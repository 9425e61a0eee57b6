"""The batched per-match rating step: gather -> rate -> scatter.

Counterpart of ``analyzer_tpu.core.update``, with the semantics of the
reference's ``rate_match`` (``rater.py:69-169``) over a whole batch:

  1. prior resolution — shared prior from the table, else the baked seed
     (``rater.py:114-121``); queue prior from the mode column, else the
     shared prior (``rater.py:123-132``);
  2. match quality from the queue matchup (the reference's code passes
     ``matchup`` although its comment says "shared", ``rater.py:140-141``);
  3. the shared update (column 0) with the per-participant delta of the
     conservative estimate mu - sigma, 0 for a first-ever rating
     (``rater.py:143-157``);
  4. the queue update (the mode column, ``rater.py:159-169``);
  5. gating — unsupported modes mutate nothing; AFK / invalid-roster
     matches get quality 0 and any_afk but no rating update.

In the JAX package this is XLA code, not a Pallas kernel; here it stays
plain PyTorch on every device. It is the superstep of the ``reference``
runner and the per-step body of the plain fused window
(:func:`analyzer_tpu_torch.core.fused._window_plain`) that the CUDA kernel
is held against.

The runner updates the table IN PLACE (:func:`scatter_rows_`) where the
JAX package builds a new array per step: the caller's state is copied once
at entry instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import (
    COL_SEED_MU,
    COL_SEED_SIGMA,
    MU_LO,
    N_COLS,
    SIGMA_LO,
    MatchBatch,
    PlayerState,
)
from analyzer_tpu_torch.ops import trueskill as ts


@dataclasses.dataclass
class RateOutputs:
    """Per-match / per-slot outputs mirroring the reference's writes.

    quality       [B]        match.trueskill_quality (0 unless ratable)
    shared_mu/.._sigma [B,2,T] participant.trueskill_mu/sigma snapshot
    delta         [B,2,T]    participant.trueskill_delta
    mode_mu/.._sigma   [B,2,T] participant_items.trueskill_<mode>_mu/sigma
    any_afk       [B]        participant_items.any_afk
    write_quality [B]        whether quality/any_afk are written at all
    updated       [B]        whether ratings were written (ratable matches)
    new_rows      [B,2,T,16] the fully updated table rows, ready to scatter
    """

    quality: torch.Tensor
    shared_mu: torch.Tensor
    shared_sigma: torch.Tensor
    delta: torch.Tensor
    mode_mu: torch.Tensor
    mode_sigma: torch.Tensor
    any_afk: torch.Tensor
    write_quality: torch.Tensor
    updated: torch.Tensor
    new_rows: torch.Tensor


def check_seed_cfg(state: PlayerState, cfg: RatingConfig) -> None:
    """Refuses to rate with an UNKNOWN_PLAYER_SIGMA other than the one that
    baked the seed columns (only that field feeds them)."""
    if (
        state.seed_cfg is not None
        and state.seed_cfg.unknown_player_sigma != cfg.unknown_player_sigma
    ):
        raise ValueError(
            f"state seeds were built with UNKNOWN_PLAYER_SIGMA="
            f"{state.seed_cfg.unknown_player_sigma}, but rating was called "
            f"with {cfg.unknown_player_sigma}; rebuild the state via "
            "PlayerState.create(..., cfg=cfg)"
        )


def rate_batch(state: PlayerState, batch: MatchBatch, cfg: RatingConfig) -> RateOutputs:
    """All rating outputs for a batch, without touching the state."""
    check_seed_cfg(state, cfg)
    rows = state.table[batch.player_idx.long()]  # [B,2,T,W] — the ONE gather
    return rate_gathered(rows, batch, cfg)


def rate_gathered(
    rows: torch.Tensor, batch: MatchBatch, cfg: RatingConfig
) -> RateOutputs:
    """:func:`rate_batch` on pre-gathered rows ``[B,2,T,16]``."""
    mask = batch.slot_mask
    b, _, t, _ = rows.shape
    # The mode's rating column (mode i -> col i+1; unsupported -1 clamps to
    # col 1 — those matches never write).
    col = (batch.mode_id.clamp(min=0) + 1).long().view(b, 1, 1, 1)
    col = col.expand(b, 2, t, 1)

    shared_mu_p = rows[..., MU_LO]
    shared_sigma_p = rows[..., SIGMA_LO]
    seed_mu = rows[..., COL_SEED_MU]
    seed_sigma = rows[..., COL_SEED_SIGMA]
    q_mu_p = torch.gather(rows, -1, col).squeeze(-1)
    q_sigma_p = torch.gather(rows, -1, col + N_COLS).squeeze(-1)

    had_mode = ~torch.isnan(q_mu_p)
    had_shared = ~torch.isnan(shared_mu_p)
    mu_sh = torch.where(had_shared, shared_mu_p, seed_mu)
    sigma_sh = torch.where(had_shared, shared_sigma_p, seed_sigma)
    mu_q = torch.where(had_mode, q_mu_p, mu_sh)
    sigma_q = torch.where(had_mode, q_sigma_p, sigma_sh)

    quality = ts.quality(mu_q, sigma_q, mask, cfg)  # queue matchup quirk
    new_sh_mu, new_sh_sigma = ts.two_team_update(
        mu_sh, sigma_sh, mask, batch.winner, cfg
    )
    new_q_mu, new_q_sigma = ts.two_team_update(
        mu_q, sigma_q, mask, batch.winner, cfg
    )
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    delta = torch.where(
        had_shared & mask,
        (new_sh_mu - new_sh_sigma) - (mu_sh - sigma_sh),
        zero,
    )

    # Col 0 <- shared posterior, mode col <- queue posterior; every other
    # column keeps its gathered value (NaN markers and seeds included).
    new_rows = rows.clone()
    new_rows[..., MU_LO] = new_sh_mu
    new_rows[..., SIGMA_LO] = new_sh_sigma
    new_rows.scatter_(-1, col, new_q_mu.unsqueeze(-1))
    new_rows.scatter_(-1, col + N_COLS, new_q_sigma.unsqueeze(-1))

    ratable = batch.ratable
    return RateOutputs(
        quality=torch.where(ratable, quality, zero),
        shared_mu=new_sh_mu,
        shared_sigma=new_sh_sigma,
        delta=delta,
        mode_mu=new_q_mu,
        mode_sigma=new_q_sigma,
        any_afk=batch.supported & batch.afk,
        write_quality=batch.supported,
        updated=ratable,
        new_rows=new_rows,
    )


def scatter_rows_(
    table: torch.Tensor,
    pad_row: int,
    player_idx: torch.Tensor,
    slot_mask: torch.Tensor,
    updated: torch.Tensor,
    new_rows: torch.Tensor,
) -> torch.Tensor:
    """The ONE whole-row scatter, in place on ``table``: masked and
    non-ratable slots route to the padding row, so shapes stay static and
    nothing collides in a conflict-free batch.

    The padding row is RE-PINNED to its pre-step value afterwards: the
    routed no-write rows differ per slot and the duplicate-index write
    order is unspecified, so without the pin the padding row would hold
    junk that later steps' masked slots gather. Pinned, it is a fixed
    point — the same fixed point as the fused window's slot 0."""
    do = updated[:, None, None] & slot_mask
    idx = torch.where(do, player_idx.long(), pad_row).reshape(-1)
    pad_prev = table[pad_row].clone()
    table.index_copy_(0, idx, new_rows.reshape(-1, table.shape[1]))
    table[pad_row] = pad_prev
    return table


def rate_step_(
    table: torch.Tensor,
    pad: int,
    idx: torch.Tensor,
    winner: torch.Tensor,
    mode_id: torch.Tensor,
    afk: torch.Tensor,
    cfg: RatingConfig,
) -> RateOutputs:
    """One superstep in place on a raw table whose padding row is ``pad``:
    the ``reference`` runner's step (``pad`` = the table's padding row) and
    the plain fused window's step (``pad`` = slot 0 of the working set).
    ``idx`` ``[B, 2, T]`` int; the slot mask is ``idx != pad``, the
    invariant every schedule and residency plan holds; ``afk`` may be bool
    or 0/1 int."""
    mask = idx != pad
    batch = MatchBatch(
        player_idx=idx, slot_mask=mask, winner=winner, mode_id=mode_id,
        afk=afk.bool(),
    )
    out = rate_gathered(table[idx.long()], batch, cfg)
    scatter_rows_(table, pad, idx, mask, out.updated, out.new_rows)
    return out


def scatter_rows(
    state: PlayerState,
    player_idx: torch.Tensor,
    slot_mask: torch.Tensor,
    updated: torch.Tensor,
    new_rows: torch.Tensor,
) -> PlayerState:
    """:func:`scatter_rows_` on a copy: the caller's state stays valid."""
    table = scatter_rows_(
        state.table.clone(), state.pad_row, player_idx, slot_mask, updated,
        new_rows,
    )
    return dataclasses.replace(state, table=table)


def apply_outputs(
    state: PlayerState, batch: MatchBatch, out: RateOutputs
) -> PlayerState:
    """Scatters the updated rows into a copy of the player table."""
    return scatter_rows(
        state, batch.player_idx, batch.slot_mask, out.updated, out.new_rows
    )


def rate_and_apply(
    state: PlayerState, batch: MatchBatch, cfg: RatingConfig
) -> tuple[PlayerState, RateOutputs]:
    """One superstep: rate a conflict-free batch and commit the posteriors
    (to a copy of the table)."""
    out = rate_batch(state, batch, cfg)
    return apply_outputs(state, batch, out), out


def rate_and_apply_checked(
    state: PlayerState, batch: MatchBatch, cfg: RatingConfig
) -> tuple[PlayerState, RateOutputs]:
    """Entry point for untrusted batches: the host-side race check first."""
    check_conflict_free(batch)
    return rate_and_apply(state, batch, cfg)


def pack_outputs(out: RateOutputs) -> torch.Tensor:
    """The collectable outputs as ONE ``[B, 3 + 10T]`` float32 tensor:
    quality, any_afk, updated, then five ``[2T]`` blocks (shared_mu,
    shared_sigma, delta, mode_mu, mode_sigma). The fused kernel writes the
    same layout (``kernels/csrc/rate_match.cuh``)."""
    b = out.quality.shape[0]
    f32 = out.shared_mu.dtype
    return torch.cat(
        [
            out.quality[:, None].to(f32),
            out.any_afk[:, None].to(f32),
            out.updated[:, None].to(f32),
            out.shared_mu.reshape(b, -1),
            out.shared_sigma.reshape(b, -1),
            out.delta.reshape(b, -1),
            out.mode_mu.reshape(b, -1),
            out.mode_sigma.reshape(b, -1),
        ],
        dim=1,
    )


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_conflict_free(batch: MatchBatch) -> None:
    """Race detector: raises if a player appears in two ratable matches of
    one batch (the scatter would collide)."""
    idx = _host(batch.player_idx)
    mask = _host(batch.slot_mask) & _host(batch.ratable)[:, None, None]
    uniq, counts = np.unique(idx[mask], return_counts=True)
    dup = uniq[counts > 1]
    if dup.size:
        raise ValueError(
            f"batch is not conflict-free: player rows {dup[:16].tolist()} appear "
            "in multiple ratable matches; scatters would collide"
        )


def check_window_conflict_free(
    player_idx, ratable, pad_row=None, slot_mask=None
) -> None:
    """Window-level race detector: every step of a ``[K, B, 2, T]`` fused
    window must be conflict-free before any of them runs. ``slot_mask``
    defaults to ``player_idx != pad_row`` (pass one of the two)."""
    idx = _host(player_idx)
    ratable = _host(ratable)
    if slot_mask is None:
        if pad_row is None:
            raise TypeError(
                "check_window_conflict_free needs pad_row or slot_mask to "
                "tell padding slots from real players"
            )
        mask = idx != pad_row
    else:
        mask = _host(slot_mask)
    live = mask & ratable[:, :, None, None]
    for s in range(idx.shape[0]):
        uniq, counts = np.unique(idx[s][live[s]], return_counts=True)
        dup = uniq[counts > 1]
        if dup.size:
            raise ValueError(
                f"window step {s} is not conflict-free: player rows "
                f"{dup[:16].tolist()} appear in multiple ratable matches "
                "of one superstep; the fused working-set writes would "
                "collide"
            )
