"""Elo pairwise/team rater (BASELINE.json config 1).

Counterpart of ``analyzer_tpu.models.elo``. Closed-form like the TrueSkill
step but with one scalar per player: team rating = mean of members,
expected score from the logistic curve, and every member of a team moves
by the same K-scaled surprise. It walks the SAME conflict-free superstep
schedule as TrueSkill (``sched.pack_schedule``, packed or windowed), so
chronology and scatter safety come from the schedule, over a ``[P+1]``
rating vector whose last row parks the padding writes.

The JAX package scans each chunk inside one jitted ``lax.scan``; here each
chunk's window is materialized on the host once (``host_window``), copied
to the device once, and its steps run as eager PyTorch, with the
per-step predictions kept on the device until the chunk ends.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from analyzer_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EloConfig:
    initial: float = 1500.0
    k: float = 32.0
    scale: float = 400.0


def create_elo_table(
    n_players: int, cfg: EloConfig = EloConfig(), device=None
) -> torch.Tensor:
    """``[P+1]`` float32 ratings, all at the initial value (padding row
    included)."""
    return torch.full(
        (n_players + 1,), cfg.initial, dtype=torch.float32,
        device=resolve_device(device),
    )


def elo_rate_batch(
    table: torch.Tensor,
    player_idx: torch.Tensor,
    slot_mask: torch.Tensor,
    winner: torch.Tensor,
    ratable: torch.Tensor,
    pad_row: int,
    cfg: EloConfig,
) -> torch.Tensor:
    """One conflict-free batch of team-Elo updates, IN PLACE on ``table``.

    Returns expected0 ``[B]``, P(team 0 wins) under the logistic curve
    from the pre-batch ratings. Padding slots may point past the table
    (a schedule packed against a larger pad row): their gather clamps to
    ``pad_row``, as JAX's clamps, and is masked out. The update is one
    ``index_add_``: real rows are unique within a conflict-free batch, and
    only ``pad_row`` takes duplicates, each adding 0."""
    maskf = slot_mask.to(table.dtype)
    idx = player_idx.long()
    r = table[idx.clamp(max=pad_row)]  # [B,2,T] row gather
    n = maskf.sum(-1).clamp(min=1.0)  # [B,2]
    team_r = (r * maskf).sum(-1) / n  # [B,2] mean rating
    diff = (team_r[:, 0] - team_r[:, 1]) / cfg.scale
    expected0 = 1.0 / (1.0 + torch.pow(10.0, -diff))  # [B]

    score0 = (winner == 0).to(table.dtype)
    delta0 = cfg.k * (score0 - expected0)  # team 0 members; team 1 gets -delta0
    delta = torch.stack([delta0, -delta0], dim=1)[:, :, None]  # [B,2,1]

    do = ratable[:, None, None] & slot_mask
    rows = torch.where(do, idx, pad_row)
    add = torch.where(do, delta, torch.zeros((), dtype=table.dtype,
                                             device=table.device))
    table.index_add_(0, rows.reshape(-1), add.reshape(-1))
    return expected0


def elo_history(
    sched,
    n_players: int,
    cfg: EloConfig = EloConfig(),
    steps_per_chunk: int = 8192,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Full-history Elo re-rate over a packed or windowed schedule.

    Returns (ratings [P], expected0 [N] in stream order) as numpy float32 —
    the latter is the model's win prediction for every match, made from
    pre-match ratings. The slot mask is derived on the device as
    ``player_idx != sched.pad_row``, as JAX's ``expand_step`` derives it."""
    pad_row = n_players  # the elo table's own parking row for padding writes
    if sched.pad_row < n_players:
        # The slot mask derives from sched.pad_row; a schedule packed
        # against a SMALLER table would alias a real player's row. (A
        # larger sched.pad_row is fine: masks derive from it, writes park
        # at the elo table's own pad row.)
        raise ValueError(
            f"schedule packed with pad_row={sched.pad_row} < "
            f"n_players={n_players}"
        )
    check = getattr(sched, "check_compact_invariant", None)
    if check is not None:
        check()
    dev = resolve_device(device)
    table = create_elo_table(n_players, cfg, device=dev)
    exps = []
    for start in range(0, sched.n_steps, steps_per_chunk):
        stop = min(start + steps_per_chunk, sched.n_steps)
        pidx, _mask, winner, mode_id, afk = sched.host_window(start, stop)
        pidx = torch.from_numpy(np.ascontiguousarray(pidx)).to(dev)
        winner = torch.from_numpy(np.ascontiguousarray(winner)).to(dev)
        ratable = torch.from_numpy(
            (np.asarray(mode_id) >= 0) & ~np.asarray(afk)
        ).to(dev)
        out = torch.empty(pidx.shape[:2], dtype=torch.float32, device=dev)
        for s in range(stop - start):
            out[s] = elo_rate_batch(
                table, pidx[s], pidx[s] != sched.pad_row, winner[s],
                ratable[s], pad_row, cfg,
            )
        exps.append(out.cpu().numpy())

    flat = (
        np.concatenate(exps, axis=0).reshape(-1)
        if exps else np.zeros(0, np.float32)
    )
    src = sched.match_idx.reshape(-1)
    sel = src >= 0
    expected = np.zeros(sched.n_matches, np.float32)
    expected[src[sel]] = flat[sel]
    return table[:n_players].cpu().numpy(), expected
