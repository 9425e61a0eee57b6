"""Match feature extraction for the win-probability heads.

Counterpart of ``analyzer_tpu.models.features``. Features per match, built
from the *pre-match* rating state (no leakage: the history runner's
collected outputs are posteriors, so features come from a separate
forward pass, :func:`history_features`):

    0    shared-mu sum difference (team0 - team1), mu0-normalized
    1    mean shared sigma over the match's real players,
         sigma0-normalized (uncertainty) — per-player mean, not a sum, so
         the scale is comparable between 3v3 (6 players) and 5v5 (10)
    2    TrueSkill win probability Phi(diff / c)  (ops.trueskill)
    3    match quality (draw probability proxy)
    4..9 one-hot game mode (6 modes)

10 features total — the "player-rating features" of BASELINE config 3.
:func:`telemetry_features` and :func:`composition_features` are numpy
copies of the JAX package's and equal it bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core import constants
from analyzer_tpu_torch.core.state import (
    COL_SEED_MU,
    COL_SEED_SIGMA,
    MU_LO,
    SIGMA_LO,
    PlayerState,
)
from analyzer_tpu_torch.device import resolve_device
from analyzer_tpu_torch.io.synthetic import (
    N_ARCHETYPES,
    N_ITEM_BUILDS,
    TELEMETRY_STATS,
)
from analyzer_tpu_torch.ops import trueskill as ts

N_FEATURES = 4 + constants.N_MODES

# Per numeric stat a ratio + a log-total, plus the item-build histogram.
N_TELEMETRY_FEATURES = 2 * (len(TELEMETRY_STATS) - 1) + N_ITEM_BUILDS


def match_features(
    state: PlayerState,
    player_idx: torch.Tensor,
    slot_mask: torch.Tensor,
    mode_id: torch.Tensor,
    cfg: RatingConfig,
) -> torch.Tensor:
    """``[B, N_FEATURES]`` from the current state (prior to these matches)."""
    rows = state.table[player_idx.long()]  # [B,2,T,W]
    maskf = slot_mask.to(rows.dtype)

    mu_sh = rows[..., MU_LO]
    sg_sh = rows[..., SIGMA_LO]
    seed_mu = rows[..., COL_SEED_MU]
    seed_sg = rows[..., COL_SEED_SIGMA]
    has = ~torch.isnan(mu_sh)
    mu = torch.where(has, mu_sh, seed_mu)
    sg = torch.where(has, sg_sh, seed_sg)

    team_mu = (mu * maskf).sum(-1)  # [B,2]
    mu_diff = (team_mu[:, 0] - team_mu[:, 1]) / cfg.mu0
    n_active = maskf.sum((-2, -1)).clamp(min=1.0)  # [B] real players
    sg_sum = (sg * maskf).sum((-2, -1)) / (cfg.sigma0 * n_active)

    p_win = ts.win_probability(mu, sg, slot_mask, cfg)
    quality = ts.quality(mu, sg, slot_mask, cfg)

    modes = torch.arange(constants.N_MODES, device=mode_id.device)
    onehot = (mode_id.clamp(min=0)[:, None] == modes[None, :]).to(rows.dtype)

    return torch.cat(
        [mu_diff[:, None], sg_sum[:, None], p_win[:, None], quality[:, None],
         onehot],
        dim=1,
    )


def telemetry_features(telemetry, player_idx) -> np.ndarray:
    """``[N, 18]`` from POST-GAME telemetry ``[N, 2, T, 6]`` (kills,
    deaths, assists, gold, cs, item_build — io/synthetic.py
    TELEMETRY_STATS): per numeric stat, the bounded team ratio
    ``(t0 - t1) / (t0 + t1 + 1)`` and the log1p match total (scale);
    plus the per-build team HISTOGRAM difference over the categorical
    item channel (the "items" of config 4), team-size normalized. These
    describe a FINISHED match — the telemetry head analyzes outcomes
    from game stats; it does not forecast. Forecasting features are
    :func:`match_features` (pre-match state only)."""
    tele = np.asarray(telemetry, np.float32)
    if tele.ndim != 4 or tele.shape[-1] != len(TELEMETRY_STATS):
        # A stat-width mismatch (e.g. an npz from an older schema) would
        # silently misread the categorical channel as a stat — reject.
        raise ValueError(
            f"telemetry must be [N, 2, T, {len(TELEMETRY_STATS)}] "
            f"({', '.join(TELEMETRY_STATS)}), got shape {tele.shape}"
        )
    maskb = player_idx >= 0
    mask = maskb.astype(np.float32)[..., None]
    stats = tele[..., :-1]
    team = (stats * mask).sum(axis=2)  # [N,2,5]
    total = team.sum(axis=1)  # [N,5]
    diff = (team[:, 0] - team[:, 1]) / (total + 1.0)

    n, _, t = player_idx.shape
    build = np.clip(tele[..., -1].astype(np.int64), 0, N_ITEM_BUILDS - 1)
    rows = np.repeat(np.arange(n * 2), t).reshape(n, 2, t)
    key = (rows * N_ITEM_BUILDS + build)[maskb]
    hist = np.bincount(key, minlength=n * 2 * N_ITEM_BUILDS).reshape(
        n, 2, N_ITEM_BUILDS
    )
    n_team = np.maximum(maskb.sum(axis=2), 1)[:, :, None]  # [N,2,1]
    hdiff = hist[:, 0] / n_team[:, 0] - hist[:, 1] / n_team[:, 1]

    return np.concatenate(
        [diff, np.log1p(total), hdiff], axis=1
    ).astype(np.float32)


def composition_features(archetype, player_idx) -> np.ndarray:
    """``[N, A*(A+1)/2]`` PRE-MATCH composition features: the difference
    (team0 - team1) of unordered teammate-archetype-PAIR counts.

    A team's synergy under any symmetric pairwise model is
    ``sum_{i<j} S[a_i, a_j]`` — a LINEAR function of these pair counts,
    so even the logistic head can represent the generator's hidden
    synergy matrix exactly (io/synthetic.py synergy_matrix) and recover
    it from outcomes. Archetypes are static player attributes (playstyle
    buckets, known before the match like a draft), so these features are
    leak-free forecasting inputs, unlike ``telemetry_features``.
    Diagonal entries count same-archetype pairs C(c_a, 2)."""
    arch = np.asarray(archetype, np.int64)
    if arch.ndim != 1:
        raise ValueError(f"archetype must be [P], got shape {arch.shape}")
    mask = player_idx >= 0
    a = np.where(mask, arch[np.clip(player_idx, 0, None)], -1)  # [N,2,T]
    counts = (a[..., None] == np.arange(N_ARCHETYPES)).sum(axis=2)  # [N,2,A]
    iu, ju = np.triu_indices(N_ARCHETYPES)
    ci = counts[:, :, iu]
    cj = counts[:, :, ju]
    pairs = np.where(iu == ju, ci * (ci - 1) // 2, ci * cj)  # [N,2,#pairs]
    return (pairs[:, 0] - pairs[:, 1]).astype(np.float32)


def history_features(
    state: PlayerState,
    sched,
    cfg: RatingConfig,
    steps_per_chunk: int = 8192,
    device=None,
    graph: bool = True,
):
    """Leak-free training data for the win-prob heads: one pass over the
    packed (or windowed) schedule that takes each step's features from the
    state BEFORE that step, then applies the plain superstep
    (:func:`~analyzer_tpu_torch.core.update.rate_step_`, the in-place
    form of ``rate_and_apply``) to a clone of ``state`` — the caller's
    state is left as it was.

    ``device`` (None = the card) is where the pass runs; ``state`` is
    copied there. On the card each step replays one CUDA graph of those
    same operations (``graph=False`` dispatches them one by one, the
    reference the graph is held to): the step is hundreds of small
    kernels, which eager dispatch pays ~9 ms of host time for (PERF.md,
    NVIDIA H100 80GB HBM3, 700.00 W), and the replay runs the same
    kernels on the same inputs, so the results are bit-identical. On the
    CPU ``graph`` is ignored. Features stay on
    the device within a chunk and are fetched once per chunk. Returns
    ``(features [N, F] float32, ratable [N] bool, final_state)`` in
    stream order. Train only on ``ratable`` rows: non-ratable matches
    (unsupported mode / AFK) still get feature rows for shape stability,
    but their mode one-hot is a clamped placeholder and their winner
    label is meaningless."""
    import dataclasses

    from analyzer_tpu_torch.core.update import check_seed_cfg, rate_step_

    dev = resolve_device(device)
    check_seed_cfg(state, cfg)
    if sched.pad_row != state.pad_row:
        raise ValueError(
            f"schedule packed with pad_row={sched.pad_row}, but the state's "
            f"padding row is {state.pad_row}"
        )
    state = dataclasses.replace(state, table=state.table.to(dev, copy=True))
    table, pad = state.table, state.pad_row
    step = None
    if dev.type == "cuda" and graph and sched.n_steps:
        step = _GraphStep(state, cfg, sched.batch_size, sched.team_size)
    chunks = []
    for start in range(0, sched.n_steps, steps_per_chunk):
        stop = min(start + steps_per_chunk, sched.n_steps)
        host = sched.host_window(start, stop)
        feats = torch.empty(
            (stop - start, sched.batch_size, N_FEATURES), dtype=torch.float32,
            device=dev,
        )
        if step is not None:
            packed = torch.from_numpy(_pack_steps(*host)).to(dev)
            for s in range(stop - start):
                step.run(packed[s], feats[s])
        else:
            pidx, _mask, winner, mode_id, afk = (
                torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host
            )
            for s in range(stop - start):
                idx = pidx[s]
                feats[s] = match_features(state, idx, idx != pad, mode_id[s], cfg)
                rate_step_(table, pad, idx, winner[s], mode_id[s], afk[s], cfg)
        chunks.append(feats.cpu().numpy())

    flat = (
        np.concatenate(chunks, axis=0).reshape(-1, N_FEATURES)
        if chunks else np.zeros((0, N_FEATURES), np.float32)
    )
    src = sched.match_idx.reshape(-1)
    sel = src >= 0
    out = np.zeros((sched.n_matches, N_FEATURES), np.float32)
    out[src[sel]] = flat[sel]
    ratable = np.zeros((sched.n_matches,), bool)
    flat_ratable = ((sched.mode_id >= 0) & ~sched.afk).reshape(-1)
    ratable[src[sel]] = flat_ratable[sel]
    return out, ratable, state


def _pack_steps(pidx, _mask, winner, mode_id, afk) -> np.ndarray:
    """A window's step inputs as one int32 row per step: the ``[B, 2, T]``
    rows, then winner, mode and afk (0/1) — the layout of
    :class:`_GraphStep`'s input buffer."""
    s = pidx.shape[0]
    return np.concatenate(
        [pidx.reshape(s, -1), winner, mode_id, afk.astype(np.int32)], axis=1,
    ).astype(np.int32, copy=False)


class _GraphStep:
    """One features step (``match_features`` then ``rate_step_``) captured
    as a CUDA graph over a static input buffer, against ``state``'s table
    (updated in place by each replay)."""

    def __init__(self, state: PlayerState, cfg: RatingConfig, b: int, t: int):
        from analyzer_tpu_torch.core.update import rate_step_

        dev, pad = state.table.device, state.pad_row
        n = b * 2 * t
        # Starts inert (every slot the pad row, mode unsupported): the
        # warm-up run below then reads pad rows and writes nothing but the
        # pad row's re-pin, which leaves the table as it was.
        self.buf = torch.zeros((n + 3 * b,), dtype=torch.int32, device=dev)
        self.buf[:n] = pad
        self.buf[n + b:n + 2 * b] = constants.UNSUPPORTED_MODE_ID
        idx = self.buf[:n].view(b, 2, t)
        winner, mode_id, afk = self.buf[n:].view(3, b)
        self.out = torch.empty((b, N_FEATURES), dtype=torch.float32, device=dev)

        def body():
            self.out.copy_(match_features(state, idx, idx != pad, mode_id, cfg))
            rate_step_(state.table, pad, idx, winner, mode_id, afk, cfg)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            body()

    def run(self, inputs: torch.Tensor, out: torch.Tensor) -> None:
        """One step: ``inputs`` is a row of :func:`_pack_steps` on the
        device; the step's features land in ``out`` ``[B, N_FEATURES]``."""
        self.buf.copy_(inputs)
        self.graph.replay()
        out.copy_(self.out)
