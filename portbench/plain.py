"""The plain reference of the rating: TrueSkill over a match history in
plain PyTorch, independent of the program.

It imports nothing of the port. It follows the semantics of the upstream
rater (``rater.py`` of vainglorygame/analyzer) as the port states them:

  * a player's shared prior is column 0 of the ``[P+1, 16]`` table, else
    the seed columns 14/15 (``get_trueskill_seed``: rank points plus
    2/3 of UNKNOWN_PLAYER_SIGMA, else the skill tier's points plus
    UNKNOWN_PLAYER_SIGMA); the queue prior is the mode's column, else the
    shared prior; NaN means "never rated";
  * the closed-form two-team update with draw probability 0:
    ``c^2 = sum(sigma^2 + tau^2) + n beta^2``, ``t = (mu_win - mu_lose) / c``,
    ``v = phi(t) / Phi(t)`` in log space, ``w = v (v + t)`` clamped into
    [0, 1] with the asymptotic tail below t = -10;
  * column 0 takes the shared posterior and the mode's column the queue
    posterior; unsupported modes and AFK matches write nothing.

Team sums are add chains in team-major, slot-minor order and square roots
are taken in float64 and rounded, the order the configuration's float32
arithmetic is stated in. ``dtype`` runs the same arithmetic in a lower
precision (the control).

Its schedule is its own: each block of matches in stream order is cut
into levels (a match's level is one more than the highest level of its
players' earlier matches in the block), and every level is one batched
step. A match therefore reads exactly the rows its players' earlier
matches wrote, whatever batches the program formed.
"""

from __future__ import annotations

import numpy as np
import torch

# Rating environment of the upstream rater (rater.py:30-37).
BETA = 10.0 / 30.0 * 3000.0
TAU = 1000.0 / 100.0
UNKNOWN_PLAYER_SIGMA = 500.0

N_RATING_COLS = 7  # shared + six modes
SEED_MU, SEED_SIGMA = 14, 15
WIDTH = 16
MIN_TIER, MAX_TIER = -1, 29

_LOG_SQRT_2PI = float(np.float32(0.9189385332046727))
_HALF_SQRT_2 = float(np.float32(0.5) * np.sqrt(np.float32(2.0)))
_TINY = float(np.float32(1e-20))
_TAU2 = float(np.float32(TAU * TAU))
_BETA2 = float(np.float32(BETA * BETA))


def vst_points() -> np.ndarray:
    """The skill-tier points of tiers -1..29 (rater.py:14-27)."""
    pts = {-1: 1.0, 0: 1.0}
    for c in range(1, 12):
        pts[c] = (109 + 1 / 11) * (c + 0.5)
    for c in range(1, 5):
        pts[11 + c] = pts[11] + 50 * (c + 0.5)
    for c in range(1, 10):
        pts[15 + c] = pts[15] + (66 + 2 / 3) * (c + 0.5)
    for c in range(1, 4):
        pts[24 + c] = pts[24] + (133 + 1 / 3) * (c + 0.5)
    for c in range(1, 3):
        pts[27 + c] = pts[27] + 200 * (c + 0.5)
    return np.array([pts[t] for t in range(MIN_TIER, MAX_TIER + 1)])


def seeds(rank_points_ranked, rank_points_blitz, skill_tier):
    """(mu, sigma) float32 seeds (rater.py:42-62): NaN or 0 rank points
    are missing."""
    rr = np.asarray(rank_points_ranked, np.float32)
    rb = np.asarray(rank_points_blitz, np.float32)
    neg = np.float32(-np.inf)
    rr = np.where(np.isnan(rr) | (rr == 0), neg, rr)
    rb = np.where(np.isnan(rb) | (rb == 0), neg, rb)
    points = np.maximum(rr, rb)
    has = points > neg
    s_points = np.float32(UNKNOWN_PLAYER_SIGMA * (2.0 / 3.0))
    s_tier = np.float32(UNKNOWN_PLAYER_SIGMA)
    tiers = np.clip(np.asarray(skill_tier), MIN_TIER, MAX_TIER) - MIN_TIER
    tier_points = vst_points().astype(np.float32)[tiers]
    sigma = np.where(has, s_points, s_tier).astype(np.float32)
    mu = np.where(has, points + s_points, tier_points + s_tier)
    return mu.astype(np.float32), sigma


def initial_table(n_players, rank_points_ranked=None, rank_points_blitz=None,
                  skill_tier=None) -> np.ndarray:
    """``[P+1, 16]`` float32: ratings NaN, seeds baked; row P pads (no
    rank points, tier 0)."""
    p1 = n_players + 1

    def feat(x, fill, dtype):
        out = np.full(p1, fill, dtype)
        if x is not None:
            out[:n_players] = np.asarray(x)
        return out

    mu, sigma = seeds(feat(rank_points_ranked, np.nan, np.float32),
                      feat(rank_points_blitz, np.nan, np.float32),
                      feat(skill_tier, 0, np.int32))
    table = np.full((p1, WIDTH), np.nan, np.float32)
    table[:, SEED_MU] = mu
    table[:, SEED_SIGMA] = sigma
    return table


# -- the update ---------------------------------------------------------------
def _sqrt_rn(x):
    return torch.sqrt(x.double()).to(x.dtype)


def _ndtr(x):
    w = x * _HALF_SQRT_2
    z = w.abs()
    y = torch.where(z < _HALF_SQRT_2, 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def _log_ndtr(x):
    lo = torch.clamp(x, max=-10.0)
    x2 = lo * lo
    log_scale = -0.5 * x2 - torch.log(-lo) - _LOG_SQRT_2PI
    odd = 1.0 / x2
    x4 = x2 * x2
    even = 3.0 / x4
    odd = odd + 15.0 / (x4 * x2)
    lower = log_scale + torch.log(1.0 + even - odd)
    return torch.where(x > 5.0, -_ndtr(-x),
                       torch.where(x > -10.0,
                                   torch.log(_ndtr(torch.clamp(x, min=-10.0))),
                                   lower))


def two_team_update(mu, sigma, mask, winner):
    """Posterior (mu, sigma) of ``[b, 2, T]`` priors; masked slots pass.
    The count and the variance sum chain over team 0's slots then team
    1's, each team's mu sum over its own slots: three chains, kept as two
    stacked accumulators (the same adds, in the same order, per match)."""
    s2 = sigma * sigma + _TAU2
    maskf = mask.to(mu.dtype)
    both = torch.stack((maskf, s2 * maskf))  # [2, b, 2, T]: n, sigma^2 sum
    mu_m = mu * maskf
    acc = torch.zeros((2, mu.shape[0]), dtype=mu.dtype, device=mu.device)
    team = torch.zeros((mu.shape[0], 2), dtype=mu.dtype, device=mu.device)
    for k in range(2):
        for t in range(mu.shape[-1]):
            acc = acc + both[:, :, k, t]
    for t in range(mu.shape[-1]):
        team = team + mu_m[:, :, t]
    n, s2_sum = acc[0], acc[1]
    c2 = torch.clamp(s2_sum + n * _BETA2, min=_TINY)
    c = _sqrt_rn(c2)
    sign = (1 - 2 * winner).to(mu.dtype)
    t = sign * (team[:, 0] - team[:, 1]) / c
    v = torch.exp(-0.5 * t * t - _LOG_SQRT_2PI - _log_ndtr(t))
    direct = torch.clamp(v * (v + t), 0.0, 1.0)
    tg = torch.where(t <= -10.0, t, torch.full_like(t, -10.0))
    t2 = tg * tg
    w = torch.where(t <= -10.0, 1.0 - 1.0 / t2 + 6.0 / (t2 * t2), direct)
    team_sign = torch.stack((sign, -sign), dim=-1)[..., None]
    mu_new = mu + team_sign * (s2 / c[:, None, None]) * v[:, None, None]
    sigma_new = _sqrt_rn(s2 * (1.0 - (s2 / c2[:, None, None]) * w[:, None, None]))
    return torch.where(mask, mu_new, mu), torch.where(mask, sigma_new, sigma)


def _step_(table, pad_row, pad_saved, idx, mask, winner, mode_id):
    """One level in place on ``table``: every match ratable, no player
    twice; slots off ``mask`` point at ``pad_row``. The shared and the
    queue update run as one batch of ``2b`` matches."""
    b, _, t = idx.shape
    rows = table[idx]
    col = (mode_id + 1).view(b, 1, 1, 1).expand(b, 2, t, 1)
    had_sh = ~torch.isnan(rows[..., 0])
    mu_sh = torch.where(had_sh, rows[..., 0], rows[..., SEED_MU])
    sg_sh = torch.where(had_sh, rows[..., N_RATING_COLS], rows[..., SEED_SIGMA])
    q_mu = torch.gather(rows, -1, col).squeeze(-1)
    q_sg = torch.gather(rows, -1, col + N_RATING_COLS).squeeze(-1)
    had_q = ~torch.isnan(q_mu)
    mu_q = torch.where(had_q, q_mu, mu_sh)
    sg_q = torch.where(had_q, q_sg, sg_sh)
    new_mu, new_sg = two_team_update(
        torch.cat((mu_sh, mu_q)), torch.cat((sg_sh, sg_q)),
        torch.cat((mask, mask)), torch.cat((winner, winner)))
    new = rows.clone()
    new[..., 0] = new_mu[:b]
    new[..., N_RATING_COLS] = new_sg[:b]
    new.scatter_(-1, col, new_mu[b:].unsqueeze(-1))
    new.scatter_(-1, col + N_RATING_COLS, new_sg[b:].unsqueeze(-1))
    table.index_copy_(0, idx.reshape(-1), new.reshape(-1, table.shape[1]))
    table[pad_row] = pad_saved


class _Graphed:
    """:func:`_step_` replayed from CUDA graphs, one per power-of-two level
    size: a level's matches are copied into the graph's static inputs and
    the rest of them padded with empty matches (every slot off, routed to
    the padding row, which each step restores). The arithmetic is the
    eager step's; the graphs only spare the host its launches."""

    def __init__(self, table, pad_row, pad_saved, team):
        self.table, self.pad_row, self.pad_saved = table, pad_row, pad_saved
        self.team = team
        self.graphs = {}
        self.pool = torch.cuda.graph_pool_handle()

    def _capture(self, size):
        dev = self.table.device
        idx = torch.full((size, 2, self.team), self.pad_row, dtype=torch.long,
                         device=dev)
        mask = torch.zeros((size, 2, self.team), dtype=torch.bool, device=dev)
        win = torch.zeros(size, dtype=torch.long, device=dev)
        mode = torch.zeros(size, dtype=torch.long, device=dev)
        args = (self.table, self.pad_row, self.pad_saved, idx, mask, win, mode)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):  # all-empty matches: the table is untouched
                _step_(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            _step_(*args)
        self.graphs[size] = (graph, idx, mask, win, mode)

    def step(self, idx, mask, win, mode):
        b = idx.shape[0]
        size = max(64, 1 << (b - 1).bit_length())
        if size not in self.graphs:
            self._capture(size)
        graph, s_idx, s_mask, s_win, s_mode = self.graphs[size]
        s_idx[:b].copy_(idx)
        s_mask[:b].copy_(mask)
        s_win[:b].copy_(win)
        s_mode[:b].copy_(mode)
        graph.replay()
        s_idx[:b].fill_(self.pad_row)
        s_mask[:b].fill_(False)


# -- the schedule -------------------------------------------------------------
def levels(pidx: torch.Tensor, n_players: int, block: int) -> torch.Tensor:
    """Level of every match inside its block of ``block`` matches (int64):
    0 for a match none of whose players played earlier in the block, else
    one more than the highest level among those earlier matches. Jacobi
    iteration over all blocks at once; it ends when no level moves."""
    n = pidx.shape[0]
    live = pidx >= 0
    m_of = torch.arange(n, device=pidx.device)[:, None, None].expand_as(pidx)
    slot_m = m_of[live]
    key = (slot_m // block) * (n_players + 1) + pidx[live].long()
    order = torch.argsort(key, stable=True)
    k_s, m_s = key[order], slot_m[order]
    prev_s = torch.full_like(m_s, -1)
    if m_s.numel() > 1:
        prev_s[1:] = torch.where(k_s[1:] == k_s[:-1], m_s[:-1], -1)
    prev = torch.empty_like(prev_s)
    prev[order] = prev_s
    has = prev >= 0
    prev_c = prev.clamp(min=0)
    level = torch.zeros(n, dtype=torch.int64, device=pidx.device)
    for _ in range(n + 1):
        cand = torch.where(has, level[prev_c] + 1, 0)
        new = torch.zeros_like(level).scatter_reduce(0, slot_m, cand, "amax")
        if torch.equal(new, level):
            return level
        level = new
    raise RuntimeError("level iteration did not settle")


def rate_history(table: np.ndarray, player_idx: np.ndarray,
                 winner: np.ndarray, mode_id: np.ndarray, afk: np.ndarray,
                 device, dtype=torch.float32, block: int = 65536) -> np.ndarray:
    """The table after rating the matches in the given order. ``table`` is
    the ``[P+1, 16]`` float32 start (row P pads); the match arrays are in
    the port's stream layout (``player_idx`` -1 = empty slot). Returns a
    float32 numpy table."""
    n_players = table.shape[0] - 1
    ratable = (np.asarray(mode_id) >= 0) & ~np.asarray(afk, bool)
    keep = np.flatnonzero(ratable)
    t = torch.from_numpy(np.ascontiguousarray(table)).to(device, dtype)
    if keep.size == 0:
        return t.float().cpu().numpy()
    pidx = torch.from_numpy(np.ascontiguousarray(player_idx[keep])).to(device).long()
    win = torch.from_numpy(np.asarray(winner)[keep]).to(device).long()
    mode = torch.from_numpy(np.asarray(mode_id)[keep]).to(device).long()
    lvl = levels(pidx, n_players, block)
    blk = torch.arange(pidx.shape[0], device=device) // block
    group = blk * (int(lvl.max()) + 1) + lvl
    perm = torch.argsort(group, stable=True)
    counts = torch.unique_consecutive(group[perm], return_counts=True)[1]
    pidx, win, mode = pidx[perm], win[perm], mode[perm]
    mask = pidx >= 0
    idx = torch.where(mask, pidx, n_players)
    pad_saved = t[n_players].clone()
    if t.is_cuda:
        step = _Graphed(t, n_players, pad_saved, idx.shape[-1]).step
    else:
        def step(*a):
            _step_(t, n_players, pad_saved, *a)
    s0 = 0
    for c in counts.tolist():
        s1 = s0 + c
        step(idx[s0:s1], mask[s0:s1], win[s0:s1], mode[s0:s1])
        s0 = s1
    return t.float().cpu().numpy()


def compare_tables(prog: np.ndarray, ref: np.ndarray) -> dict:
    """The rating columns (mu and sigma of shared + six modes) of every
    player row: how many entries differ in being NULL (NaN), and the
    largest relative gap of the rest."""
    a = np.asarray(prog, np.float64)[:, : 2 * N_RATING_COLS]
    b = np.asarray(ref, np.float64)[:, : 2 * N_RATING_COLS]
    na, nb = np.isnan(a), np.isnan(b)
    both = ~na & ~nb
    rel = np.abs(a[both] - b[both]) / np.maximum(np.abs(b[both]), 1e-30)
    return {"null_mismatches": int((na != nb).sum()),
            "max_rel_err": float(rel.max()) if rel.size else 0.0,
            "entries": int(both.sum())}
