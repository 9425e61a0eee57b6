"""Pure-Python oracle for the serving plane's query results.

The port's own copy of ``analyzer_tpu.serve.oracle`` (numpy + math only):
the plain version every served number is held to, on the CPU and on the
card. The parity contract (tests/test_torch_serve.py): for any
published view, leaderboard, tier histogram, percentile, win
probability and quality computed here must equal the
:class:`~analyzer_tpu_torch.serve.engine.QueryEngine`'s responses
**bit-for-bit**. That is possible — not just approximately true —
because the engine splits every query into

  * device work that is IEEE-exact and order-pinned: row gathers,
    NaN→seed selects, comparisons, and float32 team reductions written
    as explicit team-major slot-minor add chains (eager PyTorch
    runs each add as its own kernel, in the written order), every operation a
    correctly-rounded float32 primitive this module replays with
    ``np.float32`` scalars in the same order;
  * a host float64 finish for the transcendentals (Phi via
    ``math.erfc``, quality's ``sqrt``·``exp``), rounded once to float32
    — plain double libm, identical here and there.

Host-side and loop-shaped by design; used only by tests and never
imported by the serving path.

All functions take a HOST table — ``RatingsView.host_table()`` — in the
packed ``[alloc+1, 16]`` layout of :mod:`analyzer_tpu_torch.core.state`.
"""

from __future__ import annotations

import math

import numpy as np

from analyzer_tpu_torch.core.state import (
    COL_SEED_MU,
    COL_SEED_SIGMA,
    MU_LO,
    SIGMA_LO,
)

_CONSERVATIVE_K = np.float32(3.0)  # documented rank metric: mu - 3*sigma


def resolve_prior(table: np.ndarray, row: int):
    """(mu, sigma) float32 with the NaN -> baked-seed resolution the
    kernels apply (rater.py:114-121)."""
    mu = np.float32(table[row, MU_LO])
    sg = np.float32(table[row, SIGMA_LO])
    if math.isnan(float(mu)):
        return (
            np.float32(table[row, COL_SEED_MU]),
            np.float32(table[row, COL_SEED_SIGMA]),
        )
    return mu, sg


def conservative_score(table: np.ndarray, row: int) -> np.float32:
    """mu - 3*sigma in float32 (shared column; NaN for unrated rows),
    in the engine kernels' FMA-proof rounding order: exact ``sg+sg``,
    one rounding for ``+sg``, one for the subtract."""
    mu = np.float32(table[row, MU_LO])
    sg = np.float32(table[row, SIGMA_LO])
    return np.float32(mu - np.float32(np.float32(sg + sg) + sg))


def team_stats(table: np.ndarray, rows_a, rows_b):
    """The kernel's fixed-order float32 statistics: (n, sigma2_sum,
    mu_diff) accumulated team-major, slot-minor — team A's slots in
    order, then team B's."""
    n = np.float32(0.0)
    s2 = np.float32(0.0)
    team_mu = [np.float32(0.0), np.float32(0.0)]
    for t, rows in enumerate((rows_a, rows_b)):
        for row in rows:
            mu, sg = resolve_prior(table, row)
            n = np.float32(n + np.float32(1.0))
            s2 = np.float32(s2 + np.float32(sg * sg))
            team_mu[t] = np.float32(team_mu[t] + mu)
    return n, s2, np.float32(team_mu[0] - team_mu[1])


def win_probability(table: np.ndarray, rows_a, rows_b, beta2: float) -> np.float32:
    """P(team A wins) with the engine's float64 host finish."""
    n, s2, mu_diff = team_stats(table, rows_a, rows_b)
    c2 = max(float(s2) + float(n) * beta2, 1e-20)
    t = float(mu_diff) / math.sqrt(c2)
    return np.float32(0.5 * math.erfc(-t / math.sqrt(2.0)))


def quality(table: np.ndarray, rows_a, rows_b, beta2: float) -> np.float32:
    """Match quality (draw probability) with the engine's host finish."""
    n, s2, mu_diff = team_stats(table, rows_a, rows_b)
    nb = float(n) * beta2
    denom = max(nb + float(s2), 1e-20)
    d = float(mu_diff)
    return np.float32(math.sqrt(nb / denom) * math.exp(-(d * d) / (2.0 * denom)))


def leaderboard(table: np.ndarray, n_players: int, k: int):
    """Top-k rated rows as (row, conservative_score) — descending score,
    ties broken toward the lower row index (the engine's stable
    descending sort, replicated with a stable sort)."""
    entries = []
    for row in range(n_players):
        if math.isnan(float(table[row, MU_LO])):
            continue
        entries.append((row, conservative_score(table, row)))
    entries.sort(key=lambda e: (-float(e[1]), e[0]))
    return entries[:k]


def tier_histogram(table: np.ndarray, n_players: int, edges):
    """(counts, rated_total): counts[0] is below edges[0], counts[i]
    covers [edges[i-1], edges[i]), counts[-1] is >= edges[-1] — float32
    comparisons, integer counts."""
    edges32 = [np.float32(e) for e in edges]
    rated = 0
    ge = [0] * len(edges32)
    for row in range(n_players):
        if math.isnan(float(table[row, MU_LO])):
            continue
        rated += 1
        score = conservative_score(table, row)
        for i, e in enumerate(edges32):
            if score >= e:
                ge[i] += 1
    counts = [rated - ge[0]]
    counts += [ge[i] - ge[i + 1] for i in range(len(ge) - 1)]
    counts.append(ge[-1])
    return counts, rated


def percentile(table: np.ndarray, n_players: int, score) -> tuple[int, int]:
    """(rows strictly below ``score``, rated total) — float32 compare."""
    s = np.float32(score)
    below = 0
    rated = 0
    for row in range(n_players):
        if math.isnan(float(table[row, MU_LO])):
            continue
        rated += 1
        if conservative_score(table, row) < s:
            below += 1
    return below, rated
