"""50-digit mpmath oracle for the closed-form TrueSkill update.

The port's own copy of ``analyzer_tpu.ops.oracle`` (mpmath only, no torch).
The reference runs its factor graph on mpmath at 50 decimal digits
(``rater.py:6-8,31``). For the two-team draw_probability=0 case the graph
converges to the closed form implemented in
:mod:`analyzer_tpu_torch.ops.trueskill` — so this module IS the reference
numerics, at reference precision, for validating the float32 kernels: the
port's ``ops`` in ``tests/test_torch_oracle.py`` and a sample of the CUDA
fused window's outputs in ``chip_smoke.py``'s ``[oracle]`` phase.
Host-side and slow by design; never imported by the rating path.
"""

from __future__ import annotations

import mpmath as mp

mp.mp.dps = 50  # the reference's precision (rater.py:8)


def _phi(t):
    return mp.exp(-t * t / 2) / mp.sqrt(2 * mp.pi)


def _Phi(t):
    return mp.erfc(-t / mp.sqrt(2)) / 2


def v_win(t):
    """phi(t)/Phi(t) at 50 digits."""
    t = mp.mpf(t)
    return _phi(t) / _Phi(t)


def w_win(t):
    t = mp.mpf(t)
    v = v_win(t)
    return v * (v + t)


def two_team_update(mu, sigma, winner, beta, tau):
    """Closed-form update for two teams of players at 50 digits.

    mu, sigma: nested lists [2][team_size] of priors.
    Returns (new_mu, new_sigma) with the same nesting.
    """
    beta = mp.mpf(beta)
    tau = mp.mpf(tau)
    s2 = [[mp.mpf(s) ** 2 + tau**2 for s in team] for team in sigma]
    n = sum(len(t) for t in mu)
    c2 = sum(sum(team) for team in s2) + n * beta**2
    c = mp.sqrt(c2)
    mu_w = sum(mp.mpf(m) for m in mu[winner])
    mu_l = sum(mp.mpf(m) for m in mu[1 - winner])
    t = (mu_w - mu_l) / c
    v = v_win(t)
    w = w_win(t)
    new_mu, new_sigma = [[], []], [[], []]
    for ti in range(2):
        sign = 1 if ti == winner else -1
        for si in range(len(mu[ti])):
            new_mu[ti].append(mp.mpf(mu[ti][si]) + sign * s2[ti][si] / c * v)
            new_sigma[ti].append(
                mp.sqrt(s2[ti][si] * (1 - s2[ti][si] / c2 * w))
            )
    return new_mu, new_sigma


def quality(mu, sigma, beta):
    """Two-team draw-probability quality at 50 digits (no tau inflation —
    matches trueskill's env.quality, rater.py:141)."""
    beta = mp.mpf(beta)
    n = sum(len(t) for t in mu)
    s2_sum = sum(sum(mp.mpf(s) ** 2 for s in team) for team in sigma)
    denom = n * beta**2 + s2_sum
    mu_diff = sum(mp.mpf(m) for m in mu[0]) - sum(mp.mpf(m) for m in mu[1])
    return mp.sqrt(n * beta**2 / denom) * mp.exp(-(mu_diff**2) / (2 * denom))
