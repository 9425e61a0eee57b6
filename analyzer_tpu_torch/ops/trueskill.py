"""Closed-form two-team TrueSkill update, quality and win probability.

Counterpart of ``analyzer_tpu.ops.trueskill``. The reference only rates
two teams with draw_probability=0 (``rater.py:36,91``), for which the
factor graph converges in one pass to the closed form

    c^2   = sum_i (sigma_i^2 + tau^2) + n * beta^2      (all players, n total)
    t     = (mu_winners - mu_losers) / c
    v     = phi(t) / Phi(t)        w = v * (v + t)
    mu_i    <- mu_i +/- (sigma_i^2 + tau^2) / c * v     (+ winners, - losers)
    sigma_i <- sqrt((sigma_i^2 + tau^2) * (1 - (sigma_i^2 + tau^2) / c^2 * w))

Arrays are ``[..., 2, T]``: two teams of ``T`` padded slots with a boolean
``mask`` of real players.

Two choices make this module and the CUDA kernel
(``kernels/csrc/rate_match.cuh``) compute the same float32 operations in
the same order:

  * the team sums are explicit add chains, team 0 then team 1, slot 0..T-1,
    starting from 0 (never ``.sum()``, whose order is the library's), over
    masked terms ``x * maskf``;
  * ``sqrt`` is taken in float64 and rounded to float32: torch's CPU float32
    ``sqrt`` is not always correctly rounded, and a correctly rounded
    float32 square root equals the rounded float64 one (the kernel builds
    with nvcc's default IEEE ``sqrtf``).
"""

from __future__ import annotations

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.ops.normal import cdf, v_win, w_win

_TINY = float(np.float32(1e-20))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (via float64)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _f32(x: float) -> float:
    """A Python float holding ``x`` rounded to float32, as JAX's
    ``jnp.asarray(x, float32)`` holds it."""
    return float(np.float32(x))


def _masked_sum_stats(mu, sigma2, mask):
    """(n, sigma2_sum, mu_diff) over the (2, T) team axes, as explicit add
    chains in team-major, slot-minor order."""
    maskf = mask.to(mu.dtype)
    mu_m = mu * maskf
    s2_m = sigma2 * maskf
    zero = torch.zeros(mu.shape[:-2], dtype=mu.dtype, device=mu.device)
    n = zero
    s2_sum = zero
    team_mu = [zero, zero]
    for k in range(2):
        for t in range(mu.shape[-1]):
            n = n + maskf[..., k, t]
            s2_sum = s2_sum + s2_m[..., k, t]
            team_mu[k] = team_mu[k] + mu_m[..., k, t]
    return n, s2_sum, team_mu[0] - team_mu[1]


def two_team_update(
    mu: torch.Tensor,
    sigma: torch.Tensor,
    mask: torch.Tensor,
    winner: torch.Tensor,
    cfg: RatingConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One TrueSkill win/loss update for a batch of two-team matches.

    ``mu``, ``sigma``, ``mask`` are ``[..., 2, T]``; ``winner`` ``[...]``
    is the index (0 or 1) of the winning team. Masked slots pass through
    unchanged."""
    tau2 = _f32(cfg.tau2)
    beta2 = _f32(cfg.beta2)

    s2 = sigma * sigma + tau2  # dynamics-inflated prior variance
    n, s2_sum, mu_diff = _masked_sum_stats(mu, s2, mask)
    c2 = torch.clamp(s2_sum + n * beta2, min=_TINY)
    c = sqrt_rn(c2)

    sign = (1 - 2 * winner).to(mu.dtype)  # +1 if team 0 won
    t = sign * mu_diff / c
    v = v_win(t)
    w = w_win(t, v)

    # +1 for every slot of the winning team, -1 on the losing team.
    team_pm = torch.tensor([[1.0], [-1.0]], dtype=mu.dtype, device=mu.device)
    team_sign = sign[..., None, None] * team_pm  # [..., 2, 1]
    mu_new = mu + team_sign * (s2 / c[..., None, None]) * v[..., None, None]
    sigma_new = sqrt_rn(
        s2 * (1.0 - (s2 / c2[..., None, None]) * w[..., None, None])
    )
    return torch.where(mask, mu_new, mu), torch.where(mask, sigma_new, sigma)


def quality(
    mu: torch.Tensor, sigma: torch.Tensor, mask: torch.Tensor, cfg: RatingConfig
) -> torch.Tensor:
    """Match quality (``env.quality``):
    ``sqrt(n beta^2 / D) * exp(-(mu_0 - mu_1)^2 / (2 D))`` with
    ``D = n beta^2 + sum_i sigma_i^2`` (no tau inflation)."""
    beta2 = _f32(cfg.beta2)
    n, s2_sum, mu_diff = _masked_sum_stats(mu, sigma * sigma, mask)
    nb2 = n * beta2
    denom = torch.clamp(nb2 + s2_sum, min=_TINY)
    return sqrt_rn(nb2 / denom) * torch.exp(
        -(mu_diff * mu_diff) / (2.0 * denom)
    )


def win_probability(
    mu: torch.Tensor, sigma: torch.Tensor, mask: torch.Tensor, cfg: RatingConfig
) -> torch.Tensor:
    """P(team 0 beats team 1) = Phi((mu_0 - mu_1) / c),
    c^2 = sum sigma^2 + n beta^2."""
    beta2 = _f32(cfg.beta2)
    n, s2_sum, mu_diff = _masked_sum_stats(mu, sigma * sigma, mask)
    c = sqrt_rn(torch.clamp(n * beta2 + s2_sum, min=_TINY))
    return cdf(mu_diff / c)
