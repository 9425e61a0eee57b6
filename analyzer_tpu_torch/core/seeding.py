"""TrueSkill seeding for players with no rating yet, in numpy on the host.

Counterpart of ``analyzer_tpu.core.seeding`` (:func:`trueskill_seed_host`
is its ingest entry point), with the
semantics of the reference's ``get_trueskill_seed`` (``rater.py:42-62``):

  * fallback 1 — seed from rank points: ``max(rank_points_ranked,
    rank_points_blitz)`` where NaN and 0 both mean "missing"; sigma =
    UNKNOWN_PLAYER_SIGMA * 2/3, mu = points + sigma;
  * fallback 2 — seed from the skill-tier table: sigma =
    UNKNOWN_PLAYER_SIGMA, mu = vst_points[tier] + sigma, tiers clamped to
    -1..29.

Only add, compare and select run here, in the dtype of the inputs, so the
float32 seed columns are bit-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core import constants


def trueskill_seed(
    rank_points_ranked: np.ndarray,
    rank_points_blitz: np.ndarray,
    skill_tier: np.ndarray,
    cfg: RatingConfig,
) -> tuple[np.ndarray, np.ndarray]:
    """Elementwise seed over same-shaped feature arrays. Returns (mu, sigma)
    in the dtype of ``rank_points_ranked``."""
    rr_in = np.asarray(rank_points_ranked)
    dtype = rr_in.dtype
    neg_inf = dtype.type(-np.inf)
    rb_in = np.asarray(rank_points_blitz, dtype)

    rr = np.where(np.isnan(rr_in) | (rr_in == 0), neg_inf, rr_in)
    rb = np.where(np.isnan(rb_in) | (rb_in == 0), neg_inf, rb_in)
    rank_points = np.maximum(rr, rb)
    has_points = rank_points > neg_inf

    sigma_points = dtype.type(cfg.unknown_player_sigma * (2.0 / 3.0))
    sigma_tier = dtype.type(cfg.unknown_player_sigma)

    table = constants.VST_TABLE.astype(dtype)
    tier_idx = np.clip(
        np.asarray(skill_tier), constants.MIN_SKILL_TIER, constants.MAX_SKILL_TIER
    ) - constants.MIN_SKILL_TIER
    tier_points = table[tier_idx]

    sigma = np.where(has_points, sigma_points, sigma_tier).astype(dtype)
    mu = np.where(
        has_points, rank_points + sigma_points, tier_points + sigma_tier
    ).astype(dtype)
    return mu, sigma


def trueskill_seed_host(
    rank_points_ranked, rank_points_blitz, skill_tier, cfg: RatingConfig
) -> tuple[np.ndarray, np.ndarray]:
    """Seeding for the host-side ingest paths (the SQL store and the
    service encoders): numpy in, numpy out. Counterpart of
    ``analyzer_tpu.core.seeding.trueskill_seed_host``, which pins its jitted
    seed to the CPU backend; :func:`trueskill_seed` already runs on the
    host here, so the seed columns are baked before the table is moved to
    its device, bit-equal to the JAX package's."""
    return trueskill_seed(
        np.asarray(rank_points_ranked), np.asarray(rank_points_blitz),
        np.asarray(skill_tier), cfg,
    )
