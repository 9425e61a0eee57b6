"""Reference-compatible object API: ``get_trueskill_seed`` and ``rate_match``.

Counterpart of ``analyzer_tpu.rater``: the drop-in surface of the
reference's ``rater.py`` — same function names, same duck-typed object graph
(anything with the right attributes: match -> rosters -> participants ->
player / participant_items[0]), same side effects and logging events — with
the rating math in the closed-form PyTorch ops of
:mod:`analyzer_tpu_torch.ops.trueskill` on ``[1, 2, T]`` tensors. The host
packing, the gates and the write-back order are the JAX package's line for
line; ``tests/test_torch_rater.py`` holds the reference parity assertions
(``worker_test.py:66-189``) against this module.

Behavioral contracts preserved deliberately:
  * unsupported game modes mutate nothing (``rater.py:83-85``);
  * ``len(rosters) != 2`` or any ``went_afk == 1`` => quality=0 and
    ``any_afk=True`` on every participant_items[0], no rating update
    (``rater.py:90-106``);
  * quality is computed from the queue-specific matchup even though the
    reference comment says "shared" (``rater.py:140-141``);
  * ``trueskill_delta`` compares conservative estimates against the player's
    *current* attribute value at write time — which, for the test fixtures
    that alias one Participant object three times per roster
    (``worker_test.py:130``), reproduces the reference's sequential-write
    semantics exactly (``rater.py:147-157``);
  * seeding from a skill tier outside -1..29 raises KeyError, as the
    reference's dict lookup does (``rater.py:60``).

``rate_match(match, cfg=None, device=None)`` runs the update on the card
unless the caller names another device; it is slow by design (one tiny
dispatch and one fetch per match) and is never the measured path.
"""

from __future__ import annotations

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core import constants
from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE
from analyzer_tpu_torch.device import resolve_device
from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.ops import trueskill as ts

logger = get_logger(__name__)

_default_cfg: RatingConfig | None = None


def _cfg() -> RatingConfig:
    global _default_cfg
    if _default_cfg is None:
        _default_cfg = RatingConfig.from_env()
    return _default_cfg


def get_trueskill_seed(player, cfg: RatingConfig | None = None) -> tuple[float, float]:
    """(mu, sigma) prior for a player with no shared rating yet.

    Fallback 1: max of ranked/blitz rank points (None and 0 both mean
    missing), sigma = UNKNOWN_PLAYER_SIGMA * 2/3, mu = points + sigma so that
    mu - sigma reproduces the points exactly. Fallback 2: the skill-tier
    table with sigma = UNKNOWN_PLAYER_SIGMA. (``rater.py:42-62``.)
    Host-side float64 — seeding is feature preparation, not the hot loop.
    """
    cfg = cfg or _cfg()
    points = [
        p
        for p in (player.rank_points_ranked, player.rank_points_blitz)
        if p is not None and p != 0
    ]
    if points:
        sigma = cfg.unknown_player_sigma * (2.0 / 3.0)
        return float(max(points)) + sigma, sigma
    sigma = cfg.unknown_player_sigma
    return constants.VST_POINTS[player.skill_tier] + sigma, sigma


def _rate_arrays(mu_sh, sigma_sh, mu_q, sigma_q, mask, winner, cfg: RatingConfig):
    quality = ts.quality(mu_q, sigma_q, mask, cfg)
    sh_mu, sh_sigma = ts.two_team_update(mu_sh, sigma_sh, mask, winner, cfg)
    q_mu, q_sigma = ts.two_team_update(mu_q, sigma_q, mask, winner, cfg)
    return quality, sh_mu, sh_sigma, q_mu, q_sigma


def rate_match(match, cfg: RatingConfig | None = None, device=None):
    """Rates one match object graph in place (reference ``rater.py:69-169``)
    on ``device`` (None = the card)."""
    cfg = cfg or _cfg()
    dev = resolve_device(device)

    # Mode names are normalized by the upstream processor service.
    mode_id = constants.MODE_TO_ID.get(match.game_mode, constants.UNSUPPORTED_MODE_ID)
    if mode_id == constants.UNSUPPORTED_MODE_ID:
        logger.info("got unsupported game mode %s", match.game_mode)
        return
    col = "trueskill_" + match.game_mode

    any_afk = False
    if len(match.rosters) != 2:
        logger.error("got an invalid matchup %s", match.api_id)
        any_afk = True
    for participant in match.participants:
        participant.participant_items[0].any_afk = False
        if participant.went_afk == 1:
            logger.info("got an afk matchup %s", match.api_id)
            any_afk = True
            break
    if any_afk:
        match.trueskill_quality = 0
        for participant in match.participants:
            participant.participant_items[0].any_afk = True
        return

    # --- host -> tensor: pack the two rosters into padded [1, 2, T] arrays.
    team_size = max(
        MAX_TEAM_SIZE, *(len(r.participants) for r in match.rosters)
    )
    shape = (1, 2, team_size)
    mu_sh = np.zeros(shape, np.float32)
    sigma_sh = np.ones(shape, np.float32)
    mu_q = np.zeros(shape, np.float32)
    sigma_q = np.ones(shape, np.float32)
    mask = np.zeros(shape, bool)

    for ti, roster in enumerate(match.rosters):
        for si, participant in enumerate(roster.participants):
            player = participant.player[0]
            if player.trueskill_mu is not None:
                m_sh, s_sh = float(player.trueskill_mu), float(player.trueskill_sigma)
            else:
                m_sh, s_sh = get_trueskill_seed(player, cfg)
            q_prior_mu = getattr(player, col + "_mu")
            if q_prior_mu is not None:
                m_q, s_q = float(q_prior_mu), float(getattr(player, col + "_sigma"))
            else:
                m_q, s_q = m_sh, s_sh  # fall back to the shared prior
            mu_sh[0, ti, si] = m_sh
            sigma_sh[0, ti, si] = s_sh
            mu_q[0, ti, si] = m_q
            sigma_q[0, ti, si] = s_q
            mask[0, ti, si] = True

    logger.info("got a valid matchup %s", match.api_id)
    # The reference encodes ranks as [int(not r.winner) for r in rosters]
    # (rater.py:144); with draw_probability=0 exactly one roster must win.
    # Corrupt flags (both or neither marked winner) would silently produce a
    # bogus update — fail loudly instead so the service's failure policy
    # (dead-letter the batch, worker.py:110-120) handles the bad record.
    w0, w1 = bool(match.rosters[0].winner), bool(match.rosters[1].winner)
    if w0 == w1:
        raise ValueError(
            f"match {match.api_id!r}: rosters have inconsistent winner flags "
            f"({w0}, {w1}); exactly one team must win"
        )
    winner = np.asarray([0 if w0 else 1], np.int32)

    quality, sh_mu, sh_sigma, q_mu, q_sigma = (
        x.cpu().numpy() for x in _rate_arrays(
            *(torch.from_numpy(a).to(dev)
              for a in (mu_sh, sigma_sh, mu_q, sigma_q, mask, winner)),
            cfg,
        )
    )

    # --- tensor -> host write-back, in the reference's traversal order.
    match.trueskill_quality = float(quality[0])

    for ti, roster in enumerate(match.rosters):
        for si, participant in enumerate(roster.participants):
            player = participant.player[0]
            new_mu = float(sh_mu[0, ti, si])
            new_sigma = float(sh_sigma[0, ti, si])
            if player.trueskill_mu is not None:
                participant.trueskill_delta = (new_mu - new_sigma) - (
                    float(player.trueskill_mu) - float(player.trueskill_sigma)
                )
            else:
                participant.trueskill_delta = 0
            player.trueskill_mu = new_mu
            participant.trueskill_mu = new_mu
            player.trueskill_sigma = new_sigma
            participant.trueskill_sigma = new_sigma

    for ti, roster in enumerate(match.rosters):
        for si, participant in enumerate(roster.participants):
            player = participant.player[0]
            items = participant.participant_items[0]
            new_mu = float(q_mu[0, ti, si])
            new_sigma = float(q_sigma[0, ti, si])
            setattr(player, col + "_mu", new_mu)
            setattr(items, col + "_mu", new_mu)
            setattr(player, col + "_sigma", new_sigma)
            setattr(items, col + "_sigma", new_sigma)
