"""TrueSkill-consistent outcome resolution for soak-formed matches.

The matchmaker forms teams from the SERVED ratings; the outcome model
resolves them from the population's LATENT skills — the ground truth the
rating system is trying to estimate. The win model is exactly the
TrueSkill likelihood with the latent skills as zero-variance means:

    P(team A wins) = Phi((sum mu_A - sum mu_B) / (beta * sqrt(n)))

i.e. the ``c`` of :mod:`analyzer_tpu_torch.ops.trueskill` with every
``sigma_i = 0`` and no tau inflation — so the rating system's own
winprob estimates converge toward this model's probabilities as sigma
shrinks, which is what makes the closed loop a *calibration* testbed
and not just a load pattern.

Determinism: one seeded ``np.random.default_rng`` stream, exactly one
``random()`` read per resolved match.

The port's copy of ``analyzer_tpu.loadgen.outcomes``: float64 host math on
numpy and ``math``, so its probabilities and resolutions are the JAX
package's for the same population and seed.
"""

from __future__ import annotations

import math

import numpy as np

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.io.synthetic import SyntheticPlayers


class OutcomeModel:
    """Samples winners from the latent-skill gap through the TrueSkill
    link. ``resolve`` consumes exactly one RNG read per match, so the
    outcome sequence is a pure function of (seed, match sequence)."""

    def __init__(
        self,
        players: SyntheticPlayers,
        cfg: RatingConfig | None = None,
        seed: int = 0,
    ) -> None:
        self.players = players
        self.cfg = cfg or RatingConfig()
        # Distinct stream from the matchmaker's (same seed, different
        # spawn key): outcomes must not perturb formation draws.
        self.rng = np.random.default_rng(
            np.random.SeedSequence(entropy=seed, spawn_key=(1,))
        )

    def win_probability(self, team_a_rows, team_b_rows) -> float:
        """P(team A wins) from latent truth — the Phi link above."""
        skill = self.players.latent_skill
        gap = float(skill[list(team_a_rows)].sum()) - float(
            skill[list(team_b_rows)].sum()
        )
        n = len(team_a_rows) + len(team_b_rows)
        c = self.cfg.beta * math.sqrt(max(n, 1))
        t = gap / c
        return 0.5 * math.erfc(-t / math.sqrt(2.0))

    def resolve(self, team_a_rows, team_b_rows) -> tuple[int, float]:
        """(winner, p_a): winner is 0 when team A won. One RNG read."""
        p_a = self.win_probability(team_a_rows, team_b_rows)
        winner = 0 if self.rng.random() < p_a else 1
        return winner, p_a
