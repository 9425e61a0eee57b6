"""Typed rating configuration with reference-compatible environment variables.

The port's own copy of ``analyzer_tpu.config.RatingConfig``: same fields,
defaults, validation and ``from_env``. The reference reads its rating
hyperparameters from ``UNKNOWN_PLAYER_SIGMA`` (default 500) and ``TAU``
(default 1000/100) at import time (``rater.py:10-11``); both packages read
the same names into a frozen dataclass instead of module globals.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping


def _env(env: Mapping[str, str] | None) -> Mapping[str, str]:
    return os.environ if env is None else env


@dataclasses.dataclass(frozen=True)
class RatingConfig:
    """TrueSkill environment hyperparameters.

    Defaults mirror the reference environment at ``rater.py:30-37``:
    mu0=1500, sigma0=1000, beta=10/30*3000=1000, tau=TAU, draw_probability=0.
    ``draw_probability`` must stay 0: the closed-form two-team update in
    :mod:`analyzer_tpu_torch.ops.trueskill` exploits it (no draw margin).
    """

    mu0: float = 1500.0
    sigma0: float = 1000.0
    beta: float = 10.0 / 30.0 * 3000.0
    tau: float = 1000.0 / 100.0
    unknown_player_sigma: float = 500.0
    draw_probability: float = 0.0

    def __post_init__(self) -> None:
        if self.draw_probability != 0.0:
            raise ValueError(
                "analyzer_tpu_torch implements the draw_probability=0 closed "
                "form (the reference fixes draw_probability=0 at rater.py:36)"
            )
        if self.beta <= 0 or self.sigma0 <= 0:
            raise ValueError("beta and sigma0 must be positive")

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None) -> "RatingConfig":
        """Reads ``UNKNOWN_PLAYER_SIGMA`` and ``TAU`` like ``rater.py:10-11``
        (empty string falls back to the default, matching ``or``-defaults)."""
        e = _env(env)
        return cls(
            unknown_player_sigma=float(e.get("UNKNOWN_PLAYER_SIGMA") or 500),
            tau=float(e.get("TAU") or 1000 / 100.0),
        )

    @property
    def beta2(self) -> float:
        return self.beta * self.beta

    @property
    def tau2(self) -> float:
        return self.tau * self.tau
