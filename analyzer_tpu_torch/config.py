"""Typed configuration with reference-compatible environment variables.

The port's own copy of ``analyzer_tpu.config``: ``RatingConfig`` and
``ServiceConfig`` with the same fields, defaults, validation and
``from_env``. The reference reads its rating hyperparameters from
``UNKNOWN_PLAYER_SIGMA`` (default 500) and ``TAU`` (default 1000/100) and
twelve service variables at import time (``rater.py:10-11``,
``worker.py:16-27``); both packages read the same names into frozen
dataclasses instead of module globals.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping


def _env(env: Mapping[str, str] | None) -> Mapping[str, str]:
    return os.environ if env is None else env


# Clamp range for the pipelined loop's commit lag (in-flight batches past
# the last known commit). The floor keeps at least one full round trip
# overlapped; the ceiling bounds the failure blast radius (an aborted
# stream reprocesses up to `lag` batches sequentially) and the broker's
# unacked-delivery headroom (`ServiceConfig.prefetch_count`).
PIPELINE_MIN_LAG = 2
PIPELINE_MAX_LAG = 12


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


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Service-shell knobs, mirroring ``worker.py:16-27`` name-for-name.

    ``database_uri`` is required there (plain ``os.environ[...]`` KeyError at
    ``worker.py:17``); here it is optional because the in-memory store and the
    tensor pipeline do not need a database.
    """

    rabbitmq_uri: str = "amqp://localhost"
    database_uri: str | None = None
    batch_size: int = 500
    chunk_size: int = 100
    idle_timeout: float = 1.0
    queue: str = "analyze"
    do_crunch_match: bool = False
    crunch_queue: str = "crunch_global"
    do_telesuck_match: bool = False
    telesuck_queue: str = "telesuck"
    do_sew_match: bool = False
    sew_queue: str = "sew"
    # Not reference vars: the pipelined consume loop (service/pipeline.py).
    # Default False for direct construction (tests get the sequential,
    # reference-shaped loop); from_env defaults ON — production workers
    # want the overlap, and PIPELINE=false restores the sequential loop.
    # ``pipeline_lag=None`` means auto-tune: the worker measures the
    # dispatch->fetch round trip and its per-batch host time at warmup
    # and sets lag ~ ceil(RTT / host_time) + 1, clamped to
    # [PIPELINE_MIN_LAG, PIPELINE_MAX_LAG] (service/pipeline.py:
    # choose_pipeline_lag). Set PIPELINE_LAG to pin a fixed depth.
    pipeline: bool = False
    pipeline_lag: int | None = None

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None) -> "ServiceConfig":
        e = _env(env)
        return cls(
            rabbitmq_uri=e.get("RABBITMQ_URI") or "amqp://localhost",
            database_uri=e.get("DATABASE_URI"),
            batch_size=int(e.get("BATCHSIZE") or 500),
            chunk_size=int(e.get("CHUNKSIZE") or 100),
            idle_timeout=float(e.get("IDLE_TIMEOUT") or 1),
            queue=e.get("QUEUE") or "analyze",
            do_crunch_match=e.get("DOCRUNCHMATCH") == "true",
            crunch_queue=e.get("CRUNCH_QUEUE") or "crunch_global",
            do_telesuck_match=e.get("DOTELESUCKMATCH") == "true",
            telesuck_queue=e.get("TELESUCK_QUEUE") or "telesuck",
            do_sew_match=e.get("DOSEWMATCH") == "true",
            sew_queue=e.get("SEW_QUEUE") or "sew",
            pipeline=(e.get("PIPELINE") or "true") == "true",
            pipeline_lag=(
                int(e["PIPELINE_LAG"]) if e.get("PIPELINE_LAG") else None
            ),
        )

    @property
    def failed_queue(self) -> str:
        return self.queue + "_failed"

    @property
    def prefetch_count(self) -> int:
        """AMQP prefetch bound for the broker connection.

        The reference pins ``prefetch_count=BATCHSIZE`` (``worker.py:91``)
        — right for the sequential loop, where at most one batch is ever
        unacked. The pipelined loop defers each batch's acks until its
        commit is harvested, so up to ``lag + 1`` batches are legitimately
        unacked at once; with only one batch-size of headroom the broker
        would withhold batch N+1's deliveries until batch N fully acked,
        serializing the pipeline back to the sequential loop. Auto-tuned
        lag sizes for the clamp ceiling (the measured lag is unknown at
        connect time; over-provisioned prefetch costs only broker-side
        buffering)."""
        if not self.pipeline:
            return self.batch_size
        # max(1, ...) mirrors PipelineEngine's own clamp: PIPELINE_LAG=0
        # still runs the engine at lag 1 (two batches legitimately
        # unacked), so prefetch must cover two.
        lag = (
            PIPELINE_MAX_LAG if self.pipeline_lag is None
            else max(1, self.pipeline_lag)
        )
        return self.batch_size * (lag + 1)
