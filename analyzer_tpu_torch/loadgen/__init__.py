"""loadgen: the closed-loop matchmaking soak harness.

A matchmaker samples active players by an activity distribution, queues
them by the conservative rating the serve plane CURRENTLY publishes,
balances teams through the QueryEngine's winprob / quality path, resolves
outcomes with a TrueSkill-consistent win model, and publishes the finished
matches onto the ``analyze`` queue — while a query workload hits
``/v1/*``. Rating drift feeds back into matchmaking as in production, and
the :class:`~analyzer_tpu_torch.loadgen.driver.SoakDriver` runs broker ->
worker -> commit -> view publish under that load with per-tick SLO
samples and a ``SOAK_r*.json`` artifact (``cli soak --out``).

Everything here is DETERMINISTIC per (seed, config): player sampling,
match formation, outcomes and query traffic draw from seeded
``np.random.default_rng`` streams, and pacing runs on a virtual clock.

The port's copy of ``analyzer_tpu.loadgen``, on the card by default.
"""

from analyzer_tpu_torch.loadgen.driver import SoakConfig, SoakDriver
from analyzer_tpu_torch.loadgen.matchmaker import (
    EngineServeClient,
    FormedMatch,
    HttpServeClient,
    Matchmaker,
)
from analyzer_tpu_torch.loadgen.outcomes import OutcomeModel
from analyzer_tpu_torch.loadgen.shaper import TrafficShaper, VirtualClock

__all__ = [
    "EngineServeClient",
    "FormedMatch",
    "HttpServeClient",
    "Matchmaker",
    "OutcomeModel",
    "SoakConfig",
    "SoakDriver",
    "TrafficShaper",
    "VirtualClock",
]
