"""Cross-cutting utilities: phase timers, counters and profiler traces
(the port's counterpart of ``analyzer_tpu.utils``)."""

from analyzer_tpu_torch.utils.profiling import Counters, PhaseTimer, trace

__all__ = ["Counters", "PhaseTimer", "trace"]
