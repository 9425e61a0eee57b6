"""Runtime telemetry of the port: metrics registry and span tracer.

Own copies of the two stdlib-only cores of ``analyzer_tpu.obs``:

  * :mod:`~analyzer_tpu_torch.obs.registry` — process-wide counters, gauges
    and histograms with quantile summaries and a JSON snapshot;
  * :mod:`~analyzer_tpu_torch.obs.tracer` — span tracing into a bounded
    ring, exported as Chrome trace-event JSONL;

plus :mod:`~analyzer_tpu_torch.obs.httpd`, the route-table HTTP plumbing
the serve plane listens through. ``analyzer_tpu.obs.retrace.track_jit``
has no counterpart here: it counts a jitted entry point's recompiles, and
nothing in the port is jitted — every device function is eager PyTorch or
a kernel built once.
"""

from analyzer_tpu_torch.obs.registry import (
    MetricsRegistry,
    get_registry,
    reset_registry,
)
from analyzer_tpu_torch.obs.tracer import (
    Tracer,
    bind_trace,
    current_trace,
    get_tracer,
    instant,
    reset_tracer,
    span,
)

__all__ = [
    "MetricsRegistry",
    "Tracer",
    "bind_trace",
    "current_trace",
    "get_registry",
    "get_tracer",
    "instant",
    "reset_registry",
    "reset_tracer",
    "span",
]
