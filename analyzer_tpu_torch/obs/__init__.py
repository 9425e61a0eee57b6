"""Runtime telemetry of the port: metrics, spans, snapshots, device time.

Own copies of the stdlib-only modules of ``analyzer_tpu.obs`` the rating
path needs:

  * :mod:`~analyzer_tpu_torch.obs.registry` — process-wide counters, gauges
    and histograms with quantile summaries and a JSON snapshot;
  * :mod:`~analyzer_tpu_torch.obs.tracer` — span tracing into a bounded
    ring, exported as Chrome trace-event JSONL;
  * :mod:`~analyzer_tpu_torch.obs.snapshot` — the one-file JSON artifact
    (``cli rate --metrics-out``) and its Prometheus / summary renderings;
  * :mod:`~analyzer_tpu_torch.obs.tracectx` — causal trace context: the
    worker's ``batch.assemble`` join and the trace id bound to every span
    of a batch (on with ``ANALYZER_TPU_TRACE=1``);
  * :mod:`~analyzer_tpu_torch.obs.traceview` — the trace analyzer behind
    ``cli trace``;
  * :mod:`~analyzer_tpu_torch.obs.hw` — the peak table (with the H100)
    and the per-dispatch bytes/flops cost model;
  * :mod:`~analyzer_tpu_torch.obs.httpd` — the route-table HTTP plumbing
    the serve plane listens through;

the live planes a worker runs (the JAX package's, stdlib only):

  * :mod:`~analyzer_tpu_torch.obs.server` — obsd, the introspection
    endpoints (``/healthz /readyz /metrics /statusz /historyz /sloz
    /qualityz /debug/snapshot /debug/flight``);
  * :mod:`~analyzer_tpu_torch.obs.history` — the tiered history rings;
  * :mod:`~analyzer_tpu_torch.obs.slo` — the objective table, live burn
    rates (the :class:`Watchdog`) and the artifact verdict;
  * :mod:`~analyzer_tpu_torch.obs.flight` — the always-on flight
    recorder and its throttled dumps;
  * :mod:`~analyzer_tpu_torch.obs.audit` — the shadow audit of served
    responses against the bit-exact oracle;
  * :mod:`~analyzer_tpu_torch.obs.federate` — the fleet Collector and
    FleetServer (``cli fleet``);
  * :mod:`~analyzer_tpu_torch.obs.quality` — the calibration ledger
    (``/qualityz``);

and the device-aware ones, rebuilt on PyTorch:

  * :mod:`~analyzer_tpu_torch.obs.devicemem` — device-memory gauges from
    ``torch.cuda.memory_stats`` at chunk boundaries;
  * :mod:`~analyzer_tpu_torch.obs.prof` — opt-in ``torch.profiler``
    capture windows (the worker's ``profile_dir``);
  * :mod:`~analyzer_tpu_torch.obs.profview` — per-kernel device time,
    busy/idle split and the host-trace join of a capture
    (``cli profile``).

No counterpart: ``analyzer_tpu.obs.retrace`` (``track_jit``,
``install_jax_hooks``) counts a jitted entry point's recompiles, and
nothing in the port is jitted — every device function is eager PyTorch
or a kernel built once — so the snapshot's ``retraces`` block stays
empty and ``jax.retraces_total`` stays 0. Still to port (ROADMAP): the
offline tools of A16c, ``benchdiff`` and ``advisor``.
"""

from analyzer_tpu_torch.obs.audit import ShadowAuditor
from analyzer_tpu_torch.obs.devicemem import (
    maybe_sample as maybe_sample_device_memory,
    sample_device_memory,
)
from analyzer_tpu_torch.obs.flight import (
    FlightRecorder,
    get_flight_recorder,
    reset_flight_recorder,
)
from analyzer_tpu_torch.obs.history import (
    HistorySampler,
    get_history,
    render_history,
    reset_history,
)
from analyzer_tpu_torch.obs.prof import (
    DeviceProfiler,
    get_device_profiler,
    reset_device_profiler,
)
from analyzer_tpu_torch.obs.registry import (
    MetricsRegistry,
    get_registry,
    reset_registry,
)
from analyzer_tpu_torch.obs.slo import (
    STANDARD_OBJECTIVES,
    Watchdog,
    get_watchdog,
    reset_watchdog,
    soak_violations,
)
from analyzer_tpu_torch.obs.snapshot import (
    prometheus_text,
    render_summary,
    snapshot,
    write_chrome_trace,
    write_snapshot,
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
    "DeviceProfiler",
    "FlightRecorder",
    "HistorySampler",
    "MetricsRegistry",
    "STANDARD_OBJECTIVES",
    "ShadowAuditor",
    "Tracer",
    "Watchdog",
    "bind_trace",
    "current_trace",
    "get_device_profiler",
    "get_flight_recorder",
    "get_history",
    "get_registry",
    "get_tracer",
    "get_watchdog",
    "instant",
    "maybe_sample_device_memory",
    "prometheus_text",
    "render_history",
    "render_summary",
    "reset_device_profiler",
    "reset_flight_recorder",
    "reset_history",
    "reset_registry",
    "reset_tracer",
    "reset_watchdog",
    "sample_device_memory",
    "snapshot",
    "soak_violations",
    "span",
    "write_chrome_trace",
    "write_snapshot",
]
