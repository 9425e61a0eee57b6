"""Observability: phase timing, throughput counters, profiler traces.

The port's counterpart of ``analyzer_tpu.utils.profiling``. The classes
are thin views over the process-wide registry and tracer:
``PhaseTimer.phase`` keeps its local totals (the CLI stats lines read
them) and also records a ``phase_seconds{phase=...}`` histogram
observation plus a ``phase.<name>`` span, so a ``--metrics-out`` snapshot
carries the same numbers. ``Counters.add`` mirrors into registry counters
the same way.

``trace`` wraps ``torch.profiler`` (CPU + CUDA activities) so a whole
trace, viewable in Perfetto and attributable by ``cli profile``, can be
captured around any run with one line; it degrades to a no-op where the
profiler cannot start.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

from analyzer_tpu_torch.obs import get_registry, get_tracer


@dataclasses.dataclass
class PhaseTimer:
    """Accumulating wall-clock phase timer.

    >>> t = PhaseTimer()
    >>> with t.phase("pack"):
    ...     do_packing()
    >>> t.report()   # {'pack': 1.23}
    """

    totals: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    counts: dict = dataclasses.field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with get_tracer().span(f"phase.{name}", cat="phase"):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.totals[name] += dt
                self.counts[name] += 1
                get_registry().histogram(
                    "phase_seconds", phase=name
                ).observe(dt)

    def report(self) -> dict[str, float]:
        return dict(self.totals)

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        parts = [
            f"{k}={v:.3f}s({100 * v / total:.0f}%)"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return " ".join(parts)


@dataclasses.dataclass
class Counters:
    """Monotonic counters with rate computation. Mirrors every add into
    the process-wide registry (``app.<name>_total``).

    ``rate`` is anchored at the FIRST ``add`` of each counter, not at
    object construction, so a counter that starts moving late reports the
    rate over its active window; ``reset`` re-arms the anchors."""

    values: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    _first_at: dict = dataclasses.field(default_factory=dict, repr=False)

    def add(self, name: str, n: int = 1) -> None:
        if name not in self._first_at:
            self._first_at[name] = time.perf_counter()
        self.values[name] += n
        get_registry().counter(f"app.{name}_total").add(n)

    def rate(self, name: str) -> float:
        t0 = self._first_at.get(name)
        if t0 is None:
            return 0.0
        dt = time.perf_counter() - t0
        return self.values[name] / dt if dt > 0 else 0.0

    def reset(self) -> None:
        """Clears values and rate anchors (a new measurement window). The
        registry mirrors are monotonic by contract and keep running."""
        self.values.clear()
        self._first_at.clear()

    def report(self) -> dict[str, int]:
        return dict(self.values)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace around a block into ``log_dir`` (the
    layout :mod:`analyzer_tpu_torch.obs.profview` reads:
    ``<log_dir>/plugins/profile/<run>/<host>.trace.json.gz``). None
    disables it, and a profiler that cannot start degrades to a no-op
    instead of failing the run.

    Only the profiler start/stop are guarded: an exception raised by the
    BODY always propagates."""
    if not log_dir:
        yield
        return
    from analyzer_tpu_torch.obs import prof

    try:
        prof._start_trace(log_dir)
    except Exception:  # noqa: BLE001 — observability must not kill the run
        yield
        return
    try:
        yield
    finally:
        try:
            prof._stop_trace()
        except Exception:  # noqa: BLE001 — ditto; never mask the body error
            pass
