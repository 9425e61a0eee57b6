"""Telemetry history rings: a bounded in-process time series per metric.

The port's own copy of ``analyzer_tpu.obs.history`` (stdlib only), with the
same tiers, caps, payload and rendering. ``/metrics`` and ``/statusz``
answer "what is the value now"; the history sampler answers "what was the
trajectory INTO this state": it periodically records the registry's
counters, gauges and histogram quantiles into fixed-size rings with tiered
downsampling, so a live worker carries its own recent past (raw samples for
the last minutes, 10 s buckets for the last hour, 1 m buckets for the last
hours) in bounded memory.

Design constraints, in order:

  * **clock-injected** — the sampler NEVER reads a wall clock: every
    ``sample`` call takes ``now`` from the caller's clock. The worker
    drives it from ``Worker.clock``, so history contents are a function of
    that clock and the worker's output is bit-identical with the sampler
    on or off;
  * **stdlib only** — like the registry it samples (``cli history``
    renders saved histories offline);
  * **bounded** — ring capacities are fixed at construction; a series
    cap (:data:`MAX_SERIES`) bounds the whole structure against a
    labeled-series explosion the registry's own cardinality cap
    already throttles upstream.

Consumers: ``/historyz`` (JSON series for the scrape window),
``/statusz`` trend sparklines, the flight recorder's ``history.json``
(the trajectory INTO the incident rides every dump), ``cli history``,
and the SLO engine's multi-window burn rates (:mod:`obs.slo`).
"""

from __future__ import annotations

import threading

from analyzer_tpu_torch.logging_utils import get_logger

logger = get_logger(__name__)

#: (tier name, bucket seconds, ring capacity). ``raw`` keeps every
#: sample; coarser tiers keep one aggregate per bucket. At a 1 s sample
#: cadence: raw ~8 min, 10s ~1 h, 1m ~4 h of trajectory.
TIERS = (("raw", None, 512), ("10s", 10.0, 360), ("1m", 60.0, 240))

#: Hard cap on tracked series — the registry's per-family label cap
#: bounds growth upstream, this bounds the whole history structure.
MAX_SERIES = 1024

#: Histogram quantiles recorded as series (``<hist>:p99`` etc.).
HIST_QUANTILES = ("p50", "p99")

#: Unicode sparkline ramp for the /statusz + cli history trend render.
SPARK = "▁▂▃▄▅▆▇█"


def _coerce(value) -> float | None:
    """Gauge values may be None/bool/str — record what coerces, skip
    the rest (a string-valued gauge has no trajectory)."""
    if value is None:
        return None
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


class _Ring:
    """Fixed-capacity append ring of (t, last, min, max) rows. ``raw``
    rings carry last == min == max (one sample); bucketed rings carry
    the bucket aggregate."""

    __slots__ = ("capacity", "_rows", "_start")

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._rows: list = []
        self._start = 0  # index of the oldest row (circular)

    def append(self, row) -> None:
        if len(self._rows) < self.capacity:
            self._rows.append(row)
        else:
            self._rows[self._start] = row
            self._start = (self._start + 1) % self.capacity

    def last(self):
        if not self._rows:
            return None
        return self._rows[(self._start - 1) % len(self._rows)]

    def replace_last(self, row) -> None:
        self._rows[(self._start - 1) % len(self._rows)] = row

    def rows(self) -> list:
        """Oldest-first copy."""
        return self._rows[self._start:] + self._rows[: self._start]

    def __len__(self) -> int:
        return len(self._rows)


class _Series:
    """One metric's tiered rings. ``kind`` is ``counter`` (cumulative,
    deltas meaningful) or ``gauge`` (instantaneous; histogram quantiles
    record as gauges)."""

    __slots__ = ("name", "kind", "rings")

    def __init__(self, name: str, kind: str) -> None:
        self.name = name
        self.kind = kind
        self.rings = {tier: _Ring(cap) for tier, _, cap in TIERS}

    def record(self, t: float, value: float) -> None:
        self.rings["raw"].append((t, value, value, value))
        for tier, bucket_s, _cap in TIERS:
            if bucket_s is None:
                continue
            ring = self.rings[tier]
            bucket_t = (t // bucket_s) * bucket_s
            last = ring.last()
            if last is not None and last[0] == bucket_t:
                ring.replace_last(
                    (bucket_t, value, min(last[2], value),
                     max(last[3], value))
                )
            else:
                ring.append((bucket_t, value, value, value))

    def window_rows(self, window_s: float, now: float) -> list:
        """Oldest-first (t, last, min, max) rows covering
        ``[now - window_s, now]`` from the finest tier whose retained
        span reaches the window start (raw first, then coarser), with
        the last row at/before the window start included as the delta
        baseline. Falls back to the widest partial coverage when no
        tier reaches back far enough (young process)."""
        lo = now - window_s
        widest = None
        for tier, _bucket, _cap in TIERS:
            rows = [r for r in self.rings[tier].rows() if r[0] <= now]
            if not rows:
                continue
            if rows[0][0] <= lo:
                before = [r for r in rows if r[0] < lo]
                in_window = [r for r in rows if r[0] >= lo]
                return (before[-1:] if before else []) + in_window
            if widest is None or rows[0][0] < widest[0][0]:
                widest = rows
        return widest or []


class HistorySampler:
    """The sampler + ring store. One :meth:`sample` call records every
    registry counter/gauge (and configured histogram quantiles) at the
    caller's timestamp. Thread-safe; reads never block sampling for
    long (rings copy out under the lock)."""

    def __init__(self, registry=None, max_series: int = MAX_SERIES) -> None:
        self._registry = registry
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self.max_series = int(max_series)
        self.last_sample_t: float | None = None
        self.samples = 0
        # Pre-sample probes (devicemem, tier host bytes): refreshed so
        # the gauges the sampler is about to read are current. Probe
        # failures never reach the sampling path.
        self._probes: list = []

    # -- probes -----------------------------------------------------------
    def add_probe(self, fn) -> None:
        """Registers a nullary callable run before each sample (e.g.
        ``obs.devicemem.maybe_sample`` so device-memory gauges are fresh
        in every history row). Idempotent per function object."""
        with self._lock:
            if fn not in self._probes:
                self._probes.append(fn)

    def remove_probe(self, fn) -> None:
        with self._lock:
            if fn in self._probes:
                self._probes.remove(fn)

    # -- sampling ---------------------------------------------------------
    def _get_series(self, name: str, kind: str) -> _Series | None:
        s = self._series.get(name)
        if s is None:
            if len(self._series) >= self.max_series:
                return None
            s = self._series[name] = _Series(name, kind)
        return s

    def sample(self, now: float) -> None:
        """Records one row per live series at timestamp ``now`` (the
        CALLER's clock — the worker's). Monotonically non-decreasing
        ``now`` expected; an equal timestamp overwrites nothing (raw rings
        just gain a duplicate-t row, harmless). A probe that raises is
        logged and skipped: the sample still records."""
        from analyzer_tpu_torch.obs.registry import get_registry

        reg = self._registry or get_registry()
        with self._lock:
            probes = list(self._probes)
        for probe in probes:
            try:
                probe()
            except Exception:  # noqa: BLE001 — a probe must not stop sampling
                logger.exception("history probe %r failed", probe)
        snap = reg.snapshot()
        t = float(now)
        with self._lock:
            for name, value in snap["counters"].items():
                v = _coerce(value)
                if v is None:
                    continue
                s = self._get_series(name, "counter")
                if s is not None:
                    s.record(t, v)
            for name, value in snap["gauges"].items():
                v = _coerce(value)
                if v is None:
                    continue
                s = self._get_series(name, "gauge")
                if s is not None:
                    s.record(t, v)
            for name, summ in snap["histograms"].items():
                for q in HIST_QUANTILES:
                    v = _coerce(summ.get(q))
                    if v is None:
                        continue
                    s = self._get_series(f"{name}:{q}", "gauge")
                    if s is not None:
                        s.record(t, v)
            self.last_sample_t = t
            self.samples += 1
        reg.counter("history.samples_total").add(1)
        reg.gauge("history.series").set(len(self._series))

    # -- queries ----------------------------------------------------------
    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, name: str, tier: str = "raw") -> list:
        """Oldest-first ``[t, last, min, max]`` rows for ``name`` (empty
        when unknown)."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return []
            return [list(r) for r in s.rings[tier].rows()]

    def latest(self, name: str):
        """(t, value) of the newest raw sample, or None."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            row = s.rings["raw"].last()
            return None if row is None else (row[0], row[1])

    def window_delta(self, name: str, window_s: float, now: float):
        """Counter delta over ``[now - window_s, now]`` as
        ``(delta, span_s)`` from the finest covering tier, or None when
        fewer than two samples exist. The baseline is the OLDEST sample
        inside the window (counters only grow, so a partially covered
        window under-reports, never over-reports a burn)."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            rows = s.window_rows(window_s, now)
        if len(rows) < 2:
            return None
        delta = rows[-1][1] - rows[0][1]
        span = rows[-1][0] - rows[0][0]
        return (delta, span)

    def window_max(self, name: str, window_s: float, now: float):
        """Max observed value over the window (gauges), or None."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            rows = s.window_rows(window_s, now)
        if not rows:
            return None
        return max(r[3] for r in rows)

    def window_growth(self, name: str, window_s: float, now: float):
        """(last - first, span_s) over the window — the memory-leak
        burn-rate primitive (can be negative; gauges shrink)."""
        return self.window_delta(name, window_s, now)

    def last_change(self, name: str):
        """(t_of_last_value_change, current_value) over the raw ring —
        e.g. how long ``serve.view_version`` has sat at its value, in
        sampler time. None when unknown or single-valued so far."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            rows = s.rings["raw"].rows()
        if not rows:
            return None
        current = rows[-1][1]
        t_change = rows[0][0]
        for t, v, _mn, _mx in reversed(rows):
            if v != current:
                break
            t_change = t
        return (t_change, current)

    # -- exposition -------------------------------------------------------
    def to_json(
        self, prefix: str | None = None, tier: str | None = None
    ) -> dict:
        """The ``/historyz`` / ``history.json`` payload: every series
        (optionally name-prefix filtered) with its rings (optionally one
        tier). Rows are ``[t, last, min, max]``."""
        with self._lock:
            series = {
                name: s for name, s in self._series.items()
                if prefix is None or name.startswith(prefix)
            }
            out = {}
            for name, s in sorted(series.items()):
                rings = {
                    t: [list(r) for r in ring.rows()]
                    for t, ring in s.rings.items()
                    if (tier is None or t == tier) and len(ring)
                }
                out[name] = {"kind": s.kind, "rings": rings}
            return {
                "version": 1,
                "last_sample_t": self.last_sample_t,
                "samples": self.samples,
                "tiers": [[t, b, c] for t, b, c in TIERS],
                "series": out,
            }

    def sparkline(self, name: str, width: int = 32) -> str | None:
        """A unicode trend line of the newest ``width`` raw samples —
        counters as per-sample deltas (activity), gauges as values.
        None when fewer than two samples exist."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            rows = s.rings["raw"].rows()[-(width + 1):]
            kind = s.kind
        if len(rows) < 2:
            return None
        if kind == "counter":
            vals = [
                rows[i + 1][1] - rows[i][1] for i in range(len(rows) - 1)
            ]
        else:
            vals = [r[1] for r in rows[-width:]]
        return render_sparkline(vals)


def render_sparkline(vals: list) -> str:
    """Values -> one :data:`SPARK` character each (min..max scaled; a
    flat series renders as all-low, which reads as "quiet")."""
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return SPARK[0] * len(vals)
    scale = (len(SPARK) - 1) / (hi - lo)
    return "".join(SPARK[int((v - lo) * scale)] for v in vals)


def render_history(payload: dict, names=None, tier: str = "raw",
                   width: int = 48) -> str:
    """The human render of a ``to_json`` payload (``cli history``,
    trend sections): one line per series — sparkline, last value, and
    for counters the window delta."""
    series = payload.get("series", {})
    picked = names or sorted(series)
    out = []
    for name in picked:
        s = series.get(name)
        if s is None:
            continue
        rows = (s.get("rings") or {}).get(tier) or []
        if len(rows) < 2:
            continue
        rows = rows[-(width + 1):]
        if s.get("kind") == "counter":
            vals = [rows[i + 1][1] - rows[i][1] for i in range(len(rows) - 1)]
            tail = (
                f"last={rows[-1][1]:g} "
                f"delta={rows[-1][1] - rows[0][1]:+g}"
            )
        else:
            vals = [r[1] for r in rows[-width:]]
            tail = f"last={rows[-1][1]:g} min={min(vals):g} max={max(vals):g}"
        span = rows[-1][0] - rows[0][0]
        out.append(
            f"  {name:<44} {render_sparkline(vals)}  {tail} "
            f"(over {span:g}s)"
        )
    if not out:
        return "  (no series with enough history)\n"
    return "\n".join(out) + "\n"


_history_lock = threading.Lock()
_history: HistorySampler | None = None


def get_history() -> HistorySampler:
    """The process-wide history sampler (created on first use)."""
    global _history
    with _history_lock:
        if _history is None:
            _history = HistorySampler()
        return _history


def reset_history(**kwargs) -> HistorySampler:
    """Replaces the process-wide sampler with a fresh one (tests)."""
    global _history
    with _history_lock:
        _history = HistorySampler(**kwargs)
        return _history
