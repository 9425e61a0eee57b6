"""The traced window: a ``torch.profiler`` capture of the device and the
program's spans, reduced to what the per-layer readers need.

  * device intervals: every kernel, copy and set on the card, merged into
    busy intervals; ``busy_s`` is their union's length;
  * the host clock of the capture: a marker kernel launched right after a
    synchronize at the window's start ties the profiler's time base to
    ``time.perf_counter`` (to within a launch);
  * the breakdown: the ten device operations that took most time, and the
    ten longest kinds of idle gap, each named by the program's spans that
    were open on the host in the middle of the gap.
"""

from __future__ import annotations

import time
from collections import defaultdict

#: Length of the marker kernel that ties the capture's clock to the host's.
_MARKER_CYCLES = 1000


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(intervals) -> float:
    return sum(e - s for s, e in merge(intervals))


class Capture:
    """``with Capture(torch, device) as cap:`` around the window. After it,
    ``cap.ops`` holds ``(name, start_s, end_s)`` of every device operation
    on the host's ``perf_counter`` clock."""

    def __init__(self, torch, device) -> None:
        self.torch = torch
        self.device = device
        self.ops: list[tuple[str, float, float]] = []
        self._prof = None
        self._host_mark = None

    def __enter__(self) -> "Capture":
        torch = self.torch
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        self._prof = prof
        torch.cuda.synchronize(self.device)
        self._host_mark = time.perf_counter()
        torch.cuda._sleep(_MARKER_CYCLES)
        return self

    def __exit__(self, *exc) -> bool:
        self.torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._collect()
        return False

    def _collect(self) -> None:
        raw = []
        for evt in self._prof.events():
            tr = getattr(evt, "time_range", None)
            if tr is None or tr.end <= tr.start:
                continue
            dev = str(getattr(evt, "device_type", ""))
            if "CUDA" not in dev and "cuda" not in dev.lower():
                continue
            raw.append((evt.name, tr.start * 1e-6, tr.end * 1e-6))
        if not raw:
            return
        marks = [r for r in raw if "sleep" in r[0].lower() or "spin" in r[0].lower()]
        base = min(r[1] for r in (marks or raw))
        offset = self._host_mark - base
        self.ops = [(n, s + offset, e + offset) for n, s, e in raw]


def device_op_totals(ops, t0: float, t1: float, limit: int = 10) -> list[list]:
    """The ``limit`` device operations that took most time inside
    ``[t0, t1]``: [[name, seconds]]."""
    tot: dict[str, float] = defaultdict(float)
    for name, s, e in ops:
        if e > t0 and s < t1:
            tot[name[:64]] += min(e, t1) - max(s, t0)
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:limit]]


def idle_gaps(ops, spans, t0: float, t1: float, limit: int = 10) -> list[list]:
    """Idle time of the device inside ``[t0, t1]``, summed by what the host
    was doing: the names of the program's spans open at each gap's middle
    (``no_span_open`` where none was), longest first."""
    busy = merge([(max(s, t0), min(e, t1)) for _, s, e in ops if e > t0 and s < t1])
    gaps = []
    cur = t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    tot: dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        names = sorted({sp["name"] for sp in spans if sp["t0"] <= mid < sp["t1"]})
        tot["+".join(names) if names else "no_span_open"] += g1 - g0
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:limit]]


def program_spans(tracer, t0: float, t1: float) -> list[dict]:
    """The program's complete spans that overlap ``[t0, t1]``, on the
    ``perf_counter`` clock: ``{"name", "t0", "t1", "tid", "args"}``."""
    out = []
    for ev in tracer.events():
        if ev.get("ph") != "X":
            continue
        s = tracer.epoch_perf + ev["ts"] * 1e-6
        e = s + ev["dur"] * 1e-6
        if e > t0 and s < t1:
            out.append({"name": ev["name"], "t0": s, "t1": e,
                        "tid": ev.get("tid"), "args": ev.get("args", {})})
    return out

