"""Span tracer: bounded in-memory ring, Chrome trace-event JSONL export.

The port's own copy of ``analyzer_tpu.obs.tracer`` (stdlib only).

Spans are complete events (``ph: "X"``) in the Chrome trace-event format,
so the export opens directly in Perfetto / ``chrome://tracing``.
Timestamps are microseconds on a per-tracer monotonic epoch
(``perf_counter``-based), with the wall-clock epoch recorded once in the
tracer so a snapshot consumer can reconstruct absolute times.

The ring is bounded (default 20k events) and lock-guarded: the pipeline
writer thread and the consumer thread both emit spans. Emission cost is
two ``perf_counter`` calls, one dict, one deque append — cheap enough for
per-batch and per-chunk granularity, NOT for per-match use.

Export is JSONL: one complete JSON trace event per line. Perfetto's JSON
importer accepts this (the trace-event "JSON array format" is tolerant of
a missing enclosing array), and line-oriented output means a crashed run
still leaves a loadable prefix.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

# Causal-trace binding (obs/tracectx.py): the CURRENT trace id for this
# thread, attached to every event emitted while bound. Lives here (not
# in tracectx) so _append needs no import and an unbound thread pays one
# thread-local getattr per event — nothing allocates when tracing is off.
_tls = threading.local()


def current_trace() -> str | None:
    """The trace id bound to this thread (None when unbound)."""
    return getattr(_tls, "trace", None)


@contextlib.contextmanager
def bind_trace(trace: str | None):
    """Binds ``trace`` as this thread's causal context: every span and
    instant emitted inside the block gains ``args["trace"] = trace``.
    ``None`` is a no-op, so call sites need no enabled-check of their
    own. Re-entrant — the previous binding is restored on exit."""
    if trace is None:
        yield
        return
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace
    try:
        yield
    finally:
        _tls.trace = prev


class Tracer:
    def __init__(self, maxlen: int = 20_000) -> None:
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=maxlen)
        self.epoch_wall = time.time()
        self.epoch_perf = time.perf_counter()
        self.dropped = 0

    def _now_us(self) -> float:
        return (time.perf_counter() - self.epoch_perf) * 1e6

    def _append(self, event: dict) -> None:
        trace = getattr(_tls, "trace", None)
        if trace is not None:
            # The causal id rides in args so existing span consumers
            # (Perfetto, snapshots) need no format change; setdefault
            # keeps an explicit trace=/batch= arg authoritative.
            event["args"].setdefault("trace", trace)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(event)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "app", **args):
        """Times a block as one complete trace event. ``args`` must be
        JSON-serializable scalars (they land in the event's ``args``).
        The block receives that dict (``with span(...) as args:``) to add
        what it learns only while it runs, such as a count of its work."""
        t0 = self._now_us()
        try:
            yield args
        finally:
            t1 = self._now_us()
            self._append({
                "name": name,
                "cat": cat,
                "ph": "X",
                "ts": round(t0, 1),
                "dur": round(t1 - t0, 1),
                "pid": os.getpid(),
                "tid": threading.get_ident() % 1_000_000,
                "args": args,
            })

    def instant(self, name: str, cat: str = "app", **args) -> None:
        """A zero-duration marker (``ph: "i"``) — dead-letters, engine
        degradations, retraces."""
        self._append({
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "ts": round(self._now_us(), 1),
            "pid": os.getpid(),
            "tid": threading.get_ident() % 1_000_000,
            "args": args,
        })

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def export_chrome(self, path: str) -> int:
        """Writes the ring as Chrome trace-event JSONL; returns the event
        count (the leading metadata line excluded). The first line is a
        ``trace_epoch`` metadata event carrying this tracer's wall-clock
        epoch — what lets the trace stitcher (obs/traceview.py
        ``load_forest``) align exports from DIFFERENT processes onto one
        timeline; Perfetto ignores unknown metadata."""
        events = self.events()
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps({
                "name": "trace_epoch", "cat": "__metadata", "ph": "M",
                "ts": 0.0, "pid": os.getpid(), "tid": 0,
                "args": {"epoch_wall": self.epoch_wall},
            }) + "\n")
            for event in events:
                f.write(json.dumps(event) + "\n")
        return len(events)


_tracer_lock = threading.Lock()
_tracer: Tracer | None = None


def get_tracer() -> Tracer:
    """The process-wide tracer (created on first use)."""
    global _tracer
    with _tracer_lock:
        if _tracer is None:
            _tracer = Tracer()
        return _tracer


def reset_tracer() -> Tracer:
    """Replaces the process-wide tracer with a fresh one (tests)."""
    global _tracer
    with _tracer_lock:
        _tracer = Tracer()
        return _tracer


def span(name: str, cat: str = "app", **args):
    """Module-level convenience: a span on the process-wide tracer."""
    return get_tracer().span(name, cat=cat, **args)


def instant(name: str, cat: str = "app", **args) -> None:
    """Module-level convenience: an instant on the process-wide tracer."""
    get_tracer().instant(name, cat=cat, **args)
