"""Causal trace context: follow one match from enqueue to served-visible.

The port's own copy of ``analyzer_tpu.obs.tracectx`` (stdlib only, the
same headers, ids and instants), so a worker of either package leaves an
export ``cli trace`` of either package reconstructs.

The PR-2 tracer records *what* each thread was doing; nothing connected
a specific match's broker message to the batch that rated it, the feed
windows that staged it, the commit that made it durable, and the view
version that made it queryable. This module is that connective tissue:

  * :func:`mint` creates a :class:`TraceContext` — ``(trace_id,
    parent span id, enqueue timestamp)`` — when a match enters the
    broker, and :func:`headers` / :func:`from_headers` carry it through
    the message headers (``x-trace-id`` / ``x-parent-span`` /
    ``x-enqueue-us``), so the worker can compute queue wait without any
    shared state with the publisher;
  * :func:`assemble` is the worker-side join point: one
    ``batch.assemble`` instant records which match traces entered which
    batch (the batch gets its own ``b<N>`` trace id), and
    :func:`~analyzer_tpu_torch.obs.tracer.bind_trace` then tags every span the
    batch's pipeline emits — encode, pack, the feed thread's
    materialize/transfer, dispatch, the writer thread's fetch/commit,
    and the view publish — with that id, turning the Perfetto export
    into a linked tree across threads instead of disjoint lanes;
  * ``obs/traceview.py`` reconstructs per-match and
    per-batch timelines from the tagged events (``cli trace``).

Cost contract: **zero-allocation when disabled**. Every entry point
checks one module-level bool first and returns ``None`` untouched —
no ids are minted, no headers attached, no instants emitted, and the
tracer's per-event context lookup finds an empty thread-local. Enabling
tracing must also never perturb behavior: ids come from a process-local
counter and timestamps are only ever *recorded*, never branched on, so
a worker's results are the same with tracing on or off.

Enable via :func:`enable_tracing` or ``ANALYZER_TPU_TRACE=1``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

from analyzer_tpu_torch.obs.tracer import bind_trace, current_trace, get_tracer

__all__ = [
    "TraceContext",
    "assemble",
    "bind_trace",
    "current_trace",
    "enable_tracing",
    "from_headers",
    "headers",
    "mint",
    "tracing_enabled",
]

ENV_TRACE = "ANALYZER_TPU_TRACE"

#: Broker message header keys. String values only — AMQP header tables
#: round-trip strings untouched; numbers would be at the mercy of the
#: client library's type mapping.
TRACE_HEADER = "x-trace-id"
PARENT_HEADER = "x-parent-span"
ENQUEUE_HEADER = "x-enqueue-us"

_enabled = bool(os.environ.get(ENV_TRACE, ""))
_ids = itertools.count(1)
_ids_lock = threading.Lock()


def tracing_enabled() -> bool:
    """Whether causal tracing is on (one module-level bool)."""
    return _enabled


def enable_tracing(on: bool = True) -> None:
    """Flips causal tracing process-wide. Off is the default: every
    propagation entry point becomes a no-op returning ``None``."""
    global _enabled
    _enabled = bool(on)


def next_span_id() -> int:
    """A process-unique id for a span/batch node in the causal tree."""
    with _ids_lock:
        return next(_ids)


class TraceContext:
    """The per-message causal context: which trace (the match id), the
    parent span that minted it, and when it entered the broker — on the
    tracer's microsecond timeline, so queue wait is a same-process
    subtraction against any later event's ``ts``."""

    __slots__ = ("trace_id", "span_id", "enqueue_us")

    def __init__(self, trace_id: str, span_id: int, enqueue_us: float) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.enqueue_us = enqueue_us

    def __repr__(self) -> str:  # pragma: no cover — debugging nicety
        return (
            f"TraceContext({self.trace_id!r}, span={self.span_id}, "
            f"enqueue_us={self.enqueue_us:.1f})"
        )


def mint(trace_id: str) -> TraceContext | None:
    """Mints the context for a match entering the broker and emits the
    ``trace.enqueue`` instant that anchors its timeline. ``None`` when
    tracing is disabled (the zero-cost path: one bool check)."""
    if not _enabled:
        return None
    tracer = get_tracer()
    ctx = TraceContext(str(trace_id), next_span_id(), tracer._now_us())
    tracer.instant("trace.enqueue", cat="trace", trace=ctx.trace_id,
                   span=ctx.span_id)
    return ctx


def headers(ctx: TraceContext | None) -> dict | None:
    """Message headers carrying ``ctx`` (None passes through, so
    ``broker.publish(q, body, headers=headers(mint(id)))`` is safe
    either way)."""
    if ctx is None:
        return None
    return {
        TRACE_HEADER: ctx.trace_id,
        PARENT_HEADER: str(ctx.span_id),
        ENQUEUE_HEADER: f"{ctx.enqueue_us:.1f}",
    }


def from_headers(hdrs: dict | None) -> TraceContext | None:
    """Reconstructs the context a publisher attached; ``None`` when
    tracing is disabled, headers are absent, or the message predates
    tracing (a mixed fleet must keep consuming)."""
    if not _enabled or not hdrs:
        return None
    trace_id = hdrs.get(TRACE_HEADER)
    if not trace_id:
        return None
    try:
        span_id = int(hdrs.get(PARENT_HEADER, 0))
        enqueue_us = float(hdrs.get(ENQUEUE_HEADER, "nan"))
    except (TypeError, ValueError):
        return None
    return TraceContext(str(trace_id), span_id, enqueue_us)


def assemble(messages) -> str | None:
    """The worker-side join: mints the batch's own trace id and records
    the batch membership — one ``batch.assemble`` instant with the
    member match ids and their enqueue timestamps (``None`` for
    messages that carried no context). Bind the returned id with
    :func:`bind_trace` around the batch's pipeline so every span it
    emits joins the tree. ``None`` when tracing is disabled."""
    if not _enabled:
        return None
    batch_trace = f"b{next_span_id()}"
    members: list[str] = []
    enqueues: list[float | None] = []
    for m in messages:
        try:
            members.append(m.body.decode())
        except Exception:  # noqa: BLE001 — a binary body must not kill tracing
            members.append(repr(m.body))
        ctx = from_headers(getattr(m, "headers", None))
        enqueues.append(None if ctx is None else round(ctx.enqueue_us, 1))
    get_tracer().instant(
        "batch.assemble", cat="trace", batch=batch_trace,
        members=members, enqueues=enqueues,
    )
    return batch_trace


def wall_of_us(us: float, tracer=None) -> float:
    """Converts a tracer-timeline microsecond stamp back to wall-clock
    seconds (for human rendering; the analyzer itself never needs
    wall time)."""
    t = tracer or get_tracer()
    return t.epoch_wall + us / 1e6
