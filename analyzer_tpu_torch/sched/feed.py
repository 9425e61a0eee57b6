"""Bounded-depth prefetching feed: host staging on a producer thread.

Counterpart of ``analyzer_tpu.sched.feed``. A producer thread materializes
the next chunk of the schedule — the gather tensors and, for the fused
kernel, the residency plans — and packs it into ONE int32 host slab (in
pinned memory when the run is on the card), while the consumer (the
runner's dispatch loop) works on the chunk before. A bounded ring
(:class:`DeviceFeed`, depth 2-3) holds the staged chunks.

The host-to-device copy is issued by the CONSUMER, on its own current
stream, with ``non_blocking=True`` right before the chunk's launches
(:meth:`Slab.to_device`): stream order puts the copy before every kernel
that reads the slab, with no cross-stream event to get wrong. A pinned
slab is never reused while its copy is in flight: each chunk gets its own
pinned buffer from PyTorch's caching host allocator, which records the
copy on its stream and returns the buffer to its pool only after that
copy has completed.

Determinism: the producer stages chunks strictly in order on one thread,
so the staged work — and with it the final table and the collected
outputs — is the same at every depth; the ring changes when work is
staged, never what.

Telemetry, under the JAX package's names:

  * ``feed.depth`` gauge — ring occupancy after the last put/get;
  * ``feed.starved_total`` — the consumer found the ring empty and waited
    (the feed is behind: host-bound staging);
  * ``feed.backpressure_total`` — the producer found the ring full and
    waited (the consumer is behind);
  * ``feed.materialize`` span, one per chunk on the producer thread: the
    chunk's whole staging — materialization, residency and tier planning,
    the slab's packing into pinned memory;
  * ``feed.transfer`` span, one per chunk, around the slab's copy to the
    device. The JAX package issues that copy on the producer thread; here
    the consumer issues it (see above), so the runner opens this span on
    the consumer thread, outside ``batch.compute``, and the span's thread
    id says so.

The port's own spans, all ``cat="sched"``, split that staging and time the
waits the two counters count:

  * ``feed.gather`` (``start``, ``steps``, ``fillers``), inside
    ``feed.materialize``: the chunk's arrays — ``sched.host_window`` of a
    packed schedule, or the stream feed's filler backfill and its
    ``materialize_gather_window`` / ``materialize_scalar_window``;
  * ``feed.plan`` (``start``, ``steps``, ``windows``, ``spills``,
    ``native``), inside ``feed.materialize`` on the fused path: the
    ratable masks and :func:`~analyzer_tpu_torch.sched.residency.
    plan_windows`; ``native`` is False where the numpy planner stood in
    for the one-pass native planner (no g++);
  * ``feed.pack`` (``start``, ``bytes``, ``pinned``), inside
    ``feed.materialize``: the slab — the fused path's per-window parts and
    :meth:`Slab.finish` with its ``pin_memory()`` copy, or
    :func:`stage_window`. On a tiered fused run ``tier.plan_fused`` runs
    in this loop and counts as pack; a tiered reference chunk's split,
    plans and pack (``TierManager.stage_windows``) stay one stretch of
    ``feed.materialize``;
  * ``feed.starved`` on the consumer and ``feed.backpressure`` on the
    producer, around the ring's waits (``start``: the chunk waited for
    or waiting to be put, where the item is a runner's ``(start, stop,
    staged)``); each opens only where its counter counts;
  * ``feed.wait_assign`` (``start``: the next window's first step) on the
    stream feed's thread, from its first sleep on the assigner to its
    next window (``runner._StreamFeed``): one span a stretch, not one a
    ``poll_interval`` wake.

The counters and spans are per chunk or per wait, never per match or per
fused window.

The ingest plane's staging memory lives here too: :class:`PinnedArena`
leases page-aligned host slabs (pinned where a card is visible) that the
columnar decoder (``io/ingest.py``) writes match windows into, and
:func:`stage_ingest_window` copies a decoded window off its slabs to the
device (``ingest.commit`` span), recycling each slab only once its copy
has completed. The tiered table's cold tier takes its buffer from the same
arena (``sched/tier.py``).
"""

from __future__ import annotations

import threading
import weakref
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from analyzer_tpu_torch.core import constants
from analyzer_tpu_torch.device import resolve_device
from analyzer_tpu_torch.obs import get_registry, get_tracer
from analyzer_tpu_torch.obs.tracer import bind_trace, current_trace
from analyzer_tpu_torch.sched.residency import PlanScratch, plan_windows

#: Default ring depth: one chunk being dispatched, one staged behind it.
DEFAULT_DEPTH = 2

#: Page alignment of arena buffers: the DMA engines move whole aligned
#: pages, and the decoder's slabs start on a page either way.
ARENA_ALIGNMENT = 4096


class PinnedArena:
    """Reusable page-aligned host staging buffers for the ingest plane.

    The counterpart of ``analyzer_tpu.sched.feed.PinnedArena``, with the
    same methods and telemetry. Two allocation surfaces share one
    allocator: :meth:`take` / :meth:`give` lease fixed-shape slabs that the
    columnar decoder (``io/ingest.py``) writes whole match windows into —
    steady state reuses them, ~100% — and :meth:`empty` hands out
    long-lived buffers (the tiered table's cold tier, ``sched/tier.py``).

    Every buffer is a torch tensor cut to an ``ARENA_ALIGNMENT``-aligned
    start out of a slightly larger allocation, in page-locked memory
    whenever a CUDA device is visible, and is
    handed out as a numpy view of that tensor — what the ctypes decoder
    writes through. :meth:`tensor` returns the owning tensor, which is
    what a device copy must read: a ``torch.from_numpy`` of the view would
    not be known as pinned, and its ``non_blocking`` copy would silently
    be a synchronous pageable one.

    :meth:`commit` is the H2D edge. To a CUDA device it copies the slab's
    tensor with ``non_blocking=True`` on the current stream and records a
    CUDA event after the copy; :meth:`give_when_done` returns the slab to
    the freelist only once that event's ``query()`` reports the copy done,
    so a recycled slab is never overwritten under an in-flight copy (the
    arena recycles, never frees, so PyTorch's host allocator — which
    guards a pinned block only when it is freed — cannot do this for it).
    To the CPU a commit is a synchronous copy and the release immediate.

    Unlike the JAX package's arena, a buffer whose last reference is
    dropped (a finished tiered run's cold tier) is forgotten and freed,
    and ``ingest.arena_bytes`` falls by its size.

    Telemetry: ``ingest.arena_allocs_total`` / ``ingest.arena_reuses_total``
    counters (their ratio is the hit rate), ``ingest.h2d_commits_total``,
    and the ``ingest.arena_bytes`` gauge.
    """

    def __init__(self, name: str = "ingest") -> None:
        self.name = name
        self._pin: bool | None = None  # resolved at the first allocation
        # Reentrant: a buffer's finalizer may run on a thread inside an
        # arena method (the last reference dropped there).
        self._lock = threading.RLock()
        # (shape, dtype str) -> [view, ...] free slabs.
        self._free: dict[tuple, list] = {}
        # id(view) -> (key, owning tensor, weakref to the view, pinned).
        self._live: dict[int, tuple] = {}
        # id(view) -> the CUDA event recorded after its last commit.
        self._inflight: dict[int, object] = {}
        # (event or None, view) pairs whose copy may still be reading.
        self._deferred: list = []
        self._nbytes = 0
        self._pinned: bool | None = None  # resolved by the first commit
        reg = get_registry()
        self._allocs = reg.counter("ingest.arena_allocs_total")
        self._reuses = reg.counter("ingest.arena_reuses_total")
        self._commits = reg.counter("ingest.h2d_commits_total")
        self._bytes_gauge = reg.gauge("ingest.arena_bytes")

    @staticmethod
    def _aligned(shape, dtype, pin: bool) -> torch.Tensor:
        """A C-contiguous ``shape``/``dtype`` tensor whose data pointer is
        ARENA_ALIGNMENT-aligned (pinned when ``pin``)."""
        dt = np.dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        base = torch.empty(nbytes + ARENA_ALIGNMENT, dtype=torch.uint8,
                           pin_memory=pin)
        off = (-base.data_ptr()) % ARENA_ALIGNMENT
        tdtype = torch.from_numpy(np.empty(0, dt)).dtype
        return base[off:off + nbytes].view(tdtype).reshape(tuple(shape))

    def _new(self, key) -> np.ndarray:
        shape, dtype = key
        if self._pin is None:
            self._pin = torch.cuda.is_available()
        t = self._aligned(shape, dtype, self._pin)
        view = t.numpy()
        self._allocs.add(1)
        self._nbytes += view.nbytes
        self._bytes_gauge.set(self._nbytes)
        self._live[id(view)] = (key, t, weakref.ref(view), t.is_pinned())
        weakref.finalize(view, self._forget, id(view), view.nbytes)
        return view

    def _forget(self, key_id: int, nbytes: int) -> None:
        with self._lock:
            self._live.pop(key_id, None)
            self._inflight.pop(key_id, None)
            self._nbytes -= nbytes
            self._bytes_gauge.set(self._nbytes)

    def _entry(self, buf) -> tuple | None:
        entry = self._live.get(id(buf))
        return entry if entry is not None and entry[2]() is buf else None

    def empty(self, shape, dtype) -> np.ndarray:
        """A long-lived aligned buffer (never enters the freelist unless
        given) — the tiered table's cold tier and other resident host
        state. :meth:`tensor` gives its owning tensor."""
        with self._lock:
            return self._new((tuple(shape), np.dtype(dtype).str))

    def tensor(self, buf: np.ndarray) -> torch.Tensor:
        """The torch tensor that owns ``buf``'s memory (pinned with the
        arena). Raises ValueError for a buffer the arena did not hand out."""
        with self._lock:
            entry = self._entry(buf)
        if entry is None:
            raise ValueError("buffer was not allocated by this arena")
        return entry[1]

    def take(self, shape, dtype) -> np.ndarray:
        """Leases a slab (freelist hit, or a counted fresh allocation).
        Contents are UNDEFINED — the decoder overwrites every used slot
        and pads the rest itself."""
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            self._drain_deferred()
            free = self._free.get(key)
            if free:
                buf = free.pop()
                self._reuses.add(1)
                return buf
            return self._new(key)

    def give(self, buf: np.ndarray) -> None:
        """Returns a leased slab to the freelist for reuse."""
        with self._lock:
            entry = self._entry(buf)
            if entry is None:
                return  # not ours — ignore
            self._free.setdefault(entry[0], []).append(buf)

    def give_when_done(self, buf: np.ndarray, device_array=None) -> None:
        """Like :meth:`give`, but defers the freelist return until the
        copy of ``buf``'s last :meth:`commit` (which made ``device_array``)
        has completed on the card — the safe release for a slab whose H2D
        copy may still be reading it."""
        with self._lock:
            if self._entry(buf) is None:
                return
            self._deferred.append((self._inflight.pop(id(buf), None), buf))

    def _drain_deferred(self) -> None:
        # Lock held. query() is a non-blocking completion probe; a slab
        # committed to the CPU (or never committed) has no event.
        still = []
        for event, buf in self._deferred:
            if event is None or event.query():
                entry = self._entry(buf)
                if entry is not None:
                    self._free.setdefault(entry[0], []).append(buf)
            else:
                still.append((event, buf))
        self._deferred = still

    @property
    def pinned(self) -> bool:
        """True when every commit so far copied a pinned slab to a CUDA
        device (``Tensor.is_pinned()`` of the slab, read when it was
        allocated); False before the first commit and on the CPU."""
        return bool(self._pinned)

    def commit(self, buf: np.ndarray, device=None) -> torch.Tensor:
        """Copies ``buf`` to ``device`` (None: the card) and returns the
        device tensor: asynchronous from a pinned slab, with a CUDA event
        recorded after the copy; synchronous to the CPU. The caller keeps
        ownership of the slab — pair with :meth:`give_when_done` to
        recycle it."""
        dev = resolve_device(device)
        with self._lock:
            entry = self._entry(buf)
        if entry is not None:
            src, pinned = entry[1], entry[3]
        else:  # a foreign buffer: pageable
            src, pinned = torch.from_numpy(np.ascontiguousarray(buf)), False
        if dev.type == "cuda":
            out = src.to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            ok = pinned
        else:
            out = src.clone()
            event, ok = None, False
        with self._lock:
            if entry is not None and event is not None:
                self._inflight[id(buf)] = event
            self._pinned = ok if self._pinned is None else (self._pinned and ok)
        self._commits.add(1)
        return out

    def stats(self) -> dict:
        """JSON-ready arena counters (the ingest line's ``arena`` block):
        allocations, reuses, hit rate, resident bytes, pinned."""
        allocs = self._allocs.value
        reuses = self._reuses.value
        total = allocs + reuses
        return {
            "allocs": int(allocs),
            "reuses": int(reuses),
            "hit_rate": round(reuses / total, 4) if total else None,
            "bytes": int(self._nbytes),
            "pinned": self.pinned,
        }


_arena_lock = threading.Lock()
_arena: PinnedArena | None = None


def get_arena() -> PinnedArena:
    """The process-wide staging arena (created on first use), shared by
    the columnar decoder's window slabs and the tiered table's cold tier."""
    global _arena
    with _arena_lock:
        if _arena is None:
            _arena = PinnedArena()
        return _arena


def reset_arena() -> PinnedArena:
    """Replaces the process-wide arena with a fresh one (tests)."""
    global _arena
    with _arena_lock:
        _arena = PinnedArena()
        return _arena


class FeedClosedError(RuntimeError):
    """``put()`` on a feed the consumer already closed."""


class FeedStageError(RuntimeError):
    """A producer-thread staging failure, tagged with the window it was
    staging; the raw error is ``__cause__``. It surfaces on the consumer's
    next ``get()`` after the already-staged prefix drains."""

    def __init__(self, start: int, stop: int) -> None:
        super().__init__(
            f"feed staging failed at window [{start}, {stop})"
        )
        self.start = start
        self.stop = stop


def _chunk_args(item) -> dict:
    """``{"start": ...}`` of a runner's ``(start, stop, staged)`` item, so
    a wait span names its chunk; nothing for another kind of item."""
    if isinstance(item, tuple) and item and isinstance(item[0], int):
        return {"start": item[0]}
    return {}


class DeviceFeed:
    """Thread-safe bounded ring of staged chunks, one producer and one
    consumer. ``put`` blocks while the ring is full, ``get`` while it is
    empty; ``close()`` ends the stream, and a closed-and-drained ``get``
    returns None or raises the error ``close(error=...)`` recorded."""

    def __init__(self, depth: int = DEFAULT_DEPTH) -> None:
        if depth < 1:
            raise ValueError(f"feed depth must be >= 1, got {depth}")
        self.depth = depth
        self._cond = threading.Condition()
        self._items: deque = deque()
        self._closed = False
        self._error: BaseException | None = None
        reg = get_registry()
        self._depth_gauge = reg.gauge("feed.depth")
        self._starved = reg.counter("feed.starved_total")
        self._backpressure = reg.counter("feed.backpressure_total")

    def put(self, item) -> None:
        with self._cond:
            if len(self._items) >= self.depth and not self._closed:
                self._backpressure.add(1)
                with get_tracer().span("feed.backpressure", cat="sched",
                                       **_chunk_args(item)):
                    while len(self._items) >= self.depth and not self._closed:
                        self._cond.wait()
            if self._closed:
                raise FeedClosedError("feed closed by the consumer")
            self._items.append(item)
            self._depth_gauge.set(len(self._items))
            self._cond.notify_all()

    def get(self):
        with self._cond:
            if not self._items and not self._closed:
                self._starved.add(1)
                with get_tracer().span("feed.starved", cat="sched") as args:
                    while not self._items and not self._closed:
                        self._cond.wait()
                    if self._items:
                        args.update(_chunk_args(self._items[0]))
            if self._items:
                item = self._items.popleft()
                self._depth_gauge.set(len(self._items))
                self._cond.notify_all()
                return item
            if self._error is not None:
                raise self._error
            return None

    def close(self, error: BaseException | None = None) -> None:
        """Ends the stream (idempotent); the first recorded error wins."""
        with self._cond:
            if error is not None and self._error is None:
                self._error = error
            self._closed = True
            self._cond.notify_all()


class Prefetcher:
    """Runs ``producer(put)`` on a worker thread feeding a
    :class:`DeviceFeed`; iterate the instance to consume. When the producer
    returns the feed closes; if it raises, the exception is re-raised from
    the consumer's iteration. As a context manager, ``__exit__`` closes the
    feed (unblocking a producer in ``put``) and joins the thread."""

    def __init__(
        self, producer, depth: int = DEFAULT_DEPTH, name: str = "sched-feed"
    ) -> None:
        self.feed = DeviceFeed(depth)
        # The producer stages chunks on behalf of whatever trace is bound
        # on the constructing (consumer) thread, so its spans join that
        # trace: captured here, re-bound in _run (None: nothing bound).
        self._trace = current_trace()
        self._thread = threading.Thread(
            target=self._run, args=(producer,), name=name, daemon=True
        )
        self._thread.start()

    def _run(self, producer) -> None:
        try:
            with bind_trace(self._trace):
                producer(self.feed.put)
        except FeedClosedError:
            pass  # the consumer aborted first; its exception is the story
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            self.feed.close(error=e)
        else:
            self.feed.close()

    def __iter__(self):
        while True:
            item = self.feed.get()
            if item is None:
                return
            yield item

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.feed.close()
        self._thread.join()
        return False


class Slab:
    """Several int32 host arrays packed into ONE buffer, so a chunk crosses
    to the device in one copy. ``add`` returns the part's index into the
    list :meth:`to_device` returns."""

    def __init__(self) -> None:
        self._parts: list[np.ndarray] = []
        self.host: torch.Tensor | None = None
        self._layout: list[tuple[int, tuple]] = []

    def add(self, arr: np.ndarray) -> int:
        self._parts.append(np.ascontiguousarray(arr, np.int32))
        return len(self._parts) - 1

    def finish(self, pin: bool) -> "Slab":
        """Packs the parts; ``pin`` puts the buffer in page-locked memory
        so the device copy can run asynchronously."""
        off = 0
        for p in self._parts:
            self._layout.append((off, p.shape))
            off += p.size
        buf = np.empty(off, np.int32)
        for (o, _), p in zip(self._layout, self._parts):
            buf[o:o + p.size] = p.ravel()
        self._parts = []
        host = torch.from_numpy(buf)
        self.host = host.pin_memory() if pin else host
        return self

    @property
    def nbytes(self) -> int:
        """The packed buffer's size (after :meth:`finish`)."""
        return self.host.numel() * self.host.element_size()

    def to_device(self, device: torch.device) -> list[torch.Tensor]:
        """One copy on the caller's current stream (asynchronous from
        pinned memory), then contiguous views of the parts."""
        dev = self.host.to(device, non_blocking=True)
        return [
            dev[o:o + int(np.prod(shape))].view(shape)
            for o, shape in self._layout
        ]


def gather_chunk(sched, start: int, stop: int):
    """A packed schedule's ``host_window(start, stop)`` in the chunk's
    ``feed.gather`` span (no fillers: the schedule placed them)."""
    with get_tracer().span("feed.gather", cat="sched", start=start,
                           steps=stop - start, fillers=0):
        return sched.host_window(start, stop)


def stage_chunk(sched, start: int, stop: int, pin: bool) -> Slab:
    """The reference runner's chunk of a packed schedule
    (:func:`stage_window`), in one ``feed.materialize`` span."""
    check = getattr(sched, "check_compact_invariant", None)
    if check is not None:
        check(start, stop)
    with get_tracer().span("feed.materialize", cat="sched", start=start):
        pidx, _mask, winner, mode_id, afk = gather_chunk(sched, start, stop)
        return stage_window(pidx, winner, mode_id, afk, pin, start=start)


def stage_window(pidx, winner, mode_id, afk, pin: bool, start: int = 0) -> Slab:
    """A materialized window's ``[S', B, 2, T]`` player rows and ``[S', B]``
    winner / mode_id / afk scalars, packed into one slab (parts 0..3), in
    one ``feed.pack`` span (``start``: the chunk's first step)."""
    with get_tracer().span("feed.pack", cat="sched", start=start,
                           pinned=pin) as args:
        slab = Slab()
        for arr in (pidx, winner, mode_id, afk):
            slab.add(arr)
        slab.finish(pin)
        args["bytes"] = slab.nbytes
        return slab


def stage_ingest_window(win, arena: PinnedArena | None = None, device=None):
    """The ingest plane's H2D edge: commits one
    :class:`analyzer_tpu_torch.io.ingest.DecodedWindow`'s column slabs to
    ``device`` (None: the card) in one ``ingest.commit`` span and hands the
    slabs back to the arena, each released once its copy has completed.
    The FULL fixed-width slabs are committed (static shapes) and the live
    row count rides alongside.

    Returns ``(rows, player_idx, winner, mode_id, afk)``, the last four
    device tensors."""
    arena = arena or get_arena()
    dev = resolve_device(device)
    with get_tracer().span("ingest.commit", cat="ingest", rows=win.rows):
        devs = tuple(arena.commit(buf, dev) for buf in win.slabs)
    win.release(devs)
    return (win.rows,) + devs


class StagedWindow(NamedTuple):
    """One fused window of a staged chunk: the slab part indices of its
    slot_rows, slot_idx, winner, mode_id and afk, and its real step count
    (the plan's ``n_steps``; the rest of the window's K steps are inert
    padding)."""

    slot_rows: int
    slot_idx: int
    winner: int
    mode_id: int
    afk: int
    n_steps: int


class FusedChunk:
    """One chunk staged for the fused window: the slab holding every
    window's (slot_rows, slot_idx, winner, mode_id, afk) parts, a
    :class:`StagedWindow` per window, the padded slot->match rows for
    collect reordering (``flat``, or None), the chunk's planner totals,
    and — on a tiered run — one ``TierPlan`` per window (``tier_plans``),
    since the fused working-set gather then reads through the hot set."""

    __slots__ = ("slab", "windows", "flat", "stats", "tier_plans")

    def __init__(self, slab, windows, flat, stats, tier_plans=None):
        self.slab = slab
        self.windows = windows
        self.flat = flat
        self.stats = stats
        self.tier_plans = tier_plans


def stage_chunk_fused(sched, start: int, stop: int, fuse, collect: bool,
                      pin: bool, tier=None, scratch=None) -> FusedChunk:
    """Fused sibling of :func:`stage_chunk`: materializes the chunk and
    residency-plans it into fused windows (:func:`stage_fused_windows`),
    in one ``feed.materialize`` span. ``tier`` (a
    ``sched.tier.TierManager``) remaps each window into hot-slot space and
    attaches its promotion/demotion plan; ``scratch`` is the planner's
    :class:`~analyzer_tpu_torch.sched.residency.PlanScratch`."""
    check = getattr(sched, "check_compact_invariant", None)
    if check is not None:
        check(start, stop)
    with get_tracer().span("feed.materialize", cat="sched", start=start):
        pidx, _mask, winner, mode_id, afk = gather_chunk(sched, start, stop)
        return stage_fused_windows(
            pidx, winner, mode_id, afk, sched.pad_row, fuse,
            match_idx=sched.match_idx[start:stop] if collect else None,
            pin=pin, tier=tier, start=start, scratch=scratch,
        )


def _pad_window_steps(arr, k: int, fill):
    """Pads a window's leading (step) axis to the static window size."""
    extra = k - arr.shape[0]
    if extra <= 0:
        return arr
    pad = np.full((extra,) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad])


def stage_fused_windows(
    pidx, winner, mode_id, afk, pad_row: int, fuse, match_idx=None,
    pin: bool = False, tier=None, start: int = 0, scratch=None,
) -> FusedChunk:
    """Residency plans for a chunk, each window padded to the static window
    size with inert steps (slot 0, unsupported mode: they read and write
    only the pristine pad slot), packed into one slab. ``match_idx`` (when
    collecting) yields the padded slot->match rows, -1 on inert steps.
    ``tier`` composes the hot set: each window's ``slot_rows`` are remapped
    into hot slots (the fused gather then reads through the hot set) and
    its ``TierPlan`` rides along, its promotions packed into the same slab
    — the runner caps the fused ``max_rows`` at the hot capacity, so every
    fused window fits by construction. ``scratch`` (a
    :class:`~analyzer_tpu_torch.sched.residency.PlanScratch`) is the
    planner's row -> slot table, which a caller staging chunk after chunk
    on one thread passes to each. Its callers run it inside their chunk's
    ``feed.materialize`` span; the plans take one ``feed.plan`` span and
    the slab one ``feed.pack`` span (``start``: the chunk's first step)."""
    tracer = get_tracer()
    scratch = PlanScratch() if scratch is None else scratch
    with tracer.span("feed.plan", cat="sched", start=start,
                     steps=pidx.shape[0]) as args:
        ratable = (mode_id >= 0) & ~afk
        valid = (pidx != pad_row) & ratable[:, :, None, None]
        plans = plan_windows(pidx, valid, pad_row, fuse.window, fuse.max_rows,
                             scratch=scratch)
        spills = sum(1 for p in plans if p.spilled)
        args.update(windows=len(plans), spills=spills, native=scratch.native)
    with tracer.span("feed.pack", cat="sched", start=start,
                     pinned=pin) as args:
        slab = Slab()
        windows = []
        tier_plans = [] if tier is not None else None
        flat_parts = [] if match_idx is not None else None
        k = fuse.window
        s0 = 0
        for plan in plans:
            s1 = s0 + plan.n_steps
            slot_rows = plan.slot_rows
            if tier is not None:
                tplan, slot_rows = tier.plan_fused(
                    plan.slot_rows, plan.n_live, pidx[s0:s1], valid[s0:s1]
                )
                tplan.pack(slab)
                tier_plans.append(tplan)
            windows.append(StagedWindow(
                slab.add(slot_rows),
                slab.add(_pad_window_steps(plan.slot_idx, k, 0)),
                slab.add(_pad_window_steps(winner[s0:s1], k, 0)),
                slab.add(_pad_window_steps(
                    mode_id[s0:s1], k, constants.UNSUPPORTED_MODE_ID
                )),
                slab.add(_pad_window_steps(afk[s0:s1].astype(np.int32), k, 0)),
                plan.n_steps,
            ))
            if flat_parts is not None:
                flat_parts.append(_pad_window_steps(match_idx[s0:s1], k, -1))
            s0 = s1
        slab.finish(pin)
        args["bytes"] = slab.nbytes
    stats = {
        "windows": len(plans),
        "spills": spills,
        "writebacks_avoided": sum(p.writebacks_avoided for p in plans),
        "pad_steps": sum(k - p.n_steps for p in plans),
        "working_set_rows": max((p.n_live for p in plans), default=0),
    }
    return FusedChunk(
        slab,
        windows,
        np.concatenate(flat_parts) if flat_parts else None,
        stats,
        tier_plans,
    )
