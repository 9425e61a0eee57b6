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
"""

from __future__ import annotations

import threading
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from analyzer_tpu_torch.core import constants
from analyzer_tpu_torch.sched.residency import plan_windows

#: Default ring depth: one chunk being dispatched, one staged behind it.
DEFAULT_DEPTH = 2


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

    def put(self, item) -> None:
        with self._cond:
            while len(self._items) >= self.depth and not self._closed:
                self._cond.wait()
            if self._closed:
                raise FeedClosedError("feed closed by the consumer")
            self._items.append(item)
            self._cond.notify_all()

    def get(self):
        with self._cond:
            while not self._items and not self._closed:
                self._cond.wait()
            if self._items:
                item = self._items.popleft()
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
        self._thread = threading.Thread(
            target=self._run, args=(producer,), name=name, daemon=True
        )
        self._thread.start()

    def _run(self, producer) -> None:
        try:
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

    def to_device(self, device: torch.device) -> list[torch.Tensor]:
        """One copy on the caller's current stream (asynchronous from
        pinned memory), then contiguous views of the parts."""
        dev = self.host.to(device, non_blocking=True)
        return [
            dev[o:o + int(np.prod(shape))].view(shape)
            for o, shape in self._layout
        ]


def stage_chunk(sched, start: int, stop: int, pin: bool) -> Slab:
    """The reference runner's chunk of a packed schedule
    (:func:`stage_window`)."""
    check = getattr(sched, "check_compact_invariant", None)
    if check is not None:
        check(start, stop)
    pidx, _mask, winner, mode_id, afk = sched.host_window(start, stop)
    return stage_window(pidx, winner, mode_id, afk, pin)


def stage_window(pidx, winner, mode_id, afk, pin: bool) -> Slab:
    """A materialized window's ``[S', B, 2, T]`` player rows and ``[S', B]``
    winner / mode_id / afk scalars, packed into one slab (parts 0..3)."""
    slab = Slab()
    for arr in (pidx, winner, mode_id, afk):
        slab.add(arr)
    return slab.finish(pin)


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
    collect reordering (``flat``, or None), and the chunk's planner
    totals."""

    __slots__ = ("slab", "windows", "flat", "stats")

    def __init__(self, slab, windows, flat, stats):
        self.slab = slab
        self.windows = windows
        self.flat = flat
        self.stats = stats


def stage_chunk_fused(sched, start: int, stop: int, fuse, collect: bool,
                      pin: bool) -> FusedChunk:
    """Fused sibling of :func:`stage_chunk`: materializes the chunk and
    residency-plans it into fused windows (:func:`stage_fused_windows`)."""
    check = getattr(sched, "check_compact_invariant", None)
    if check is not None:
        check(start, stop)
    pidx, _mask, winner, mode_id, afk = sched.host_window(start, stop)
    return stage_fused_windows(
        pidx, winner, mode_id, afk, sched.pad_row, fuse,
        match_idx=sched.match_idx[start:stop] if collect else None, pin=pin,
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
    pin: bool = False,
) -> FusedChunk:
    """Residency plans for a chunk, each window padded to the static window
    size with inert steps (slot 0, unsupported mode: they read and write
    only the pristine pad slot), packed into one slab. ``match_idx`` (when
    collecting) yields the padded slot->match rows, -1 on inert steps."""
    ratable = (mode_id >= 0) & ~afk
    valid = (pidx != pad_row) & ratable[:, :, None, None]
    plans = plan_windows(pidx, valid, pad_row, fuse.window, fuse.max_rows)
    slab = Slab()
    windows = []
    flat_parts = [] if match_idx is not None else None
    k = fuse.window
    s0 = 0
    for plan in plans:
        s1 = s0 + plan.n_steps
        windows.append(StagedWindow(
            slab.add(plan.slot_rows),
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
    stats = {
        "windows": len(plans),
        "spills": sum(1 for p in plans if p.spilled),
        "writebacks_avoided": sum(p.writebacks_avoided for p in plans),
        "pad_steps": sum(k - p.n_steps for p in plans),
        "working_set_rows": max((p.n_live for p in plans), default=0),
    }
    return FusedChunk(
        slab.finish(pin),
        windows,
        np.concatenate(flat_parts) if flat_parts else None,
        stats,
    )
