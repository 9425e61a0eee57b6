"""Incremental capacity-aware first-fit: the migration engine's scheduler.

``sched.superstep.assign_batches`` consumes a COMPLETE stream. The
migration engine never has one — matches become visible one decode window
at a time — so this module carries the first-fit recurrence as
restartable state: :meth:`~PyIncrementalAssigner.feed` consumes exactly
the newly decoded slice ``[lo, hi)`` and leaves the per-player frontier,
the batch fill counts and the union-find next-free index ready for the
next window. Feeding the windows in stream order gives the assignment of
one pass over the concatenated stream, whatever the cut: the schedule is a
function of (stream bytes, capacity) alone, not of decode timing.

:func:`IncrementalAssigner` routes between two implementations with one
surface (``feed`` / ``finish`` / ``close`` / ``n_assigned`` /
``batches_used`` / ``is_native``):

  * :class:`NativeIncrementalAssigner` (the default) — the state behind a
    ``sched/csrc/packer.cc`` handle; ``feed`` runs with the GIL released
    and publishes ``progress[0]`` with release stores every
    :data:`PROGRESS_EVERY` matches;
  * :class:`PyIncrementalAssigner` — the python recurrence, the fallback
    where there is no g++ and the oracle the native loop is held to.

Both consume NON-RATABLE matches (unsupported mode, AFK) inline, as
dependency-free entries that take capacity (first-fit from batch 0),
where the offline packer holds them back and backfills other batches'
free slots: holding them back needs the whole stream's filler population.
They read and write no rating state, so the table and every per-match
output equal those of any other placement; only the slot a filler's gate
outputs are computed in moves.

The port's copy of ``analyzer_tpu.migrate.assign``: the assignments are
integers and equal the JAX package's exactly (tests/test_torch_migrate.py).
The native library builds at first use (never at import).
"""

from __future__ import annotations

import numpy as np

from analyzer_tpu_torch.sched import _native

#: Progress-publish interval (matches) inside one ``feed`` slice — equal to
#: the native loop's ``kFFProgressEvery``, so the route never changes where
#: a consumer sees progress.
PROGRESS_EVERY = 2048


def assign_native_available() -> bool:
    """Whether the GIL-released windowed first-fit loads (it builds with g++
    on the first call): the router's default route, surfaced as the
    ``migrate.assign_native`` gauge and ``Worker.stats()['migration']
    ['assign_native']``. False only where there is no g++."""
    return _native.load() is not None


class PyIncrementalAssigner:
    """Restartable first-fit over a growing stream in python — the fallback
    and the exact oracle of the native windowed loop.

    ``out_batch`` / ``out_slot`` are the caller's preallocated int64
    buffers (sentinel-filled: the feed trims what it reads at the first
    sentinel); ``progress`` is the shared ``[2]`` int64 publish array
    (``progress[0]`` = matches final, ``progress[1]`` = batches used, set
    by :meth:`finish`); ``on_progress`` wakes the reader."""

    is_native = False

    def __init__(self, capacity: int, out_batch: np.ndarray,
                 out_slot: np.ndarray, progress: np.ndarray | None = None,
                 on_progress=None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.out_batch = out_batch
        self.out_slot = out_slot
        self.progress = progress
        self.on_progress = on_progress
        self.n_assigned = 0
        # last[p] = batch of p's most recent ratable match, -1 if none.
        self._last = np.full(1024, -1, dtype=np.int64)
        self._fill: list[int] = []
        self._next_free: list[int] = []
        self._max_batch = -1

    def _ensure(self, b: int) -> None:
        fill, nxt = self._fill, self._next_free
        while len(fill) <= b:
            fill.append(0)
            nxt.append(len(nxt))

    def _find(self, b: int) -> int:
        self._ensure(b)
        nxt = self._next_free
        root = b
        while True:
            self._ensure(root)
            if nxt[root] == root:
                break
            root = nxt[root]
        while nxt[b] != root:  # path compression
            b, nxt[b] = nxt[b], root
        return root

    def _grow_players(self, top: int) -> None:
        size = self._last.size
        while size <= top:
            size *= 2
        bigger = np.full(size, -1, dtype=np.int64)
        bigger[: self._last.size] = self._last
        self._last = bigger

    def _publish(self, upto: int) -> None:
        if self.progress is not None:
            # Entries [0, upto) are final; the GIL orders the buffer stores
            # before this one.
            self.progress[0] = upto
        if self.on_progress is not None:
            self.on_progress()

    def feed(self, player_idx: np.ndarray, mode_id: np.ndarray,
             afk: np.ndarray, lo: int, hi: int) -> None:
        """Assigns matches ``[lo, hi)`` of the accumulated stream buffers
        (``player_idx [cap, 2, T]`` and the per-match scalars). Slices come
        in stream order with no gap; progress publishes at the end of the
        slice and every :data:`PROGRESS_EVERY` matches within it."""
        if hi <= lo:
            return
        if lo != self.n_assigned:
            raise ValueError(
                f"feed slices must be contiguous: expected lo="
                f"{self.n_assigned}, got {lo}"
            )
        cap = self.capacity
        last = self._last
        fill = self._fill
        out_b, out_s = self.out_batch, self.out_slot
        for i in range(lo, hi):
            if i > lo and not (i & (PROGRESS_EVERY - 1)):
                self._publish(i)
            ratable = mode_id[i] >= 0 and not afk[i]
            players = None
            floor_b = 0  # a filler is dependency-free: first batch with room
            if ratable:
                players = player_idx[i].ravel()
                players = players[players >= 0]
                if players.size:
                    top = int(players.max())
                    if top >= last.size:
                        self._grow_players(top)
                        last = self._last
                    floor_b = int(last[players].max()) + 1
            b = self._find(floor_b)
            out_b[i] = b
            out_s[i] = fill[b]
            fill[b] += 1
            if fill[b] == cap:
                self._ensure(b + 1)
                self._next_free[b] = b + 1
            if b > self._max_batch:
                self._max_batch = b
            if players is not None and players.size:
                last[players] = b
        self.n_assigned = hi
        self._publish(hi)

    @property
    def batches_used(self) -> int:
        """Batches holding at least one match so far."""
        return self._max_batch + 1

    def finish(self) -> None:
        """Publishes the final (matches, batches used) pair — the record the
        feed's tail reads after the join."""
        if self.progress is not None:
            self.progress[0] = self.n_assigned
            self.progress[1] = self.batches_used
        if self.on_progress is not None:
            self.on_progress()

    def close(self) -> None:
        """The native assigner's handle release; nothing to release here."""


class NativeIncrementalAssigner:
    """The GIL-released windowed first-fit: :class:`PyIncrementalAssigner`'s
    surface and results, with the state behind a ``packer.cc`` handle.

    ``on_progress`` fires once a window, after the native call returns (a
    GIL-released loop cannot call back into python); the engine's reader
    also wakes every ``poll_interval`` seconds to cover the gap. The handle
    is freed by :meth:`close` (idempotent, also from ``__del__``)."""

    is_native = True

    def __init__(self, capacity: int, out_batch: np.ndarray,
                 out_slot: np.ndarray, progress: np.ndarray | None = None,
                 on_progress=None, n_hint: int = 0) -> None:
        lib = _native.load()
        if lib is None:
            raise RuntimeError(
                "native windowed assigner requested but there is no g++ to "
                "build it (assign_native_available() is False)"
            )
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._lib = lib
        self.capacity = int(capacity)
        self.out_batch = out_batch
        self.out_slot = out_slot
        self.progress = progress
        self.on_progress = on_progress
        self.n_assigned = 0
        self._handle = _native.assign_ff_create(lib, self.capacity, n_hint)

    def _live(self) -> int:
        if self._handle is None:
            raise ValueError("assigner already closed")
        return self._handle

    def feed(self, player_idx: np.ndarray, mode_id: np.ndarray,
             afk: np.ndarray, lo: int, hi: int) -> None:
        """:meth:`PyIncrementalAssigner.feed`'s contract. The ratable gate is
        computed here for the window (one uint8 array); everything per
        match runs in C."""
        if hi <= lo:
            return
        if lo != self.n_assigned:
            raise ValueError(
                f"feed slices must be contiguous: expected lo="
                f"{self.n_assigned}, got {lo}"
            )
        handle = self._live()
        n = hi - lo
        idx = player_idx[lo:hi].reshape(n, -1)
        ratable = np.asarray((mode_id[lo:hi] >= 0) & ~afk[lo:hi], dtype=np.uint8)
        _native.assign_ff_feed(
            self._lib, handle, idx, ratable, lo, hi,
            self.out_batch, self.out_slot, self.progress,
        )
        self.n_assigned = hi
        if self.on_progress is not None:
            self.on_progress()

    @property
    def batches_used(self) -> int:
        """Batches holding at least one match so far (the native high-water
        mark, read without publishing)."""
        return _native.assign_ff_finish(self._lib, self._live(), None)

    def finish(self) -> None:
        """Publishes the final (matches, batches used) pair."""
        _native.assign_ff_finish(self._lib, self._live(), self.progress)
        if self.on_progress is not None:
            self.on_progress()

    def close(self) -> None:
        """Releases the native handle (idempotent; finish is optional)."""
        h, self._handle = self._handle, None
        if h is not None:
            _native.assign_ff_destroy(self._lib, h)

    def __del__(self) -> None:  # pragma: no cover — GC timing
        if getattr(self, "_handle", None) is not None:
            self.close()


def IncrementalAssigner(capacity: int, out_batch: np.ndarray,
                        out_slot: np.ndarray,
                        progress: np.ndarray | None = None, on_progress=None,
                        native: bool | None = None):
    """The router: the native windowed first-fit where it builds, the
    python recurrence otherwise. ``native=True`` demands the native route
    (raises without it), ``False`` forces the python oracle, ``None``
    chooses."""
    use = assign_native_available() if native is None else native
    cls = NativeIncrementalAssigner if use else PyIncrementalAssigner
    return cls(capacity, out_batch, out_slot, progress, on_progress)
