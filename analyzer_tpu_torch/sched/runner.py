"""The history runners: supersteps rated chunk by chunk on the device.

Counterparts of ``analyzer_tpu.sched.runner.rate_history`` (a packed
schedule) and ``rate_stream`` (a raw stream, packed while it is rated),
with the same signatures. Each chunk of ``steps_per_chunk`` supersteps is
staged on a producer thread (:mod:`analyzer_tpu_torch.sched.feed`) and
dispatched by the consumer loop both share (:func:`_consume`):

  * ``kernel="reference"`` — a Python loop over the chunk's steps, each
    one plain-PyTorch superstep (gather, ``rate_gathered``, the routed
    scatter with the padding row re-pinned);
  * ``kernel="fused"`` — the chunk's residency-planned windows, each one
    gather, one fused window (the hand-written CUDA kernel on the card,
    its plain version on a CPU table) and one writeback.

The table is updated IN PLACE on one copy of the caller's state, made at
entry (the JAX package donates its buffer chunk to chunk instead). Per-match
outputs, when collected, come back one chunk behind the dispatch, so the
device-to-host copy of chunk k-1 overlaps chunk k.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.fused import fused_window_table
from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE, PlayerState
from analyzer_tpu_torch.core.update import check_seed_cfg, pack_outputs, rate_step_
from analyzer_tpu_torch.sched.feed import (
    DEFAULT_DEPTH,
    FeedStageError,
    Prefetcher,
    stage_chunk,
    stage_chunk_fused,
    stage_fused_windows,
    stage_window,
)
from analyzer_tpu_torch.sched.residency import resolve_fuse
from analyzer_tpu_torch.sched.superstep import (
    assign_batches,
    choose_batch_size_streamed,
    materialize_gather_window,
    materialize_scalar_window,
)


@dataclasses.dataclass
class HistoryOutputs:
    """Per-match outputs in stream order (numpy, host-side): what the
    reference persists per match and participant (``rater.py:140-169``).
    Rows of matches that were not rated hold the gate outputs only;
    ``updated`` marks rows whose ratings were written."""

    quality: np.ndarray  # [N]
    shared_mu: np.ndarray  # [N, 2, T]
    shared_sigma: np.ndarray  # [N, 2, T]
    delta: np.ndarray  # [N, 2, T]
    mode_mu: np.ndarray  # [N, 2, T]
    mode_sigma: np.ndarray  # [N, 2, T]
    any_afk: np.ndarray  # [N]
    updated: np.ndarray  # [N]


def _reference_chunk_(table, pad_row, views, cfg, collect):
    """The reference runner's chunk, in place on ``table``: one
    plain-PyTorch superstep per step. Returns ``[S', B, 3 + 10T]`` or
    None."""
    pidx, winner, mode_id, afk = views
    ys = []
    for s in range(pidx.shape[0]):
        out = rate_step_(table, pad_row, pidx[s], winner[s], mode_id[s], afk[s], cfg)
        if collect:
            ys.append(pack_outputs(out))
    return torch.stack(ys) if collect else None


def _dispatch_fused_chunk(table, staged, views, cfg, collect, backend):
    """Every residency window of a staged chunk, in order, in place on
    ``table``. Returns the chunk's ``[n_windows * K, B, 3 + 10T]`` packed
    outputs when collecting — the reference chunk's layout plus inert
    padded steps, which ``staged.flat`` maps to -1."""
    ys_parts = []
    for win in staged.windows:
        slot_rows, slot_idx, winner, mode_id, afk = (views[i] for i in win[:5])
        _, ys = fused_window_table(
            table, slot_rows, slot_idx, winner, mode_id, afk,
            cfg, collect, backend, n_steps=win.n_steps,
        )
        if collect:
            ys_parts.append(ys)
    if not collect:
        return None
    return ys_parts[0] if len(ys_parts) == 1 else torch.cat(ys_parts)


class _Fetch:
    """A chunk's collected outputs on their way to the host: on the card an
    asynchronous copy into pinned memory, awaited one chunk later."""

    def __init__(self, ys: torch.Tensor) -> None:
        self._event = None
        if ys.is_cuda:
            self.host = torch.empty(ys.shape, dtype=ys.dtype, pin_memory=True)
            self.host.copy_(ys, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self.host = ys

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self.host.numpy()


def rate_history(
    state: PlayerState,
    sched,
    cfg: RatingConfig,
    collect: bool = False,
    steps_per_chunk: int | None = None,
    start_step: int = 0,
    stop_after: int | None = None,
    on_chunk=None,
    view_publisher=None,
    prefetch_depth: int | None = None,
    kernel: str = "reference",
    fuse_window: int | None = None,
    fuse_max_rows: int | None = None,
    fuse_backend: str | None = None,
    hot_rows: int = 0,
    stats_out: dict | None = None,
) -> tuple[PlayerState, HistoryOutputs | None]:
    """Rates a packed history on the device of ``state.table``. Returns the
    final state (a new one; the caller's stays valid) and, when
    ``collect``, per-match outputs in stream order.

    ``kernel``: ``"reference"`` (plain PyTorch supersteps) or ``"fused"``
    (windows of ``fuse_window`` supersteps through the fused window;
    ``fuse_max_rows`` bounds the working set, overflow splits windows;
    ``fuse_backend`` "torch" | "cuda" | None, see
    :func:`analyzer_tpu_torch.core.fused.fused_window_table`). Chunk
    boundaries, hooks and results do not depend on the kernel's window
    size or on ``prefetch_depth`` (the feed ring's depth, default 2).

    ``start_step`` re-enters the schedule mid-way (with the state taken at
    that step); ``stop_after`` ends at the chunk boundary at or after that
    step; ``on_chunk(state, next_step)`` fires after each chunk is
    dispatched — the state's table is the live one, valid until the next
    chunk dispatches, so a hook copies what it keeps.

    ``stats_out`` (optional dict) receives the fused path's planner totals
    after the run: windows dispatched, spills, inert pad steps, scatter
    rows avoided, and the working-set high-water mark.

    ``view_publisher`` (the serve plane, ROADMAP A11) and ``hot_rows`` (the
    tiered table, ROADMAP A9) are not ported yet and raise
    NotImplementedError unless left at their defaults."""
    _refuse_unported(view_publisher, hot_rows)
    fuse = resolve_fuse(kernel, fuse_window, fuse_max_rows, fuse_backend)
    check_seed_cfg(state, cfg)
    n_steps = sched.n_steps if stop_after is None else min(stop_after, sched.n_steps)
    if steps_per_chunk is None:
        # About 8 chunks, so host staging overlaps the device; the floor
        # keeps per-chunk overhead amortized, the ceiling bounds the slabs.
        steps_per_chunk = min(8192, max(256, -(-sched.n_steps // 8)))
    state = state.clone()
    pin = state.table.is_cuda
    starts = list(range(start_step, n_steps, steps_per_chunk))

    def produce(put) -> None:
        for start in starts:
            stop = min(start + steps_per_chunk, n_steps)
            try:
                if fuse is not None:
                    item = stage_chunk_fused(
                        sched, start, stop, fuse, collect, pin
                    )
                else:
                    item = stage_chunk(sched, start, stop, pin)
            except Exception as e:
                raise FeedStageError(start, stop) from e
            put((start, stop, item))

    outs, fused_flat, totals = _consume(
        produce, state, sched.pad_row, cfg, fuse, collect, on_chunk,
        prefetch_depth,
    )
    if stats_out is not None and fuse is not None:
        stats_out.update(totals)
    if not collect:
        return state, None
    flat_idx = (
        _flat(fused_flat) if fused_flat is not None
        else sched.match_idx[start_step:n_steps].reshape(-1)
    )
    return state, _gather_outputs(
        outs, flat_idx, sched.n_matches, sched.team_size
    )


def _refuse_unported(view_publisher, hot_rows: int) -> None:
    if view_publisher is not None:
        raise NotImplementedError(
            "view_publisher is not ported yet (ROADMAP A11, serve plane)"
        )
    if hot_rows != 0:
        raise NotImplementedError(
            "hot_rows (the tiered table) is not ported yet (ROADMAP A9)"
        )


def _flat(fused_flat: list) -> np.ndarray:
    return (np.concatenate(fused_flat).reshape(-1) if fused_flat
            else np.empty(0, np.int32))


def _consume(produce, state, pad_row, cfg, fuse, collect, on_chunk, depth):
    """The consumer loop of both runners: dispatches every chunk that
    ``produce`` stages (on the Prefetcher's thread), in place on
    ``state.table``. Returns ``(outs, fused_flat, totals)``: the chunks'
    packed outputs when collecting, the fused path's padded slot->match
    rows (fused + collect, else None) and its planner totals."""
    table = state.table
    device = table.device
    outs = [] if collect else None
    # Fused + collect: inert window-padding steps make the emitted ys rows
    # a superset of the schedule's, so the staged chunks carry their own
    # padded slot->match rows.
    fused_flat = [] if (fuse is not None and collect) else None
    totals = {"windows": 0, "spills": 0, "pad_steps": 0,
              "writebacks_avoided": 0, "working_set_rows": 0}
    pending = None  # chunk k-1's outputs, fetched after dispatching chunk k
    with Prefetcher(produce, depth=depth or DEFAULT_DEPTH) as pf:
        for _start, stop, staged in pf:
            if fuse is not None:
                views = staged.slab.to_device(device)
                ys = _dispatch_fused_chunk(
                    table, staged, views, cfg, collect, fuse.backend
                )
                if fused_flat is not None:
                    fused_flat.append(staged.flat)
                for key, val in staged.stats.items():
                    totals[key] = (max(totals[key], val)
                                   if key == "working_set_rows"
                                   else totals[key] + val)
            else:
                views = staged.to_device(device)
                ys = _reference_chunk_(table, pad_row, views, cfg, collect)
            del views, staged
            if collect:
                fetch = _Fetch(ys)
                if pending is not None:
                    outs.append(pending.result())
                pending = fetch
            if on_chunk is not None:
                on_chunk(state, stop)
    if pending is not None:
        outs.append(pending.result())
    return outs, fused_flat, totals


def rate_stream(
    state: PlayerState,
    stream,
    cfg: RatingConfig,
    collect: bool = False,
    batch_size: int | None = None,
    steps_per_chunk: int | None = None,
    poll_interval: float = 0.002,
    team_size: int | None = None,
    stats_out: dict | None = None,
    mesh=None,
    view_publisher=None,
    on_chunk=None,
    prefetch_depth: int | None = None,
    kernel: str = "reference",
    fuse_window: int | None = None,
    fuse_max_rows: int | None = None,
    fuse_backend: str | None = None,
    hot_rows: int = 0,
) -> tuple[PlayerState, HistoryOutputs | None]:
    """Rates a raw ``MatchStream`` while its schedule is still being built —
    the fully streamed feed. Returns the final state (a new one; the
    caller's stays valid) and, when ``collect``, per-match outputs in
    stream order.

    Three threads: a WORKER runs the first-fit assignment
    (:func:`~analyzer_tpu_torch.sched.superstep.assign_batches`, the native
    loop with the GIL released) into preallocated buffers and publishes its
    progress; the FEED thread scatters the newly assigned matches into the
    slot->match map, backfills non-ratable fillers into each window's free
    slots in stream order, materializes every complete window of
    ``steps_per_chunk`` supersteps and stages it (for ``kernel="fused"``
    with its residency plans); the caller's thread dispatches the staged
    chunks exactly as :func:`rate_history` does. The batch size comes from
    a bounded prefix of the stream (``choose_batch_size_streamed``) unless
    ``batch_size`` is given.

    Cross-thread protocol: the assignment buffers start at a sentinel, an
    aligned int64 store does not tear, and the feed trims what it reads at
    the first sentinel. A batch is final once its fill count reaches the
    batch size (first-fit never reopens a full batch), so the feed derives
    the watermark from the data it has read. ``Thread.join`` is the one
    synchronization point after which the buffers are read plainly. The
    python assigner wakes the feed at every progress publish through a
    condition variable; the native one cannot call back, so the feed
    also wakes every ``poll_interval`` seconds.

    Deterministic: window boundaries are fixed multiples of
    ``steps_per_chunk`` and fillers are consumed in stream order, so what
    is emitted is a function of (stream, batch size, steps_per_chunk) only.
    The final state equals ``rate_history(pack_schedule(stream))``'s at the
    same batch size bit for bit — each match's update reads only its
    players' prior rows, however the matches are grouped — and so do the
    collected outputs (a filler's place differs, its gate outputs do not).

    ``stats_out`` receives ``n_steps``, ``batch_size``, ``occupancy`` and
    ``choose_batch_size_s`` (and, for the fused path, the planner totals
    of :func:`rate_history`). ``on_chunk(state, next_step)`` fires after
    each dispatched chunk, as in :func:`rate_history`.

    ``mesh`` (ROADMAP A14), ``hot_rows`` (A9) and ``view_publisher`` (A11)
    are not ported yet and raise NotImplementedError unless left at their
    defaults."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet (ROADMAP A14, parallel)"
        )
    _refuse_unported(view_publisher, hot_rows)
    n = stream.n_matches
    team = team_size or max(MAX_TEAM_SIZE, stream.team_size)
    if stream.team_size > team:
        raise ValueError(
            f"stream team size {stream.team_size} exceeds team_size {team}"
        )
    fuse = resolve_fuse(kernel, fuse_window, fuse_max_rows, fuse_backend)
    check_seed_cfg(state, cfg)
    state = state.clone()
    pad_row = state.pad_row
    if n == 0:
        if stats_out is not None:
            stats_out.update(
                n_steps=0, batch_size=0, occupancy=0.0, choose_batch_size_s=0.0
            )
        return state, (_gather_outputs([], np.empty(0, np.int32), 0, team)
                       if collect else None)
    if int(stream.player_idx.max()) >= pad_row:
        raise ValueError(
            f"stream references player row {int(stream.player_idx.max())} "
            f"but the player table only has rows 0..{pad_row - 1}"
        )
    t_choose = time.perf_counter()
    b = batch_size or choose_batch_size_streamed(stream)
    t_choose = time.perf_counter() - t_choose
    feed = _StreamFeed(
        stream, b, steps_per_chunk or min(8192, max(256, -(-n // b) // 8 or 1)),
        team, pad_row, fuse, collect, state.table.is_cuda, poll_interval,
    )
    outs, fused_flat, totals = _consume(
        feed.produce, state, pad_row, cfg, fuse, collect, on_chunk,
        prefetch_depth,
    )
    if stats_out is not None:
        stats_out.update(
            n_steps=feed.s_total, batch_size=b,
            occupancy=n / (feed.s_total * b), choose_batch_size_s=t_choose,
        )
        if fuse is not None:
            stats_out.update(totals)
    if not collect:
        return state, None
    flat_idx = (_flat(fused_flat) if fused_flat is not None
                else feed.slot_map[: feed.s_total * b])
    return state, _gather_outputs(outs, flat_idx, n, team)


class _StreamFeed:
    """The producer side of :func:`rate_stream`. :meth:`produce` runs on the
    Prefetcher's thread: it starts the assigner thread, turns the
    assignment into the slot->match map as it becomes visible, and stages
    every window of ``spc`` supersteps once all its batches are final."""

    SENTINEL = np.iinfo(np.int64).min

    def __init__(self, stream, b, spc, team, pad_row, fuse, collect, pin,
                 poll_interval):
        n = stream.n_matches
        self.stream, self.b, self.spc, self.team = stream, b, spc, team
        self.pad_row, self.fuse, self.collect, self.pin = pad_row, fuse, collect, pin
        self.poll_interval = poll_interval
        self.progress = np.zeros(2, np.int64)
        self.out_b = np.full(n, self.SENTINEL, np.int64)
        self.out_s = np.full(n, self.SENTINEL, np.int64)
        self.fillers = np.flatnonzero(~stream.ratable)
        steps = max(-(-n // b) + 2, 2)
        self.slot_map = np.full(steps * b, -1, np.int32)  # slot -> match
        self.fill_count = np.zeros(steps, np.int32)  # ratable matches per batch
        self.done_m = 0  # assignment entries scattered into slot_map
        self.watermark = 0  # batches known full (final)
        self.n_fill = 0  # fillers placed
        self.emitted = 0  # steps staged for the consumer
        self.s_total = None  # the schedule's steps, once known
        self._cv = threading.Condition()
        self._assigner_done = False
        self._assigner_err: BaseException | None = None

    def _notify(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def _assign(self) -> None:
        """The assigner thread: first-fit into the sentinel-filled buffers,
        publishing progress as it goes."""
        try:
            assign_batches(self.stream, self.b, self.progress, self.out_b,
                           self.out_s, on_progress=self._notify)
        except BaseException as e:  # noqa: BLE001 — re-raised by produce()
            self._assigner_err = e
        finally:
            with self._cv:
                self._assigner_done = True
                self._cv.notify_all()

    def _grow(self, min_steps: int) -> None:
        steps = self.fill_count.size
        if min_steps <= steps:
            return
        while steps < min_steps:
            steps *= 2
        slot_map = np.full(steps * self.b, -1, np.int32)
        slot_map[: self.slot_map.size] = self.slot_map
        fill_count = np.zeros(steps, np.int32)
        fill_count[: self.fill_count.size] = self.fill_count
        self.slot_map, self.fill_count = slot_map, fill_count

    def _scatter_new(self, p: int) -> None:
        """Consumes assignment entries [done_m, p), trimmed at the first one
        not yet visible, and advances the watermark over full batches."""
        d = self.done_m
        nb, ns = self.out_b[d:p], self.out_s[d:p]
        # Either buffer may still show the sentinel where the other does
        # not: no acquire loads order the two on a weakly ordered CPU.
        unwritten = np.flatnonzero((nb == self.SENTINEL) | (ns == self.SENTINEL))
        if unwritten.size:
            p = d + int(unwritten[0])
            nb, ns = nb[: p - d], ns[: p - d]
        if p <= d:
            return
        live = nb >= 0
        if live.any():
            self._grow(int(nb[live].max()) + 1)
            self.slot_map[nb[live] * self.b + ns[live]] = (
                np.flatnonzero(live) + d
            ).astype(np.int32)
            counts = np.bincount(nb[live])
            self.fill_count[: counts.size] += counts.astype(np.int32)
            # First-fit never reopens a full batch: full means final.
            while (self.watermark < self.fill_count.size
                   and self.fill_count[self.watermark] >= self.b):
                self.watermark += 1
        self.done_m = p

    def _stage(self, e0: int, e1: int):
        """Backfills fillers into the free slots of steps [e0, e1) in stream
        order, materializes the window and stages it for the consumer."""
        b = self.b
        win = self.slot_map[e0 * b: e1 * b]  # a view: the backfill lands in the map
        take = min(int((win < 0).sum()), self.fillers.size - self.n_fill)
        if take > 0:
            free = np.flatnonzero(win < 0)[:take]
            win[free] = self.fillers[self.n_fill: self.n_fill + take]
            self.n_fill += take
        mi = win.reshape(e1 - e0, b)
        pidx, _mask = materialize_gather_window(self.stream, mi, self.pad_row,
                                                self.team)
        winner, mode_id, afk = materialize_scalar_window(self.stream, mi)
        if self.fuse is not None:
            return stage_fused_windows(
                pidx, winner, mode_id, afk, self.pad_row, self.fuse,
                match_idx=mi if self.collect else None, pin=self.pin,
            )
        return stage_window(pidx, winner, mode_id, afk, self.pin)

    def _emit(self, put, e1: int) -> None:
        e0 = self.emitted
        try:
            item = self._stage(e0, e1)
        except Exception as e:
            raise FeedStageError(e0, e1) from e
        put((e0, e1, item))
        self.emitted = e1

    def produce(self, put) -> None:
        """Emits every complete window while the assigner runs, then the
        tail. Window boundaries are fixed multiples of ``spc`` whenever the
        data became visible, so thread timing changes only how far ahead a
        window is staged, never what it holds."""
        worker = threading.Thread(target=self._assign, name="sched-assign",
                                  daemon=True)
        worker.start()
        try:
            while True:
                done = self._assigner_done  # read BEFORE consuming progress
                self._scatter_new(int(self.progress[0]))
                advanced = False
                while self.watermark - self.emitted >= self.spc:
                    self._emit(put, self.emitted + self.spc)
                    advanced = True
                if done:
                    break
                if not advanced:
                    with self._cv:
                        # Re-check under the lock: a notify between the
                        # reads above and this wait must not be lost.
                        if (not self._assigner_done
                                and self.done_m == int(self.progress[0])):
                            self._cv.wait(self.poll_interval)
        finally:
            worker.join()
        if self._assigner_err is not None:
            raise RuntimeError("schedule assignment failed") from self._assigner_err
        n, b = self.stream.n_matches, self.b
        self._scatter_new(n)
        if self.done_m != n:  # after join() every entry must be visible
            raise RuntimeError(f"assignment visible up to {self.done_m} of {n}")
        ratable_b = self.out_b[self.out_b >= 0]
        total_b = int(ratable_b.max()) + 1 if ratable_b.size else 0
        # Tail: the fillers left over go into extra all-filler batches after
        # the last assigned one (pack_schedule's rule).
        left = self.fillers.size - self.n_fill
        extra = 0
        if left:
            free_rest = int(
                (self.slot_map[self.emitted * b: total_b * b] < 0).sum()
            ) if total_b > self.emitted else 0
            extra = max(0, -(-(left - free_rest) // b))
        s_total = max(total_b + extra, self.emitted, 1)
        self._grow(s_total)
        while self.emitted < s_total:
            self._emit(put, min(self.emitted + self.spc, s_total))
        self.s_total = s_total


def _gather_outputs(
    outs: list, flat_idx: np.ndarray, n: int, team: int
) -> HistoryOutputs:
    """Unpacks the per-chunk ``[S', B, 3 + 10T]`` packed arrays and
    scatters the slots back to stream order. No chunks (resume at or past
    the end) yields all-zero outputs with ``updated`` all False."""
    t2 = 2 * team
    if not outs:
        return HistoryOutputs(
            quality=np.zeros(n, np.float32),
            shared_mu=np.zeros((n, 2, team), np.float32),
            shared_sigma=np.zeros((n, 2, team), np.float32),
            delta=np.zeros((n, 2, team), np.float32),
            mode_mu=np.zeros((n, 2, team), np.float32),
            mode_sigma=np.zeros((n, 2, team), np.float32),
            any_afk=np.zeros(n, bool),
            updated=np.zeros(n, bool),
        )
    sel = flat_idx >= 0
    dest = flat_idx[sel]
    full = np.concatenate(outs, axis=0)
    outs.clear()
    full = full.reshape(-1, full.shape[-1])  # [S*B, 3 + 5*2T]
    packed = np.zeros((n, full.shape[1]), full.dtype)
    packed[dest] = full[sel]
    del full

    def block(i):  # a view into `packed`
        return packed[:, 3 + i * t2: 3 + (i + 1) * t2].reshape(n, 2, team)

    return HistoryOutputs(
        quality=packed[:, 0],
        shared_mu=block(0),
        shared_sigma=block(1),
        delta=block(2),
        mode_mu=block(3),
        mode_sigma=block(4),
        any_afk=packed[:, 1] > 0.5,
        updated=packed[:, 2] > 0.5,
    )
