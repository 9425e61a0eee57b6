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

With ``hot_rows`` either kernel runs against the hot set of a tiered table
(:mod:`analyzer_tpu_torch.sched.tier`), and with ``view_publisher`` the
table is published as versioned serve views at chunk boundaries
(:mod:`analyzer_tpu_torch.serve.view`).

The table is updated IN PLACE on one copy of the caller's state, made at
entry (the JAX package donates its buffer chunk to chunk instead). Per-match
outputs, when collected, come back one chunk behind the dispatch, so the
device-to-host copy of chunk k-1 overlaps chunk k.

Telemetry, under the JAX package's names and arguments: per chunk a
``feed.materialize`` span on the producer thread (sched/feed.py), then on
the consumer thread ``feed.transfer`` (the slab's copy to the device),
``batch.compute`` (the chunk's launches, and with ``collect`` the start of
its outputs' copy back: enqueue cost on the card) and, with ``collect``,
``batch.fetch`` around the wait for the previous chunk's outputs — where
device time surfaces on the host; with a ``view_publisher``, the throttled
publish at each chunk boundary runs in a ``view.publish`` span (as the
mesh's does). The port's own spans split the staging inside
``feed.materialize`` (``feed.gather``, ``feed.plan``, ``feed.pack``) and
time the waits: ``feed.starved`` / ``feed.backpressure`` on the ring
(sched/feed.py) and, in :func:`rate_stream`, ``feed.wait_assign`` while
the feed thread sleeps on the assigner. Each run sets the
``sched.occupancy`` gauge and adds its supersteps to
``sched.steps_total``; device memory is sampled (throttled) at chunk
boundaries.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.fused import fused_window_table
from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE, PlayerState
from analyzer_tpu_torch.core.update import check_seed_cfg, pack_outputs, rate_step_
from analyzer_tpu_torch.obs import (
    get_registry,
    get_tracer,
    maybe_sample_device_memory,
)
from analyzer_tpu_torch.sched.feed import (
    DEFAULT_DEPTH,
    FeedStageError,
    Prefetcher,
    stage_chunk,
    stage_chunk_fused,
    stage_fused_windows,
    stage_window,
)
from analyzer_tpu_torch.sched.residency import PlanScratch, resolve_fuse
from analyzer_tpu_torch.sched.tier import TierManager, stage_chunk_tiered
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


def _dispatch_fused_chunk(table, staged, views, cfg, collect, backend,
                          tier=None):
    """Every residency window of a staged chunk, in order, in place on
    ``table``. Returns the chunk's ``[n_windows * K, B, 3 + 10T]`` packed
    outputs when collecting — the reference chunk's layout plus inert
    padded steps, which ``staged.flat`` maps to -1. On a tiered run each
    window's ``TierPlan`` (promotions in, dirty demotions out) executes
    against the hot table right before its window."""
    ys_parts = []
    plans = staged.tier_plans or (None,) * len(staged.windows)
    for win, tplan in zip(staged.windows, plans):
        if tplan is not None:
            tier.apply(table, tplan, views)
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

    ``hot_rows`` > 0 runs TIERED (:mod:`analyzer_tpu_torch.sched.tier`):
    only a ``hot_rows``-slot hot set (rounded up to a power of two) of the
    player table is device-resident; the rest lives in a host cold tier,
    promoted ahead of the window that needs it on the feed thread and
    LRU-demoted with dirty rows written back one batch per window. Results
    are bit-identical to the untiered run at every hot-set size; 0 (the
    default) leaves the untiered paths untouched. Composes with
    ``kernel="fused"`` (the working-set gather reads through the hot set)
    and with ``view_publisher``; the ``on_chunk`` hook then receives the
    logical full state.

    ``view_publisher`` (a :class:`analyzer_tpu_torch.serve.view.
    ViewPublisher`) makes a long re-rate servable while it runs: a
    throttled snapshot of the table publishes at chunk boundaries (rows
    addressed by index) plus one unthrottled publish of the final state.
    Untiered, each publish copies the whole table; tiered, the rows written
    since the last publish ride the publisher's patch path."""
    fuse = resolve_fuse(kernel, fuse_window, fuse_max_rows, fuse_backend)
    if hot_rows < 0:
        raise ValueError(f"hot_rows must be >= 0, got {hot_rows}")
    check_seed_cfg(state, cfg)
    tier = TierManager(state, hot_rows) if hot_rows else None
    if tier is not None and fuse is not None:
        fuse = tier.clamp_fuse(fuse)
    n_steps = sched.n_steps if stop_after is None else min(stop_after, sched.n_steps)
    if steps_per_chunk is None:
        # About 8 chunks, so host staging overlaps the device; the floor
        # keeps per-chunk overhead amortized, the ceiling bounds the slabs.
        steps_per_chunk = min(8192, max(256, -(-sched.n_steps // 8)))
    # Tiered: the runners only ever see the hot table; the caller's full
    # state became the cold tier (one fetch at entry).
    state = tier.hot_state() if tier is not None else state.clone()
    pin = state.table.is_cuda
    reg = get_registry()
    reg.gauge("sched.occupancy").set(round(sched.occupancy, 4))
    reg.counter("sched.steps_total").add(max(0, n_steps - start_step))
    starts = list(range(start_step, n_steps, steps_per_chunk))

    def produce(put) -> None:
        scratch = PlanScratch()
        for start in starts:
            stop = min(start + steps_per_chunk, n_steps)
            try:
                if fuse is not None:
                    item = stage_chunk_fused(
                        sched, start, stop, fuse, collect, pin, tier=tier,
                        scratch=scratch,
                    )
                elif tier is not None:
                    item = stage_chunk_tiered(sched, start, stop, tier, collect)
                else:
                    item = stage_chunk(sched, start, stop, pin)
            except Exception as e:
                raise FeedStageError(start, stop) from e
            put((start, stop, item))

    state, outs, fused_flat, totals = _consume(
        produce, state, sched.pad_row, cfg, fuse, collect, on_chunk,
        prefetch_depth, tier, view_publisher, end_step=lambda: n_steps,
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


def _record_fused(stats: dict) -> None:
    """One dispatched chunk's fused-feed observables into the registry
    (the JAX package's ``residency.record_plan_telemetry`` series): windows
    dispatched — one ``fused_window`` launch each on the card — budget
    spills, scatter rows avoided, inert pad steps, and the working-set
    high-water mark."""
    reg = get_registry()
    reg.counter("fused.windows_total").add(stats["windows"])
    reg.counter("fused.spills_total").add(stats["spills"])
    reg.counter("fused.writebacks_avoided_total").add(stats["writebacks_avoided"])
    reg.counter("fused.pad_steps_total").add(stats["pad_steps"])
    gauge = reg.gauge("fused.working_set_rows")
    if stats["working_set_rows"] > (gauge.value or 0):
        gauge.set(stats["working_set_rows"])


def _flat(fused_flat: list) -> np.ndarray:
    return (np.concatenate(fused_flat).reshape(-1) if fused_flat
            else np.empty(0, np.int32))


def _consume(produce, state, pad_row, cfg, fuse, collect, on_chunk, depth,
             tier=None, view_publisher=None, end_step=None, admit=None,
             on_dispatched=None, final_publish=True):
    """The consumer loop of the runners and of the migration engine
    (``migrate/engine.py``): dispatches every chunk that ``produce`` stages
    (on the Prefetcher's thread), in place on
    ``state.table`` — the hot table when ``tier`` is given — and publishes
    through ``view_publisher`` at chunk boundaries (throttled) and, with
    ``final_publish``, at the end (always). Returns ``(state, outs,
    fused_flat, totals)``: the final state (tiered: the logical full table,
    reconstructed), the chunks' packed outputs when collecting, the fused
    path's padded slot->match rows (fused + collect, else None) and its
    planner totals. ``end_step()`` gives the ``start`` argument of the last
    ``batch.fetch`` span, read at the end (the streamed schedule's length
    is known only then).

    ``admit(start)`` runs before each chunk's transfer and may block (the
    migration engine's admission gate); ``on_dispatched(start, stop)``
    runs after each chunk's dispatch, before ``on_chunk``."""
    tracer = get_tracer()
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
        for start, stop, staged in pf:
            if admit is not None:
                admit(start)
            slab = staged if fuse is None and tier is None else staged.slab
            # The port's H2D copy: issued here, on the consumer's stream
            # (sched/feed.py), where the JAX package's producer issues it.
            with tracer.span("feed.transfer", cat="sched", start=start):
                views = slab.to_device(device)
            with tracer.span("batch.compute", cat="sched", start=start):
                if fuse is not None:
                    ys = _dispatch_fused_chunk(
                        table, staged, views, cfg, collect, fuse.backend,
                        tier,
                    )
                    if fused_flat is not None:
                        fused_flat.append(staged.flat)
                    for key, val in staged.stats.items():
                        totals[key] = (max(totals[key], val)
                                       if key == "working_set_rows"
                                       else totals[key] + val)
                    _record_fused(staged.stats)
                elif tier is not None:
                    ys = tier.dispatch_chunk(
                        table, staged, views, cfg, collect
                    )
                else:
                    ys = _reference_chunk_(
                        table, pad_row, views, cfg, collect
                    )
                fetch = _Fetch(ys) if collect else None
            del views, staged, slab
            if collect:
                if pending is not None:
                    with tracer.span("batch.fetch", cat="sched", start=start):
                        outs.append(pending.result())
                pending = fetch
            if on_dispatched is not None:
                on_dispatched(start, stop)
            if on_chunk is not None:
                # Tiered: the hook gets the logical full state (cold tier
                # + resident written rows).
                on_chunk(
                    tier.full_state(table) if tier is not None else state,
                    stop,
                )
            if view_publisher is not None:
                # Throttled, and BEFORE the next chunk updates the table in
                # place: the publisher takes its own copy here or not at
                # all.
                with tracer.span("view.publish", cat="sched", start=start):
                    if tier is not None:
                        tier.maybe_publish_view(view_publisher, table)
                    else:
                        view_publisher.maybe_publish_state(state)
            maybe_sample_device_memory()  # chunk-boundary memory gauges
    if view_publisher is not None and final_publish:  # unthrottled
        if tier is not None:
            tier.publish_view(view_publisher, table)
        else:
            view_publisher.publish_state(state)
    if tier is not None:
        # The drained cold tier plus every resident row written since
        # entry: bit-identical to the untiered runner's final table.
        state = tier.finish(table)
    if pending is not None:
        with tracer.span("batch.fetch", cat="sched", start=end_step()):
            outs.append(pending.result())
    return state, outs, fused_flat, totals


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

    ``hot_rows`` and ``view_publisher`` mirror :func:`rate_history`: the
    cold rows are promoted on this same feed thread ahead of the window
    that needs them, and views publish at window boundaries plus the final
    table.

    ``mesh`` (a :class:`~analyzer_tpu_torch.parallel.mesh.Mesh`) composes
    this feed with the sharded-table data parallelism
    (``parallel.mesh.ShardedRun``): every emitted window is routed on the
    feed thread and dispatched to the mesh, so a sharded re-rate gets the
    same concurrent assignment and O(window) host memory. The automatic
    batch size is a multiple of ``lcm(8, D)`` (an explicit ``batch_size``
    must be a multiple of D); ``collect``, ``kernel="fused"`` and
    ``hot_rows`` are refused with the mesh, as in the JAX package; the hook
    receives the snapshot THUNK of :meth:`~analyzer_tpu_torch.parallel.
    mesh.ShardedRun.call_hook`, and a ``view_publisher`` gets only the
    final (gathered) table."""
    n = stream.n_matches
    team = team_size or max(MAX_TEAM_SIZE, stream.team_size)
    if stream.team_size > team:
        raise ValueError(
            f"stream team size {stream.team_size} exceeds team_size {team}"
        )
    fuse = resolve_fuse(kernel, fuse_window, fuse_max_rows, fuse_backend)
    if hot_rows < 0:
        raise ValueError(f"hot_rows must be >= 0, got {hot_rows}")
    check_seed_cfg(state, cfg)
    run = None
    if mesh is not None:
        if collect:
            raise ValueError(
                "collect=True is not supported with mesh= (the sharded "
                "scan carries only the table); use rate_history"
            )
        if fuse is not None:
            raise ValueError(
                "kernel='fused' is not supported with mesh= (the sharded "
                "scatter is per-shard compacted; a per-shard fused "
                "working set is tracked by parallel.mesh's "
                "mesh.writebacks_avoidable_total accounting)"
            )
        if hot_rows:
            raise ValueError(
                "hot_rows > 0 is not supported with mesh= (each shard "
                "tiering its slice independently is the ROADMAP item 2 "
                "composition); drop mesh= or hot_rows"
            )
        from analyzer_tpu_torch.parallel.mesh import ShardedRun

        run = ShardedRun(state, cfg, mesh)
    pad_row = state.pad_row
    tier = TierManager(state, hot_rows) if hot_rows else None
    if tier is not None and fuse is not None:
        fuse = tier.clamp_fuse(fuse)
    if run is None:
        state = tier.hot_state() if tier is not None else state.clone()
    if n == 0:
        if stats_out is not None:
            stats_out.update(
                n_steps=0, batch_size=0, occupancy=0.0, choose_batch_size_s=0.0
            )
        if run is not None:
            state = run.finish()
        elif tier is not None:
            state = tier.finish(state.table)
        return state, (_gather_outputs([], np.empty(0, np.int32), 0, team)
                       if collect else None)
    if int(stream.player_idx.max()) >= pad_row:
        raise ValueError(
            f"stream references player row {int(stream.player_idx.max())} "
            f"but the player table only has rows 0..{pad_row - 1}"
        )
    # The batch-size choice is reported through stats_out (a CLI stats
    # contract), not a phase histogram — a raw clock is the right tool.
    t_choose = time.perf_counter()  # graftlint: disable=GL023
    if run is not None:
        n_dev = mesh.n_shards
        if batch_size is None:
            # The mesh-aware multiple keeps B both 8-aligned and divisible
            # by D, even for a D that is not a power of two.
            m = math.lcm(8, n_dev)
            b = choose_batch_size_streamed(stream, batch_multiple=m)
            b = -(-b // m) * m  # the mean-width candidate can undershoot m
        elif batch_size % n_dev:
            raise ValueError(
                f"batch_size {batch_size} not divisible by mesh size {n_dev}"
            )
        else:
            b = batch_size
    else:
        b = batch_size or choose_batch_size_streamed(stream)
    t_choose = time.perf_counter() - t_choose  # graftlint: disable=GL023
    feed = _StreamFeed(
        stream, b, steps_per_chunk or min(8192, max(256, -(-n // b) // 8 or 1)),
        team, pad_row, fuse, collect, state.table.is_cuda, poll_interval,
        tier, run,
    )
    if run is not None:
        run.consume(feed.produce, on_chunk, prefetch_depth)
    else:
        state, outs, fused_flat, totals = _consume(
            feed.produce, state, pad_row, cfg, fuse, collect, on_chunk,
            prefetch_depth, tier, view_publisher, end_step=lambda: feed.s_total,
        )
    reg = get_registry()
    reg.gauge("sched.occupancy").set(round(n / (feed.s_total * b), 4))
    reg.counter("sched.steps_total").add(feed.s_total)
    if stats_out is not None:
        stats_out.update(
            n_steps=feed.s_total, batch_size=b,
            occupancy=n / (feed.s_total * b), choose_batch_size_s=t_choose,
        )
        if fuse is not None:
            stats_out.update(totals)
    if run is not None:
        state = run.finish()
        if view_publisher is not None:
            view_publisher.publish_state(state)  # final table, unthrottled
        return state, None
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
                 poll_interval, tier=None, run=None, fillers=None):
        n = stream.n_matches
        self.tier = tier
        self.run = run  # a ShardedRun: windows are routed for the mesh
        self.stream, self.b, self.spc, self.team = stream, b, spc, team
        self.pad_row, self.fuse, self.collect, self.pin = pad_row, fuse, collect, pin
        self.poll_interval = poll_interval
        self.progress = np.zeros(2, np.int64)
        self.out_b = np.full(n, self.SENTINEL, np.int64)
        self.out_s = np.full(n, self.SENTINEL, np.int64)
        # The non-ratable matches backfilled into free slots (the migration
        # engine's feed passes none: its assigner places them inline).
        self.fillers = (np.flatnonzero(~stream.ratable) if fillers is None
                        else fillers)
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
        self._wait_span = None  # the open feed.wait_assign, if any
        self.plan_scratch = PlanScratch()  # the residency planner's table

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
        order, materializes the window and stages it for the consumer, in
        one ``feed.materialize`` span (the backfill and materialization in
        its ``feed.gather``)."""
        b = self.b
        tracer = get_tracer()
        with tracer.span("feed.materialize", cat="sched", start=e0):
            with tracer.span("feed.gather", cat="sched", start=e0,
                             steps=e1 - e0) as args:
                # a view: the backfill lands in the map
                win = self.slot_map[e0 * b: e1 * b]
                take = min(int((win < 0).sum()), self.fillers.size - self.n_fill)
                if take > 0:
                    free = np.flatnonzero(win < 0)[:take]
                    win[free] = self.fillers[self.n_fill: self.n_fill + take]
                    self.n_fill += take
                args["fillers"] = take
                mi = win.reshape(e1 - e0, b)
                pidx, mask = materialize_gather_window(
                    self.stream, mi, self.pad_row, self.team
                )
                winner, mode_id, afk = materialize_scalar_window(self.stream, mi)
            if self.run is None and self.fuse is not None:
                return stage_fused_windows(
                    pidx, winner, mode_id, afk, self.pad_row, self.fuse,
                    match_idx=mi if self.collect else None, pin=self.pin,
                    tier=self.tier, start=e0, scratch=self.plan_scratch,
                )
            if self.run is None and self.tier is not None:
                return self.tier.stage_windows(pidx, winner, mode_id, afk)
            if self.run is None:
                return stage_window(pidx, winner, mode_id, afk, self.pin,
                                    start=e0)
        with tracer.span("feed.transfer", cat="sched", start=e0):
            return self.run.stage(pidx, mask, winner, mode_id, afk)

    def _begin_wait(self) -> None:
        """Opens ``feed.wait_assign`` at the first sleep on the assigner of
        a stretch; :meth:`_end_wait` closes it at the next window or the
        assigner's end, so the span is one a stretch, not one a wake."""
        if self._wait_span is None:
            self._wait_span = get_tracer().span(
                "feed.wait_assign", cat="sched", start=self.emitted)
            self._wait_span.__enter__()

    def _end_wait(self) -> None:
        span, self._wait_span = self._wait_span, None
        if span is not None:
            span.__exit__(None, None, None)

    def _emit(self, put, e1: int) -> None:
        self._end_wait()
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
                            self._begin_wait()
                            self._cv.wait(self.poll_interval)
        finally:
            self._end_wait()
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
