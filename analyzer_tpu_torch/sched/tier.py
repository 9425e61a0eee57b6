"""Tiered ratings table: a device-resident hot set over a pinned host tier.

Counterpart of ``analyzer_tpu.sched.tier``. Without it the WHOLE
``[P+1, 16]`` player table lives in device memory for the runners to rate
against. The tier manager turns device memory into a managed cache:

  * a **hot set** — a device-resident ``[H+1, 16]`` table of ``hot_rows``
    slots (rounded up to a power of two, row ``H`` the padding row) — is
    all the rating step and the fused window ever see;
  * a **cold tier** — the full ``[P+1, 16]`` table as host float32, in a
    buffer of the process staging arena (page-locked where a card is
    visible) — holds the rest and is the authoritative copy of every
    non-resident row;
  * an explicit **page table** (row -> hot slot) is kept on the FEED
    thread: the producer that materializes windows already names every
    window's touched rows, so promotion is planned exactly ``depth`` chunks
    ahead, and the promoted rows ride the chunk's staging slab (one
    host-to-device copy per chunk, issued by the consumer on its stream);
  * **demotion** is LRU at window granularity: when a window needs slots,
    the least-recently-used resident rows it does not touch are evicted;
    rows the device wrote since promotion (**dirty**) are gathered off the
    hot table in one batched copy per window into pinned memory, and land
    in the cold tier once that copy's CUDA event has completed.

Split of authority (the cross-thread contract):

  * the PRODUCER (feed thread) owns the page table, the LRU clock, the
    dirty bits and ``host_version`` — it plans every promotion and demotion
    sequentially, so its model of future device state is exact, just ahead
    of time;
  * the CONSUMER (dispatch loop) owns the cold tier's WRITES, the queue of
    writebacks in flight, and ``applied`` — the highest plan whose
    writebacks are materialized in the cold tier;
  * the producer may stage a cold row eagerly ("fresh") only when
    ``host_version[row] <= applied``, i.e. no writeback of that row is
    still in flight. Otherwise the promotion is DEFERRED: the consumer
    reads it from the cold tier at dispatch time, after draining the queue.
    A device-to-host copy with ``non_blocking=True`` returns before the
    bytes have landed, so the consumer waits on the copy's event BEFORE it
    writes the cold tier, and stores ``applied`` after that write; the GIL
    orders the producer's ``applied`` load before its cold-tier reads. The
    fresh path therefore never reads a stale row.

Bit-identity: tiering changes where rows live, not what is computed.
Remapped indices gather and scatter the same float32 values in the same
order through the same code (``hot_rows=0`` constructs no manager), so the
final table, the collected outputs and every published view equal the
untiered runner's bit for bit at every hot-set size, depth and kernel
(``tests/test_torch_tier.py``).

What equals the JAX package exactly, for the same schedule: the span cuts,
every plan's transaction (evictions, promotions and their slots, dirty
writebacks, deferred rows, written rows) and the six ``tier.*`` counters.
What does not carry over: the JAX package pads the promotion and writeback
index lists to power-of-two buckets so its jitted gather and scatter
compile a short ladder of shapes; eager PyTorch compiles nothing, so the
lists here have their real lengths.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref

import numpy as np
import torch

from analyzer_tpu_torch.obs import get_registry, get_tracer
from analyzer_tpu_torch.obs.devicemem import set_host_tier_sampler
from analyzer_tpu_torch.utils.ownership import thread_role

#: Smallest hot-set capacity: below this a single superstep rarely fits.
MIN_HOT_ROWS = 8


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


_EMPTY = np.empty(0, np.int32)

#: Live managers for the devicemem host-bytes probe (obs/devicemem.py
#: samples the cold tier next to the device-memory gauges).
_MANAGERS: "weakref.WeakSet[TierManager]" = weakref.WeakSet()
_SAMPLER_INSTALLED = False
_SAMPLER_LOCK = threading.Lock()


def _host_tier_bytes() -> int:
    return sum(m.host_nbytes for m in list(_MANAGERS))


@dataclasses.dataclass
class TierPlan:
    """One dispatch window's page-table transaction, planned on the feed
    thread and executed by the consumer before the window's compute.

    ``wb_*`` name the dirty evictions (one batched device-to-host copy);
    ``fresh_*`` carry the eagerly staged promotions; ``deferred_*`` are
    promotions whose latest value is a writeback still in flight — the
    consumer fills them from the cold tier after draining the queue.
    ``evict_rows`` / ``promote_rows`` + ``promote_slots`` /
    ``written_rows`` replay the transaction into the consumer's own
    row -> slot map (the publish / final-reconstruction view of residency).

    ``parts`` is set by the staging code that packed this plan's
    ``wb_slots`` / ``fresh_slots`` / ``fresh_data`` into the chunk's slab:
    the three slab part indices (None where the list is empty). A plan
    without ``parts`` (made by hand, in tests) is uploaded at apply time."""

    seq: int
    wb_slots: np.ndarray  # [n_wb] hot slots to gather
    wb_rows: np.ndarray  # [n_wb] cold-tier rows the gather lands in
    fresh_slots: np.ndarray  # [n_fresh] destination slots
    fresh_data: np.ndarray | None  # [n_fresh, 16] staged promotion rows
    deferred_rows: np.ndarray  # [n_def]
    deferred_slots: np.ndarray  # [n_def]
    evict_rows: np.ndarray  # all evicted rows (clean included)
    promote_rows: np.ndarray  # all promoted rows
    promote_slots: np.ndarray
    written_rows: np.ndarray  # rows this window's scatter commits
    parts: tuple | None = None

    def pack(self, slab) -> None:
        """Adds the plan's device-bound lists to ``slab`` (float32 rows as
        their int32 bit patterns) and drops the host copies."""
        wb = slab.add(self.wb_slots) if self.wb_slots.size else None
        idx = rows = None
        if self.fresh_slots.size:
            idx = slab.add(self.fresh_slots)
            rows = slab.add(self.fresh_data.view(np.int32))
        self.parts = (wb, idx, rows)
        self.fresh_data = None


class TieredChunk:
    """One staged chunk of the reference-kernel tiered path: the slab and
    the budget-split sub-windows, each a (plan, slab part indices of pidx /
    winner / mode_id / afk) pair dispatched in order."""

    __slots__ = ("slab", "parts")

    def __init__(self, slab, parts):
        self.slab = slab
        self.parts = parts


class TierManager:
    """The hot-set / cold-tier state machine. One per tiered run; the feed
    thread calls the ``plan_*`` / ``stage_*`` half, the dispatch loop the
    ``apply`` / ``finish`` / ``publish`` half (see the module docstring for
    the cross-thread contract). The hot table lives on the device of the
    caller's state."""

    def __init__(self, state, hot_rows: int) -> None:
        if hot_rows < 1:
            raise ValueError(f"hot_rows must be >= 1, got {hot_rows}")
        global _SAMPLER_INSTALLED
        self._template = state
        self.device = state.table.device
        self.pad_row = state.pad_row
        self.n_players = state.pad_row
        # The cold tier starts as the caller's full table: one fetch at
        # entry, the tiered sibling of the untiered path's clone. It lives
        # in a page-aligned buffer of the process staging arena
        # (sched/feed.py PinnedArena, the allocator of the ingest decode
        # slabs too: pinned where a card is visible, counted in
        # ingest.arena_bytes), as the JAX package's cold tier does; the
        # values are copied in, so bit-identity is untouched. The
        # arena's torch tensor over the same memory is the copy's handle.
        from analyzer_tpu_torch.sched.feed import get_arena

        arena = get_arena()
        self._host_table = arena.empty(tuple(state.table.shape), np.float32)
        self._host_tensor = arena.tensor(self._host_table)
        self._host_tensor.copy_(state.table)
        self.capacity = _pow2(max(hot_rows, MIN_HOT_ROWS))
        self.hot_pad = self.capacity
        self._pad_vals = self._host_table[self.pad_row].copy()
        # -- producer-owned page table --
        self._slot_lut = np.full(self.pad_row + 1, -1, np.int32)
        self._slot_lut[self.pad_row] = self.hot_pad
        self._row_of = np.full(self.capacity, -1, np.int32)
        self._dirty = np.zeros(self.capacity, bool)
        self._last_use = np.zeros(self.capacity, np.int64)
        self._free = list(range(self.capacity - 1, -1, -1))  # slot 0 first
        self._host_version = np.full(self.pad_row + 1, -1, np.int64)
        self._seq = 0
        # -- consumer-owned --
        self._applied = -1
        self._pending: list = []  # (seq, rows, host copy, event) FIFO
        self._c_slot_of = np.full(self.pad_row + 1, -1, np.int32)
        self._written_pub = np.zeros(self.pad_row + 1, bool)
        self._written_start = np.zeros(self.pad_row + 1, bool)
        reg = get_registry()
        self._hits = reg.counter("tier.hits_total")
        self._misses = reg.counter("tier.misses_total")
        self._promotions = reg.counter("tier.promotions_total")
        self._demotions = reg.counter("tier.demotions_total")
        self._writebacks = reg.counter("tier.dirty_writebacks_total")
        self._spills = reg.counter("tier.spills_total")
        reg.gauge("tier.hot_rows").set(self.capacity)
        reg.gauge("tier.host_bytes").set(self.host_nbytes)
        self._tracer = get_tracer()
        _MANAGERS.add(self)
        # Managers may be built from any thread; the install-once flag
        # needs the lock even though a second install would be harmless.
        with _SAMPLER_LOCK:
            if not _SAMPLER_INSTALLED:
                set_host_tier_sampler(_host_tier_bytes)
                _SAMPLER_INSTALLED = True

    # -- sizing ----------------------------------------------------------
    @property
    def host_nbytes(self) -> int:
        """Cold-tier host bytes: the table plus the page-table arrays —
        what the ``tier.host_bytes`` gauge reports."""
        return int(
            self._host_table.nbytes + self._slot_lut.nbytes
            + self._row_of.nbytes + self._last_use.nbytes
            + self._host_version.nbytes + self._c_slot_of.nbytes
        )

    def hot_state(self):
        """The device-resident hot PlayerState the rating step runs
        against: a ``[capacity+1, 16]`` table whose last row is the padding
        row (copied from the full table so masked gathers read identical
        bits); free slots hold zeros and are never gathered. The feature
        arrays are inert placeholders — the rating step never reads them."""
        hot = np.zeros((self.capacity + 1, self._host_table.shape[1]),
                       np.float32)
        hot[self.hot_pad] = self._pad_vals
        dev = self.device
        return dataclasses.replace(
            self._template,
            table=torch.from_numpy(hot).to(dev),
            rank_points_ranked=torch.zeros(self.capacity + 1, device=dev),
            rank_points_blitz=torch.zeros(self.capacity + 1, device=dev),
            skill_tier=torch.zeros(self.capacity + 1, dtype=torch.int32,
                                   device=dev),
        )

    def clamp_fuse(self, fuse):
        """Caps the fused working-set budget at the hot capacity so every
        fused window's touched rows fit the hot set by construction (the
        residency planner's budget cut then doubles as the tier's
        forced-miss split)."""
        return dataclasses.replace(
            fuse, max_rows=min(fuse.max_rows, self.capacity)
        )

    # -- producer half (feed thread) -------------------------------------
    @thread_role("producer")
    def split_spans(self, player_idx: np.ndarray) -> list[tuple[int, int]]:
        """Cuts a chunk at step boundaries so each sub-window's distinct
        touched rows fit the hot capacity — the forced-miss / thrash path:
        a window bigger than the hot set still rates correctly, paying
        extra promotion traffic (counted as ``tier.spills_total``). The
        cut is exact, from first-touch prefix counts (the same math as the
        fused planner's working-set budget cut)."""
        s_total = player_idx.shape[0]
        per_step = int(np.prod(player_idx.shape[1:]))
        spans: list[tuple[int, int]] = []
        s0 = 0
        while s0 < s_total:
            sub = player_idx[s0:]
            flat = np.concatenate(
                [np.full(1, self.pad_row, player_idx.dtype), sub.ravel()]
            )
            u, first = np.unique(flat, return_index=True)
            first_step = np.maximum(first - 1, 0) // per_step
            cum = np.cumsum(np.bincount(first_step, minlength=s_total - s0))
            # cum counts the padding row once (the virtual element), so
            # real rows in a prefix are cum - 1.
            fits = int(np.searchsorted(cum, self.capacity + 1, side="right"))
            if fits == 0:
                raise ValueError(
                    f"one superstep touches {int(cum[0]) - 1} distinct rows "
                    f"but the hot set holds {self.capacity}; raise hot_rows "
                    "or shrink the batch size"
                )
            spans.append((s0, s0 + fits))
            s0 += fits
        if len(spans) > 1:
            self._spills.add(len(spans) - 1)
        return spans

    @thread_role("producer")
    def plan_rows(self, touched: np.ndarray, written: np.ndarray) -> TierPlan:
        """The page-table transaction for one dispatch window: ``touched``
        (unique, pad-free) must all be resident when the window runs,
        ``written`` (unique, pad-free) become dirty. Returns the plan the
        consumer executes; the page table here is updated immediately —
        the producer's model runs ahead of the device by exactly the
        prefetch depth."""
        seq = self._seq
        if touched.size > self.capacity:
            raise ValueError(
                f"window touches {touched.size} rows but the hot set "
                f"holds {self.capacity} (split_spans missed a cut)"
            )
        slots = self._slot_lut[touched]
        miss_mask = slots < 0
        misses = touched[miss_mask]
        n_hit = int(touched.size - misses.size)
        if n_hit:
            self._hits.add(n_hit)
        evict_rows = wb_slots = wb_rows = assign = _EMPTY
        if misses.size:
            self._misses.add(int(misses.size))
            self._promotions.add(int(misses.size))
            take = min(len(self._free), misses.size)
            freed = [self._free.pop() for _ in range(take)]
            need = misses.size - take
            if need:
                # LRU among resident slots the window does not touch;
                # deterministic tie-break on the slot id. Only the `need`
                # least (last use, slot) pairs are wanted, in order: a
                # partition finds the cut, and a stable sort of the slots
                # at or below it (ascending already) orders them — the
                # same choice as a full lexsort of the capacity, without
                # sorting the capacity for every window.
                lu = np.where(
                    self._row_of >= 0, self._last_use, np.iinfo(np.int64).max
                )
                lu[slots[~miss_mask]] = np.iinfo(np.int64).max
                cut = np.partition(lu, need - 1)[need - 1]
                cand = np.flatnonzero(lu <= cut)
                ev = cand[np.argsort(lu[cand], kind="stable")][:need].astype(
                    np.int32)
                evict_rows = self._row_of[ev].copy()
                ev_dirty = self._dirty[ev]
                wb_slots = ev[ev_dirty]
                wb_rows = evict_rows[ev_dirty]
                self._demotions.add(int(ev.size))
                if wb_rows.size:
                    self._writebacks.add(int(wb_rows.size))
                    self._host_version[wb_rows] = seq
                self._slot_lut[evict_rows] = -1
                self._row_of[ev] = -1
                self._dirty[ev] = False
                assign = np.concatenate(
                    [np.fromiter(freed, np.int32, count=take), ev]
                )
            else:
                assign = np.fromiter(freed, np.int32, count=take)
            self._slot_lut[misses] = assign
            self._row_of[assign] = misses
        # Fresh vs deferred: a row whose last dirty demotion the consumer
        # has already materialized (host_version <= applied, read ONCE)
        # can be staged eagerly from the cold tier on this thread.
        applied = self._applied
        fresh_slots = deferred_rows = deferred_slots = _EMPTY
        fresh_data = None
        if misses.size:
            fresh_mask = self._host_version[misses] <= applied
            f_rows = misses[fresh_mask]
            deferred_rows = misses[~fresh_mask]
            deferred_slots = assign[~fresh_mask]
            if f_rows.size:
                with self._tracer.span("tier.promote", cat="tier", seq=seq):
                    fresh_slots = assign[fresh_mask]
                    fresh_data = self._host_table[f_rows]  # a copy
        self._last_use[self._slot_lut[touched]] = seq
        if written.size:
            self._dirty[self._slot_lut[written]] = True
        self._seq = seq + 1
        return TierPlan(
            seq=seq,
            wb_slots=wb_slots,
            wb_rows=wb_rows,
            fresh_slots=fresh_slots,
            fresh_data=fresh_data,
            deferred_rows=deferred_rows,
            deferred_slots=deferred_slots,
            evict_rows=evict_rows,
            promote_rows=misses,
            promote_slots=assign,
            written_rows=written,
        )

    @thread_role("producer")
    def plan_window(self, player_idx: np.ndarray, valid: np.ndarray):
        """Reference-kernel staging of one (already budget-split)
        sub-window: plans residency for its touched rows and remaps the
        gather indices into hot-slot space. ``valid`` is the written-slot
        mask (``slot_mask & ratable``) — exactly the rows the device
        scatter commits, which is what dirtiness means."""
        touched = np.unique(player_idx)
        if touched.size and touched[-1] == self.pad_row:
            touched = touched[:-1]
        written = np.unique(player_idx[valid])
        plan = self.plan_rows(
            touched.astype(np.int32), written.astype(np.int32)
        )
        hot_pidx = self._slot_lut[player_idx]
        return plan, hot_pidx

    @thread_role("producer")
    def plan_fused(self, slot_rows: np.ndarray, n_live: int,
                   player_idx: np.ndarray, valid: np.ndarray):
        """Fused-kernel staging of one residency window: the fused plan
        already names the touched rows (``slot_rows[1:n_live]`` — slot 0
        is the padding row), so the tier plan reuses them and the remap
        is a single take over ``slot_rows`` (unused slots map to the hot
        padding slot). The fused working set then reads through the hot
        set — composition is exactly this remap."""
        touched = np.sort(slot_rows[1:n_live]).astype(np.int32)
        written = np.unique(player_idx[valid]).astype(np.int32)
        plan = self.plan_rows(touched, written)
        return plan, self._slot_lut[slot_rows]

    @thread_role("producer")
    def stage_windows(self, player_idx, winner, mode_id, afk) -> TieredChunk:
        """Producer-side staging of one reference-kernel chunk: budget
        splits, per-sub-window residency plans, index remap, and the
        packing of every remapped sub-window and its promotions into the
        chunk's one slab (pinned when the hot set is on the card)."""
        from analyzer_tpu_torch.sched.feed import Slab

        ratable = (mode_id >= 0) & ~afk
        slab = Slab()
        parts = []
        for s0, s1 in self.split_spans(player_idx):
            sub = player_idx[s0:s1]
            valid = (sub != self.pad_row) & ratable[s0:s1][:, :, None, None]
            plan, hot_pidx = self.plan_window(sub, valid)
            plan.pack(slab)
            parts.append((plan, tuple(
                slab.add(a) for a in
                (hot_pidx, winner[s0:s1], mode_id[s0:s1], afk[s0:s1])
            )))
        return TieredChunk(slab.finish(self.device.type == "cuda"), parts)

    # -- consumer half (dispatch loop) ------------------------------------
    @thread_role("consumer")
    def _drain(self, wait: bool = True) -> None:
        """Materializes queued writebacks into the cold tier, oldest first.
        Each entry's device-to-host copy was issued with
        ``non_blocking=True``: its bytes are in the pinned buffer only once
        its event has completed, so the event is waited on (``wait``) or
        polled (the queue then stops at the first copy still in flight)
        BEFORE the cold tier is written."""
        while self._pending:
            _seq, rows, host, event = self._pending[0]
            if event is not None:
                if wait:
                    event.synchronize()
                elif not event.query():
                    return
            self._host_table[rows] = host.numpy()
            self._pending.pop(0)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @thread_role("consumer")
    def apply(self, table: torch.Tensor, plan: TierPlan, views=None):
        """Executes one plan against the hot table, in place, in the only
        order that is correct: materialize earlier writebacks (all of them
        when this plan has a deferred promotion, else those whose copies
        have landed), publish how far the cold tier is current
        (``applied``), gather THIS plan's dirty evictions off the table
        (before their slots are overwritten), then write the promotions
        in. ``views`` are the device views of the slab the plan was packed
        into. Returns the table; the caller dispatches the window's
        compute against it."""
        self._drain(wait=bool(plan.deferred_rows.size))
        # The store comes after the cold-tier writes above (the GIL orders
        # them for the producer): every plan before the oldest copy still
        # in flight is materialized.
        self._applied = (
            self._pending[0][0] - 1 if self._pending else plan.seq - 1
        )
        wb = idx = rows = None
        if plan.parts is not None and views is not None:
            wb, idx, rows = (
                None if p is None else views[p] for p in plan.parts
            )
            if rows is not None:
                rows = rows.view(torch.float32)
        else:
            if plan.wb_slots.size:
                wb = self._to_device(plan.wb_slots)
            if plan.fresh_slots.size:
                idx = self._to_device(plan.fresh_slots)
                rows = self._to_device(plan.fresh_data)
        if plan.wb_rows.size:
            with self._tracer.span("tier.demote", cat="tier", seq=plan.seq):
                dev = table.index_select(0, wb.long())
                event = None
                if dev.is_cuda:
                    host = torch.empty(dev.shape, dtype=dev.dtype,
                                       pin_memory=True)
                    host.copy_(dev, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                else:
                    host = dev
                self._pending.append((plan.seq, plan.wb_rows, host, event))
        if idx is not None:
            table.index_copy_(0, idx.long(), rows)
        if plan.deferred_rows.size:
            # The miss path: the row's latest value was still in flight
            # at plan time. The drain above made the cold tier current,
            # so this read is correct — just not overlapped.
            with self._tracer.span("tier.promote", cat="tier",
                                   seq=plan.seq, deferred=True):
                table.index_copy_(
                    0, self._to_device(plan.deferred_slots).long(),
                    self._to_device(self._host_table[plan.deferred_rows]),
                )
        # Replay the transaction into the consumer's own residency view
        # (the publish / final-reconstruction side never reads producer
        # state, which runs ahead of the device).
        if plan.evict_rows.size:
            self._c_slot_of[plan.evict_rows] = -1
        if plan.promote_rows.size:
            self._c_slot_of[plan.promote_rows] = plan.promote_slots
        if plan.written_rows.size:
            self._written_pub[plan.written_rows] = True
            self._written_start[plan.written_rows] = True
        return table

    @thread_role("consumer")
    def dispatch_chunk(self, table, staged: TieredChunk, views, cfg,
                       collect: bool):
        """Consumer-side dispatch of one reference-kernel tiered chunk, in
        place on the hot ``table``: apply each sub-window's plan, rate it
        step by step, concatenate the collected outputs (one fetchable
        tensor per chunk, like the fused path)."""
        from analyzer_tpu_torch.sched.runner import _reference_chunk_

        ys_parts = []
        for plan, part in staged.parts:
            self.apply(table, plan, views)
            ys = _reference_chunk_(
                table, self.hot_pad, tuple(views[i] for i in part), cfg,
                collect,
            )
            if collect:
                ys_parts.append(ys)
        if not collect:
            return None
        return ys_parts[0] if len(ys_parts) == 1 else torch.cat(ys_parts)

    @thread_role("consumer")
    def _fetch_resident(self, table, rows: np.ndarray) -> np.ndarray:
        """Current values of resident ``rows`` off the hot table (one
        gather and one synchronous fetch)."""
        slots = self._to_device(self._c_slot_of[rows]).long()
        return table.index_select(0, slots).cpu().numpy()

    @thread_role("consumer")
    def full_table(self, table) -> np.ndarray:
        """The logical full ``[P+1, 16]`` table as of the last dispatched
        window: the cold tier (drained) plus the current values of every
        resident row written since run start. Used for the final state,
        checkpoint hooks, and full view rebuilds."""
        self._drain()
        full = self._host_table.copy()
        changed = np.flatnonzero(self._written_start)
        resident = changed[self._c_slot_of[changed] >= 0]
        if resident.size:
            full[resident] = self._fetch_resident(table, resident)
        return full

    @thread_role("consumer")
    def full_state(self, table):
        """A PlayerState of :meth:`full_table` on the run's device
        (checkpoint hooks — one sync per snapshot, like the untiered
        hook's fetch)."""
        return dataclasses.replace(
            self._template, table=self._to_device(self.full_table(table))
        )

    @thread_role("consumer")
    def finish(self, table):
        """Final state of a tiered run: drain, reconstruct, and return a
        PlayerState bit-identical to the untiered runner's."""
        return self.full_state(table)

    # -- serve-view publish ------------------------------------------------
    @thread_role("consumer")
    def publish_view(self, publisher, table, force: bool = True):
        """Publishes the logical table through ``publisher`` from the hot
        set: rows written since the last publish come from the hot table
        (resident) or the drained cold tier (demoted), and ride the
        incremental patch path; everything else is what the previous view
        already serves. Views stay snapshot-consistent and bit-identical
        to untiered publishes."""
        if not force and not publisher.due():
            return None
        self._drain()
        changed = np.flatnonzero(self._written_pub)
        vals = self._host_table[changed].copy()
        res_mask = self._c_slot_of[changed] >= 0
        if res_mask.any():
            vals[res_mask] = self._fetch_resident(table, changed[res_mask])
        view = publisher.publish_state_patch(
            changed, vals, self.n_players,
            full_table=lambda: self.full_table(table),
        )
        self._written_pub[:] = False
        return view

    @thread_role("consumer")
    def maybe_publish_view(self, publisher, table):
        """Throttled :meth:`publish_view` — the chunk-boundary hook."""
        return self.publish_view(publisher, table, force=False)


def stage_chunk_tiered(sched, start: int, stop: int, tier: TierManager,
                       collect: bool) -> TieredChunk:
    """Tiered sibling of ``feed.stage_chunk``: materializes the window,
    then splits, plans, remaps and packs it through the tier manager, in
    one ``feed.materialize`` span. ``collect`` needs no extra staging —
    the collected-output layout is row-id-free and the chunk's slot->match
    map is unchanged by the split (sub-windows are prefixes in order)."""
    check = getattr(sched, "check_compact_invariant", None)
    if check is not None:
        check(start, stop)
    from analyzer_tpu_torch.sched.feed import gather_chunk

    with get_tracer().span("feed.materialize", cat="sched", start=start):
        pidx, _mask, winner, mode_id, afk = gather_chunk(sched, start, stop)
        return tier.stage_windows(pidx, winner, mode_id, afk)
