"""Data parallelism over a mesh of shards: sharded player table, sharded scatter.

Counterpart of ``analyzer_tpu.parallel.mesh``, with its layout, routing and
results. The JAX package runs a ``shard_map`` over a 1-D ``data`` axis of
devices; here a :class:`Mesh` is an ordered list of ``D`` shards, each
process of a ``torch.distributed`` group (or the one process without a
group) holding ``D / world_size`` consecutive shards on its own device, as
one shard-major block ``[D_local * rps, 16]``. One code path serves every
shape: D logical shards on one card, one shard per gloo process on the CPU,
or any mix.

  * **Ownership is interleaved** — global row ``r`` lives in shard
    ``r % D`` at local row ``r // D`` (the table padded to ``D * rps``
    rows, ``rps = ceil((P+1)/D)``), THE layout invariant the sharded serve
    plane shares (``serve/view.py``).
  * **Prior assembly** — the only collective on the rating path. Each
    local shard gathers candidate rows for the whole flattened batch from
    its block (out-of-shard slots clamp, then ``where(owned, cand, 0.0)`` —
    never ``NaN * 0``); the process's own contributions add in shard order,
    and a process group then sums them across processes with one
    ``all_reduce(SUM)``. Each slot's row comes from exactly its owner, so
    the prior equals the single-device gather bit for bit, NaN
    never-rated markers included.
  * **Compute is replicated** — every process runs the port's plain
    :func:`~analyzer_tpu_torch.core.update.rate_gathered` on the whole
    batch, as the JAX step does.
  * **The scatter is sharded** — the host routing (:func:`build_routing`,
    :func:`_window_routing`, integer for integer the JAX package's) names,
    per (superstep, shard), the compacted update slots that land in that
    shard (``sel``) and their local rows (``dst``, padded with ``rps``).
    Each superstep writes the process's shards with ONE launch of the
    hand-written row-scatter kernel (``kernels/csrc/row_scatter.cu``,
    ``mode="drop"``) at ``local_shard * rps + dst``, the padding entries
    out of range and dropped. (The JAX step's scatter is XLA's
    ``.at[dst].set(mode="drop")``; the results are the same.) Steps are
    not batched into one launch: step s+1 gathers what step s wrote.

There is no batch all-gather: packing is deterministic, so every process
holds the whole host window; it uploads the whole compact window and only
its own shards' routing. ``mesh.puts_total`` / ``mesh.put_bytes_total``
count the same host arrays the JAX package's ``_put_global`` counts (the
table once, then six arrays a window), so the counters equal JAX's. The
final table and the hook's snapshots gather every process's blocks to every
process.

The fused window does not run here (``rate_stream`` refuses
``kernel='fused'`` with ``mesh=``, as the JAX package does);
``mesh.writebacks_avoidable_total`` counts what a per-shard fused working
set would save.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import MatchBatch, PlayerState
from analyzer_tpu_torch.core.update import rate_gathered
from analyzer_tpu_torch.device import resolve_device
from analyzer_tpu_torch.kernels.row_scatter import row_scatter
from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs import (
    get_registry,
    get_tracer,
    maybe_sample_device_memory,
)
from analyzer_tpu_torch.parallel.multihost import (
    collective_device,
    process_count,
    process_index,
)
from analyzer_tpu_torch.sched.feed import DEFAULT_DEPTH, Prefetcher, Slab
from analyzer_tpu_torch.sched.residency import window_reuse_stats

logger = get_logger(__name__)

#: The ROADMAP item the fabric publisher (``fabric_directory=``) waits for.
A15B = "ROADMAP A15b, the fabric"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_shards`` shards over the processes of the group: process ``rank``
    of ``world_size`` holds shards ``[rank * n_local, (rank+1) * n_local)``
    on ``device``. ``distributed``: a process group exists, and the prior
    assembly and the final gather run through it (at world size 1 too)."""

    n_shards: int
    device: torch.device
    rank: int = 0
    world_size: int = 1
    distributed: bool = False

    @property
    def n_local(self) -> int:
        return self.n_shards // self.world_size

    @property
    def local_shards(self) -> range:
        return range(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the group, in place (no-op without one). The tensor
        crosses to the group's device and back when they differ (gloo takes
        CPU tensors, NCCL the card's)."""
        if not self.distributed:
            return t
        dev = collective_device()
        if t.device == dev:
            dist.all_reduce(t)
            return t
        buf = t.to(dev)
        dist.all_reduce(buf)
        t.copy_(buf)
        return t

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every process's ``t`` (same shape), in rank order, on ``t``'s
        device."""
        if not self.distributed or self.world_size == 1:
            return [t]
        dev = collective_device()
        src = t.to(dev).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src)
        return [p.to(t.device) for p in parts]


def make_mesh(n_shards: int | None = None, device=None) -> Mesh:
    """A mesh of ``n_shards`` shards over this process group's processes
    (None: one shard per process, the JAX package's ``--mesh 0``), each
    process's shards on ``device`` (None = the card; with several cards,
    the one of ``rank % device_count``). Raises when the shards do not
    divide over the processes — a mesh that silently ran fewer shards than
    asked would run at a parallelism the caller did not size the batch
    for."""
    world, rank = process_count(), process_index()
    d = world if n_shards is None else int(n_shards)
    if d < 1:
        raise ValueError(f"a mesh needs at least one shard, got {d}")
    if d % world:
        raise ValueError(
            f"asked for a {d}-shard mesh but {world} processes are "
            "available; the shard count must be a multiple of the process "
            "count"
        )
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    distributed = dist.is_initialized()
    if distributed and dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError(
            f"the process group runs NCCL, which needs the card; the mesh "
            f"asked for {dev}"
        )
    return Mesh(d, dev, rank, world, distributed)


@dataclasses.dataclass(frozen=True)
class Routing:
    """Host-precomputed per-(superstep, shard) scatter compaction.

    Ownership is **interleaved**: global player row ``r`` lives in shard
    ``r % D`` at local row ``r // D``. Interleaving makes per-shard update
    counts near-binomial regardless of player-id locality.

    sel ``[S, D, K]`` int32: flat slot positions (into the ``B*2*T``
      flattened batch) whose player row lives in shard ``d`` at step ``s``;
      padded with 0 (the padding ``dst`` makes the write a no-op).
    dst ``[S, D, K]`` int32: the slot's player row, shard-local; padding
      entries hold ``rows_per_shard`` (out of range -> dropped).
    """

    sel: np.ndarray
    dst: np.ndarray
    rows_per_shard: int
    n_shards: int

    @property
    def capacity(self) -> int:
        return self.sel.shape[2]


def build_routing(sched, n_table_rows: int, n_shards: int) -> Routing:
    """Routes every written slot (a real player in a ratable match) of an
    EAGER schedule to its owner shard, for the whole schedule at once (the
    windowed feed routes per chunk with :func:`_window_routing` instead);
    for repeated runs over one schedule (benchmarks)."""
    s_steps, b = sched.match_idx.shape
    n = b * 2 * sched.player_idx.shape[-1]
    rps = -(-n_table_rows // n_shards)
    ratable = (sched.mode_id >= 0) & ~sched.afk
    valid = sched.slot_mask & ratable[:, :, None, None]
    idx = sched.player_idx.reshape(s_steps, n).astype(np.int64)
    sel, dst = _window_routing(idx, valid.reshape(s_steps, n), n_shards, rps)
    return Routing(sel=sel, dst=dst, rows_per_shard=rps, n_shards=n_shards)


def _window_routing(
    idx_flat: np.ndarray, valid_flat: np.ndarray, n_shards: int, rps: int
) -> tuple[np.ndarray, np.ndarray]:
    """The routing core on flattened ``[W, n]`` window arrays: returns
    (sel, dst) ``[W, D, K]`` int32 at the window's exact capacity
    ``K = max per-(step, shard) valid-slot count`` (>= 1). Padding entries
    hold sel 0 / dst ``rps``. One stable argsort of slot->owner per step
    groups each shard's slots contiguously (the JAX package's algorithm,
    so the arrays are equal integer for integer)."""
    w, n = idx_flat.shape
    owner = np.where(valid_flat, _owner(idx_flat, n_shards), n_shards)

    order = np.argsort(owner, axis=1, kind="stable")
    sorted_owner = np.take_along_axis(owner, order, axis=1)
    flat = (sorted_owner + np.arange(w)[:, None] * (n_shards + 1)).ravel()
    counts = np.bincount(flat, minlength=w * (n_shards + 1)).reshape(
        w, n_shards + 1
    )[:, :n_shards]

    k = max(int(counts.max()) if counts.size else 0, 1)
    start = np.cumsum(counts, axis=1) - counts  # [W, D] exclusive prefix
    pos = start[:, :, None] + np.arange(k)[None, None, :]  # [W, D, K]
    in_range = np.arange(k)[None, None, :] < counts[:, :, None]
    pos = np.minimum(pos, n - 1)
    sel = np.take_along_axis(order, pos.reshape(w, -1), axis=1).reshape(
        w, n_shards, k
    )
    rows = np.take_along_axis(idx_flat, sel.reshape(w, -1), axis=1).reshape(
        w, n_shards, k
    )
    dst = _local_row(rows, n_shards)
    return (
        np.where(in_range, sel, 0).astype(np.int32),
        np.where(in_range, dst, rps).astype(np.int32),
    )


def _owner(row, n_shards):
    """Interleaved ownership, THE layout invariant: global row r lives in
    shard ``r % D`` at local row ``r // D``. Used by the host routing, the
    prior assembly, and the (un)reorder helpers below — change all of them
    together or not at all."""
    return row % n_shards


def _local_row(row, n_shards):
    return row // n_shards


def _to_shard_major(table, n_shards: int, rows_per_shard: int):
    """[D*rps, W] row-major -> shard-major ([D, rps, W] flattened): shard
    d's block holds global rows d, d+D, d+2D, ... (numpy or torch)."""
    width = table.shape[-1]
    return (
        table.reshape(rows_per_shard, n_shards, width)
        .swapaxes(0, 1)
        .reshape(-1, width)
    )


def _from_shard_major(table, n_shards: int, rows_per_shard: int):
    """Inverse of :func:`_to_shard_major`."""
    width = table.shape[-1]
    return (
        table.reshape(n_shards, rows_per_shard, width)
        .swapaxes(0, 1)
        .reshape(-1, width)
    )


def _count_put(nbytes: int) -> None:
    """The JAX package's ``_put_global`` accounting, per host array put to
    the mesh (the same arrays, so the same totals)."""
    reg = get_registry()
    reg.counter("mesh.put_bytes_total").add(int(nbytes))
    reg.counter("mesh.puts_total").add(1)


def sharded_step_fn(mesh: Mesh, cfg: RatingConfig, rows_per_shard: int,
                    pad_row: int):
    """The chunk runner over this process's shard-major block. Returns
    ``run(block, pidx, winner, mode_id, afk, sel, target) -> block``, which
    applies the chunk's supersteps in order, in place on ``block``
    ``[D_local * rps, 16]``: ``pidx`` ``[S, B, 2, T]`` and the ``[S, B]``
    scalars are the whole compact window (the slot mask is derived as
    ``pidx != pad_row``), ``sel`` / ``target`` ``[S, D_local * K]`` this
    process's compacted slots and their block rows (padding out of range).

    Each superstep: the prior psum (each local shard's ``where(owned,
    cand, 0.0)`` contribution added in shard order, then the group's
    ``all_reduce``), the replicated plain update, and ONE ``row_scatter``
    launch (``mode="drop"``) on the block."""
    n_shards, rps = mesh.n_shards, rows_per_shard
    n_local = mesh.n_local
    shard_ids = torch.arange(
        mesh.local_shards.start, mesh.local_shards.stop, device=mesh.device
    )

    def step(block, pidx, winner, mode_id, afk, sel, target) -> None:
        width = block.shape[1]
        flat = pidx.reshape(-1).long()
        loc = _local_row(flat, n_shards).clamp_(0, rps - 1)
        owned = _owner(flat, n_shards)[None, :] == shard_ids[:, None]
        cand = block.view(n_local, rps, width)[:, loc]
        # Disjoint contributions: each slot's row comes from exactly its
        # owner (x + 0 = x), non-owners are hard zeros (never NaN * 0).
        contrib = torch.where(owned[..., None], cand, 0.0)
        rows = contrib[0]
        for j in range(1, n_local):
            rows = rows + contrib[j]
        rows = mesh.all_reduce_(rows)
        batch = MatchBatch(
            player_idx=pidx, slot_mask=pidx != pad_row, winner=winner,
            mode_id=mode_id, afk=afk.bool(),
        )
        out = rate_gathered(rows.view(*pidx.shape, width), batch, cfg)
        new_flat = out.new_rows.reshape(-1, width)
        row_scatter(block, target, new_flat.index_select(0, sel.long()),
                    mode="drop")

    def run(block, pidx, winner, mode_id, afk, sel, target):
        for s in range(pidx.shape[0]):
            step(block, pidx[s], winner[s], mode_id[s], afk[s], sel[s],
                 target[s])
        return block

    return run


class ShardedRun:
    """The device-side half of the sharded re-rate, factored so ANY host
    feed — an eager :class:`PackedSchedule`, a lazy ``WindowedSchedule``
    window loop, or ``rate_stream``'s concurrent assignment — can drive the
    same sharded steps one window at a time with O(window) host memory.

    Holds this process's shard-major block of the padded table;
    :meth:`stage` routes and packs one ``[W, B, ...]`` window on the host,
    :meth:`dispatch_staged` runs it. Routing capacity ``K`` is bucketed
    (25% headroom, multiple of 8) as the JAX package's is, so its routing
    arrays — and the put counters — are the same; a window whose
    per-(step, shard) count outgrows the bucket grows it (logged), and
    buckets never shrink.
    """

    def __init__(
        self,
        state: PlayerState,
        cfg: RatingConfig,
        mesh: Mesh,
        routing_capacity: int | None = None,
        track_dirty: bool = False,
    ) -> None:
        if (
            state.seed_cfg is not None
            and state.seed_cfg.unknown_player_sigma != cfg.unknown_player_sigma
        ):
            raise ValueError(
                f"state seeds were built with UNKNOWN_PLAYER_SIGMA="
                f"{state.seed_cfg.unknown_player_sigma}, but the sharded "
                f"rater was called with {cfg.unknown_player_sigma}; rebuild "
                "the state via PlayerState.create(..., cfg=cfg)"
            )
        self.mesh = mesh
        self.cfg = cfg
        self.n_dev = mesh.n_shards
        self.n_rows = state.table.shape[0]
        self.rps = -(-self.n_rows // self.n_dev)
        self.pad_row = state.pad_row
        self._cap = routing_capacity
        self._state = state
        self._lo = mesh.local_shards.start
        self._n_local = mesh.n_local
        dev = mesh.device
        self._step_fn = sharded_step_fn(mesh, cfg, self.rps, state.pad_row)
        # Per-shard dirty-row accounting for the sharded serve plane: the
        # routing's dst lists already name every local row each shard
        # writes, so a view publish ships exactly those rows — producer
        # (stage) computes, consumer (dispatch) accumulates, publish
        # drains. Off unless a publisher is wired.
        self.track_dirty = track_dirty
        self._dirty: list[list[np.ndarray]] = [[] for _ in range(self.n_dev)]

        # Pad the table to D * rps rows (NaN), reorder into shard-major
        # and keep this process's shards: a fresh buffer, so the in-place
        # steps never touch the caller's state.
        width = state.table.shape[1]
        table = state.table.to(dev)
        pad = self.n_dev * self.rps - self.n_rows
        if pad:
            table = torch.cat([
                table,
                torch.full((pad, width), float("nan"), dtype=table.dtype,
                           device=dev),
            ])
        _count_put(self.n_dev * self.rps * width * table.element_size())
        full = _to_shard_major(table, self.n_dev, self.rps)
        lo = self._lo * self.rps
        self._block = full[lo: lo + self._n_local * self.rps].clone()

    # -- host side (the feed's producer thread) ----------------------------
    def _route_window(
        self, pidx: np.ndarray, mask: np.ndarray, mode_id: np.ndarray,
        afk: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-window routing, padded to the capacity bucket. The window's
        written-row list also feeds the residency reuse accounting shared
        with the fused kernel's planner (``sched.residency.
        window_reuse_stats``): each row instance beyond its first is a
        scatter a per-shard fused working set would have absorbed
        (``mesh.writebacks_avoidable_total``)."""
        ratable = (mode_id >= 0) & ~afk
        valid = mask & ratable[:, :, None, None]
        w = pidx.shape[0]
        idx = pidx.reshape(w, -1).astype(np.int64)
        uniq, instances = window_reuse_stats(idx[valid.reshape(w, -1)])
        if instances > uniq:
            get_registry().counter("mesh.writebacks_avoidable_total").add(
                instances - uniq
            )
        sel, dst = _window_routing(
            idx, valid.reshape(w, -1), self.n_dev, self.rps
        )
        k = sel.shape[2]
        if self._cap is None or k > self._cap:
            new_cap = max(8, -(-int(k * 1.25) // 8) * 8)
            if self._cap is not None:
                logger.info(
                    "sharded routing capacity grew %d -> %d (one recompile)",
                    self._cap, new_cap,
                )
            self._cap = max(new_cap, self._cap or 0)
        if k < self._cap:
            pad = np.zeros(sel.shape[:2] + (self._cap - k,), np.int32)
            sel = np.concatenate([sel, pad], axis=2)
            dst = np.concatenate([dst, pad + self.rps], axis=2)
        return sel, dst

    def stage(
        self,
        pidx: np.ndarray,
        mask: np.ndarray,
        winner: np.ndarray,
        mode_id: np.ndarray,
        afk: np.ndarray,
        sel: np.ndarray | None = None,
        dst: np.ndarray | None = None,
    ) -> tuple:
        """The HOST half of :meth:`dispatch`: routes (unless precomputed
        sel/dst are given) and packs one window into one int32 slab —
        pinned on the card — without running it. Touches neither the table
        nor the device, so the feed's producer thread stages window k+1
        while the consumer runs window k. ``mask`` is consumed here only
        (routing); the device derives it as ``pidx != pad_row``. The slab
        holds the whole window and this process's shards' compacted slots
        and scatter rows (``local_shard * rps + dst``, padding out of
        range). With ``track_dirty`` the staged tuple also carries each
        shard's written local rows for the serve plane's patch publish."""
        if sel is None:
            sel, dst = self._route_window(pidx, mask, mode_id, afk)
        dirty = None
        if self.track_dirty:
            dirty = []
            for d in range(self.n_dev):
                rows = np.unique(dst[:, d, :])
                dirty.append(rows[rows < self.rps].astype(np.int64))
        winner8 = winner.astype(np.int8)
        mode8 = mode_id.astype(np.int8)
        for arr in (pidx, winner8, mode8, afk, sel, dst):
            _count_put(arr.nbytes)
        w = pidx.shape[0]
        lo, hi = self._lo, self._lo + self._n_local
        sel_l, dst_l = sel[:, lo:hi], dst[:, lo:hi]
        base = (np.arange(self._n_local, dtype=np.int64) * self.rps)[None, :, None]
        target = np.where(
            dst_l < self.rps, base + dst_l, self._n_local * self.rps
        ).reshape(w, -1)
        slab = Slab()
        for arr in (pidx, winner, mode_id, afk, sel_l.reshape(w, -1), target):
            slab.add(arr)
        return slab.finish(self.mesh.device.type == "cuda"), dirty

    # -- device side (the consumer thread) -----------------------------------
    def dispatch_staged(self, staged: tuple) -> None:
        """Runs one staged window: its slab's copy to the device (on the
        consumer's stream, as ``sched/feed.py`` issues every copy), then
        its supersteps in order. Consumer-thread only — the in-place block
        serializes windows; the dirty accumulation shares that ordering,
        so a publish covers exactly the windows dispatched before it."""
        slab, dirty = staged
        if dirty is not None:
            for d, rows in enumerate(dirty):
                if rows.size:
                    self._dirty[d].append(rows)
        self._step_fn(self._block, *slab.to_device(self.mesh.device))

    def dispatch(
        self,
        pidx: np.ndarray,
        mask: np.ndarray,
        winner: np.ndarray,
        mode_id: np.ndarray,
        afk: np.ndarray,
        sel: np.ndarray | None = None,
        dst: np.ndarray | None = None,
    ) -> None:
        """Stage + run one window in one call."""
        self.dispatch_staged(
            self.stage(pidx, mask, winner, mode_id, afk, sel, dst)
        )

    def _table(self) -> torch.Tensor:
        """The assembled row-major ``[P+1, 16]`` table: a NEW tensor (every
        process's blocks gathered to every process), never a view of the
        live block."""
        full = torch.cat(self.mesh.all_gather(self._block))
        return _from_shard_major(full, self.n_dev, self.rps)[: self.n_rows].clone()

    def call_hook(self, on_chunk, next_step: int) -> None:
        """Invokes ``on_chunk(snapshot, next_step)`` with a ZERO-ARG THUNK
        producing the assembled (row-major) PlayerState. Evaluating it is a
        cross-process collective, so a multi-process hook must call it on
        every process or on none (make the decision a pure function of
        ``next_step``); skipped chunks pay nothing. The thunk must be
        consumed INSIDE the hook: the next chunk updates the block in
        place, so a deferred evaluation would read a later table — it
        raises loudly instead."""
        live = [True]

        def snapshot(_live=live):
            if not _live[0]:
                raise RuntimeError(
                    "snapshot thunk evaluated after on_chunk returned; "
                    "the table it reads is updated in place by the next "
                    "chunk — consume it inside the hook"
                )
            return dataclasses.replace(self._state, table=self._table())

        on_chunk(snapshot, next_step)
        live[0] = False

    def consume(self, produce, on_chunk=None, depth=None, publisher=None) -> None:
        """The consumer loop of every feed of this run (``rate_history_
        sharded`` and ``rate_stream(mesh=)``): ``produce(put)`` runs on the
        Prefetcher's thread and puts ``(start, stop, staged)`` per window
        (:meth:`stage` output); this thread dispatches each window, then
        publishes to a sharded ``publisher`` (throttled) and hands the hook
        its snapshot thunk — so a publish covers exactly the windows
        dispatched before it."""
        tracer = get_tracer()
        with Prefetcher(
            produce, depth=depth or DEFAULT_DEPTH, name="mesh-feed"
        ) as pf:
            for start, stop, staged in pf:
                with tracer.span("batch.compute", cat="mesh", start=start):
                    self.dispatch_staged(staged)
                del staged
                if publisher is not None:
                    with tracer.span("view.publish", cat="mesh", start=start):
                        self.maybe_publish_views(publisher)
                if on_chunk is not None:
                    self.call_hook(on_chunk, stop)
                maybe_sample_device_memory()  # chunk-boundary memory gauges

    # -- sharded serve-plane publish --------------------------------------
    def _shard_blocks(self) -> list[np.ndarray]:
        """Each local shard's ``[rps, W]`` block on the host. Block ``d``'s
        local row ``j`` is global row ``j*D + d``: the shard-major layout IS
        the serve plane's interleaved local order, so the blocks feed
        ``ShardedViewPublisher`` verbatim."""
        host = self._block.cpu().numpy()
        return [host[j * self.rps: (j + 1) * self.rps]
                for j in range(self._n_local)]

    def maybe_publish_views(self, publisher) -> bool:
        """Throttled :meth:`publish_views` (the chunk-boundary hook)."""
        if not publisher.due():
            return False
        self.publish_views(publisher)
        return True

    def publish_views(self, publisher) -> None:
        """Publishes one version-consistent per-shard view set: only the
        local rows written since the last publish (the accumulated routing
        ``dst`` lists) ride the per-shard patch path into the serving
        tables. ``publisher`` is a
        :class:`~analyzer_tpu_torch.serve.view.ShardedViewPublisher` with
        ``n_shards == mesh size`` on a single-process mesh (validated by
        the runner wiring)."""
        blocks = self._shard_blocks()
        n_players = self.n_rows - 1
        patches = []
        for d in range(self.n_dev):
            if self._dirty[d]:
                rows_idx = np.unique(np.concatenate(self._dirty[d]))
            else:
                rows_idx = np.empty(0, np.int64)
            patches.append((rows_idx, blocks[d][rows_idx]))
            self._dirty[d] = []
        publisher.publish_shard_patches(patches, n_players, lambda: blocks)

    def finish(self) -> PlayerState:
        """Assembles and returns the final row-major state."""
        return dataclasses.replace(self._state, table=self._table())


def rate_history_sharded(
    state: PlayerState,
    sched,
    cfg: RatingConfig,
    mesh: Mesh | None = None,
    steps_per_chunk: int = 1024,
    start_step: int = 0,
    stop_after: int | None = None,
    on_chunk=None,
    routing: Routing | None = None,
    routing_capacity: int | None = None,
    prefetch_depth: int | None = None,
    view_publisher=None,
    fabric_directory=None,
) -> PlayerState:
    """Full-history re-rate, data-parallel over the mesh. Returns the final
    state (on the mesh's device; the caller's stays valid).

    ``sched`` may be an eager :class:`PackedSchedule` or a lazy
    ``WindowedSchedule`` — with the latter both the gather tensors and the
    scatter routing are built per chunk inside the feed loop (O(window)
    host memory). ``sched.batch_size`` must be divisible by the mesh size.
    ``start_step``/``stop_after``/``on_chunk`` mirror
    ``sched.rate_history``'s checkpoint-resume surface; the hook receives a
    snapshot THUNK — see :meth:`ShardedRun.call_hook`. ``routing`` reuses a
    precomputed :func:`build_routing` (validated against the mesh, the
    table and the schedule); ``routing_capacity`` presets the per-window
    routing bucket. ``mesh`` None: one shard per process on the state
    table's device.

    The feed rides the bounded prefetcher (``sched.feed``,
    ``prefetch_depth`` default 2): window materialization and routing run
    on a producer thread (``feed.materialize`` / ``feed.transfer`` spans,
    ``cat="mesh"``) up to depth windows ahead; the consumer alone
    dispatches (a ``batch.compute`` span a chunk, the slab's copy to the
    device included), publishes (``view.publish``) and calls hooks. Chunk order, hook boundaries
    and results are depth-invariant.

    ``view_publisher`` wires the sharded SERVE plane: a
    :class:`~analyzer_tpu_torch.serve.view.ShardedViewPublisher` whose
    ``n_shards`` equals the mesh size gets throttled per-shard patch
    publishes at chunk boundaries plus an unthrottled final publish; a
    plain ``ViewPublisher`` gets only the final assembled table. On a
    multi-process mesh a raw sharded publisher would tear the view (each
    process holds only its own shards) and is refused; the JAX package's
    ``fabric_directory=`` (a ``FabricShardPublisher`` per process) waits
    for ROADMAP A15b and raises NotImplementedError.
    """
    if fabric_directory is not None:
        raise NotImplementedError(
            f"fabric_directory= is not ported yet ({A15B}: the fabric's "
            "FabricShardPublisher); publish through a ShardedViewPublisher "
            "on a single-process mesh"
        )
    mesh = mesh or make_mesh(device=state.table.device)
    n_dev = mesh.n_shards
    if sched.batch_size % n_dev:
        raise ValueError(
            f"batch_size {sched.batch_size} not divisible by mesh size {n_dev}"
        )
    n_rows = state.table.shape[0]
    # The sharded step derives slot_mask on device as player_idx !=
    # state.pad_row (the compact feed). A schedule packed against a
    # DIFFERENT pad row would mark its padding slots as real players —
    # phantom pad-row teammates silently corrupting the update.
    if sched.pad_row != state.pad_row:
        raise ValueError(
            f"schedule packed with pad_row={sched.pad_row} but the state "
            f"table's pad row is {state.pad_row}; repack the schedule with "
            "pad_row=state.pad_row"
        )
    check = getattr(sched, "check_compact_invariant", None)
    if check is not None:  # hand-built eager schedules verify; see there
        check()
    if routing is not None and (
        routing.n_shards != n_dev
        or routing.rows_per_shard * n_dev < n_rows
        or routing.sel.shape[0] != sched.n_steps
    ):
        # A routing from a different packing of the same stream can match
        # on shards/rows and still scatter the wrong slots — bind it to
        # this schedule's step count too.
        raise ValueError(
            f"routing was built for {routing.n_shards} shards x "
            f"{routing.rows_per_shard} rows x {routing.sel.shape[0]} steps; "
            f"mesh has {n_dev} devices, the table {n_rows} rows, and the "
            f"schedule {sched.n_steps} steps"
        )

    sharded_publisher = view_publisher is not None and hasattr(
        view_publisher, "publish_shard_patches"
    )
    if sharded_publisher:
        if mesh.world_size != 1:
            raise ValueError(
                "per-shard view publishing on a multi-process mesh "
                "needs a fabric directory (each process only sees its "
                "own shards' blocks — a raw publisher would tear the "
                "view); pass fabric_directory= to route owned shards "
                "through the fabric protocol, or bring the serve tier "
                "up as its own fleet with `cli fabric`"
            )
        if view_publisher.n_shards != n_dev:
            raise ValueError(
                f"view publisher has {view_publisher.n_shards} shards "
                f"but the mesh has {n_dev} devices; build the "
                "ShardedViewPublisher with n_shards == mesh size"
            )

    run = ShardedRun(
        state, cfg, mesh, routing_capacity=routing_capacity,
        track_dirty=sharded_publisher,
    )
    n_steps = sched.n_steps if stop_after is None else min(stop_after, sched.n_steps)
    tracer = get_tracer()

    def produce(put) -> None:
        for start in range(start_step, n_steps, steps_per_chunk):
            stop = min(start + steps_per_chunk, n_steps)
            with tracer.span("feed.materialize", cat="mesh", start=start):
                pidx, mask, winner, mode_id, afk = sched.host_window(
                    start, stop
                )
            with tracer.span("feed.transfer", cat="mesh", start=start):
                staged = run.stage(
                    pidx, mask, winner, mode_id, afk,
                    sel=routing.sel[start:stop] if routing is not None else None,
                    dst=routing.dst[start:stop] if routing is not None else None,
                )
            put((start, stop, staged))

    run.consume(
        produce, on_chunk, prefetch_depth,
        publisher=view_publisher if sharded_publisher else None,
    )
    if sharded_publisher:
        run.publish_views(view_publisher)  # final per-shard, unthrottled
    final = run.finish()
    if view_publisher is not None and not sharded_publisher:
        view_publisher.publish_state(final)  # final table, unthrottled
    return final
