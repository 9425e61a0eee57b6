"""Versioned, snapshot-consistent views of the live rating table.

Counterpart of ``analyzer_tpu.serve.view``. The
write plane commits continuously; readers must never observe a
half-committed table. The mechanism is double-buffering at the publish
boundary:

  * the publisher owns a HOST staging table (numpy float32, the same
    ``[P+1, 16]`` packed layout as :mod:`analyzer_tpu_torch.core.state`)
    that only the writer thread mutates;
  * ``publish_*`` builds a NEW device table — a copy-on-write patch of the
    previous view's table when the row bucket is unchanged (clone, then
    ``index_copy_`` of the touched rows: one small host-to-device copy), or
    a full upload of the staging buffer when the table grew a bucket — and
    swaps the current-view reference in one atomic assignment;
  * a reader grabs :meth:`ViewPublisher.current` ONCE per request tick and
    computes everything against that :class:`RatingsView`. The view object
    is frozen: nothing writes its device table after the swap, its id list
    and row map only ever APPEND (guarded by the view's own ``n_players``),
    so a view taken at version ``v`` answers exactly as the table stood at
    ``v`` forever, no matter how far the writer has advanced.

Tensors are mutable where the JAX package's arrays are not, so the
immutability is this module's discipline: every published table is a
tensor this module allocated and owns (never the runner's table, which the
next chunk updates in place; never a tensor aliasing the staging buffer),
and a table is complete on the device BEFORE the swap — the publisher
synchronizes its stream, so a reader on any other thread or stream that
sees the new reference sees the finished table.

Publishing never blocks readers and readers never block publishing — the
only lock is writer-side, serializing concurrent publishers.

Row sizing rides the power-of-two bucket ladder of :func:`row_bucket`, so a
table that grows by appends is rebuilt once per doubling and patched in
between.

The SHARDED plane (:class:`ShardedViewPublisher`) applies the same contract
per mesh shard: the table splits by the mesh's interleaved ownership
(global row ``r`` -> shard ``r % S`` at local row ``r // S``, the
:mod:`analyzer_tpu_torch.parallel.mesh` layout invariant), every publish
swaps ONE :class:`ShardedRatingsView` holding all ``S`` per-shard snapshots
under a single monotone version — a reader can never observe a torn
cross-shard version — and per-shard updates ride the single plane's
copy-on-write ``index_copy_`` patch, so only each shard's touched rows cross
to the device. The shards live on one device (the CPU test shape, and the
one card) or on a list of devices, shard ``d`` on ``devices[d % len]``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from analyzer_tpu_torch.core.state import TABLE_WIDTH
from analyzer_tpu_torch.device import resolve_device
from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs import get_registry
from analyzer_tpu_torch.service.encode import row_bucket

logger = get_logger(__name__)

#: Floor of the staging table's row bucket and of the ladder that
#: :meth:`ViewPublisher.warm_patch_buckets` walks.
PATCH_BUCKET_FLOOR = 64


def _pow2_bucket(n: int, floor: int) -> int:
    return max(floor, 1 << max(n - 1, 0).bit_length())


def shard_of_row(row: int, n_shards: int) -> int:
    """Interleaved shard ownership — THE mesh layout invariant (global row
    ``r`` lives in shard ``r % S``). The serve plane and the write mesh
    must agree or routed lookups read the wrong shard."""
    return row % n_shards


def local_of_row(row: int, n_shards: int) -> int:
    """Shard-local row for a global row (``r // S`` — see
    :func:`shard_of_row`)."""
    return row // n_shards


def shard_player_count(n_players: int, shard: int, n_shards: int) -> int:
    """How many of the first ``n_players`` global rows shard owns."""
    return max(0, -(-(n_players - shard) // n_shards))


def _count_publish_bytes(nbytes: int) -> None:
    """Host-to-device accounting for the publish path: the patch-vs-rebuild
    split is invisible in wall time at test scale, so the byte counter is
    what pins "appends ride the patch path"."""
    reg = get_registry()
    reg.counter("serve.view_publish_bytes_total").add(int(nbytes))


def _patch_rows(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    """New table with ``rows[i]`` written at row ``idx[i]`` — copy-on-write:
    the previous view keeps serving from ``table``, which is not touched."""
    out = table.clone()
    out.index_copy_(0, idx, rows)
    return out


class RatingsView:
    """One immutable published snapshot: a device rating table plus the
    id mapping frozen at ``n_players``.

    ``table`` is ``[alloc+1, 16]`` float32 in the packed
    :mod:`core.state` layout; rows ``n_players..alloc-1`` are NaN ghost
    rows and row ``alloc`` is the padding row masked slots aim at.
    ``_ids``/``_row_of`` may be shared append-only structures — the
    ``n_players`` guard is what freezes them for this version."""

    __slots__ = (
        "version", "table", "n_players", "published_at", "_row_of",
        "_ids", "_host",
    )

    def __init__(self, version, table, n_players, row_of, ids) -> None:
        self.version = version
        self.table = table
        self.n_players = n_players
        self.published_at = time.monotonic()
        self._row_of = row_of
        self._ids = ids
        self._host = None

    @property
    def pad_row(self) -> int:
        return self.table.shape[0] - 1

    @property
    def age_s(self) -> float:
        return time.monotonic() - self.published_at

    def resolve(self, player_id: str) -> int | None:
        """Row for ``player_id`` at THIS version, or None when the player
        was not yet published (including players added in later
        versions — the shared map may know them, this table does not)."""
        if self._row_of is None:  # identity mode: ids ARE row indices
            try:
                row = int(player_id)
            except (TypeError, ValueError):
                return None
        else:
            row = self._row_of.get(player_id)
            if row is None:
                return None
        return row if 0 <= row < self.n_players else None

    def id_of(self, row: int) -> str:
        """The player id published at ``row`` (< ``n_players``)."""
        if self._ids is None:
            return str(row)
        return self._ids[row]

    def host_table(self) -> np.ndarray:
        """The table as host float32 (fetched once, cached; a copy, never
        an alias of the device tensor) — the oracle and debug surfaces
        read this; the serving path only formats leaderboard rows from
        it."""
        if self._host is None:
            self._host = self.table.detach().to("cpu", copy=True).numpy()
        return self._host


class ViewPublisher:
    """The write side: merges committed rating rows and publishes
    immutable :class:`RatingsView` versions on ``device`` (None = the
    card).

    Two modes, fixed by the first publish:

      * **merge mode** (:meth:`publish_rows` — the service worker):
        per-batch posterior rows keyed by player api id accumulate into
        the staging table; unknown ids append new rows;
      * **table mode** (:meth:`publish_state` — ``cli serve``, the sched
        runners): a whole ``PlayerState`` table replaces the staging
        buffer, with an optional id list (None = rows are addressed by
        index).

    Thread contract: any single thread may publish at a time (writer
    lock); :meth:`current` is safe from any thread, lock-free.
    """

    def __init__(self, min_publish_interval_s: float = 2.0, device=None) -> None:
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._row_of: dict[str, int] | None = {}
        self._ids: list[str] | None = []
        self._staging = np.full(
            (PATCH_BUCKET_FLOOR + 1, TABLE_WIDTH), np.nan, np.float32
        )
        self._view: RatingsView | None = None
        self._version = 0
        self.min_publish_interval_s = min_publish_interval_s
        self._last_publish: float | None = None
        # Set by a cutover CONSUMING this publisher as a staging lineage:
        # its buffers were adopted by the live lineage, so further
        # publishes here would tear the adopted state (_swap refuses).
        self._retired = False

    # -- read side --------------------------------------------------------
    def current(self) -> RatingsView | None:
        """The latest published view (None before the first publish).
        One atomic reference read — never blocks, never tears."""
        return self._view

    @property
    def version(self) -> int:
        return self._version

    def view_age_s(self) -> float | None:
        view = self._view
        return None if view is None else view.age_s

    # -- device side ------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """An owning device copy of ``arr``. ``copy=True`` matters on the
        CPU, where ``.to`` would otherwise alias the numpy buffer — and an
        aliased view would mutate under later staging merges, the exact
        torn-read class this double buffer exists to kill."""
        return torch.from_numpy(arr).to(self.device, copy=True)

    def _patch(self, prev: RatingsView, rows_idx: np.ndarray,
               rows: np.ndarray) -> torch.Tensor:
        """The incremental path: only the touched rows cross to the device
        and land in a clone of the previous version's table. (The JAX
        package pads both lists to a power-of-two bucket so its jitted
        scatter compiles a short ladder; nothing compiles here, so the
        lists have their real lengths and the byte counter counts them.)"""
        idx = np.ascontiguousarray(rows_idx, np.int64)
        _count_publish_bytes(idx.nbytes + rows.nbytes)
        return _patch_rows(
            prev.table, self._upload(idx), self._upload(rows)
        )

    # -- write side -------------------------------------------------------
    def publish_rows(self, ids, rows) -> RatingsView:
        """Merges ``rows`` (``[n, 16]`` float32, packed layout) for the
        players named by ``ids`` and publishes a new version. New ids
        append; existing ids overwrite their row (a row named twice takes
        its last value). The worker calls this at each batch commit
        boundary with the batch's posterior table."""
        rows = np.array(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != TABLE_WIDTH or len(ids) != rows.shape[0]:
            raise ValueError(
                f"publish_rows wants [n, {TABLE_WIDTH}] rows matching ids; "
                f"got {rows.shape} for {len(ids)} ids"
            )
        with self._lock:
            if self._row_of is None:
                raise ValueError(
                    "publisher is in table mode (publish_state with "
                    "index-addressed rows); per-id merges need id-mapped "
                    "publishes from the start"
                )
            prev = self._view
            touched = np.empty(len(ids), np.int64)
            for i, pid in enumerate(ids):
                row = self._row_of.get(pid)
                if row is None:
                    row = len(self._ids)
                    self._row_of[pid] = row
                    self._ids.append(pid)
                touched[i] = row
            p = len(self._ids)
            alloc = row_bucket(p)
            self._grow(alloc)
            self._staging[touched] = rows
            if prev is not None and prev.table.shape[0] == alloc + 1:
                # index_copy_ promises no order among duplicate indices:
                # send each touched row once, with its merged value.
                uniq = np.unique(touched)
                table = self._patch(prev, uniq, self._staging[uniq])
            else:
                _count_publish_bytes(self._staging[: alloc + 1].nbytes)
                table = self._upload(self._staging[: alloc + 1])
            return self._swap(table, p)

    def publish_state(self, state, ids=None) -> RatingsView:
        """Publishes a whole rating table: ``state`` is a ``PlayerState``
        (or a raw ``[P+1, 16]`` tensor or array — the last row being the
        padding row either way). ``ids`` maps rows to player ids; None
        serves rows by index (full-history re-rates, checkpoints). The
        table is copied to the host FIRST — the runner updates the
        caller's tensor in place right after this returns."""
        table = getattr(state, "table", state)
        if isinstance(table, torch.Tensor):
            host = table.detach().to("cpu", torch.float32).numpy()
        else:
            host = np.asarray(table, np.float32)
        p = host.shape[0] - 1
        if ids is not None and len(ids) != p:
            raise ValueError(f"{len(ids)} ids for a {p}-player table")
        with self._lock:
            alloc = row_bucket(p)
            if ids is None:
                self._row_of = None
                self._ids = None
            else:
                self._row_of = {pid: i for i, pid in enumerate(ids)}
                self._ids = list(ids)
            self._staging = np.full(
                (alloc + 1, TABLE_WIDTH), np.nan, np.float32
            )
            self._staging[:p] = host[:p]
            _count_publish_bytes(self._staging.nbytes)
            return self._swap(self._upload(self._staging), p)

    def publish_state_patch(
        self, rows_idx, rows, n_players: int, full_table
    ) -> RatingsView:
        """Table-mode INCREMENTAL publish for a writer that knows exactly
        which index-addressed rows changed since the previous version —
        the tiered runner (``sched/tier.py``), whose hot set names every
        row written since the last publish. Only those rows cross to the
        device, riding the same patch path as :meth:`publish_rows`; the
        staging buffer keeps the full-table invariant so later publishes
        (either method) stay consistent. ``rows_idx`` holds no duplicates.

        ``full_table`` is a zero-arg callable producing the whole
        ``[P+1, 16]`` host table — the rebuild fallback, paid only when
        there is no patchable previous view (first publish, an id-mapped
        publisher, or a row-bucket change). A GROWN ``n_players`` within
        the same row bucket stays on the patch path: index-addressed
        appends are just patches past the previous view's ``n_players``,
        and the per-view ``n_players`` guard already freezes the old
        version."""
        rows = np.asarray(rows, np.float32)
        rows_idx = np.asarray(rows_idx, np.int64)
        with self._lock:
            alloc = row_bucket(n_players)
            prev = self._view
            patchable = (
                prev is not None
                and self._row_of is None
                and prev.table.shape[0] == alloc + 1
                and prev.n_players <= n_players
                and self._staging.shape[0] == alloc + 1
            )
            if not patchable:
                host = np.asarray(full_table(), np.float32)
                self._row_of = None
                self._ids = None
                self._staging = np.full(
                    (alloc + 1, TABLE_WIDTH), np.nan, np.float32
                )
                self._staging[:n_players] = host[:n_players]
                _count_publish_bytes(self._staging.nbytes)
                return self._swap(self._upload(self._staging), n_players)
            self._staging[rows_idx] = rows
            return self._swap(self._patch(prev, rows_idx, rows), n_players)

    def due(self) -> bool:
        """Whether the publish throttle window has elapsed. Callers whose
        publish is expensive to PREPARE (the tiered runner's dirty-row
        fetch) check this before building the payload; the first publish
        is always due."""
        return (
            self._last_publish is None
            or time.monotonic() - self._last_publish
            >= self.min_publish_interval_s
        )

    def maybe_publish_state(self, state, ids=None) -> RatingsView | None:
        """Throttled :meth:`publish_state` — the sched runners call this
        at chunk boundaries, where an unthrottled publish would pay a
        table copy per chunk. The first call always publishes."""
        if not self.due():
            return None
        return self.publish_state(state, ids=ids)

    def warm_patch_buckets(self, cap_ids: int) -> int:
        """Walks the patch path once for every id-count bucket up to
        ``cap_ids`` by re-publishing EXISTING rows (idempotent values;
        versions advance). In the JAX package this pre-compiles the patch
        scatter's shape ladder; here it warms the allocator for those
        sizes and — what callers rely on — advances the version by the
        same count: the ladder length is a pure function of ``cap_ids``
        and the published population. Returns the number of warm
        publishes."""
        with self._lock:
            ids = list(self._ids or [])
            if not ids:
                return 0
            row_of = dict(self._row_of)
            staging = self._staging
            n = len(ids)
            cap = _pow2_bucket(
                min(int(cap_ids), max(n, 1)), PATCH_BUCKET_FLOOR
            )
            pages = []
            b = PATCH_BUCKET_FLOOR
            while b <= cap:
                page = [ids[i % n] for i in range(b)]
                rows = staging[[row_of[pid] for pid in page]].copy()
                pages.append((page, rows))
                b *= 2
        for page, rows in pages:
            self.publish_rows(page, rows)
        return len(pages)

    def cutover_from(self, staging: "ViewPublisher") -> RatingsView:
        """THE dual-lineage cutover entry: adopts the ``staging``
        publisher's latest view as this (live) lineage's next version —
        one ``_swap`` under the live writer lock, the staging lineage's
        device table reused BY REFERENCE (no copy). Readers resolving
        ``current()`` observe a monotone version sequence with no torn or
        missing view: they serve the old lineage until the single
        reference assignment inside ``_swap``, and the new view's table is
        the staging lineage's immutable published tensor.

        The staging publisher is CONSUMED: its id map and staging buffer
        transfer to the live lineage (so later live publishes — merge or
        table mode — continue from the migrated state), and it is marked
        retired; any further publish into it raises instead of tearing
        the adopted buffers. The two publisher locks are taken
        SEQUENTIALLY (staging snapshot first, then the live swap), never
        nested — no ordering hazard."""
        with staging._lock:
            view = staging._view
            if view is None:
                raise ValueError(
                    "staging lineage has no published view to cut over to"
                )
            row_of, ids, buf = staging._row_of, staging._ids, staging._staging
            staging._retired = True
        with self._lock:
            self._row_of = row_of
            self._ids = ids
            self._staging = buf
            get_registry().counter("serve.view_cutovers_total").add(1)
            return self._swap(view.table, view.n_players)

    def adopt_view(self, view: RatingsView) -> bool:
        """FOLLOWER adoption: makes ``view`` — another lineage's published
        snapshot — this publisher's current view BY REFERENCE,
        ``cutover_from``'s mechanism without consuming the source. The
        leader keeps publishing into its own lineage; a follower re-adopts
        each new version as it observes one, and its readers get the same
        atomic-reference guarantee as the leader's: one assignment, no
        torn state, version numbers tracking the LEADER's monotone
        sequence (not a local counter).

        Returns True when the view was adopted, False when the follower
        already serves this version (the idempotent re-poll). A version
        moving backwards raises. A follower is read-only by contract: its
        own staging buffer never merges the adopted tables, so publishing
        into it afterwards would fork the lineage — don't."""
        with self._lock:
            if self._retired:
                raise RuntimeError(
                    "publisher was retired by a lineage cutover; a retired "
                    "lineage cannot adopt views"
                )
            cur = self._view
            if cur is not None and view.version == cur.version:
                return False
            if cur is not None and view.version < cur.version:
                raise ValueError(
                    f"adopt_view would rewind {cur.version} -> "
                    f"{view.version}; followers adopt monotone leader "
                    "versions only (a restarted leader means a fresh "
                    "follower)"
                )
            self._view = view
            self._version = view.version
            self._last_publish = time.monotonic()
            reg = get_registry()
            reg.gauge("serve.view_version").set(self._version)
            reg.counter("serve.view_adoptions_total").add(1)
            return True

    def _grow(self, alloc: int) -> None:
        if alloc + 1 <= self._staging.shape[0]:
            return
        bigger = np.full((alloc + 1, TABLE_WIDTH), np.nan, np.float32)
        bigger[: self._staging.shape[0] - 1] = self._staging[:-1]
        self._staging = bigger

    def _swap(self, table: torch.Tensor, n_players: int) -> RatingsView:
        """Builds the next version and swaps the reference (the one
        atomic publication point). Caller holds the writer lock."""
        if self._retired:
            raise RuntimeError(
                "publisher was retired by a lineage cutover (its buffers "
                "now back the live lineage); publish into the live "
                "publisher instead"
            )
        if table.is_cuda:
            # The uploads and the patch above are queued on this thread's
            # stream; a reader may run on another. Finish them before the
            # reference becomes visible.
            torch.cuda.current_stream(table.device).synchronize()
        self._version += 1
        view = RatingsView(
            self._version, table, n_players, self._row_of, self._ids
        )
        self._view = view
        self._last_publish = time.monotonic()
        reg = get_registry()
        reg.gauge("serve.view_version").set(self._version)
        reg.gauge("serve.view_age_seconds").set(0.0)
        reg.counter("serve.view_publishes_total").add(1)
        return view


class ShardedRatingsView:
    """One immutable published snapshot of the SHARDED serving plane: ``S``
    per-shard :class:`RatingsView` objects frozen under a single version
    number. A reader resolving ``current()`` once can never mix shard
    tables from two publishes — the cross-shard torn-read guard is this
    object's existence, not any per-shard discipline.

    Per-shard tables are ``[local_alloc+1, 16]`` in shard-LOCAL row order
    (global row ``r`` -> shard ``r % S`` local row ``r // S``), all shards
    sharing ONE local row bucket."""

    __slots__ = (
        "version", "shards", "n_players", "n_shards", "published_at",
        "_row_of", "_ids", "_host",
    )

    def __init__(self, version, shards, n_players, row_of, ids) -> None:
        self.version = version
        self.shards = tuple(shards)
        self.n_players = n_players
        self.n_shards = len(self.shards)
        self.published_at = time.monotonic()
        self._row_of = row_of
        self._ids = ids
        self._host = None

    @property
    def age_s(self) -> float:
        return time.monotonic() - self.published_at

    def resolve(self, player_id: str) -> int | None:
        """GLOBAL row for ``player_id`` at this version (same contract as
        :meth:`RatingsView.resolve`)."""
        if self._row_of is None:  # identity mode: ids ARE row indices
            try:
                row = int(player_id)
            except (TypeError, ValueError):
                return None
        else:
            row = self._row_of.get(player_id)
            if row is None:
                return None
        return row if 0 <= row < self.n_players else None

    def locate(self, player_id: str) -> tuple[int, int] | None:
        """(shard, local_row) for ``player_id``, or None when unknown — the
        routed-lookup primitive the sharded engine groups by."""
        row = self.resolve(player_id)
        if row is None:
            return None
        return shard_of_row(row, self.n_shards), local_of_row(
            row, self.n_shards
        )

    def id_of(self, row: int) -> str:
        """The player id published at GLOBAL ``row`` (< ``n_players``)."""
        if self._ids is None:
            return str(row)
        return self._ids[row]

    def host_table(self) -> np.ndarray:
        """The logical ``[n_players, 16]`` host table reassembled from the
        per-shard slices (fetched once, cached): the oracle, the shadow
        audit and debug surfaces read it; the routed query path never
        does."""
        if self._host is None:
            out = np.empty((self.n_players, TABLE_WIDTH), np.float32)
            for d, shard in enumerate(self.shards):
                ln = shard.n_players
                if ln:
                    out[d:: self.n_shards] = shard.host_table()[:ln]
            self._host = out
        return self._host


class ShardedViewPublisher:
    """The sharded plane's write side: one version-consistent
    :class:`RatingsView` per mesh shard, swapped atomically as a single
    :class:`ShardedRatingsView` under one monotone version.

    Mirrors :class:`ViewPublisher`'s modes (id-merge :meth:`publish_rows`,
    whole-table :meth:`publish_state`) and adds the mesh runner's
    per-shard incremental entry :meth:`publish_shard_patches` — each
    shard's touched rows ride the single plane's copy-on-write patch, so a
    commit's host-to-device cost is per-shard rows, never the table.

    ``devices`` (optional, a list of torch devices) puts shard ``d``'s
    table on ``devices[d % len(devices)]``; without it every shard lives on
    ``device`` (None = the card).

    Thread contract: identical to :class:`ViewPublisher` — one writer at a
    time (writer lock), :meth:`current` lock-free from any thread.
    """

    def __init__(
        self,
        n_shards: int,
        min_publish_interval_s: float = 2.0,
        devices=None,
        device=None,
    ) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.device = resolve_device(device) if devices is None else None
        self._devices = (
            [resolve_device(d) for d in devices] if devices is not None
            else None
        )
        self._lock = threading.Lock()
        self._row_of: dict[str, int] | None = {}
        self._ids: list[str] | None = []
        self._local_alloc = PATCH_BUCKET_FLOOR
        self._staging = [
            np.full((self._local_alloc + 1, TABLE_WIDTH), np.nan, np.float32)
            for _ in range(self.n_shards)
        ]
        self._view: ShardedRatingsView | None = None
        self._version = 0
        self.min_publish_interval_s = min_publish_interval_s
        self._last_publish: float | None = None
        self._retired = False  # see ViewPublisher: consumed by a cutover

    # -- read side --------------------------------------------------------
    def current(self) -> ShardedRatingsView | None:
        """The latest published sharded view (None before the first
        publish). One atomic reference read — never blocks, never tears
        across shards."""
        return self._view

    @property
    def version(self) -> int:
        return self._version

    def view_age_s(self) -> float | None:
        view = self._view
        return None if view is None else view.age_s

    def due(self) -> bool:
        """Same throttle contract as :meth:`ViewPublisher.due`."""
        return (
            self._last_publish is None
            or time.monotonic() - self._last_publish
            >= self.min_publish_interval_s
        )

    def device_of(self, d: int) -> torch.device:
        """The device shard ``d``'s tables live on."""
        if self._devices is None:
            return self.device
        return self._devices[d % len(self._devices)]

    # -- write side -------------------------------------------------------
    def publish_rows(self, ids, rows) -> ShardedRatingsView:
        """Id-merge publish (the service worker's commit boundary): routes
        each id's row to its owner shard and patches only the shards a
        commit touched — untouched shards carry their previous device
        table forward with zero transfer."""
        rows = np.array(rows, np.float32)
        if (
            rows.ndim != 2
            or rows.shape[1] != TABLE_WIDTH
            or len(ids) != rows.shape[0]
        ):
            raise ValueError(
                f"publish_rows wants [n, {TABLE_WIDTH}] rows matching ids; "
                f"got {rows.shape} for {len(ids)} ids"
            )
        with self._lock:
            if self._row_of is None:
                raise ValueError(
                    "publisher is in table mode (publish_state with "
                    "index-addressed rows); per-id merges need id-mapped "
                    "publishes from the start"
                )
            prev = self._view
            touched = np.empty(len(ids), np.int64)
            for i, pid in enumerate(ids):
                row = self._row_of.get(pid)
                if row is None:
                    row = len(self._ids)
                    self._row_of[pid] = row
                    self._ids.append(pid)
                touched[i] = row
            p = len(self._ids)
            alloc = row_bucket(shard_player_count(p, 0, self.n_shards))
            patchable = prev is not None and alloc == self._local_alloc
            self._grow_local(alloc)
            shard = shard_of_row(touched, self.n_shards)
            local = local_of_row(touched, self.n_shards)
            tables = []
            for d in range(self.n_shards):
                mine = shard == d
                self._staging[d][local[mine]] = rows[mine]
                if patchable and not mine.any():
                    tables.append(prev.shards[d].table)  # zero transfer
                elif patchable:
                    # index_copy_ promises no order among duplicate
                    # indices: send each touched row once, merged.
                    uniq = np.unique(local[mine])
                    tables.append(self._patch_shard(
                        d, prev.shards[d].table, uniq, self._staging[d][uniq]
                    ))
                else:
                    tables.append(self._rebuild_shard(d))
            return self._swap(tables, p)

    def publish_state(self, state, ids=None) -> ShardedRatingsView:
        """Whole-table publish, split by interleaved ownership — the
        topology-blind bootstrap (``cli serve --shards``, the sched
        runners' final snapshot). The table is copied to the host first."""
        table = getattr(state, "table", state)
        if isinstance(table, torch.Tensor):
            host = table.detach().to("cpu", torch.float32).numpy()
        else:
            host = np.asarray(table, np.float32)
        p = host.shape[0] - 1
        if ids is not None and len(ids) != p:
            raise ValueError(f"{len(ids)} ids for a {p}-player table")
        with self._lock:
            if ids is None:
                self._row_of = None
                self._ids = None
            else:
                self._row_of = {pid: i for i, pid in enumerate(ids)}
                self._ids = list(ids)
            self._local_alloc = row_bucket(
                shard_player_count(p, 0, self.n_shards)
            )
            tables = []
            for d in range(self.n_shards):
                self._staging[d] = np.full(
                    (self._local_alloc + 1, TABLE_WIDTH), np.nan, np.float32
                )
                mine = host[:p][d:: self.n_shards]
                self._staging[d][: mine.shape[0]] = mine
                tables.append(self._rebuild_shard(d))
            return self._swap(tables, p)

    def maybe_publish_state(self, state, ids=None) -> ShardedRatingsView | None:
        """Throttled :meth:`publish_state` (the sched-runner surface)."""
        if not self.due():
            return None
        return self.publish_state(state, ids=ids)

    def publish_shard_patches(
        self, patches, n_players: int, full_slices
    ) -> ShardedRatingsView:
        """Table-mode INCREMENTAL publish from a writer that already holds
        per-shard slices in shard-local order — the sharded mesh runner
        (``parallel.mesh.ShardedRun``), whose routing names every row each
        shard wrote since the last publish.

        ``patches``: one ``(local_rows_idx, rows)`` pair per shard (no
        duplicate indices) — only those rows cross to the device.
        ``full_slices``: zero-arg callable producing per-shard ``[>=
        local_n, 16]`` host slices in local row order — the rebuild
        fallback (first publish, id-mapped publisher, bucket growth),
        mirroring :meth:`ViewPublisher.publish_state_patch`."""
        if len(patches) != self.n_shards:
            raise ValueError(
                f"{len(patches)} shard patches for a {self.n_shards}-shard "
                "publisher"
            )
        with self._lock:
            alloc = row_bucket(
                shard_player_count(n_players, 0, self.n_shards)
            )
            prev = self._view
            patchable = (
                prev is not None
                and self._row_of is None
                and alloc == self._local_alloc
                and prev.n_players <= n_players
            )
            if not patchable:
                slices = full_slices()
                self._row_of = None
                self._ids = None
                self._local_alloc = alloc
                tables = []
                for d in range(self.n_shards):
                    ln = shard_player_count(n_players, d, self.n_shards)
                    self._staging[d] = np.full(
                        (alloc + 1, TABLE_WIDTH), np.nan, np.float32
                    )
                    self._staging[d][:ln] = np.asarray(
                        slices[d], np.float32
                    )[:ln]
                    tables.append(self._rebuild_shard(d))
                return self._swap(tables, n_players)
            tables = []
            for d, (idx, rows) in enumerate(patches):
                idx = np.asarray(idx, np.int64)
                rows = np.asarray(rows, np.float32)
                self._staging[d][idx] = rows
                if idx.size:
                    tables.append(
                        self._patch_shard(d, prev.shards[d].table, idx, rows)
                    )
                else:
                    tables.append(prev.shards[d].table)
            return self._swap(tables, n_players)

    def warm_patch_buckets(self, cap_ids: int) -> int:
        """The sharded mirror of :meth:`ViewPublisher.warm_patch_buckets`:
        one publish per ladder bucket, each carrying ``b`` ids PER SHARD,
        keeping the publish COUNT (and so the version sequence) identical
        to the single plane's ladder."""
        with self._lock:
            ids = list(self._ids or [])
            if not ids:
                return 0
            row_of = dict(self._row_of)
            owned = [
                [pid for pid in ids
                 if shard_of_row(row_of[pid], self.n_shards) == d]
                for d in range(self.n_shards)
            ]
            n = len(ids)
            cap = _pow2_bucket(
                min(int(cap_ids), max(n, 1)), PATCH_BUCKET_FLOOR
            )
            pages = []
            b = PATCH_BUCKET_FLOOR
            while b <= cap:
                page = []
                for mine in owned:
                    if mine:
                        page.extend(mine[i % len(mine)] for i in range(b))
                rows = np.stack([
                    self._staging[shard_of_row(row_of[pid], self.n_shards)][
                        local_of_row(row_of[pid], self.n_shards)
                    ]
                    for pid in page
                ])
                pages.append((page, rows))
                b *= 2
        for page, rows in pages:
            self.publish_rows(page, rows)
        return len(pages)

    def cutover_from(self, staging: "ShardedViewPublisher") -> ShardedRatingsView:
        """The sharded mirror of :meth:`ViewPublisher.cutover_from`: all
        ``S`` per-shard tables of the staging lineage's latest view are
        adopted by reference under ONE new version, so a reader can never
        mix pre- and post-cutover shards. Topologies must match — a
        cross-shard-count cutover would need a re-split, which is a
        ``publish_state`` of the migrated table, not a reference swap."""
        if staging.n_shards != self.n_shards:
            raise ValueError(
                f"cannot cut over a {staging.n_shards}-shard staging "
                f"lineage into a {self.n_shards}-shard live plane; "
                "publish_state the migrated table instead"
            )
        with staging._lock:
            view = staging._view
            if view is None:
                raise ValueError(
                    "staging lineage has no published view to cut over to"
                )
            row_of, ids = staging._row_of, staging._ids
            bufs, alloc = staging._staging, staging._local_alloc
            staging._retired = True
        with self._lock:
            self._row_of = row_of
            self._ids = ids
            self._staging = bufs
            self._local_alloc = alloc
            get_registry().counter("serve.view_cutovers_total").add(1)
            return self._swap(
                [shard.table for shard in view.shards], view.n_players
            )

    # -- internals --------------------------------------------------------
    def _upload(self, d: int, arr: np.ndarray) -> torch.Tensor:
        """An owning copy of ``arr`` on shard ``d``'s device (``copy=True``:
        see :meth:`ViewPublisher._upload` on aliasing)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device_of(d), copy=True
        )

    def _patch_shard(self, d: int, prev_table, local_idx, rows):
        """One shard's copy-on-write patch (the single plane's
        :func:`_patch_rows`), the lists at their real lengths."""
        idx = np.ascontiguousarray(local_idx, np.int64)
        rows = np.ascontiguousarray(rows, np.float32)
        _count_publish_bytes(idx.nbytes + rows.nbytes)
        return _patch_rows(prev_table, self._upload(d, idx),
                           self._upload(d, rows))

    def _rebuild_shard(self, d: int) -> torch.Tensor:
        """One shard's owning full-slice upload."""
        _count_publish_bytes(self._staging[d].nbytes)
        return self._upload(d, self._staging[d])

    def _grow_local(self, alloc: int) -> None:
        if alloc <= self._local_alloc:
            return
        for d in range(self.n_shards):
            bigger = np.full((alloc + 1, TABLE_WIDTH), np.nan, np.float32)
            bigger[: self._staging[d].shape[0] - 1] = self._staging[d][:-1]
            self._staging[d] = bigger
        self._local_alloc = alloc

    def _swap(self, tables, n_players: int) -> ShardedRatingsView:
        """Builds the next version — ALL shards under one number — and swaps
        the single reference. Caller holds the writer lock."""
        if self._retired:
            raise RuntimeError(
                "publisher was retired by a lineage cutover (its buffers "
                "now back the live lineage); publish into the live "
                "publisher instead"
            )
        for t in tables:
            if t.is_cuda:
                # Every shard's upload or patch finishes before the one
                # reference becomes visible to readers on other threads.
                torch.cuda.current_stream(t.device).synchronize()
        self._version += 1
        shards = [
            RatingsView(
                self._version, t,
                shard_player_count(n_players, d, self.n_shards), None, None,
            )
            for d, t in enumerate(tables)
        ]
        view = ShardedRatingsView(
            self._version, shards, n_players, self._row_of, self._ids
        )
        self._view = view
        self._last_publish = time.monotonic()
        reg = get_registry()
        reg.gauge("serve.view_version").set(self._version)
        reg.gauge("serve.view_age_seconds").set(0.0)
        reg.gauge("serve.shards").set(self.n_shards)
        reg.counter("serve.view_publishes_total").add(1)
        return view
