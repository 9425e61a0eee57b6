"""FabricShardPublisher: per-host shard publishing over the fabric
protocol.

The port's copy of ``analyzer_tpu.fabric.publish``. The mesh runner
(``parallel/mesh.py rate_history_sharded``) publishes every shard's dirty
rows through one ``ShardedViewPublisher``. That is correct in one process;
on a multi-process mesh each process only sees its own shards' blocks, so
a raw publisher would tear the view. The fabric answer: wrap the
publisher so each host publishes ONLY its owned shards' patches
(``shard % H`` — :mod:`.topology`) under its own monotone version, and
record every publish in the :class:`~analyzer_tpu_torch.fabric.directory.
FabricDirectory` so readers route around staleness instead of reading
torn state.

Only the patches are filtered. A first publish (no previous view) or a
bucket growth makes the inner publisher rebuild every shard from the
writer's ``full_slices`` — the rows of non-owned shards included — as
JAX's publisher does; later publishes never patch them.

The wrapper is also the per-owner staging seam for the sharded backfill:
``migrate.LineageManager.begin_fabric`` wraps its staging lineage in one
of these, so a fabric host's re-rate publishes a staging lineage scoped
to the rows it owns.

Clock discipline: version observations take ``now`` from the caller's
clock, injected at construction — this module never reads a wall clock.
"""

from __future__ import annotations

import numpy as np

from analyzer_tpu_torch.core.state import TABLE_WIDTH


class FabricShardPublisher:
    """Owned-shard filter + directory recording around a
    ``ShardedViewPublisher`` (or anything with its publish surface).

    ``clock`` is the owning worker's injected clock (the soak's
    VirtualClock, ``time.monotonic`` in production workers) — passed in so
    directory observations stay on the caller's timeline; None records
    every observation at 0.0.
    """

    def __init__(self, directory, host: int, inner, clock=None) -> None:
        topo = directory.topology
        if inner.n_shards != topo.n_shards:
            raise ValueError(
                f"publisher has {inner.n_shards} shards but the fabric "
                f"topology says {topo.n_shards}; the two must agree or "
                "ownership filtering drops real patches"
            )
        self.directory = directory
        self.host = int(host)
        self.inner = inner
        self.clock = clock
        self.owned = frozenset(topo.owned_shards(self.host))

    # -- the publish surface the mesh runner drives -----------------------
    @property
    def n_shards(self) -> int:
        return self.inner.n_shards

    @property
    def version(self) -> int:
        return self.inner.version

    def current(self):
        return self.inner.current()

    def due(self) -> bool:
        return self.inner.due()

    def warm_patch_buckets(self, cap_ids: int) -> int:
        return self.inner.warm_patch_buckets(cap_ids)

    def publish_shard_patches(self, patches, n_players, blocks_thunk):
        """The fabric filter: non-owned shards' patches are emptied (an
        empty rows_idx is the publisher's own no-op encoding), owned shards
        pass through untouched, and the resulting version lands in the
        directory. The inner publisher still advances ONE version for all
        its shards — per-host atomicity is exactly what keeps cross-shard
        reads untorn on this host."""
        filtered = []
        for shard, (rows_idx, rows) in enumerate(patches):
            if shard in self.owned:
                filtered.append((rows_idx, rows))
            else:
                filtered.append((
                    np.empty(0, np.int64),
                    np.empty((0, rows.shape[1] if rows.ndim == 2 else TABLE_WIDTH),
                             np.float32),
                ))
        view = self.inner.publish_shard_patches(
            filtered, n_players, blocks_thunk
        )
        self._record()
        return view

    def _record(self) -> None:
        now = self.clock() if self.clock is not None else 0.0
        try:
            self.directory.entry(self.host)
        except KeyError:
            self.directory.register(self.host, now=now)
        self.directory.observe(self.host, self.inner.version, now)
