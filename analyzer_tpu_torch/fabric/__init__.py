"""Multi-host rate fabric: shard-owning worker processes, a
version-consistent cross-host view protocol, and broker-partitioned
ingest (docs/fabric.md).

The port's copy of ``analyzer_tpu.fabric``, with JAX's ``__all__``. Its
hosts run on the card unless asked for the CPU (``device=``).

The single-process analyzer already owns every layer — rating scan,
serve plane, partitioned broker, SLO plane. The fabric is the refactor
that takes "millions of users" from a table size to an actual fleet:

  * **ownership** (:mod:`.topology`) — the serve plane's ``row % S``
    interleaved layout extends one level: shard ``s`` is owned by host
    ``s % H``. Ownership is a pure function of (row, S, H); no lookup
    service, no rebalance protocol, no state.
  * **version vector** (:mod:`.directory`) — each host publishes its
    owned shards' rows under ONE monotone per-host version (its
    ``ViewPublisher``); a host-local :class:`FabricDirectory` tracks
    the fleet's ``(host, shards, version)`` vector. Clock-injected:
    every observation takes ``now`` from the caller.
  * **routing** (:mod:`.route`) — point lookups go to the owning host
    over the existing ``/v1/*`` ServePlane surface; leaderboards merge
    per-host top-k candidates with the serve plane's shard-boundary-
    safe ``(-score, global_row)`` tie-break; tier counts sum exactly.
    In-process readers follow a host's lineage by REFERENCE
    (``ViewPublisher.adopt_view`` — the ``cutover_from`` mechanism
    without consuming the source), so a reader never observes a torn
    cross-shard version pair.
  * **ingest** (:class:`~analyzer_tpu_torch.service.broker.PartitionSubscription`)
    — the partitioned broker's ``<queue>.p<k>.{live,backfill}`` layout
    is the transport; each worker consumes ONLY its owned partitions,
    and ``partition_of == shard ownership`` by construction.

``cli fabric`` launches the host processes (:mod:`.process`);
``cli soak --hosts N`` runs the closed-loop soak over the real
subprocess topology (:mod:`.driver`) with a deterministic block that is
bit-identical per (seed, config) across host counts.
"""

from analyzer_tpu_torch.fabric.directory import FabricDirectory, HostEntry
from analyzer_tpu_torch.fabric.driver import FabricSoakConfig, FabricSoakDriver
from analyzer_tpu_torch.fabric.host import FabricHost, FabricHostConfig
from analyzer_tpu_torch.fabric.matchmaker import ShardMatchmaker
from analyzer_tpu_torch.fabric.publish import FabricShardPublisher
from analyzer_tpu_torch.fabric.route import FabricRouter, FollowerPlane
from analyzer_tpu_torch.fabric.topology import (
    FabricTopology,
    host_of_row,
    host_of_shard,
    owned_partitions,
    owned_rows,
    owned_shards,
    row_of_id,
)

__all__ = [
    "FabricDirectory",
    "FabricHost",
    "FabricHostConfig",
    "FabricRouter",
    "FabricShardPublisher",
    "FabricSoakConfig",
    "FabricSoakDriver",
    "FabricTopology",
    "FollowerPlane",
    "HostEntry",
    "ShardMatchmaker",
    "host_of_row",
    "host_of_shard",
    "owned_partitions",
    "owned_rows",
    "owned_shards",
    "row_of_id",
]
