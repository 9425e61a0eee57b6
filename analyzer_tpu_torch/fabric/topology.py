"""Fabric ownership math — pure functions, no state, no clock.

The port's copy of ``analyzer_tpu.fabric.topology``: integer maps equal to
JAX's for every input. The serve plane's mesh layout invariant
(``serve/view.py``: global row ``r`` lives in shard ``r % S`` at local
index ``r // S``) extends one level to hosts: shard ``s`` is owned by host
``s % H``. Everything the fabric routes — point lookups, match ingest
partitions, view patches — derives from these two modular maps, so
ownership needs no lookup service and no rebalance protocol: any process
that knows ``(S, H)`` computes the same answer.

The companion invariant is ``partition_of == shard ownership``: the
partitioned broker routes a match by its first team-A row's shard
(``x-partition`` header), so a host that consumes exactly its owned
partitions receives exactly its owned players' matches. The fabric's
matchmaking keeps matches SHARD-PURE (every participant in one shard —
:mod:`analyzer_tpu_torch.fabric.matchmaker`), which is what makes that
routing loss-free: no match ever needs rows two hosts own.
"""

from __future__ import annotations

import dataclasses

# THE layout invariant, reused verbatim: fabric ownership must agree with
# the serve plane's shard math or routed lookups read the wrong host.
from analyzer_tpu_torch.serve.view import (  # noqa: F401  (re-exported)
    local_of_row,
    shard_of_row,
    shard_player_count,
)


def host_of_shard(shard: int, n_hosts: int) -> int:
    """Owner host for ``shard`` — the interleaved map one level up
    (shard ``s`` lives on host ``s % H``)."""
    return shard % n_hosts


def host_of_row(row: int, n_shards: int, n_hosts: int) -> int:
    """Owner host for a global row: ``host_of_shard(shard_of_row(r))``."""
    return host_of_shard(shard_of_row(row, n_shards), n_hosts)


def owned_shards(host: int, n_shards: int, n_hosts: int) -> tuple[int, ...]:
    """The shards ``host`` owns, ascending (``s % H == host``)."""
    return tuple(range(host, n_shards, n_hosts))


def owned_partitions(host: int, n_shards: int, n_hosts: int) -> tuple[int, ...]:
    """The broker partitions ``host`` consumes. Partition == shard by the
    ingest invariant, so this IS :func:`owned_shards` — spelled separately
    because the two travel to different subsystems (broker vs view)."""
    return owned_shards(host, n_shards, n_hosts)


def owned_rows(host: int, n_players: int, n_shards: int, n_hosts: int) -> list[int]:
    """Global rows ``host`` owns among the first ``n_players``, ascending —
    the host's authoritative player set (seed publishes, table exports)."""
    return [
        r for r in range(n_players)
        if host_of_row(r, n_shards, n_hosts) == host
    ]


def row_of_id(player_id: str) -> int:
    """Global row for a soak-population api id (``p%06d`` —
    ``loadgen/matchmaker.player_id``): id -> row -> shard -> host, all pure
    functions. Raises ``ValueError`` for ids outside the scheme."""
    if not player_id or player_id[0] != "p" or not player_id[1:].isdigit():
        raise ValueError(
            f"player id {player_id!r} is not in the fabric's p<row> "
            "scheme; cannot derive an owner host"
        )
    return int(player_id[1:])


@dataclasses.dataclass(frozen=True)
class FabricTopology:
    """One fleet's shape: ``n_shards`` fixed by config (the determinism
    key), ``n_hosts`` fixed by deployment. Shards need not be a multiple of
    hosts — ownership interleaves — but every host must own at least one
    shard, or it would idle forever."""

    n_shards: int
    n_hosts: int

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")
        if self.n_hosts > self.n_shards:
            raise ValueError(
                f"{self.n_hosts} hosts but only {self.n_shards} shards — "
                f"host {self.n_shards} would own nothing; raise n_shards "
                "or lower n_hosts"
            )

    def host_of_shard(self, shard: int) -> int:
        return host_of_shard(shard, self.n_hosts)

    def host_of_row(self, row: int) -> int:
        return host_of_row(row, self.n_shards, self.n_hosts)

    def host_of_id(self, player_id: str) -> int:
        return self.host_of_row(row_of_id(player_id))

    def owned_shards(self, host: int) -> tuple[int, ...]:
        return owned_shards(host, self.n_shards, self.n_hosts)

    def owned_partitions(self, host: int) -> tuple[int, ...]:
        return owned_partitions(host, self.n_shards, self.n_hosts)

    def owned_rows(self, host: int, n_players: int) -> list[int]:
        return owned_rows(host, n_players, self.n_shards, self.n_hosts)
