"""FabricDirectory: the host-local view of the fleet's version vector.

The port's copy of ``analyzer_tpu.fabric.directory``: the same calls give
the same vectors, snapshots and errors.

Each fabric host publishes its owned shards' rows under ONE monotone
per-host version (its ``ViewPublisher`` — every owned shard advances
together, so a reader of that host can never see shard A at version v
and shard B at v-1: the torn cross-shard pair the protocol forbids).
The directory is each process's bookkeeping of the fleet:

    host -> (owned shards, base urls, last observed version, last seen)

It is deliberately NOT a consensus service. Ownership is a pure
function (:mod:`.topology`), so the directory never arbitrates who owns
what — it only tracks which hosts are reachable and how fresh each
host's published version is. A host whose version has not been observed
to advance within ``down_after_s`` is reported down and leaves the read
merge (:mod:`.route`) without wedging readers; it re-enters on its next
observed publish.

Clock discipline (JAX's lint rule GL048): the directory is
CLOCK-INJECTED like every obs plane — ``observe``/``lag``/``down_hosts`` take ``now``
from the caller (the worker's clock; under the soak the VirtualClock),
so fabric bookkeeping is exactly as deterministic as its driver.

Thread contract: one writer lock inside; ``vector()``/``snapshot()``
return fresh copies, safe from any thread.
"""

from __future__ import annotations

import dataclasses
import threading

from analyzer_tpu_torch.fabric.topology import FabricTopology
from analyzer_tpu_torch.obs import get_registry


@dataclasses.dataclass
class HostEntry:
    """One host's directory row. ``serve_url``/``control_url`` are None
    for in-process hosts (the follower-adoption read path)."""

    host: int
    shards: tuple[int, ...]
    serve_url: str | None = None
    control_url: str | None = None
    version: int = 0
    last_seen: float | None = None
    down: bool = False


class FabricDirectory:
    """Tracks the fleet's ``(host, shards, version)`` vector.

    ``register`` adds a host (idempotent; shards come from the
    topology, not the caller — ownership is not negotiable).
    ``observe`` records a published version at ``now`` and enforces
    per-host monotonicity: a version that moves backwards is a protocol
    violation (a restarted host must re-register, which resets the
    floor) and raises rather than silently serving a rewound view.
    """

    def __init__(
        self, topology: FabricTopology, down_after_s: float = 10.0
    ) -> None:
        self.topology = topology
        self.down_after_s = float(down_after_s)
        self._lock = threading.Lock()
        self._hosts: dict[int, HostEntry] = {}
        reg = get_registry()
        reg.gauge("fabric.hosts").set(topology.n_hosts)
        self._observe_count = reg.counter("fabric.version_observations_total")

    # -- membership -------------------------------------------------------
    def register(
        self,
        host: int,
        serve_url: str | None = None,
        control_url: str | None = None,
        now: float | None = None,
    ) -> HostEntry:
        """Adds (or re-adds) ``host``. Re-registration resets the
        version floor to 0 — the restart path: a rebuilt host starts a
        fresh monotone sequence."""
        if not 0 <= host < self.topology.n_hosts:
            raise ValueError(
                f"host {host} outside the topology's 0..{self.topology.n_hosts - 1}"
            )
        entry = HostEntry(
            host=host,
            shards=self.topology.owned_shards(host),
            serve_url=serve_url,
            control_url=control_url,
            version=0,
            last_seen=now,
        )
        with self._lock:
            self._hosts[host] = entry
        return entry

    def entry(self, host: int) -> HostEntry:
        with self._lock:
            e = self._hosts.get(host)
        if e is None:
            raise KeyError(f"host {host} is not registered in the directory")
        return e

    def hosts(self) -> list[HostEntry]:
        with self._lock:
            return sorted(self._hosts.values(), key=lambda e: e.host)

    # -- the version vector ------------------------------------------------
    def observe(self, host: int, version: int, now: float) -> None:
        """Records that ``host`` has published ``version`` (observed at
        ``now``, the caller's clock). Monotone per host: a rewind flags
        a protocol violation loudly."""
        with self._lock:
            e = self._hosts.get(host)
            if e is None:
                raise KeyError(
                    f"host {host} observed before register(); the fabric "
                    "registers membership before it routes"
                )
            if version < e.version:
                raise ValueError(
                    f"host {host} version rewound {e.version} -> {version}; "
                    "a restarted host must re-register (directory."
                    "register resets its floor)"
                )
            e.version = int(version)
            e.last_seen = float(now)
            e.down = False
        self._observe_count.add(1)

    def mark_down(self, host: int) -> None:
        """Explicitly removes ``host`` from the read merge (probe
        failure, operator action). It re-enters on the next observe."""
        with self._lock:
            e = self._hosts.get(host)
            if e is not None:
                e.down = True

    def vector(self) -> dict[int, int]:
        """The fleet version vector — one monotone version per host."""
        with self._lock:
            return {h: e.version for h, e in sorted(self._hosts.items())}

    # -- health -----------------------------------------------------------
    def down_hosts(self, now: float) -> list[int]:
        """Hosts currently out of the merge: explicitly marked down, or
        not observed within ``down_after_s`` of ``now``."""
        with self._lock:
            out = []
            for h, e in sorted(self._hosts.items()):
                stale = (
                    e.last_seen is None
                    or now - e.last_seen > self.down_after_s
                )
                if e.down or stale:
                    out.append(h)
            return out

    def alive_hosts(self, now: float) -> list[HostEntry]:
        down = set(self.down_hosts(now))
        return [e for e in self.hosts() if e.host not in down]

    def lag_s(self, now: float) -> dict[int, float | None]:
        """Per-host staleness in caller-clock seconds (None = never
        observed) — what /fleetz renders when one host lags."""
        with self._lock:
            return {
                h: (None if e.last_seen is None else max(0.0, now - e.last_seen))
                for h, e in sorted(self._hosts.items())
            }

    # -- routing ----------------------------------------------------------
    def route_shard(self, shard: int) -> HostEntry:
        return self.entry(self.topology.host_of_shard(shard))

    def route_row(self, row: int) -> HostEntry:
        return self.entry(self.topology.host_of_row(row))

    def route_id(self, player_id: str) -> HostEntry:
        return self.entry(self.topology.host_of_id(player_id))

    # -- introspection -----------------------------------------------------
    def snapshot(self, now: float | None = None) -> dict:
        """The /statusz ``fabric.directory`` block: topology, the
        version vector, per-host freshness and down-ness."""
        down = set(self.down_hosts(now)) if now is not None else set()
        with self._lock:
            return {
                "n_shards": self.topology.n_shards,
                "n_hosts": self.topology.n_hosts,
                "hosts": [
                    {
                        "host": h,
                        "shards": list(e.shards),
                        "version": e.version,
                        "serve_url": e.serve_url,
                        "down": e.down or h in down,
                    }
                    for h, e in sorted(self._hosts.items())
                ],
            }
