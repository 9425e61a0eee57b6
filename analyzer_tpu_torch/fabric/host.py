"""FabricHost: one shard-owning worker process of the rate fabric.

The port's copy of ``analyzer_tpu.fabric.host``, on ``config.device``
(None: the card; it raises without one). The host's Worker rates through
its plain superstep, as JAX's rates through its reference scan.

A fabric host is the full single-worker rig — partitioned broker,
store, sequential :class:`~analyzer_tpu_torch.service.worker.Worker` with the
serve plane and obsd attached — scoped to the shards it owns
(``shard % n_hosts == host``, :mod:`.topology`):

  * its broker is a ``PartitionedBroker`` with one partition per shard,
    consumed through a :class:`~analyzer_tpu_torch.service.broker.
    PartitionSubscription` over the OWNED partitions only — the worker
    never sees another host's traffic (``partition_of == shard
    ownership``);
  * its served view covers exactly the owned population: the host is
    seeded with only its owned players' rows and rates only shard-pure
    matches of its owned shards, so every version it publishes is a
    complete, untorn snapshot of "my players";
  * a control plane (``/fabric/*`` POST routes on the shared
    ``obs/httpd.py`` plumbing — no ad-hoc server) lets the fabric
    driver seed, warm, feed per-(tick, shard) match groups, and read the
    final table; the existing ``/v1/*`` serve surface answers routed
    queries and obsd feeds the fleet Collector.

Determinism: the host runs on a :class:`~analyzer_tpu_torch.loadgen.shaper.
VirtualClock` the driver advances through ``/fabric/rate`` — a group is
enqueued whole and drained to empty before the call returns, so batch
composition is a pure function of (group, batch_size), identical across
host counts (docs/fabric.md "Bit-identity across topologies"). A host's
view holds its owned rows in its own local order, and each match is rated
from the priors its players' objects carry, so the bits do not depend on
where a player's row sits.

Clock discipline: no wall-clock reads — every ``now`` is the virtual
clock.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
from analyzer_tpu_torch.fabric.directory import FabricDirectory
from analyzer_tpu_torch.fabric.topology import FabricTopology
from analyzer_tpu_torch.loadgen.shaper import VirtualClock
from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs import get_registry
from analyzer_tpu_torch.obs.httpd import HttpError, RoutedHTTPServer, json_body

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class FabricHostConfig:
    """One host's full parameterization (the subprocess spec,
    ``fabric/process.py``, is this plus file-handshake paths). ``device``
    is where the host rates and serves: None is the card."""

    host: int
    n_shards: int
    n_hosts: int
    seed: int = 0
    n_players: int = 400
    batch_size: int = 64
    quality: bool = True
    slo_plane: bool = True
    down_after_s: float = 10.0
    device: str | None = None


class FabricHost:
    """The in-process composition: build it directly in tests, or let
    ``fabric/process.py`` wrap it in a subprocess with the ready-file
    handshake. ``close()`` tears down both planes (idempotent)."""

    def __init__(self, config: FabricHostConfig) -> None:
        from analyzer_tpu_torch.io.synthetic import synthetic_players
        from analyzer_tpu_torch.service.broker import (
            PartitionedBroker,
            PartitionSubscription,
        )
        from analyzer_tpu_torch.service.store import InMemoryStore
        from analyzer_tpu_torch.service.worker import Worker

        self.cfg = config
        self.topology = FabricTopology(config.n_shards, config.n_hosts)
        if not 0 <= config.host < config.n_hosts:
            raise ValueError(
                f"host {config.host} outside the topology's "
                f"0..{config.n_hosts - 1}"
            )
        self.host = int(config.host)
        self.owned = self.topology.owned_shards(self.host)
        self.vclock = VirtualClock()
        # One partition per shard — THE fabric layout. The subscription
        # is what the worker consumes: owned partitions only.
        self.broker = PartitionedBroker(partitions=config.n_shards)
        self.subscription = PartitionSubscription(
            self.broker, self.topology.owned_partitions(self.host)
        )
        self.store = InMemoryStore()
        self.rating_config = RatingConfig()
        self.worker = Worker(
            self.subscription,
            self.store,
            ServiceConfig(
                batch_size=config.batch_size, idle_timeout=0.0,
                pipeline=False,
            ),
            self.rating_config,
            clock=self.vclock.monotonic,
            pipeline=False,
            serve_port=0,
            obs_port=0,
            slo_plane=config.slo_plane,
            audit=False,
            quality=config.quality,
            device=config.device,
        )
        self.players = synthetic_players(config.n_players, seed=config.seed)
        self.directory = FabricDirectory(
            self.topology, down_after_s=config.down_after_s
        )
        self.directory.register(
            self.host, serve_url=self.worker.serve_server.url,
            now=self.vclock.now,
        )
        reg = get_registry()
        reg.gauge("fabric.host_index").set(self.host)
        reg.gauge("fabric.owned_shards").set(len(self.owned))
        self.worker.fabric_info = self._fabric_stats
        self._player_cache: dict[int, object] = {}
        self._retrace_base: float | None = None
        self._closed = False
        # The control plane: POST verbs on the shared httpd plumbing.
        self.control = RoutedHTTPServer(
            routes={
                "/fabric/status": lambda _p: json_body(self.status()),
                "/fabric/table": lambda _p: json_body(self.table()),
            },
            post_routes={
                "/fabric/seed": lambda b: json_body(self.seed_rows(**b)),
                "/fabric/warmup": lambda b: json_body(
                    self.warm(**(b or {}))
                ),
                "/fabric/rate": lambda b: json_body(self.rate_group(**b)),
                "/fabric/finish": lambda _b: json_body(self.finish()),
                "/fabric/burn": lambda b: json_body(self.burn(**b)),
            },
            name=f"fabric-host-{self.host}",
            json_errors=True,
        )

    # -- introspection -----------------------------------------------------
    def _fabric_stats(self) -> dict:
        """The worker's ``stats()['fabric']`` block (and /statusz's):
        membership + the fleet version vector as this host knows it."""
        return {
            "host": self.host,
            "n_hosts": self.topology.n_hosts,
            "n_shards": self.topology.n_shards,
            "shards": list(self.owned),
            "vector": {
                str(h): v for h, v in self.directory.vector().items()
            },
        }

    @property
    def serve_url(self) -> str:
        return self.worker.serve_server.url

    @property
    def control_url(self) -> str:
        return self.control.url

    @property
    def obs_port(self) -> int:
        return self.worker.obs_server.port

    def status(self) -> dict:
        queue = self.worker.config.queue
        return {
            "host": self.host,
            "owned_shards": list(self.owned),
            "version": self.worker.view_publisher.version,
            "matches_rated": self.worker.matches_rated,
            "batches_ok": self.worker.batches_ok,
            "dead_letters": self.worker.dead_letters,
            "queue_depth": (
                self.subscription.qsize(queue) + len(self.worker.queue)
            ),
            "virtual_now": self.vclock.now,
            "directory": self.directory.snapshot(self.vclock.now),
        }

    def table(self) -> dict:
        """The owned population's final rows — ids + packed float32 rows
        (exact through JSON: every float32 is representable as a
        double). The driver reassembles per-host tables into global row
        order for the topology-invariant final-table digest."""
        view = self.worker.view_publisher.current()
        if view is None:
            return {"version": 0, "ids": [], "rows": []}
        host_rows = view.host_table()[: view.n_players]
        return {
            "version": view.version,
            "ids": [view.id_of(r) for r in range(view.n_players)],
            "rows": [
                [float(x) for x in row] for row in np.asarray(host_rows)
            ],
        }

    # -- the driver's verbs ------------------------------------------------
    def seed_rows(self, ids, rows) -> dict:
        """Publishes version 1 over the OWNED seed population. ``ids``
        must all be owned — a foreign id here means the driver sliced
        the population wrong, which would silently tear ownership."""
        for pid in ids:
            owner = self.topology.host_of_id(pid)
            if owner != self.host:
                raise HttpError(
                    400,
                    f"id {pid} belongs to host {owner}, not {self.host}",
                )
        table = np.asarray(rows, np.float32)
        view = self.worker.view_publisher.publish_rows(list(ids), table)
        self.directory.observe(self.host, view.version, self.vclock.now)
        return {"host": self.host, "version": view.version, "n": len(ids)}

    def warm(self, cap_ids: int | None = None) -> dict:
        """The production warm-up discipline (SoakDriver.prepare): worker +
        engine warmup, the publisher's patch-bucket ladder, and the retrace
        base the steady-state SLO is measured from. Nothing in the port is
        jitted, so ``jax.retraces_total`` stays 0 and the base is 0."""
        from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE

        self.worker.warmup()
        self.worker.query_engine.warmup()
        self.worker.view_publisher.warm_patch_buckets(
            int(cap_ids)
            if cap_ids is not None
            else self.cfg.batch_size * 2 * MAX_TEAM_SIZE
        )
        self._retrace_base = float(
            get_registry().counter("jax.retraces_total").value
        )
        return {
            "host": self.host,
            "version": self.worker.view_publisher.version,
            "retrace_base": self._retrace_base,
        }

    def _player_obj(self, row: int):
        """One shared duck-typed player object per owned row — the
        worker's write-back updates the priors the next batch loads
        (the same closed loop as SoakDriver._player_obj)."""
        obj = self._player_cache.get(row)
        if obj is None:
            from analyzer_tpu_torch.fixtures import fake_player
            from analyzer_tpu_torch.loadgen.matchmaker import player_id

            p = self.players

            def _opt(x):
                return None if np.isnan(x) else float(x)

            obj = fake_player(
                skill_tier=int(p.skill_tier[row]),
                rank_points_ranked=_opt(p.rank_points_ranked[row]),
                rank_points_blitz=_opt(p.rank_points_blitz[row]),
            )
            obj.api_id = player_id(row)
            self._player_cache[row] = obj
        return obj

    def _build_match(self, spec: dict):
        from analyzer_tpu_torch.fixtures import (
            fake_match,
            fake_participant,
            fake_roster,
        )

        winner = int(spec["winner"])
        afk = bool(spec["afk"])
        rosters = []
        for t, rows in enumerate((spec["a_rows"], spec["b_rows"])):
            parts = [
                fake_participant(
                    player=self._player_obj(int(r)),
                    skill_tier=int(self.players.skill_tier[int(r)]),
                    went_afk=bool(afk and t == 0 and s == 0),
                )
                for s, r in enumerate(rows)
            ]
            rosters.append(
                fake_roster(winner=int(t == winner), participants=parts)
            )
        match = fake_match(spec["mode"], rosters, api_id=spec["id"])
        match.created_at = int(spec["created_at"])
        return match

    def rate_group(self, now, matches, peer_versions=None) -> dict:
        """One (tick, shard) match group: advance the virtual clock to
        the driver's ``now``, enqueue every match (original headers —
        the trace chain's broker hop and the ``x-partition`` routing
        ride them), then poll until the backlog is EMPTY. The drain
        barrier is the bit-identity keystone: batch composition becomes
        a pure function of (group, batch_size), so the rating bits
        cannot depend on how many hosts the shards landed on."""
        if now > self.vclock.now:
            self.vclock.advance(now - self.vclock.now)
        for spec in matches:
            for r in list(spec["a_rows"]) + list(spec["b_rows"]):
                shard = int(r) % self.topology.n_shards
                if self.topology.host_of_shard(shard) != self.host:
                    raise HttpError(
                        400,
                        f"match {spec['id']} touches row {r} of shard "
                        f"{shard}, owned by host "
                        f"{self.topology.host_of_shard(shard)} — the "
                        "fabric only routes shard-pure matches to their "
                        "owner",
                    )
            match = self._build_match(spec)
            self.store.add_match(match)
            self.broker.publish(
                self.worker.config.queue,
                match.api_id.encode(),
                headers=spec.get("headers") or None,
            )
        queue = self.worker.config.queue
        budget = 2 * len(matches) + 50
        while (
            self.subscription.qsize(queue) or self.worker.queue
        ) and budget > 0:
            self.worker.poll()
            budget -= 1
        if self.subscription.qsize(queue) or self.worker.queue:
            raise HttpError(
                503,
                f"host {self.host} could not drain a {len(matches)}-match "
                "group; the fabric's per-group barrier is stuck",
            )
        self.directory.observe(
            self.host, self.worker.view_publisher.version, self.vclock.now
        )
        for h, v in (peer_versions or {}).items():
            h = int(h)
            if h == self.host:
                continue
            try:
                self.directory.entry(h)
            except KeyError:
                self.directory.register(h, now=self.vclock.now)
            self.directory.observe(h, int(v), self.vclock.now)
        return {
            "host": self.host,
            "version": self.worker.view_publisher.version,
            "matches_rated": self.worker.matches_rated,
            "batches_ok": self.worker.batches_ok,
            "dead_letters": self.worker.dead_letters,
        }

    def burn(self, count: int = 1) -> dict:
        """The injected-burn hook (fleet SLO attribution tests): dead
        letters appear on THIS host only, strictly between two of the
        parent Collector's scrapes."""
        get_registry().counter("worker.dead_letters_total").add(int(count))
        return {"host": self.host, "burned": int(count)}

    def finish(self) -> dict:
        """End-of-run accounting: flushes the audit backlog (when armed)
        and reports the per-host deterministic counters plus the
        steady-state retrace delta the fleet SLO gates on.
        ``retraces_steady`` keeps the artifact's shape and is always 0 in
        the port (nothing is jitted)."""
        if self.worker.auditor is not None:
            self.worker.auditor.drain()
        retraces = float(
            get_registry().counter("jax.retraces_total").value
        )
        return {
            "host": self.host,
            "version": self.worker.view_publisher.version,
            "matches_rated": self.worker.matches_rated,
            "batches_ok": self.worker.batches_ok,
            "dead_letters": self.worker.dead_letters,
            "retraces_steady": (
                retraces - self._retrace_base
                if self._retrace_base is not None else 0.0
            ),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.control.close()
        self.worker.close()
