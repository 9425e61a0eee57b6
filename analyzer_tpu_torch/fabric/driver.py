"""FabricSoakDriver: the multi-host closed-loop soak over a real
subprocess fabric.

The port's copy of ``analyzer_tpu.fabric.driver``, on ``device`` (None:
the card; every host subprocess runs there, and the driver raises without
one). The artifact keeps JAX's FABRIC shape (``config``,
``deterministic``, ``fleet``, ``slo``, ``capture``); its ``measured``
block adds each host's bring-up seconds (``bringup``).

The single-process :class:`~analyzer_tpu_torch.loadgen.driver.SoakDriver`
re-shaped around shard-owning worker PROCESSES:

  * the parent owns formation: one :class:`~analyzer_tpu_torch.fabric.
    matchmaker.ShardMatchmaker` per shard (per-shard seeded substreams,
    shard-pure matches) plus ONE outcome model and ONE driver stream,
    consumed in a fixed shard order — the (tick, shard) -> matches map
    is a pure function of (seed, config), independent of the host
    count;
  * each host is a :mod:`~analyzer_tpu_torch.fabric.process` subprocess: a
    ``PartitionedBroker`` consumed through its owned partitions, a
    sequential worker on a virtual clock the parent advances through
    ``/fabric/rate``, the ``/v1/*`` serve plane, and obsd for the
    fleet Collector;
  * each (tick, shard) group is posted to the owning host and DRAINED
    before the next group — the barrier that makes batch composition
    (and therefore every rating bit) topology-invariant;
  * the query workload runs through the :class:`~analyzer_tpu_torch.fabric.
    route.FabricRouter` (point lookups to owners, merged leaderboards/
    tiers), digesting version-stripped responses;
  * a fleet :class:`~analyzer_tpu_torch.obs.federate.Collector` scrapes every
    host's obsd each tick (on the VIRTUAL clock) and evaluates
    ``STANDARD_OBJECTIVES`` at fleet scope with per-host attribution.

Headline contract (docs/fabric.md, pinned by
tests/test_torch_fabric_fleet.py): the artifact's ``deterministic`` block
— match digest, query digest, final-table digest, counters — is
BIT-IDENTICAL per (seed, config) across ``n_hosts`` ∈ {1, 2, 4};
``n_hosts=1`` is the single-plane oracle topology.

Wall-clock reads below are subprocess liveness (a child that never writes
its ready file) or the measured block (latencies, wall throughput,
bring-up) — never decision inputs on the deterministic path, exactly the
loadgen discipline.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.fabric.directory import FabricDirectory
from analyzer_tpu_torch.fabric.matchmaker import ShardMatchmaker
from analyzer_tpu_torch.fabric.route import FabricRouter
from analyzer_tpu_torch.fabric.topology import FabricTopology, row_of_id
from analyzer_tpu_torch.loadgen.driver import LEADERBOARD_K, QUERY_RATINGS_IDS
from analyzer_tpu_torch.loadgen.matchmaker import HttpServeClient, player_id
from analyzer_tpu_torch.loadgen.outcomes import OutcomeModel
from analyzer_tpu_torch.loadgen.shaper import (
    DEFAULT_QUERY_MIX,
    TrafficShaper,
    VirtualClock,
    choose_kind,
)
from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs import get_registry
from analyzer_tpu_torch.obs.tracectx import (
    enable_tracing,
    headers as trace_headers,
    mint as trace_mint,
    tracing_enabled,
)

logger = get_logger(__name__)

#: Wall budget for a child to come up and write its ready file.
READY_TIMEOUT_S = 180.0


@dataclasses.dataclass(frozen=True)
class FabricSoakConfig:
    """One fabric soak's full parameterization. Defaults are a CPU
    smoke fabric — a few seconds, tier-1 safe. The deterministic block
    is bit-identical per (seed, config-minus-n_hosts): ``n_hosts`` is
    the topology knob the contract quantifies over."""

    seed: int = 0
    duration_s: float = 6.0
    tick_s: float = 1.0
    qps: float = 16.0
    query_qps: float = 8.0
    n_players: int = 240
    batch_size: int = 32
    n_shards: int = 4
    n_hosts: int = 2
    team5_frac: float = 0.3
    afk_rate: float = 0.0
    activity_concentration: float = 1.2
    warmup: bool = True
    trace: bool = False
    quality: bool = True
    slo_plane: bool = True
    scrape: bool = True  # fleet Collector over the hosts' obsd planes
    down_after_s: float = 10.0  # virtual seconds before a host is down
    max_view_lag_ticks: int = 2
    child_max_wall_s: float = 900.0

    @property
    def n_ticks(self) -> int:
        return max(1, int(round(self.duration_s / self.tick_s)))


def _post_json(url: str, obj, timeout_s: float = 300.0) -> dict:
    """One control-plane POST (JSON in, JSON out). Raises on non-200 —
    a failed control verb is a broken fabric, never a silent skip."""
    req = urllib.request.Request(
        url,
        data=json.dumps(obj).encode("utf-8"),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _get_json(url: str, timeout_s: float = 300.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


def spawn_fabric_hosts(
    base_spec: dict, tmpdir: str, exit_file: str
) -> list[dict]:
    """Spawns ``base_spec["n_hosts"]`` :mod:`~analyzer_tpu_torch.fabric.
    process` children with the ready/exit file handshake and blocks
    until every child published its bound urls. Shared by the soak
    driver and ``cli fabric``. Each returned host dict carries the
    child's ready info (``serve_url``/``control_url``/``obs_port``)
    plus ``proc``/``log``/``log_path`` for reaping.

    Raises ``RuntimeError`` (with the failed child's log tail) when a
    child dies or stalls during bring-up, after signalling ``exit_file``
    and reaping every child it started. Children start with ``python
    -m``, never by fork: a parent that touched CUDA cannot fork a child
    that uses it."""
    import analyzer_tpu_torch

    repo = os.path.dirname(
        os.path.dirname(os.path.abspath(analyzer_tpu_torch.__file__))
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    hosts: list[dict] = []
    for h in range(int(base_spec["n_hosts"])):
        ready = os.path.join(tmpdir, f"ready-{h}.json")
        spec = dict(
            base_spec, host=h, ready_file=ready, exit_file=exit_file
        )
        spec_path = os.path.join(tmpdir, f"spec-{h}.json")
        with open(spec_path, "w", encoding="utf-8") as f:
            json.dump(spec, f)
        log_path = os.path.join(tmpdir, f"host-{h}.log")
        log = open(log_path, "w", encoding="utf-8")  # noqa: SIM115 — lives with the child
        proc = subprocess.Popen(
            [sys.executable, "-m", "analyzer_tpu_torch.fabric.process",
             spec_path],
            env=env,
            stdout=log,
            stderr=subprocess.STDOUT,
        )
        hosts.append({
            "host": h, "proc": proc, "ready_file": ready,
            "log_path": log_path, "log": log,
        })
    deadline = time.monotonic() + READY_TIMEOUT_S  # graftlint: disable=GL048 — subprocess bring-up deadline, wall-shaped by nature
    for h in hosts:
        while not os.path.exists(h["ready_file"]):
            failed = None
            if h["proc"].poll() is not None:
                failed = f"exited rc={h['proc'].returncode} before ready"
            elif time.monotonic() > deadline:  # graftlint: disable=GL048 — subprocess bring-up deadline, wall-shaped by nature
                failed = f"not ready within {READY_TIMEOUT_S}s"
            if failed:
                reap_fabric_hosts(hosts, exit_file)
                with open(h["log_path"], encoding="utf-8") as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(
                    f"fabric host {h['host']} {failed}; its log:\n{tail}"
                )
            time.sleep(0.05)  # graftlint: disable=GL048 — bring-up poll interval, wall-shaped by nature
        with open(h["ready_file"], encoding="utf-8") as f:
            h.update(json.load(f))
    return hosts


def reap_fabric_hosts(hosts: list[dict], exit_file: str) -> None:
    """Signals every host down through ``exit_file``, waits for each
    (killing one that outlives 30 s) and closes its log."""
    try:
        with open(exit_file, "w", encoding="utf-8") as f:
            f.write("exit\n")
    except OSError:
        pass
    for h in hosts:
        try:
            h["proc"].wait(timeout=30)
        except subprocess.TimeoutExpired:
            h["proc"].kill()
            h["proc"].wait(timeout=10)
        h["log"].close()


class FabricSoakDriver:
    """Spawns the host topology, runs the soak, returns the artifact.

    ``device`` is where the hosts rate and serve (None: the card; it
    raises without one). ``close()`` signals the children to exit and
    reaps them (idempotent; ``run`` does not close, so a test can query
    the live fabric afterwards)."""

    def __init__(self, config: FabricSoakConfig | None = None,
                 device=None) -> None:
        from analyzer_tpu_torch.device import resolve_device
        from analyzer_tpu_torch.io.synthetic import synthetic_players

        self.cfg = cfg = config or FabricSoakConfig()
        self.device = resolve_device(device)
        self.topology = FabricTopology(cfg.n_shards, cfg.n_hosts)
        self._trace_prev: bool | None = None
        if cfg.trace and not tracing_enabled():
            self._trace_prev = False
            enable_tracing(True)
        self.vclock = VirtualClock()
        self.rating_config = RatingConfig()
        self.players = synthetic_players(cfg.n_players, seed=cfg.seed)
        self.outcomes = OutcomeModel(
            self.players, self.rating_config, seed=cfg.seed
        )
        # Streams: (2,) drives afk flags + query draws (the SoakDriver
        # convention), (4,) assigns each formed match's shard — all
        # consumed in fixed orders, so every draw sequence is
        # topology-invariant.
        self.qrng = np.random.default_rng(
            np.random.SeedSequence(entropy=cfg.seed, spawn_key=(2,))
        )
        self.frng = np.random.default_rng(
            np.random.SeedSequence(entropy=cfg.seed, spawn_key=(4,))
        )
        self._seq = 0
        self._match_digest = hashlib.sha256()
        self._query_digest = hashlib.sha256()
        self._closed = False
        self._tmp = tempfile.TemporaryDirectory(prefix="fabric-soak-")
        self._exit_file = os.path.join(self._tmp.name, "exit")
        self.hosts: list[dict] = []
        self._spawn_hosts()
        from analyzer_tpu_torch.obs.federate import Collector

        try:
            self.directory = FabricDirectory(
                self.topology, down_after_s=cfg.down_after_s
            )
            for h in self.hosts:
                self.directory.register(
                    h["host"], serve_url=h["serve_url"],
                    control_url=h["control_url"], now=self.vclock.now,
                )
            self.router = FabricRouter(
                self.directory, cfg=self.rating_config,
                clock=self.vclock.monotonic,
            )
            self.matchmakers = [
                ShardMatchmaker(
                    self.players,
                    HttpServeClient(
                        self.hosts[self.topology.host_of_shard(s)]["serve_url"]
                    ),
                    s,
                    cfg.n_shards,
                    seed=cfg.seed,
                    cfg=self.rating_config,
                    activity_concentration=cfg.activity_concentration,
                    team5_frac=cfg.team5_frac,
                )
                for s in range(cfg.n_shards)
            ]
            self.collector = None
            if cfg.scrape:
                self.collector = Collector(
                    targets=[f"127.0.0.1:{h['obs_port']}" for h in self.hosts],
                )
        except BaseException:
            self.close()  # a half-built driver still reaps its hosts
            raise

    # -- topology bring-up -------------------------------------------------
    def _spawn_hosts(self) -> None:
        cfg = self.cfg
        base_spec = {
            "n_shards": cfg.n_shards,
            "n_hosts": cfg.n_hosts,
            "seed": cfg.seed,
            "n_players": cfg.n_players,
            "batch_size": cfg.batch_size,
            "quality": cfg.quality,
            "slo_plane": cfg.slo_plane,
            "trace": cfg.trace,
            "max_wall_s": cfg.child_max_wall_s,
            "device": str(self.device),
        }
        self.hosts.extend(
            spawn_fabric_hosts(base_spec, self._tmp.name, self._exit_file)
        )
        self.bringup = {
            h["host"]: {"host": h["host"], **h["bringup"]} for h in self.hosts
        }

    # -- rig preparation ---------------------------------------------------
    def prepare(self) -> None:
        """Seeds every host with its OWNED slice of the version-1
        population (global-row order within each host — on the 1-host
        oracle the view's local rows ARE the global rows) and runs the
        per-host warm-up discipline. Each host's seed and warm-up wall
        seconds land in ``self.bringup``."""
        from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE, PlayerState

        cfg = self.cfg
        state = PlayerState.create(
            cfg.n_players,
            rank_points_ranked=self.players.rank_points_ranked,
            rank_points_blitz=self.players.rank_points_blitz,
            skill_tier=self.players.skill_tier,
            cfg=self.rating_config,
            device=self.device,
        )
        rows = state.table.cpu().numpy()[: cfg.n_players]
        for h in self.hosts:
            t0 = time.perf_counter()  # graftlint: disable=GL048 — measured bring-up seconds (measured.bringup), not a decision input
            owned = [
                r for r in range(cfg.n_players)
                if self.topology.host_of_row(r) == h["host"]
            ]
            resp = _post_json(
                h["control_url"] + "/fabric/seed",
                {
                    "ids": [player_id(r) for r in owned],
                    "rows": [[float(x) for x in rows[r]] for r in owned],
                },
            )
            self.directory.observe(
                h["host"], resp["version"], self.vclock.now
            )
            # graftlint: disable=GL048 — measured bring-up seconds (measured.bringup), not a decision input
            self.bringup[h["host"]]["seed_s"] = time.perf_counter() - t0
        if cfg.warmup:
            for h in self.hosts:
                t0 = time.perf_counter()  # graftlint: disable=GL048 — measured bring-up seconds (measured.bringup), not a decision input
                _post_json(
                    h["control_url"] + "/fabric/warmup",
                    {"cap_ids": cfg.batch_size * 2 * MAX_TEAM_SIZE},
                )
                # graftlint: disable=GL048 — measured bring-up seconds (measured.bringup), not a decision input
                self.bringup[h["host"]]["warm_s"] = time.perf_counter() - t0

    # -- formation ---------------------------------------------------------
    def _form_specs(self, shard: int, k: int) -> list[dict]:
        """``k`` shard-pure match specs for ``shard``: formation off the
        shard's own substream, outcomes + afk off the shared streams in
        this fixed call order, digest folded exactly like the
        single-process soak."""
        if k <= 0:
            return []
        specs = []
        for m in self.matchmakers[shard].form(k):
            winner, p_model = self.outcomes.resolve(
                m.team_a_rows, m.team_b_rows
            )
            afk = bool(self.qrng.random() < self.cfg.afk_rate)
            mid = f"fab-{self._seq:08d}"
            ctx = trace_mint(mid)
            headers = dict(trace_headers(ctx) or {})
            headers["x-partition"] = shard
            specs.append({
                "id": mid,
                "mode": m.mode,
                "a_rows": [int(r) for r in m.team_a_rows],
                "b_rows": [int(r) for r in m.team_b_rows],
                "winner": int(winner),
                "afk": afk,
                "created_at": self._seq,
                "headers": headers,
            })
            self._match_digest.update(
                json.dumps(
                    {
                        "id": mid,
                        "mode": m.mode,
                        "a": m.team_a_ids,
                        "b": m.team_b_ids,
                        "split": m.split,
                        "p_served": m.p_a,
                        "quality": m.quality,
                        "p_model": p_model,
                        "winner": winner,
                        "afk": afk,
                    },
                    sort_keys=True,
                ).encode()
            )
            self._seq += 1
        get_registry().counter("soak.matches_published_total").add(len(specs))
        return specs

    # -- query workload ----------------------------------------------------
    def _issue_queries(self, n: int, latencies_ms: list, counts: dict) -> None:
        """``n`` routed queries with the soak's deterministic kind mix.
        Payloads draw a shard first, then that shard's rows — every
        draw and therefore every response body (version-stripped) is
        topology-invariant."""
        cfg = self.cfg
        for _ in range(n):
            kind = choose_kind(self.qrng, DEFAULT_QUERY_MIX)
            shard = int(self.qrng.integers(cfg.n_shards))
            if kind == "ratings":
                rows = self.matchmakers[shard].sample_rows(
                    QUERY_RATINGS_IDS, rng=self.qrng
                )
                call = (
                    self.router.get_ratings,
                    ([player_id(r) for r in rows],),
                )
            elif kind == "winprob":
                rows = self.matchmakers[shard].sample_rows(6, rng=self.qrng)
                call = (
                    self.router.win_probability,
                    (
                        [player_id(r) for r in rows[:3]],
                        [player_id(r) for r in rows[3:]],
                    ),
                )
            elif kind == "leaderboard":
                call = (self.router.leaderboard, (LEADERBOARD_K,))
            else:
                call = (self.router.tier_histogram, ())
            t0 = time.perf_counter()  # graftlint: disable=GL048 — measured-block latency, not a decision input
            resp = call[0](*call[1])
            dt = time.perf_counter() - t0  # graftlint: disable=GL048 — measured-block latency, not a decision input
            latencies_ms.append(dt * 1e3)
            counts[kind] = counts.get(kind, 0) + 1
            self._query_digest.update(
                (
                    kind + "\n"
                    + json.dumps(
                        FabricRouter.strip_versions(resp), sort_keys=True
                    )
                ).encode()
            )
        get_registry().counter("soak.queries_sent_total").add(n)

    # -- the loop ----------------------------------------------------------
    def run(self) -> dict:
        cfg = self.cfg
        reg = get_registry()
        self.prepare()
        match_shaper = TrafficShaper(cfg.qps, cfg.tick_s)
        query_shaper = TrafficShaper(cfg.query_qps, cfg.tick_s)
        published = 0
        query_counts: dict[str, int] = {}
        latencies_ms: list[float] = []
        per_host_rated = {h["host"]: 0 for h in self.hosts}
        per_host_version = {h["host"]: 0 for h in self.hosts}
        staleness = {h["host"]: 0 for h in self.hosts}
        staleness_max = 0
        wall_t0 = time.perf_counter()  # graftlint: disable=GL048 — measured-block wall anchor, not a decision input
        for tick in range(cfg.n_ticks):
            self.vclock.advance(cfg.tick_s)
            due = match_shaper.due()
            # Shard assignment off its own stream, then a fixed-order
            # walk: (tick, shard) -> match specs is topology-invariant.
            drawn = (
                self.frng.integers(0, cfg.n_shards, size=due)
                if due else np.empty(0, np.int64)
            )
            per_shard = [int((drawn == s).sum()) for s in range(cfg.n_shards)]
            tick_load = {h["host"]: 0 for h in self.hosts}
            for shard in range(cfg.n_shards):
                owner = self.topology.host_of_shard(shard)
                specs = self._form_specs(shard, per_shard[shard])
                published += len(specs)
                tick_load[owner] += len(specs)
                # Always posted — the empty group is the heartbeat that
                # advances the child's virtual clock and refreshes the
                # directory's freshness bookkeeping.
                resp = _post_json(
                    self.hosts[owner]["control_url"] + "/fabric/rate",
                    {
                        "now": self.vclock.now,
                        "matches": specs,
                        "peer_versions": {
                            str(k): v
                            for k, v in self.directory.vector().items()
                        },
                    },
                )
                self.directory.observe(
                    owner, resp["version"], self.vclock.now
                )
                per_host_rated[owner] = resp["matches_rated"]
            for h in self.hosts:
                idx = h["host"]
                version = self.directory.entry(idx).version
                if version != per_host_version[idx] or tick_load[idx] == 0:
                    staleness[idx] = 0
                else:
                    staleness[idx] += 1
                per_host_version[idx] = version
                staleness_max = max(staleness_max, staleness[idx])
            self._issue_queries(
                query_shaper.due(), latencies_ms, query_counts
            )
            if self.collector is not None:
                self.collector.scrape(self.vclock.now)
            reg.counter("soak.ticks_total").add(1)
            reg.gauge("soak.virtual_seconds").set(self.vclock.now)
        wall_s = time.perf_counter() - wall_t0  # graftlint: disable=GL048 — measured-block wall clock, not a decision input

        finals = [
            _post_json(h["control_url"] + "/fabric/finish", {})
            for h in self.hosts
        ]
        rated = sum(f["matches_rated"] for f in finals)
        table_digest = self._table_digest()
        burning: list[str] = []
        attribution: dict = {}
        if self.collector is not None:
            self.collector.scrape(self.vclock.now)
            burning = list(self.collector.burning)
            attribution = self.collector.attribution()
        lat = np.asarray(latencies_ms, np.float64)
        pct = lambda q: (  # noqa: E731 — three-use one-liner
            round(float(np.percentile(lat, q)), 3) if lat.size else None
        )
        artifact = {
            "metric": "fabric.matches_per_sec_per_host",
            "value": (
                round(rated / wall_s / cfg.n_hosts, 2) if wall_s > 0 else 0.0
            ),
            "config": dataclasses.asdict(cfg),
            "deterministic": {
                "seed": cfg.seed,
                "ticks": cfg.n_ticks,
                "virtual_s": round(cfg.n_ticks * cfg.tick_s, 6),
                "matches_published": published,
                "matches_rated": rated,
                "matches_digest": self._match_digest.hexdigest(),
                "queries_digest": self._query_digest.hexdigest(),
                "table_digest": table_digest,
                "queries": dict(sorted(query_counts.items())),
                "batches_ok": sum(f["batches_ok"] for f in finals),
                "dead_letters": sum(f["dead_letters"] for f in finals),
                "view_staleness_ticks_max": staleness_max,
                "drained": True,  # the per-group barrier drains or 503s
            },
            "fleet": {
                "n_hosts": cfg.n_hosts,
                "n_shards": cfg.n_shards,
                # Per-kind routed-call counts: fan-out kinds scale with
                # the host count, so these live OUTSIDE deterministic.
                "route_calls": dict(sorted(self.router.calls.items())),
                "hosts": [
                    {
                        "host": f["host"],
                        "matches_rated": f["matches_rated"],
                        "batches_ok": f["batches_ok"],
                        "dead_letters": f["dead_letters"],
                        "retraces_steady": f["retraces_steady"],
                        "view_version_final": f["version"],
                    }
                    for f in finals
                ],
                "burning": burning,
                "attribution": attribution,
                "scrapes": (
                    self.collector.scrapes
                    if self.collector is not None else 0
                ),
            },
            "latency_ms": {"p50": pct(50), "p90": pct(90), "p99": pct(99)},
            "measured": {
                "wall_s": round(wall_s, 3),
                "queries_per_sec": (
                    round(len(latencies_ms) / wall_s, 2)
                    if wall_s > 0 else 0.0
                ),
                "remote_lookup_p99_ms": pct(99),
                "bringup": [self.bringup[h["host"]] for h in self.hosts],
            },
            "capture": {"degraded": False},
        }
        violations = self._violations(artifact, finals)
        artifact["slo"] = {
            "pass": not violations,
            "violations": violations,
            "thresholds": {
                "max_view_lag_ticks": cfg.max_view_lag_ticks,
            },
        }
        if violations:
            reg.counter("soak.slo_violations_total").add(len(violations))
            logger.warning(
                "fabric soak SLO violations: %s", "; ".join(violations)
            )
        logger.info(
            "fabric soak done: %d matches over %d ticks x %d hosts "
            "(%.1f wall s), slo=%s",
            rated, cfg.n_ticks, cfg.n_hosts, wall_s,
            "pass" if not violations else "FAIL",
        )
        return artifact

    def _violations(self, artifact: dict, finals: list[dict]) -> list[str]:
        cfg = self.cfg
        det = artifact["deterministic"]
        out = []
        if det["matches_rated"] < det["matches_published"]:
            out.append(
                f"lost work: {det['matches_published']} published, "
                f"{det['matches_rated']} rated"
            )
        if det["dead_letters"]:
            out.append(f"dead letters: {det['dead_letters']}")
        if det["view_staleness_ticks_max"] > cfg.max_view_lag_ticks:
            out.append(
                "view staleness "
                f"{det['view_staleness_ticks_max']} ticks exceeds "
                f"{cfg.max_view_lag_ticks}"
            )
        if cfg.warmup:
            for f in finals:
                if f["retraces_steady"] > 0:
                    out.append(
                        f"host {f['host']}: {f['retraces_steady']:.0f} "
                        "steady-state retraces (unwarmed shape reached "
                        "the fabric)"
                    )
        for name in artifact["fleet"]["burning"]:
            out.append(f"fleet objective burning: {name}")
        return out

    def _table_digest(self) -> str:
        """The final-table digest: every host's owned rows reassembled
        into GLOBAL row order, hashed as packed float32 — THE
        topology-invariance witness (same bits at any host count)."""
        table = None
        seen = 0
        for h in self.hosts:
            resp = _get_json(h["control_url"] + "/fabric/table")
            for pid, row in zip(resp["ids"], resp["rows"]):
                r = row_of_id(pid)
                if table is None:
                    table = np.full(
                        (self.cfg.n_players, len(row)), np.nan, np.float32
                    )
                table[r] = np.asarray(row, np.float32)
                seen += 1
        if table is None or seen != self.cfg.n_players:
            raise RuntimeError(
                f"final table incomplete: {seen} of "
                f"{self.cfg.n_players} rows published"
            )
        return hashlib.sha256(
            np.ascontiguousarray(table).tobytes()
        ).hexdigest()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        reap_fabric_hosts(self.hosts, self._exit_file)
        self._tmp.cleanup()
        if self._trace_prev is not None:
            enable_tracing(self._trace_prev)
