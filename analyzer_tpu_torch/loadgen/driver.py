"""SoakDriver: the closed-loop soak — matchmaker -> broker -> worker ->
commit -> view publish -> query traffic — under one virtual clock.

One tick of virtual time runs the whole production loop once:

  1. the **matchmaker** forms this tick's matches FROM THE SERVED
     RATINGS (queue by served conservative rating, winprob-balanced
     splits — ``matchmaker.py``), the **outcome model** resolves winners
     from latent truth, and the finished matches land in the store and
     on the ``analyze`` queue;
  2. the **worker** consumes (bounded polls per tick, so overload shows
     up as queue depth instead of silently stretching the tick), rates,
     commits, and publishes a new view version at each commit boundary;
  3. the **query workload** hits ``/v1/*`` (HTTP or in-process) with a
     deterministic kind mix, so the read plane serves while the write
     plane ingests;
  4. **SLO samples**: queue depth, view-version staleness, dead
     letters, retraces past warmup — all deterministic; wall-clock
     latencies and throughput land in the artifact's *measured* block.

Determinism contract (pinned by ``tests/test_torch_loadgen.py``): the
artifact's ``deterministic`` block — matches formed, outcomes, query
digests, SLO counters, per-tick trajectory — is BIT-IDENTICAL for the
same (seed, config), across ``broker_partitions``, ``serve_shards`` and
``migrate``, because every decision reads a seeded RNG stream or the
virtual clock.

The emitted ``SOAK_r*.json`` artifact carries the JAX package's shape; its
SLOs (zero dead letters, flat steady-state retraces, bounded view
staleness, drained backlog) are judged from the deterministic block by
``obs.slo.soak_violations``.

The port's copy of ``analyzer_tpu.loadgen.driver``, on ``device`` (None:
the card). Where it differs:

  * nothing in the port is jitted, so ``jax.retraces_total`` stays 0 and
    the flat-steady-retraces objective passes trivially; it is kept, so
    the artifact and its judge keep the JAX shape;
  * the ``migrate`` backfill runs the fused window (:data:`MIGRATE_KERNEL`)
    where JAX's runs its reference scan: on the card the port's reference
    path dispatches ~100 small kernels a superstep from the host, and the
    seeded history is chain-bound (its hottest players sit in most
    matches: ~66,000 supersteps for 100,000 matches over a million
    players), so the reference path would take minutes. The two kernels'
    tables are bit-identical (tests/test_torch_migrate.py);
  * the matchmaker ranks players by the ratings the port serves, which
    may differ from the JAX package's in the last float32 bit, so the
    block can differ from JAX's for the same seed by a pairing flip;
    its parts are held to JAX's separately (tests/test_torch_loadgen.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time

import numpy as np

from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
from analyzer_tpu_torch.loadgen.matchmaker import (
    EngineServeClient,
    HttpServeClient,
    Matchmaker,
    player_id,
)
from analyzer_tpu_torch.loadgen.outcomes import OutcomeModel
from analyzer_tpu_torch.loadgen.shaper import (
    DEFAULT_QUERY_MIX,
    TrafficShaper,
    VirtualClock,
    choose_kind,
)
from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs import get_registry
# THE shared SLO owner (obs/slo.py): the driver's verdict and the live
# watchdog walk the same declarative objective table.
from analyzer_tpu_torch.obs.slo import soak_violations
from analyzer_tpu_torch.obs.tracectx import (
    enable_tracing,
    headers as trace_headers,
    mint as trace_mint,
    tracing_enabled,
)

logger = get_logger(__name__)

#: Fixed leaderboard depth for the query workload.
LEADERBOARD_K = 10

#: The migration backfill's kernel (see the module docstring).
MIGRATE_KERNEL = "fused"

#: Ids in one ratings point-lookup of the query workload — fixed so the
#: serve gather bucket is one shape (the matchmaker's pages are separate,
#: matchmaker.RATINGS_PAGE).
QUERY_RATINGS_IDS = 8


@dataclasses.dataclass(frozen=True)
class SoakConfig:
    """One soak's full parameterization. ``duration_s`` is VIRTUAL time
    (ticks = duration_s / tick_s); wall time only matters in realtime
    mode. Defaults are a CPU smoke soak — seconds, tier-1 safe."""

    seed: int = 0
    duration_s: float = 8.0
    tick_s: float = 1.0
    qps: float = 24.0  # matches formed per virtual second
    query_qps: float = 10.0  # serve queries per virtual second
    n_players: int = 400
    batch_size: int = 64
    polls_per_tick: int = 4
    team5_frac: float = 0.3
    afk_rate: float = 0.0
    activity_concentration: float = 1.2
    warmup: bool = True  # precompile worker + serve + publish ladders
    use_http: bool = True  # query workload over /v1/* vs in-process
    # Route the HTTP query workload through the serve FRONT DOOR
    # (serve/frontdoor.py — the concurrent socket plane + native codec)
    # instead of the worker's RoutedHTTPServer plane. Same engine, same
    # response bytes (the codec is differential-pinned), so the
    # deterministic block is BIT-IDENTICAL to both the RoutedHTTPServer
    # run and the in-process run per (seed, config) — pinned by
    # tests/test_torch_frontdoor.py. Implies use_http.
    serve_http: bool = False
    # > 1 serves through the sharded plane (ShardedViewPublisher +
    # ShardedQueryEngine, docs/serving.md "Sharded plane"). The
    # deterministic block is BIT-IDENTICAL across serve_shards values
    # for the same (seed, config-otherwise) — the sharded engine's
    # contract, pinned by tests/test_torch_loadgen.py.
    serve_shards: int = 1
    realtime: bool = False  # pace ticks against the wall clock
    # Causal tracing (obs/tracectx.py): every published match carries a
    # TraceContext through the broker, the worker's batches tag their
    # spans, and the artifact gains a `trace` block with the stage
    # decomposition + dominant stage. The DETERMINISTIC block is
    # bit-identical with tracing on or off (ids are recorded, never
    # branched on).
    trace: bool = False
    # > 1 runs the ingest edge through the PartitionedBroker: the
    # analyze queue splits into partitions by player-shard (row % S —
    # the serve plane's mesh layout invariant; the driver stamps
    # x-partition from each match's first team-A row), with
    # per-partition depth/dead-letter accounting. The deterministic
    # block is BIT-IDENTICAL to the single-queue run per (seed, config)
    # — the broker's seq-merged delivery contract.
    broker_partitions: int = 1
    # Priority lanes (live vs backfill) on the partitioned broker, with
    # the AdmissionController arbitrating backfill behind live traffic.
    # Lanes alone are also deterministic-block-invariant (live-only
    # traffic is never reordered).
    priority_lanes: bool = False
    # Backfill/replay traffic (requires priority_lanes): re-publishes
    # already-rated match ids on the backfill lane at this rate — the
    # zero-downtime re-rate workload's ingest shape.
    # Re-rating is idempotent per match; backfill rides OUTSIDE
    # matches_published so the drain SLO still means "live work done".
    backfill_qps: float = 0.0
    max_view_lag_ticks: int = 2  # SLO: served view staleness bound
    min_matches_per_sec: float | None = None  # SLO: absolute wall floor
    max_p99_ms: float | None = None  # SLO: absolute serve-latency bound
    # SLO: stages that must NOT dominate the critical path (benchdiff's
    # queue_wait check, wired to the trace block — requires trace=True).
    forbid_dominant_stages: tuple = ()
    # The live SLO plane (obs/history.py + obs/slo.py): history sampler
    # + watchdog riding the worker's poll loop on the VIRTUAL clock.
    # The deterministic block is BIT-IDENTICAL with the plane on or off
    # per (seed, config) — nothing in it branches into the rating path.
    # Off = the AB knob.
    slo_plane: bool = True
    # Continuous shadow audit (obs/audit.py): a seeded-hash sample of
    # the soak's served queries replays through the bit-exact oracle
    # off the hot path; the artifact gains an `audit` block (outside
    # the deterministic block) and audit mismatches gate the soak
    # verdict zero-tolerance. Also deterministic-block-invariant.
    audit: bool = False
    audit_sample_denom: int = 4
    # Zero-downtime migration under live load (the `cli soak --migrate`
    # judge): a seeded synthetic history streams through the backfill
    # engine (analyzer_tpu_torch/migrate) into a STAGING
    # view lineage while the soak's live plane keeps serving —
    # admission-arbitrated against the live backlog — and traffic cuts
    # over atomically AFTER the measured window. The deterministic
    # block is BIT-IDENTICAL with the migration on or off per (seed,
    # config): the backfill publishes only into the staging lineage,
    # and the cutover happens after every deterministic value is
    # captured (pinned by tests/test_torch_loadgen.py).
    migrate: bool = False
    migrate_matches: int = 400
    # obsd on the soak's worker (None = no listener): lets a fleet
    # Collector (obs/federate.py) scrape the run — the deterministic
    # block is BIT-IDENTICAL with a scraper attached or absent (the
    # scrape path is read-only).
    obs_port: int | None = None
    # Rating-quality plane (obs/quality.py): the calibration ledger
    # scores every committed batch's PRE-update win probability against
    # the realized outcome; the artifact gains a `quality` block and
    # the calibration artifact check (obs/slo.py) gates the verdict
    # once the volume floor is met. Observer-only: the deterministic
    # block is BIT-IDENTICAL with the plane on or off (the AB knob,
    # `cli soak --no-quality`).
    quality: bool = True

    @property
    def n_ticks(self) -> int:
        return max(1, int(round(self.duration_s / self.tick_s)))


class SoakDriver:
    """Owns the rig (broker, store, worker + serve plane) and the loop.

    ``run()`` executes the configured soak and returns the artifact
    dict; ``close()`` tears the rig down (idempotent; ``run`` does NOT
    close, so a test can inspect the live worker afterwards). ``device``
    is where the worker rates, the views live and the migration runs
    (None: the card; it raises without one).
    """

    def __init__(self, config: SoakConfig | None = None, device=None) -> None:
        from analyzer_tpu_torch.device import resolve_device
        from analyzer_tpu_torch.io.synthetic import synthetic_players
        from analyzer_tpu_torch.service.broker import InMemoryBroker
        from analyzer_tpu_torch.service.store import InMemoryStore
        from analyzer_tpu_torch.service.worker import Worker

        self.cfg = config or SoakConfig()
        cfg = self.cfg
        self.device = resolve_device(device)
        # Causal tracing is a process-wide flag; remember the prior state
        # so close() restores it (a traced soak inside a test session
        # must not leak tracing into the next test).
        self._trace_prev: bool | None = None
        if cfg.trace and not tracing_enabled():
            self._trace_prev = False
            enable_tracing(True)
        self.vclock = VirtualClock()
        if cfg.broker_partitions > 1 or cfg.priority_lanes:
            from analyzer_tpu_torch.service.broker import PartitionedBroker

            self.broker = PartitionedBroker(
                partitions=cfg.broker_partitions, lanes=cfg.priority_lanes,
            )
        else:
            self.broker = InMemoryBroker()
        if cfg.backfill_qps > 0 and not cfg.priority_lanes:
            raise ValueError(
                "backfill_qps needs priority_lanes=True — backfill "
                "traffic without a lane would contend with live matches "
                "head-on, which is exactly what lanes exist to prevent"
            )
        self.store = InMemoryStore()
        self.rating_config = RatingConfig()
        service_cfg = ServiceConfig(
            batch_size=cfg.batch_size, idle_timeout=0.0, pipeline=False,
        )
        # Sequential worker on the virtual clock: the pipelined engine's
        # writer thread would put commit ORDER on wall-time scheduling,
        # which the bit-identical contract cannot absorb.
        self.worker = Worker(
            self.broker, self.store, service_cfg, self.rating_config,
            clock=self.vclock.monotonic, pipeline=False, serve_port=0,
            serve_shards=cfg.serve_shards, obs_port=cfg.obs_port,
            slo_plane=cfg.slo_plane, audit=cfg.audit,
            audit_seed=cfg.seed, audit_sample_denom=cfg.audit_sample_denom,
            quality=cfg.quality, device=self.device,
        )
        self.players = synthetic_players(cfg.n_players, seed=cfg.seed)
        self.outcomes = OutcomeModel(
            self.players, self.rating_config, seed=cfg.seed
        )
        self.frontdoor = None
        if cfg.serve_http:
            from analyzer_tpu_torch.serve.frontdoor import FrontDoor

            self.frontdoor = FrontDoor(self.worker.query_engine)
            self.client = HttpServeClient(self.frontdoor.url)
        elif cfg.use_http:
            self.client = HttpServeClient(self.worker.serve_server.url)
        else:
            self.client = EngineServeClient(self.worker.query_engine)
        self.matchmaker = Matchmaker(
            self.players, self.client, seed=cfg.seed,
            cfg=self.rating_config,
            activity_concentration=cfg.activity_concentration,
            team5_frac=cfg.team5_frac,
        )
        # Driver-level draws (afk flags, query kinds/payloads): a third
        # stream so query traffic never perturbs formation or outcomes.
        self.qrng = np.random.default_rng(
            np.random.SeedSequence(entropy=cfg.seed, spawn_key=(2,))
        )
        self._seq = 0
        self._backfill_cursor = 0
        self._backfill_published = 0
        self._player_cache: dict[int, object] = {}
        self._match_digest = hashlib.sha256()
        self._query_digest = hashlib.sha256()
        self._closed = False
        # Migration rig (cfg.migrate): filled by _prepare_migration.
        self._mig_data: bytes | None = None
        self._mig_state0 = None
        self._mig_reference = None  # the from-scratch re-rate's table
        self._mig_result: dict = {}
        self._mig_thread = None
        self._mig_lineage = None

    # -- rig preparation ---------------------------------------------------
    def prepare(self) -> None:
        """Primes the served view with the seeded population and (when
        ``cfg.warmup``) warms every path the soak can hit — the production
        discipline (`Worker.warmup`, `QueryEngine.warmup`): nothing
        compiles in the port, but the first touch of the device, its
        allocator pools and the publisher's patch buckets is paid here,
        before the measured window."""
        cfg = self.cfg
        state = self._migration_state()
        ids = [player_id(i) for i in range(cfg.n_players)]
        rows = state.table.cpu().numpy()[: cfg.n_players]
        # Version 1: every player known-but-unrated, seeds served — the
        # production bootstrap from the player table. Matchmaking reads
        # these seed estimates until real posteriors land.
        self.worker.view_publisher.publish_rows(ids, rows)
        if cfg.warmup:
            self.worker.warmup()
            self.worker.query_engine.warmup()
            self._warm_publish_buckets(ids, rows)
        if cfg.migrate:
            # Build the migration history AND run the backfill engine
            # once to completion on a throwaway staging lineage: the
            # warmup of every path the concurrent run will take (the
            # native packer and scanner builds included) and the
            # from-scratch reference table the acceptance check pins the
            # migrated lineage against bit for bit.
            self._prepare_migration()
        self._retrace_base = float(
            get_registry().counter("jax.retraces_total").value
        )

    def _warm_publish_buckets(self, ids, rows) -> None:
        """Warms the view publisher's patch path for every id-count bucket
        a commit can carry (the publisher's own ``warm_patch_buckets`` —
        re-publishing seed pages with idempotent content; versions
        advance, values do not). The ladder LENGTH is a pure function of
        the cap and the published population — identical across plane
        topologies, so the soak's version sequence (and therefore its
        deterministic block) does not depend on ``serve_shards``."""
        from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE

        self.worker.view_publisher.warm_patch_buckets(
            self.cfg.batch_size * 2 * MAX_TEAM_SIZE
        )

    # -- match materialization --------------------------------------------
    def _player_obj(self, row: int):
        """The SHARED duck-typed player object for ``row`` — one object
        per player for the whole soak, so the worker's write-back
        updates the priors the next batch loads (the store half of the
        closed loop)."""
        obj = self._player_cache.get(row)
        if obj is None:
            from analyzer_tpu_torch.fixtures import fake_player

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

    def _build_match(self, formed, winner: int, afk: bool):
        from analyzer_tpu_torch.fixtures import (
            fake_match,
            fake_participant,
            fake_roster,
        )

        rosters = []
        for t, rows in enumerate((formed.team_a_rows, formed.team_b_rows)):
            parts = [
                fake_participant(
                    player=self._player_obj(r),
                    skill_tier=int(self.players.skill_tier[r]),
                    went_afk=bool(afk and t == 0 and s == 0),
                )
                for s, r in enumerate(rows)
            ]
            rosters.append(
                fake_roster(winner=int(t == winner), participants=parts)
            )
        match = fake_match(formed.mode, rosters, api_id=f"soak-{self._seq:08d}")
        match.created_at = self._seq
        self._seq += 1
        return match

    def _publish_matches(self, n: int) -> int:
        """Forms, resolves, stores and enqueues ``n`` matches; folds
        each into the match digest. Returns the count published."""
        formed = self.matchmaker.form(n)
        reg = get_registry()
        for m in formed:
            winner, p_model = self.outcomes.resolve(
                m.team_a_rows, m.team_b_rows
            )
            afk = bool(self.qrng.random() < self.cfg.afk_rate)
            match = self._build_match(m, winner, afk)
            self.store.add_match(match)
            # The causal chain's first link: the TraceContext is minted
            # the moment the match enters the broker and rides the
            # message headers (None/no headers when tracing is off —
            # the digests below never see it either way).
            ctx = trace_mint(match.api_id)
            headers = dict(trace_headers(ctx) or {})
            if self.cfg.broker_partitions > 1:
                # Home-shard routing: the first team-A row's shard under
                # the mesh layout invariant (row % S — the same function
                # the serve plane routes lookups by). Header-routed so
                # the broker never has to parse match payloads.
                headers["x-partition"] = (
                    int(m.team_a_rows[0]) % self.cfg.broker_partitions
                )
            self.broker.publish(
                self.worker.config.queue, match.api_id.encode(),
                headers=headers or None,
            )
            self._match_digest.update(
                json.dumps(
                    {
                        "id": match.api_id,
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
        reg.counter("soak.matches_published_total").add(len(formed))
        return len(formed)

    def _publish_backfill(self, n: int) -> int:
        """Re-publishes ``n`` already-stored match ids on the backfill
        lane (cycling oldest-first) — the replay/re-rate ingest shape.
        Deterministic: a pure cursor walk over the match sequence, no
        draws. No-op until live matches exist."""
        if self._seq == 0:
            return 0
        sent = 0
        for _ in range(n):
            mid = f"soak-{self._backfill_cursor % self._seq:08d}"
            self._backfill_cursor += 1
            self.broker.publish(
                self.worker.config.queue, mid.encode(),
                headers={"x-lane": "backfill"},
            )
            sent += 1
        self._backfill_published += sent
        return sent

    # -- zero-downtime migration under load (cfg.migrate) ------------------
    def _migration_state(self):
        """A fresh pre-migration player table — the seeded population
        prepare() publishes, and what a from-scratch season re-rate starts
        from."""
        from analyzer_tpu_torch.core.state import PlayerState

        return PlayerState.create(
            self.cfg.n_players,
            rank_points_ranked=self.players.rank_points_ranked,
            rank_points_blitz=self.players.rank_points_blitz,
            skill_tier=self.players.skill_tier,
            cfg=self.rating_config, device=self.device,
        )

    def _prepare_migration(self) -> None:
        """Synthesizes the seeded migration history, then runs the
        backfill engine once (throwaway staging lineage) — the warmup AND
        the bit-identity reference table."""
        import os
        import tempfile

        from analyzer_tpu_torch.io.csv_codec import save_stream_csv
        from analyzer_tpu_torch.io.synthetic import synthetic_stream
        from analyzer_tpu_torch.migrate import rate_backfill
        from analyzer_tpu_torch.serve import ViewPublisher

        cfg = self.cfg
        stream = synthetic_stream(
            cfg.migrate_matches, self.players, seed=cfg.seed + 7,
        )
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "migration.csv")
            save_stream_csv(path, stream)
            with open(path, "rb") as f:
                self._mig_data = f.read()
        self._mig_state0 = self._migration_state()
        warm_staging = ViewPublisher(device=self.device)
        ref, _ = rate_backfill(
            self._mig_state0, self._mig_data, self.rating_config,
            staging=warm_staging, kernel=MIGRATE_KERNEL,
        )
        self._mig_reference = ref.table.cpu().numpy()

    def _run_migration(self) -> None:
        """The concurrent backfill (its own thread, WALL time — it lives
        entirely outside the deterministic block): streams the history
        into the staging lineage under the admission controller, gated
        on the soak's live backlog."""
        from analyzer_tpu_torch.migrate import LineageManager, rate_backfill
        from analyzer_tpu_torch.service.broker import AdmissionController

        queue = self.worker.config.queue

        def live_backlog() -> int:
            return self.broker.qsize(queue) + len(self.worker.queue)

        self._mig_lineage = LineageManager(self.worker.view_publisher)
        staging = self._mig_lineage.begin()
        stats: dict = {}
        t0 = time.perf_counter()  # graftlint: disable=GL028 — measured-block wall anchor, not a decision input
        try:
            final, _ = rate_backfill(
                self._migration_state(), self._mig_data,
                self.rating_config,
                staging=staging,
                ids=[player_id(i) for i in range(self.cfg.n_players)],
                admission=AdmissionController(),
                live_backlog=live_backlog,
                stats_out=stats, kernel=MIGRATE_KERNEL,
            )
        except BaseException as e:  # noqa: BLE001 — surfaced in the artifact
            self._mig_result.update(error=repr(e), stats=stats)
            self._mig_lineage.abort()
            return
        wall = time.perf_counter() - t0  # graftlint: disable=GL028 — measured-block wall clock, not a decision input
        self._mig_result.update(
            table=final.table.cpu().numpy(), stats=stats, wall_s=wall,
        )

    def _finish_migration(self) -> dict:
        """Joins the backfill, verifies the migrated lineage bit-for-bit
        against the from-scratch reference, and performs the atomic
        cutover. Called strictly AFTER the artifact's deterministic
        block is built — nothing here can perturb it. Returns the
        artifact's ``migration`` block (wall-derived, like `measured`)."""
        if self._mig_thread is not None:
            self._mig_thread.join(timeout=600)
        res = self._mig_result
        block: dict = {
            "ran": True,
            "matches": self.cfg.migrate_matches,
            "error": res.get("error"),
        }
        if "error" in res or "table" not in res:
            block["finished"] = False
            return block
        stats = res["stats"]
        pre_version = self.worker.view_publisher.version
        pre_cutover_view = self.worker.view_publisher.current()
        bit_identical = bool(
            np.array_equal(res["table"], self._mig_reference, equal_nan=True)
        )
        view = self._mig_lineage.cutover()
        served = view.host_table()
        cutover_identical = bool(
            np.array_equal(
                served[: view.n_players],
                res["table"][: view.n_players],
                equal_nan=True,
            )
        )
        wall = res["wall_s"]
        block.update(
            finished=True,
            streamed=bool(stats.get("streamed")),
            bit_identical=bit_identical,
            cutover_serves_migrated_table=cutover_identical,
            backfill_wall_s=round(wall, 3),
            backfill_matches_per_sec=(
                round(stats.get("matches", 0) / wall, 1) if wall > 0 else None
            ),
            ttfd_s=(
                round(stats["ttfd_s"], 4)
                if stats.get("ttfd_s") is not None else None
            ),
            supersteps=stats.get("n_steps"),
            occupancy=round(stats.get("occupancy", 0.0), 3),
            admission_halvings=stats.get("admission_halvings"),
            cutover_pause_ms=round(
                (self._mig_lineage.cutover_pause_s or 0.0) * 1e3, 3
            ),
            lineage_versions={
                "pre_cutover_live": pre_version,
                "post_cutover_live": view.version,
            },
        )
        if self.cfg.quality:
            try:
                block["quality"] = self._migration_quality(
                    res["table"], pre_cutover_view
                )
            except Exception as e:  # noqa: BLE001 — advisory evidence only
                block["quality"] = {"error": repr(e)}
        return block

    def _migration_quality(self, migrated_table, live_view) -> dict | None:
        """The staging-vs-live replay judge (obs/quality.py
        :func:`score_table`): both lineages score the IDENTICAL
        migration window with the identical serve-plane link — did the
        backfill produce a better-fitting table than the live lineage
        it replaces? Advisory evidence (never gates the verdict: the
        live lineage never saw this window, so a fit gap is expected —
        the signal is a *migrated* table that fits WORSE)."""
        import io as _io

        from analyzer_tpu_torch.io.csv_codec import load_stream_csv
        from analyzer_tpu_torch.obs.quality import score_table

        if live_view is None:
            return None
        stream = load_stream_csv(_io.StringIO(self._mig_data.decode()))
        keys = ("matches_scored", "brier", "logloss", "ece")
        migrated = score_table(migrated_table, stream, self.rating_config)
        live = score_table(
            np.asarray(live_view.host_table()), stream, self.rating_config
        )
        return {
            "replay_matches": self.cfg.migrate_matches,
            "migrated": {k: migrated[k] for k in keys},
            "live_pre_cutover": {k: live[k] for k in keys},
        }

    # -- query workload ----------------------------------------------------
    def _issue_queries(self, n: int, latencies_ms: list,
                       counts: dict) -> None:
        """``n`` serve queries with the deterministic kind mix. Payload
        draws come off the driver stream; latency is the one legitimate
        wall read (measured block, never a decision input)."""
        client = self.client
        for _ in range(n):
            kind = choose_kind(self.qrng, DEFAULT_QUERY_MIX)
            if kind == "ratings":
                rows = self.matchmaker.sample_rows(
                    QUERY_RATINGS_IDS, rng=self.qrng
                )
                call = (client.get_ratings, ([player_id(r) for r in rows],))
            elif kind == "winprob":
                rows = self.matchmaker.sample_rows(6, rng=self.qrng)
                call = (
                    client.win_probability,
                    (
                        [player_id(r) for r in rows[:3]],
                        [player_id(r) for r in rows[3:]],
                    ),
                )
            elif kind == "leaderboard":
                call = (client.leaderboard, (LEADERBOARD_K,))
            else:
                call = (client.tiers, ())
            t0 = time.perf_counter()  # graftlint: disable=GL028 — measured-block latency, not a decision input
            resp = call[0](*call[1])
            dt = time.perf_counter() - t0  # graftlint: disable=GL028 — measured-block latency, not a decision input
            latencies_ms.append(dt * 1e3)
            counts[kind] = counts.get(kind, 0) + 1
            self._query_digest.update(
                (kind + "\n" + json.dumps(resp, sort_keys=True)).encode()
            )
        get_registry().counter("soak.queries_sent_total").add(n)

    # -- the loop ----------------------------------------------------------
    def run(self) -> dict:
        """Executes the soak and returns the SOAK artifact dict."""
        cfg = self.cfg
        reg = get_registry()
        reg.gauge("soak.qps_target").set(cfg.qps)
        self.prepare()
        if cfg.migrate:
            # The backfill runs CONCURRENTLY with the whole soak on its
            # own (wall-clock) thread, publishing only into the staging
            # lineage — live serving, the digests, and every counter in
            # the deterministic block are untouched until the cutover,
            # which happens after that block is captured.
            import threading

            self._mig_thread = threading.Thread(
                target=self._run_migration, name="soak-migrate", daemon=True
            )
            self._mig_thread.start()
        match_shaper = TrafficShaper(cfg.qps, cfg.tick_s)
        query_shaper = TrafficShaper(cfg.query_qps, cfg.tick_s)
        backfill_shaper = (
            TrafficShaper(cfg.backfill_qps, cfg.tick_s)
            if cfg.backfill_qps > 0 else None
        )
        published = 0
        query_counts: dict[str, int] = {}
        latencies_ms: list[float] = []
        trajectory: list[list] = []
        depth_max = 0
        lag_ticks = 0
        lag_ticks_max = 0
        last_version = self.worker.view_publisher.version
        wall_t0 = time.perf_counter()  # graftlint: disable=GL028 — measured-block wall anchor, not a decision input
        queue = self.worker.config.queue

        def sample(tick: int) -> int:
            nonlocal depth_max, lag_ticks, lag_ticks_max, last_version
            depth = self.broker.qsize(queue) + len(self.worker.queue)
            depth_max = max(depth_max, depth)
            version = self.worker.view_publisher.version
            rated = self.worker.matches_rated
            # Staleness in ticks: a tick with work still pending and no
            # new published version ages the view; a publish (or a fully
            # drained loop) resets it. Deterministic — purely counters.
            # (>=: backfill re-rates push rated past published — a fully
            # drained loop is still "fresh"; == and >= agree otherwise.)
            if version != last_version or (depth == 0 and rated >= published):
                lag_ticks = 0
            else:
                lag_ticks += 1
            lag_ticks_max = max(lag_ticks_max, lag_ticks)
            last_version = version
            trajectory.append([tick, depth, version, rated])
            return depth

        for tick in range(cfg.n_ticks):
            self.vclock.advance(cfg.tick_s)
            # Arrivals are PACED across the tick's poll slots instead of
            # burst-published at the tick edge: a tick is the virtual
            # clock's granularity, not a claim that a second's worth of
            # matches lands in one instant — and a burst would charge
            # the whole backlog's wall time to `queue_wait`, swamping
            # the stage decomposition with a driver artifact. Slot
            # sizing is a pure function of (due, polls_per_tick):
            # deterministic, leftovers land on the earliest slots.
            due = match_shaper.due()
            backfill_due = (
                backfill_shaper.due() if backfill_shaper is not None else 0
            )
            polls = max(1, cfg.polls_per_tick)
            for p in range(polls):
                share = due // polls + (1 if p < due % polls else 0)
                if share:
                    published += self._publish_matches(share)
                bf_share = backfill_due // polls + (
                    1 if p < backfill_due % polls else 0
                )
                if bf_share:
                    self._publish_backfill(bf_share)
                self.worker.poll()
            self._issue_queries(query_shaper.due(), latencies_ms, query_counts)
            sample(tick)
            reg.counter("soak.ticks_total").add(1)
            reg.gauge("soak.virtual_seconds").set(self.vclock.now)
            if cfg.realtime:
                target = wall_t0 + (tick + 1) * cfg.tick_s
                delay = target - time.perf_counter()  # graftlint: disable=GL028 — realtime pacing reads the wall by definition
                if delay > 0:
                    time.sleep(delay)  # graftlint: disable=GL028 — realtime pacing sleep, virtual schedule already fixed

        # Drain: the backlog must clear in bounded virtual time — an
        # undrainable soak is itself an SLO violation, not a hang.
        drained = False
        for extra in range(cfg.n_ticks + 100):
            if (
                self.broker.qsize(queue) == 0
                and not self.worker.queue
                and self.worker.matches_rated >= published
            ):
                drained = True
                break
            self.vclock.advance(cfg.tick_s)
            for _ in range(cfg.polls_per_tick):
                self.worker.poll()
            sample(cfg.n_ticks + extra)
        # Flush the shadow-audit backlog: every sampled query must be
        # oracle-replayed before the artifact reads the mismatch count
        # (worker.drain also covers this on the production exit path).
        if self.worker.auditor is not None:
            self.worker.auditor.drain()
        wall_s = time.perf_counter() - wall_t0  # graftlint: disable=GL028 — measured-block wall clock, not a decision input

        retraces_steady = (
            float(reg.counter("jax.retraces_total").value)
            - self._retrace_base
        )
        # Causal-trace decomposition (obs/traceview.py): the same
        # per-stage breakdown `cli trace` renders, aggregated over the
        # soak's batches, so an SLO violation names the dominant stage.
        # Wall-time derived — it lives OUTSIDE the deterministic block.
        trace_block = None
        if tracing_enabled():
            from analyzer_tpu_torch.obs import get_tracer
            from analyzer_tpu_torch.obs.traceview import build_model, critical_path

            trace_block = critical_path(build_model(get_tracer().events()))
        lat = np.asarray(latencies_ms, np.float64)
        latency_ms = {
            "p50": round(float(np.percentile(lat, 50)), 3) if lat.size else None,
            "p90": round(float(np.percentile(lat, 90)), 3) if lat.size else None,
            "p99": round(float(np.percentile(lat, 99)), 3) if lat.size else None,
        }
        rated = self.worker.matches_rated
        artifact = {
            "metric": "soak.matches_per_sec",
            "value": round(rated / wall_s, 2) if wall_s > 0 else 0.0,
            "config": dataclasses.asdict(self.cfg),
            "deterministic": {
                "seed": self.cfg.seed,
                "ticks": cfg.n_ticks,
                "virtual_s": round(cfg.n_ticks * cfg.tick_s, 6),
                "matches_published": published,
                "matches_rated": rated,
                "matches_digest": self._match_digest.hexdigest(),
                "queries_digest": self._query_digest.hexdigest(),
                "queries": dict(sorted(query_counts.items())),
                "serve_calls": dict(sorted(self.client.calls.items())),
                "batches_ok": self.worker.batches_ok,
                "dead_letters": self.worker.dead_letters,
                "view_version_final": self.worker.view_publisher.version,
                "view_lag_ticks_max": lag_ticks_max,
                "queue_depth_max": depth_max,
                "queue_depth_final": (
                    self.broker.qsize(queue) + len(self.worker.queue)
                ),
                "retraces_steady": retraces_steady,
                "drained": drained,
                "backfill_published": self._backfill_published,
                "trajectory": trajectory,
            },
            "slo": {
                "pass": True,
                "violations": [],
                "thresholds": {
                    "max_view_lag_ticks": cfg.max_view_lag_ticks,
                    "min_matches_per_sec": cfg.min_matches_per_sec,
                    "max_p99_ms": cfg.max_p99_ms,
                    "forbid_dominant_stages": list(
                        cfg.forbid_dominant_stages
                    ) or None,
                },
            },
            "latency_ms": latency_ms,
            "measured": {
                "wall_s": round(wall_s, 3),
                "queries_per_sec": (
                    round(len(latencies_ms) / wall_s, 2) if wall_s > 0 else 0.0
                ),
            },
            "capture": {"degraded": False},
        }
        if self.frontdoor is not None:
            # Codec route accounting for the socket plane (OUTSIDE the
            # deterministic block — native vs fallback changes nothing
            # the digests see, by the codec's byte-parity contract).
            artifact["frontdoor"] = self.frontdoor.codec_stats()
        if trace_block is not None:
            artifact["trace"] = trace_block
            artifact["slo"]["dominant_stage"] = trace_block["dominant_stage"]
        if self.worker.auditor is not None:
            # The shadow audit's evidence (OUTSIDE the deterministic
            # block — offered counts include engine-internal retries):
            # sampled/checked/mismatch counters plus the first bounded
            # mismatch records. soak_violations gates mismatches == 0.
            artifact["audit"] = self.worker.auditor.stats()
            if self.worker.auditor.mismatches:
                artifact["audit"]["examples"] = [
                    {k: m[k] for k in ("kind", "key", "version")}
                    for m in self.worker.auditor.mismatches[:8]
                ]
        if self.worker.quality is not None:
            # The calibration ledger's evidence (obs/quality.py):
            # OUTSIDE the deterministic block — but itself
            # deterministic per (seed, config), byte-identical across
            # reruns (pinned by tests/test_quality.py). Attached
            # BEFORE soak_violations so the calibration artifact
            # check (obs/slo.py) judges this run's own reliability.
            artifact["quality"] = self.worker.quality.summary()
        if cfg.migrate:
            # Deterministic block is captured above; the cutover (and
            # its version bump) happens only now. The migration's own
            # acceptance — finished, streamed (no silent fall-back to
            # the offline re-rate), bit-identical to the from-scratch
            # reference — gates the soak verdict like any SLO.
            artifact["migration"] = self._finish_migration()
        violations = soak_violations(artifact)
        mig = artifact.get("migration")
        if mig is not None:
            if not mig.get("finished"):
                violations.append(
                    "migration: backfill did not finish "
                    f"({mig.get('error') or 'timed out'})"
                )
            else:
                if not mig.get("streamed"):
                    violations.append(
                        "migration: engine fell back to the offline "
                        "(non-streamed) re-rate path"
                    )
                if not mig.get("bit_identical"):
                    violations.append(
                        "migration: migrated lineage is NOT bit-identical "
                        "to the from-scratch re-rate"
                    )
                if not mig.get("cutover_serves_migrated_table"):
                    violations.append(
                        "migration: post-cutover live view does not serve "
                        "the migrated table"
                    )
        artifact["slo"]["violations"] = violations
        artifact["slo"]["pass"] = not violations
        if violations:
            reg.counter("soak.slo_violations_total").add(len(violations))
            logger.warning("soak SLO violations: %s", "; ".join(violations))
            if trace_block is not None and trace_block["dominant_stage"]:
                logger.warning(
                    "dominant stage over the soak's batches: %s "
                    "(artifact `trace` block has the full decomposition)",
                    trace_block["dominant_stage"],
                )
            # When a device profile was captured during the soak (dead
            # letter / degradation / SIGUSR2), attribute it right here:
            # the violation log then names the dominant device kernel
            # and the busy/idle split next to the dominant host stage.
            from analyzer_tpu_torch.obs.prof import get_device_profiler

            last_capture = get_device_profiler().last_capture
            if last_capture is not None:
                from analyzer_tpu_torch.obs.profview import analyze_capture

                att = analyze_capture(last_capture)
                if att["parsed"]:
                    dev_split = att["device"]
                    logger.warning(
                        "device profile %s: dominant kernel %s, busy "
                        "%.3f ms / idle %.3f ms (idle %.1f%% of the "
                        "capture window)",
                        last_capture, att["dominant_kernel"],
                        dev_split["busy_us"] / 1e3,
                        dev_split["idle_us"] / 1e3,
                        100 * dev_split["idle_frac"],
                    )
                else:
                    logger.warning(
                        "device profile %s did not parse: %s",
                        last_capture, att.get("error"),
                    )
        logger.info(
            "soak done: %d matches over %d ticks (%.1f wall s), slo=%s",
            rated, cfg.n_ticks, wall_s,
            "pass" if not violations else "FAIL",
        )
        return artifact

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            if self.frontdoor is not None:
                self.frontdoor.close()
            self.worker.close()
            if self._trace_prev is not None:
                enable_tracing(self._trace_prev)


def write_artifact(artifact: dict, path: str) -> None:
    """One pretty-printed SOAK artifact (the JAX package's ``SOAK_rNN.json``
    shape)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
        f.write("\n")
