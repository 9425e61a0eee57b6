"""The worker: consume match ids, rate in batches, commit, fan out.

Mirrors the reference's control flow (``worker.py:95-166``) with the
vectorized rating path swapped in:

  * micro-batcher — accumulate messages; flush at ``batch_size`` or after
    ``idle_timeout`` seconds from the first queued message
    (``worker.py:95-101``);
  * process — dedupe ids, load chronologically, encode to tensors, run the
    conflict-free scheduler + jitted kernel, write back
    (``worker.py:169-199``; outputs are fully computed before any mutation,
    giving the reference's single-transaction semantics by construction);
  * failure policy — any exception dead-letters the WHOLE batch to
    ``<queue>_failed`` and nacks without requeue (``worker.py:110-120``);
  * fan-out — per-message ack; notify via topic exchange with the message's
    ``notify`` header; optional crunch/sew forwards of the raw body;
    optional telesuck publish of each telemetry URL with a
    ``match_api_id`` header (``worker.py:122-166``);
  * metrics — matches/sec counter, the BASELINE.json first-class output
    (SURVEY.md section 5.5: the reference has only debug logs);
  * pipelined mode (``service/pipeline.py``, on by default via env config,
    off for direct construction) — overlaps each batch's device round
    trip with the next batch's load/encode by chaining priors on device;
    bit-identical results, same failure policy.

The port's copy of ``analyzer_tpu.service.worker``. Every batch is rated on
the worker's ``device`` (None = the card) through the port's reference
superstep (``sched.rate_history``, plain PyTorch on the card — the JAX
package's worker runs its reference scan there too, not a Pallas kernel).
The observability planes are the JAX worker's, each an observer (the
committed rows, the published views and the served responses are
bit-identical with any of them on or off):

  * obsd (``obs_port``, obs/server.py) with the ``worker.pipeline``,
    ``service.broker``, ``service.store``, ``serve.view`` and
    ``slo.watchdog`` readiness probes;
  * the flight recorder (``flight_dir``, obs/flight.py): always recording,
    dumping on a dead letter, a pipeline degradation, an SLO burn, SIGUSR1
    and obsd's ``/debug/flight``;
  * the device profiler (``profile_dir``, obs/prof.py): one
    ``torch.profiler`` window around the next batch's dispatch on SIGUSR2,
    after a dead letter, a degradation and an SLO burn;
  * the SLO plane (``slo_plane``, on by default): history rings on the
    worker's clock, the burn-rate watchdog, the calibration ledger's
    population drift, and with ``audit`` the shadow audit of served
    responses — all on one throttled tick of the consumer thread's poll
    (``history_interval_s``), never per batch;
  * the rating-quality ledger (``quality``, on by default, obs/quality.py)
    scores each sequentially committed batch's pre-update win
    probabilities against its outcomes.

``serve_shards > 1`` serves through the sharded plane
(``ShardedViewPublisher`` + ``ShardedQueryEngine``, every response equal
to the single plane's).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
from analyzer_tpu_torch.device import resolve_device
from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs import (
    get_device_profiler,
    get_flight_recorder,
    get_registry,
    get_tracer,
)
from analyzer_tpu_torch.obs import tracectx
from analyzer_tpu_torch.obs.tracer import bind_trace
from analyzer_tpu_torch.sched import pack_schedule, rate_history
from analyzer_tpu_torch.service.broker import Broker, Message
from analyzer_tpu_torch.service.encode import EncodedBatch

logger = get_logger(__name__)


def _mirrored_counter(attr: str, series: str):
    """A per-worker integer attribute whose positive deltas mirror into
    the process-wide registry counter ``series`` — so ``w.matches_rated
    += n`` (the call sites, including the pipeline engine's harvest)
    keeps working while every increment also lands on the metrics
    surface. The attribute stays per-worker (two competing consumers
    report their own numbers); the registry series is process-wide, like
    any Prometheus counter."""

    def fget(self):
        return getattr(self, "_" + attr, 0)

    def fset(self, value):
        delta = value - getattr(self, "_" + attr, 0)
        if delta > 0:
            get_registry().counter(series).add(delta)
        setattr(self, "_" + attr, value)

    return property(fget, fset)

# The service loop rates a batch's schedule in chunks of this many
# supersteps (the JAX package's fixed scan step; it pads the schedule to a
# multiple of it so one compiled shape serves every batch). Nothing
# compiles per shape here, so the port keeps the chunking and leaves the
# inert padding steps out: they would read and write nothing.
SERVICE_STEP_CHUNK = 8


class Worker:
    # Operator counters: per-worker values whose increments mirror into
    # the process-wide registry (docs/observability.md catalog).
    matches_rated = _mirrored_counter(
        "matches_rated", "worker.matches_rated_total"
    )
    batches_failed = _mirrored_counter(
        "batches_failed", "worker.batches_failed_total"
    )
    batches_ok = _mirrored_counter("batches_ok", "worker.batches_ok_total")
    dead_letters = _mirrored_counter(
        "dead_letters", "worker.dead_letters_total"
    )
    pipeline_engine_failures = _mirrored_counter(
        "pipeline_engine_failures", "worker.pipeline_engine_failures_total"
    )

    def __init__(
        self,
        broker: Broker,
        store,
        config: ServiceConfig | None = None,
        rating_config: RatingConfig | None = None,
        clock=time.monotonic,
        pipeline: bool | None = None,
        obs_port: int | None = None,
        obs_host: str | None = None,
        flight_dir: str | None = None,
        serve_port: int | None = None,
        serve_host: str | None = None,
        serve_shards: int | None = None,
        profile_dir: str | None = None,
        slo_plane: bool = True,
        audit: bool | None = None,
        audit_sample_denom: int | None = None,
        audit_seed: int = 0,
        quality: bool = True,
        history_interval_s: float = 1.0,
        device=None,
    ) -> None:
        """``device`` is where every batch is rated (None = the card; it
        raises without one, before anything is declared on the broker).
        ``obs_port`` (0 = ephemeral) starts obsd on ``obs_host`` (default
        loopback); ``flight_dir`` (or ``ANALYZER_TPU_FLIGHT_DIR``) arms
        flight-recorder dumps; ``profile_dir`` (or
        ``ANALYZER_TPU_PROFILE_DIR``) arms the process-wide device profiler
        (obs/prof.py); ``slo_plane`` runs the history sampler and the
        watchdog every ``history_interval_s`` of the worker's clock;
        ``audit`` (None: ``ANALYZER_TPU_AUDIT``) audits 1 in
        ``audit_sample_denom`` served responses (seeded by
        ``audit_seed``) when the SLO plane and the serve plane are on."""
        self.device = resolve_device(device)
        self.broker = broker
        self.store = store
        self.config = config or ServiceConfig.from_env()
        self.rating_config = rating_config or RatingConfig.from_env()
        self.clock = clock
        self.queue: list[Message] = []
        self._first_message_at: float | None = None
        self._queue_depth_sampled_at: float | None = None
        self.matches_rated = 0
        self.batches_failed = 0
        self.batches_ok = 0
        self.dead_letters = 0
        self._started_at = clock()
        self._stop_requested = False
        # Flight recorder: the ring is always on (process-wide, shared
        # with the pipeline writer's breadcrumbs); artifact dumps engage
        # once a directory is configured (flight_dir here, or
        # ANALYZER_TPU_FLIGHT_DIR in the environment).
        self.flight = get_flight_recorder()
        if flight_dir is not None:
            self.flight.configure(base_dir=flight_dir)
        # Device-time attribution (obs/prof.py): armed by profile_dir here
        # or ANALYZER_TPU_PROFILE_DIR; unarmed it costs one attribute read
        # per batch. SIGUSR2 requests a capture of the next dispatch
        # window; dead-letters, degradation and SLO burns request one
        # automatically (throttled), and the flight dump names it.
        self.profiler = get_device_profiler()
        if profile_dir is not None:
            self.profiler.configure(profile_dir=profile_dir)
        # Pipelined consume loop (service/pipeline.py): overlap the next
        # batch's load/encode with the in-flight batch's device round
        # trip + commit. None = follow config.pipeline.
        self.pipeline_enabled = (
            self.config.pipeline if pipeline is None else pipeline
        )
        self._engine = None
        self._pipeline_requested = self.pipeline_enabled
        # Transient engine-construction failures retry with backoff
        # instead of permanently degrading the worker (ADVICE r4): a
        # brief DB blip at the clone probe must not halve throughput
        # until restart.
        self._engine_retry_at: float | None = None
        self._engine_backoff = 5.0
        self.pipeline_engine_failures = 0
        # Filled by warmup's probe when lag is auto (config.pipeline_lag
        # None); PipelineEngine reads them through choose_pipeline_lag.
        self.measured_rtt_s: float | None = None
        self.measured_host_s: float | None = None
        # Pinned schedule width, the JAX package's: one width derived once
        # from the batch size (a 500-match batch of mostly-distinct
        # players packs into ~8 steps of 64), so both packages pack every
        # batch into the same schedule.
        w = -(-self.config.batch_size // 8)  # ~steps-of-8 heuristic width
        self._packed_width = min(128, max(8, -(-w // 8) * 8))
        # The SINGLE owners of the service shape knobs — schedule packing,
        # warmup, and the pipelined engine all read these, so overriding
        # one on a worker keeps every consumer in lockstep.
        self._step_chunk = SERVICE_STEP_CHUNK
        from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE
        from analyzer_tpu_torch.service.encode import row_bucket

        self._canon_rows = (
            row_bucket(self.config.batch_size * 2 * MAX_TEAM_SIZE) + 1
        )

        # Service-lane journal mode: WAL overlap + cheap commits (see
        # SqlStore.enable_wal — deliberately NOT on for the bulk
        # full-history lane, where WAL measured 1.7x slower).
        enable_wal = getattr(store, "enable_wal", None)
        if enable_wal is not None:
            enable_wal()

        c = self.config
        # The reference declares queue/failed/crunch/telesuck but NOT sew
        # (worker.py:87-90) — sew is assumed to exist; we keep that contract.
        broker.declare_queue(c.queue)
        broker.declare_queue(c.failed_queue)
        broker.declare_queue(c.crunch_queue)
        broker.declare_queue(c.telesuck_queue)

        # obsd (obs/server.py): the live introspection plane. Readiness
        # combines the pipeline lane's health with duck-typed broker/
        # store connectivity probes — `curl :port/readyz` flips to 503
        # the moment the worker degrades to the sequential loop.
        self.obs_server = None
        if obs_port is not None:
            from analyzer_tpu_torch.obs.server import (
                DEFAULT_HOST, ObsServer, connectivity_probe,
            )

            self.obs_server = ObsServer(
                port=obs_port,
                host=obs_host or DEFAULT_HOST,
                status_provider=self.stats,
                # /debug/flight rides the worker's own dump path so a
                # remotely-triggered artifact carries the config and
                # device-profiler blocks a local trigger would.
                flight_dump=self._flight_dump,
            )
            health = self.obs_server.health
            health.register("worker.pipeline", self._pipeline_health)
            health.register(
                "service.broker", connectivity_probe(broker, "broker")
            )
            health.register(
                "service.store", connectivity_probe(store, "store")
            )
        # ratesrv (serve/): the query-serving read plane. The worker
        # publishes a new immutable view version at every batch commit
        # boundary (_publish_view — sequential process() and the
        # pipelined harvest both route through it), so readers see
        # exactly the committed table, never a mid-commit one.
        self.view_publisher = None
        self.query_engine = None
        self.serve_server = None
        if serve_port is not None:
            from analyzer_tpu_torch.obs.httpd import DEFAULT_HOST as LOOPBACK
            from analyzer_tpu_torch.serve import (
                QueryEngine,
                ShardedQueryEngine,
                ShardedViewPublisher,
                ViewPublisher,
            )
            from analyzer_tpu_torch.serve.server import ServeServer

            # Topology is a constructor knob, not a caller concern: both
            # planes satisfy the ServePlane protocol, so everything from
            # _publish_view to /v1/* is identical either way — and the
            # served numbers are bit-identical by the sharded engine's
            # contract.
            if serve_shards is not None and serve_shards > 1:
                self.view_publisher = ShardedViewPublisher(
                    serve_shards, device=self.device
                )
                self.query_engine = ShardedQueryEngine(
                    self.view_publisher, cfg=self.rating_config,
                    device=self.device,
                ).start()
            else:
                self.view_publisher = ViewPublisher(device=self.device)
                self.query_engine = QueryEngine(
                    self.view_publisher, cfg=self.rating_config,
                    device=self.device,
                ).start()
            self.serve_server = ServeServer(
                self.query_engine,
                port=serve_port,
                host=serve_host or LOOPBACK,
            )
            if self.obs_server is not None:
                # /readyz flips green only after the first commit
                # publishes version 1 — a balancer must not route reads
                # at a worker still warming its view.
                self.obs_server.health.register(
                    "serve.view", self._serve_view_health
                )
        # The live SLO plane: the history sampler records the registry
        # into trend rings on THIS worker's clock, the watchdog evaluates
        # the objective table as multi-window burn rates over those rings
        # — flipping /readyz degraded and capturing a flight dump + device
        # profile at first burn — and the shadow auditor replays a
        # seeded-hash sample of served queries through the bit-exact
        # oracle off the hot path. One throttled _slo_tick per poll;
        # slo_plane=False disables all three (the bit-identity AB knob).
        self.history = None
        self.watchdog = None
        self.auditor = None
        self._history_interval_s = float(history_interval_s)
        self._history_sampled_at: float | None = None
        if slo_plane:
            from analyzer_tpu_torch.obs.devicemem import maybe_sample
            from analyzer_tpu_torch.obs.history import get_history
            from analyzer_tpu_torch.obs.slo import get_watchdog

            self.history = get_history()
            # Device-memory gauges refresh ahead of every sample so memory
            # growth is trend-visible (the leak burn-rate SLO's data
            # source). torch.cuda.memory_stats runs here, on the
            # throttled tick, never per batch.
            self.history.add_probe(maybe_sample)
            self.watchdog = get_watchdog()
            self.watchdog.on_burn = self._on_slo_burn
            if self.obs_server is not None:
                self.obs_server.health.register(
                    "slo.watchdog", self.watchdog.healthy
                )
            if audit is None:
                audit = bool(
                    os.environ.get("ANALYZER_TPU_AUDIT", "") not in ("", "0")
                )
            if audit and self.query_engine is not None:
                from analyzer_tpu_torch.obs.audit import (
                    DEFAULT_SAMPLE_DENOM,
                    ShadowAuditor,
                )

                self.auditor = ShadowAuditor(
                    cfg=self.rating_config,
                    tier_edges=self.query_engine.tier_edges,
                    seed=audit_seed,
                    sample_denom=(
                        audit_sample_denom if audit_sample_denom is not None
                        else DEFAULT_SAMPLE_DENOM
                    ),
                )
                self.query_engine.auditor = self.auditor
        # The rating-quality plane (obs/quality.py): at every sequential
        # commit the ledger scores the batch's PRE-update predicted win
        # probabilities (the serve plane's Phi link over the prior
        # ratings) against the realized outcomes, mirrored into quality.*
        # counters; drift snapshots ride the throttled _slo_tick. An
        # observer: nothing here feeds back into the rating path, so
        # results are bit-identical with the plane on or off
        # (quality=False is the AB knob, like slo_plane).
        self.quality = None
        if quality:
            from analyzer_tpu_torch.obs.quality import (
                CalibrationLedger,
                set_quality_ledger,
            )

            self.quality = CalibrationLedger(self.rating_config)
            set_quality_ledger(self.quality)

    # -- micro-batcher ----------------------------------------------------
    def poll(self) -> bool:
        """One consumer iteration: pull what's available, flush when the
        batch is full or the idle timer expired. Returns True if a flush
        happened."""
        room = self.config.batch_size - len(self.queue)
        if room > 0:
            got = self.broker.get(self.config.queue, room)
            if got and self._first_message_at is None:
                self._first_message_at = self.clock()
            self.queue.extend(got)
        self._sample_queue_depth()
        self._slo_tick()
        full = len(self.queue) >= self.config.batch_size
        idle = (
            self._first_message_at is not None
            and self.clock() - self._first_message_at >= self.config.idle_timeout
        )
        if self.queue and (full or idle):
            self.try_process()
            return True
        if self._engine is not None:
            # No new flush: apply whatever batches completed (acks must
            # not wait for the next flush), but do NOT block on the
            # in-flight tail — a push broker legitimately returns empty
            # polls while deliveries are in flight (broker.py:95+), and
            # draining there would serialize the pipeline back to the
            # sequential loop. Full drains happen on stop, bounded-run
            # exit, and explicit Worker.drain().
            self._engine.harvest()
        return False

    def _sample_queue_depth(self) -> None:
        """Samples the broker's ready depth into the
        ``broker.queue_depth{queue=}`` gauge (plus the unlabeled
        process gauge) so soak/production backpressure is visible on
        /statusz. On a partitioned broker the ``{queue=}`` series is the
        AGGREGATE across every partition and lane (``qsize`` owns that
        sum), and each partition / lane also emits its own
        ``broker.queue_depth{queue=,partition=,lane=}`` series, so /statusz
        shows the skew (bounded by the registry's label-cardinality cap).
        Throttled on the worker clock — on AMQP the depth is a
        passive-declare round trip, which a 100 Hz poll loop must not pay
        per iteration. Best-effort: a broker blip here must not take down
        the consume loop."""
        qsize = getattr(self.broker, "qsize", None)
        if qsize is None:
            return
        now = self.clock()
        if (
            self._queue_depth_sampled_at is not None
            and now - self._queue_depth_sampled_at < 1.0
        ):
            return
        self._queue_depth_sampled_at = now
        try:
            depth = int(qsize(self.config.queue))
        except Exception:  # noqa: BLE001 — observability is best-effort
            logger.debug("broker qsize probe failed", exc_info=True)
            return
        reg = get_registry()
        reg.gauge("broker.queue_depth").set(depth)
        reg.gauge("broker.queue_depth", queue=self.config.queue).set(depth)
        partition_depths = getattr(self.broker, "partition_depths", None)
        if partition_depths is None:
            return
        try:
            per_part = partition_depths(self.config.queue)
        except Exception:  # noqa: BLE001 — observability is best-effort
            logger.debug("broker partition_depths probe failed", exc_info=True)
            return
        for part, lanes in per_part.items():
            for lane, lane_depth in lanes.items():
                reg.gauge(
                    "broker.queue_depth",
                    queue=self.config.queue, partition=part, lane=lane,
                ).set(lane_depth)

    def _slo_tick(self) -> None:
        """One throttled pass of the live SLO plane, on the consumer
        thread: refresh the serve gauges the sampler reads, drain a
        bounded slice of the shadow-audit backlog (the oracle replay runs
        here, never on the serving path), snapshot the calibration
        ledger's population drift over the served view, record a history
        sample at THIS worker's clock and evaluate the watchdog. Nothing
        here branches into the rating path. A failing tick is logged and
        the loop goes on."""
        if self.history is None:
            return
        now = self.clock()
        if (
            self._history_sampled_at is not None
            and now - self._history_sampled_at < self._history_interval_s
        ):
            return
        self._history_sampled_at = now
        try:
            if self.view_publisher is not None:
                reg = get_registry()
                reg.gauge("serve.view_version").set(self.view_publisher.version)
                age = self.view_publisher.view_age_s()
                if age is not None:
                    reg.gauge("serve.view_age_seconds").set(round(age, 3))
            if self.auditor is not None:
                self.auditor.drain(limit=64)
            if self.quality is not None and self.view_publisher is not None:
                # Population drift over the COMMITTED table (the served
                # view — the surface readers see): one device-to-host copy
                # per view version, throttled to the history interval.
                view = self.view_publisher.current()
                if view is not None:
                    self.quality.observe_population(
                        view.host_table(), now=now
                    )
            self.history.sample(now)
            if self.watchdog is not None:
                self.watchdog.check(now)
        except Exception:  # noqa: BLE001 — the SLO plane must never
            # take down the consume loop it observes.
            logger.exception("SLO plane tick failed")

    def _on_slo_burn(self, objective, burn) -> None:
        """First-burn evidence capture: the flight recorder freezes the
        trajectory INTO the burn (history.json rides the dump) and the
        device profiler arms a capture of the next dispatch window —
        both throttled, both no-ops when unarmed."""
        logger.warning("SLO burn: %s — %s", objective.name, burn.detail)
        if (
            getattr(objective, "kind", None) == "calibration"
            and self.quality is not None
        ):
            # Name the worst reliability bin while the evidence is fresh:
            # WHERE the predictions are off, not just that they are.
            wb = self.quality.worst_bin()
            if wb is not None:
                logger.warning(
                    "calibration burn: worst reliability bin "
                    "[%s, %s): mean_p=%s mean_y=%s over %s matches",
                    wb["lo"], wb["hi"], wb["mean_p"], wb["mean_y"],
                    wb["count"],
                )
                self.flight.note("quality.worst_bin", **wb)
        self.flight.note(
            "slo.burn", objective=objective.name, detail=burn.detail
        )
        self.profiler.request("slo_burn")
        self._flight_dump(f"slo-{objective.name}")

    def request_stop(self) -> None:
        """Asks the consume loop to exit after the current batch. Safe
        from a signal handler (single flag write). The reference has no
        graceful shutdown at all (``worker.py:219-221`` — SIGTERM kills
        mid-batch and relies on broker redelivery); here an in-flight
        batch always finishes its commit + acks first."""
        self._stop_requested = True

    def run(
        self,
        max_flushes: int | None = None,
        poll_interval: float = 0.01,
        max_wall_s: float | None = None,
        install_signal_handlers: bool = False,
    ) -> None:
        """Blocking consume loop (the reference's ``start_consuming``).
        ``max_wall_s`` bounds a ``max_flushes`` run in wall-clock time so
        a test against a mis-seeded broker fails loudly instead of
        spinning forever. ``install_signal_handlers`` wires SIGTERM and
        SIGINT to :meth:`request_stop` (drain in-flight batches, exit
        cleanly, flush a final snapshot) and SIGUSR1 to a flight-recorder
        dump + ``stats()`` log line WITHOUT stopping — the operator's
        "what is this worker doing right now" signal — and SIGUSR2 to a
        device-profiler capture of the next batch's dispatch (main-thread
        only: ``signal.signal`` raises elsewhere)."""
        # NOT reset here: a stop requested before run() must be honored
        # (it is cleared on the stop exit below so the worker is reusable).
        previous_handlers = {}
        if install_signal_handlers:
            import signal

            for sig in (signal.SIGTERM, signal.SIGINT):
                previous_handlers[sig] = signal.signal(
                    sig, lambda *_: self.request_stop()
                )
            if hasattr(signal, "SIGUSR1"):  # not on Windows
                previous_handlers[signal.SIGUSR1] = signal.signal(
                    signal.SIGUSR1, self._on_sigusr1
                )
            if hasattr(signal, "SIGUSR2"):  # on-demand device capture
                previous_handlers[signal.SIGUSR2] = signal.signal(
                    signal.SIGUSR2, self._on_sigusr2
                )
        try:
            flushes = 0
            deadline = None if max_wall_s is None else self.clock() + max_wall_s
            while max_flushes is None or flushes < max_flushes:
                if self._stop_requested:
                    # In-flight pipelined batches finish their commits +
                    # acks first (the graceful-shutdown contract), THEN
                    # messages pulled into a partial batch go back to the
                    # broker (nack + requeue) — leaving them unacked would
                    # strand them forever on the in-memory broker and
                    # until connection teardown on AMQP.
                    self.drain()
                    for msg in self.queue:
                        self.broker.nack(msg.delivery_tag, requeue=True)
                    self.queue = []
                    self._first_message_at = None
                    self._stop_requested = False
                    logger.info(
                        "stop requested; exiting after %s batches: %s",
                        flushes, self.stats(),
                    )
                    # Everything committed + acked above; flush one last
                    # snapshot so the shutdown state is inspectable after
                    # the process is gone.
                    self._final_snapshot()
                    return
                if deadline is not None and self.clock() > deadline:
                    target = "" if max_flushes is None else f"/{max_flushes}"
                    raise TimeoutError(
                        f"worker made {flushes}{target} flushes in "
                        f"{max_wall_s}s"
                    )
                if self.poll():
                    flushes += 1
                else:
                    time.sleep(poll_interval)
            self.drain()  # bounded runs return with everything committed
        finally:
            if previous_handlers:
                import signal

                for sig, handler in previous_handlers.items():
                    signal.signal(sig, handler)

    # -- warmup -----------------------------------------------------------
    def warmup(self) -> None:
        """First touch of the device before the first message: one batch
        per player-row bucket production can hit (64 up to
        ``row_bucket(batch_size * 2 * 5)``) runs through the same rating
        path a batch takes, so the CUDA context, the caching allocator's
        pools and the pinned host pool exist before any message waits on
        them. In the JAX package this ladder fills XLA's compile cache;
        nothing here compiles per shape (eager PyTorch), so the runs are a
        first touch only. Then, when the lag is auto, the cost probe that
        feeds ``choose_pipeline_lag``; and with pipelining on, one chain
        patch through a ring of the resolved depth."""
        from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE, PlayerState
        from analyzer_tpu_torch.sched.superstep import MatchStream

        t0 = self.clock()
        max_alloc = self._canon_rows - 1  # one owner: the constructor
        ladder = []
        alloc = 64  # row_bucket's floor
        while alloc <= max_alloc:
            ladder.append(alloc)
            alloc *= 2
        for alloc in ladder:
            # A matches-worth of distinct players filling this bucket.
            p = min(alloc, self.config.batch_size * 2 * MAX_TEAM_SIZE)
            n_matches = max(1, p // (2 * MAX_TEAM_SIZE))
            p = n_matches * 2 * MAX_TEAM_SIZE
            state = PlayerState.create(
                alloc, cfg=self.rating_config, device=self.device
            )
            idx = np.arange(p, dtype=np.int32).reshape(
                n_matches, 2, MAX_TEAM_SIZE
            )
            stream = MatchStream(
                player_idx=idx,
                winner=np.zeros(n_matches, np.int32),
                mode_id=np.ones(n_matches, np.int32),  # ranked
                afk=np.zeros(n_matches, bool),
            )
            sched = self._bucketed_schedule(stream, alloc)
            rate_history(
                state, sched, self.rating_config, collect=True,
                steps_per_chunk=self._step_chunk,
            )
        if self.pipeline_enabled and self.config.pipeline_lag is None:
            try:
                self._measure_pipeline_costs()
            except Exception:  # noqa: BLE001 — optimization-only probe:
                # a transient device error here must not kill startup;
                # the engine falls back to DEFAULT_LAG.
                logger.exception(
                    "pipeline cost probe failed; lag falls back to the "
                    "default"
                )
        if self.pipeline_enabled:
            from analyzer_tpu_torch.core.state import TABLE_WIDTH
            from analyzer_tpu_torch.service.pipeline import (
                _chain_patch_, chain_buffers, ring_put_,
            )

            # The probe ran FIRST so the ring is allocated at the lag the
            # engine will actually resolve (chain_buffers owns the shape).
            lag = self.resolved_pipeline_lag()
            ring, pairs, _ = chain_buffers(lag, self._canon_rows, self.device)
            dst = torch.zeros((ladder[-1] + 1, TABLE_WIDTH),
                              dtype=torch.float32, device=self.device)
            ring_put_(ring, 0, dst)
            _chain_patch_(
                dst, ring, torch.from_numpy(pairs[:, :1]).to(self.device)
            )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        logger.info(
            "warmup ran the %d-rung row ladder in %.1fs",
            len(ladder), self.clock() - t0,
        )

    def _measure_pipeline_costs(self) -> None:
        """Feeds ``choose_pipeline_lag``: the dispatch->fetch round trip
        of one production-sized packed-outputs chunk (the latency the
        pipeline must hide; min of 3 after a first-touch rep) and the
        per-batch host cost of encode + schedule + write_back on a
        synthetic batch-size object graph (the work that hides it).
        Store load/commit costs add to the host side in production,
        which only LOWERS the ideal lag — an over-estimate costs broker
        headroom and failure blast radius, not throughput, so the probe
        deliberately errs high.

        The round trip is a fresh ``[SERVICE_STEP_CHUNK, width, 3 + 10T]``
        f32 tensor computed on the device and copied into pinned host
        memory with ``non_blocking=True``, timed with ``perf_counter``
        until the CUDA event behind the copy has completed (on the CPU
        the same steps, with nothing to wait for)."""
        from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE
        from analyzer_tpu_torch.sched.runner import _Fetch

        # One chunk's collect output: [chunk, width, 3 + 10T] f32 — a full
        # 500-match batch of mostly-distinct players packs into about one
        # such chunk (~108 KB at the defaults).
        shape = (self._step_chunk, self._packed_width, 3 + 10 * MAX_TEAM_SIZE)
        base = torch.zeros(shape, dtype=torch.float32, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rtt: float | None = None
        for i in range(4):
            t0 = time.perf_counter()
            _Fetch(base + float(i)).result()  # fresh tensor each rep
            dt = time.perf_counter() - t0
            if i > 0:  # rep 0 pays the first-touch costs
                rtt = dt if rtt is None else min(rtt, dt)
        # The probe must measure the LANE production batches will run —
        # the columnar encode is several times cheaper than the object
        # one, and an inflated host estimate would under-size the lag
        # (lag ~ rtt / host).
        columnar = getattr(self.store, "load_batch_raw", None) is not None
        if columnar:
            from analyzer_tpu_torch.fixtures import synthetic_raw_batch
            from analyzer_tpu_torch.service.columnar import ColumnarBatch

            t0 = self.clock()
            enc = ColumnarBatch(
                synthetic_raw_batch(self.config.batch_size),
                self.rating_config, bucket_rows=True, device=self.device,
            )
        else:
            from analyzer_tpu_torch.fixtures import synthetic_batch

            matches = synthetic_batch(self.config.batch_size)
            t0 = self.clock()
            enc = EncodedBatch(matches, self.rating_config, bucket_rows=True,
                               device=self.device)
        sched = self._bucketed_schedule(enc.stream, enc.state.pad_row)
        host = self.clock() - t0
        _, outs = rate_history(
            enc.state, sched, self.rating_config, collect=True,
            steps_per_chunk=self._step_chunk,
        )
        t0 = self.clock()
        if columnar:
            enc.write_plan(outs)
        else:
            enc.write_back(outs)
        host += self.clock() - t0
        self.measured_rtt_s = rtt
        self.measured_host_s = host
        logger.info(
            "pipeline cost probe: rtt %.3f ms, host %.1f ms/batch",
            (rtt or 0.0) * 1e3, host * 1e3,
        )

    def resolved_pipeline_lag(self) -> int:
        """The commit lag the pipelined engine will run with: the pinned
        ``PIPELINE_LAG`` when set, else the warmup probe's measurement
        through ``choose_pipeline_lag``, else the default. One owner —
        warmup compiles the chain ring at this depth and the engine must
        build it identically."""
        from analyzer_tpu_torch.service.pipeline import (
            DEFAULT_LAG, choose_pipeline_lag,
        )

        if self.config.pipeline_lag is not None:
            return max(1, int(self.config.pipeline_lag))
        if self.measured_rtt_s is not None and self.measured_host_s is not None:
            lag = choose_pipeline_lag(self.measured_rtt_s, self.measured_host_s)
            logger.info(
                "pipeline lag auto-tuned to %d (rtt %.0f ms, host "
                "%.0f ms/batch)", lag, self.measured_rtt_s * 1e3,
                self.measured_host_s * 1e3,
            )
            return lag
        return DEFAULT_LAG

    # -- batch pipeline ---------------------------------------------------
    def _bucketed_schedule(self, stream, pad_row: int):
        """The pinned-width schedule — the ONE place the service schedule
        is packed, shared by ``process``, ``warmup`` and the pipelined
        engine. The runners consume it in chunks of ``SERVICE_STEP_CHUNK``
        steps (the last one shorter; see the constant for why the JAX
        package's inert padding steps are left out)."""
        return pack_schedule(
            stream, pad_row=pad_row, batch_size=self._packed_width,
            windowed=True,
        )

    def _dead_letter(self, messages) -> None:
        """Republish to the failed queue + nack without requeue — the
        reference's failure policy (``worker.py:110-120``), applied here
        to whatever subset the caller determined."""
        rollback = getattr(self.store, "rollback", None)
        if rollback is not None:
            # Close out any read transaction load_batch's SELECTs opened
            # (the reference's rollback-then-close, worker.py:195-199);
            # without this a MySQL connection would pin a stale snapshot
            # and the next load_batch would miss newly ingested matches.
            rollback()
        for msg in messages:
            self.broker.publish(self.config.failed_queue, msg.body, msg.headers)
            self.broker.nack(msg.delivery_tag, requeue=False)
        self.dead_letters += len(messages)
        get_tracer().instant(
            "worker.dead_letter", cat="worker", messages=len(messages)
        )
        # The flight recorder freezes the last seconds BEFORE this point —
        # spans, log tail, batch breadcrumbs — into an artifact dir
        # (throttled). The failure policy above already completed, so a
        # dump failure costs nothing but the artifact.
        self.flight.note("dead_letter", messages=len(messages))
        # Device-time attribution for the failure window: a (throttled)
        # capture of the NEXT dispatch, named in the dump below.
        self.profiler.request("dead_letter")
        self._flight_dump("dead_letter")

    def try_process(self) -> None:
        """Routes the flushed batch: the sequential reference-shaped path
        (default), or the pipelined engine (``service/pipeline.py``) that
        overlaps this batch's device round trip with the next batch's
        host work. Failure policy is identical either way."""
        batch = self.queue
        self.queue = []
        self._first_message_at = None
        mode = "pipelined" if self.pipeline_enabled else "sequential"
        # Causal join (obs/tracectx.py, no-op when tracing is off): one
        # batch.assemble instant maps member match traces -> this batch,
        # and binding the batch id makes every span below — the feed
        # thread's and the pipelined writer's included — part of one
        # reconstructable tree (cli trace).
        trace = tracectx.assemble(batch)
        # The batch lifecycle span: flush -> (encode/rate/commit or
        # dead-letter). In pipelined mode this covers submission only —
        # commit + ack land in a later harvest (their own spans).
        with bind_trace(trace), get_tracer().span(
            "batch.lifecycle", cat="worker", messages=len(batch), mode=mode
        ):
            if self.pipeline_enabled:
                self._try_process_pipelined(batch)
            else:
                self._process_batch_sequential(batch)

    def _ensure_engine(self):
        """Returns the pipelined engine, constructing it on first use, or
        ``None`` when unavailable (caller runs the sequential loop). A
        PERMANENT refusal (RuntimeError from the store's eager clone
        probe — e.g. in-memory sqlite, ``sql_store.py:176``) disables
        pipelined mode for the worker's lifetime; anything else (a
        transient DB outage hitting the probe's connect) keeps pipelined
        mode requested and retries construction after a backoff, so a
        brief blip costs seconds of sequential throughput, not the rest
        of the process. ``pipeline_degraded`` surfaces the state."""
        if self._engine is not None:
            return self._engine
        if not self.pipeline_enabled:
            return None
        now = self.clock()
        if self._engine_retry_at is not None and now < self._engine_retry_at:
            return None
        from analyzer_tpu_torch.service.pipeline import PipelineEngine
        from analyzer_tpu_torch.service.store import UncloneableStoreError

        try:
            self._engine = PipelineEngine(self, lag=self.config.pipeline_lag)
        except UncloneableStoreError as err:
            self._disable_pipeline(f"store refuses a second connection: {err}")
            return None
        except Exception as err:  # noqa: BLE001 — transient: retry later
            self.pipeline_engine_failures += 1
            self._engine_retry_at = now + self._engine_backoff
            logger.warning(
                "pipeline engine construction failed (%s); sequential "
                "loop for ~%.0f s, then retrying", err, self._engine_backoff,
            )
            self._engine_backoff = min(self._engine_backoff * 2, 300.0)
            return None
        self._engine_retry_at = None
        self._engine_backoff = 5.0
        return self._engine

    def _disable_pipeline(self, reason: str) -> None:
        """Permanently degrades the worker to the sequential loop (store
        can never clone; writer died). Narrows the broker's QoS window
        back to the reference's one-batch bound when the broker supports
        it — the pipelined prefetch (lag+1 batches) would otherwise keep
        hogging deliveries a sequential consumer can't keep up with,
        starving healthy competing consumers on the same queue."""
        self.pipeline_enabled = False
        self._engine = None
        get_registry().counter("worker.pipeline_degradations_total").add(1)
        get_registry().gauge("worker.pipeline_degraded").set(True)
        get_tracer().instant(
            "worker.pipeline_degraded", cat="worker", reason=reason
        )
        logger.warning(
            "pipelined mode disabled (%s); using the sequential loop",
            reason,
        )
        self.profiler.request("pipeline_degraded")
        self._flight_dump("pipeline_degraded")
        set_prefetch = getattr(self.broker, "set_prefetch", None)
        if set_prefetch is not None:
            try:
                set_prefetch(self.config.batch_size)
            except Exception:  # noqa: BLE001 — QoS narrowing is best-effort
                logger.exception("could not narrow broker prefetch")

    def drain(self) -> None:
        """Blocks until every in-flight pipelined batch has committed (or
        its failure policy has been applied). Also drains the shadow-audit
        backlog: a bounded-run exit must not leave sampled queries
        unreplayed."""
        if self._engine is not None:
            self._engine.drain()
        if self.auditor is not None:
            self.auditor.drain()

    def close(self) -> None:
        """Releases the pipelined engine (writer thread + its cloned
        store connection) after draining, drains the audit, releases the
        process-wide watchdog hook and ``/qualityz`` registration, and
        stops obsd + ratesrv. A Worker is reusable after close — the next
        pipelined flush builds a fresh engine (obsd/ratesrv are not
        rebuilt: their lifetime is the process's)."""
        if self._engine is not None:
            self._engine.close()
            self._engine = None
        if self.auditor is not None:
            self.auditor.drain()
        if self.watchdog is not None and self.watchdog.on_burn == self._on_slo_burn:
            # The watchdog is process-wide; a closed worker must not keep
            # receiving burn callbacks through it.
            self.watchdog.on_burn = None
        if self.quality is not None:
            from analyzer_tpu_torch.obs.quality import (
                get_quality_ledger,
                set_quality_ledger,
            )

            # The ledger registration is process-wide; release it only if
            # it is still ours (a newer worker may own it).
            if get_quality_ledger() is self.quality:
                set_quality_ledger(None)
        if self.serve_server is not None:
            self.serve_server.close()
            self.serve_server = None
        if self.query_engine is not None:
            self.query_engine.close()
            self.query_engine = None
        if self.obs_server is not None:
            self.obs_server.close()
            self.obs_server = None

    def _try_process_pipelined(self, batch) -> None:
        from analyzer_tpu_torch.service.pipeline import PipelineFallback

        engine = self._ensure_engine()
        if engine is None:  # unavailable (permanent or inside the retry
            # window): the sequential loop owns the batch's failure policy.
            self._process_batch_sequential(batch)
            return
        engine.harvest()  # apply whatever completed since the last flush
        if not self.pipeline_enabled or self._engine is None:
            # harvest itself disabled the pipeline (dead writer):
            # submitting to the orphaned engine would strand this
            # batch's messages unacked in a queue nothing drains.
            self._process_batch_sequential(batch)
            return
        try:
            engine.submit(batch)
        except PipelineFallback:
            # A pending failure poisoned the stream: harvest applies the
            # failure policy + reprocessing, then this batch runs clean.
            engine.harvest()
            self._process_batch_sequential(batch)
        except Exception as err:  # noqa: BLE001 — poison, load errors, ...
            # The sequential path re-loads from scratch and owns the
            # poison-isolation / whole-batch dead-letter decision — but
            # it must see FULLY COMMITTED state and commit in order, so
            # the in-flight pipeline finishes first (the PoisonError
            # retry inside submit drains for the same reason).
            logger.warning(
                "pipelined submit failed (%s); sequential fallback", err
            )
            engine.drain()
            self._process_batch_sequential(batch)

    def _process_batch_sequential(self, batch) -> None:
        """The reference's ``try_process`` (``worker.py:103-166``), with
        POISON-PILL ISOLATION on top: a failure that names its offending
        match(es) (service.encode.PoisonError) dead-letters exactly
        those messages and retries the rest, so one corrupt record costs
        one message instead of the whole 500 (the reference dead-letters
        everything, ``worker.py:110-120``). Unattributable errors keep
        the whole-batch policy."""
        from analyzer_tpu_torch.service.encode import PoisonError

        for _ in range(len(batch) + 1):  # each pass removes >= 1 message
            try:
                self.process([m.body.decode() for m in batch])
                break
            except PoisonError as err:
                bad_ids = set(err.api_ids)
                bad = [m for m in batch if m.body.decode() in bad_ids]
                if not bad:  # can't attribute after all: whole-batch policy
                    logger.error("batch failed: %s", err)
                    self.batches_failed += 1
                    self._dead_letter(batch)
                    return
                logger.error(
                    "poison match(es) %s: %s; dead-lettering %d message(s), "
                    "retrying the other %d",
                    sorted(bad_ids), err, len(bad), len(batch) - len(bad),
                )
                self._dead_letter(bad)
                keep = {id(m) for m in bad}
                batch = [m for m in batch if id(m) not in keep]
                if not batch:
                    return
            except Exception as err:  # noqa: BLE001 — policy: any error dead-letters
                logger.error("batch failed: %s", err)
                self.batches_failed += 1
                self._dead_letter(batch)
                return
        else:  # loop exhausted without success — defensive, unreachable
            self.batches_failed += 1
            self._dead_letter(batch)
            return

        self._ack_batch(batch)

    def _ack_batch(self, batch) -> None:
        """Per-message ack + notify/crunch/sew/telesuck fan-out
        (``worker.py:122-166``). Always on the consumer thread — the
        broker is not thread-safe."""
        logger.info("acking batch")
        get_registry().counter("worker.acks_total").add(len(batch))
        for msg in batch:
            self.broker.ack(msg.delivery_tag)
            notify = (msg.headers or {}).get("notify")
            if notify:
                self.broker.publish_topic("amq.topic", notify, b"analyze_update")
            # Forwards keep the original message headers, as the reference
            # republishes with properties=prop (worker.py:136-147) so
            # downstream consumers still see e.g. the notify header.
            if self.config.do_crunch_match:
                self.broker.publish(self.config.crunch_queue, msg.body, msg.headers)
            if self.config.do_sew_match:
                self.broker.publish(self.config.sew_queue, msg.body, msg.headers)
            if self.config.do_telesuck_match:
                mid = msg.body.decode()
                for url in self.store.asset_urls(mid):
                    self.broker.publish(
                        self.config.telesuck_queue,
                        url.encode(),
                        headers={"match_api_id": mid},
                    )

    def _encode_batch(self, ids: list[str]):
        """Loads + encodes one id batch through the store's best lane:
        columnar (``load_batch_raw`` -> :class:`ColumnarBatch`, no object
        graphs — the SqlStore fast path) or the object lane
        (``load_batch`` -> :class:`EncodedBatch` — required where the
        loaded objects ARE the store, e.g. InMemoryStore). Returns an
        encoded batch whose ``matches`` is empty when no ids loaded."""
        raw_loader = getattr(self.store, "load_batch_raw", None)
        if raw_loader is not None:
            from analyzer_tpu_torch.service.columnar import ColumnarBatch

            raw = None
            native_loader = getattr(self.store, "load_batch_native", None)
            if native_loader is not None:
                # C scanner: typed column arrays, no per-row python
                # tuples (None when unavailable — python rows instead).
                raw = native_loader(ids)
            if raw is None:
                raw = raw_loader(ids)
            return ColumnarBatch(
                raw, self.rating_config, bucket_rows=True, device=self.device
            )
        matches = self.store.load_batch(ids)
        if not matches:
            return None
        return EncodedBatch(matches, self.rating_config, bucket_rows=True,
                            device=self.device)

    def process(self, ids: list[str]) -> list[str]:
        """Rates one batch of match ids. Pure until the final write-back:
        an exception anywhere leaves objects and state untouched."""
        from analyzer_tpu_torch.service.columnar import finalize

        tracer = get_tracer()
        with tracer.span("batch.encode", cat="worker", ids=len(ids)):
            enc = self._encode_batch(ids)
        n = len(enc.matches) if enc is not None else 0
        logger.info("processing batch of %s matches", n)
        self.flight.note_batch(len(ids), n, first_id=ids[0] if ids else None)
        if not n:
            return []
        # Pre-update prior snapshot for the calibration ledger: ONE
        # compact row gather before dispatch, scored after the commit
        # below (obs/quality.py).
        q_prior = (
            self._quality_prior(enc) if self.quality is not None else None
        )
        with tracer.span("batch.pack", cat="worker", matches=n):
            sched = self._bucketed_schedule(enc.stream, enc.state.pad_row)
        with tracer.span(
            "batch.compute", cat="worker", matches=n, steps=sched.n_steps
        ), self.profiler.maybe_capture(
            context={"matches": n, "steps": sched.n_steps}
        ):
            # Collected outputs come back to the host inside, so the span
            # closes only once the device has finished the batch.
            final_state, outs = rate_history(
                enc.state, sched, self.rating_config, collect=True,
                steps_per_chunk=self._step_chunk,
            )
        # Transactional stores (SqlStore) flush in one commit, rolling
        # back internally on error (worker.py:194-199); the in-memory
        # store's objects ARE the store, nothing to flush beyond
        # write_back's mutations.
        with tracer.span("batch.commit", cat="worker", matches=n):
            finalize(self.store, enc, outs)
        # The commit boundary IS the view publish boundary: readers of
        # the serving plane see this batch's posteriors only once the
        # store does (no-op without serve_port).
        self._publish_view(enc, final_state.table)
        if q_prior is not None:
            self._score_quality(q_prior)
        self.matches_rated += n
        self.batches_ok += 1
        logger.info(
            "batch rated: %d matches (%.1f matches/s since start)",
            n, self.matches_per_sec,
        )
        return [
            m if isinstance(m, str) else m.api_id for m in enc.matches
        ]

    def _quality_prior(self, enc) -> tuple | None:
        """The calibration ledger's input: the batch's PRE-update rows in
        one compact gather (only the rows its matches reference, on the
        host) and host views of its stream, re-indexed into that gather
        (empty slots stay -1). Never raises — the quality plane is an
        observer and must not take down the consume loop."""
        try:
            idx = np.asarray(enc.stream.player_idx)
            rows = np.unique(idx[idx >= 0])
            table = enc.state.table[
                torch.from_numpy(rows.astype(np.int64)).to(enc.state.table.device)
            ].cpu().numpy()
            compact = np.where(idx >= 0, np.searchsorted(rows, idx), -1)
            return (
                table,
                compact,
                np.asarray(enc.stream.winner),
                np.asarray(enc.stream.mode_id),
                np.asarray(enc.stream.afk),
                int(rows.size),  # past every compact row: no slot is padding
            )
        except Exception:  # noqa: BLE001 — observer plane
            logger.exception("quality prior snapshot failed")
            return None

    def _score_quality(self, prior: tuple) -> None:
        """Scores one committed batch against its pre-update priors."""
        try:
            table, idx, winner, mode_id, afk, pad = prior
            self.quality.score_batch(table, idx, winner, mode_id, afk, pad)
        except Exception:  # noqa: BLE001 — observer plane
            logger.exception("quality scoring failed")

    # -- serving plane ----------------------------------------------------
    def _publish_view(self, enc, table) -> None:
        """Publishes one committed batch's posterior rows into the
        serving plane's view (serve/view.py). ``enc`` supplies the
        api-id -> row map (EncodedBatch and ColumnarBatch both expose
        ``row_of``); ``table`` is the batch's FINAL device table (its own
        tensor: no later batch writes it). No-op when serving is off or the batch carried no
        players (_EmptyBatch). Never raises: a read-plane publish
        failure must not dead-letter a successfully committed batch."""
        if self.view_publisher is None:
            return
        row_of = getattr(enc, "row_of", None)
        if not row_of:
            return
        try:
            ids = [None] * len(row_of)
            for pid, row in row_of.items():
                ids[row] = pid
            rows = table[: len(ids)].detach().cpu().numpy()
            view = self.view_publisher.publish_rows(ids, rows)
            if tracectx.tracing_enabled():
                # The served-visible anchor of the causal chain: the bound
                # batch trace rides in via args (the commit came first).
                get_tracer().instant(
                    "view.publish", cat="trace",
                    version=view.version, players=view.n_players,
                )
            logger.debug(
                "published ratings view v%d (%d players)",
                view.version, view.n_players,
            )
        except Exception:  # noqa: BLE001 — the write plane must not fail
            # because the read plane could not take the update.
            logger.exception("ratings view publish failed")

    def _serve_view_health(self) -> tuple[bool, str]:
        """obsd readiness probe: green once a view has been published."""
        view = self.view_publisher.current()
        if view is None:
            return False, "no ratings view published yet"
        return True, f"view v{view.version} ({view.n_players} players)"

    # -- observability ----------------------------------------------------
    def _pipeline_health(self) -> tuple[bool, str]:
        """Readiness probe: a degraded pipelined worker still serves (the
        sequential loop rates correctly) but at lower throughput — a load
        balancer should stop preferring it, which is exactly what a 503
        readiness means."""
        if self.pipeline_degraded:
            return False, "pipeline degraded: sequential fallback active"
        if self.pipeline_enabled:
            return True, "pipelined"
        return True, "sequential by config"

    def _flight_dump(self, reason: str, force: bool = False) -> str | None:
        """One flight-recorder artifact for a failure path. Never raises
        (obs/flight.py owns the throttle + error swallowing); the config
        capture rides along so the artifact explains the worker's knobs,
        and the device profiler's capture info names the torch.profiler
        directory when one is armed. Returns the artifact path (None when
        unarmed or throttled) — obsd's /debug/flight reports it."""
        return self.flight.dump(
            reason, config=dataclasses.asdict(self.config), force=force,
            profile=self.profiler.capture_info(),
        )

    def _on_sigusr1(self, *_args) -> None:
        """SIGUSR1: dump + stats WITHOUT stopping. Runs on the main thread
        between bytecodes (Python signal semantics), so the file IO here
        cannot interleave with a batch mid-commit."""
        logger.info("SIGUSR1: %s", self.stats())
        self._flight_dump("sigusr1", force=True)

    def _on_sigusr2(self, *_args) -> None:
        """SIGUSR2: request a device-profiler capture of the NEXT batch's
        dispatch window (no-op + a log line when no profile dir is armed).
        Force-bypasses the throttle — an operator asking twice means it."""
        if not self.profiler.armed:
            logger.info(
                "SIGUSR2: no profile dir armed (--profile-dir / "
                "ANALYZER_TPU_PROFILE_DIR); ignoring capture request"
            )
            return
        self.profiler.request("sigusr2", force=True)

    def _final_snapshot(self) -> None:
        """The graceful-shutdown snapshot: written into the flight
        recorder's directory (no-op when none is configured — tests and
        embedded workers must not litter their cwd)."""
        base = self.flight.base_dir
        if base is None:
            return
        from analyzer_tpu_torch.obs import write_snapshot

        try:
            os.makedirs(base, exist_ok=True)
            path = os.path.join(base, f"final-snapshot-{os.getpid()}.json")
            write_snapshot(path)
            logger.info("final metrics snapshot written to %s", path)
        except Exception:  # noqa: BLE001 — shutdown must complete regardless
            logger.exception("final snapshot failed")

    @property
    def matches_per_sec(self) -> float:
        dt = self.clock() - self._started_at
        return self.matches_rated / dt if dt > 0 else 0.0

    def stats(self) -> dict:
        """One operator-facing snapshot of the counters the reference
        never had (SURVEY.md section 5.5: its only observability was
        debug logs): throughput, failure counts, and the pipelined
        lane's health — ready for a metrics scraper or a periodic log
        line. Since the obs subsystem landed this is a VIEW over the
        registry-mirrored counters (the counting sites moved there); it
        also pushes the worker's current gauges, so a snapshot taken
        right after ``stats()`` carries the same picture.
        ``tests/test_service.py::TestStats`` pins the key schema — a
        dropped key here silently breaks a metrics scraper. The
        ``migration`` block is None until a backfill has run in this
        process (:meth:`_migration_block`); the ``fabric`` block is None
        until the fabric is ported (ROADMAP A15b); ``slo`` is the SLO plane's digest
        (None with ``slo_plane=False``) and ``quality`` the calibration
        ledger's (None with ``quality=False``)."""
        # The engine is built lazily at the first flush, but the lag is
        # already resolved (warmup probe / pinned config) — report it
        # whenever pipelined mode is on, None only when it's off.
        lag = (
            self._engine.lag if self._engine is not None
            else (self.resolved_pipeline_lag()
                  if self.pipeline_enabled else None)
        )
        reg = get_registry()
        reg.gauge("worker.pipeline_lag").set(lag)
        reg.gauge("worker.pipeline_degraded").set(self.pipeline_degraded)
        reg.gauge("worker.matches_per_sec").set(round(self.matches_per_sec, 1))
        return {
            "matches_rated": self.matches_rated,
            "batches_ok": self.batches_ok,
            "batches_failed": self.batches_failed,
            "dead_letters": self.dead_letters,
            "matches_per_sec": round(self.matches_per_sec, 1),
            "pipeline_enabled": self.pipeline_enabled,
            "pipeline_degraded": self.pipeline_degraded,
            "pipeline_engine_failures": self.pipeline_engine_failures,
            "pipeline_lag": lag,
            # The same number under the name the engine resolves it by —
            # operators correlate this against PIPELINE_LAG/probe logs.
            "resolved_pipeline_lag": lag,
            "measured_rtt_ms": (
                round(self.measured_rtt_s * 1e3, 1)
                if self.measured_rtt_s is not None else None
            ),
            "measured_host_ms": (
                round(self.measured_host_s * 1e3, 1)
                if self.measured_host_s is not None else None
            ),
            # The serving plane's keys ride along even when serving is
            # off (None) — scrapers key on presence, not worker flavor.
            "serve": (
                self.query_engine.stats()
                if self.query_engine is not None else None
            ),
            # The migration block: None until a backfill has run in this
            # process (the progress record's phase leaves "idle").
            "migration": self._migration_block(),
            # The live SLO plane's digest (None when slo_plane=False):
            # what's burning, plus the shadow audit's counters when
            # auditing is on — /sloz and /historyz carry the detail.
            "slo": (
                {
                    "burning": self.watchdog.burning,
                    "history_samples": self.history.samples,
                    "audit": (
                        self.auditor.stats()
                        if self.auditor is not None else None
                    ),
                }
                if self.watchdog is not None else None
            ),
            # The rating-quality plane's digest: scored matches, running
            # Brier / ECE, drift PSI (obs/quality.py).
            "quality": (
                self.quality.stats() if self.quality is not None else None
            ),
            # Fabric membership: None until ROADMAP A15b ports the fabric
            # (the JAX worker reports None off-fabric).
            "fabric": None,
        }

    def _migration_block(self) -> dict | None:
        """The ``stats()['migration']`` block: the process-wide migration
        progress record, with the ETA derived from THIS worker's history
        rings and clock (virtual under the soak). None when no migration
        has run — scrapers key on presence, not on worker flavor."""
        from analyzer_tpu_torch.migrate.progress import get_migration_progress

        return get_migration_progress().snapshot(
            history=self.history, now=self.clock()
        )

    @property
    def pipeline_degraded(self) -> bool:
        """True while a pipeline-configured worker is routing batches
        through the sequential loop — a permanent clone refusal flipped
        ``pipeline_enabled`` off, or a transient engine-construction
        failure is inside its retry window. False before the first flush
        (the engine is built lazily) and in sequential-by-config
        workers. A metrics surface for the state ADVICE r4 flagged as
        one-log-line-and-silent."""
        return self._pipeline_requested and (
            not self.pipeline_enabled or self._engine_retry_at is not None
        )


def requeue_failed(
    broker, config: "ServiceConfig",
    empty_polls: int = 5, poll_interval: float = 0.2,
    sleep=time.sleep,
) -> int:
    """Redrives every dead-lettered message from ``<QUEUE>_failed`` back
    onto the main queue, headers intact. Returns the count.

    The operational complement to the failure policy: after fixing the
    cause (schema, upstream data, a poison record), the reference's
    operators had to shovel `analyze_failed` back by hand with broker
    tooling; here it is one command (`cli worker --requeue-failed`).

    Broker realities this respects:
      * both queues are declared first — subscribing to a missing queue
        404s a real channel, and publishing to a missing main queue
        would silently DROP the redriven messages;
      * a push-consumer broker (the pika adapter) returns empty from its
        first non-blocking polls while the server's deliveries are in
        flight, so the drain only stops after ``empty_polls`` CONSECUTIVE
        empty polls ``poll_interval`` apart;
      * delivery is at-least-once: each message re-publishes BEFORE its
        ack, so a crash or connection blip mid-drain can duplicate up to
        one prefetch window, never lose — and rating is idempotent per
        match (a re-rate writes the same posteriors)."""
    broker.declare_queue(config.queue)
    broker.declare_queue(config.failed_queue)
    moved = 0
    empties = 0
    while empties < empty_polls:
        batch = broker.get(config.failed_queue, 100)
        if not batch:
            empties += 1
            sleep(poll_interval)
            continue
        empties = 0
        for msg in batch:
            broker.publish(config.queue, msg.body, msg.headers)
            broker.ack(msg.delivery_tag)
            moved += 1
    logger.info(
        "requeued %d dead-lettered message(s) %s -> %s",
        moved, config.failed_queue, config.queue,
    )
    return moved


def main(
    max_flushes: int | None = None,
    obs_port: int | None = None,
    flight_dir: str | None = None,
    serve_port: int | None = None,
    serve_shards: int | None = None,
    profile_dir: str | None = None,
    audit: bool | None = None,
    slo_plane: bool = True,
    device=None,
    obs_host: str | None = None,
    audit_sample_denom: int | None = None,
) -> Worker:
    """``python -m analyzer_tpu_torch.service.worker`` — the reference's
    ``python3 worker.py`` entry point (``worker.py:219-221``), requiring a
    live RabbitMQ (pika installed) to be useful. Embedded/in-process use
    goes through ``Worker(InMemoryBroker(), InMemoryStore())`` instead.
    ``max_flushes`` bounds the consume loop (tests; None = forever like
    the reference's ``start_consuming``; bounded runs get a 60 s
    wall-clock deadline so they fail loudly rather than spin). Returns
    the Worker for inspection after a bounded run.

    ``obs_port`` (or ``ANALYZER_TPU_OBS_PORT``) starts obsd on
    ``obs_host``; ``flight_dir`` (or ``ANALYZER_TPU_FLIGHT_DIR``) arms
    flight-recorder dumps; ``serve_port`` (or ``ANALYZER_TPU_SERVE_PORT``)
    co-hosts the ratesrv query plane; ``profile_dir`` (or
    ``ANALYZER_TPU_PROFILE_DIR``) arms on-demand ``torch.profiler`` capture
    windows — SIGUSR2, automatic on dead-letter/degradation/SLO burn;
    ``audit`` (or ``ANALYZER_TPU_AUDIT=1``) turns on the continuous shadow
    audit of 1 in ``audit_sample_denom`` served queries against the
    bit-exact oracle; ``slo_plane=False`` disables the history sampler +
    SLO watchdog + audit entirely; ``device`` is where batches are rated
    (None = the card); ``serve_shards`` (or ``ANALYZER_TPU_SERVE_SHARDS``)
    > 1 serves through the sharded plane."""
    config = ServiceConfig.from_env()
    if obs_port is None and os.environ.get("ANALYZER_TPU_OBS_PORT"):
        obs_port = int(os.environ["ANALYZER_TPU_OBS_PORT"])
    if serve_port is None and os.environ.get("ANALYZER_TPU_SERVE_PORT"):
        serve_port = int(os.environ["ANALYZER_TPU_SERVE_PORT"])
    if serve_shards is None and os.environ.get("ANALYZER_TPU_SERVE_SHARDS"):
        serve_shards = int(os.environ["ANALYZER_TPU_SERVE_SHARDS"])
    flight_dir = flight_dir or os.environ.get("ANALYZER_TPU_FLIGHT_DIR")
    profile_dir = profile_dir or os.environ.get("ANALYZER_TPU_PROFILE_DIR")
    if audit is None and os.environ.get("ANALYZER_TPU_AUDIT", "") not in ("", "0"):
        audit = True
    device = resolve_device(device)
    from analyzer_tpu_torch.service.broker import make_pika_broker

    # Sequential mode: prefetch_count=BATCHSIZE bounds in-flight messages
    # exactly like the reference (worker.py:91). Pipelined mode widens it
    # to cover the in-flight window — the pipeline defers acks until a
    # batch's commit is harvested, and a one-batch bound would make the
    # broker withhold batch N+1 until batch N fully acked, serializing
    # the loop back to sequential (ServiceConfig.prefetch_count).
    broker = make_pika_broker(
        config.rabbitmq_uri, prefetch=config.prefetch_count
    )
    if config.database_uri:
        from analyzer_tpu_torch.service.sql_store import SqlStore

        store = SqlStore(config.database_uri, chunk_size=config.chunk_size)
    else:
        from analyzer_tpu_torch.service.store import InMemoryStore

        store = InMemoryStore()
    worker = Worker(
        broker, store, config, obs_port=obs_port, obs_host=obs_host,
        flight_dir=flight_dir, serve_port=serve_port,
        serve_shards=serve_shards, profile_dir=profile_dir, audit=audit,
        audit_sample_denom=audit_sample_denom, slo_plane=slo_plane,
        device=device,
    )
    worker.warmup()  # first touch of the device before consuming
    try:
        worker.run(
            max_flushes=max_flushes,
            max_wall_s=None if max_flushes is None else 60.0,
            # Production loop: SIGTERM/SIGINT finish the in-flight batch
            # (commit + acks) before exiting; bounded test runs skip the
            # handler install (may run off the main thread).
            install_signal_handlers=max_flushes is None,
        )
    finally:
        worker.close()  # writer thread + cloned store connection
    return worker


if __name__ == "__main__":
    main()
