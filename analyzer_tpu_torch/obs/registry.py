"""Process-wide metrics registry: counters, gauges, histograms.

The port's own copy of ``analyzer_tpu.obs.registry`` (stdlib only): the
same instruments, series keys, cardinality cap and snapshot shape, with the
pre-declared schema cut to the families the port emits — the tiered
table's ``tier.*``, the serve plane's ``serve.*`` (integer counters that
the parity tests hold equal to the JAX package's on the same schedule),
the service shell's ``worker.*`` and ``broker.*`` under the JAX names, and
the SQL store's native-scanner counters ``sql.*`` (the port's own), and
the rating path's ``sched.*``, ``feed.*``, ``device.*``, ``profile.*`` and
``phase_seconds`` families (the runners, the prefetching feed, the
device-memory sampler, the profile attribution, ``utils.profiling``), and
the ingest plane's ``ingest.*`` (the columnar decoder, the staging arena),
the fused window's ``fused.*``, the data-parallel mesh's ``mesh.*``, and
the live planes' ``history.*``,
``slo.*``, ``audit.*``, ``fleet.*`` and ``obs.flight_dumps_total``
(``jax.retraces_total`` is declared under the JAX name and stays 0:
nothing in the port is jitted, and an SLO objective names it). The
JAX package has no ``pipeline.*`` series: its pipelined engine reports
through the ``worker.pipeline_*`` gauges, and so does the port's.

Design constraints, in order:

  * **stdlib only** — the registry is imported by the scheduler and the
    serve plane and must stay light;
  * **cheap on the hot path** — a counter add is one lock acquire and one
    float add; a histogram observation appends to a bounded deterministic
    reservoir (no RNG, no allocation churn);
  * **one process-wide instance** — instruments are identified by
    ``name{label=value,...}`` exactly like Prometheus series, so two call
    sites asking for the same (name, labels) share one instrument, and a
    scraper or a ``--metrics-out`` snapshot sees the whole process.

The registry pre-declares the operator-facing schema
(:data:`STANDARD_COUNTERS` / :data:`STANDARD_GAUGES`) so every snapshot
carries the full key set even before the first event: a dashboard reading
``tier.misses_total`` gets 0, not a missing series that is
indistinguishable from a broken scrape.
"""

from __future__ import annotations

import threading
import time


def _series_key(name: str, labels: dict | None) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter. ``rate()`` is anchored at the FIRST sample, not
    construction — a long-lived process whose counter starts moving late
    reports the rate over its active window (the Counters.rate bug this
    replaces measured decaying rates on long-lived workers)."""

    __slots__ = ("_lock", "_value", "_first_at", "_last_at")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._first_at: float | None = None
        self._last_at: float | None = None

    def add(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        now = time.perf_counter()
        with self._lock:
            if self._first_at is None:
                self._first_at = now
            self._last_at = now
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def rate(self) -> float:
        """Events per second over the first-sample -> now window."""
        with self._lock:
            if self._first_at is None:
                return 0.0
            dt = time.perf_counter() - self._first_at
            return self._value / dt if dt > 0 else 0.0


class Gauge:
    """Last-write-wins scalar. Values may be bool/int/float/None; the
    snapshot passes them through, the Prometheus exposition coerces
    (True -> 1, None -> skipped)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, initial=0) -> None:
        self._lock = threading.Lock()
        self._value = initial

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value = (self._value or 0) + n

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Streaming distribution with count/sum/min/max and quantiles from a
    DETERMINISTIC decimating reservoir: every ``stride``-th observation is
    kept; when the reservoir hits ``max_samples`` it is halved (even
    indices survive) and the stride doubles. The kept set is an evenly
    spaced subsample of the stream — quantiles are exact for short runs
    and an unbiased-in-time sketch for long ones — with no RNG (results
    are reproducible) and bounded memory."""

    __slots__ = ("_lock", "count", "sum", "min", "max",
                 "_samples", "_stride", "_skip", "_max_samples")

    def __init__(self, max_samples: int = 512) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._samples: list[float] = []
        self._stride = 1
        self._skip = 0
        self._max_samples = max_samples

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._skip += 1
            if self._skip >= self._stride:
                self._skip = 0
                self._samples.append(v)
                if len(self._samples) >= self._max_samples:
                    self._samples = self._samples[::2]
                    self._stride *= 2

    def quantile(self, q: float) -> float | None:
        with self._lock:
            if not self._samples:
                return None
            s = sorted(self._samples)
            i = min(len(s) - 1, max(0, round(q * (len(s) - 1))))
            return s[i]

    def summary(self) -> dict:
        """JSON-ready: count/sum/mean/min/max + p50/p90/p99."""
        with self._lock:
            samples = sorted(self._samples)
            count, total = self.count, self.sum
            lo, hi = self.min, self.max

        def pick(q):
            if not samples:
                return None
            return samples[min(len(samples) - 1, max(0, round(q * (len(samples) - 1))))]

        return {
            "count": count,
            "sum": round(total, 6),
            "mean": round(total / count, 6) if count else None,
            "min": lo,
            "max": hi,
            "p50": pick(0.50),
            "p90": pick(0.90),
            "p99": pick(0.99),
        }


#: Operator-facing series every snapshot must carry, observed or not.
STANDARD_COUNTERS = (
    # The tiered ratings table (sched/tier.py): touched-row hits against
    # the device hot set vs misses that promoted from the host cold tier,
    # LRU demotions, the dirty subset written back to the host, and window
    # splits forced by a hot set smaller than one window's touched rows.
    # Pre-declared so an untiered run reads 0, not missing.
    "tier.hits_total",
    "tier.misses_total",
    "tier.promotions_total",
    "tier.demotions_total",
    "tier.dirty_writebacks_total",
    "tier.spills_total",
    # The data-parallel mesh (parallel/mesh.py): host arrays put to the
    # mesh per window (the same arrays, bytes and calls as the JAX
    # package's _put_global), and the scatter rows a per-shard fused
    # working set would have saved on its compacted row lists.
    "mesh.put_bytes_total",
    "mesh.puts_total",
    "mesh.writebacks_avoidable_total",
    # Series the registry REFUSED to create because a label family hit
    # its cardinality cap (MAX_LABEL_VALUES): the canary for a label
    # minted from an unbounded value (queue names, player ids).
    "obs.dropped_series_total",
    "serve.queries_total",
    "serve.view_publishes_total",
    # The query engine's per-version result caches (serve/engine.py).
    "serve.leaderboard_cache_hits_total",
    "serve.tier_cache_hits_total",
    # Host-to-device bytes the publish path moved (the patch-vs-rebuild
    # pin).
    "serve.view_publish_bytes_total",
    # The sharded serve plane (serve/view.py + serve/engine.py): routed
    # per-shard query traffic (serve.shard.queries_total{shard=} series
    # appear on first sample; the base is pre-declared), and the
    # distributed top-k's host merges and candidate volume. Pre-declared
    # so a single-device plane reads 0, not missing.
    "serve.shard.queries_total",
    "serve.shard.merges_total",
    "serve.shard.merge_candidates_total",
    # Lineage cutovers and follower adoptions (serve/view.py).
    "serve.view_cutovers_total",
    "serve.view_adoptions_total",
    # The serve front door (serve/frontdoor.py): requests answered across
    # all reader loops, response bytes rendered (native codec + counted
    # python fallbacks), and keep-alive connection reuses saved by the
    # pooled HTTP client (obs/httpd.py PooledHTTPClient). Pre-declared so
    # a process without a front door reads 0.
    "frontdoor.requests_total",
    "frontdoor.encode_bytes_total",
    "frontdoor.codec_fallbacks_total",
    "frontdoor.pool_reuse_total",
    # The partitioned broker's priority lanes (service/broker.py):
    # backfill messages admitted behind live traffic, and messages the
    # admission controller held back for host headroom.
    "broker.backfill_admitted_total",
    "broker.backfill_throttled_total",
    # The service worker (service/worker.py): the reference's only
    # output was debug logs; these are its operator counters.
    "worker.matches_rated_total",
    "worker.batches_ok_total",
    "worker.batches_failed_total",
    "worker.dead_letters_total",
    "worker.acks_total",
    "worker.pipeline_degradations_total",
    "worker.pipeline_engine_failures_total",
    # The SQL store's native columnar scanner (service/csrc/fastsql.cc):
    # scans it served, and falls back to the python scans (a build or
    # load failure, or a failed scan). A run that meant to use the
    # scanner reads nonzero scans and zero fallbacks.
    "sql.native_scans_total",
    "sql.native_fallbacks_total",
    # The schedule and its runners (sched/superstep.py, sched/runner.py):
    # slots filled with the pad row, and supersteps dispatched.
    # sched.pad_steps_total counts the JAX package's step bucketing
    # (``pad_to_steps``), which the port does not do: it stays 0 here.
    "sched.pad_steps_total",
    "sched.pad_slots_total",
    "sched.steps_total",
    # The prefetching feed (sched/feed.py): starved = the consumer outran
    # the feed (host-bound), backpressure = the feed outran the consumer.
    # Pre-declared so "feed never starved" reads as 0, not as a missing
    # series.
    "feed.starved_total",
    "feed.backpressure_total",
    # Profile attribution (obs/profview.py): capture dirs whose device
    # trace parsed end to end.
    "profile.captures_parsed_total",
    # The wire-speed ingest plane (io/ingest.py + sched/feed.py arena):
    # columnar windows decoded (bytes/rows/windows), streams the fast
    # path refused (quoted grammar / no native scanner), arena slab
    # allocations vs freelist reuses (their ratio is the hit rate), and
    # H2D commits off the arena.
    "ingest.bytes_decoded_total",
    "ingest.rows_decoded_total",
    "ingest.windows_total",
    "ingest.fallbacks_total",
    "ingest.arena_allocs_total",
    "ingest.arena_reuses_total",
    "ingest.h2d_commits_total",
    # Rating-state snapshots (io/checkpoint.py): snapshots taken, those a
    # newer one replaced on the asynchronous writer before they were
    # written (latest wins), and the bytes of the files renamed into place.
    "checkpoint.snapshots_total",
    "checkpoint.superseded_total",
    "checkpoint.bytes_written_total",
    # The rating-quality plane (obs/quality.py): matches scored against
    # their pre-update predicted win probability, the streaming
    # Brier/log-loss sums and the per-bin reliability counts
    # (quality.bin_count{bin=} / bin_p_sum{bin=} / bin_y_sum{bin=}
    # labeled series appear on first score). Counters, so a windowed ECE
    # is exact from deltas; pre-declared so "nothing scored" reads 0.
    "quality.matches_scored_total",
    "quality.brier_sum",
    "quality.logloss_sum",
    "quality.bin_count",
    "quality.bin_p_sum",
    "quality.bin_y_sum",
    # The fused window's feed (sched/runner.py): windows dispatched (one
    # fused_window launch each on the card), working-set budget cuts, the
    # per-step scatter rows fusion eliminated, and the inert padding steps
    # spills cost. Pre-declared so "never spilled" reads 0.
    "fused.windows_total",
    "fused.spills_total",
    "fused.writebacks_avoided_total",
    "fused.pad_steps_total",
    # The JAX package's retrace counter, kept at 0: nothing in the port is
    # jitted, and the flat-steady-retraces objective (obs/slo.py) names it.
    "jax.retraces_total",
    "obs.flight_dumps_total",
    # The live SLO plane (obs/history.py + obs/slo.py + obs/audit.py):
    # history-ring samples taken, SLO burn onsets and recoveries seen by
    # the watchdog, and the shadow audit's sampled / oracle-replayed /
    # DIVERGED query counts — audit.mismatches_total is the zero-tolerance
    # objective (zero-audit-mismatches): one increment is a correctness
    # incident.
    "history.samples_total",
    "slo.burns_total",
    "slo.recoveries_total",
    "audit.sampled_total",
    "audit.checked_total",
    "audit.mismatches_total",
    # The fleet observability plane (obs/federate.py): Collector scrape
    # rounds, per-host scrape failures, fleet-scope SLO burn onsets and
    # recoveries over the merged rings, and flight dumps the Collector
    # requested from a burning host via its /debug/flight trigger.
    "fleet.scrapes_total",
    "fleet.scrape_errors_total",
    "fleet.burns_total",
    "fleet.recoveries_total",
    "fleet.flight_requests_total",
)
STANDARD_GAUGES = (
    # The tiered table's two budget gauges: the hot-set capacity in rows
    # (pow2-bucketed from hot_rows) and the cold tier's committed host
    # bytes.
    "tier.hot_rows",
    "tier.host_bytes",
    # The serving plane (serve/view.py, serve/engine.py): 0 until the
    # first publish — a scraper can tell "no read plane" from "broken".
    "serve.view_version",
    "serve.view_age_seconds",
    # Shard count of the sharded serve plane (0 = single-device).
    "serve.shards",
    # The pipelined consume loop (service/pipeline.py): its resolved
    # commit lag, batches in flight past the last commit, whether the
    # worker fell back to the sequential loop, and throughput.
    "worker.pipeline_lag",
    "worker.pipeline_degraded",
    "worker.pipeline_inflight",
    "worker.matches_per_sec",
    # Ready depth of the consume queue (labeled broker.queue_depth{queue=}
    # series appear on first sample).
    "broker.queue_depth",
    # Partition count of the partitioned broker (1 = single queue).
    "broker.partitions",
    # Open sockets across the front door's reader loops.
    "frontdoor.connections",
    # Slot occupancy of the last rated schedule (sched/runner.py).
    "sched.occupancy",
    # Ring occupancy of the prefetching feed after the last put/get
    # (sched/feed.py): steady 0 on a busy run = host-bound.
    "feed.depth",
    # Per-device series (device.hbm_bytes_in_use{device=...}) appear on
    # first sample (obs/devicemem.py); the process total is pre-declared.
    "device.live_buffers",
    # Device-idle fraction of the last attributed capture window
    # (obs/profview.py).
    "profile.device_idle_frac",
    # The ingest staging arena's resident bytes (sched/feed.py
    # PinnedArena — decode slabs + the tiered table's cold tier).
    "ingest.arena_bytes",
    # The rating-quality plane's derived running means (the counters are
    # the source of truth) and the population-drift PSI.
    "quality.brier",
    "quality.ece",
    "quality.psi_mu",
    # Fused working-set high-water mark in table rows.
    "fused.working_set_rows",
    # The live SLO plane: series the history sampler tracks, objectives
    # currently burning (0 = healthy), per-objective burn state
    # (slo.state{objective=} series appear on first transition), and the
    # shadow audit's pending replay backlog.
    "history.series",
    "slo.burning",
    "slo.state",
    "audit.backlog",
    # The fleet plane's topology gauges (obs/federate.py): scraped
    # targets, targets refused past the host cap, objectives burning at
    # FLEET scope, and the fleet history's tracked series. Per-host
    # fleet.host_up{host=} series appear on first scrape.
    "fleet.hosts",
    "fleet.hosts_dropped",
    "fleet.host_up",
    "fleet.burning",
    "fleet.series",
)

#: Histogram families the runtime emits (labeled series like
#: ``serve.microbatch_occupancy{kind=}`` count as one family).
STANDARD_HISTOGRAMS = (
    "phase_seconds",
    "sched.pack_occupancy",
    "serve.microbatch_occupancy",
)

#: The span name catalog: every runtime-emitted trace-event name.
SPAN_CATALOG = (
    # worker / pipeline batch lifecycle
    "batch.lifecycle",
    "batch.encode",
    "batch.pack",
    "batch.chain",
    "batch.dispatch",
    "batch.compute",
    "batch.fetch",
    "batch.write_back",
    "batch.commit",
    # the prefetching feed: staging (producer thread) and the slab's copy
    # to the device (the consumer thread in the port)
    "feed.materialize",
    "feed.transfer",
    # the port's own split of the staging (nested in feed.materialize) and
    # its three waits: the ring's two and the stream feed's on the assigner
    "feed.gather",
    "feed.plan",
    "feed.pack",
    "feed.starved",
    "feed.backpressure",
    "feed.wait_assign",
    # the tiered table's promotion/demotion traffic
    "tier.promote",
    "tier.demote",
    # worker instants
    "worker.dead_letter",
    "worker.pipeline_degraded",
    # causal tracing (obs/tracectx.py): enqueue anchor, batch join,
    # serve-visible publish
    "trace.enqueue",
    "batch.assemble",
    "view.publish",
    # the wire-speed ingest plane: one columnar window's decode into an
    # arena slab, and its H2D commit off that slab
    "ingest.decode",
    "ingest.commit",
    # the migration (migrate/engine.py, migrate/lineage.py): a run's set-up,
    # an assignment window of the front half, a snapshot the consumer
    # takes, the final staging publish and the cutover; and a snapshot's
    # serialize and rename (io/checkpoint.py)
    "migrate.prepare",
    "migrate.assign",
    "migrate.checkpoint",
    "migrate.publish",
    "migrate.cutover",
    "checkpoint.write",
)

#: Distinct labeled series allowed per family (base metric name) before
#: the registry refuses to mint more. An unbounded label value (player
#: ids, per-request tokens) would otherwise grow the registry — and
#: every snapshot, scrape and flight dump serializing it — forever.
MAX_LABEL_VALUES = 256

#: Label KEYS reserved for a fleet collector that merges every scraped
#: process's series under ``host=<target>``: a process minting its own
#: ``host=``/``fleet=`` label would collide with the federated view.
RESERVED_LABELS = ("host", "fleet")

#: Operator-facing help text per schema family — the ``# HELP`` line of
#: a Prometheus exposition. Families not listed here (runtime-minted,
#: tests) fall back to a generic line via :func:`schema_help`.
SCHEMA_HELP = {
    "tier.hits_total": "touched rows found in the device hot set",
    "tier.misses_total": "touched rows promoted from the host cold tier",
    "tier.promotions_total": "cold-to-hot row promotions",
    "tier.demotions_total": "hot-set LRU demotions",
    "tier.dirty_writebacks_total": "dirty rows written back to the cold tier",
    "tier.spills_total": "window cuts forced by an over-budget working set",
    "tier.hot_rows": "hot-set capacity in table rows",
    "tier.host_bytes": "cold tier's committed host bytes",
    "mesh.put_bytes_total": "bytes moved by mesh global puts",
    "mesh.puts_total": "mesh global put calls",
    "mesh.writebacks_avoidable_total":
        "scatter rows a per-shard fused working set would have saved",
    "obs.dropped_series_total":
        "series mints refused by the label-cardinality cap",
    "serve.queries_total": "queries answered by the serving plane",
    "serve.view_publishes_total": "ratings-view versions published",
    "serve.leaderboard_cache_hits_total":
        "leaderboard answers served from the version-keyed cache",
    "serve.tier_cache_hits_total":
        "tier-histogram answers served from the version-keyed cache",
    "serve.view_publish_bytes_total":
        "host-to-device bytes moved by view publishes",
    "serve.shard.queries_total": "queries routed to per-shard microbatches",
    "serve.shard.merges_total": "cross-shard top-k host merges",
    "serve.shard.merge_candidates_total": "candidates fed into shard merges",
    "serve.view_cutovers_total": "atomic dual-lineage view cutovers",
    "serve.view_adoptions_total":
        "leader views adopted by reference into a follower lineage",
    "serve.view_version": "current served view version",
    "serve.view_age_seconds": "seconds since the current view published",
    "serve.shards": "shard count of the serving plane (0 = single)",
    "frontdoor.connections": "open sockets across the front door readers",
    "frontdoor.requests_total": "requests answered by the front door",
    "frontdoor.encode_bytes_total": "response bytes rendered by the codec",
    "frontdoor.codec_fallbacks_total":
        "responses the native codec routed to the python encoder",
    "frontdoor.pool_reuse_total":
        "keep-alive connection reuses by the pooled HTTP client",
    "serve.microbatch_occupancy": "per-tick serve microbatch fill",
    "worker.matches_rated_total": "matches rated and committed by the worker",
    "worker.batches_ok_total": "batches that rated and committed cleanly",
    "worker.batches_failed_total": "batches that hit the failure policy",
    "worker.dead_letters_total": "messages dead-lettered to the failed queue",
    "worker.acks_total": "messages acked after a committed batch",
    "worker.pipeline_degradations_total":
        "permanent fallbacks from the pipelined to the sequential loop",
    "worker.pipeline_engine_failures_total":
        "transient pipelined-engine construction failures (retried)",
    "worker.pipeline_lag": "commit lag (batches) of the pipelined engine",
    "worker.pipeline_degraded": "1 while the sequential fallback is active",
    "worker.pipeline_inflight": "pipelined batches submitted, not harvested",
    "worker.matches_per_sec": "worker throughput since start",
    "broker.queue_depth": "ready messages on the consume queue",
    "broker.partitions": "partition count of the partitioned broker",
    "broker.backfill_admitted_total":
        "backfill messages admitted behind live traffic",
    "broker.backfill_throttled_total":
        "backfill messages held back for host headroom",
    "sql.native_scans_total": "queries served by the native sqlite scanner",
    "sql.native_fallbacks_total":
        "native sqlite scanner unavailable or failed: python scans instead",
    "sched.pad_steps_total": "schedule steps added as padding",
    "sched.pad_slots_total": "schedule slots filled with the pad row",
    "sched.steps_total": "supersteps dispatched by the scan runners",
    "sched.occupancy": "fraction of schedule slots carrying real matches",
    "feed.starved_total": "consumer waits on an empty prefetch ring",
    "feed.backpressure_total": "producer waits on a full prefetch ring",
    "feed.depth": "prefetch-ring occupancy after the last put/get",
    "device.live_buffers": "live device buffers (leak canary)",
    "profile.captures_parsed_total":
        "device-profile capture dirs attributed end-to-end",
    "profile.device_idle_frac":
        "device-idle fraction of the last attributed capture window",
    "phase_seconds": "wall seconds per instrumented phase",
    "sched.pack_occupancy": "per-schedule slot occupancy distribution",
    "ingest.bytes_decoded_total": "bytes decoded by the columnar windows",
    "ingest.rows_decoded_total": "rows decoded by the columnar windows",
    "ingest.windows_total": "columnar decode windows completed",
    "ingest.fallbacks_total": "streams refused by the native fast path",
    "ingest.arena_allocs_total": "pinned-arena slab allocations",
    "ingest.arena_reuses_total": "pinned-arena freelist reuses",
    "ingest.h2d_commits_total": "H2D commits staged off the arena",
    "checkpoint.snapshots_total": "rating-state snapshots taken",
    "checkpoint.superseded_total": "snapshots replaced before they were written",
    "checkpoint.bytes_written_total": "bytes of snapshot files renamed into place",
    "ingest.arena_bytes": "pinned staging arena resident bytes",
    "quality.matches_scored_total":
        "rated matches scored against their pre-update win probability",
    "quality.brier_sum": "running Brier-score sum over scored matches",
    "quality.logloss_sum": "running log-loss sum over scored matches",
    "quality.bin_count": "scored matches per reliability bin",
    "quality.bin_p_sum": "predicted-probability sum per reliability bin",
    "quality.bin_y_sum": "realized-outcome sum per reliability bin",
    "quality.brier": "running mean Brier score (lower = better)",
    "quality.ece": "running expected calibration error (lower = better)",
    "quality.psi_mu":
        "population-stability index of mu vs the pinned reference window",
    "fused.windows_total": "fused working-set windows dispatched",
    "fused.spills_total": "working-set budget window cuts (bulk spills)",
    "fused.writebacks_avoided_total":
        "per-step scatter rows the fused window kernel eliminated",
    "fused.pad_steps_total": "inert padding steps in fused windows",
    "fused.working_set_rows": "fused working-set high-water mark (rows)",
    "jax.retraces_total": "XLA retraces observed by the jit listeners",
    "obs.flight_dumps_total": "flight-recorder artifact dumps written",
    "history.samples_total": "history-ring sampling rounds",
    "history.series": "series tracked by the history sampler",
    "slo.burns_total": "SLO burn onsets seen by the watchdog",
    "slo.recoveries_total": "SLO burn recoveries",
    "slo.burning": "objectives currently burning (0 = healthy)",
    "slo.state": "per-objective burn state (1 = burning)",
    "audit.sampled_total": "served responses sampled by the shadow audit",
    "audit.checked_total": "sampled responses replayed through the oracle",
    "audit.mismatches_total":
        "served responses that DIVERGED from the bit-exact oracle (SLO: 0)",
    "audit.backlog": "sampled responses awaiting oracle replay",
    "fleet.scrapes_total": "Collector scrape rounds across the fleet",
    "fleet.scrape_errors_total": "per-host scrape failures",
    "fleet.burns_total": "fleet-scope SLO burn onsets",
    "fleet.recoveries_total": "fleet-scope SLO burn recoveries",
    "fleet.flight_requests_total":
        "flight dumps requested from burning hosts via /debug/flight",
    "fleet.hosts": "targets the Collector scrapes",
    "fleet.hosts_dropped": "targets refused past the fleet host cap",
    "fleet.host_up": "1 while the host's last scrape succeeded",
    "fleet.burning": "objectives burning at fleet scope",
    "fleet.series": "series tracked by the fleet history rings",
}


def schema_help(name: str) -> str:
    """The ``# HELP`` line body for a series family; a generic pointer
    at the catalog for names outside :data:`SCHEMA_HELP`."""
    return SCHEMA_HELP.get(
        name, f"analyzer_tpu series {name}"
    )


class MetricsRegistry:
    """get-or-create instrument store keyed by ``name{labels}``.

    Label cardinality is CAPPED per family (:data:`MAX_LABEL_VALUES`
    distinct labeled series per base name): past the cap, the registry
    stops minting new series — the overflow traffic lands on one shared
    unregistered instrument per family (call sites keep working, the
    snapshot stops growing) and every refused mint counts into
    ``obs.dropped_series_total``, so the condition is visible instead
    of an unbounded-memory failure mode."""

    def __init__(
        self,
        declare_standard: bool = True,
        max_label_values: int = MAX_LABEL_VALUES,
    ) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self.max_label_values = int(max_label_values)
        # family name -> count of labeled series minted under it.
        self._family_counts: dict[str, int] = {}
        # family name -> the shared post-cap overflow instrument (NOT in
        # the snapshot dicts — it absorbs writes, it is not a series).
        self._overflow: dict[str, object] = {}
        # Created directly (the lock is not re-entrant) and always
        # present: the drop path below increments it under the lock.
        self._dropped = self._counters.setdefault(
            "obs.dropped_series_total", Counter()
        )
        if declare_standard:
            for name in STANDARD_COUNTERS:
                self.counter(name)
            for name in STANDARD_GAUGES:
                self.gauge(name)

    def _get_or_create(self, store: dict, name: str, labels: dict, factory):
        key = _series_key(name, labels)
        with self._lock:
            inst = store.get(key)
            if inst is None:
                if labels:
                    n = self._family_counts.get(name, 0)
                    if n >= self.max_label_values:
                        # Cap hit: count the refusal, route the caller to
                        # the family's shared overflow instrument.
                        self._dropped.add(1)
                        okey = f"{factory.__name__}:{name}"
                        inst = self._overflow.get(okey)
                        if inst is None:
                            inst = self._overflow[okey] = factory()
                        return inst
                    self._family_counts[name] = n + 1
                inst = store[key] = factory()
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(self._counters, name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create(self._gauges, name, labels, Gauge)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get_or_create(self._histograms, name, labels, Histogram)

    def snapshot(self) -> dict:
        """JSON-ready view of every series: counter values, gauge values,
        histogram summaries."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(histograms.items())
            },
        }


_registry_lock = threading.Lock()
_registry: MetricsRegistry | None = None


def get_registry() -> MetricsRegistry:
    """The process-wide registry (created on first use)."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricsRegistry()
        return _registry


def reset_registry() -> MetricsRegistry:
    """Replaces the process-wide registry with a fresh one (tests)."""
    global _registry
    with _registry_lock:
        _registry = MetricsRegistry()
        return _registry
