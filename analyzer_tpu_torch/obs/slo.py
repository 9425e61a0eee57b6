"""Declarative SLO engine: one objective table, two evaluation modes.

The port's own copy of ``analyzer_tpu.obs.slo`` (stdlib only). The table
(:data:`STANDARD_OBJECTIVES`) is the JAX package's field by field, metric
names included — ``flat-steady-retraces`` reads ``jax.retraces_total``,
which the port declares and keeps at 0 (nothing here is jitted) — so a
verdict means the same thing in both packages:

  * **artifact mode** (:func:`soak_violations`) — re-derives a verdict
    from a SOAK artifact's deterministic block, with every check of the
    JAX package (``_check_*``);
  * **live mode** (:func:`evaluate_live`, :class:`Watchdog`) — multi-
    window burn rates over the history rings (:mod:`obs.history`). An
    objective *burns* when every configured window exceeds its
    threshold (the short window gives fast detection, the long window
    keeps a single blip from paging). The :class:`Watchdog` rides the
    worker's poll loop: on a first burn it flips ``/readyz`` degraded
    (via its HealthChecks probe), fires the flight recorder + device
    profiler through its ``on_burn`` hook, and emits ``slo.*`` state
    metrics; recovery is recorded symmetrically.

Clock discipline: like :mod:`obs.history`, this module NEVER reads a
wall clock — ``Watchdog.check(now)`` and every evaluator take the
caller's timestamp, so the engine runs on the worker's clock and the
worker's output is bit-identical with the watchdog on or off.

The calibration objective's threshold and volume floor come from the
port's :data:`obs.quality.QUALITY_TABLE`, the quality plane's one table.
"""

from __future__ import annotations

import dataclasses
import threading

from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs.quality import QUALITY_TABLE as _QUALITY_TABLE
from analyzer_tpu_torch.obs.registry import get_registry

logger = get_logger(__name__)

#: Live evaluation kinds:
#:   counter_zero  any increment over the short window burns
#:                 (zero-tolerance: dead letters, audit mismatches)
#:   counter_rate  events/s above threshold over EVERY window burns
#:   gauge_max     window max above threshold over EVERY window burns
#:   gauge_growth  (last-first)/span above threshold over EVERY window
#:                 burns (the memory-leak burn rate)
#:   ratio_min     metric/(metric+metric_b) delta-ratio over the longest
#:                 window below threshold burns (tier hit-rate floor);
#:                 skipped below ``min_volume`` events
#:   calibration   windowed expected calibration error, computed EXACTLY
#:                 from the labeled ``quality.bin_p_sum{bin=}`` /
#:                 ``bin_y_sum{bin=}`` ring deltas normalized by the
#:                 ``metric`` (scored-matches) delta, above threshold
#:                 over the longest window burns; skipped below
#:                 ``min_volume`` scored matches (obs/quality.py)
#:   artifact      no live half — artifact-mode check only
LIVE_KINDS = (
    "counter_zero", "counter_rate", "gauge_max", "gauge_growth", "ratio_min",
    "calibration",
)


@dataclasses.dataclass(frozen=True)
class Objective:
    """One named service-level objective. ``metric``/``metric_b`` name
    pre-declared STANDARD series (``obs.registry``); ``artifact_check``
    names the deterministic-block check :func:`soak_violations` runs for
    it (None = live-only)."""

    name: str
    kind: str
    metric: str = ""
    threshold: float = 0.0
    windows: tuple = (60.0, 300.0)
    metric_b: str | None = None
    min_volume: float = 0.0
    artifact_check: str | None = None
    description: str = ""


@dataclasses.dataclass(frozen=True)
class Burn:
    """One live evaluation result."""

    objective: str
    burning: bool
    value: float | None
    detail: str


#: THE objective table — the soak SLO table promoted to one shared,
#: declarative set. Artifact checks reproduce the historical
#: ``soak_slo_violations`` semantics verbatim; live halves watch the
#: same conditions as burn rates over the history rings.
STANDARD_OBJECTIVES = (
    Objective(
        "zero-dead-letters", "counter_zero", "worker.dead_letters_total",
        artifact_check="dead_letters",
        description="a dead-lettered match is lost work (SLO: 0)",
    ),
    Objective(
        "flat-steady-retraces", "counter_rate", "jax.retraces_total",
        threshold=0.1, artifact_check="retraces_steady",
        description=(
            "post-warmup XLA retraces mean an unwarmed shape reached "
            "production (live: a sustained storm, not one stray compile)"
        ),
    ),
    Objective(
        "bounded-view-staleness", "gauge_max", "serve.view_age_seconds",
        threshold=30.0, windows=(60.0,), artifact_check="view_staleness",
        description=(
            "served ratings must track commits (artifact: lag ticks; "
            "live: seconds since the last publish)"
        ),
    ),
    Objective(
        "drained-backlog", "artifact", artifact_check="drained",
        description="the soak's backlog must clear in bounded time",
    ),
    Objective(
        "no-lost-work", "artifact", artifact_check="lost_work",
        description="every published match must be rated",
    ),
    Objective(
        "throughput-floor", "artifact", artifact_check="throughput_floor",
        description="optional absolute matches/s floor (slo.thresholds)",
    ),
    Objective(
        "latency-cap", "artifact", artifact_check="latency_cap",
        description="optional absolute serve-p99 cap (slo.thresholds)",
    ),
    Objective(
        "no-forbidden-dominant-stage", "artifact",
        artifact_check="dominant_stage",
        description=(
            "the critical path must not be dominated by a forbidden "
            "stage (requires a traced capture)"
        ),
    ),
    Objective(
        "no-feed-starvation", "counter_rate", "feed.starved_total",
        threshold=1.0,
        description=(
            "a starved device feed means the host is the bottleneck "
            "(docs/observability.md feed section)"
        ),
    ),
    Objective(
        "tier-hit-rate-floor", "ratio_min", "tier.hits_total",
        metric_b="tier.misses_total", threshold=0.5, min_volume=1024.0,
        description=(
            "hot-set hit rate collapse = tier thrash (docs/kernels.md); "
            "evaluated only past min_volume touched rows"
        ),
    ),
    Objective(
        "zero-audit-mismatches", "counter_zero", "audit.mismatches_total",
        artifact_check="audit_mismatches",
        description=(
            "the shadow audit replays served answers through the "
            "bit-exact oracle — one mismatch is a correctness incident "
            "(obs/audit.py)"
        ),
    ),
    Objective(
        "calibration-floor", "calibration", "quality.matches_scored_total",
        threshold=_QUALITY_TABLE["ece_alert"],
        min_volume=float(_QUALITY_TABLE["min_matches"]),
        artifact_check="calibration",
        description=(
            "windowed expected calibration error of served win "
            "probabilities vs realized outcomes — the first MODEL-"
            "QUALITY objective (obs/quality.py); evaluated only past "
            "min_volume scored matches, thresholds shared with the "
            "quality plane's one declared table"
        ),
    ),
    Objective(
        "bounded-memory-growth", "gauge_growth", "device.live_buffers",
        threshold=200.0,
        description=(
            "sustained live-buffer growth across every window is the "
            "leak signature (devicemem rides the history sampler)"
        ),
    ),
)


def _objectives(objectives):
    """None -> the CURRENT module-level table (resolved at call time so
    a test can doctor ``STANDARD_OBJECTIVES`` and see every consumer
    pick the doctored set up)."""
    return STANDARD_OBJECTIVES if objectives is None else tuple(objectives)


# -- live mode -------------------------------------------------------------

def evaluate_live(obj: Objective, history, now: float) -> Burn:
    """One objective's burn state over the history rings at ``now``.
    Insufficient history (young process, metric never sampled) is NOT
    burning — an alarm that fires before there is evidence teaches
    operators to ignore it."""
    if obj.kind == "counter_zero":
        got = history.window_delta(obj.metric, obj.windows[0], now)
        if got is None:
            return Burn(obj.name, False, None, "no history yet")
        delta, span = got
        burning = delta > obj.threshold
        return Burn(
            obj.name, burning, delta,
            f"{obj.metric} +{delta:g} over {span:g}s "
            f"(SLO: <= {obj.threshold:g})",
        )
    if obj.kind == "counter_rate":
        rates = []
        for w in obj.windows:
            got = history.window_delta(obj.metric, w, now)
            if got is None:
                return Burn(obj.name, False, None, "no history yet")
            delta, span = got
            rates.append(delta / span if span > 0 else 0.0)
        burning = all(r > obj.threshold for r in rates)
        return Burn(
            obj.name, burning, max(rates),
            f"{obj.metric} rates "
            + "/".join(f"{r:.3g}/s" for r in rates)
            + f" over {'/'.join(f'{w:g}s' for w in obj.windows)} "
            f"(SLO: <= {obj.threshold:g}/s in some window)",
        )
    if obj.kind == "gauge_max":
        maxima = []
        for w in obj.windows:
            m = history.window_max(obj.metric, w, now)
            if m is None:
                return Burn(obj.name, False, None, "no history yet")
            maxima.append(m)
        burning = all(m > obj.threshold for m in maxima)
        return Burn(
            obj.name, burning, max(maxima),
            f"{obj.metric} max {max(maxima):g} "
            f"(SLO: <= {obj.threshold:g})",
        )
    if obj.kind == "gauge_growth":
        rates = []
        for w in obj.windows:
            got = history.window_growth(obj.metric, w, now)
            if got is None:
                return Burn(obj.name, False, None, "no history yet")
            delta, span = got
            rates.append(delta / span if span > 0 else 0.0)
        burning = all(r > obj.threshold for r in rates)
        return Burn(
            obj.name, burning, max(rates),
            f"{obj.metric} growing "
            + "/".join(f"{r:+.3g}/s" for r in rates)
            + f" (SLO: <= {obj.threshold:g}/s sustained)",
        )
    if obj.kind == "ratio_min":
        w = obj.windows[-1]
        a = history.window_delta(obj.metric, w, now)
        b = history.window_delta(obj.metric_b, w, now)
        if a is None or b is None:
            return Burn(obj.name, False, None, "no history yet")
        hits, misses = a[0], b[0]
        volume = hits + misses
        if volume < obj.min_volume:
            return Burn(
                obj.name, False, None,
                f"below min volume ({volume:g} < {obj.min_volume:g})",
            )
        ratio = hits / volume
        return Burn(
            obj.name, ratio < obj.threshold, ratio,
            f"{obj.metric}/({obj.metric}+{obj.metric_b}) = {ratio:.3f} "
            f"over {w:g}s (SLO: >= {obj.threshold:g})",
        )
    if obj.kind == "calibration":
        # Exact windowed ECE from ring deltas: counters sum, so
        # sum_b |Δbin_p_sum_b - Δbin_y_sum_b| / Δscored IS the ECE of
        # exactly the matches scored inside the window (obs/quality.py
        # ece_from_bins documents the identity). The labeled series
        # appear on first score; a bin with no history contributes no
        # gap, which under-counts only if the ring never sampled it —
        # and the volume guard (from the same deltas) covers that.
        w = obj.windows[-1]
        got = history.window_delta(obj.metric, w, now)
        if got is None:
            return Burn(obj.name, False, None, "no history yet")
        total, span = got
        if total < obj.min_volume:
            return Burn(
                obj.name, False, None,
                f"below min volume ({total:g} < {obj.min_volume:g})",
            )
        gap = 0.0
        for k in range(int(_QUALITY_TABLE["bins"])):
            p = history.window_delta(f"quality.bin_p_sum{{bin={k}}}", w, now)
            y = history.window_delta(f"quality.bin_y_sum{{bin={k}}}", w, now)
            if p is not None and y is not None:
                gap += abs(p[0] - y[0])
        ece = gap / total
        return Burn(
            obj.name, ece > obj.threshold, ece,
            f"windowed ece {ece:.3f} over {total:g} matches / {w:g}s "
            f"(SLO: <= {obj.threshold:g})",
        )
    return Burn(obj.name, False, None, f"artifact-only ({obj.kind})")


class Watchdog:
    """The live consumer: evaluates the objective table over the
    history rings on every :meth:`check` and tracks per-objective
    burn/recover state. State transitions emit ``slo.*`` metrics and
    call ``on_burn(objective, burn)`` once per burn onset — the worker
    wires that to a flight-recorder dump + a DeviceProfiler capture
    request, so the evidence window is captured WHILE the objective is
    burning, not reconstructed afterwards."""

    def __init__(self, history=None, objectives=None, on_burn=None) -> None:
        self._history = history
        self._objectives = objectives
        self.on_burn = on_burn
        self._lock = threading.Lock()
        self._state: dict[str, Burn] = {}
        self.checks = 0

    @property
    def history(self):
        if self._history is not None:
            return self._history
        from analyzer_tpu_torch.obs.history import get_history

        return get_history()

    def objectives(self):
        return _objectives(self._objectives)

    def check(self, now: float) -> list[Burn]:
        """One evaluation pass at ``now``; returns every live
        objective's burn state. Never raises."""
        reg = get_registry()
        results: list[Burn] = []
        onsets: list = []
        with self._lock:
            self.checks += 1
            for obj in self.objectives():
                if obj.kind not in LIVE_KINDS:
                    continue
                try:
                    burn = evaluate_live(obj, self.history, now)
                except Exception as err:  # noqa: BLE001 — an evaluator
                    # crash must not take down the poll loop it rides.
                    logger.exception("SLO objective %s failed to evaluate",
                                     obj.name)
                    burn = Burn(obj.name, False, None, f"error: {err!r}")
                prev = self._state.get(obj.name)
                was_burning = prev is not None and prev.burning
                if burn.burning and not was_burning:
                    reg.counter("slo.burns_total").add(1)
                    reg.gauge("slo.state", objective=obj.name).set(1)
                    onsets.append((obj, burn))
                elif not burn.burning and was_burning:
                    reg.counter("slo.recoveries_total").add(1)
                    reg.gauge("slo.state", objective=obj.name).set(0)
                self._state[obj.name] = burn
                results.append(burn)
            reg.gauge("slo.burning").set(
                sum(1 for b in self._state.values() if b.burning)
            )
        for obj, burn in onsets:
            if self.on_burn is not None:
                try:
                    self.on_burn(obj, burn)
                except Exception:  # noqa: BLE001 — evidence capture is
                    # best-effort; the watchdog keeps watching.
                    logger.exception("SLO on_burn hook failed (%s)", obj.name)
        return results

    @property
    def burning(self) -> list[str]:
        with self._lock:
            return sorted(
                n for n, b in self._state.items() if b.burning
            )

    def healthy(self):
        """HealthChecks probe: /readyz degrades while any objective
        burns — a balancer should stop preferring a worker that is
        violating its SLOs, which is exactly what a 503 means."""
        burning = self.burning
        if burning:
            return False, "burning: " + ", ".join(burning)
        if not self._state:
            return True, "no SLO evaluation yet"
        return True, f"{len(self._state)} objectives ok"

    def status(self) -> dict:
        """The ``/sloz`` payload."""
        with self._lock:
            state = dict(self._state)
        objs = []
        for obj in self.objectives():
            burn = state.get(obj.name)
            objs.append({
                "name": obj.name,
                "kind": obj.kind,
                "metric": obj.metric or None,
                "threshold": obj.threshold,
                "windows": list(obj.windows),
                "state": (
                    "untracked" if obj.kind not in LIVE_KINDS
                    else "burning" if burn is not None and burn.burning
                    else "ok" if burn is not None
                    else "unevaluated"
                ),
                "value": burn.value if burn is not None else None,
                "detail": (
                    burn.detail if burn is not None else obj.description
                ),
            })
        return {
            "objectives": objs,
            "burning": sorted(
                n for n, b in state.items() if b.burning
            ),
            "checks": self.checks,
        }


_watchdog_lock = threading.Lock()
_watchdog: Watchdog | None = None


def get_watchdog() -> Watchdog:
    """The process-wide watchdog (created on first use; the worker
    attaches its ``on_burn`` hook, /sloz reads its status)."""
    global _watchdog
    with _watchdog_lock:
        if _watchdog is None:
            _watchdog = Watchdog()
        return _watchdog


def reset_watchdog(**kwargs) -> Watchdog:
    """Replaces the process-wide watchdog with a fresh one (tests)."""
    global _watchdog
    with _watchdog_lock:
        _watchdog = Watchdog(**kwargs)
        return _watchdog


# -- artifact mode ---------------------------------------------------------

def _check_dead_letters(data, det, thr, obj):
    dead = det.get("dead_letters", 0)
    if dead:
        return f"dead_letters: {dead} (SLO: 0)"
    return None


def _check_retraces(data, det, thr, obj):
    retraces = det.get("retraces_steady", 0)
    if retraces:
        return (
            f"retraces_steady: {retraces:g} post-warmup retraces "
            "(SLO: flat)"
        )
    return None


def _check_view_staleness(data, det, thr, obj):
    max_lag = thr.get("max_view_lag_ticks", 2)
    lag = det.get("view_lag_ticks_max", 0)
    if lag > max_lag:
        return (
            f"view_lag_ticks_max: {lag} > {max_lag} (served view went "
            "stale while commits were pending)"
        )
    return None


def _check_drained(data, det, thr, obj):
    if not det.get("drained", True) or det.get("queue_depth_final", 0):
        return (
            f"backlog not drained: {det.get('queue_depth_final', '?')} "
            "message(s) left after the drain window"
        )
    return None


def _check_lost_work(data, det, thr, obj):
    published = det.get("matches_published", 0)
    rated = det.get("matches_rated", 0)
    if rated < published:
        return (
            f"matches_rated {rated} < matches_published {published} "
            "(ingest lost work)"
        )
    return None


def _check_throughput_floor(data, det, thr, obj):
    floor = thr.get("min_matches_per_sec")
    if floor is not None and float(data.get("value", 0.0)) < floor:
        return (
            f"matches_per_sec {data.get('value')} below the configured "
            f"floor {floor}"
        )
    return None


def _check_latency_cap(data, det, thr, obj):
    p99_cap = thr.get("max_p99_ms")
    p99 = (data.get("latency_ms") or {}).get("p99")
    if p99_cap is not None and p99 is not None and p99 > p99_cap:
        return f"serve p99 {p99} ms above the configured cap {p99_cap} ms"
    return None


def _check_dominant_stage(data, det, thr, obj):
    forbidden = thr.get("forbid_dominant_stages") or []
    if not forbidden:
        return None
    # Only evaluable on a traced capture; an artifact that ASKED for the
    # gate but carries no trace block fails loudly, not green-by-omission.
    dominant = (data.get("trace") or {}).get("dominant_stage")
    if dominant is None:
        return (
            "forbid_dominant_stages configured but the artifact has "
            "no trace block (run the soak with --trace)"
        )
    if dominant in forbidden:
        return (
            f"dominant critical-path stage {dominant!r} is in the "
            f"forbidden set {sorted(forbidden)} — the ingest edge is "
            "the bottleneck (docs/ingest.md runbook)"
        )
    return None


def _check_audit_mismatches(data, det, thr, obj):
    # The shadow audit's zero-tolerance half: the artifact's audit block
    # rides OUTSIDE the deterministic block (its counters include drains
    # after the measured window), but its mismatch count gates the same
    # as a dead letter. Absent block = audit not enabled = nothing to
    # gate (the soak acceptance run enables it explicitly).
    audit = data.get("audit")
    if not isinstance(audit, dict):
        return None
    mismatches = audit.get("mismatches", 0)
    if mismatches:
        return (
            f"audit mismatches: {mismatches} served response(s) diverged "
            "from the bit-exact oracle (SLO: 0; obs/audit.py)"
        )
    return None


def _check_calibration(data, det, thr, obj):
    # The rating-quality gate (obs/quality.py): the quality block rides
    # OUTSIDE the deterministic block, like audit — the plane is an
    # observer and the deterministic block stays bit-identical with the
    # plane on or off. Absent block = plane off = nothing to gate (the
    # vanished-block regression is benchdiff's job, mirroring the
    # ingest/migrate vanished-native gates); below the volume floor the
    # verdict is withheld, like the live min_volume guard.
    quality = data.get("quality")
    if not isinstance(quality, dict):
        return None
    n = quality.get("matches_scored") or 0
    if n < thr.get("min_quality_matches", obj.min_volume):
        return None
    ece = quality.get("ece")
    cap = thr.get("max_ece", obj.threshold)
    if ece is not None and ece > cap:
        return (
            f"quality ece {ece:g} above {cap:g} over {n} scored matches "
            "(served win probabilities are mis-calibrated; "
            "docs/OPERATIONS.md \"Triaging a calibration burn\")"
        )
    return None


_ARTIFACT_CHECKS = {
    "dead_letters": _check_dead_letters,
    "retraces_steady": _check_retraces,
    "view_staleness": _check_view_staleness,
    "drained": _check_drained,
    "lost_work": _check_lost_work,
    "throughput_floor": _check_throughput_floor,
    "latency_cap": _check_latency_cap,
    "dominant_stage": _check_dominant_stage,
    "audit_mismatches": _check_audit_mismatches,
    "calibration": _check_calibration,
}


def soak_violations(data: dict, objectives=None) -> list[str]:
    """Artifact-mode evaluation: walks the objective table and runs
    each objective's deterministic-block check against a SOAK artifact.
    Returns human-readable violation strings; empty means pass.

    The same table the live :class:`Watchdog` walks: doctor one
    objective and both consumers trip. The messages are the JAX
    package's, word for word, on the same artifact. The port's soak
    driver (``loadgen/driver.py``) judges its artifact here, and so does
    ``cli benchdiff --family soak``'s absolute half
    (:func:`analyzer_tpu_torch.obs.benchdiff.soak_slo_violations`)."""
    det = data.get("deterministic")
    if not isinstance(det, dict):
        return ["artifact has no deterministic block (not a SOAK capture?)"]
    thr = (data.get("slo") or {}).get("thresholds") or {}
    out: list[str] = []
    for obj in _objectives(objectives):
        if obj.artifact_check is None:
            continue
        if obj.artifact_check.startswith("zero:"):
            # Generic zero-tolerance check on any deterministic-block
            # key — lets an ad-hoc objective gate a counter without a
            # bespoke check function (and lets tests doctor the table).
            key = obj.artifact_check[5:]
            value = det.get(key, 0)
            if value:
                out.append(
                    f"{key}: {value:g} (SLO: 0; objective {obj.name})"
                )
            continue
        check = _ARTIFACT_CHECKS.get(obj.artifact_check)
        if check is None:
            out.append(
                f"objective {obj.name!r} names unknown artifact check "
                f"{obj.artifact_check!r}"
            )
            continue
        violation = check(data, det, thr, obj)
        if violation is not None:
            out.append(violation)
    return out
