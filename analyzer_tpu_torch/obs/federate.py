"""Fleet observability plane: metrics federation + fleet-scope SLO burns.

The port's own copy of ``analyzer_tpu.obs.federate`` (stdlib only), with
the same merge, burns, routes and payloads. Every observability surface
below this module is PROCESS-LOCAL — the registry, ``/statusz``, the
history rings, the SLO watchdog answer questions about ONE worker. This
module is the fleet half:

  * :class:`Collector` scrapes N workers' obsd endpoints
    (``/debug/snapshot`` for the registry merge, ``/historyz`` for
    per-host sampler staleness), merges their registries into a FLEET
    snapshot under the reserved ``host=`` label (``obs.registry
    .RESERVED_LABELS``), maintains fleet-level history rings over the
    merged series, and evaluates ``STANDARD_OBJECTIVES`` at fleet scope
    as multi-window burn rates — with PER-HOST attribution, so a fleet
    burn names the offending host, and an evidence hook: at burn onset
    the Collector asks the burning host to freeze its own flight
    recorder via obsd's authenticated-localhost ``/debug/flight``
    trigger;
  * :class:`FleetServer` serves the federated view: ``/fleetz``
    (topology + per-host health/versions/staleness), aggregated
    ``/metrics`` (Prometheus text over the merged snapshot), a fleet
    ``/sloz``, and the fleet rings on ``/historyz``;
  * ``cli fleet`` drives both — a scrape loop in serve mode, or
    ``--check`` one-shot mode (scrape once, evaluate, exit 1 on burn).

Aggregation semantics: counters SUM across hosts (a dead letter
anywhere moves the fleet delta), gauges take the MAX (the fleet's
``serve.view_age_seconds`` is the WORST host's staleness — exactly the
number the bounded-staleness objective must burn on); histograms merge
as per-host labeled summaries only (quantiles do not add). A host that
drops out of a scrape round simply leaves the merge — its counters'
disappearance DECREASES fleet sums, which the burn-rate windows read as
"no new events", never as a spurious burn.

Clock discipline: like :mod:`obs.history` and :mod:`obs.slo`, this
module NEVER reads a wall clock — ``scrape(now)``/``check(now)`` take
the caller's timestamp (``cli fleet``'s wall loop, a test's synthetic
clock), so fleet burn windows are exactly as deterministic as their
driver. A JAX worker's obsd and a port worker's answer the same routes
with the same payloads, so one Collector scrapes either.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading

from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs.registry import MAX_LABEL_VALUES, get_registry

logger = get_logger(__name__)

__all__ = [
    "Collector", "FleetServer", "HostState", "MAX_FLEET_HOSTS",
    "fleet_series_key",
]

#: Host-cardinality cap — the ``host=`` label's analog of the
#: registry's per-family label guard: targets past the cap are
#: refused at construction (counted in ``fleet.hosts_dropped``), so a
#: mis-generated target list cannot grow the fleet snapshot, the merged
#: rings, and every /fleetz render without bound.
MAX_FLEET_HOSTS = MAX_LABEL_VALUES

#: Fleet history capacity: per-host labeled series multiply the base
#: schema by the host count, so the fleet rings get a wider series cap
#: than a single process's sampler.
MAX_FLEET_SERIES = 16384

_SERIES_RE = re.compile(r"^(?P<name>[^{]+)(\{(?P<labels>.*)\})?$", re.DOTALL)

_TIMEOUT_S = 5.0


def fleet_series_key(key: str, host: str) -> str:
    """``name{a=b}`` + host -> ``name{a=b,host=<target>}`` (labels kept
    sorted, the registry's own key discipline) — the reserved-label
    merge every scraped series goes through."""
    m = _SERIES_RE.match(key)
    name = m.group("name") if m else key
    labels = {}
    body = (m.group("labels") if m else None) or ""
    if body:
        for pair in body.split(","):
            k, _, v = pair.partition("=")
            labels[k] = v
    labels["host"] = host
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def _numeric(value) -> float | None:
    if value is None:
        return None
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def _http_fetch_json(url: str, timeout: float = _TIMEOUT_S) -> dict:
    """The default fetcher (tests inject their own): one GET, parsed as
    JSON. Localhost/VPC scrape targets — no retries here; the Collector
    counts failures per host and keeps scraping."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.load(resp)


@dataclasses.dataclass
class HostState:
    """One scrape target's rolling state (the /fleetz row)."""

    target: str
    up: bool = False
    scrapes: int = 0
    consecutive_failures: int = 0
    last_scrape_t: float | None = None
    last_error: str | None = None
    snapshot: dict | None = None
    # Lifted from the scrape for the /fleetz row: the served view's
    # version/age gauges and the worker's own history-sampler position
    # (a stalled sampler means the host's burn windows are blind).
    view_version: float | None = None
    view_age_s: float | None = None
    history_last_sample_t: float | None = None
    history_samples: int | None = None

    def row(self) -> dict:
        return {
            "up": self.up,
            "scrapes": self.scrapes,
            "consecutive_failures": self.consecutive_failures,
            "last_scrape_t": self.last_scrape_t,
            "last_error": self.last_error,
            "view_version": self.view_version,
            "view_age_seconds": self.view_age_s,
            "history_last_sample_t": self.history_last_sample_t,
            "history_samples": self.history_samples,
        }


class Collector:
    """The fleet scraper/merger/judge. Clock-injected: drive it with
    :meth:`scrape` at the caller's cadence; read the federated view
    through :meth:`fleet_snapshot` / :meth:`fleetz` / :meth:`sloz`, or
    serve them with :class:`FleetServer`.

    Doubles as the fleet :class:`~analyzer_tpu_torch.obs.history
    .HistorySampler`'s registry: ``snapshot()`` returns the merged
    fleet view, so one unmodified sampler records fleet-level rings the
    unmodified SLO evaluators then burn on — the single-process plane's
    machinery, pointed at the fleet."""

    def __init__(
        self,
        targets,
        objectives=None,
        flight_token: str | None = None,
        request_flight_dumps: bool = True,
        fetch=None,
        max_hosts: int = MAX_FLEET_HOSTS,
        max_series: int = MAX_FLEET_SERIES,
    ) -> None:
        from analyzer_tpu_torch.obs.history import HistorySampler

        targets = [str(t).strip() for t in targets if str(t).strip()]
        reg = get_registry()
        if len(targets) > max_hosts:
            dropped = len(targets) - max_hosts
            logger.warning(
                "fleet host cap: scraping %d of %d targets (%d dropped)",
                max_hosts, len(targets), dropped,
            )
            reg.gauge("fleet.hosts_dropped").set(dropped)
            targets = targets[:max_hosts]
        self.targets = targets
        self._objectives = objectives
        self.flight_token = flight_token
        self.request_flight_dumps = request_flight_dumps
        self._fetch = fetch or _http_fetch_json
        self._lock = threading.Lock()
        self._hosts = {t: HostState(target=t) for t in targets}
        self._merged: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        self._state: dict = {}          # objective name -> Burn
        self._attribution: dict = {}    # objective name -> [targets]
        self.scrapes = 0
        self.last_scrape_t: float | None = None
        self.history = HistorySampler(registry=self, max_series=max_series)
        reg.gauge("fleet.hosts").set(len(targets))

    # -- the registry facade the fleet HistorySampler samples -------------
    def snapshot(self) -> dict:
        return self.fleet_snapshot()

    def counter(self, name: str, **labels):
        # Sampler self-telemetry (history.samples_total) lands on the
        # collector process's own registry, like any other subsystem.
        return get_registry().counter(name, **labels)

    def gauge(self, name: str, **labels):
        return get_registry().gauge(name, **labels)

    # -- scraping ---------------------------------------------------------
    def _scrape_host(self, hs: HostState, now: float) -> None:
        base = f"http://{hs.target}"
        try:
            snap = self._fetch(f"{base}/debug/snapshot")
        except Exception as err:  # noqa: BLE001 — a down host is a state,
            # not a collector crash; the scrape loop must keep going.
            hs.up = False
            hs.consecutive_failures += 1
            hs.last_error = repr(err)
            get_registry().counter("fleet.scrape_errors_total").add(1)
            return
        hs.up = True
        hs.scrapes += 1
        hs.consecutive_failures = 0
        hs.last_error = None
        hs.last_scrape_t = now
        hs.snapshot = snap
        gauges = snap.get("gauges") or {}
        hs.view_version = _numeric(gauges.get("serve.view_version"))
        hs.view_age_s = _numeric(gauges.get("serve.view_age_seconds"))
        try:
            # The worker-side sampler's position, without the series
            # payload (?series= filters to a tiny prefix): a host whose
            # own rings stopped advancing is blind to its local burns —
            # the /fleetz row must say so.
            hist = self._fetch(f"{base}/historyz?series=history.")
            hs.history_last_sample_t = _numeric(hist.get("last_sample_t"))
            hs.history_samples = hist.get("samples")
        except Exception:  # noqa: BLE001 — optional detail, never fatal
            hs.history_last_sample_t = None
            hs.history_samples = None

    def _merge(self) -> dict:
        """The fleet snapshot: per-host series under ``host=`` plus the
        fleet aggregates under the bare names (counters sum, gauges
        max), with the Collector's own ``fleet.*`` self-telemetry
        overlaid."""
        counters: dict = {}
        gauges: dict = {}
        hists: dict = {}
        agg_c: dict = {}
        agg_g: dict = {}
        for hs in self._hosts.values():
            if not hs.up or hs.snapshot is None:
                continue
            for key, value in (hs.snapshot.get("counters") or {}).items():
                v = _numeric(value)
                if v is None:
                    continue
                counters[fleet_series_key(key, hs.target)] = v
                agg_c[key] = agg_c.get(key, 0.0) + v
            for key, value in (hs.snapshot.get("gauges") or {}).items():
                v = _numeric(value)
                if v is None:
                    continue
                gauges[fleet_series_key(key, hs.target)] = v
                prev = agg_g.get(key)
                agg_g[key] = v if prev is None else max(prev, v)
            for key, summ in (hs.snapshot.get("histograms") or {}).items():
                if isinstance(summ, dict):
                    hists[fleet_series_key(key, hs.target)] = dict(summ)
        counters.update(agg_c)
        gauges.update(agg_g)
        own = get_registry().snapshot()
        counters.update({
            k: v for k, v in own["counters"].items()
            if k.startswith("fleet.")
        })
        gauges.update({
            k: v for k, v in own["gauges"].items() if k.startswith("fleet.")
        })
        return {
            "counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "histograms": dict(sorted(hists.items())),
        }

    def scrape(self, now: float) -> list:
        """One federation round at the caller's timestamp: scrape every
        target, rebuild the fleet snapshot, record a fleet history
        sample, evaluate the objective table at fleet scope, and fire
        evidence capture at burn onsets. Returns the live objectives'
        fleet burn states."""
        reg = get_registry()
        with self._lock:
            for hs in self._hosts.values():
                self._scrape_host(hs, now)
            self.scrapes += 1
            self.last_scrape_t = now
            reg.counter("fleet.scrapes_total").add(1)
            for hs in self._hosts.values():
                reg.gauge("fleet.host_up", host=hs.target).set(hs.up)
            # Merge AFTER the self-telemetry bump so the fleet snapshot
            # (and the rings sampled from it) carries this round's own
            # fleet.* counters.
            self._merged = self._merge()
        # Outside the lock: the sampler re-enters snapshot() (which
        # takes the lock) and the burn hook does network IO.
        self.history.sample(now)
        reg.gauge("fleet.series").set(len(self.history.names()))
        return self._evaluate(now)

    # -- fleet-scope evaluation -------------------------------------------
    def objectives(self):
        from analyzer_tpu_torch.obs.slo import STANDARD_OBJECTIVES

        return (
            STANDARD_OBJECTIVES if self._objectives is None
            else tuple(self._objectives)
        )

    def _host_objective(self, obj, target: str):
        return dataclasses.replace(
            obj,
            metric=fleet_series_key(obj.metric, target),
            metric_b=(
                fleet_series_key(obj.metric_b, target)
                if obj.metric_b else None
            ),
        )

    def _evaluate(self, now: float) -> list:
        from analyzer_tpu_torch.obs.slo import LIVE_KINDS, Burn, evaluate_live

        reg = get_registry()
        results: list = []
        onsets: list = []
        with self._lock:
            up = [t for t, hs in self._hosts.items() if hs.up]
            for obj in self.objectives():
                if obj.kind not in LIVE_KINDS:
                    continue
                try:
                    burn = evaluate_live(obj, self.history, now)
                except Exception as err:  # noqa: BLE001 — one broken
                    # evaluator must not stop the fleet pass.
                    burn = Burn(obj.name, False, None, f"error: {err!r}")
                attributed: list = []
                if burn.burning:
                    # Per-host attribution: re-run the same evaluator
                    # over the host-labeled series. A burn no single
                    # host owns (each under threshold, the sum over) is
                    # attributed to the fleet as a whole.
                    for target in up:
                        try:
                            hb = evaluate_live(
                                self._host_objective(obj, target),
                                self.history, now,
                            )
                        except Exception:  # noqa: BLE001 — as above
                            continue
                        if hb.burning:
                            attributed.append(target)
                prev = self._state.get(obj.name)
                was_burning = prev is not None and prev.burning
                if burn.burning and not was_burning:
                    reg.counter("fleet.burns_total").add(1)
                    onsets.append((obj, burn, list(attributed)))
                elif not burn.burning and was_burning:
                    reg.counter("fleet.recoveries_total").add(1)
                self._state[obj.name] = burn
                self._attribution[obj.name] = attributed
                results.append(burn)
            reg.gauge("fleet.burning").set(
                sum(1 for b in self._state.values() if b.burning)
            )
        for obj, burn, attributed in onsets:
            logger.warning(
                "FLEET SLO burn: %s on %s — %s",
                obj.name, attributed or "the fleet (no single host)",
                burn.detail,
            )
            if self.request_flight_dumps:
                for target in attributed:
                    self._request_flight(target, obj.name)
        return results

    def _request_flight(self, target: str, objective: str) -> None:
        """Evidence capture at burn onset: the burning host freezes its
        own flight recorder via obsd's /debug/flight trigger (localhost
        -authenticated there; the shared token rides the query). Best
        effort — the fleet keeps judging whether or not the evidence
        lands."""
        url = f"http://{target}/debug/flight?reason=fleet-slo-{objective}"
        if self.flight_token:
            url += f"&token={self.flight_token}"
        try:
            got = self._fetch(url)
            get_registry().counter("fleet.flight_requests_total").add(1)
            logger.info(
                "requested flight dump from %s: %s", target,
                (got or {}).get("dumped"),
            )
        except Exception as err:  # noqa: BLE001 — evidence is best-effort
            logger.warning(
                "flight-dump request to %s failed: %r", target, err
            )

    def check(self, now: float) -> list:
        """One-shot mode (``cli fleet --check``): a SINGLE scrape, then
        absolute evaluation of the objectives a lone sample can judge —
        ``counter_zero`` objectives on the counters' absolute values
        (the CI topology under test is freshly started, so any count IS
        this run's count) and ``gauge_max`` on the merged worst-host
        gauges. Rate/growth/ratio objectives need two samples and are
        skipped. Returns ``(burn, attributed_targets)`` pairs for the
        burning objectives; an empty list is a green topology."""
        from analyzer_tpu_torch.obs.slo import Burn

        self.scrape(now)
        out: list = []
        with self._lock:
            merged = self._merged
            up = [t for t, hs in self._hosts.items() if hs.up]
            for obj in self.objectives():
                if obj.kind == "counter_zero":
                    value = merged["counters"].get(obj.metric, 0.0)
                    if value <= obj.threshold:
                        continue
                    attributed = [
                        t for t in up
                        if merged["counters"].get(
                            fleet_series_key(obj.metric, t), 0.0
                        ) > obj.threshold
                    ]
                    out.append((
                        Burn(
                            obj.name, True, value,
                            f"{obj.metric} = {value:g} across the fleet "
                            f"(SLO: <= {obj.threshold:g})",
                        ),
                        attributed,
                    ))
                elif obj.kind == "gauge_max":
                    value = merged["gauges"].get(obj.metric)
                    if value is None or value <= obj.threshold:
                        continue
                    attributed = [
                        t for t in up
                        if (merged["gauges"].get(
                            fleet_series_key(obj.metric, t)
                        ) or 0.0) > obj.threshold
                    ]
                    out.append((
                        Burn(
                            obj.name, True, value,
                            f"{obj.metric} worst-host {value:g} "
                            f"(SLO: <= {obj.threshold:g})",
                        ),
                        attributed,
                    ))
        return out

    # -- the federated read surface ---------------------------------------
    def fleet_snapshot(self) -> dict:
        with self._lock:
            return self._merged

    @property
    def burning(self) -> list:
        with self._lock:
            return sorted(
                n for n, b in self._state.items() if b.burning
            )

    def attribution(self) -> dict:
        with self._lock:
            return {
                n: list(t) for n, t in self._attribution.items() if t
            }

    def fleetz(self) -> dict:
        """The ``/fleetz`` payload: topology + per-host health/versions/
        staleness + the fleet burn state."""
        with self._lock:
            hosts = {t: hs.row() for t, hs in self._hosts.items()}
            return {
                "version": 1,
                "targets": len(self.targets),
                "up": sum(1 for hs in self._hosts.values() if hs.up),
                "scrapes": self.scrapes,
                "last_scrape_t": self.last_scrape_t,
                "hosts": hosts,
                "burning": sorted(
                    n for n, b in self._state.items() if b.burning
                ),
                "attribution": {
                    n: list(t)
                    for n, t in self._attribution.items() if t
                },
            }

    def sloz(self) -> dict:
        """The fleet ``/sloz`` payload: the objective table with
        fleet-scope burn states and per-host attribution."""
        from analyzer_tpu_torch.obs.slo import LIVE_KINDS

        with self._lock:
            state = dict(self._state)
            attribution = {
                n: list(t) for n, t in self._attribution.items()
            }
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
                "hosts": attribution.get(obj.name) or [],
            })
        return {
            "scope": "fleet",
            "objectives": objs,
            "burning": sorted(
                n for n, b in state.items() if b.burning
            ),
            "scrapes": self.scrapes,
        }


class FleetServer:
    """The Collector's serving plane — the fleet analog of obsd, on the
    shared ``obs/httpd.py`` plumbing (loopback by default)."""

    def __init__(self, collector: Collector, port: int = 0,
                 host: str | None = None) -> None:
        from analyzer_tpu_torch.obs.httpd import (
            DEFAULT_HOST, RoutedHTTPServer, json_body, text_body,
        )
        from analyzer_tpu_torch.obs.snapshot import prometheus_text

        self.collector = collector

        def fleetz(params):
            return json_body(collector.fleetz())

        def sloz(params):
            return json_body(collector.sloz())

        def metrics(params):
            return text_body(prometheus_text(collector.fleet_snapshot()))

        def historyz(params):
            from analyzer_tpu_torch.obs.history import TIERS

            tier = params.get("tier")
            if tier is not None and tier not in {t for t, _, _ in TIERS}:
                return text_body(
                    f"unknown tier {tier!r} (raw|10s|1m)\n", 400
                )
            return json_body(
                collector.history.to_json(
                    prefix=params.get("series"), tier=tier,
                )
            )

        self._httpd = RoutedHTTPServer(
            routes={
                "/healthz": lambda params: text_body("ok\n"),
                "/fleetz": fleetz,
                "/sloz": sloz,
                "/metrics": metrics,
                "/historyz": historyz,
            },
            port=port,
            host=host or DEFAULT_HOST,
            name="analyzer-fleetd",
        )
        logger.info("fleetd listening on %s", self.url)

    @property
    def port(self) -> int:
        return self._httpd.port

    @property
    def url(self) -> str:
        return self._httpd.url

    def close(self) -> None:
        self._httpd.close()
