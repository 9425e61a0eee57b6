"""obsd: the live introspection plane — stdlib HTTP endpoints on a thread.

Everything the snapshot artifact exposes post-hoc (``--metrics-out``,
``cli metrics``) becomes scrapeable while the process runs:

  ``GET /healthz``         liveness — 200 as long as the thread serves;
  ``GET /readyz``          readiness — 200 when every registered
                           :class:`HealthChecks` probe passes, 503 with
                           one ``fail <name>: <detail>`` line per failing
                           probe otherwise (a worker registers pipeline/
                           broker/store probes — and a ``serve.view``
                           probe when the query-serving plane is on,
                           ``service/worker.py``);
  ``GET /metrics``         Prometheus text exposition (``prometheus_text``);
  ``GET /statusz``         human summary: ``render_summary`` plus the
                           owner's ``status_provider()`` dict (worker
                           ``stats()``), the served view's version AND
                           age, and trend sparklines from the history
                           rings;
  ``GET /historyz``        the telemetry history rings as JSON
                           (``obs/history.py`` — ``?series=<prefix>``
                           filters by name prefix, ``?tier=raw|10s|1m``
                           picks one downsampling tier);
  ``GET /sloz``            the SLO watchdog's objective table and
                           burn states (``obs/slo.py``);
  ``GET /qualityz``        the rating-quality ledger's reliability
                           table, streaming brier/log-loss/ECE and
                           population-drift snapshot
                           (``obs/quality.py``);
  ``GET /debug/snapshot``  the full JSON snapshot, spans included;
  ``GET /debug/flight``    TRIGGERS a flight-recorder dump
                           (``?reason=...``) — the fleet Collector's
                           evidence-capture hook (obs/federate.py):
                           localhost-only regardless of the bind, and
                           token-authenticated when a token is
                           configured (``flight_token=`` /
                           ``ANALYZER_TPU_FLIGHT_TOKEN``); throttling
                           stays the recorder's (per reason).

Served through the port's :mod:`analyzer_tpu_torch.obs.httpd` plumbing
(route table + daemon ``ThreadingHTTPServer``), the copy the serve plane
rides — no framework, no dependency, good enough for a scrape every few
seconds and an operator's curl. Every plane binds localhost unless an
operator explicitly widens it. The routes, status codes, content types
and bodies are the JAX package's ``analyzer_tpu.obs.server``'s.
"""

from __future__ import annotations

import json
import threading

from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs.httpd import DEFAULT_HOST, RoutedHTTPServer, text_body
from analyzer_tpu_torch.obs.snapshot import (
    prometheus_text,
    render_summary,
    snapshot,
)

logger = get_logger(__name__)

__all__ = [
    "DEFAULT_HOST", "HealthChecks", "ObsServer", "connectivity_probe",
]


class HealthChecks:
    """Pluggable readiness registry: ``register(name, probe)`` where
    ``probe()`` returns ``True``/``False`` or ``(ok, detail)``. A probe
    that raises is a failing probe (the exception is the detail) — a
    readiness endpoint that crashes on the condition it exists to report
    would be worse than useless."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._checks: dict[str, object] = {}

    def register(self, name: str, probe) -> None:
        with self._lock:
            self._checks[name] = probe

    def unregister(self, name: str) -> None:
        with self._lock:
            self._checks.pop(name, None)

    def run(self) -> dict[str, tuple[bool, str]]:
        """name -> (ok, detail) for every registered probe."""
        with self._lock:
            checks = dict(self._checks)
        out: dict[str, tuple[bool, str]] = {}
        for name, probe in checks.items():
            try:
                result = probe()
            except Exception as err:  # noqa: BLE001 — a raising probe is a failing probe
                out[name] = (False, f"probe raised: {err!r}")
                continue
            if isinstance(result, tuple):
                ok, detail = result
                out[name] = (bool(ok), str(detail))
            else:
                out[name] = (bool(result), "ok" if result else "failed")
        return out

    @property
    def ready(self) -> bool:
        return all(ok for ok, _ in self.run().values())


class ObsServer:
    """The obsd thread. ``port=0`` binds an ephemeral port (tests); the
    bound port is readable at :attr:`port`. ``status_provider()`` (a dict,
    e.g. ``Worker.stats``) enriches ``/statusz``. Stop with
    :meth:`close` — the worker's shutdown path owns that call."""

    def __init__(
        self,
        port: int = 0,
        host: str = DEFAULT_HOST,
        status_provider=None,
        health: HealthChecks | None = None,
        max_statusz_spans: int = 200,
        flight_dump=None,
        flight_token: str | None = None,
    ) -> None:
        import os

        self.health = health if health is not None else HealthChecks()
        self.status_provider = status_provider
        self._max_statusz_spans = max_statusz_spans
        # /debug/flight: the dump hook (the worker passes its own so a
        # remote-triggered artifact carries config + profiler info like
        # a local one) and the shared-secret token. No token configured
        # = localhost peers may trigger untokened (the endpoint is
        # loopback-gated either way).
        self._flight_dump = flight_dump
        self.flight_token = (
            flight_token
            or os.environ.get("ANALYZER_TPU_FLIGHT_TOKEN")
            or None
        )
        self._httpd = RoutedHTTPServer(
            routes={
                "/healthz": lambda params: text_body("ok\n"),
                "/readyz": self._route_readyz,
                "/metrics": lambda params: text_body(prometheus_text()),
                "/statusz": lambda params: text_body(self._statusz()),
                "/historyz": self._route_historyz,
                "/sloz": self._route_sloz,
                "/qualityz": self._route_qualityz,
                "/debug/snapshot": self._route_snapshot,
                "/debug/flight": self._route_flight,
            },
            port=port,
            host=host,
            name="analyzer-obsd",
            local_only={"/debug/flight"},
        )
        self.host = host
        logger.info("obsd listening on http://%s:%d", self.host, self.port)

    @property
    def port(self) -> int:
        return self._httpd.port

    @property
    def url(self) -> str:
        return self._httpd.url

    def _route_readyz(self, params) -> tuple[int, str, str]:
        code, body = self._readyz()
        return text_body(body, code)

    def _route_snapshot(self, params) -> tuple[int, str, str]:
        body = json.dumps(snapshot(max_spans=None), indent=1, sort_keys=True)
        return 200, body + "\n", "application/json"

    def _route_historyz(self, params) -> tuple[int, str, str]:
        from analyzer_tpu_torch.obs.history import TIERS, get_history

        prefix = params.get("series")
        tier = params.get("tier")
        if tier is not None and tier not in {t for t, _, _ in TIERS}:
            return text_body(
                f"unknown tier {tier!r} (raw|10s|1m)\n", 400
            )
        body = json.dumps(
            get_history().to_json(prefix=prefix, tier=tier),
            indent=1, sort_keys=True,
        )
        return 200, body + "\n", "application/json"

    def _route_sloz(self, params) -> tuple[int, str, str]:
        from analyzer_tpu_torch.obs.slo import get_watchdog

        body = json.dumps(
            get_watchdog().status(), indent=1, sort_keys=True
        )
        return 200, body + "\n", "application/json"

    def _route_qualityz(self, params) -> tuple[int, str, str]:
        """The rating-quality plane (obs/quality.py): the live ledger's
        full reliability table + drift snapshot, or an explicit
        ``enabled: false`` when this process runs no ledger — a scraper
        can tell "plane off" from "broken" (the same presence contract
        as stats()['quality'])."""
        from analyzer_tpu_torch.obs.quality import get_quality_ledger

        ledger = get_quality_ledger()
        payload = (
            {"enabled": False} if ledger is None
            else dict(ledger.summary(), enabled=True)
        )
        body = json.dumps(payload, indent=1, sort_keys=True)
        return 200, body + "\n", "application/json"

    def _route_flight(self, params) -> tuple[int, str, str]:
        """The authenticated-localhost dump trigger: a fleet Collector
        (or an operator's curl on the box) asks THIS process to freeze
        its flight-recorder evidence — used at fleet-burn onset so the
        burning host captures its own trajectory while it burns. The
        recorder's per-reason throttle still applies (a storm of
        requests produces one artifact); the reason is sanitized into
        the artifact directory name by the recorder itself."""
        if self.flight_token is not None and (
            params.get("token") != self.flight_token
        ):
            return (
                403,
                json.dumps({"error": "bad or missing token"}) + "\n",
                "application/json",
            )
        reason = params.get("reason") or "remote"
        if self._flight_dump is not None:
            path = self._flight_dump(reason)
        else:
            from analyzer_tpu_torch.obs.flight import get_flight_recorder

            path = get_flight_recorder().dump(reason)
        body = json.dumps(
            {"reason": reason, "dumped": path}, sort_keys=True
        )
        return 200, body + "\n", "application/json"

    def _readyz(self) -> tuple[int, str]:
        results = self.health.run()
        failing = {n: d for n, (ok, d) in results.items() if not ok}
        lines = [
            (f"fail {n}: {results[n][1]}" if n in failing else f"ok {n}")
            for n in sorted(results)
        ]
        if not lines:
            lines = ["ok (no checks registered)"]
        return (503 if failing else 200), "\n".join(lines) + "\n"

    #: Series whose trends /statusz renders when the history sampler
    #: has data for them (the page-one signals; everything else is one
    #: /historyz query away).
    STATUSZ_TRENDS = (
        "worker.matches_rated_total",
        "worker.dead_letters_total",
        "broker.queue_depth",
        "serve.view_age_seconds",
        "feed.starved_total",
        "tier.host_bytes",
        "device.live_buffers",
        "audit.mismatches_total",
        "quality.matches_scored_total",
    )

    def _statusz(self) -> str:
        snap = snapshot(max_spans=self._max_statusz_spans)
        out = [render_summary(snap)]
        out.extend(self._statusz_history())
        if self.status_provider is not None:
            try:
                status = self.status_provider()
            except Exception as err:  # noqa: BLE001 — statusz must render
                # during the incident it exists to explain
                status = {"status_provider_error": repr(err)}
            out.append("status:")
            out.extend(f"  {k} = {v}" for k, v in sorted(status.items()))
        ready = self.health.run()
        if ready:
            out.append("readiness:")
            out.extend(
                f"  {'ok ' if ok else 'FAIL'} {n}: {d}"
                for n, (ok, d) in sorted(ready.items())
            )
        return "\n".join(out) + "\n"

    def _statusz_history(self) -> list[str]:
        """The history-derived /statusz sections: the served view's
        version WITH its age (staleness is the #1 page — the operator
        must never compute it by hand from two scrapes), and trend
        sparklines for the page-one series. Empty before the first
        sample; never raises into the status page."""
        from analyzer_tpu_torch.obs.history import get_history
        from analyzer_tpu_torch.obs.slo import get_watchdog

        try:
            history = get_history()
            out: list[str] = []
            vv = history.last_change("serve.view_version")
            if vv is not None and vv[1]:
                t_change, version = vv
                age = history.latest("serve.view_age_seconds")
                last_t = history.last_sample_t
                # Age from the ring: prefer the sampled age gauge (set
                # from the publisher's own clock), fall back to "how
                # long has the version sat unchanged" in sampler time.
                if age is not None:
                    age_s = age[1]
                elif last_t is not None:
                    age_s = last_t - t_change
                else:
                    age_s = 0.0
                out.append(
                    f"serve view: v{int(version)} age={age_s:.1f}s"
                )
            burning = get_watchdog().burning
            if burning:
                out.append("SLO BURNING: " + ", ".join(burning))
            trends = []
            for name in self.STATUSZ_TRENDS:
                line = history.sparkline(name)
                if line is None:
                    continue
                latest = history.latest(name)
                trends.append(
                    f"  {name:<36} {line}  last={latest[1]:g}"
                )
            if trends:
                out.append("trends (oldest -> newest; /historyz for data):")
                out.extend(trends)
            return out
        except Exception:  # noqa: BLE001 — statusz must render during
            # the incident it exists to explain
            logger.exception("statusz history section failed")
            return []

    def close(self) -> None:
        """Stops serving and joins the thread. Idempotent."""
        self._httpd.close()
        logger.info("obsd stopped")


def connectivity_probe(obj, what: str):
    """A HealthChecks probe over a duck-typed broker/store: consults
    ``is_connected``/``is_open`` (attr or nullary method) or ``ping()``
    when the object offers one; objects exposing none of these (the
    in-memory fakes) are healthy by construction."""

    def probe() -> tuple[bool, str]:
        for attr in ("is_connected", "is_open"):
            flag = getattr(obj, attr, None)
            if flag is None:
                continue
            ok = bool(flag() if callable(flag) else flag)
            return ok, f"{what}.{attr}={ok}"
        ping = getattr(obj, "ping", None)
        if callable(ping):
            ping()  # raises on a dead connection -> failing probe
            return True, f"{what}.ping ok"
        return True, f"{what}: no connectivity probe exposed"

    return probe
