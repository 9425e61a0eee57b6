"""The port's obsd (``analyzer_tpu_torch.obs.server``) against the JAX
package's, and the CLI verbs that start or read it.

A port ``ObsServer`` and a JAX ``ObsServer`` run side by side in one
process with the same probes: every route answers with the same status
and content type, ``/readyz`` with the same ``ok``/``fail`` lines, the
JSON routes of fresh planes with the same bodies, and ``/debug/flight``
is localhost-only (a request from another loopback address is refused
with the same 403) and checks its token. A port Worker's ``/readyz`` equals
the JAX worker's line for line, before and after its first view and under
a forced degradation. ``cli quality --url`` renders a port obsd's
``/qualityz`` exactly as the JAX CLI does; ``cli rate --obs-port 0``
writes the checkpoint of the run without the flag and closes obsd;
``cli serve --obs-port`` (a flag the port's ``serve`` lacked) serves obsd
beside ratesrv. SIGUSR1 dumps without stopping and SIGTERM exits with a
final snapshot, as in the JAX worker. Every server binds port 0 and is
closed in ``finally``; every request has a timeout.
"""

import glob
import http.client
import json
import os
import signal
import sqlite3
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

import analyzer_tpu.obs as jobs
from analyzer_tpu import cli as jax_cli
from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.config import ServiceConfig as JaxServiceConfig
from analyzer_tpu.obs import server as jserver
from analyzer_tpu.obs import tracer as jtracer
from analyzer_tpu.obs.quality import reset_quality_ledger as j_reset_quality
from analyzer_tpu.service import InMemoryBroker as JaxInMemoryBroker
from analyzer_tpu.service import InMemoryStore as JaxInMemoryStore
from analyzer_tpu.service import Worker as JaxWorker
from analyzer_tpu_torch import cli
from analyzer_tpu_torch import obs
from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
from analyzer_tpu_torch.obs import server as pserver
from analyzer_tpu_torch.obs.quality import reset_quality_ledger
from analyzer_tpu_torch.service import InMemoryBroker, InMemoryStore, SqlStore, Worker
from tests.test_torch_sql_store import synth_db


def _reset_all():
    obs.reset_tracer()
    jtracer.reset_tracer()
    for mod in (obs, jobs):
        mod.reset_registry()
        mod.reset_flight_recorder()
        mod.reset_history()
        mod.reset_watchdog()
    reset_quality_ledger()
    j_reset_quality()


@pytest.fixture(autouse=True)
def fresh_telemetry(monkeypatch):
    monkeypatch.delenv("ANALYZER_TPU_FLIGHT_TOKEN", raising=False)
    monkeypatch.delenv("ANALYZER_TPU_FLIGHT_DIR", raising=False)
    _reset_all()
    yield
    _reset_all()


def http_get(url: str, source: str | None = None) -> tuple[int, str, str]:
    """(status, body, content type) of one GET; ``source`` binds the
    client socket to that local address."""
    if source is not None:
        parsed = urllib.parse.urlsplit(url)
        conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                          timeout=10, source_address=(source, 0))
        try:
            conn.request("GET", parsed.path + ("?" + parsed.query if parsed.query else ""))
            resp = conn.getresponse()
            return (resp.status, resp.read().decode("utf-8"),
                    resp.getheader("Content-Type"))
        finally:
            conn.close()
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return (resp.status, resp.read().decode("utf-8"),
                    resp.headers.get("Content-Type"))
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode("utf-8"), err.headers.get("Content-Type")


# -- HealthChecks and connectivity probes -------------------------------------


class _Open:
    is_open = True


class _Closed:
    def is_connected(self):
        return False


class _Pings:
    def ping(self):
        return None


class _DeadPing:
    def ping(self):
        raise ConnectionError("gone")


class _Plain:
    pass


@pytest.mark.parametrize("obj", [_Open, _Closed, _Pings, _DeadPing, _Plain])
def test_connectivity_probe_equal_jax(obj):
    ours, theirs = pserver.HealthChecks(), jserver.HealthChecks()
    ours.register("x", pserver.connectivity_probe(obj(), "broker"))
    theirs.register("x", jserver.connectivity_probe(obj(), "broker"))
    assert ours.run() == theirs.run()
    assert ours.ready == theirs.ready


def test_health_checks_equal_jax():
    results = []
    for mod in (pserver, jserver):
        h = mod.HealthChecks()
        h.register("a", lambda: True)
        h.register("b", lambda: (False, "down"))
        h.register("boom", lambda: 1 / 0)
        first = (h.run(), h.ready)
        h.unregister("b")
        h.unregister("boom")
        results.append((first, h.run(), h.ready))
    assert results[0] == results[1]
    assert results[0][2] is True and "ZeroDivisionError" in results[0][0][0]["boom"][1]


# -- the routes, side by side ----------------------------------------------------


ROUTES = [
    "/healthz", "/readyz", "/metrics", "/statusz", "/historyz",
    "/historyz?series=worker.&tier=raw", "/historyz?tier=2h", "/sloz",
    "/qualityz", "/debug/snapshot", "/debug/flight?reason=x",
    "/debug/flight?reason=x&token=s3cret", "/nope",
]


@pytest.fixture
def both_servers():
    servers = []
    try:
        for mod in (pserver, jserver):
            srv = mod.ObsServer(port=0, status_provider=lambda: {"k": 42},
                                flight_token="s3cret")
            srv.health.register("svc.a", lambda: (True, "fine"))
            srv.health.register("svc.b", lambda: (False, "degraded"))
            servers.append(srv)
        yield servers
    finally:
        for srv in servers:
            srv.close()


@pytest.mark.parametrize("route", ROUTES)
def test_route_status_and_content_type_equal_jax(both_servers, route):
    ours, theirs = (http_get(s.url + route) for s in both_servers)
    assert ours[0] == theirs[0] and ours[2] == theirs[2]
    if route.startswith(("/healthz", "/readyz", "/historyz", "/sloz", "/qualityz",
                         "/debug/flight", "/nope")):
        assert ours[1] == theirs[1], route


def test_readyz_fail_lines(both_servers):
    status, body, _ = http_get(both_servers[0].url + "/readyz")
    assert status == 503
    assert body == "ok svc.a\nfail svc.b: degraded\n"
    both_servers[0].health.register("svc.b", lambda: True)
    assert http_get(both_servers[0].url + "/readyz")[:2] == (200, "ok svc.a\nok svc.b\n")


def test_debug_flight_is_localhost_only_and_token_checked(both_servers, tmp_path):
    obs.reset_flight_recorder(base_dir=str(tmp_path), min_interval_s=0.0)
    url = both_servers[0].url
    assert "/debug/flight" in both_servers[0]._httpd._local_only
    got = [http_get(s.url + "/debug/flight?reason=x&token=s3cret", source="127.0.0.3")
           for s in both_servers]
    assert got[0][0] == got[1][0] == 403 and got[0][1] == got[1][1]
    assert "localhost-only" in got[0][1]
    assert http_get(url + "/debug/flight?reason=x&token=wrong")[0] == 403
    status, body, _ = http_get(url + "/debug/flight?reason=fleet-slo-x&token=s3cret")
    assert status == 200
    dumped = json.loads(body)["dumped"]
    assert dumped and os.path.isfile(os.path.join(dumped, "history.json"))


def test_empty_token_means_unset(monkeypatch):
    srv = pserver.ObsServer(port=0, flight_token="")
    try:
        assert srv.flight_token is None
    finally:
        srv.close()
    monkeypatch.setenv("ANALYZER_TPU_FLIGHT_TOKEN", "envtok")
    srv = pserver.ObsServer(port=0)
    try:
        assert srv.flight_token == "envtok" and srv.host == "127.0.0.1"
    finally:
        srv.close()


def test_statusz_sections_and_metrics_exposition(both_servers):
    reg = obs.get_registry()
    reg.counter("worker.acks_total").add(3)
    h = obs.get_history()
    for t in range(6):
        reg.counter("worker.matches_rated_total").add(t)
        h.sample(float(t))
    srv = both_servers[0]
    status, body, _ = http_get(srv.url + "/statusz")
    assert status == 200
    assert "k = 42" in body and "readiness:" in body
    assert "trends (oldest -> newest" in body
    status, body, _ = http_get(srv.url + "/metrics")
    assert "worker_acks_total 3" in body and "# HELP" in body
    snap = json.loads(http_get(srv.url + "/debug/snapshot")[1])
    assert snap["counters"]["worker.acks_total"] == 3


# -- the Worker's obsd -------------------------------------------------------------


def _workers(**kw):
    cfg = dict(batch_size=2, idle_timeout=0.0)
    ours = Worker(InMemoryBroker(), InMemoryStore(), ServiceConfig(**cfg),
                  RatingConfig(), device="cpu", obs_port=0, **kw)
    theirs = JaxWorker(JaxInMemoryBroker(), JaxInMemoryStore(),
                       JaxServiceConfig(**cfg), JaxRatingConfig(), obs_port=0, **kw)
    return ours, theirs


def test_worker_readyz_equal_jax_before_and_after_the_first_view():
    ours, theirs = _workers(serve_port=0)
    try:
        got = [http_get(w.obs_server.url + "/readyz")[:2] for w in (ours, theirs)]
        assert got[0] == got[1] and got[0][0] == 503
        assert "fail serve.view: no ratings view published yet" in got[0][1]
        for name in ("worker.pipeline", "service.broker", "service.store",
                     "slo.watchdog"):
            assert f"ok {name}" in got[0][1]
        ours.poll()
        theirs.poll()
        ours.view_publisher.publish_rows(["a", "b"], np.zeros((2, 16), np.float32))
        theirs.view_publisher.publish_rows(["a", "b"], np.zeros((2, 16), np.float32))
        got = [http_get(w.obs_server.url + "/readyz")[:2] for w in (ours, theirs)]
        assert got[0] == got[1] == (200, got[0][1])
        assert got[0][1].startswith("ok serve.view\n")
        assert ours._serve_view_health() == (True, "view v1 (2 players)")
    finally:
        ours.close()
        theirs.close()


def test_worker_readyz_503_on_forced_degradation_equal_jax():
    kw = dict(batch_size=2, idle_timeout=0.0, pipeline=True, pipeline_lag=2)
    ours = Worker(InMemoryBroker(), InMemoryStore(), ServiceConfig(**kw),
                  RatingConfig(), device="cpu", obs_port=0)
    theirs = JaxWorker(JaxInMemoryBroker(), JaxInMemoryStore(),
                       JaxServiceConfig(**kw), JaxRatingConfig(), obs_port=0)
    try:
        for w in (ours, theirs):
            w._disable_pipeline("forced by test")
        got = [http_get(w.obs_server.url + "/readyz")[:2] for w in (ours, theirs)]
        assert got[0] == got[1] and got[0][0] == 503
        assert "fail worker.pipeline: pipeline degraded" in got[0][1]
    finally:
        ours.close()
        theirs.close()
    url = ours.obs_server
    assert url is None  # closed by the worker


def test_worker_metrics_and_statusz_reflect_work():
    broker = InMemoryBroker()
    w = Worker(broker, InMemoryStore(), ServiceConfig(batch_size=2, idle_timeout=0.0),
               RatingConfig(), device="cpu", obs_port=0)
    url = w.obs_server.url
    try:
        broker.publish("analyze", b"missing-1")
        broker.publish("analyze", b"missing-2")
        assert w.poll()
        body = http_get(url + "/metrics")[1]
        assert "worker_acks_total 2" in body
        assert "matches_rated" in http_get(url + "/statusz")[1]
        sloz = json.loads(http_get(url + "/sloz")[1])
        assert sloz["checks"] == 1 and sloz["burning"] == []
        assert json.loads(http_get(url + "/historyz")[1])["samples"] == 1
    finally:
        w.close()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/healthz", timeout=2)


def test_worker_debug_flight_carries_the_worker_config(tmp_path):
    w = Worker(InMemoryBroker(), InMemoryStore(),
               ServiceConfig(batch_size=2, idle_timeout=0.0), RatingConfig(),
               device="cpu", obs_port=0, flight_dir=str(tmp_path))
    try:
        status, body, _ = http_get(w.obs_server.url + "/debug/flight?reason=fleet-slo-t")
        assert status == 200
        with open(os.path.join(json.loads(body)["dumped"], "context.json")) as f:
            ctx = json.load(f)
        assert ctx["config"]["batch_size"] == 2 and ctx["reason"] == "fleet-slo-t"
        assert ctx["config"]["rabbitmq_uri"] == "<redacted>"
    finally:
        w.close()


def test_dead_letter_and_degradation_dump(tmp_path):
    obs.reset_flight_recorder(base_dir=str(tmp_path), min_interval_s=0.0)
    broker = InMemoryBroker()
    w = Worker(broker, InMemoryStore(), ServiceConfig(batch_size=2, idle_timeout=0.0),
               RatingConfig(), device="cpu")

    def boom(ids):
        raise RuntimeError("injected batch failure")

    w.process = boom
    broker.publish("analyze", b"m1")
    broker.publish("analyze", b"m2")
    assert w.poll() and w.dead_letters == 2
    dirs = glob.glob(str(tmp_path / "flight-*dead_letter*"))
    assert len(dirs) == 1
    with open(os.path.join(dirs[0], "snapshot.json")) as f:
        assert json.load(f)["counters"]["worker.dead_letters_total"] == 2
    with open(os.path.join(dirs[0], "events.log")) as f:
        kinds = {json.loads(line)["kind"] for line in f}
    assert {"dead_letter", "log"} <= kinds
    w._disable_pipeline("forced by test")
    assert glob.glob(str(tmp_path / "flight-*pipeline_degraded*"))
    w.close()


def test_sigusr1_dumps_without_stopping_and_sigterm_exits(tmp_path):
    obs.reset_flight_recorder(base_dir=str(tmp_path), min_interval_s=0.0)
    w = Worker(InMemoryBroker(), InMemoryStore(),
               ServiceConfig(batch_size=2, idle_timeout=0.0), RatingConfig(),
               device="cpu")
    before = signal.getsignal(signal.SIGUSR1)
    pid = os.getpid()
    t1 = threading.Timer(0.2, lambda: os.kill(pid, signal.SIGUSR1))
    t2 = threading.Timer(0.7, lambda: os.kill(pid, signal.SIGTERM))
    t1.start()
    t2.start()
    try:
        w.run(install_signal_handlers=True, max_wall_s=30)
    finally:
        t1.cancel()
        t2.cancel()
        w.close()
    assert glob.glob(str(tmp_path / "flight-*sigusr1*"))
    finals = glob.glob(str(tmp_path / "final-snapshot-*.json"))
    assert finals
    with open(finals[0]) as f:
        assert "counters" in json.load(f)
    assert signal.getsignal(signal.SIGUSR1) is before


# -- the CLI ---------------------------------------------------------------------


def test_cli_quality_url_against_a_port_obsd_equals_jax(tmp_path, capsys):
    path = synth_db(str(tmp_path / "q.db"), n=120, p=40)
    broker = InMemoryBroker()
    w = Worker(broker, SqlStore(f"sqlite:///{path}"),
               ServiceConfig(batch_size=16, idle_timeout=0.0), RatingConfig(),
               device="cpu", obs_port=0)
    try:
        conn = sqlite3.connect(path)
        ids = [r[0] for r in conn.execute("SELECT api_id FROM match ORDER BY created_at")]
        conn.close()
        for mid in ids:
            broker.publish("analyze", mid.encode())
        while w.poll():
            pass
        assert w.quality.summary()["matches_scored"] > 0
        url = w.obs_server.url
        for argv in (["quality", "--url", url], ["quality", "--url", url, "--json"]):
            assert cli.main(argv) == 0
            ours = capsys.readouterr().out
            assert jax_cli.main(argv) == 0
            assert ours == capsys.readouterr().out
        payload = json.loads(http_get(url + "/qualityz")[1])
        assert payload["enabled"] is True and payload["matches_scored"] > 0
    finally:
        w.close()
    # the ledger registration went with the worker: /qualityz of a bare
    # obsd says so, and cli quality --url refuses it as JAX's does
    srv = pserver.ObsServer(port=0)
    try:
        assert json.loads(http_get(srv.url + "/qualityz")[1]) == {"enabled": False}
        for main in (cli.main, jax_cli.main):
            assert main(["quality", "--url", srv.url]) == 2
            assert "quality ledger disabled" in capsys.readouterr().err
    finally:
        srv.close()


def _synth(tmp_path, n=300):
    path = str(tmp_path / "s.npz")
    assert cli.main(["synth", "--matches", str(n), "--players", "60",
                     "--out", path]) == 0
    return path


def test_cli_rate_obs_port_equals_the_run_without(tmp_path, capsys, monkeypatch):
    path = _synth(tmp_path)
    started = []
    orig = pserver.ObsServer

    class Recording(orig):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            started.append(self)

    monkeypatch.setattr(pserver, "ObsServer", Recording)
    ck = {}
    for flag in ([], ["--obs-port", "0"]):
        out = str(tmp_path / f"ck{len(flag)}.npz")
        assert cli.main(["rate", "--csv", path, "--device", "cpu", "--kernel",
                         "fused", "--checkpoint", out, *flag]) == 0
        ck[len(flag)] = np.load(out)
    err = capsys.readouterr().err
    assert len(started) == 1
    url = err.split("obsd listening on ")[1].split()[0]
    assert url.startswith("http://127.0.0.1:")
    for key in ck[0].files:
        np.testing.assert_array_equal(ck[0][key], ck[2][key])
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/healthz", timeout=2)


def test_cli_serve_obs_port(tmp_path, capsys, monkeypatch):
    path = _synth(tmp_path, n=200)
    ck = str(tmp_path / "ck.npz")
    assert cli.main(["rate", "--csv", path, "--device", "cpu",
                     "--checkpoint", ck]) == 0
    started = []
    orig = pserver.ObsServer

    class Recording(orig):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            started.append(self)

    monkeypatch.setattr(pserver, "ObsServer", Recording)
    rc = []
    t = threading.Thread(target=lambda: rc.append(cli.main(
        ["serve", "--checkpoint", ck, "--device", "cpu", "--max-seconds", "3",
         "--obs-port", "0"])))
    t.start()
    try:
        deadline = time.monotonic() + 30
        while not started and time.monotonic() < deadline:
            time.sleep(0.05)
        assert started, "obsd never started"
        url = started[0].url
        while time.monotonic() < deadline:
            body = http_get(url + "/metrics")[1]
            if "serve_view_publishes_total 1" in body:
                break
            time.sleep(0.05)
        assert "serve_view_publishes_total 1" in body
        assert http_get(url + "/healthz")[:2] == (200, "ok\n")
    finally:
        t.join(timeout=60)
    assert not t.is_alive() and rc == [0]
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/healthz", timeout=2)
    # the flag parses as JAX's serve parser takes it
    args = cli.build_parser().parse_args(
        ["serve", "--checkpoint", ck, "--obs-port", "9100"])
    assert args.obs_port == 9100
