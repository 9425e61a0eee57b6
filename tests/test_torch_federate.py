"""The port's fleet plane (``analyzer_tpu_torch.obs.federate``: the
Collector, its fleet burns and FleetServer) and ``cli fleet``, against the
JAX package's.

The merge, the burns and the payloads are integer, string and host float
arithmetic over scraped JSON, so the tolerance is 0: two Collectors — one
of each package — fed the same canned snapshots through the same
injectable fetcher (``FakeFleet``) at the same injected times give equal
fleet snapshots, burn states, per-host attribution, flight-dump requests,
``/fleetz`` and fleet ``/sloz`` payloads, and ``check`` results. Over real
sockets, a port FleetServer's routes answer with the JAX FleetServer's
statuses and content types, each package's Collector scrapes the other's
obsd, and ``cli fleet --check`` exits (0 green, 1 burning or down with
``--require-all-up``, 2 without targets) and prints as the JAX CLI does.
Every server binds port 0 and closes in ``finally``.
"""

import json
import re
import urllib.error
import urllib.request

import pytest

import analyzer_tpu.obs as jobs
import analyzer_tpu.obs.federate as jfed
from analyzer_tpu import cli as jax_cli
from analyzer_tpu.obs import server as jserver
from analyzer_tpu.obs.registry import RESERVED_LABELS as J_RESERVED
from analyzer_tpu_torch import cli
from analyzer_tpu_torch import obs
from analyzer_tpu_torch.obs import federate as pfed
from analyzer_tpu_torch.obs import server as pserver
from analyzer_tpu_torch.obs.registry import RESERVED_LABELS


@pytest.fixture(autouse=True)
def fresh_telemetry():
    for mod in (obs, jobs):
        mod.reset_registry()
        mod.reset_flight_recorder()
        mod.reset_history()
        mod.reset_watchdog()
    yield
    for mod in (obs, jobs):
        mod.reset_registry()
        mod.reset_flight_recorder()


def http_get(url: str) -> tuple[int, str, str]:
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return (resp.status, resp.read().decode("utf-8"),
                    resp.headers.get("Content-Type"))
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode("utf-8"), err.headers.get("Content-Type")


def _snap(counters=None, gauges=None, histograms=None) -> dict:
    return {
        "counters": dict(counters or {}),
        "gauges": dict(gauges or {}),
        "histograms": dict(histograms or {}),
    }


class FakeFleet:
    """Canned per-target obsd payloads + a request log: the Collector's
    injectable fetcher, so federation logic runs without sockets."""

    def __init__(self, snapshots: dict) -> None:
        self.snapshots = snapshots
        self.down: set = set()
        self.requests: list = []
        self.flight_requests: list = []

    def fetch(self, url: str, timeout: float = 5.0) -> dict:
        self.requests.append(url)
        target, _, pathq = url[len("http://"):].partition("/")
        path = ("/" + pathq).partition("?")[0]
        if target in self.down:
            raise OSError(f"{target} down")
        if path == "/debug/snapshot":
            return json.loads(json.dumps(self.snapshots[target]))
        if path == "/historyz":
            return {"last_sample_t": 12.0, "samples": 5, "series": {}}
        if path == "/debug/flight":
            self.flight_requests.append(url)
            return {"dumped": f"/tmp/flight-{target}", "reason": "x"}
        raise AssertionError(f"unexpected path {path}")


def test_constants_and_series_keys_equal_jax():
    assert RESERVED_LABELS == J_RESERVED
    assert (pfed.MAX_FLEET_HOSTS, pfed.MAX_FLEET_SERIES) == (
        jfed.MAX_FLEET_HOSTS, jfed.MAX_FLEET_SERIES)
    for key in ("worker.acks_total", "broker.queue_depth{queue=analyze}",
                "x{b=2,a=1}", "slo.state{objective=zero-dead-letters}", "bare{}"):
        for host in ("a:1", "10.0.0.1:9100"):
            assert pfed.fleet_series_key(key, host) == jfed.fleet_series_key(key, host)


# -- the Collector, driven the same way in both packages ----------------------


TARGETS = ("a:1", "b:2", "c:3")


def _fleet_snapshots():
    return {
        "a:1": _snap(
            counters={"worker.matches_rated_total": 5, "worker.acks_total": 1,
                      "worker.dead_letters_total": 0.0},
            gauges={"serve.view_age_seconds": 2.0, "serve.view_version": 3,
                    "broker.queue_depth{queue=analyze}": 9, "flag": True,
                    "label": "x"},
            histograms={"phase_seconds{phase=pack}": {
                "count": 3, "sum": 0.6, "p50": 0.2, "p99": 0.3}},
        ),
        "b:2": _snap(
            counters={"worker.matches_rated_total": 7,
                      "worker.dead_letters_total": 0.0},
            gauges={"serve.view_age_seconds": 44.0, "device.live_buffers": 10},
        ),
        "c:3": _snap(counters={"worker.dead_letters_total": 0.0}),
    }


def _drive(pkg, fed, script):
    """Runs ``script`` (a list of (time, mutation) steps) through one
    package's Collector; returns everything the Collector exposes."""
    fleet = FakeFleet(_fleet_snapshots())
    col = fed.Collector(list(TARGETS), fetch=fleet.fetch, flight_token="tok")
    trail = []
    for t, mutate in script:
        if mutate is not None:
            mutate(fleet)
        burns = col.scrape(t)
        trail.append((
            [(b.objective, b.burning, b.value, b.detail) for b in burns],
            col.fleet_snapshot(), col.burning, col.attribution(),
        ))
    reg = pkg.get_registry()
    counters = {k: v for k, v in reg.snapshot()["counters"].items()
                if k.startswith("fleet.")}
    return (trail, col.fleetz(), col.sloz(), fleet.flight_requests,
            fleet.requests, counters, col.history.to_json())


def _dead_letter_on_b(fleet):
    fleet.snapshots["b:2"]["counters"]["worker.dead_letters_total"] = 3.0


def _c_goes_down(fleet):
    fleet.down.add("c:3")


def _c_comes_back(fleet):
    fleet.down.discard("c:3")


def _stale_everywhere(fleet):
    for snap in fleet.snapshots.values():
        snap["gauges"]["serve.view_age_seconds"] = 40.0


SCRIPTS = {
    "quiet": [(float(t), None) for t in range(0, 200, 20)],
    "dead_letter_burn_and_recovery": [(0.0, None), (30.0, _dead_letter_on_b),
                                      (61.0, None), (75.0, None)]
    + [(float(t), None) for t in range(90, 420, 30)],
    "host_down_and_back": [(0.0, None), (10.0, _c_goes_down), (20.0, None),
                           (30.0, _c_comes_back), (40.0, None)],
    "fleet_wide_staleness": [(0.0, None), (30.0, _stale_everywhere),
                             (61.0, None), (91.0, None)],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_collector_equal_jax(script):
    ours = _drive(obs, pfed, SCRIPTS[script])
    for mod in (obs, jobs):
        mod.reset_registry()
    theirs = _drive(jobs, jfed, SCRIPTS[script])
    assert ours == theirs
    if script == "dead_letter_burn_and_recovery":
        trail, fleetz, sloz, flights, _req, counters, _h = ours
        # b:2's view is 44 s old throughout: staleness burns beside it
        assert trail[2][2] == ["bounded-view-staleness", "zero-dead-letters"]
        assert trail[2][3]["zero-dead-letters"] == ["b:2"]
        dead = [u for u in flights if "zero-dead-letters" in u]
        assert len(dead) == 1 and "token=tok" in dead[0]
        assert dead[0].startswith("http://b:2/debug/flight")
        assert counters["fleet.burns_total"] == 2
        assert counters["fleet.recoveries_total"] == 1
        row = next(o for o in sloz["objectives"] if o["name"] == "zero-dead-letters")
        assert row["state"] == "ok" and sloz["scope"] == "fleet"
    if script == "host_down_and_back":
        assert ours[5]["fleet.scrape_errors_total"] == 2


def test_merge_semantics():
    fleet = FakeFleet(_fleet_snapshots())
    col = pfed.Collector(list(TARGETS), fetch=fleet.fetch)
    col.scrape(1.0)
    merged = col.fleet_snapshot()
    assert merged["counters"]["worker.matches_rated_total"] == 12
    assert merged["counters"]["worker.matches_rated_total{host=a:1}"] == 5
    assert merged["gauges"]["serve.view_age_seconds"] == 44.0
    assert merged["gauges"]["broker.queue_depth{host=a:1,queue=analyze}"] == 9
    assert merged["histograms"]["phase_seconds{host=a:1,phase=pack}"]["p99"] == 0.3
    assert merged["counters"]["fleet.scrapes_total"] == 1
    assert "label" not in merged["gauges"] and merged["gauges"]["flag"] == 1.0
    row = col.fleetz()["hosts"]["a:1"]
    assert (row["history_last_sample_t"], row["history_samples"]) == (12.0, 5)
    assert (row["view_version"], row["view_age_seconds"]) == (3.0, 2.0)


@pytest.mark.parametrize("max_hosts", [1, 2])
def test_host_cap_equal_jax(max_hosts):
    got = []
    for pkg, fed in ((obs, pfed), (jobs, jfed)):
        fleet = FakeFleet(_fleet_snapshots())
        col = fed.Collector(list(TARGETS), fetch=fleet.fetch, max_hosts=max_hosts)
        got.append((col.targets, pkg.get_registry().gauge("fleet.hosts_dropped").value))
    assert got[0] == got[1] == (list(TARGETS[:max_hosts]), 3 - max_hosts)


@pytest.mark.parametrize("case", ["green", "dead_letters", "stale", "down"])
def test_check_equal_jax(case):
    def snaps():
        s = _fleet_snapshots()
        s["b:2"]["gauges"]["serve.view_age_seconds"] = 2.0
        if case == "dead_letters":
            s["b:2"]["counters"]["worker.dead_letters_total"] = 2.0
            s["c:3"]["counters"]["audit.mismatches_total"] = 1.0
        if case == "stale":
            s["c:3"]["gauges"]["serve.view_age_seconds"] = 45.0
        return s

    got = []
    for fed in (pfed, jfed):
        fleet = FakeFleet(snaps())
        if case == "down":
            fleet.down.add("a:1")
        col = fed.Collector(list(TARGETS), fetch=fleet.fetch,
                            request_flight_dumps=False)
        got.append([((b.objective, b.burning, b.value, b.detail), hosts)
                    for b, hosts in col.check(0.0)])
    assert got[0] == got[1]
    names = {burn[0]: hosts for burn, hosts in got[0]}
    want = {"green": {}, "down": {},
            "dead_letters": {"zero-dead-letters": ["b:2"],
                             "zero-audit-mismatches": ["c:3"]},
            "stale": {"bounded-view-staleness": ["c:3"]}}[case]
    assert names == want


# -- over sockets ------------------------------------------------------------------


ROUTES = ["/healthz", "/fleetz", "/sloz", "/metrics", "/historyz",
          "/historyz?series=worker.&tier=10s", "/historyz?tier=2h", "/nope"]


@pytest.fixture
def fleet_servers():
    """A port obsd with some work counted, and a FleetServer of each
    package over a Collector of that package scraping it."""
    obs.get_registry().counter("worker.matches_rated_total").add(10)
    obsd = pserver.ObsServer(port=0)
    servers = []
    try:
        target = f"127.0.0.1:{obsd.port}"
        for fed in (pfed, jfed):
            col = fed.Collector([target], request_flight_dumps=False)
            col.scrape(0.0)
            col.scrape(1.0)
            servers.append(fed.FleetServer(col, port=0))
        yield target, servers
    finally:
        for srv in servers:
            srv.close()
        obsd.close()


@pytest.mark.parametrize("route", ROUTES)
def test_fleet_server_routes_equal_jax(fleet_servers, route):
    _target, servers = fleet_servers
    ours, theirs = (http_get(s.url + route) for s in servers)
    assert ours[0] == theirs[0] and ours[2] == theirs[2]
    if route in ("/healthz", "/historyz?tier=2h", "/nope"):
        assert ours[1] == theirs[1]


def test_fleet_server_surface(fleet_servers):
    target, servers = fleet_servers
    url = servers[0].url
    fz = json.loads(http_get(url + "/fleetz")[1])
    assert fz["up"] == 1 and fz["hosts"][target]["up"] and fz["scrapes"] == 2
    body = http_get(url + "/metrics")[1]
    assert f'worker_matches_rated_total{{host="{target}"}} 10' in body
    hz = json.loads(http_get(url + "/historyz?series=worker.matches")[1])
    assert f"worker.matches_rated_total{{host={target}}}" in hz["series"]
    assert json.loads(http_get(url + "/sloz")[1])["scope"] == "fleet"


def test_collectors_scrape_either_packages_obsd():
    """A JAX obsd and a port obsd answer the same routes with the same
    payload shapes: each package's Collector merges the other's."""
    obs.get_registry().counter("worker.acks_total").add(4)
    jobs.get_registry().counter("worker.acks_total").add(6)
    p_obsd, j_obsd = pserver.ObsServer(port=0), jserver.ObsServer(port=0)
    try:
        targets = [f"127.0.0.1:{p_obsd.port}", f"127.0.0.1:{j_obsd.port}"]
        for fed in (pfed, jfed):
            col = fed.Collector(targets, request_flight_dumps=False)
            col.scrape(0.0)
            merged = col.fleet_snapshot()["counters"]
            assert merged[pfed.fleet_series_key("worker.acks_total", targets[0])] == 4
            assert merged[pfed.fleet_series_key("worker.acks_total", targets[1])] == 6
            assert all(row["up"] for row in col.fleetz()["hosts"].values())
    finally:
        p_obsd.close()
        j_obsd.close()


def _both_clis(argv, capsys):
    rc = cli.main(argv)
    ours = capsys.readouterr()
    jrc = jax_cli.main(argv)
    theirs = capsys.readouterr()
    return (rc, ours), (jrc, theirs)


def _mask(text: str) -> str:
    return re.sub(r"http://127\.0\.0\.1:\d+", "URL", text)


@pytest.mark.parametrize("case", ["green", "burning", "burning_json"])
def test_cli_fleet_check_equal_jax(case, capsys):
    srv = pserver.ObsServer(port=0)
    target = f"127.0.0.1:{srv.port}"
    try:
        if case != "green":
            obs.get_registry().counter("worker.dead_letters_total").add(2)
        argv = ["fleet", "--check", target]
        if case == "burning_json":
            argv = ["fleet", "--check", "--json", "--targets", target]
        (rc, ours), (jrc, theirs) = _both_clis(argv, capsys)
    finally:
        srv.close()
    assert rc == jrc == (0 if case == "green" else 1)
    assert ours.out == theirs.out
    if case == "green":
        assert "fleet ok: 1/1" in ours.out
    else:
        assert f"FLEET BURN: zero-dead-letters [{target}]" in ours.out


def test_cli_fleet_down_target_and_no_targets_equal_jax(capsys):
    (rc, ours), (jrc, theirs) = _both_clis(
        ["fleet", "--check", "--require-all-up", "127.0.0.1:1"], capsys)
    assert rc == jrc == 1 and ours.out == theirs.out
    assert "DOWN: 127.0.0.1:1" in ours.out
    (rc, ours), (jrc, theirs) = _both_clis(
        ["fleet", "--check", "127.0.0.1:1"], capsys)
    assert rc == jrc == 0 and ours.out == theirs.out
    (rc, ours), (jrc, theirs) = _both_clis(["fleet", "--check"], capsys)
    assert rc == jrc == 2 and ours.err == theirs.err
    assert "no targets" in ours.err


def test_cli_fleet_serve_mode_bounded_scrapes(capsys):
    srv = pserver.ObsServer(port=0)
    try:
        (rc, ours), (jrc, theirs) = _both_clis(
            ["fleet", f"127.0.0.1:{srv.port}", "--scrapes", "2",
             "--interval", "0.05"], capsys)
    finally:
        srv.close()
    assert rc == jrc == 0
    assert _mask(ours.out) == _mask(theirs.out)
    assert "fleetd serving /fleetz /metrics /sloz /historyz at URL" in _mask(ours.out)
