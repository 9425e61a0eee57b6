"""The port's live SLO plane — history rings (``obs/history.py``), the SLO
engine and watchdog (``obs/slo.py``), the shadow audit (``obs/audit.py``)
and the flight recorder (``obs/flight.py``) — and the Worker that runs
them, against the JAX package's.

Everything here is integer, string or host float64 arithmetic on the same
inputs, so the tolerance is 0:

  * history: the same registry writes at the same injected times give
    equal ``to_json()`` payloads, window queries and ``render_history``
    text;
  * SLO engine: ``STANDARD_OBJECTIVES`` equal field by field;
    ``evaluate_live`` and ``Watchdog.check`` give the same burns,
    recoveries, ``slo.*`` counters and ``/sloz`` status; ``soak_violations``
    gives the same messages on the JAX tests' artifact dicts, the doctored
    table included;
  * audit: the same sampled set for the same seed and query keys; on a
    port view every served kind replays with 0 mismatches, the port's
    replay equals the JAX auditor's on the same table, and a doctored
    response is caught;
  * flight recorder: a dump has the JAX dump's file set and JSON keys
    (``context.json`` names the loaded torch where JAX's names jax);
  * Worker: with the planes on (obsd, flight recorder, SLO plane with
    every tick, shadow audit of every query, quality ledger) and off, the
    committed rows, every published view and the served responses are
    bit-identical, sequential and pipelined; on ``tests/fakes.py`` graphs
    with the same injected clock the ``slo.*``, ``audit.*`` and
    ``history.*`` counters and the ``stats()["slo"]`` block equal the JAX
    worker's; ``cli history`` renders like JAX's.

Every process-wide singleton of both packages is reset around each test.
"""

import dataclasses
import glob
import json
import os
import sqlite3

import numpy as np
import pytest

import analyzer_tpu.obs as jobs
import analyzer_tpu.obs.slo as jslo
from analyzer_tpu import cli as jax_cli
from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.config import ServiceConfig as JaxServiceConfig
from analyzer_tpu.obs import audit as jaudit
from analyzer_tpu.obs import history as jhistory
from analyzer_tpu.obs import tracer as jtracer
from analyzer_tpu.obs.quality import reset_quality_ledger as j_reset_quality
from analyzer_tpu.serve import ViewPublisher as JaxViewPublisher
from analyzer_tpu.service import InMemoryBroker as JaxInMemoryBroker
from analyzer_tpu.service import InMemoryStore as JaxInMemoryStore
from analyzer_tpu.service import Worker as JaxWorker
from analyzer_tpu_torch import cli
from analyzer_tpu_torch import obs
from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
from analyzer_tpu_torch.obs import audit as paudit
from analyzer_tpu_torch.obs import history as phistory
from analyzer_tpu_torch.obs import slo as pslo
from analyzer_tpu_torch.obs.devicemem import reset_sampler
from analyzer_tpu_torch.obs.quality import reset_quality_ledger
from analyzer_tpu_torch.serve import QueryEngine, ViewPublisher
from analyzer_tpu_torch.service import InMemoryBroker, InMemoryStore, SqlStore, Worker
from tests.test_torch_service import _tie, mem_history
from tests.test_torch_sql_store import dump, synth_db


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
    reset_sampler()


@pytest.fixture(autouse=True)
def fresh_telemetry():
    _reset_all()
    yield
    _reset_all()


class Clock:
    """An injected clock that moves only when the test moves it."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# -- history rings -----------------------------------------------------------


def _write(reg, step: int) -> None:
    """One step of registry traffic: counters (plain and labeled), gauges
    (incl. a bool and a string, which has no trajectory) and a histogram."""
    reg.counter("parity.events_total").add(step % 3)
    reg.counter("parity.events_total", kind="a").add(1)
    reg.gauge("parity.depth").set((step * 7) % 11)
    reg.gauge("parity.flag").set(step % 2 == 0)
    reg.gauge("parity.label").set("x")
    reg.histogram("parity.latency").observe(0.001 * ((step * 13) % 17))
    reg.counter("worker.dead_letters_total").add(1 if step == 40 else 0)


def _filled(pkg_reg, sampler_cls, steps=90, dt=7.0):
    reg = pkg_reg()
    h = sampler_cls(registry=reg)
    for step in range(steps):
        _write(reg, step)
        h.sample(step * dt)
    return h


@pytest.fixture
def both_histories():
    return (
        _filled(obs.reset_registry, phistory.HistorySampler),
        _filled(jobs.reset_registry, jhistory.HistorySampler),
    )


class TestHistoryRings:
    def test_constants_equal_jax(self):
        assert phistory.TIERS == jhistory.TIERS
        assert phistory.MAX_SERIES == jhistory.MAX_SERIES
        assert phistory.HIST_QUANTILES == jhistory.HIST_QUANTILES
        assert phistory.SPARK == jhistory.SPARK

    @pytest.mark.parametrize("prefix,tier", [
        ("parity.", None), ("parity.", "raw"), ("parity.", "10s"),
        ("parity.", "1m"), ("worker.dead", None),
    ])
    def test_to_json_equal_jax(self, both_histories, prefix, tier):
        p, j = both_histories
        assert p.to_json(prefix, tier) == j.to_json(prefix, tier)

    def test_common_series_equal_jax(self, both_histories):
        p, j = both_histories
        # history.series counts every series tracked, and the port's
        # registry declares fewer families than the JAX package's.
        common = sorted(set(p.names()) & set(j.names()) - {"history.series"})
        assert "history.samples_total" in common and len(common) > 20
        for name in common:
            for tier, _b, _c in phistory.TIERS:
                assert p.series(name, tier) == j.series(name, tier), name
            assert p.latest(name) == j.latest(name)
            assert p.last_change(name) == j.last_change(name)
            assert p.sparkline(name) == j.sparkline(name)

    @pytest.mark.parametrize("name", [
        "parity.events_total", "parity.events_total{kind=a}",
        "parity.depth", "parity.latency:p99", "worker.dead_letters_total",
    ])
    @pytest.mark.parametrize("window", [30.0, 60.0, 300.0, 3000.0])
    def test_window_queries_equal_jax(self, both_histories, name, window):
        p, j = both_histories
        for now in (100.0, 400.0, 623.0):
            assert p.window_delta(name, window, now) == j.window_delta(name, window, now)
            assert p.window_max(name, window, now) == j.window_max(name, window, now)
            assert p.window_growth(name, window, now) == j.window_growth(name, window, now)

    @pytest.mark.parametrize("tier", ["raw", "10s", "1m"])
    def test_render_history_equal_jax(self, both_histories, tier):
        p, j = both_histories
        pj, jj = p.to_json("parity."), j.to_json("parity.")
        assert phistory.render_history(pj, tier=tier) == jhistory.render_history(jj, tier=tier)
        names = ["parity.depth", "parity.events_total"]
        assert (phistory.render_history(pj, names=names, width=8)
                == jhistory.render_history(jj, names=names, width=8))
        assert phistory.render_history({}) == jhistory.render_history({})

    def test_probes_run_before_sample_and_never_raise(self):
        reg = obs.reset_registry()
        h = phistory.HistorySampler(registry=reg)
        calls = []

        def probe():
            calls.append(1)
            reg.gauge("parity.probe").set(len(calls))

        def broken():
            raise RuntimeError("probe down")

        h.add_probe(probe)
        h.add_probe(probe)  # idempotent
        h.add_probe(broken)
        h.sample(1.0)
        assert calls == [1] and h.latest("parity.probe") == (1.0, 1.0)
        h.remove_probe(broken)
        h.sample(2.0)
        assert h.samples == 2 and reg.counter("history.samples_total").value == 2

    def test_series_cap_equal_jax(self):
        for pkg, mod in ((obs, phistory), (jobs, jhistory)):
            reg = pkg.reset_registry()
            h = mod.HistorySampler(registry=reg, max_series=5)
            h.sample(0.0)
            assert len(h.names()) == 5
            assert reg.gauge("history.series").value == 5


# -- the SLO engine ------------------------------------------------------------


def _objective_dicts(table):
    return [dataclasses.asdict(o) for o in table]


def test_standard_objectives_equal_jax_field_by_field():
    assert _objective_dicts(pslo.STANDARD_OBJECTIVES) == _objective_dicts(
        jslo.STANDARD_OBJECTIVES)
    assert pslo.LIVE_KINDS == jslo.LIVE_KINDS
    assert sorted(pslo._ARTIFACT_CHECKS) == sorted(jslo._ARTIFACT_CHECKS)


def test_objective_metrics_are_declared_in_the_port():
    from analyzer_tpu_torch.obs import registry as preg

    declared = set(preg.STANDARD_COUNTERS) | set(preg.STANDARD_GAUGES)
    for o in pslo.STANDARD_OBJECTIVES:
        for metric in (o.metric, o.metric_b):
            if metric:
                assert metric in declared, (o.name, metric)
    assert obs.get_registry().counter("jax.retraces_total").value == 0


def _scenario_dead_letter(reg, t):
    if t == 320:
        reg.counter("worker.dead_letters_total").add(2)


def _scenario_audit_mismatch(reg, t):
    if t in (200, 205):
        reg.counter("audit.mismatches_total").add(1)


def _scenario_starving(reg, t):
    reg.counter("feed.starved_total").add(10 if 100 <= t < 500 else 0)


def _scenario_retrace_storm(reg, t):
    reg.counter("jax.retraces_total").add(1 if t >= 150 else 0)


def _scenario_stale_view(reg, t):
    reg.gauge("serve.view_age_seconds").set(45.0 if 250 <= t < 330 else 1.0)


def _scenario_leak(reg, t):
    reg.gauge("device.live_buffers").set(t * 300 if t < 450 else 0)


def _scenario_thrash(reg, t):
    reg.counter("tier.hits_total").add(4 if t < 300 else 60)
    reg.counter("tier.misses_total").add(16 if t < 300 else 1)


def _scenario_miscalibrated(reg, t):
    # 10 matches a second predicted at p=0.95 (bin 9) that go 50/50.
    reg.counter("quality.matches_scored_total").add(10)
    reg.counter("quality.bin_count", bin=9).add(10)
    reg.counter("quality.bin_p_sum", bin=9).add(9.5)
    reg.counter("quality.bin_y_sum", bin=9).add(5.0 if t < 400 else 9.5)


SCENARIOS = [
    _scenario_dead_letter, _scenario_audit_mismatch, _scenario_starving,
    _scenario_retrace_storm, _scenario_stale_view, _scenario_leak,
    _scenario_thrash, _scenario_miscalibrated,
]


def _run_watchdog(pkg, hist_mod, slo_mod, scenario, objectives=None):
    reg = pkg.reset_registry()
    h = hist_mod.HistorySampler(registry=reg)
    onsets = []
    wd = slo_mod.Watchdog(history=h, objectives=objectives,
                          on_burn=lambda o, b: onsets.append((o.name, b.detail)))
    trail = []
    for t in range(0, 700, 5):
        scenario(reg, t)
        h.sample(float(t))
        burns = wd.check(float(t))
        trail.append([dataclasses.asdict(b) for b in burns])
    counters = {k: reg.counter(k).value for k in
                ("slo.burns_total", "slo.recoveries_total")}
    return trail, onsets, counters, wd.status(), wd.healthy()


class TestLiveEvaluation:
    @pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[10:])
    def test_watchdog_equal_jax(self, scenario):
        ours = _run_watchdog(obs, phistory, pslo, scenario)
        theirs = _run_watchdog(jobs, jhistory, jslo, scenario)
        assert ours == theirs
        # every scenario burns something, and burns recover where it ends
        assert ours[2]["slo.burns_total"] >= 1, ours[1]

    @pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[10:])
    def test_evaluate_live_equal_jax(self, scenario):
        hp = _filled_scenario(obs, phistory, scenario)
        hj = _filled_scenario(jobs, jhistory, scenario)
        for op, oj in zip(pslo.STANDARD_OBJECTIVES, jslo.STANDARD_OBJECTIVES):
            for now in (50.0, 330.0, 695.0):
                assert (dataclasses.asdict(pslo.evaluate_live(op, hp, now))
                        == dataclasses.asdict(jslo.evaluate_live(oj, hj, now)))

    def test_young_process_is_not_burning(self):
        h = phistory.HistorySampler(registry=obs.reset_registry())
        wd = pslo.Watchdog(history=h)
        assert all(not b.burning for b in wd.check(0.0))
        assert wd.healthy() == (True, f"{len(wd._state)} objectives ok")

    def test_on_burn_failure_is_logged_not_raised(self, caplog):
        def boom(obj, burn):
            raise RuntimeError("evidence capture down")

        reg = obs.reset_registry()
        h = phistory.HistorySampler(registry=reg)
        wd = pslo.Watchdog(history=h, on_burn=boom)
        for t in range(0, 400, 5):
            _scenario_dead_letter(reg, t)
            h.sample(float(t))
            wd.check(float(t))
        assert reg.counter("slo.burns_total").value == 1


def _filled_scenario(pkg, hist_mod, scenario):
    reg = pkg.reset_registry()
    h = hist_mod.HistorySampler(registry=reg)
    for t in range(0, 700, 5):
        scenario(reg, t)
        h.sample(float(t))
    return h


def _healthy_artifact():
    return {
        "metric": "soak.matches_per_sec", "value": 50.0,
        "latency_ms": {"p99": 5.0},
        "deterministic": {
            "matches_published": 40, "matches_rated": 40,
            "batches_ok": 4, "dead_letters": 0,
            "view_lag_ticks_max": 0, "queue_depth_final": 0,
            "retraces_steady": 0, "drained": True,
        },
        "slo": {"thresholds": {"max_view_lag_ticks": 2}},
        "capture": {"degraded": False},
    }


def _faulty(art):
    d = art["deterministic"]
    d.update(dead_letters=2, retraces_steady=3, view_lag_ticks_max=5,
             drained=False, queue_depth_final=7, matches_rated=30)
    return art


def _audit_mismatch(art):
    art["audit"] = {"mismatches": 1, "checked": 30}
    return art


def _audit_clean(art):
    art["audit"] = {"mismatches": 0, "checked": 30}
    return art


def _miscalibrated(art):
    art["quality"] = {"matches_scored": 5000, "ece": 0.4}
    return art


def _calibrated_low_volume(art):
    art["quality"] = {"matches_scored": 10, "ece": 0.4}
    return art


def _floors(art):
    art["slo"]["thresholds"].update(min_matches_per_sec=100.0, max_p99_ms=1.0)
    return art


def _dominant_stage_missing(art):
    art["slo"]["thresholds"]["forbid_dominant_stages"] = ["ingest"]
    return art


def _dominant_stage_forbidden(art):
    art = _dominant_stage_missing(art)
    art["trace"] = {"dominant_stage": "ingest"}
    return art


def _no_deterministic(art):
    del art["deterministic"]
    return art


ARTIFACTS = [
    lambda a: a, _faulty, _audit_mismatch, _audit_clean, _miscalibrated,
    _calibrated_low_volume, _floors, _dominant_stage_missing,
    _dominant_stage_forbidden, _no_deterministic,
]


def _doctored(slo_mod):
    return slo_mod.STANDARD_OBJECTIVES + (
        slo_mod.Objective(
            "doctored-zero-batches", "counter_zero",
            "worker.batches_ok_total", artifact_check="zero:batches_ok",
            description="trips on ANY healthy work — the canary",
        ),
        slo_mod.Objective("doctored-unknown", "artifact",
                          artifact_check="no_such_check"),
    )


class TestArtifactMode:
    @pytest.mark.parametrize("doctor", ARTIFACTS, ids=lambda f: getattr(
        f, "__name__", "healthy").strip("_"))
    def test_soak_violations_equal_jax(self, doctor):
        got = pslo.soak_violations(doctor(_healthy_artifact()))
        want = jslo.soak_violations(doctor(_healthy_artifact()))
        assert got == want
        if doctor is _faulty:
            v = "\n".join(got)
            assert "dead_letters: 2 (SLO: 0)" in v and "ingest lost work" in v

    @pytest.mark.parametrize("doctor", ARTIFACTS[:3], ids=["healthy", "faulty", "audit"])
    def test_doctored_table_trips_both_consumers_as_jax(self, doctor, monkeypatch):
        monkeypatch.setattr(pslo, "STANDARD_OBJECTIVES", _doctored(pslo))
        monkeypatch.setattr(jslo, "STANDARD_OBJECTIVES", _doctored(jslo))
        got = pslo.soak_violations(doctor(_healthy_artifact()))
        assert got == jslo.soak_violations(doctor(_healthy_artifact()))
        assert any("batches_ok" in v for v in got)
        assert any("no_such_check" in v for v in got)
        # the live consumer walks the same (doctored) table
        reg = obs.reset_registry()
        h = phistory.HistorySampler(registry=reg)
        wd = pslo.Watchdog(history=h)
        for t in range(0, 120, 10):
            h.sample(float(t))
        reg.counter("worker.batches_ok_total").add(1)
        h.sample(120.0)
        wd.check(120.0)
        assert wd.burning == ["doctored-zero-batches"]


# -- the shadow audit ----------------------------------------------------------


def test_sampled_set_equal_jax():
    keys = [paudit.query_key("ratings", (f"p{i}",)) for i in range(400)]
    keys += [paudit.query_key("winprob", ((f"a{i}",), (f"b{i}",))) for i in range(50)]
    keys += [paudit.query_key("leaderboard", k) for k in range(1, 50)]
    keys += [paudit.query_key("percentile", float(v)) for v in range(-30, 30)]
    for key, jkey in zip(keys, keys):
        assert key == jkey
    assert paudit.query_key("tiers", None) == jaudit.query_key("tiers", None)
    for seed in (0, 7, 12345):
        for denom in (1, 2, 8, 64):
            ours = [k for k in keys if paudit.sampled(k, seed, denom)]
            assert ours == [k for k in keys if jaudit.sampled(k, seed, denom)]
    assert 0 < len([k for k in keys if paudit.sampled(k, 7, 8)]) < len(keys) // 2
    assert (paudit.DEFAULT_SAMPLE_DENOM, paudit.MAX_PENDING, paudit.MAX_MISMATCHES) == (
        jaudit.DEFAULT_SAMPLE_DENOM, jaudit.MAX_PENDING, jaudit.MAX_MISMATCHES)


def _seeded_rows(n=40, seed=11):
    """A rated table: the first few players unrated (NaN), seeds set."""
    from analyzer_tpu_torch.core.state import PlayerState

    rng = np.random.default_rng(seed)
    table = PlayerState.create(n, cfg=RatingConfig(), device="cpu").table.numpy()
    rows = table[:n].copy()
    rows[4:, :14] = rng.normal(1500.0, 300.0, (n - 4, 14)).astype(np.float32)
    rows[4:, 7:14] = np.abs(rows[4:, 7:14]) % 400 + 50
    return [f"p{i:03d}" for i in range(n)], rows


QUERIES = [
    ("get_ratings", (["p000", "p005", "p017"],)),
    ("win_probability", (["p004", "p005", "p006"], ["p010", "p011", "p012"])),
    ("leaderboard", (10,)),
    ("tier_histogram", ()),
    ("percentile", (250.0,)),
]


@pytest.fixture
def audited_plane():
    ids, rows = _seeded_rows()
    pub = ViewPublisher(device="cpu")
    pub.publish_rows(ids, rows)
    aud = paudit.ShadowAuditor(cfg=RatingConfig(), seed=3, sample_denom=1)
    engine = QueryEngine(pub, cfg=RatingConfig(), device="cpu", auditor=aud)
    return ids, rows, pub, engine, aud


class TestShadowAudit:
    def test_every_kind_replays_with_zero_mismatches(self, audited_plane):
        _ids, _rows, _pub, engine, aud = audited_plane
        for method, args in QUERIES:
            getattr(engine, method)(*args)
        assert aud.sampled == aud.offered == len(QUERIES) and aud.backlog == 5
        assert aud.drain(limit=2) == 2 and aud.backlog == 3
        assert aud.drain() == 3
        assert aud.mismatch_count == 0 and aud.checked == 5
        reg = obs.get_registry()
        assert reg.counter("audit.sampled_total").value == 5
        assert reg.counter("audit.checked_total").value == 5
        assert reg.counter("audit.mismatches_total").value == 0
        assert reg.gauge("audit.backlog").value == 0
        assert aud.stats() == {"enabled": True, "sample_denom": 1, "offered": 5,
                               "sampled": 5, "checked": 5, "mismatches": 0,
                               "dropped": 0, "backlog": 0}

    def test_replay_equals_jax_auditor_on_the_same_table(self, audited_plane):
        ids, rows, pub, engine, _aud = audited_plane
        jpub = JaxViewPublisher()
        jpub.publish_rows(ids, rows)
        ours = paudit.ShadowAuditor(cfg=RatingConfig(),
                                    tier_edges=engine.tier_edges)
        theirs = jaudit.ShadowAuditor(cfg=JaxRatingConfig())
        payloads = [("ratings", ("p000", "p005", "p017")),
                    ("winprob", (("p004", "p005"), ("p010", "p011"))),
                    ("leaderboard", 7), ("tiers", None), ("percentile", 250.0)]
        for kind, payload in payloads:
            assert (ours._replay(kind, payload, pub.current())
                    == theirs._replay(kind, payload, jpub.current())), kind

    def test_doctored_response_is_caught(self, audited_plane):
        ids, _rows, pub, engine, aud = audited_plane
        resp = engine.get_ratings(ids[5:8])
        aud.drain()
        doctored = json.loads(json.dumps(resp))
        doctored["ratings"][0]["seed_mu"] += 0.5
        aud.offer("ratings", tuple(ids[5:8]), doctored, pub.current())
        aud.drain()
        assert aud.mismatch_count == 1
        assert obs.get_registry().counter("audit.mismatches_total").value == 1
        rec = aud.mismatches[-1]
        assert rec["kind"] == "ratings" and rec["version"] == pub.version
        assert "audit.mismatch" in [e["kind"] for e in obs.get_flight_recorder().events()]

    def test_sampling_is_one_in_denom_of_the_keys(self):
        ids, rows = _seeded_rows()
        pub = ViewPublisher(device="cpu")
        pub.publish_rows(ids, rows)
        aud = paudit.ShadowAuditor(seed=9, sample_denom=4)
        engine = QueryEngine(pub, device="cpu", auditor=aud)
        for pid in ids:
            engine.get_ratings([pid])
        want = [paudit.query_key("ratings", (p,)) for p in ids]
        want = [k for k in want if jaudit.sampled(k, 9, 4)]
        assert aud.offered == len(ids) and aud.sampled == len(want)
        assert [paudit.query_key(k, p) for k, p, _r, _v in aud._pending] == want

    def test_a_refused_query_is_not_offered(self, audited_plane):
        _ids, _rows, _pub, engine, aud = audited_plane
        with pytest.raises(KeyError):
            engine.win_probability(["nobody"], ["p005"])
        assert aud.offered == 0


# -- the flight recorder ---------------------------------------------------------


def _dump(pkg, base):
    rec = pkg.reset_flight_recorder(base_dir=str(base), min_interval_s=30.0)
    rec.note("custom", n=3)
    rec.note_batch(4, 3, first_id="m1")
    pkg.get_registry().counter("worker.acks_total").add(5)
    pkg.get_history().sample(1.0)
    pkg.get_history().sample(2.0)
    first = rec.dump("test-reason", config={"database_uri": "sqlite:///x", "b": 1})
    throttled = rec.dump("test-reason")
    other = rec.dump("other")
    forced = rec.dump("test-reason", force=True)
    return rec, first, throttled, other, forced


class TestFlightRecorder:
    def test_dump_file_set_and_keys_equal_jax(self, tmp_path):
        rec, path, throttled, other, forced = _dump(obs, tmp_path / "port")
        jrec, jpath, jthrottled, jother, jforced = _dump(jobs, tmp_path / "jax")
        assert throttled is None and jthrottled is None
        assert other and jother and forced and jforced
        assert rec.dumps == jrec.dumps == 3
        assert sorted(os.listdir(path)) == sorted(os.listdir(jpath)) == [
            "context.json", "events.log", "history.json", "snapshot.json",
            "trace.jsonl"]
        for name in ("snapshot.json", "history.json"):
            with open(os.path.join(path, name)) as f, \
                    open(os.path.join(jpath, name)) as g:
                assert set(json.load(f)) == set(json.load(g)), name
        with open(os.path.join(path, "context.json")) as f, \
                open(os.path.join(jpath, "context.json")) as g:
            ctx, jctx = json.load(f), json.load(g)
        assert set(ctx) - {"torch"} == set(jctx) - {"jax"}
        assert ctx["config"] == jctx["config"] == {"database_uri": "<redacted>", "b": 1}
        assert ctx["reason"] == jctx["reason"] == "test-reason"
        with open(os.path.join(path, "events.log")) as f, \
                open(os.path.join(jpath, "events.log")) as g:
            ev = [json.loads(line) for line in f]
            jev = [json.loads(line) for line in g]
        assert [(e["kind"], sorted(e)) for e in ev] == [(e["kind"], sorted(e)) for e in jev]
        assert obs.get_registry().counter("obs.flight_dumps_total").value == 3
        with open(os.path.join(path, "history.json")) as f:
            assert json.load(f)["samples"] == 2

    def test_no_base_dir_is_a_breadcrumbed_noop(self):
        rec = obs.reset_flight_recorder()
        assert rec.dump("x") is None
        assert rec.events()[-1]["kind"] == "dump.skipped"

    def test_log_records_reach_the_ring(self):
        from analyzer_tpu_torch.logging_utils import get_logger

        rec = obs.reset_flight_recorder()
        get_logger("analyzer_tpu_torch.test_flight").warning("hello ring")
        assert any(e["kind"] == "log" and e["msg"] == "hello ring"
                   for e in rec.events())


# -- the Worker ----------------------------------------------------------------


def _match_ids(path):
    conn = sqlite3.connect(path)
    try:
        return [r[0] for r in conn.execute(
            "SELECT api_id FROM match ORDER BY created_at, api_id")]
    finally:
        conn.close()


def _queries(engine):
    """Five queries, one of each kind, over the players the current view
    ranks first (every one of them published)."""
    lb = engine.leaderboard(10)
    ids = [e["id"] for e in lb["leaders"]]
    return [
        lb,
        engine.get_ratings(ids[:6]),
        engine.win_probability(ids[:3], ids[3:6]),
        engine.tier_histogram(),
        engine.percentile(0.0),
    ]


def _run_planes(path, planes: bool, pipeline: bool, tmp_path):
    """One Worker over the sqlite file at ``path`` with the serve plane on
    and every obs plane on (audit of every query, an SLO tick every poll)
    or off; returns the rows, every published view, the responses to a
    fixed query set after every flush and at the end, and the stats."""
    if planes:
        kw = dict(obs_port=0, flight_dir=str(tmp_path / "flight"), audit=True,
                  audit_sample_denom=1, slo_plane=True, quality=True,
                  history_interval_s=0.0)
    else:
        kw = dict(slo_plane=False, quality=False)
    broker = InMemoryBroker()
    w = Worker(broker, SqlStore(f"sqlite:///{path}"),
               ServiceConfig(batch_size=16, idle_timeout=0.0), RatingConfig(),
               pipeline=pipeline, serve_port=0, device="cpu", **kw)
    views = []
    publish = w.view_publisher.publish_rows

    def recording(ids, rows):
        view = publish(ids, rows)
        views.append((view.version, view.n_players, view.host_table().copy()))
        return view

    w.view_publisher.publish_rows = recording
    for mid in _match_ids(path):
        broker.publish("analyze", mid.encode())
    served = []
    try:
        for _ in range(1000):
            flushed = w.poll()
            if flushed and w.view_publisher.current() is not None:
                served.append(_queries(w.query_engine))
            if not flushed and broker.qsize("analyze") == 0:
                break
        w.drain()
        served.append(_queries(w.query_engine))
        w.drain()
        stats = w.stats()
    finally:
        w.close()
    return dump(path), views, served, stats, w


@pytest.mark.parametrize("pipeline", [False, True], ids=["sequential", "pipelined"])
def test_worker_planes_on_off_bit_identical(tmp_path, pipeline):
    on = synth_db(str(tmp_path / "on.db"), n=160, p=50)
    off = synth_db(str(tmp_path / "off.db"), n=160, p=50)
    rows_on, views_on, served_on, st_on, w_on = _run_planes(on, True, pipeline, tmp_path)
    rows_off, views_off, served_off, st_off, _ = _run_planes(off, False, pipeline, tmp_path)
    assert rows_on == rows_off
    assert len(views_on) == len(views_off) >= 10
    for (v1, n1, t1), (v2, n2, t2) in zip(views_on, views_off):
        assert (v1, n1) == (v2, n2)
        np.testing.assert_array_equal(t1, t2)
    if pipeline:
        # The writer thread's commits land at harvest times the planes'
        # ticks move, so a round may see another version than its
        # counterpart; every round served at a version both runs saw is
        # equal, the final one (after the drain) included.
        def by_version(served):
            return {r[0]["version"]: r for r in served}

        on_v, off_v = by_version(served_on), by_version(served_off)
        common = sorted(set(on_v) & set(off_v))
        assert common and common[-1] == views_on[-1][0]
        assert all(on_v[v] == off_v[v] for v in common)
    else:
        assert served_on == served_off
    det = ("matches_rated", "batches_ok", "batches_failed", "dead_letters")
    assert {k: st_on[k] for k in det} == {k: st_off[k] for k in det}
    # the planes really ran
    audit = st_on["slo"]["audit"]
    assert audit["checked"] == audit["sampled"] == 5 * len(served_on)
    assert all(len({resp["version"] for resp in r}) == 1 for r in served_on)
    assert audit["mismatches"] == 0 and st_off["slo"] is None
    assert st_on["slo"]["history_samples"] > 10
    # the ledger scores sequential commits (as the JAX worker's does)
    assert bool(st_on["quality"]["matches_scored"]) is not pipeline
    assert w_on.obs_server is None  # closed


def _run_counters(side, clock_step=10.0):
    """A Worker of either package over ``tests/fakes.py`` graphs with one
    winner-tie poison (a dead letter -> the zero-dead-letters burn), the
    serve plane with an audit of 1 in 2 queries, on an injected clock."""
    store, ids, players = mem_history(
        InMemoryStore if side == "port" else JaxInMemoryStore)
    _tie(store)
    clock = Clock()
    if side == "port":
        broker = InMemoryBroker()
        w = Worker(broker, store, ServiceConfig(batch_size=8, idle_timeout=0.0),
                   RatingConfig(), clock=clock, serve_port=0, audit=True,
                   audit_sample_denom=2, audit_seed=5, device="cpu")
        reg = obs.get_registry()
    else:
        broker = JaxInMemoryBroker()
        w = JaxWorker(broker, store, JaxServiceConfig(batch_size=8, idle_timeout=0.0),
                      JaxRatingConfig(), clock=clock, serve_port=0, audit=True,
                      audit_sample_denom=2, audit_seed=5)
        reg = jobs.get_registry()
    pids = [p.api_id for p in players]
    try:
        for mid in ids:
            broker.publish("analyze", mid.encode())
        polls = 0
        while True:
            clock.t += clock_step
            polls += 1
            flushed = w.poll()
            if flushed and w.view_publisher.current() is not None:
                w.query_engine.get_ratings(pids[:3])
                w.query_engine.leaderboard(5)
                w.query_engine.win_probability(pids[:3], pids[3:6])
            if not flushed and broker.qsize("analyze") == 0:
                break
        for _ in range(12):  # slide the 60 s window past the dead letter
            clock.t += clock_step
            w.poll()
        w.drain()
        stats = w.stats()
    finally:
        w.close()
    snap = reg.snapshot()["counters"]
    names = [k for k in snap if k.startswith(("slo.", "audit.", "history."))]
    return {k: snap[k] for k in sorted(names)}, stats, polls


def test_worker_plane_counters_equal_jax():
    ours, st, polls = _run_counters("port")
    theirs, jst, jpolls = _run_counters("jax")
    assert polls == jpolls
    assert ours == theirs
    assert ours["slo.burns_total"] >= 1 and ours["slo.recoveries_total"] >= 1
    assert ours["audit.checked_total"] == ours["audit.sampled_total"] > 0
    assert ours["audit.mismatches_total"] == 0
    assert ours["history.samples_total"] == polls + 12
    assert st["slo"] == jst["slo"]
    assert set(st) == set(jst) and st["dead_letters"] == jst["dead_letters"] == 1


def test_worker_defaults_and_close_release_the_singletons():
    ledger_owner = Worker(InMemoryBroker(), InMemoryStore(), ServiceConfig(),
                          device="cpu")
    assert ledger_owner.history is obs.get_history()
    assert ledger_owner.watchdog.on_burn == ledger_owner._on_slo_burn
    from analyzer_tpu_torch.obs.quality import get_quality_ledger

    assert get_quality_ledger() is ledger_owner.quality is not None
    assert ledger_owner.auditor is None  # no serve plane, no audit
    ledger_owner.close()
    assert obs.get_watchdog().on_burn is None
    assert get_quality_ledger() is None
    off = Worker(InMemoryBroker(), InMemoryStore(), ServiceConfig(),
                 device="cpu", slo_plane=False, quality=False)
    assert off.history is off.watchdog is off.auditor is None
    assert off.stats()["slo"] is None and off.stats()["quality"] is None
    off.close()


def test_worker_stats_keys_equal_jax_with_the_slo_block():
    w = Worker(InMemoryBroker(), InMemoryStore(),
               ServiceConfig(batch_size=2, idle_timeout=0.0), RatingConfig(),
               device="cpu", serve_port=0, audit=True)
    jw = JaxWorker(JaxInMemoryBroker(), JaxInMemoryStore(),
                   JaxServiceConfig(batch_size=2, idle_timeout=0.0),
                   JaxRatingConfig(), serve_port=0, audit=True)
    try:
        w.poll()
        jw.poll()
        s, js = w.stats(), jw.stats()
        assert set(s) == set(js)
        assert set(s["slo"]) == set(js["slo"]) == {"burning", "history_samples", "audit"}
        assert s["slo"] == js["slo"]
    finally:
        w.close()
        jw.close()


def test_slo_burn_dumps_history_into_the_flight_dir(tmp_path):
    clock = Clock()
    w = Worker(InMemoryBroker(), InMemoryStore(),
               ServiceConfig(batch_size=2, idle_timeout=0.0), RatingConfig(),
               clock=clock, flight_dir=str(tmp_path), device="cpu")
    try:
        for _ in range(90):
            clock.t += 1.0
            w.poll()
        obs.get_registry().counter("worker.dead_letters_total").add(2)
        clock.t += 1.0
        w.poll()
        dumps = glob.glob(str(tmp_path / "flight-*slo-zero-dead-letters*"))
        assert dumps, os.listdir(tmp_path)
        with open(os.path.join(dumps[0], "history.json")) as f:
            raw = json.load(f)["series"]["worker.dead_letters_total"]["rings"]["raw"]
        assert raw[0][1] == 0.0 and raw[-1][1] == 2.0
        with open(os.path.join(dumps[0], "events.log")) as f:
            assert "slo.burn" in [json.loads(line)["kind"] for line in f]
        with open(os.path.join(dumps[0], "context.json")) as f:
            ctx = json.load(f)
        assert ctx["config"]["batch_size"] == 2 and ctx["reason"] == "slo-zero-dead-letters"
    finally:
        w.close()


def test_a_failing_tick_is_logged_and_the_loop_goes_on(monkeypatch):
    w = Worker(InMemoryBroker(), InMemoryStore(),
               ServiceConfig(batch_size=2, idle_timeout=0.0), RatingConfig(),
               device="cpu", history_interval_s=0.0)
    logged = []
    monkeypatch.setattr(w.history, "sample",
                        lambda now: (_ for _ in ()).throw(RuntimeError("ring down")))
    monkeypatch.setattr("analyzer_tpu_torch.service.worker.logger.exception",
                        lambda msg, *a: logged.append(msg))
    try:
        assert w.poll() is False
        assert logged == ["SLO plane tick failed"]
    finally:
        w.close()


# -- cli history -----------------------------------------------------------------


def _saved_history(tmp_path):
    reg = obs.reset_registry()
    h = phistory.HistorySampler(registry=reg)
    c = reg.counter("worker.matches_rated_total")
    for t in range(20):
        c.add(3)
        reg.gauge("broker.queue_depth").set(20 - t)
        h.sample(float(t))
    path = tmp_path / "history.json"
    path.write_text(json.dumps(h.to_json()))
    return str(path)


@pytest.mark.parametrize("argv", [
    ["--series", "worker.matches_r"],
    ["--series", "worker.matches_r", "--json"],
    ["--series", "broker.", "--series", "worker.", "--tier", "10s"],
    [],
])
def test_cli_history_equal_jax(tmp_path, capsys, argv):
    path = _saved_history(tmp_path)
    assert cli.main(["history", path, *argv]) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main(["history", path, *argv]) == 0
    assert ours == capsys.readouterr().out
    if argv == ["--series", "worker.matches_r"]:
        assert "worker.matches_rated_total" in ours and "delta=+57" in ours


def test_cli_history_reads_a_flight_dump_and_refuses_a_missing_one(tmp_path, capsys):
    rec = obs.reset_flight_recorder(base_dir=str(tmp_path), min_interval_s=0.0)
    obs.get_registry().counter("worker.acks_total").add(5)
    obs.get_history().sample(1.0)
    obs.get_history().sample(2.0)
    path = rec.dump("test")
    assert cli.main(["history", path, "--series", "worker.acks"]) == 0
    out = capsys.readouterr().out
    assert "worker.acks_total" in out
    assert jax_cli.main(["history", path, "--series", "worker.acks"]) == 0
    assert capsys.readouterr().out == out
    for main in (cli.main, jax_cli.main):
        assert main(["history", str(tmp_path / "nope.json")]) == 2
        assert "cannot read history" in capsys.readouterr().err


def test_audit_under_concurrent_offers_and_drains():
    """Eight client threads query a threaded engine (the tick thread
    offers) while another thread drains, with a short switch interval:
    no sample is lost or counted twice, and nothing mismatches."""
    import sys
    import threading

    ids, rows = _seeded_rows()
    pub = ViewPublisher(device="cpu")
    pub.publish_rows(ids, rows)
    aud = paudit.ShadowAuditor(cfg=RatingConfig(), seed=1, sample_denom=1,
                               max_pending=32)
    engine = QueryEngine(pub, cfg=RatingConfig(), device="cpu", auditor=aud).start()
    done = threading.Event()
    errors = []

    def client(k):
        try:
            for i in range(40):
                engine.get_ratings([ids[(k * 7 + i) % len(ids)]])
        except Exception as err:  # noqa: BLE001 — reported below
            errors.append(err)

    def drainer():
        while not done.is_set():
            aud.drain(limit=5)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        clients = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        drain = threading.Thread(target=drainer)
        drain.start()
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=60)
        done.set()
        drain.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
        engine.close()
    assert not errors and not any(t.is_alive() for t in clients + [drain])
    aud.drain()
    assert aud.offered == aud.sampled == 320
    assert aud.checked + aud.dropped == aud.sampled and aud.backlog == 0
    assert aud.mismatch_count == 0
