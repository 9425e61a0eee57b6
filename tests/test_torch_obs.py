"""The rating path's telemetry in the port against the JAX package's.

Span parity: the same seeded schedule through both packages'
``rate_history`` and ``rate_stream`` (reference kernel; the fused path with
JAX's scan backend, as ``tests/test_torch_fused.py`` runs it; a tiered
run), each under a fresh tracer and registry: the multiset of
``(name, cat, sorted arg keys)`` of the ``batch.*`` / ``feed.*`` spans is
equal, and so are ``sched.steps_total``, ``sched.occupancy`` and the
packing series. The port's ``feed.transfer`` runs on the consumer thread
(its H2D copy is issued there), so its thread differs from JAX's; its
name, category and arguments do not. The port's own staging split and
wait spans (:data:`PORT_SPANS`, ``tests/test_torch_sched.py``) have no
JAX counterpart and are left out of the comparison.

Schema parity: the snapshot's top-level keys, and the declared counters,
gauges, histograms, span names and help texts of the families this slice
emits (``sched.*``, ``feed.*``, ``device.*``, ``profile.*``,
``phase_seconds``) equal the JAX package's, the port's own spans aside.

Then the port's own copies, case by case after ``tests/test_obs.py`` and
``tests/test_feed.py``: exposition and its parser, ``PhaseTimer`` /
``Counters``, the profiler ``trace`` guard, the feed's counters and trace
binding, the device-memory sampler on the CPU, and ``cli rate
--metrics-out / --trace-events``, ``cli metrics`` and ``cli trace``
against the JAX CLI on the same inputs. Tolerance: none — every value
compared here is an integer, a string or a value both packages compute
from the same integers.
"""

import collections
import json
import os
import threading
import time

import numpy as np
import pytest

import analyzer_tpu.sched as jsched
from analyzer_tpu import cli as jax_cli
from analyzer_tpu import obs as jobs
from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.core.state import PlayerState as JaxPlayerState
from analyzer_tpu.obs import registry as jreg
from analyzer_tpu.obs import tracer as jtracer
from analyzer_tpu_torch import cli, obs
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
from analyzer_tpu_torch.obs import devicemem
from analyzer_tpu_torch.obs import registry as preg
from analyzer_tpu_torch.obs.snapshot import parse_prometheus_text
from analyzer_tpu_torch.sched import pack_schedule, rate_history, rate_stream
from analyzer_tpu_torch.sched.feed import DeviceFeed, Prefetcher

CFG = RatingConfig()
JCFG = JaxRatingConfig()
FAMILIES = ("sched.", "feed.", "device.", "profile.", "phase_seconds")

#: The port's spans that the JAX package does not emit: the split of
#: ``feed.materialize`` and the feed's three waits (sched/feed.py).
PORT_SPANS = frozenset({"feed.gather", "feed.plan", "feed.pack",
                        "feed.starved", "feed.backpressure",
                        "feed.wait_assign"})


#: (reset_registry, reset_tracer) of each package.
PORT_RESET = (obs.reset_registry, obs.reset_tracer)
JAX_RESET = (jobs.reset_registry, jtracer.reset_tracer)


@pytest.fixture(autouse=True)
def fresh_obs():
    for resets in (PORT_RESET, JAX_RESET):
        for reset in resets:
            reset()
    yield
    for resets in (PORT_RESET, JAX_RESET):
        for reset in resets:
            reset()


def _setup(n_matches=200, n_players=50, seed=43, batch_size=8):
    players = synthetic_players(n_players, seed=seed)
    stream = synthetic_stream(n_matches, players, seed=seed)
    feats = (players.rank_points_ranked, players.rank_points_blitz,
             players.skill_tier)
    state = PlayerState.create(n_players, *feats, device="cpu")
    jstate = JaxPlayerState.create(n_players, *feats)
    jstream = jsched.MatchStream(stream.player_idx, stream.winner,
                                 stream.mode_id, stream.afk)
    return state, stream, jstate, jstream


def _span_multiset(tracer) -> collections.Counter:
    return collections.Counter(
        (e["name"], e["cat"], tuple(sorted(e["args"])))
        for e in tracer.events()
        if e["ph"] == "X" and e["name"].split(".")[0] in ("batch", "feed")
        and e["name"] not in PORT_SPANS
    )


def _sched_values(reg) -> dict:
    snap = reg.snapshot()
    return {
        "steps": snap["counters"]["sched.steps_total"],
        "pad_slots": snap["counters"]["sched.pad_slots_total"],
        "occupancy": snap["gauges"]["sched.occupancy"],
    }


def _both(run_port, run_jax):
    """Runs each side under a fresh tracer and registry; returns the two
    (span multiset, sched values) pairs."""
    out = []
    for (reset_reg, reset_tr), run in ((PORT_RESET, run_port),
                                       (JAX_RESET, run_jax)):
        reg = reset_reg()
        tracer = reset_tr()
        run()
        out.append((_span_multiset(tracer), _sched_values(reg)))
    return out


# -- span and counter parity ---------------------------------------------


HISTORY_CASES = {
    "reference": dict(kernel="reference"),
    "reference_collect": dict(kernel="reference", collect=True),
    "fused_collect": dict(kernel="fused", fuse_window=4, collect=True),
    "tiered": dict(kernel="reference", hot_rows=32, collect=True),
}


class TestSpanParity:
    @pytest.mark.parametrize("case", sorted(HISTORY_CASES))
    def test_rate_history(self, case):
        kw = dict(HISTORY_CASES[case], steps_per_chunk=6)
        state, stream, jstate, jstream = _setup()
        pad = state.pad_row

        def port():
            sched = pack_schedule(stream, pad_row=pad, batch_size=8)
            rate_history(state, sched, CFG, fuse_backend=(
                "torch" if kw["kernel"] == "fused" else None), **kw)

        def jax():
            sched = jsched.pack_schedule(jstream, pad_row=pad, batch_size=8)
            jsched.rate_history(jstate, sched, JCFG, fuse_backend=(
                "scan" if kw["kernel"] == "fused" else None), **kw)

        (p_spans, p_vals), (j_spans, j_vals) = _both(port, jax)
        assert p_spans == j_spans
        assert p_vals == j_vals
        names = {k[0] for k in p_spans}
        assert {"feed.materialize", "feed.transfer", "batch.compute"} <= names
        assert ("batch.fetch" in names) == bool(kw.get("collect"))

    @pytest.mark.parametrize("kernel", ["reference", "fused"])
    @pytest.mark.parametrize("collect", [False, True])
    def test_rate_stream(self, kernel, collect):
        state, stream, jstate, jstream = _setup(n_matches=300, n_players=60,
                                                seed=11)
        kw = dict(kernel=kernel, collect=collect, steps_per_chunk=7)
        if kernel == "fused":
            kw["fuse_window"] = 4

        def port():
            rate_stream(state, stream, CFG, fuse_backend=(
                "torch" if kernel == "fused" else None), **kw)

        def jax():
            jsched.rate_stream(jstate, jstream, JCFG, fuse_backend=(
                "scan" if kernel == "fused" else None), **kw)

        (p_spans, p_vals), (j_spans, j_vals) = _both(port, jax)
        assert p_spans == j_spans
        # rate_stream packs no schedule object: pad slots stay 0 on both.
        assert p_vals == j_vals

    def test_transfer_runs_on_the_consumer_thread(self):
        state, stream, _j, _js = _setup()
        tracer = obs.reset_tracer()
        sched = pack_schedule(stream, pad_row=state.pad_row, batch_size=8)
        rate_history(state, sched, CFG, collect=True, steps_per_chunk=6)
        me = threading.get_ident() % 1_000_000
        tids = collections.defaultdict(set)
        for e in tracer.events():
            tids[e["name"]].add(e["tid"])
        assert tids["feed.transfer"] == {me}
        assert tids["batch.compute"] == {me} and tids["batch.fetch"] == {me}
        assert me not in tids["feed.materialize"]  # the producer thread

    def test_feed_spans_join_the_bound_trace(self):
        state, stream, _j, _js = _setup()
        tracer = obs.reset_tracer()
        sched = pack_schedule(stream, pad_row=state.pad_row, batch_size=8)
        with obs.bind_trace("b7"):
            rate_history(state, sched, CFG, steps_per_chunk=6)
        feed = [e for e in tracer.events() if e["name"].startswith("feed.")]
        assert feed and all(e["args"]["trace"] == "b7" for e in feed)


# -- schema parity --------------------------------------------------------


def _family(names):
    return sorted(n for n in names if n.startswith(FAMILIES))


class TestSchemaParity:
    def test_snapshot_top_level_keys_equal_jax(self):
        assert set(obs.snapshot()) == set(jobs.snapshot())

    @pytest.mark.parametrize("catalog", [
        "STANDARD_COUNTERS", "STANDARD_GAUGES", "STANDARD_HISTOGRAMS",
    ])
    def test_declared_families_equal_jax(self, catalog):
        assert _family(getattr(preg, catalog)) == _family(getattr(jreg, catalog))

    def test_span_catalog_equal_jax(self):
        def ours(cat):
            return {n for n in cat if n.split(".")[0] in ("batch", "feed")}
        assert ours(preg.SPAN_CATALOG) - PORT_SPANS == ours(jreg.SPAN_CATALOG)
        assert PORT_SPANS <= set(preg.SPAN_CATALOG)
        assert not PORT_SPANS & set(jreg.SPAN_CATALOG)

    def test_help_texts_equal_jax(self):
        keys = _family(jreg.SCHEMA_HELP)
        assert keys == _family(preg.SCHEMA_HELP)
        for k in keys:
            assert preg.SCHEMA_HELP[k] == jreg.SCHEMA_HELP[k], k

    def test_snapshot_series_equal_jax_for_the_families(self):
        p, j = obs.snapshot(), jobs.snapshot()
        for bucket in ("counters", "gauges", "histograms"):
            assert _family(p[bucket]) == _family(j[bucket]), bucket

    def test_retraces_block_is_kept_and_empty(self):
        snap = obs.snapshot()
        assert snap["retraces"] == {}
        assert snap["version"] == jobs.snapshot()["version"] == 1


# -- the port's own copies (after tests/test_obs.py) ----------------------


class TestExposition:
    def test_snapshot_shape(self):
        obs.get_registry().counter("c").add(1)
        with obs.get_tracer().span("s"):
            pass
        snap = obs.snapshot()
        assert {"ts", "counters", "gauges", "histograms", "retraces",
                "spans", "spans_dropped"} <= set(snap)
        assert json.loads(json.dumps(snap)) == snap

    def test_prometheus_text_equals_jax(self):
        for pkg in (obs, jobs):
            reg = pkg.get_registry()
            reg.counter("sched.steps_total").add(5)
            reg.gauge("feed.depth").set(2)
            reg.histogram("phase_seconds", phase="pack").observe(0.25)
        p = obs.prometheus_text(obs.snapshot(max_spans=0))
        j = jobs.prometheus_text(jobs.snapshot(max_spans=0))
        assert "sched_steps_total 5" in p
        assert 'phase_seconds{phase="pack",quantile="0.50"} 0.25' in p

        def fam(text):
            out = []
            for ln in text.splitlines():
                name = (ln.split(" ")[2] if ln.startswith("# ")
                        else ln.split("{")[0].split(" ")[0])
                if name.startswith(("sched_", "feed_", "phase_seconds")):
                    out.append(ln)
            return out
        assert fam(p) == fam(j) and fam(p)

    def test_exposition_round_trips_through_the_parser(self):
        reg = obs.get_registry()
        reg.counter("sched.steps_total").add(5)
        reg.gauge("sched.occupancy").set(0.5)
        h = reg.histogram("phase_seconds", phase="pack")
        for i in range(20):
            h.observe(i * 0.01)
        snap = obs.snapshot(max_spans=0)
        parsed = parse_prometheus_text(obs.prometheus_text(snap))
        for key, value in snap["counters"].items():
            assert parsed["counters"][key] == pytest.approx(value), key
        assert parsed["gauges"]["sched.occupancy"] == 0.5
        hist = parsed["histograms"]["phase_seconds{phase=pack}"]
        assert hist["count"] == 20
        assert parsed["types"]["sched.steps_total"] == "counter"
        assert parsed["help"]["sched.steps_total"] == (
            "supersteps dispatched by the scan runners")

    def test_render_summary(self):
        obs.get_registry().counter("feed.starved_total").add(2)
        out = obs.render_summary(obs.snapshot())
        assert "feed.starved_total = 2" in out and "spans:" in out


class TestLegacyViews:
    def test_phase_timer_mirrors_registry_and_tracer(self):
        from analyzer_tpu_torch.utils import PhaseTimer

        t = PhaseTimer()
        with t.phase("pack"):
            pass
        with t.phase("pack"):
            pass
        assert t.counts["pack"] == 2
        hist = obs.get_registry().snapshot()["histograms"]
        assert hist["phase_seconds{phase=pack}"]["count"] == 2
        assert [e["name"] for e in obs.get_tracer().events()] == [
            "phase.pack", "phase.pack"]
        assert t.report()["pack"] >= 0 and "pack=" in t.summary()

    def test_counters_rate_anchors_on_first_add(self, monkeypatch):
        import analyzer_tpu_torch.utils.profiling as prof

        now = [0.0]
        monkeypatch.setattr(prof.time, "perf_counter", lambda: now[0])
        c = prof.Counters()
        now[0] = 500.0
        c.add("matches", 100)
        now[0] = 510.0
        assert c.rate("matches") == pytest.approx(10.0)
        assert c.rate("never_added") == 0.0
        c.reset()
        assert c.report() == {}
        assert obs.get_registry().snapshot()["counters"]["app.matches_total"] == 100

    def test_cli_uses_the_shared_phase_timer(self):
        from analyzer_tpu_torch.utils.profiling import PhaseTimer

        assert cli.PhaseTimer is PhaseTimer


class TestProfilerTrace:
    def test_body_exception_propagates(self, tmp_path):
        from analyzer_tpu_torch.utils import trace

        with pytest.raises(ValueError, match="the real error"):
            with trace(str(tmp_path / "cap")):
                raise ValueError("the real error")

    def test_disabled_trace_propagates_too(self):
        from analyzer_tpu_torch.utils import trace

        with pytest.raises(ValueError):
            with trace(None):
                raise ValueError("x")

    def test_profiler_start_failure_degrades_to_noop(self, monkeypatch):
        from analyzer_tpu_torch.obs import prof
        from analyzer_tpu_torch.utils import trace

        def boom(*_a, **_k):
            raise RuntimeError("backend can't profile")

        monkeypatch.setattr(prof, "_start_trace", boom)
        ran = []
        with trace("/tmp/ignored"):
            ran.append(True)
        assert ran == [True]

    def test_capture_has_the_layout_profview_reads(self, tmp_path):
        import torch

        from analyzer_tpu_torch.obs.profview import analyze_capture, find_trace_files
        from analyzer_tpu_torch.utils import trace

        with trace(str(tmp_path)):
            torch.ones(64).add_(1)
        rels = find_trace_files(str(tmp_path))
        assert len(rels) == 1
        parts = rels[0].split(os.sep)
        assert parts[:2] == ["plugins", "profile"] and len(parts) == 4
        assert parts[3].endswith(".trace.json.gz")
        att = analyze_capture(str(tmp_path), update_metrics=False)
        # A CPU-only capture parses, and finds no device lane: its process
        # is named after the interpreter, not "GPU <n>".
        assert att["parsed"] is True and att["device"]["lanes"] == 0


class TestFeedCounters:
    def test_put_blocks_at_depth_and_counts_backpressure(self):
        feed = DeviceFeed(1)
        feed.put(1)
        done = []

        def producer():
            feed.put(2)
            done.append(True)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        time.sleep(0.05)
        assert not done
        assert feed.get() == 1
        t.join(timeout=5)
        assert done and feed.get() == 2
        assert obs.get_registry().counter("feed.backpressure_total").value >= 1

    def test_get_blocks_until_put_and_counts_starvation(self):
        feed = DeviceFeed(2)
        got = []
        t = threading.Thread(target=lambda: got.append(feed.get()), daemon=True)
        t.start()
        time.sleep(0.05)
        assert not got
        feed.put("x")
        t.join(timeout=5)
        assert got == ["x"]
        assert obs.get_registry().counter("feed.starved_total").value >= 1

    def test_depth_gauge_tracks_occupancy(self):
        feed = DeviceFeed(3)
        g = obs.get_registry().gauge("feed.depth")
        feed.put(1)
        feed.put(2)
        assert g.value == 2
        feed.get()
        assert g.value == 1

    def test_prefetcher_rebinds_the_constructing_trace(self):
        tracer = obs.get_tracer()

        def producer(put):
            with tracer.span("feed.materialize", cat="sched", start=0):
                pass
            put(1)

        with obs.bind_trace("b3"), Prefetcher(producer) as pf:
            assert list(pf) == [1]
        (ev,) = tracer.events()
        assert ev["args"] == {"start": 0, "trace": "b3"}


class TestDeviceMemory:
    def test_cpu_sample_counts_live_tensors(self):
        import torch

        keep = torch.zeros(1000)  # 4,000 bytes at least
        out = devicemem.sample_device_memory()
        cpu = out["cpu:0"]
        assert cpu["source"] == "live_tensors" and cpu["bytes_limit"] is None
        assert cpu["bytes_in_use"] >= keep.nbytes and cpu["live_buffers"] >= 1
        snap = obs.get_registry().snapshot()["gauges"]
        assert snap["device.hbm_bytes_in_use{device=cpu:0}"] == cpu["bytes_in_use"]
        assert snap["device.live_buffers"] == cpu["live_buffers"]

    def test_maybe_sample_throttles(self):
        devicemem.reset_sampler()
        try:
            assert devicemem.maybe_sample(min_interval_s=60.0) is True
            assert devicemem.maybe_sample(min_interval_s=60.0) is False
        finally:
            devicemem.reset_sampler()

    def test_tier_registers_its_host_bytes(self):
        from analyzer_tpu_torch.sched.tier import TierManager

        state = PlayerState.create(40, device="cpu")
        mgr = TierManager(state, 16)
        out = devicemem.sample_device_memory()
        assert out["host"]["tier_bytes"] >= mgr.host_nbytes
        assert obs.get_registry().gauge("tier.host_bytes").value == (
            out["host"]["tier_bytes"])

    def test_runner_samples_at_chunk_boundaries(self):
        state, stream, _j, _js = _setup()
        devicemem.reset_sampler()
        sched = pack_schedule(stream, pad_row=state.pad_row, batch_size=8)
        rate_history(state, sched, CFG, steps_per_chunk=6)
        gauges = obs.get_registry().snapshot()["gauges"]
        assert gauges["device.live_buffers{device=cpu:0}"] > 0


# -- the command line -------------------------------------------------------


def _synth(tmp_path, n=300):
    path = str(tmp_path / "h.npz")
    assert cli.main(["synth", "--matches", str(n), "--players", "90",
                     "--out", path]) == 0
    return path


class TestCliSurface:
    def test_rate_metrics_out_and_trace_events(self, tmp_path, capsys):
        path = _synth(tmp_path)
        m, t = str(tmp_path / "m.json"), str(tmp_path / "t.jsonl")
        assert cli.main(["rate", "--csv", path, "--device", "cpu",
                         "--metrics-out", m, "--trace-events", t]) == 0
        snap = json.load(open(m))
        names = {e["name"] for e in snap["spans"]}
        assert {"batch.compute", "feed.materialize", "feed.transfer",
                "phase.rate"} <= names
        assert snap["counters"]["sched.steps_total"] > 0
        assert any(k.startswith("phase_seconds") for k in snap["histograms"])
        lines = [json.loads(ln) for ln in open(t)]
        assert lines[0]["name"] == "trace_epoch"
        for e in lines:
            assert {"name", "ph", "ts", "pid", "tid"} <= set(e)
        err = capsys.readouterr().err
        assert "wrote metrics snapshot" in err and "Chrome trace events" in err

    def test_rate_snapshot_matches_jax_cli(self, tmp_path, capsys):
        """Same stream file through both CLIs' packed path: the span names
        and the sched series of the two snapshots are equal."""
        path = _synth(tmp_path)
        snaps = []
        for resets, main, extra in ((PORT_RESET, cli.main, ["--device", "cpu"]),
                                    (JAX_RESET, jax_cli.main, [])):
            for reset in resets:
                reset()
            m = str(tmp_path / f"m_{len(snaps)}.json")
            assert main(["rate", "--csv", path, "--checkpoint",
                         str(tmp_path / f"ck{len(snaps)}.npz"),
                         "--checkpoint-every", "8", "--metrics-out", m,
                         *extra]) == 0
            snaps.append(json.load(open(m)))
        capsys.readouterr()
        p, j = snaps

        def spans(s):
            return collections.Counter(
                e["name"] for e in s["spans"]
                if e["name"].split(".")[0] in ("batch", "feed", "phase")
                and e["name"] not in PORT_SPANS)

        assert spans(p) == spans(j)
        for key in ("sched.steps_total", "sched.pad_slots_total"):
            assert p["counters"][key] == j["counters"][key], key
        assert p["gauges"]["sched.occupancy"] == j["gauges"]["sched.occupancy"]
        assert set(p) == set(j)

    def test_metrics_subcommand_renders_snapshot(self, tmp_path, capsys):
        obs.get_registry().counter("sched.steps_total").add(3)
        m = str(tmp_path / "m.json")
        obs.write_snapshot(m)
        for main in (cli.main, jax_cli.main):
            assert main(["metrics", m]) == 0
            out = json.loads(capsys.readouterr().out)
            assert out["counters"]["sched.steps_total"] == 3
        outs = []
        for main in (cli.main, jax_cli.main):
            assert main(["metrics", m, "--format", "summary"]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and "sched.steps_total = 3" in outs[0]
        assert cli.main(["metrics", m, "--format", "prom"]) == 0
        assert "sched_steps_total 3" in capsys.readouterr().out

    def test_metrics_subcommand_live_and_missing_file(self, capsys):
        assert cli.main(["metrics"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert "feed.starved_total" in out["counters"]
        for main in (cli.main, jax_cli.main):
            assert main(["metrics", "/nonexistent/x.json"]) == 2
        capsys.readouterr()

    def test_trace_of_a_rate_export_exits_2_as_jax(self, tmp_path, capsys):
        path = _synth(tmp_path)
        t = str(tmp_path / "t.jsonl")
        assert cli.main(["rate", "--csv", path, "--device", "cpu",
                         "--trace-events", t]) == 0
        capsys.readouterr()
        for main in (cli.main, jax_cli.main):
            assert main(["trace", t]) == 2
            assert "no causal-trace events" in capsys.readouterr().err
        for main in (cli.main, jax_cli.main):
            assert main(["trace", str(tmp_path / "nope.jsonl")]) == 2
        capsys.readouterr()

    @pytest.mark.parametrize("argv,item", [
        (("--mesh", "2"), "mesh_devices"),
        (("--obs-port", "0", "--mesh", "2"), "mesh_devices"),
    ])
    def test_unported_rate_flags_exit_2(self, tmp_path, capsys, argv, item):
        """``--mesh`` is ported, with or without ``--obs-port`` (obsd
        starts first): the run exits 0, its stats line carries
        ``mesh_devices`` and ``processes`` and equals the single-device
        run's."""
        path = _synth(tmp_path)
        capsys.readouterr()
        assert cli.main(["rate", "--csv", path, "--device", "cpu"]) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert cli.main(["rate", "--csv", path, "--device", "cpu", *argv]) == 0
        captured = capsys.readouterr()
        got = json.loads([ln for ln in captured.out.splitlines()
                          if ln.startswith("{")][-1])  # loggers share stdout
        assert (got[item], got["processes"]) == (2, 1)
        for key in ("matches", "players_rated", "mean_mu"):
            assert got[key] == want[key], key
        if "--obs-port" in argv:
            assert captured.err.startswith("obsd listening")

    def test_rate_trace_writes_a_capture_cli_profile_parses(self, tmp_path,
                                                            capsys):
        path = _synth(tmp_path, n=60)
        cap = str(tmp_path / "cap")
        assert cli.main(["rate", "--csv", path, "--device", "cpu",
                         "--trace", cap]) == 0
        capsys.readouterr()
        assert cli.main(["profile", cap, "--json"]) == 0
        att = json.loads(capsys.readouterr().out)
        assert att["parsed"] is True and att["trace_files"]
        # Kernels run on the CPU here: the host lane holds the operators.
        assert att["device"]["lanes"] == 0


def test_rate_history_counts_steps_from_start_step():
    state, stream, _j, _js = _setup()
    sched = pack_schedule(stream, pad_row=state.pad_row, batch_size=8)
    reg = obs.reset_registry()
    rate_history(state, sched, CFG, start_step=5, stop_after=17,
                 steps_per_chunk=6)
    assert reg.counter("sched.steps_total").value == 12
    assert reg.gauge("sched.occupancy").value == round(sched.occupancy, 4)
    assert np.isfinite(reg.gauge("sched.occupancy").value)
