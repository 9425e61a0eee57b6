"""Device-time attribution in the port against the JAX package's.

  * ``obs/profview.py`` — the port's ``analyze_capture`` returns the same
    dict as JAX's on the committed capture fixtures
    (``tests/fixtures/profile_ok`` and ``profile_torn``, read, never
    written) and on a Kineto-format trace built here in both of Kineto's
    shapes — the device lane named "GPU 0", and (torch 2.11 on the card)
    every process named "python3" with "GPU 0" in ``process_labels``,
    which only the port reads — with ``cat: "kernel"`` and ``gpu_memcpy``
    events and host-side operator, runtime and overhead events,
    attributing to a busy time known in advance. ``decompose_dispatch``
    and the renderers equal JAX's too.
  * ``obs/traceview.py`` — the port's copy builds the same model, reports
    and critical path as JAX's on the same events.
  * ``obs/prof.py`` — ``DeviceProfiler`` (latch, per-reason throttle,
    force, a start that fails, the manifest and its join keys), ported
    case by case from ``tests/test_trace.py::TestDeviceProfiler`` and
    ``tests/test_profile_intel.py::TestCaptureManifest``.
  * ``obs/hw.py`` — ``tests/test_profile_intel.py::TestHwPeaks`` case by
    case, plus the H100 row.
  * ``cli profile`` / ``cli trace`` — exit codes and JSON equal to the JAX
    CLI's on the same inputs.

Tolerance: none — both packages run the same arithmetic on the same
parsed JSON numbers.
"""

import gzip
import json
import os

import pytest

from analyzer_tpu import cli as jax_cli
from analyzer_tpu.obs import profview as jprofview
from analyzer_tpu.obs import traceview as jtraceview
from analyzer_tpu_torch import cli, obs
from analyzer_tpu_torch.obs import hw, profview, traceview
from tests.test_profile_intel import _host_events
from tests.test_trace import _synthetic_events

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
OK_DIR = os.path.join(FIXTURES, "profile_ok")
TORN_DIR = os.path.join(FIXTURES, "profile_torn")


@pytest.fixture(autouse=True)
def fresh_registry():
    obs.reset_registry()
    yield
    obs.reset_registry()


def kineto_capture(root, labelled: bool) -> str:
    """A capture directory holding a trace in the shape ``torch.profiler``
    exports: a host process (operators, runtime calls, the profiler's own
    span lane and its overhead events on pid -1) and a device process on
    stream 7 with two kernels and one copy. ``labelled``: torch 2.11's
    shape on the card, both processes named "python3" and told apart by
    ``process_labels`` ("CPU", "GPU 0"); else the device process is named
    "GPU 0". Device busy: [90,95) + [100,150) + [200,260) = 115 us over
    the [90,260) window: idle 55 us."""
    host, gpu = 4242, 0

    def meta(pid, name):
        if labelled and pid in (host, gpu):
            name = "python3"
        return {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": name}}

    def x(pid, tid, cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
                "ts": ts, "dur": dur, "args": {}}

    kernel = "fused_window_kernel(float*, int const*, int const*)"
    events = [
        meta(host, "python"),
        {"ph": "M", "name": "process_labels", "pid": host, "tid": 0,
         "args": {"labels": "CPU"}},
        meta(gpu, "GPU 0"),
        {"ph": "M", "name": "process_labels", "pid": gpu, "tid": 0,
         "args": {"labels": "GPU 0" if labelled else "NVIDIA H100 80GB HBM3"}},
        meta("Spans", "Spans"),
        x("Spans", "PyTorch Profiler", "Trace", "PyTorch Profiler (0)", 0.0, 400.0),
        x(host, host, "cpu_op", "aten::index_select", 80.0, 12.0),
        x(host, host, "cuda_runtime", "cudaMemcpyAsync", 85.0, 4.0),
        x(host, host, "cuda_runtime", "cudaLaunchKernelExC", 96.0, 3.0),
        x(host, host, "cuda_runtime", "cudaLaunchKernelExC", 196.0, 3.0),
        x(gpu, 7, "gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 90.0, 5.0),
        x(gpu, 7, "kernel", kernel, 100.0, 50.0),
        x(gpu, 7, "kernel", kernel, 200.0, 60.0),
        x(-1, 0, "overhead", "Activity Buffer Request", 60.0, 8.0),
        {"ph": "f", "id": 1, "pid": gpu, "tid": 7, "ts": 100.0,
         "cat": "ac2g", "name": "ac2g", "bp": "e"},
    ]
    run = os.path.join(str(root), "plugins", "profile", "2026_01_01_00_00_00")
    os.makedirs(run)
    with gzip.open(os.path.join(run, "host.trace.json.gz"), "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    return str(root)


class TestAttributionParity:
    @pytest.mark.parametrize("capture", [OK_DIR, TORN_DIR])
    def test_fixture_attribution_equals_jax(self, capture):
        got = profview.analyze_capture(capture, update_metrics=False)
        want = jprofview.analyze_capture(capture, update_metrics=False)
        assert got == want
        assert profview.render_attribution(got) == jprofview.render_attribution(want)

    def test_ok_fixture_numbers(self):
        att = profview.analyze_capture(OK_DIR, update_metrics=False)
        assert att["parsed"] is True and att["dominant_kernel"] == "fusion.update"
        assert att["device"]["busy_us"] == pytest.approx(350.0)
        assert att["device"]["idle_frac"] == pytest.approx(0.3)

    @pytest.mark.parametrize("labelled", [False, True],
                             ids=["named", "labelled"])
    def test_kineto_trace_attributes_to_its_known_busy_time(self, tmp_path,
                                                            labelled):
        cap = kineto_capture(tmp_path, labelled)
        att = profview.analyze_capture(cap, update_metrics=False)
        want = jprofview.analyze_capture(cap, update_metrics=False)
        if labelled:
            # The JAX parser reads process names only: it finds no device
            # lane in this shape, the port's finds the labelled one.
            assert want["device"]["lanes"] == 0
        else:
            assert att == want
        assert att["parsed"] is True and att["error"] is None
        dev = att["device"]
        assert dev["busy_us"] == pytest.approx(115.0)
        assert dev["window_us"] == pytest.approx(170.0)
        assert dev["idle_us"] == pytest.approx(55.0)
        assert dev["idle_frac"] == pytest.approx(round(55.0 / 170.0, 4))
        assert dev["lanes"] == 1  # GPU 0, stream 7; host lanes excluded
        k0, k1 = att["kernels"]
        assert k0["name"].startswith("fused_window_kernel")
        assert (k0["count"], k0["total_us"]) == (2, 110.0)
        assert k1["name"].startswith("Memcpy HtoD")
        assert att["dominant_kernel"] == k0["name"]
        # Nothing is compiled inside a port capture: the field stays, at 0.
        assert att["compile"]["compile_us"] == 0.0
        assert att["compile"]["compile_frac"] == 0.0

    def test_missing_and_empty_dirs(self, tmp_path):
        for fn in (profview.analyze_capture, jprofview.analyze_capture):
            att = fn(str(tmp_path / "nope"), update_metrics=False)
            assert att["parsed"] is False
            assert "no such capture directory" in att["error"]
            att = fn(str(tmp_path), update_metrics=False)
            assert att["parsed"] is False and "no trace.json" in att["error"]

    def test_metrics_update_on_success_only(self):
        reg = obs.reset_registry()
        profview.analyze_capture(TORN_DIR)
        assert reg.counter("profile.captures_parsed_total").value == 0
        profview.analyze_capture(OK_DIR)
        assert reg.counter("profile.captures_parsed_total").value == 1
        assert reg.gauge("profile.device_idle_frac").value == pytest.approx(0.3)

    def test_trace_file_discovery_equals_jax(self, tmp_path):
        (tmp_path / "b").mkdir()
        (tmp_path / "b" / "z.trace.json").write_text("[]")
        (tmp_path / "a.trace.json.gz").write_bytes(gzip.compress(b"[]"))
        (tmp_path / "notes.txt").write_text("x")
        got = profview.find_trace_files(str(tmp_path))
        assert got == jprofview.find_trace_files(str(tmp_path))
        assert got == ["a.trace.json.gz", os.path.join("b", "z.trace.json")]


class TestJoinParity:
    @pytest.mark.parametrize("batches", [("b1",), ("b1", "b2")])
    def test_decompose_dispatch_equals_jax(self, batches):
        events = _host_events(batches)
        att = profview.analyze_capture(OK_DIR, update_metrics=False)
        got = profview.decompose_dispatch(traceview.build_model(events), att)
        want = jprofview.decompose_dispatch(jtraceview.build_model(events), att)
        assert got == want and got["scope"] == "manifest"
        assert profview.render_decomposition(got) == (
            jprofview.render_decomposition(want))

    def test_unparsed_joins_return_none(self):
        att = profview.analyze_capture(TORN_DIR, update_metrics=False)
        model = traceview.build_model(_host_events())
        assert profview.decompose_dispatch(model, att) is None

    def test_traceview_reports_equal_jax(self):
        events = _synthetic_events()
        m, jm = traceview.build_model(events), jtraceview.build_model(events)
        assert traceview.critical_path(m) == jtraceview.critical_path(jm)
        for match in ("m1", "m2"):
            assert traceview.match_report(m, match) == jtraceview.match_report(
                jm, match)
            assert traceview.verify_chain(m, match) == []
        assert traceview.render_critical_path(traceview.critical_path(m)) == (
            jtraceview.render_critical_path(jtraceview.critical_path(jm)))
        assert traceview.STAGE_OF == jtraceview.STAGE_OF
        assert traceview.STAGES == jtraceview.STAGES


class TestDeviceProfiler:
    def _stubbed(self, monkeypatch, tmp_path, **kw):
        from analyzer_tpu_torch.obs import prof

        calls = []
        monkeypatch.setattr(prof, "_start_trace", lambda p: calls.append(("start", p)))
        monkeypatch.setattr(prof, "_stop_trace", lambda: calls.append(("stop",)))
        return prof.DeviceProfiler(profile_dir=str(tmp_path), **kw), calls

    def test_unarmed_is_inert(self, monkeypatch):
        from analyzer_tpu_torch.obs.prof import ENV_DIR, DeviceProfiler

        monkeypatch.delenv(ENV_DIR, raising=False)
        p = DeviceProfiler(profile_dir=None)
        assert not p.armed
        assert p.request("dead_letter") is False
        with p.maybe_capture():
            pass
        assert p.captures == 0 and p.capture_info() is None

    def test_env_arms_it(self, monkeypatch, tmp_path):
        from analyzer_tpu_torch.obs.prof import ENV_DIR, DeviceProfiler

        monkeypatch.setenv(ENV_DIR, str(tmp_path))
        assert DeviceProfiler().profile_dir == str(tmp_path)

    def test_latch_captures_exactly_the_next_window(self, monkeypatch, tmp_path):
        p, calls = self._stubbed(monkeypatch, tmp_path)
        assert p.request("sigusr2", force=True)
        with p.maybe_capture():
            pass
        with p.maybe_capture():
            pass
        assert [c[0] for c in calls] == ["start", "stop"]
        assert p.captures == 1
        assert p.last_capture is not None and "sigusr2" in p.last_capture
        info = p.capture_info()
        assert info["captures"] == 1 and info["dir"] == str(tmp_path)

    def test_throttle_is_per_reason_and_force_bypasses(self, monkeypatch, tmp_path):
        clock = {"t": 0.0}
        p, _ = self._stubbed(monkeypatch, tmp_path, min_interval_s=60.0,
                             clock=lambda: clock["t"])
        assert p.request("dead_letter") is True
        clock["t"] = 10.0
        assert p.request("dead_letter") is False
        assert p.request("pipeline_degraded") is True
        assert p.request("dead_letter", force=True) is True

    def test_start_failure_never_breaks_the_window(self, monkeypatch, tmp_path):
        from analyzer_tpu_torch.obs import prof

        def boom(_p):
            raise RuntimeError("no backend")

        monkeypatch.setattr(prof, "_start_trace", boom)
        p = prof.DeviceProfiler(profile_dir=str(tmp_path))
        p.request("sigusr2", force=True)
        ran = []
        with p.maybe_capture():
            ran.append(True)
        assert ran == [True] and p.captures == 0

    def test_body_error_still_stops_the_capture(self, monkeypatch, tmp_path):
        p, calls = self._stubbed(monkeypatch, tmp_path)
        p.request("sigusr2", force=True)
        with pytest.raises(ValueError):
            with p.maybe_capture():
                raise ValueError("batch failed")
        assert [c[0] for c in calls] == ["start", "stop"]

    def test_capture_writes_manifest_with_join_keys(self, monkeypatch, tmp_path):
        p, _calls = self._stubbed(monkeypatch, tmp_path)
        p.configure(min_interval_s=0.0)
        assert p.request("slo_burn", force=True)
        with obs.bind_trace("b4"), p.maybe_capture(
            context={"matches": 64, "steps": 4, "batches": ["b9"]}
        ):
            pass
        man = json.load(open(os.path.join(p.last_capture, "manifest.json")))
        assert man["version"] == 1 and man["reason"] == "slo_burn"
        assert man["capture_index"] == 1
        assert man["dir"] == os.path.basename(p.last_capture)
        assert man["batches"] == ["b4", "b9"] and man["traces"] == ["b4"]
        assert man["matches"] == 64 and man["steps"] == 4
        assert man["wall_end"] >= man["wall_start"]
        assert set(man["device"]) == {"platform", "device_kind"}
        assert p.capture_info()["last_manifest"] == man
        assert profview.load_manifest(p.last_capture) == man

    def test_windows_within_one_second_keep_their_own_dirs(self, monkeypatch,
                                                            tmp_path):
        p, calls = self._stubbed(monkeypatch, tmp_path, min_interval_s=0.0)
        monkeypatch.setattr("time.strftime", lambda fmt: "20260101-000000")
        dirs = []
        for _ in range(3):
            assert p.request("bench", force=True)
            with p.maybe_capture():
                pass
            dirs.append(p.last_capture)
        assert len(set(dirs)) == 3 and p.captures == 3
        assert [os.path.basename(d) for d in dirs] == [
            f"profile-20260101-000000-bench-{os.getpid()}{suffix}"
            for suffix in ("", "-2", "-3")
        ]
        for d in dirs:
            assert profview.load_manifest(d)["dir"] == os.path.basename(d)

    def test_real_capture_on_the_cpu(self, tmp_path):
        """Unstubbed: a window around torch work writes the layout, and the
        one-session guard frees itself."""
        import torch

        from analyzer_tpu_torch.obs import prof

        p = prof.DeviceProfiler(profile_dir=str(tmp_path))
        for _ in range(2):
            p.request("sigusr2", force=True)
            with p.maybe_capture(context={"matches": 1}):
                torch.arange(16).sum()
        assert p.captures == 2
        att = profview.analyze_capture(p.last_capture, update_metrics=False)
        assert att["parsed"] is True and att["manifest"]["capture_index"] == 2
        with pytest.raises(RuntimeError, match="no profiler session"):
            prof.stop_trace()

    def test_process_profiler_is_shared_and_resettable(self, tmp_path):
        from analyzer_tpu_torch.obs import prof

        try:
            a = prof.get_device_profiler()
            assert prof.get_device_profiler() is a
            b = prof.reset_device_profiler(profile_dir=str(tmp_path))
            assert b is not a and b.armed
        finally:
            prof.reset_device_profiler()


class TestHwPeaks:
    def test_classify_maps_known_devices(self):
        assert hw.classify("gpu", "NVIDIA H100 80GB HBM3") == "h100"
        assert hw.classify("gpu", "NVIDIA H100 PCIe") == "h100"
        assert hw.classify("cuda", "Some Future Card") == "h100"
        assert hw.classify("tpu", "TPU v5e") == "v5e"
        assert hw.classify("tpu", "TPU v5 lite") == "v5e"
        assert hw.classify("tpu", "TPU v5p") == "v5p"
        assert hw.classify("tpu", "TPU v9x") == "v5e"
        assert hw.classify("cpu", "") == "cpu"
        assert hw.classify(None, None) == "cpu"

    def test_jax_rows_are_kept(self):
        from analyzer_tpu.obs import hw as jhw

        for key, row in jhw.PEAKS.items():
            assert hw.PEAKS[key] == row
        for args in (("tpu", "TPU v5e"), ("tpu", "TPU v5p"), ("cpu", "")):
            assert hw.classify(*args) == jhw.classify(*args)

    def test_h100_row_is_the_data_sheet(self):
        row = hw.PEAKS["h100"]
        assert row["bytes_per_s"] == 3.35e12
        assert row["flops_per_s"] == 989e12  # dense bf16, the column's rule
        assert "H100" in row["label"] and "bf16" in row["label"]

    def test_peaks_from_table(self):
        p = hw.peaks_for("gpu", "NVIDIA H100 80GB HBM3", env={})
        assert p["source"] == "table" and p["platform"] == "h100"
        assert p["bytes_per_s"] == hw.PEAKS["h100"]["bytes_per_s"]

    def test_env_override_pins_the_roof(self):
        env = {hw.ENV_PEAK_BYTES: "123.0", hw.ENV_PEAK_FLOPS: "456.0"}
        p = hw.peaks_for("gpu", "NVIDIA H100 80GB HBM3", env=env)
        assert p["source"] == "env"
        assert (p["bytes_per_s"], p["flops_per_s"]) == (123.0, 456.0)
        p = hw.peaks_for("cpu", None, env={hw.ENV_PEAK_BYTES: "99.0"})
        assert p["source"] == "env" and p["bytes_per_s"] == 99.0
        assert p["flops_per_s"] == hw.PEAKS["cpu"]["flops_per_s"]

    def test_cost_model_mirrors_the_table_layout(self):
        from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE, TABLE_WIDTH

        assert hw.TABLE_ROW_BYTES == TABLE_WIDTH * 4
        assert hw.SLOT_TEAM_SIZE == MAX_TEAM_SIZE

    def test_cost_model_equals_jax(self):
        from analyzer_tpu.obs import hw as jhw

        assert hw.slot_cost(3) == jhw.slot_cost(3)
        assert hw.dispatch_cost(4, 8) == jhw.dispatch_cost(4, 8)
        assert hw.stream_cost(7) == jhw.stream_cost(7)
        one = hw.slot_cost(1)
        assert one["bytes"] == 2 * hw.SLOT_TEAM_SIZE * (
            2 * hw.TABLE_ROW_BYTES + hw.SLOT_INDEX_BYTES)
        assert hw.dispatch_cost(4, 8)["bytes"] == 32 * one["bytes"]

    def test_roofline_verdicts(self):
        env = {hw.ENV_PEAK_BYTES: "100.0", hw.ENV_PEAK_FLOPS: "100.0"}
        mem = hw.roofline(50.0, 1.0, 1.0, env=env)
        assert mem["bound_by"] == "memory"
        assert mem["frac_of_peak_bw"] == pytest.approx(0.5)
        assert hw.roofline(1.0, 50.0, 1.0, env=env)["bound_by"] == "compute"
        over = hw.roofline(1.0, 1.0, 1.0, env=env)
        assert over["bound_by"] == "overhead"

    def test_roofline_records_source_and_idle(self):
        r = hw.roofline(10.0, 10.0, 0.5, platform="gpu",
                        device_kind="NVIDIA H100 80GB HBM3",
                        device_idle_frac=0.25, source="profile", env={})
        assert r["device_time_source"] == "profile"
        assert r["device_idle_frac"] == 0.25
        assert r["achieved_bytes_per_s"] == pytest.approx(20.0)
        assert r["peak"]["platform"] == "h100"
        z = hw.roofline(10.0, 10.0, 0.0, env={})
        assert z["achieved_bytes_per_s"] == 0.0 and z["bound_by"] == "overhead"

    def test_render_roofline_names_the_bound(self):
        env = {hw.ENV_PEAK_BYTES: "100.0", hw.ENV_PEAK_FLOPS: "100.0"}
        text = hw.render_roofline(
            hw.roofline(50.0, 1.0, 1.0, device_idle_frac=0.3, env=env))
        assert "bound by: memory" in text
        assert "device idle inside the capture window: 30.0%" in text


class TestCliSurfaces:
    @pytest.mark.parametrize("capture,rc", [(OK_DIR, 0), (TORN_DIR, 1)])
    def test_cli_profile_equals_jax(self, capsys, capture, rc):
        outs = []
        for main in (cli.main, jax_cli.main):
            assert main(["profile", capture, "--json"]) == rc
            outs.append(json.loads(capsys.readouterr().out))
            assert main(["profile", capture]) == rc
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[2] and outs[1] == outs[3]
        if rc == 0:
            assert "dominant kernel: fusion.update" in outs[1]
        else:
            assert "parsed: false" in outs[1]

    def test_cli_profile_json_with_host_trace_join(self, capsys, tmp_path):
        host = tmp_path / "host.jsonl"
        host.write_text("".join(json.dumps(e) + "\n" for e in _host_events()))
        docs = []
        for main in (cli.main, jax_cli.main):
            assert main(["profile", OK_DIR, "--trace-events", str(host),
                         "--json"]) == 0
            docs.append(json.loads(capsys.readouterr().out))
        assert docs[0] == docs[1]
        assert docs[0]["dispatch_decomposition"]["dispatch_ms"] == pytest.approx(2.0)
        for main in (cli.main, jax_cli.main):
            assert main(["profile", OK_DIR, "--trace-events",
                         str(tmp_path / "nope.jsonl")]) == 2
        capsys.readouterr()

    def test_cli_profile_kineto_capture(self, capsys, tmp_path):
        cap = kineto_capture(tmp_path, labelled=True)
        assert cli.main(["profile", cap]) == 0
        out = capsys.readouterr().out
        assert "dominant kernel: fused_window_kernel" in out
        assert "1 lane(s)" in out

    def test_cli_trace_equals_jax(self, capsys, tmp_path):
        path = tmp_path / "events.jsonl"
        path.write_text("".join(json.dumps(e) + "\n" for e in _synthetic_events()))
        for argv, rc in (
            ([str(path), "--json"], 0),
            ([str(path)], 0),
            ([str(path), "--match", "m1", "--json"], 0),
            ([str(path), "--batch", "b1"], 0),
            ([str(path), "--match", "nope"], 1),
            ([str(path), "--batch", "nope"], 1),
            ([str(path), "--profile", OK_DIR, "--json"], 0),
        ):
            outs = []
            for main in (cli.main, jax_cli.main):
                assert main(["trace", *argv]) == rc, argv
                outs.append(capsys.readouterr().out)
            assert outs[0] == outs[1], argv

    def test_cli_trace_untraced_and_missing_exit_2(self, capsys, tmp_path):
        p = tmp_path / "plain.jsonl"
        p.write_text('{"name": "batch.compute", "ph": "X", "ts": 1, '
                     '"dur": 1, "args": {}}\n')
        for main in (cli.main, jax_cli.main):
            assert main(["trace", str(p)]) == 2
            assert main(["trace", "/nonexistent/trace.jsonl"]) == 2
        capsys.readouterr()
