"""The port's headline capture (``analyzer_tpu_torch.bench``, ``cli bench``)
against the JAX package's root ``bench.py``.

  * The pure helpers (``_tail_stable``, ``streamed_stats``,
    ``capture_stats``, ``emit_metric``, ``obs_breakdown``'s shape) give the
    JAX helpers' outputs exactly on the same inputs. ``capture_stats``
    takes the JAX line's TPU thresholds as arguments (the port raises
    neither reason by default, until ROADMAP A17 fits card thresholds).
  * ``cli bench --device cpu`` at 2,000 matches prints a line whose key
    structure equals the JAX bench's on the same workload — the
    ``watchdog_overhead`` and ``federate_overhead`` blocks included, on by
    default in both — plus ``device``, with both bit-identities true; its
    reference table matches JAX's ``rate_history`` on the same stream with
    tests/test_torch_stream.py's table tolerance (rtol 2e-6, atol 2e-3:
    float32 transcendentals and sum order, tests/test_torch_ops.py).
  * ``--ingest`` and ``--migrate`` on the CPU (each line's key structure
    equal to the JAX bench's, plus ``device`` and, on the migration line,
    the port's ``migrate.kernel`` / ``admission_halvings`` /
    ``fused_window_launches``), and the exit-2 refusal of the default
    device where there is no card.

Root ``bench.py`` only defines functions at import; it is loaded by path.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.core.state import PlayerState as JaxPlayerState
from analyzer_tpu.io.synthetic import (
    synthetic_players as j_players,
    synthetic_stream as j_stream,
)
from analyzer_tpu.sched import pack_schedule as j_pack, rate_history as j_rate_history
from analyzer_tpu_torch import bench, cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MATCHES = 2000
HOT_ROWS = 512
RTOL, ATOL = 2e-6, 2e-3


def _load_root_bench():
    spec = importlib.util.spec_from_file_location(
        "root_bench_for_port_tests", os.path.join(REPO, "bench.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = _load_root_bench()


@contextlib.contextmanager
def _env(**kv):
    """Sets env knobs for the block and restores the WHOLE environment
    after it (``cli bench`` routes its flags into os.environ)."""
    saved = dict(os.environ)
    try:
        for key in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[key]
        os.environ.update({k: str(v) for k, v in kv.items()})
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


# -- pure helpers ---------------------------------------------------------

TIMES = [
    [1.0], [1.0, 1.1], [2.0, 1.0, 1.05, 1.02], [1.0, 3.5, 1.2, 1.3],
    [1.0, 1.5, 1.6], [5.0, 1.0, 0.9, 4.0], [0.4, 0.41, 0.39, 0.8, 0.4, 0.42],
]


@pytest.mark.parametrize("times", TIMES)
@pytest.mark.parametrize("repeats", [1, 2, 3, 5])
def test_tail_stable_equals_jax(times, repeats):
    assert bench._tail_stable(times, repeats) == jbench._tail_stable(times, repeats)
    assert bench.SPREAD_LIMIT == jbench.SPREAD_LIMIT


@pytest.mark.parametrize("times", TIMES)
@pytest.mark.parametrize("stable", [True, False])
def test_streamed_stats_equal_jax(times, stable):
    assert (bench.streamed_stats(times, stable, 0.37)
            == jbench.streamed_stats(times, stable, 0.37))


@pytest.mark.parametrize("times", TIMES)
@pytest.mark.parametrize("probes", [(95.0, 120.0), (170.0, 200.0), (150.0, 400.0)])
@pytest.mark.parametrize("predicted", [None, 0.5, 1.0, 2.0])
@pytest.mark.parametrize("stable", [True, False])
def test_capture_stats_equal_jax_at_its_thresholds(times, probes, predicted, stable):
    got = bench.capture_stats(
        times, probes, stable, predicted, probe_slow_ms=160.0,
        degraded_above=jbench.DEGRADED_ABOVE_PREDICTION,
    )
    assert got == jbench.capture_stats(times, probes, stable, predicted)


@pytest.mark.parametrize("times", TIMES)
def test_capture_stats_port_defaults_raise_only_convergence(times):
    got = bench.capture_stats(times, (900.0, 900.0), True, 1e-6)
    assert got["degraded_reasons"] == [] and got["degraded"] is False
    got = bench.capture_stats(times, (900.0, 900.0), False, 1e-6)
    assert got["degraded_reasons"] == ["repeats_never_converged"]


def test_prediction_is_jax_model_uncalibrated():
    for steps, b in ((1157, 432), (10, 8), (23149, 432)):
        want = jbench.predict_device_time(steps, b) / jbench.DEVICE_TIME_CALIBRATION
        assert bench.predict_device_time(steps, b) == pytest.approx(want, rel=1e-12)
    assert bench.DEVICE_TIME_CALIBRATION == 1.0
    assert (bench.BASELINE_MATCHES_PER_SEC_PER_CHIP
            == jbench.BASELINE_MATCHES_PER_SEC_PER_CHIP)


def _blocks():
    cap = jbench.capture_stats([1.0, 1.1, 0.9], (100.0, 110.0), True, 0.8)
    return dict(
        capture=cap,
        streamed=jbench.streamed_stats([2.0, 2.2], True, 0.9),
        fused={"window": 16, "min_over_reference": 0.5},
        tiered={"hot_rows": 64, "min_over_resident": 1.9},
        trace_overhead={"overhead_pct": 0.4},
        watchdog_overhead={"overhead_pct": 0.7, "samples": 3},
        federate_overhead={"overhead_pct": 0.2, "scrapes": 9},
        roofline={"bound_by": "overhead"},
        profile={"parsed": True, "dominant_kernel": "k"},
        telemetry={"phases": {"pack_s": 0.1}},
    )


@pytest.mark.parametrize("drop", [None, "fused", "tiered", "profile", "capture",
                                  "watchdog_overhead"])
def test_emit_metric_equals_jax(drop, capsys):
    blocks = _blocks()
    if drop is not None:
        blocks[drop] = None
    jbench.emit_metric(1234.56789, **blocks)
    want = _last_json(capsys.readouterr().out)
    line = bench.emit_metric(1234.56789, **blocks)
    got = _last_json(capsys.readouterr().out)
    assert got == want == line
    bench.emit_metric(1234.56789, **blocks, device={"name": "x", "power_limit": "1 W"})
    with_dev = _last_json(capsys.readouterr().out)
    assert with_dev.pop("device") == {"name": "x", "power_limit": "1 W"}
    assert with_dev == want


def test_obs_breakdown_shape_equals_jax():
    phases = {"generate_s": 0.1234, "pack_s": 1.0}
    got, want = bench.obs_breakdown(phases), jbench.obs_breakdown(phases)
    assert set(got) == set(want)
    for key in ("jax_compile", "sched", "feed"):
        assert set(got[key]) == set(want[key]), key
    assert got["phases"] == want["phases"]
    # nothing is jitted in the port: present, empty / zero
    assert got["retraces"] == {}
    assert set(got["jax_compile"].values()) == {0}


def test_profile_window_on_cpu(tmp_path):
    with _env(BENCH_PROFILE=1, BENCH_PROFILE_DIR=tmp_path):
        block = bench.bench_profile_window(lambda: torch.ones(64).sum(), "bench")
    assert block["parsed"] is True and block["dir"].startswith(str(tmp_path))
    assert "dominant_kernel" in block
    with _env():
        assert bench.bench_profile_window(lambda: None, "bench") is None


# -- the whole capture on the CPU --------------------------------------------

SKIP_INNER = {("telemetry", "retraces"), ("telemetry", "device_memory")}


def _keys(d, path=()):
    out = set()
    for k, v in d.items():
        p = path + (k,)
        out.add(p)
        if isinstance(v, dict) and p not in SKIP_INNER:
            out |= _keys(v, p)
    return out


@pytest.fixture(scope="module")
def captures():
    knobs = dict(BENCH_MATCHES=N_MATCHES, BENCH_REPEATS=1)
    box = {}
    orig = bench.main

    def spy(**kw):
        box["result"] = orig(**kw)
        return box["result"]

    out, err = io.StringIO(), io.StringIO()
    with _env(**knobs), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        bench.main = spy
        try:
            rc = cli.main(["bench", "--device", "cpu", "--kernel", "fused",
                           "--hot-rows", str(HOT_ROWS)])
        finally:
            bench.main = orig
    jout = io.StringIO()
    with _env(**knobs, BENCH_HOT_ROWS=HOT_ROWS), contextlib.redirect_stdout(jout), \
            contextlib.redirect_stderr(io.StringIO()):
        jbench.main()
    return {
        "rc": rc, "line": _last_json(out.getvalue()), "stderr": err.getvalue(),
        "table": box["result"]["table"], "jax": _last_json(jout.getvalue()),
    }


def test_cli_bench_cpu_exits_0_with_one_json_line(captures):
    assert captures["rc"] == 0
    assert captures["line"]["metric"] == "matches_per_sec_per_chip"
    assert captures["line"]["device"] == {"name": "cpu", "power_limit": None}


def test_line_keys_equal_jax_less_a16b_plus_device(captures):
    got = _keys(captures["line"]) - {("device",), ("device", "name"),
                                     ("device", "power_limit")}
    assert got == _keys(captures["jax"])


def test_bit_identities_hold(captures):
    line = captures["line"]
    assert line["fused"]["bit_identical_to_reference"] is True
    assert line["tiered"]["bit_identical_to_resident"] is True
    assert line["fused"]["windows"] == captures["jax"]["fused"]["windows"]
    for key in ("working_set_rows", "spills", "writebacks_avoided", "pad_steps"):
        assert line["fused"][key] == captures["jax"]["fused"][key], key
    assert line["tiered"]["capacity"] == captures["jax"]["tiered"]["capacity"]


def test_a16b_blocks_left_out_with_one_stderr_line(captures):
    """The SLO-plane and federation blocks are ported and on by default:
    present with JAX's keys and counts that show the planes ran."""
    line, jax = captures["line"], captures["jax"]
    for block in ("watchdog_overhead", "federate_overhead"):
        assert set(line[block]) == set(jax[block]), block
        assert line[block]["off_s"] > 0 and line[block]["on_s"] > 0
    assert line["watchdog_overhead"]["samples"] > 0
    assert line["watchdog_overhead"]["checks"] == line["watchdog_overhead"]["samples"]
    assert line["federate_overhead"]["scrapes"] > 0
    assert "ROADMAP A16b" not in captures["stderr"]
    assert "SLO-plane-on rate_history" in captures["stderr"]
    assert "scraped-under-load rate_history" in captures["stderr"]


def test_capture_never_raises_the_tpu_reasons(captures):
    reasons = captures["line"]["capture"]["degraded_reasons"]
    assert all(r == "repeats_never_converged" for r in reasons)
    assert captures["line"]["roofline"]["device_time_source"] == "wall"


def test_final_table_matches_jax_rate_history(captures):
    jp = j_players(N_MATCHES // 3, seed=42)
    js = j_stream(N_MATCHES, jp, seed=42, activity_concentration=0.8,
                  max_activity_share=1e-4)
    st = JaxPlayerState.create(
        N_MATCHES // 3, rank_points_ranked=jp.rank_points_ranked,
        rank_points_blitz=jp.rank_points_blitz, skill_tier=jp.skill_tier,
    )
    want, _ = j_rate_history(st, j_pack(js, pad_row=st.pad_row, windowed=True),
                             JaxRatingConfig())
    a, b = captures["table"], np.asarray(want.table)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# -- BENCH_MESH ------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_captures():
    from analyzer_tpu import obs as jobs
    from analyzer_tpu_torch import obs

    knobs = dict(BENCH_MATCHES=N_MATCHES, BENCH_REPEATS=1, BENCH_MESH=2)
    box = {}
    orig = bench.main

    def spy(**kw):
        box["result"] = orig(**kw)
        return box["result"]

    obs.reset_registry()
    jobs.reset_registry()
    out, err = io.StringIO(), io.StringIO()
    with _env(**knobs), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        bench.main = spy
        try:
            rc = cli.main(["bench", "--device", "cpu"])
        finally:
            bench.main = orig
    jout = io.StringIO()
    with _env(**knobs), contextlib.redirect_stdout(jout), \
            contextlib.redirect_stderr(io.StringIO()):
        jbench.main()
    return {
        "rc": rc, "line": _last_json(out.getvalue()), "stderr": err.getvalue(),
        "table": box["result"]["table"], "jax": _last_json(jout.getvalue()),
    }


def test_bench_mesh_line_keys_equal_jax(mesh_captures):
    """``BENCH_MESH=2`` runs the sharded capture: the JAX line's keys (plus
    ``device``), the same mesh put volume, and the same streamed feed."""
    assert mesh_captures["rc"] == 0
    line, jax = mesh_captures["line"], mesh_captures["jax"]
    got = _keys(line) - {("device",), ("device", "name"), ("device", "power_limit")}
    assert got == _keys(jax)
    assert (line["telemetry"]["mesh_put_bytes_total"]
            == jax["telemetry"]["mesh_put_bytes_total"] > 0)
    assert "eager precomputed-routing control" in mesh_captures["stderr"]
    assert "over 2 shards" in mesh_captures["stderr"]


def test_bench_mesh_rate_is_per_device(mesh_captures):
    """Two logical shards share the one device, so the line's
    ``matches_per_sec_per_chip`` is the whole run's rate, not half of it."""
    line = mesh_captures["line"]
    best = min(line["capture"]["repeats_s"])
    assert line["metric"] == "matches_per_sec_per_chip"
    assert line["value"] * best == pytest.approx(
        N_MATCHES, rel=0.0005 / best + 0.01
    )


def test_bench_mesh_table_equals_the_reference_run(mesh_captures):
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
    from analyzer_tpu_torch.sched import pack_schedule, rate_history

    players = synthetic_players(N_MATCHES // 3, seed=42)
    stream = synthetic_stream(N_MATCHES, players, seed=42, activity_concentration=0.8,
                              max_activity_share=1e-4)
    state = PlayerState.create(
        N_MATCHES // 3, players.rank_points_ranked, players.rank_points_blitz,
        players.skill_tier, device="cpu",
    )
    want, _ = rate_history(state, pack_schedule(stream, pad_row=state.pad_row),
                           RatingConfig())
    assert np.array_equal(mesh_captures["table"], want.table.numpy(), equal_nan=True)


# -- --ingest -------------------------------------------------------------------


def test_ingest_line_on_cpu_keys_equal_jax():
    knobs = dict(BENCH_INGEST_MATCHES=N_MATCHES, BENCH_INGEST_WINDOW=128,
                 BENCH_REPEATS=1)
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update({k: str(v) for k, v in knobs.items()})
    proc = subprocess.run(
        [sys.executable, "-m", "analyzer_tpu_torch", "bench", "--ingest",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    got = _last_json(proc.stdout)
    jout = io.StringIO()
    with _env(**knobs, BENCH_INGEST=1), contextlib.redirect_stdout(jout), \
            contextlib.redirect_stderr(io.StringIO()):
        jbench.main()
    want = _last_json(jout.getvalue())
    assert _keys(got) - {("device",), ("device", "name"),
                         ("device", "power_limit")} == _keys(want)
    assert got["ingest"]["native"] is True
    assert got["ingest"]["rows"] == N_MATCHES == want["ingest"]["rows"]
    assert got["ingest"]["windows"] == want["ingest"]["windows"]
    assert got["ingest"]["csv_bytes"] == want["ingest"]["csv_bytes"]
    assert got["arena"]["pinned"] is False  # CPU commits are plain copies
    assert got["arena"]["hit_rate"] >= 0.9
    assert got["device"] == {"name": "cpu", "power_limit": None}


# -- --migrate -----------------------------------------------------------------

MIGRATE_KNOBS = dict(BENCH_MIGRATE_MATCHES=N_MATCHES, BENCH_ASSIGN_MATCHES=20_000,
                     BENCH_MIGRATE_WINDOW=256, BENCH_REPEATS=1)
#: The port's additions to the JAX migration line.
MIGRATE_EXTRA = {("device",), ("device", "name"), ("device", "power_limit"),
                 ("migrate", "kernel"), ("migrate", "admission_halvings"),
                 ("migrate", "fused_window_launches")}


@pytest.mark.parametrize("kernel", ["reference", "fused"])
def test_migrate_line_on_cpu_keys_equal_jax(kernel, capsys):
    from analyzer_tpu_torch.migrate import reset_migration_progress

    with _env(**MIGRATE_KNOBS, BENCH_KERNEL=kernel):
        assert cli.main(["bench", "--migrate", "--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    jout = io.StringIO()
    with _env(**MIGRATE_KNOBS, BENCH_MIGRATE=1), contextlib.redirect_stdout(jout), \
            contextlib.redirect_stderr(io.StringIO()):
        jbench.main()
    reset_migration_progress()
    want = _last_json(jout.getvalue())
    assert _keys(got) - MIGRATE_EXTRA == _keys(want)
    mig = got["migrate"]
    assert got["metric"] == want["metric"] == "migrate.matches_per_sec"
    assert mig["streamed"] is True and mig["bit_identical"] is True
    assert mig["kernel"] == kernel and mig["fused_window_launches"] == 0  # CPU
    assert mig["assign_native"] is True and got["assign"]["native"] is True
    for key in ("matches", "players", "csv_bytes", "window_rows", "plan_windows",
                "prefix_windows"):
        assert mig[key] == want["migrate"][key], key
    assert got["device"] == {"name": "cpu", "power_limit": None}


# -- refusals (exit 2, before any env routing) ---------------------------------


@pytest.mark.parametrize("argv,env,item", [
    (["--obs-port", "0", "--migrate"], {}, "--device cpu"),
    ([], {"BENCH_OBS_PORT": "9100", "BENCH_MIGRATE": "1"}, "--device cpu"),
    (["--migrate"], {}, "--device cpu"),
    ([], {"BENCH_MIGRATE": "1"}, "--device cpu"),
    (["--migrate"], {"BENCH_MESH": "1"}, "--device cpu"),
    ([], {"BENCH_MESH": "4", "BENCH_MIGRATE": "1"}, "--device cpu"),
    ([], {"BENCH_WATCHDOG_OVERHEAD": "1", "BENCH_MIGRATE": "1"}, "--device cpu"),
    (["--migrate"], {"BENCH_FEDERATE_OVERHEAD": "yes", "BENCH_MESH": "1"},
     "--device cpu"),
])
def test_refusals_exit_2_naming_the_item(argv, env, item, capsys):
    """Nothing of the capture is refused any more (``--migrate`` is ported);
    the one refusal left is the default device where there is no card. It
    exits 2 before anything runs, naming ``--device cpu``, whatever the
    flags and knobs, and routes nothing into the environment."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device would run")
    with _env(**env):
        rc = cli.main(["bench", *argv])
        leaked = {k for k in os.environ if k.startswith("BENCH_")} - set(env)
    err = capsys.readouterr().err
    assert rc == 2
    assert item in err and "ROADMAP" not in err
    assert not leaked


def test_a16b_knobs_at_zero_are_accepted(capsys):
    """The overhead, obsd and mesh knobs at 0 or 1 leave the migration line
    running."""
    for value in ("0", "1"):
        with _env(**{**MIGRATE_KNOBS, "BENCH_ASSIGN_MATCHES": 0},
                  BENCH_MIGRATE=1, BENCH_WATCHDOG_OVERHEAD=value,
                  BENCH_FEDERATE_OVERHEAD=value, BENCH_OBS_PORT=0, BENCH_MESH=0,
                  BENCH_KERNEL="reference"):
            out = bench.main(obs_port=0, device="cpu")
        assert out["line"]["metric"] == "migrate.matches_per_sec"
        assert "assign" not in out["line"]
    capsys.readouterr()


def test_default_device_without_a_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device would run")
    with _env():
        assert cli.main(["bench"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_module_entry_point_takes_the_cli_flags():
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update({k: str(v) for k, v in MIGRATE_KNOBS.items()},
               BENCH_ASSIGN_MATCHES="0", BENCH_KERNEL="reference")
    proc = subprocess.run(
        [sys.executable, "-m", "analyzer_tpu_torch.bench", "--device", "cpu",
         "--migrate"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert _last_json(proc.stdout)["metric"] == "migrate.matches_per_sec"
