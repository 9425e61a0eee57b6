"""The port's ``cli benchdiff`` against the JAX package's, byte for byte.

Both CLIs run in this process on the same files: every ordered pair of the
committed artifacts of each family (read, never written), then doctored
candidates built in ``tmp_path``: a regressed ratio, a degraded capture,
vanished blocks, the overhead gates, and a SOAK line that violates each
SLO. Stdout, stderr and the exit code must be equal. Tolerance: none.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import io
import json
import os

import pytest

from analyzer_tpu import cli as jax_cli
from analyzer_tpu.obs import benchdiff as jax_bd
from analyzer_tpu_torch import cli as port_cli
from analyzer_tpu_torch.obs import benchdiff as port_bd

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: family -> committed artifacts it reads (``tiered`` reads BENCH's).
COMMITTED = {
    fam: sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(_REPO, port_bd.FAMILIES[fam] + "_r*.json")))
    for fam in ("bench", "tiered", "serve", "ingest", "migrate", "fabric")
}
PAIRS = [(fam, a, b) for fam, names in COMMITTED.items()
         for a in names for b in names]


def run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["benchdiff", *argv])
    return rc, out.getvalue(), err.getvalue()


def same(argv) -> tuple[int, str, str]:
    got = run(port_cli.main, argv)
    want = run(jax_cli.main, argv)
    assert got == want
    return got


def test_committed_families_present():
    for fam in ("bench", "serve", "migrate"):
        assert len(COMMITTED[fam]) >= 2, fam
    for fam in ("ingest", "fabric"):
        assert COMMITTED[fam], fam


@pytest.mark.parametrize("family,a,b", PAIRS)
def test_committed_pair_equals_jax(family, a, b):
    same(["--family", family, os.path.join(_REPO, a), os.path.join(_REPO, b)])


@pytest.mark.parametrize("family", sorted(COMMITTED))
def test_against_latest_equals_jax(family):
    rc, _out, err = same(["--against-latest", "--family", family,
                          "--dir", _REPO])
    if len(COMMITTED[family]) < 2:
        assert rc == 2 and "not enough" in err
    else:
        assert rc in (0, 1)


# -- doctored candidates ---------------------------------------------------

def _rich_bench() -> dict:
    """A BENCH line with every block the bench and tiered gates read."""
    with open(os.path.join(_REPO, "BENCH_r05.json")) as f:
        line = json.load(f)["parsed"]
    line.update({
        "capture": {"degraded": False, "min_over_predicted": 1.2},
        "fused": {"min_over_reference": 0.4, "window": 16, "stable": True},
        "tiered": {"min_over_resident": 1.3, "hit_rate": 0.9,
                   "hot_rows": 32768, "stable": True},
        "streamed": {"min_s": 2.0, "min_over_device": 1.5, "stable": True},
        "roofline": {"device_idle_frac": 0.3, "bound_by": "overhead",
                     "frac_of_peak_bw": 0.01, "frac_of_peak_flops": 0.001},
        "profile": {"parsed": True, "dominant_kernel": "fused_window"},
        "trace_overhead": {"overhead_pct": 1.0, "stable": True},
        "watchdog_overhead": {"overhead_pct": 0.5, "stable": True},
        "federate_overhead": {"overhead_pct": 1.5, "stable": True},
    })
    return line


def _soak() -> dict:
    """A green SOAK line: every objective's artifact check passes."""
    return {
        "metric": "soak.matches_per_sec", "value": 100.0,
        "latency_ms": {"p50": 1.0, "p99": 4.0},
        "deterministic": {
            "dead_letters": 0, "retraces_steady": 0, "view_lag_ticks_max": 0,
            "drained": True, "queue_depth_final": 0,
            "matches_published": 500, "matches_rated": 500,
        },
        "slo": {"pass": True, "thresholds": {
            "max_view_lag_ticks": 2, "min_matches_per_sec": 10.0,
            "max_p99_ms": 50.0, "forbid_dominant_stages": ["queue_wait"],
            "min_quality_matches": 100,
        }},
        "trace": {"dominant_stage": "dispatch"},
        "audit": {"mismatches": 0},
        "quality": {"matches_scored": 500, "brier": 0.2, "ece": 0.01},
    }


def _doctor(data: dict, **paths) -> dict:
    """A deep copy with ``block__key=value`` set (``block=None`` drops it)."""
    out = copy.deepcopy(data)
    for path, value in paths.items():
        keys = path.split("__")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if value is None:
            node.pop(keys[-1], None)
        else:
            node[keys[-1]] = value
    return out


SOAK_VIOLATIONS = {
    "dead_letters": dict(deterministic__dead_letters=3),
    "retraces": dict(deterministic__retraces_steady=2),
    "staleness": dict(deterministic__view_lag_ticks_max=9),
    "drained": dict(deterministic__drained=False,
                    deterministic__queue_depth_final=7),
    "lost_work": dict(deterministic__matches_rated=450),
    "throughput_floor": dict(value=2.0),
    "latency_cap": dict(latency_ms__p99=80.0),
    "dominant_stage": dict(trace__dominant_stage="queue_wait"),
    "no_trace_block": dict(trace=None),
    "audit": dict(audit__mismatches=2),
    "calibration": dict(quality__ece=0.4),
    "quality_vanished": dict(quality=None),
    "regressed": dict(value=80.0, latency_ms__p99=9.0),
}

CASES = {
    # family, baseline (a maker or a committed file), candidate doctoring, expected rc
    "bench_self": ("bench", _rich_bench, {}, 0),
    "bench_fused_ratio_toward_1": (
        "bench", _rich_bench, dict(fused__min_over_reference=0.97), 1),
    "bench_degraded_capture": (
        "bench", _rich_bench, dict(capture__degraded=True,
                                   fused__min_over_reference=0.97), 0),
    "bench_profile_vanished": ("bench", _rich_bench, dict(profile=None), 1),
    "bench_profile_unparsed": (
        "bench", _rich_bench, dict(profile__parsed=False), 1),
    "bench_federate_overhead": (
        "bench", _rich_bench, dict(federate_overhead__overhead_pct=15.9), 1),
    "bench_watchdog_overhead": (
        "bench", _rich_bench, dict(watchdog_overhead__overhead_pct=7.24), 1),
    "bench_trace_overhead_unstable": (
        "bench", _rich_bench, dict(trace_overhead__overhead_pct=9.0,
                                   trace_overhead__stable=False), 0),
    "bench_idle_rises": (
        "bench", _rich_bench, dict(roofline__device_idle_frac=0.6), 1),
    "tiered_thrash": (
        "tiered", _rich_bench, dict(tiered__min_over_resident=2.0,
                                    tiered__hit_rate=0.5), 1),
    "tiered_vanished": ("tiered", _rich_bench, dict(tiered=None), 1),
    "fabric_single_host": (
        "fabric", "FABRIC_BENCH_r01.json", dict(fleet__n_hosts=1), 1),
    "fabric_dead_letters": (
        "fabric", "FABRIC_BENCH_r01.json", dict(deterministic__dead_letters=4), 1),
    "fabric_burning": (
        "fabric", "FABRIC_BENCH_r01.json",
        dict(fleet__burning=["no-dead-letters"]), 1),
    "serve_codec_lost": (
        "serve", "SERVE_BENCH_r02.json", dict(frontdoor__native=False), 1),
    "serve_sharded_vanished": (
        "serve", "SERVE_BENCH_r02.json", dict(sharded=None), 1),
    "serve_degraded": (
        "serve", "SERVE_BENCH_r02.json", dict(capture__degraded=True, value=1.0), 0),
    "ingest_python_codec": (
        "ingest", "INGEST_BENCH_r01.json", dict(ingest__native=False), 1),
    "migrate_offline": (
        "migrate", "MIGRATE_BENCH_r02.json", dict(migrate__streamed=False), 1),
    "migrate_python_assign": (
        "migrate", "MIGRATE_BENCH_r02.json", dict(assign__native=False), 1),
    **{f"soak_{name}": ("soak", _soak, d, 1)
       for name, d in SOAK_VIOLATIONS.items()},
    "soak_green": ("soak", _soak, {}, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_doctored_candidate_equals_jax(tmp_path, case):
    family, base, doctoring, want_rc = CASES[case]
    if callable(base):
        a = base()
    else:
        a = port_bd.load_bench(os.path.join(_REPO, base))
    b = _doctor(a, **doctoring)
    prefix = port_bd.FAMILIES[family]
    a_path, b_path = tmp_path / f"{prefix}_r01.json", tmp_path / f"{prefix}_r02.json"
    a_path.write_text(json.dumps(a))
    b_path.write_text(json.dumps(b))
    rc, out, _err = same(["--family", family, str(a_path), str(b_path)])
    assert rc == want_rc, out
    rc_latest, _o, _e = same(["--against-latest", "--family", family,
                              "--dir", str(tmp_path)])
    assert rc_latest == rc


def test_self_diff_reads_zero(tmp_path):
    a = _rich_bench()
    path = tmp_path / "BENCH_r01.json"
    path.write_text(json.dumps(a))
    rc, out, _err = same([str(path), str(path)])
    assert rc == 0
    rows = out.splitlines()[1:]
    assert rows and all("(+0.0%) ok" in r for r in rows), out


@pytest.mark.parametrize("argv", [
    [],
    ["only_one.json"],
    ["--against-latest", "a.json", "b.json"],
    ["missing_a.json", "missing_b.json"],
    ["--against-latest", "--family", "soak"],
])
def test_usage_errors_equal_jax(tmp_path, argv):
    argv = [a if a.startswith("--") or a == "soak" else str(tmp_path / a)
            for a in argv]
    if "--against-latest" in argv and "--dir" not in argv:
        argv += ["--dir", str(tmp_path)]
    rc, _out, _err = same(argv)
    assert rc == 2


def test_truncated_artifact_exits_2(tmp_path):
    good = tmp_path / "BENCH_r01.json"
    good.write_text(json.dumps(_rich_bench()))
    bad = tmp_path / "BENCH_r02.json"
    bad.write_text('{"metric": "x"')
    assert same([str(good), str(bad)])[0] == 2
    bad.write_text('{"unit": "x"}')
    assert same([str(good), str(bad)])[0] == 2


def test_module_functions_equal_jax():
    lines = [_rich_bench(), _soak()]
    for name in COMMITTED["serve"] + COMMITTED["fabric"]:
        lines.append(jax_bd.load_bench(os.path.join(_REPO, name)))
    for line in lines:
        assert port_bd.bench_configs(line) == [
            port_bd.BenchConfig(**vars(c)) for c in jax_bd.bench_configs(line)]
        for fn in ("soak_slo_violations", "fabric_slo_violations",
                   "trace_overhead_violations", "watchdog_overhead_violations",
                   "federate_overhead_violations"):
            assert getattr(port_bd, fn)(line) == getattr(jax_bd, fn)(line), fn
    assert port_bd.FAMILIES == jax_bd.FAMILIES
    for name in ("TRACE_OVERHEAD_MAX_PCT", "WATCHDOG_OVERHEAD_MAX_PCT",
                 "FEDERATE_OVERHEAD_MAX_PCT"):
        assert getattr(port_bd, name) == getattr(jax_bd, name)
