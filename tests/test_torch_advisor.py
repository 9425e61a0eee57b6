"""The port's tuning advisor (``obs/advisor.py``, ``cli tune``) against JAX's.

The same inputs go through both packages: the committed artifacts (read,
never written), doctored artifacts in ``tmp_path`` that make every rule of
the table fire, a history ring and the committed profile capture
``tests/fixtures/profile_ok``. The port's JSON report must equal JAX's
after exactly two substitutions, the deviations ROADMAP queue C records:
the fused rule's action names the window's working set in its cluster's
shared memory (JAX's names the TPU's VMEM), and the queue rules name
``cli soak --broker-partitions 2``, the flag both CLIs define, where JAX's
name ``--partitions``. The report is byte-identical across runs, and every
flag it names parses with the port's own argparser.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shlex

import pytest

from analyzer_tpu import cli as jax_cli
from analyzer_tpu.obs import advisor as jax_advisor
from analyzer_tpu_torch import cli as port_cli
from analyzer_tpu_torch.obs import advisor as port_advisor

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE = os.path.join(_REPO, "tests", "fixtures", "profile_ok")

#: (JAX's wording, the port's): the only differences allowed.
SUBSTITUTIONS = (
    ("the VMEM-resident window kernel is not beating the reference scan",
     "the window kernel, its working set resident in its cluster's shared "
     "memory, is not beating the reference scan"),
    ("cli soak --partitions 2", "cli soak --broker-partitions 2"),
)


def _write(path, data) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f)
    return str(path)


def _bench(bound_by: str) -> dict:
    return {
        "metric": "matches_per_sec_per_chip", "value": 1.0e6,
        "telemetry": {"feed": {"starved_total": 8, "backpressure_total": 0}},
        "roofline": {"device_idle_frac": 0.62, "bound_by": bound_by,
                     "frac_of_peak_bw": 0.71, "frac_of_peak_flops": 0.002},
        "fused": {"min_over_reference": 0.99, "window": 16},
        "tiered": {"hit_rate": 0.46, "min_over_resident": 1.96,
                   "hot_rows": 32768},
    }


def _history() -> dict:
    raw = [[float(t), float(d)] for t, d in ((0, 3), (10, 40), (20, 90))]
    return {"series": {
        "broker.queue_depth{queue=matches}": {"rings": {"raw": raw}},
        "worker.matches_rated_total": {"rings": {"raw": [[0.0, 1.0]]}},
    }}


@pytest.fixture
def firing(tmp_path) -> str:
    """A directory of artifacts that fire every rule of the table: the
    newest BENCH line is overhead-bound (device-idle, dispatch-overhead),
    the older one memory-bound (bandwidth-roof, when named without the
    newer)."""
    _write(tmp_path / "BENCH_r01.json", _bench("memory"))
    _write(tmp_path / "BENCH_r02.json", _bench("overhead"))
    _write(tmp_path / "INGEST_BENCH_r01.json", {
        "metric": "ingest.bytes_per_sec", "value": 1.0,
        "ingest": {"native": False}})
    _write(tmp_path / "MIGRATE_BENCH_r01.json", {
        "metric": "migrate.matches_per_sec", "value": 1.0,
        "migrate": {"assign_native": False, "plan_windows": 4,
                    "prefix_windows": 4}})
    _write(tmp_path / "SOAK_r01.json", {
        "metric": "soak.matches_per_sec", "value": 1.0,
        "slo": {"dominant_stage": "queue_wait"}})
    _write(tmp_path / "SERVE_BENCH_r01.json", {
        "metric": "serve.queries_per_sec", "value": 1.0})
    flight = tmp_path / "flight"
    flight.mkdir()
    _write(flight / "history.json", _history())
    return str(tmp_path)


def _expected(jax_json: str) -> str:
    for old, new in SUBSTITUTIONS:
        jax_json = jax_json.replace(old, new)
    return jax_json


def _report(mod, **kw) -> dict:
    return mod.advise(mod.gather_inputs(**kw))


def _input_sets(firing):
    names = sorted(os.listdir(firing))
    paths = [os.path.join(firing, n) for n in names]
    memory = [p for p in paths if not p.endswith("BENCH_r02.json")]
    return {
        "committed": dict(scan_dir=_REPO, profile_dir=PROFILE),
        "firing_scan": dict(scan_dir=firing, profile_dir=PROFILE),
        "firing_paths_memory": dict(paths=memory),
        "firing_paths_overhead": dict(paths=paths, profile_dir=PROFILE),
        "history_only": dict(paths=[os.path.join(firing, "flight")]),
        "profile_only": dict(profile_dir=PROFILE),
        "nothing": dict(paths=[os.path.join(firing, "absent.json")]),
    }


SETS = ("committed", "firing_scan", "firing_paths_memory",
        "firing_paths_overhead", "history_only", "profile_only", "nothing")


@pytest.mark.parametrize("which", SETS)
def test_report_equals_jax_but_the_two_wordings(firing, which):
    kw = _input_sets(firing)[which]
    got = json.dumps(_report(port_advisor, **kw), sort_keys=True)
    want = json.dumps(_report(jax_advisor, **kw), sort_keys=True)
    assert got == _expected(want)
    assert port_advisor.render_report(json.loads(got)) == _expected(
        jax_advisor.render_report(json.loads(want)))


def test_every_rule_fires_and_each_substitution_applies(firing):
    sets = _input_sets(firing)
    fired = set()
    for which in ("firing_paths_memory", "firing_paths_overhead"):
        report = _report(port_advisor, **sets[which])
        fired |= {f["rule"] for f in report["findings"]}
        text = json.dumps(report)
        assert "VMEM" not in text and "--partitions 2" not in text.replace(
            "--broker-partitions 2", "")
    assert fired == {
        "ingest-native-fallback", "migrate-assign-fallback", "feed-starved",
        "device-idle", "dispatch-overhead", "fused-not-paying", "tier-thrash",
        "queue-wait-dominant", "queue-depth-growing", "plan-prefix-exhausted",
        "bandwidth-roof"}
    assert len(fired) == len(port_advisor.RULES)
    jax_text = json.dumps(_report(jax_advisor, **sets["firing_paths_overhead"]))
    for old, _new in SUBSTITUTIONS:
        assert old in jax_text


def run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["tune", *argv])
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("json_out", [False, True])
def test_cli_tune_equals_jax_and_is_byte_identical(firing, json_out):
    argv = ["--dir", firing, "--profile", PROFILE] + (["--json"] if json_out else [])
    first = run(port_cli.main, argv)
    assert first == run(port_cli.main, argv)
    rc, out, err = run(jax_cli.main, argv)
    assert first == (rc, _expected(out), err)
    assert first[0] == 0


def test_cli_tune_without_inputs_exits_2(tmp_path):
    argv = ["--dir", str(tmp_path)]
    got = run(port_cli.main, argv)
    assert got == run(jax_cli.main, argv)
    assert got[0] == 2


def test_every_named_flag_parses_with_the_port_cli(firing):
    sets = _input_sets(firing)
    flags = set()
    for which in ("firing_paths_memory", "firing_paths_overhead"):
        for f in _report(port_advisor, **sets[which])["findings"]:
            flags.update(f["flags"])
    assert flags
    parser = port_cli.build_parser()
    for flag in sorted(flags):
        argv = shlex.split(flag.split(" (")[0])
        assert argv[0] == "cli"
        args = parser.parse_args(argv[1:])
        assert args.fn.__name__ == f"cmd_{argv[1]}"
    # JAX's wording names a flag neither CLI defines.
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        parser.parse_args(["soak", "--partitions", "2"])
