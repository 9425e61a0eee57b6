"""The port's last three root experiments on the CPU, at small sizes.

* ``experiments/serve_bench.py``: the JAX script and the port's module run
  in this process on the same seed and widths; the SERVE_BENCH lines have
  the same shape, and every field that does not depend on the clock or on
  compilation is equal (the port's retrace and compile fields read 0,
  JAX's steady ones do too). The seeded table and workloads are equal bit
  for bit.
* ``experiments/sharded_overhead.py``: the plain, sharded and nopsum
  tables equal the reference runner's bit for bit (padding row included),
  and each sharded arm runs ``row_scatter`` (its plain version, on the
  CPU) once a superstep.
* ``experiments/db_ingest.py``: the native scanner's history equals the
  python scan's (stream, ids and table), and its stream equals the JAX
  package's ``SqlStore.load_stream`` on the same file.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import runpy
import sys

import numpy as np
import pytest

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.experiments import db_ingest, serve_bench, sharded_overhead
from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
from analyzer_tpu_torch.sched import pack_schedule, rate_history

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SERVE_BENCH = os.path.join(_REPO, "experiments", "serve_bench.py")

SERVE_ARGS = [
    "--players", "1500", "--queries", "300", "--naive-queries", "40",
    "--shards", "2", "--frontdoor", "--frontdoor-queries", "400",
    "--frontdoor-connections", "4", "--http-queries", "40", "--seed", "7",
]

#: SERVE_BENCH fields that depend on neither the clock nor compilation.
DETERMINISTIC = (
    ("metric",), ("players",), ("queries",), ("max_batch",),
    ("naive", "queries"), ("sharded", "shards"),
    ("sharded", "bit_identical_to_single"), ("sharded", "steady_retraces"),
    ("frontdoor", "native"), ("frontdoor", "encodes"),
    ("frontdoor", "fallbacks"), ("frontdoor", "connections"),
    ("frontdoor", "pipeline_depth"), ("frontdoor", "readers"),
    ("frontdoor", "queries"), ("frontdoor", "errors"),
    ("frontdoor", "steady_retraces"), ("telemetry", "steady_retraces"),
    ("telemetry", "steady_backend_compiles"),
)


def _keys(d, prefix=()):
    out = set()
    for k, v in d.items():
        out.add(prefix + (k,))
        if isinstance(v, dict):
            out |= _keys(v, prefix + (k,))
    return out


def _get(d, path):
    for k in path:
        d = d[k]
    return d


@pytest.fixture(scope="module")
def serve_lines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_bench")
    port_out, jax_out = str(tmp / "port.json"), str(tmp / "jax.json")
    with contextlib.redirect_stdout(io.StringIO()):
        assert serve_bench.main(SERVE_ARGS + ["--device", "cpu", "--out", port_out]) == 0
    argv = sys.argv
    sys.argv = ["serve_bench.py", *SERVE_ARGS, "--out", jax_out]
    try:
        with contextlib.redirect_stdout(io.StringIO()), pytest.raises(SystemExit) as ex:
            runpy.run_path(JAX_SERVE_BENCH, run_name="__main__")
    finally:
        sys.argv = argv
    assert ex.value.code == 0
    with open(port_out) as f, open(jax_out) as g:
        return json.load(f), json.load(g)


def test_serve_bench_line_has_jax_shape(serve_lines):
    port, jax_line = serve_lines
    assert _keys(port) == _keys(jax_line)


@pytest.mark.parametrize("path", DETERMINISTIC, ids=".".join)
def test_serve_bench_deterministic_field_equals_jax(serve_lines, path):
    port, jax_line = serve_lines
    assert _get(port, path) == _get(jax_line, path)


def test_serve_bench_retrace_fields_read_zero(serve_lines):
    port, _ = serve_lines
    tel = port["telemetry"]
    assert tel["retraces_total"] == tel["steady_retraces"] == 0
    assert tel["backend_compiles_total"] == 0
    assert port["frontdoor"]["stable"] and port["sharded"]["stable"]


def test_serve_bench_inputs_equal_jax():
    ns = runpy.run_path(JAX_SERVE_BENCH, run_name="jax_serve_bench")
    t_port, ids_port, _ = serve_bench.build_table(500, 3)
    t_jax, ids_jax, _ = ns["build_table"](500, 3)
    np.testing.assert_array_equal(t_port, np.asarray(t_jax))
    assert ids_port == ids_jax
    assert serve_bench.gen_matchups(500, 50, 4) == ns["gen_matchups"](500, 50, 4)
    xs = [5.0, 1.0, 3.0, 2.0]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert serve_bench.quantile(xs, q) == ns["quantile"](xs, q)


# -- sharded_overhead ------------------------------------------------------

CFG = RatingConfig()


def _overhead_inputs(n_matches=900, n_players=300):
    players = synthetic_players(n_players, seed=42)
    stream = synthetic_stream(n_matches, players, seed=42,
                              activity_concentration=0.8, max_activity_share=1e-4)
    state = PlayerState.create(
        n_players, rank_points_ranked=players.rank_points_ranked,
        rank_points_blitz=players.rank_points_blitz,
        skill_tier=players.skill_tier, cfg=CFG, device="cpu",
    )
    return state, pack_schedule(stream, pad_row=state.pad_row)


def test_sharded_overhead_tables_equal_the_reference_runner():
    state, sched = _overhead_inputs()
    before = state.table.clone()
    res = sharded_overhead.measure(state, sched, CFG, repeats=1)
    ref, _ = rate_history(state, sched, CFG, kernel="reference")
    want = ref.table.numpy()
    for arm in sharded_overhead.ARMS:
        assert np.array_equal(res[arm]["table"], want, equal_nan=True), arm
    assert np.array_equal(state.table.numpy(), before.numpy(), equal_nan=True)
    assert res["n_steps"] == sched.n_steps


def test_sharded_arms_scatter_once_a_superstep(monkeypatch):
    import analyzer_tpu_torch.parallel.mesh as mesh

    state, sched = _overhead_inputs(600, 200)
    calls = []

    def counting(real):
        def call(*a, **kw):
            calls.append(kw.get("mode"))
            return real(*a, **kw)
        return call

    monkeypatch.setattr(mesh, "row_scatter", counting(mesh.row_scatter))
    monkeypatch.setattr(sharded_overhead, "row_scatter",
                        counting(sharded_overhead.row_scatter))
    runs = sharded_overhead.arms(state, sched, CFG)
    for arm, want in (("plain", 0), ("sharded", sched.n_steps),
                      ("nopsum", sched.n_steps)):
        calls.clear()
        runs[arm]()
        assert len(calls) == want, arm
        assert set(calls) <= {"drop"}


def test_sharded_overhead_main_prints_the_split(capsys):
    assert sharded_overhead.main(["--matches", "450", "--repeats", "1",
                                  "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for word in ("plain", "nopsum", "sharded", "assembly cost",
                 "ms a superstep", "bit-identical to the reference runner: True"):
        assert word in out, word


# -- db_ingest ---------------------------------------------------------------

def test_db_ingest_native_equals_python_and_jax(tmp_path):
    from analyzer_tpu.service import SqlStore as JaxSqlStore

    path = str(tmp_path / "h.db")
    db_ingest.build_db(path, 600, 200, seed=5)
    _dt, native = db_ingest.time_ingest(path, native=True, device="cpu")
    _dt, python = db_ingest.time_ingest(path, native=False, device="cpu")
    assert db_ingest.same_history(native, python)
    jax_hist = JaxSqlStore(f"sqlite:///{path}").load_stream()
    for key in ("player_idx", "winner", "mode_id", "afk"):
        np.testing.assert_array_equal(getattr(native.stream, key),
                                      np.asarray(getattr(jax_hist.stream, key)))
    assert native.match_ids == list(jax_hist.match_ids)
    assert native.player_ids == list(jax_hist.player_ids)


def test_db_ingest_main_reports_parity(tmp_path, capsys):
    db = str(tmp_path / "fixture.db")
    assert db_ingest.main(["--matches", "450", "--db", db, "--device", "cpu"]) == 0
    assert "parity native == python: True" in capsys.readouterr().out
    assert os.path.exists(db)  # a named fixture is kept for reruns
