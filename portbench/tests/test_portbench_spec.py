"""BENCHMARK.json and the files it names: everything a cell needs is found
by name, and the file keeps the contract's shape."""

import json
import os
import re

import pytest

from _tiny import ROOT, TINY, spec_for
from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SPEC = run.load_spec(ROOT)


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24
    # A full check of 24 cells must fit the driver's 43200 s.
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e
    assert "setup_s" in e2e


@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_resolves_by_name(workload):
    spec = spec_for(workload)
    wl, config, traffic = run.resolve(spec, workload, ROOT)
    assert wl["chips"] == 1
    driver = run.load_module(
        os.path.join(ROOT, "portbench", "drivers", traffic["driver"] + ".py"),
        "t_driver_" + traffic["driver"])
    assert hasattr(driver, "Cell")
    e2e = run.metrics_for(spec, workload, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layers = run.metrics_for(spec, workload, "per_layer")
    assert layers
    for m in layers:
        reader = run.load_module(
            os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"),
            "t_metric_" + m["name"].replace(".", "_"))
        assert callable(reader.read)
        assert m["moves"] in {x["name"] for x in e2e}


def test_every_cell_has_a_tiny_size():
    assert {w["name"] for w in SPEC["workloads"]} <= set(TINY)


def test_configs_are_used_and_their_files_distinct():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert used == {c["name"] for c in SPEC["configs"]}
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
