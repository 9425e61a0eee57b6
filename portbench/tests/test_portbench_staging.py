"""The readers of the re-rate's staging split and waits: each program
span's seconds clipped to the window, per superstep for the three parts of
``feed.materialize`` and as a union over the window for the two waits;
nothing where the program emits no such span; and a traced run on the CPU
that reports every metric the program's spans feed."""

import json
import os
import subprocess
import sys

import pytest

from _tiny import ROOT, SECONDS, TINY, spec_for
from portbench import run

STAGING = {"gather_ms_per_step.rerate": "feed.gather",
           "plan_ms_per_step.rerate": "feed.plan",
           "pack_ms_per_step.rerate": "feed.pack"}
WAITS = {"starved_share.rerate": "feed.starved",
         "assign_wait_share.rerate": "feed.wait_assign"}


def reader(name):
    return run.load_module(os.path.join(ROOT, "portbench", "metrics", name + ".py"),
                           "t_staging_" + name.replace(".", "_"))


def _span(name, t0, t1, tid=2):
    return {"name": name, "t0": t0, "t1": t1, "tid": tid, "args": {"start": 0}}


@pytest.mark.parametrize("name", sorted(STAGING) + sorted(WAITS))
def test_nothing_without_data(name):
    assert reader(name).read(run.Window(0.0, 1.0, {})) is None


@pytest.mark.parametrize("name", sorted(STAGING))
def test_staging_ms_per_step_clipped_and_divided(name):
    span = STAGING[name]
    spans = [_span("feed.materialize", 0.5, 5.5),
             _span(span, 0.5, 1.5), _span(span, 2.0, 2.5), _span(span, 4.5, 5.5)]
    # 0.5 + 0.5 + 0.5 s inside [1, 5], over 100 supersteps
    w = run.Window(1.0, 5.0, {"steps": 100}, [], spans)
    assert reader(name).read(w) == pytest.approx(1e3 * 1.5 / 100)
    # a program that does not split feed.materialize: nothing to read
    w = run.Window(1.0, 5.0, {"steps": 100}, [], spans[:1])
    assert reader(name).read(w) is None
    assert reader(name).read(run.Window(1.0, 5.0, {"steps": 0}, [], spans)) is None


@pytest.mark.parametrize("name", sorted(WAITS))
def test_wait_share_is_a_union_clipped_to_the_window(name):
    span = WAITS[name]
    split = _span("feed.gather", 0.0, 0.1)
    spans = [split, _span(span, 0.5, 2.0, tid=1), _span(span, 1.5, 2.5, tid=3),
             _span(span, 3.5, 6.0, tid=1)]
    # union 1.0-2.5 and 3.5-5.0 inside [1, 5]: 3.0 s of 4
    w = run.Window(1.0, 5.0, {}, [], spans)
    assert reader(name).read(w) == pytest.approx(100 * 3.0 / 4)
    # a program with the split but no wait in the window waited 0
    assert reader(name).read(run.Window(1.0, 5.0, {}, [], [split])) == 0.0
    # one without either: nothing
    w = run.Window(1.0, 5.0, {}, [], [_span("feed.materialize", 1.0, 5.0)])
    assert reader(name).read(w) is None


def test_a_traced_run_reports_every_program_span_metric():
    workload = "history10m.stream_fused"
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from portbench import run\n"
        "sys.path.insert(0, %r)\n"
        "from _tiny import spec_for\n"
        "out = run.run_cell(%r, 2**31 + 41, %r, True, device='cpu', overrides=%r,"
        " t_start=0.0, spec=spec_for(%r))\n"
        "print(json.dumps({'correct': out['correct'], 'metrics': sorted(out['metrics'])}))\n"
    ) % (ROOT, os.path.dirname(os.path.abspath(__file__)), workload, SECONDS,
         TINY[workload], workload)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"]
    want = {m["name"] for m in run.metrics_for(spec_for(workload), workload, "per_layer")
            if m["source"] == "program_span"}
    assert set(STAGING) | set(WAITS) <= want <= set(got["metrics"])
