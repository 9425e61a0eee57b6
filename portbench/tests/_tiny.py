"""Tiny sizes of every cell for the CPU tests (never used by a run)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "history10m.stream_fused": {"players": 3000, "matches": 30000,
                                "segment_matches": 5000, "warmup_matches": 3000},
    "history10m.stream_reference": {"players": 3000, "matches": 30000,
                                    "segment_matches": 5000, "warmup_matches": 3000},
    "live1m.worker_backlog": {"players": 20000, "store_matches": 6000,
                              "backlog_matches": 3000, "warmup_batches": 2,
                              "refill_below": 1000, "refill_matches": 1000,
                              "pipeline_lag": 3},
}
SECONDS = 0.5


def spec_for(workload):
    """``BENCHMARK.json``, with a cell built and tested here but left out of
    the benchmark (PERF.md, Open questions) added from
    ``left_out_cells.json``: its workload entry, its configuration's entry
    where the benchmark lists it no more, its own metrics, and its name on
    the listed metrics it shares."""
    import json

    from portbench import run

    spec = run.load_spec(ROOT)
    if workload in {w["name"] for w in spec["workloads"]}:
        return spec
    with open(os.path.join(os.path.dirname(__file__), "left_out_cells.json")) as f:
        cell = json.load(f)[workload]
    spec["workloads"] = spec["workloads"] + [cell["workload"]]
    if "config" in cell:
        spec["configs"] = spec["configs"] + [cell["config"]]
    for kind in ("end_to_end", "per_layer"):
        spec[kind] = [dict(m, workloads=m["workloads"] + [workload])
                      if m["name"] in cell["joins"] else m for m in spec[kind]]
        spec[kind] = spec[kind] + cell[kind]
    return spec
