"""One run of one benchmark cell.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration file and
its traffic mix, ``portbench/traffic/<traffic>.json``; the traffic's
``driver`` names the general generator under ``portbench/drivers/`` that
reads it. A run:

  1. applies the process settings (``portbench/host.py``) before torch is
     imported, and logs them;
  2. refuses to run without the cards the cell asks for;
  3. makes its data from the seed, builds and warms the program on the
     cell's own shapes (all of it is ``setup_s``);
  4. measures for ``--seconds`` seconds; with ``--trace 1`` under
     ``torch.profiler``, and the per-layer readers
     (``portbench/metrics/<name>.py``) reduce the capture and the
     program's spans and counters;
  5. checks what the timed path produced against the plain reference,
     once the device peak has been read;
  6. refuses to report if a JAX module was loaded in this process.

The last lines on standard error are the numbers compared beside their
limits; the last line on standard output is the result, one JSON object.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import host  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "portbench")

#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "analyzer_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: str, name: str):
    """A module of the benchmark's own, by file path (metric files carry
    dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(spec: dict, workload: str, root: str = ROOT):
    """(workload entry, configuration, traffic) of a cell, by name."""
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return wl, config, traffic


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``analyzer_tpu_torch`` is not ``analyzer_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def metrics_for(spec: dict, workload: str, kind: str) -> list[dict]:
    return [m for m in spec[kind]
            if "workloads" not in m or workload in m["workloads"]]


class Window:
    """What a per-layer reader sees of the measured window."""

    def __init__(self, t0, t1, raw, ops=None, spans=None):
        self.t0, self.t1 = t0, t1
        self.window_s = t1 - t0
        self.raw = raw
        self.ops = ops or []
        self.spans = spans or []
        from portbench.trace import busy_seconds

        clip = [(max(s, t0), min(e, t1)) for _, s, e in self.ops
                if e > t0 and s < t1]
        self.busy_s = busy_seconds(clip) if clip else 0.0

    def span_seconds(self, *names) -> float:
        """Seconds of the named spans inside the window (clipped)."""
        tot = 0.0
        for sp in self.spans:
            if sp["name"] in names:
                tot += max(0.0, min(sp["t1"], self.t1) - max(sp["t0"], self.t0))
        return tot


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             root: str = ROOT, t_start: float | None = None,
             spec: dict | None = None, control: bool = False):
    """Runs the cell and returns the result object, or None where the
    cards the cell asks for are missing (``device="cpu"`` skips that look:
    the harness's own tests). ``overrides`` merges keys into the
    configuration and the traffic (tests shrink sizes with it); ``spec``
    stands in for ``BENCHMARK.json`` (tests of a cell it does not list).
    ``control`` also reads the check's control after the check (its
    readings under ``control``, its seconds under ``control_s``): the
    benchmark's own runs never do."""
    t_start = _T_START if t_start is None else t_start
    spec = load_spec(root) if spec is None else spec
    wl, config, traffic = resolve(spec, workload, root)
    for key, val in (overrides or {}).items():
        (config if key in config else traffic)[key] = val

    import torch

    host.cap_torch_threads(torch)
    if device != "cpu":
        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            log(f"error: the cell asks for {wl['chips']} CUDA device(s); "
                f"cuda available={torch.cuda.is_available()}, "
                f"count={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return None
    dev = torch.device(device)
    if dev.type == "cuda":
        log(f"[device] {torch.cuda.get_device_name(dev)}; "
            f"{host.power_limit()}; torch {torch.__version__} cuda {torch.version.cuda}")
    driver = load_module(os.path.join(root, "portbench", "drivers",
                                      traffic["driver"] + ".py"),
                         "portbench_driver_" + traffic["driver"])
    cell = driver.Cell(config, traffic, seed, dev, log)
    try:
        cell.setup()
        setup_s = time.perf_counter() - t_start
        log(f"[setup] {setup_s:.3f} s {json.dumps(cell.setup_split)}")
        from portbench import trace as tracing

        cell.reset_obs()
        ops = []
        if trace and dev.type == "cuda":
            with tracing.Capture(torch, dev) as cap:
                res = cell.window(seconds)
            ops = cap.ops
        else:
            res = cell.window(seconds)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        spans = tracing.program_spans(cell.tracer(), res["t0"], res["t1"]) if trace else []
        win = Window(res["t0"], res["t1"], res["raw"], ops, spans)
        checks = cell.check()
        if control:
            t = time.perf_counter()
            low = cell.control()
            control_s = time.perf_counter() - t
    finally:
        cell.close()

    found = forbidden_modules()
    if found:
        log("error: JAX or the JAX package was loaded in this process: "
            + ", ".join(found))
        raise SystemExit(4)

    metrics = {}
    if not trace:
        for m in metrics_for(spec, workload, "end_to_end"):
            val = setup_s if m["name"] == "setup_s" else res["metrics"][m["name"]]
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        for m in metrics_for(spec, workload, "per_layer"):
            reader = load_module(os.path.join(root, "portbench", "metrics",
                                              m["name"] + ".py"),
                                 "portbench_metric_" + m["name"].replace(".", "_"))
            val = reader.read(win)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    device_block = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": wl["chips"],
        "memory_peak_bytes": int(peak),
    }
    out = {
        "correct": bool(all(c["ok"] for c in checks)) and res["failed"] == 0,
        "attempted": int(res["attempted"]),
        "failed": int(res["failed"]),
        "metrics": metrics,
        "device": device_block,
    }
    if trace:
        device_block["busy_s"] = win.busy_s
        device_block["window_s"] = win.window_s
        out["breakdown"] = {
            "device_ops": tracing.device_op_totals(ops, win.t0, win.t1),
            "idle_gaps": tracing.idle_gaps(ops, spans, win.t0, win.t1),
        }
    if control:
        out["control"], out["control_s"] = low, control_s
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    for c in checks:
        log(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}) "
            f"{'ok' if c['ok'] else 'FAILED'}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    settings = host.apply(ROOT)
    log(f"[host] {json.dumps(settings)}")
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if out is None:
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
