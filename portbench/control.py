"""The control of a cell's correctness check, at the cell's own size.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 --seconds <s>

For each seed, a run of the cell (``run.run_cell``: set-up, a window of
``--seconds`` at the cell's load, the check of the program against the
plain reference: the lower readings), then the control (the reference
computed in bfloat16, the precision below the float32 the configuration
states, put in the program's place: the upper readings). One JSON line
per seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import host, run


def control_cell(workload: str, seed: int, seconds: float, device: str = "cuda",
                 overrides: dict | None = None, spec: dict | None = None) -> dict:
    out = run.run_cell(workload, seed, seconds, False, device=device,
                       overrides=overrides, spec=spec, control=True)
    if out is None:
        raise SystemExit(3)
    return {"workload": workload, "seed": seed, "attempted": out["attempted"],
            "program": {k: c["value"] for k, c in out["checks"].items()},
            "limits": {k: c["limit"] for k, c in out["checks"].items()},
            "control": out["control"], "control_s": out["control_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of a cell's check")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.log(f"[host] {json.dumps(host.apply(run.ROOT))}")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_cell(args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
