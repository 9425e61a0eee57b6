"""Scatter-floor measurement on the card: how fast can a superstep's row
scatter go?

Counterpart of ``experiments/scatter_floor.py``. One step writes R rows
into a ``[P, W]`` float32 table in place, ``table[idx[r]] = rows[r]``, with
the R indices distinct within the step; a run is S steps whose index and
row sets repeat every 8 steps, as the superstep runner's scan feeds them.
Same P, R and step counts as the JAX harness. Variants:

  * ``torch16`` / ``torch128`` — ``index_copy_`` (one PyTorch call per
    step) on a table of 16 / 128 floats per row;
  * ``cuda16`` / ``cuda128`` — the hand-written row-scatter kernel
    (:mod:`analyzer_tpu_torch.kernels.row_scatter`): the whole run of S
    steps is one ``row_scatter_steps`` call, one cooperative launch whose
    grid barrier orders step s before step s + 1 (steps s and s + 8 write
    the same rows).

The JAX harness's NSEM (DMA copies in flight) has no counterpart: the
kernel has no DMA ring. Each timed run starts from a fresh table; the best
of 3 runs, divided by S, is printed as us/step and ns/row.

    python -m analyzer_tpu_torch.experiments.scatter_floor [--device cpu]

Runs on the card unless ``--device cpu`` is given (where both variants of
a width run ``index_copy_``: the kernel wrapper's plain version).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from analyzer_tpu_torch.device import resolve_device
from analyzer_tpu_torch.kernels.row_scatter import row_scatter, row_scatter_steps

P = 1_500_000
R = 5120  # rows per superstep: B=512 matches x 10 player slots
#: Steps per run at each row width, as in the JAX harness.
STEPS = {16: 400, 128: 50}
#: Distinct index/row sets; step s uses set s % N_SETS.
N_SETS = 8
#: Timed runs per variant (after one untimed run); the best is printed.
REPEATS = 3


def scatter_torch(table, idx, rows):
    """One step through ``index_copy_`` (``idx`` int64)."""
    table.index_copy_(0, idx, rows)


def scatter_cuda(table, idx, rows):
    """One step through the row-scatter kernel (``idx`` int32)."""
    row_scatter(table, idx, rows)


def run_steps(step, table, idx, rows):
    """Every step of a run, in order, in place on ``table``: one ``step``
    call per step."""
    for s in range(idx.shape[0]):
        step(table, idx[s], rows[s])
    return table


def run_torch(table, idx, rows):
    """A run through ``index_copy_``, one call per step (``idx`` int64)."""
    return run_steps(scatter_torch, table, idx, rows)


def run_cuda(table, idx, rows):
    """A run through the row-scatter kernel: every step in one launch
    (``idx`` int32)."""
    return row_scatter_steps(table, idx, rows)


#: name -> (row width, run function, index dtype)
VARIANTS = {
    "torch16": (16, run_torch, torch.int64),
    "torch128": (128, run_torch, torch.int64),
    "cuda16": (16, run_cuda, torch.int32),
    "cuda128": (128, run_cuda, torch.int32),
}


def make_xs(s_steps: int, width: int, rng: np.random.Generator,
            n_players: int = P, n_rows: int = R):
    """The run's inputs, as numpy: ``idx`` ``[S, R]`` int32 (distinct
    within a step) and ``rows`` ``[S, R, W]`` float32, repeating every
    :data:`N_SETS` steps. Draws from ``rng`` in the JAX harness's order."""
    idx = np.stack(
        [rng.choice(n_players, size=n_rows, replace=False) for _ in range(N_SETS)]
    ).astype(np.int32)
    rows = rng.random((N_SETS, n_rows, width)).astype(np.float32)
    step_set = np.arange(s_steps) % N_SETS
    return idx[step_set], rows[step_set]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_variant(name: str, device, rng: np.random.Generator,
                 n_players: int = P, n_rows: int = R, repeats: int = REPEATS) -> float:
    """Best-of-``repeats`` seconds per step of a variant; a fresh zero table
    for every timed run."""
    width, run, idx_dtype = VARIANTS[name]
    device = resolve_device(device)
    idx, rows = make_xs(STEPS[width], width, rng, n_players, n_rows)
    idx = torch.from_numpy(idx).to(device=device, dtype=idx_dtype)
    rows = torch.from_numpy(rows).to(device)
    run(torch.zeros((n_players, width), device=device), idx, rows)
    _sync(device)  # built, compiled and warm
    best = float("inf")
    for _ in range(repeats):
        table = torch.zeros((n_players, width), device=device)
        _sync(device)
        t0 = time.perf_counter()
        run(table, idx, rows)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best / idx.shape[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device.type} ({kind}); P={P} R={R}", flush=True)
    for name in VARIANTS:
        per_step = time_variant(name, device, np.random.default_rng(0))
        print(f"{name:10s}: {per_step * 1e6:8.1f} us/step  "
              f"{per_step / R * 1e9:6.1f} ns/row", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
