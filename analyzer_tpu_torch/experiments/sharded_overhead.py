"""Sharded-runner single-device overhead breakdown: the D=1 ablation.

The port's copy of ``experiments/sharded_overhead.py``, over the port's
own pieces. At D=1 the prior assembly's ``all_reduce`` is a no-op, so
every difference between the arms is device and dispatch work, not
communication:

  plain    — the reference runner's chunk (``sched.runner.
             _reference_chunk_``) over the whole schedule: whole-row
             gather -> ``rate_gathered`` -> the full-batch row scatter;
  sharded  — the mesh step (``parallel.mesh.sharded_step_fn``) with
             ``parallel.mesh.build_routing``: the prior assembly
             (``where`` over the owned rows, the shard sum, the group's
             ``all_reduce``), then the routing-compacted scatter through
             ``row_scatter(mode="drop")``, one launch a superstep;
  nopsum   — sharded minus the assembly: priors read by a DIRECT
             whole-row gather (valid only at D=1, where the shard owns
             every row), the compacted scatter kept.

The sharded-vs-nopsum gap is the assembly's cost; the nopsum-vs-plain gap
is the compacted scatter's. All three tables are bit-identical to each
other and to the reference runner (``rate_history(kernel="reference")``).
The tables are put on the device inside each timed run, as the JAX
experiment puts its donated carry; the schedule and the routing arrays
are preloaded.

Usage (the card by default; ``--device cpu`` for a CPU rehearsal):

    python -m analyzer_tpu_torch.experiments.sharded_overhead \\
        [--matches 500000] [--players N] [--repeats 5] [--device cpu]

Prints the JAX experiment's split (min of ``--repeats`` after a warm-up
run of each arm), each arm's ms a superstep, and the ``row_scatter``
launches of one run of each sharded arm (one a superstep on the card).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import MatchBatch, PlayerState
from analyzer_tpu_torch.core.update import rate_gathered
from analyzer_tpu_torch.device import resolve_device
from analyzer_tpu_torch.kernels import row_scatter as rs
from analyzer_tpu_torch.kernels.row_scatter import row_scatter
from analyzer_tpu_torch.parallel.mesh import build_routing, make_mesh, sharded_step_fn
from analyzer_tpu_torch.sched.runner import _reference_chunk_

N_MATCHES = 500_000
REPEATS = 5
ARMS = ("plain", "sharded", "nopsum")


def nopsum_step_fn(cfg: RatingConfig, pad_row: int):
    """The sharded step with the prior assembly ablated: a direct
    whole-row gather (D=1 only — the single shard owns every row), the
    compacted scatter kept. Same arguments as ``sharded_step_fn``'s run."""

    def run(block, pidx, winner, mode_id, afk, sel, target):
        width = block.shape[1]
        for s in range(pidx.shape[0]):
            batch = MatchBatch(
                player_idx=pidx[s], slot_mask=pidx[s] != pad_row,
                winner=winner[s], mode_id=mode_id[s], afk=afk[s].bool(),
            )
            out = rate_gathered(block[pidx[s].long()], batch, cfg)
            new_flat = out.new_rows.reshape(-1, width)
            row_scatter(block, target[s], new_flat.index_select(0, sel[s].long()),
                        mode="drop")
        return block

    return run


def arms(state: PlayerState, sched, cfg: RatingConfig) -> dict:
    """name -> a zero-argument run of that arm over the whole schedule,
    from the state's table as host memory to the final table on the
    device (a fresh table each call)."""
    dev = state.table.device
    table0 = state.table.cpu().clone()
    if dev.type == "cuda":
        table0 = table0.pin_memory()
    pad_row = state.pad_row
    n_rows = table0.shape[0]
    routing = build_routing(sched, n_rows, 1)
    pidx, _mask, winner, mode_id, afk = sched.host_window(0, sched.n_steps)
    views = tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                  for a in (pidx, winner, mode_id, afk))
    sel = torch.from_numpy(routing.sel[:, 0]).to(dev).contiguous()
    # At D=1 the block is the table itself (rows_per_shard = its rows), so
    # the scatter target is the routing's dst, padding out of range.
    target = torch.from_numpy(routing.dst[:, 0]).to(dev).contiguous()
    step_sharded = sharded_step_fn(make_mesh(1, device=dev), cfg, n_rows, pad_row)
    step_nopsum = nopsum_step_fn(cfg, pad_row)

    def fresh():
        return table0.to(dev, non_blocking=True, copy=True)

    def plain():
        table = fresh()
        _reference_chunk_(table, pad_row, views, cfg, False)
        return table

    def sharded():
        return step_sharded(fresh(), *views, sel, target)

    def nopsum():
        return step_nopsum(fresh(), *views, sel, target)

    return {"plain": plain, "sharded": sharded, "nopsum": nopsum,
            "capacity": routing.capacity}


def _timed(fn, dev) -> tuple[float, torch.Tensor]:
    t0 = time.perf_counter()
    table = fn()
    table[:1].cpu()  # the fetch that ends the run, as the JAX experiment's
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, table


def measure(state: PlayerState, sched, cfg: RatingConfig,
            repeats: int = REPEATS) -> dict:
    """Each arm's minimum wall over ``repeats`` runs after a warm-up run,
    its final table (host numpy) and, for the sharded arms, the
    ``row_scatter`` launches of one run (the kernel's count: 0 on the CPU,
    where the wrapper runs the plain version)."""
    dev = state.table.device
    runs = arms(state, sched, cfg)
    out = {"n_steps": sched.n_steps, "capacity": runs["capacity"]}
    for name in ARMS:
        rs.launches = 0
        _s, table = _timed(runs[name], dev)
        launches = rs.launches
        best = min(_timed(runs[name], dev)[0] for _ in range(repeats))
        out[name] = {"s": best, "table": table.cpu().numpy(),
                     "launches": launches}
    return out


def report(res: dict, dev: torch.device) -> list[str]:
    """The JAX experiment's split, plus ms a superstep and, for the sharded
    arms, the ``row_scatter`` launches of one run."""
    p, n, s = (res[a]["s"] for a in ("plain", "nopsum", "sharded"))
    steps = res["n_steps"]
    per = {a: 1e3 * res[a]["s"] / max(steps, 1) for a in ARMS}
    lines = [
        f"plain (reference runner's chunk):  {p:.3f} s ({per['plain']:.4f} ms a superstep)",
        f"nopsum (direct gather + routing):  {n:.3f} s = {n / p:.2f}x plain "
        f"({per['nopsum']:.4f} ms a superstep, row_scatter launches "
        f"{res['nopsum']['launches']})",
        f"sharded (prior assembly + routing): {s:.3f} s = {s / p:.2f}x plain "
        f"({per['sharded']:.4f} ms a superstep, row_scatter launches "
        f"{res['sharded']['launches']})",
        f"-> assembly cost {s - n:+.3f} s, routing-scatter cost {n - p:+.3f} s "
        f"(one call, one {dev.type} device; compare runs only within a call)",
    ]
    return lines


def main(argv=None) -> int:
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
    from analyzer_tpu_torch.sched import pack_schedule, rate_history

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matches", type=int, default=N_MATCHES)
    ap.add_argument("--players", type=int, default=None,
                    help="default: a third of --matches")
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_players = args.players or max(args.matches // 3, 12)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev.type} ({name}), {args.matches} matches / {n_players} "
          "players, D=1 ablation")
    cfg = RatingConfig()
    players = synthetic_players(n_players, seed=args.seed)
    stream = synthetic_stream(args.matches, players, seed=args.seed,
                              activity_concentration=0.8, max_activity_share=1e-4)
    state = PlayerState.create(
        n_players, rank_points_ranked=players.rank_points_ranked,
        rank_points_blitz=players.rank_points_blitz,
        skill_tier=players.skill_tier, cfg=cfg, device=dev,
    )
    sched = pack_schedule(stream, pad_row=state.pad_row)
    res = measure(state, sched, cfg, args.repeats)
    print(f"schedule: {sched.n_steps} steps x B={sched.batch_size}, occupancy "
          f"{sched.occupancy:.3f}, routing K={res['capacity']}")
    for line in report(res, dev):
        print(line)
    ref, _ = rate_history(state, sched, cfg, kernel="reference")
    want = ref.table.cpu().numpy()
    same = all(np.array_equal(res[a]["table"], want, equal_nan=True) for a in ARMS)
    print(f"plain, sharded and nopsum tables bit-identical to the reference "
          f"runner: {same}")
    if dev.type == "cuda":
        if any(res[a]["launches"] != sched.n_steps for a in ("sharded", "nopsum")):
            print("row_scatter launches differ from the supersteps", file=sys.stderr)
            return 1
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
