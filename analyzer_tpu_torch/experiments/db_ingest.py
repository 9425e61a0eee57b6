"""Columnar DB ingest benchmark: the native C scanner against python bulk scans.

The port's copy of ``experiments/db_ingest.py``. It builds a synthetic
full-history sqlite database (the reference's data source shape —
match/roster/participant/player rows keyed by TEXT api_ids,
``worker.py:176-191``) with ``io.dbgen`` and times the port's
``SqlStore.load_stream`` both ways:

  * native: ``service/csrc/fastsql.cc`` — one sqlite3 C-API walk per pass,
    values copied into numpy buffers (no per-row Python, no text round
    trip);
  * python: the bulk scan — one ``group_concat`` aggregate per (chunk,
    column) and a numpy text parse.

The two histories must be equal: the stream's every column, and the
player table (NaN where unrated) the load builds on the device.

Usage (the card by default; ``--device cpu`` for a CPU rehearsal):

    python -m analyzer_tpu_torch.experiments.db_ingest --matches 1000000 \\
        [--db PATH] [--skip-python] [--device cpu]

Without ``--db`` the fixture is built in a temporary directory and removed
at exit; with ``--db`` it is built there once and reused on reruns.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from analyzer_tpu_torch.device import resolve_device
from analyzer_tpu_torch.io.dbgen import write_history_db
from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
from analyzer_tpu_torch.service import SqlStore


def build_db(path: str, n_matches: int, n_players: int, seed: int,
             items: bool = False) -> None:
    """Synthetic full-history fixture via ``io.dbgen``. ``items=True`` adds
    the participant_items rows the service path's write-back needs; the
    columnar ingest never reads them, so the benchmark skips them."""
    players = synthetic_players(n_players, seed=seed)
    stream = synthetic_stream(n_matches, players, seed=seed,
                              max_activity_share=1e-4)
    write_history_db(path, stream, players, items=items)


def time_ingest(path: str, native: bool, device=None) -> tuple[float, object]:
    """Seconds of one ``load_stream`` through the native scanner or the
    python scan, and the loaded history (its table synchronised)."""
    store = SqlStore(f"sqlite:///{path}")
    if not native:
        store._native_sql = False
    dev = resolve_device(device)
    t0 = time.perf_counter()
    hist = store.load_stream(device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, hist


def same_history(a, b) -> bool:
    """Stream columns and the player table equal (NaN where unrated)."""
    return (
        all(np.array_equal(getattr(a.stream, k), getattr(b.stream, k))
            for k in ("player_idx", "winner", "mode_id", "afk"))
        and np.array_equal(a.state.table.cpu().numpy(),
                           b.state.table.cpu().numpy(), equal_nan=True)
        and a.match_ids == b.match_ids and a.player_ids == b.player_ids
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matches", type=int, default=1_000_000)
    ap.add_argument("--players", type=int, default=None)
    ap.add_argument("--db", default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument(
        "--skip-python", action="store_true",
        help="time only the native path (the python scan is several times slower)",
    )
    ap.add_argument("--device", default=None,
                    help="torch device of the loaded table (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_players = args.players or max(args.matches // 3, 12)
    tmp = None
    path = args.db
    if path is None:
        tmp = tempfile.mkdtemp(prefix="db_ingest_")
        path = os.path.join(tmp, f"history_{args.matches}_{n_players}.db")
    try:
        if not os.path.exists(path):
            print(f"building fixture {path} ...", flush=True)
            t0 = time.perf_counter()
            build_db(path, args.matches, n_players, args.seed)
            print(f"  built in {time.perf_counter() - t0:.1f} s "
                  f"({os.path.getsize(path) / 1e6:.0f} MB)")
        else:
            print(f"reusing fixture {path} ({os.path.getsize(path) / 1e6:.0f} MB)")
        dt_n, hist_n = time_ingest(path, native=True, device=dev)
        print(f"native ingest: {dt_n:.2f} s  ({args.matches / dt_n / 1e3:.0f}k "
              f"matches/s) on {dev}")
        if args.skip_python:
            return 0
        dt_p, hist_p = time_ingest(path, native=False, device=dev)
        print(f"python ingest: {dt_p:.2f} s  ({args.matches / dt_p / 1e3:.0f}k "
              f"matches/s)  -> native is {dt_p / dt_n:.2f}x faster")
        same = same_history(hist_n, hist_p)
        print(f"parity native == python: {same}")
        return 0 if same else 1
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
