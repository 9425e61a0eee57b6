"""Service-loop steady-state throughput: the reference's operating shape.

The port's copy of ``experiments/service_bench.py``. The columnar lane
(``cli rate --db``) is for full-history re-rates; the SERVICE lane is the
reference's actual job — AMQP batches of 500 match ids, load the object
graph, encode, rate on the device, write back, commit, ack
(``worker.py:95-199``). This measures that loop end to end with the
in-memory broker and either store:

  * mem    — InMemoryStore object graphs (isolates worker+encode+device)
  * sqlite — SqlStore against a real file-backed DB (adds the per-batch
             selectin loads and the transactional UPDATE commits)

The fixture is the JAX benchmark's: ``n_players = matches // 3`` (floor
12), batches of ``BATCH = 500``, a synthetic history of 3v3 ranked matches
(mem) or ``io.dbgen`` over ``synthetic_stream(max_activity_share=1e-4)``
with participant_items rows (sqlite). The pristine sqlite file is built
once per directory and copied for every run, since the worker's
write-back mutates it.

Usage (the card by default; ``--device cpu`` for a CPU rehearsal):

    python -m analyzer_tpu_torch.experiments.service_bench --store sqlite \\
        [--matches 50000] [--no-pipeline] [--lag N] [--device cpu]

The last line is one JSON object with the run's numbers and the device
they were measured on.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
from analyzer_tpu_torch.service import InMemoryBroker, InMemoryStore, SqlStore, Worker

BATCH = 500  # the reference's BATCHSIZE (worker.py:18)


def build_mem_store(n_matches: int, n_players: int, seed: int):
    """Persistent fake-player population + n 3v3 ranked matches over it.
    Players are SHARED objects: the worker's write-back makes each
    match's posterior the next one's prior, like the reference's DB."""
    from analyzer_tpu_torch.fixtures import (
        fake_items, fake_match, fake_participant, fake_player, fake_roster,
    )

    rng = np.random.default_rng(seed)
    players = []
    for i in range(n_players):
        players.append(fake_player(skill_tier=int(rng.integers(1, 29))))
        players[-1].api_id = f"p{i}"
    store = InMemoryStore()
    ids = []
    # distinct 6-player draws, vectorized with dup-redraw (io/synthetic.py)
    draws = rng.integers(0, n_players, (n_matches, 6))
    need = np.arange(n_matches)
    for _ in range(64):
        rows = np.sort(draws[need], axis=1)
        dup = (rows[:, 1:] == rows[:, :-1]).any(axis=1)
        need = need[dup]
        if need.size == 0:
            break
        draws[need] = rng.integers(0, n_players, (need.size, 6))
    winners = rng.integers(0, 2, n_matches)
    for m in range(n_matches):
        rosters = []
        for t in range(2):
            parts = [
                fake_participant(player=players[draws[m, t * 3 + s]],
                                 items=fake_items(),
                                 skill_tier=players[draws[m, t * 3 + s]].skill_tier)
                for s in range(3)
            ]
            rosters.append(fake_roster(winner=int(winners[m] == t), participants=parts))
        mid = f"m{m:08d}"
        match = fake_match("ranked", rosters, api_id=mid)
        match.created_at = m
        store.add_match(match)
        ids.append(mid)
    return store, ids


def build_db(path: str, n_matches: int, n_players: int, seed: int,
             items: bool = True) -> None:
    """The synthetic reference-schema fixture of the JAX package's
    ``experiments/db_ingest.build_db``: ``io.dbgen`` over
    ``synthetic_stream(max_activity_share=1e-4)``. ``items=True`` adds the
    participant_items rows the SERVICE path's write-back needs
    (``rater.py:104,169``); the columnar ingest never reads them."""
    from analyzer_tpu_torch.io.dbgen import write_history_db
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream

    players = synthetic_players(n_players, seed=seed)
    stream = synthetic_stream(
        n_matches, players, seed=seed, max_activity_share=1e-4
    )
    write_history_db(path, stream, players, items=items)


def match_ids(path: str) -> list[str]:
    """Every match id of a sqlite fixture, chronologically."""
    store = SqlStore(f"sqlite:///{path}")
    try:
        cur = store.conn.cursor()
        cur.execute('SELECT "api_id" FROM "match" ORDER BY "created_at" ASC')
        ids = [r[0] for r in cur.fetchall()]
        cur.close()
    finally:
        store.close()
    return ids


def build_sqlite_store(pristine: str, n_matches: int, n_players: int,
                       seed: int):
    """The PRISTINE fixture is built once at ``pristine``; each run copies
    it to a scratch file beside it — the worker's write-back mutates the
    database, so rerunning against the original would silently benchmark
    pre-rated players."""
    if not os.path.exists(pristine):
        build_db(pristine, n_matches, n_players, seed, items=True)
    scratch = pristine + ".run"
    shutil.copy(pristine, scratch)
    return SqlStore(f"sqlite:///{scratch}"), match_ids(scratch)


def run_loop(worker: Worker, broker: InMemoryBroker, ids: list,
             queue: str) -> dict:
    """Publishes every id, polls until the queue is empty, drains the
    pipelined tail. Returns seconds, batches and matches/s."""
    for mid in ids:
        broker.publish(queue, mid.encode() if isinstance(mid, str) else mid)
    t0 = time.perf_counter()
    batches = 0
    while worker.poll():
        batches += 1
    worker.drain()  # pipelined mode: include the in-flight tail's commits
    dt = time.perf_counter() - t0
    return {"seconds": dt, "batches": batches,
            "matches_per_s": len(ids) / dt if dt > 0 else None}


def main(argv=None) -> int:
    from analyzer_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matches", type=int, default=50_000)
    ap.add_argument("--players", type=int, default=None)
    ap.add_argument("--store", choices=("mem", "sqlite"), default="mem")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument(
        "--no-pipeline", action="store_true",
        help="sequential reference-shaped loop",
    )
    ap.add_argument(
        "--lag", type=int, default=None,
        help="pin the pipelined commit lag (default: auto-tune from the "
        "warmup cost probe, config.py pipeline_lag)",
    )
    ap.add_argument(
        "--fixture-dir", default=None,
        help="where the pristine sqlite fixture is built and kept "
        "(default: a fresh temporary directory, removed at exit)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where batches are rated: cuda (default; refuses to start "
        "without a card) or cpu",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n_players = args.players or max(args.matches // 3, 12)

    tmp = None
    workdir = args.fixture_dir
    if workdir is None:
        workdir = tmp = tempfile.mkdtemp(prefix="service_bench_")
    try:
        t0 = time.perf_counter()
        if args.store == "mem":
            store, ids = build_mem_store(args.matches, n_players, args.seed)
        else:
            os.makedirs(workdir, exist_ok=True)
            store, ids = build_sqlite_store(
                os.path.join(
                    workdir,
                    f"service_bench_{args.matches}_{n_players}_{args.seed}.db",
                ),
                args.matches, n_players, args.seed,
            )
        print(f"fixture ({args.store}): {len(ids)} matches / {n_players} "
              f"players in {time.perf_counter() - t0:.1f} s", flush=True)

        broker = InMemoryBroker()
        cfg = ServiceConfig(
            batch_size=BATCH, idle_timeout=0.0, pipeline_lag=args.lag
        )
        worker = Worker(
            broker, store, cfg, RatingConfig(),
            pipeline=not args.no_pipeline, device=device,
        )
        worker.warmup()
        lag = None
        if not args.no_pipeline:
            eng = worker._ensure_engine()
            lag = eng.lag if eng else None
            print(f"pipeline lag: {lag}"
                  + (" (auto)" if args.lag is None else " (pinned)"), flush=True)
        got = run_loop(worker, broker, ids, cfg.queue)
        stats = worker.stats()
        worker.close()
        failed = broker.qsize(cfg.failed_queue)
        print(f"service loop: {len(ids)} matches in {got['seconds']:.2f} s = "
              f"{got['matches_per_s'] / 1e3:.1f}k matches/s "
              f"({got['batches']} batches of {BATCH}, {failed} dead-lettered)")
        print(json.dumps({
            "store": args.store,
            "pipeline": not args.no_pipeline,
            "matches": len(ids),
            "players": n_players,
            "seconds": got["seconds"],
            "matches_per_s": got["matches_per_s"],
            "batches": got["batches"],
            "dead_letters": failed,
            "lag": lag,
            "measured_rtt_ms": stats["measured_rtt_ms"],
            "measured_host_ms": stats["measured_host_ms"],
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
        }))
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
