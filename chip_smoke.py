#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``analyzer_tpu_torch``) on one card.

    python3 chip_smoke.py

Drives the port's paths on the north-star configuration (10M synthetic
matches, 1.5M players; bench.py's stream settings
``activity_concentration=0.8``, ``max_activity_share=1e-4``, seed 42, every
player starting from the unknown-player seed as ``cli rate`` starts a
stream file) through the entry points a user calls, and holds every
kernel against its plain PyTorch version. Phases, each printing its own
lines:

  1. device: the card's name and power limit;
  2. build: the two CUDA kernels (nvcc) and the host packer, sqlite and CSV
     scanners (g++), built from the checkout's sources in parallel; each
     must load;
  3. scatter: the scatter-floor experiment
     (``python -m analyzer_tpu_torch.experiments.scatter_floor``) at
     P=1.5M, R=5120, W=16 and 128, with the row-scatter kernel's launches
     counted over it (one per run of S steps); then S steps (400 at W=16,
     50 at W=128) through ``row_scatter_steps`` (one launch), through
     ``row_scatter`` (a launch per step) and through ``index_copy_`` from
     the same starting table must give bit-identical tables, and all three
     are timed per step, by CUDA events and by the profiler's device time;
  4. kernel vs plain at full width: the first 8 fused windows of the
     schedule, most of them cut short by a spill and padded with an inert
     tail, through the fused-window kernel (clusters of 8 and 16 CTAs, the
     tail skipped) and its plain PyTorch version on the same CUDA inputs
     (gates and NaN pattern exact, floats within ``KERNEL_RTOL``); then
     the same history prefix through the kernel at fuse windows 1, 4 and
     16, and twice at 16, must give bit-identical tables;
  5. main: ``pack_schedule(windowed=True)`` + ``rate_history(kernel=
     "fused")`` at full size, with the kernel's launch count taken over
     exactly that run (it must equal the windows dispatched), run with the
     runner's spans on and under ``utils.profiling.trace`` (torch.profiler,
     CPU + CUDA): one line splits the consumer loop's wall into feed wait,
     dispatch, fetch and hooks (they must account for it within
     ``SPLIT_TOL``) beside the producer thread's staging, and the
     capture's attribution (``obs.profview``) gives device-busy seconds,
     idle share and the top kernels — ``fused_window`` must be among them,
     on a device lane; then the
     first twentieth of the schedule through ``kernel="reference"`` (plain
     PyTorch on the card) and through the fused path: NaN pattern exact,
     floats within ``PATH_RTOL``;
  prefix: the phases that re-rate the history a second time run on its
     first million matches (over the whole player table), against
     ``rate_history(kernel="fused")`` on that prefix, launches counted,
     its consumer loop split as [main]'s;
  6. stream: ``rate_stream(kernel="fused")`` over the prefix must give the
     prefix's table bit for bit, through the kernel;
  6a. mesh: ``parallel.rate_history_sharded`` over ``MESH_SHARDS`` logical
     shards on the card, over the prefix, with a ``ShardedViewPublisher``
     wired in: the table equals the prefix's bit for bit, the row-scatter
     kernel launches once a superstep (``mode="drop"``), the ``mesh.*``
     counters and the consumer loop's split (feed wait, dispatch, publish)
     are printed; a burst of every query kind from 8 threads through a
     ``ShardedQueryEngine`` equals a single-plane ``QueryEngine`` and
     ``serve.oracle``; at D = 1, 2, 8 and through ``rate_stream(mesh=2)``
     the first 100,000 matches equal ``rate_history(kernel="reference")``
     bit for bit; ``row_scatter(mode="drop")`` equals its plain version at
     the run's shapes and is timed (back to back, queued behind a sleep
     kernel, and a call's host time against the bare launch's);
     ``cli rate --mesh 0`` in a subprocess
     joins an NCCL group of world size 1 (COORDINATOR_ADDRESS /
     NUM_PROCESSES / PROCESS_ID) and writes ``cli rate``'s checkpoint;
     ``cli serve --shards 4`` on it answers ``/v1/*`` with ``--shards 1``'s
     bytes; ``cli train --mesh 2`` gives ``cli train``'s weights within
     ``MESH_TRAIN_ATOL``; one ``BENCH_MESH=2`` bench line at 100,000
     matches;
  7. tier: the prefix through ``rate_history(kernel="fused",
     hot_rows=262144, view_publisher=pub)`` — a hot set of 17% of the
     players over a pinned host tier — with the kernel's launch count taken
     over that run: the table must equal the prefix's bit for bit, and the
     run must have paged; then the first twentieth of the schedule at
     ``hot_rows=32768`` with the reference kernel, a hot set smaller than a
     chunk's rows (chunks split, rows thrash), against the untiered prefix
     of phase 5, bit for bit;
  8. serve: the view phase 7 published last (through the patch path) must
     equal a full publish of the final table bit for bit; a warmed
     ``QueryEngine`` on the card then answers 256 ratings pages of 64 ids,
     1,024 5v5 win probabilities, leaderboards at k = 10, 100, 1000, tier
     histograms and 256 percentiles submitted from 8 threads, every
     response held to ``serve.oracle`` on the view's host table with
     tolerance 0 (a table with a tie class across the k-th place too);
     then 4 readers against a writer that republishes patches: versions
     only rise per reader and each response equals the oracle at its own
     version;
  9. cli: the prefix saved as npz, then ``cli rate --kernel fused --trace
     DIR --metrics-out m.json --trace-events t.jsonl`` (the streamed path)
     must report the prefix's ``players_rated`` and ``mean_mu``; in
     subprocesses ``cli metrics --format summary`` and ``cli profile DIR``
     exit 0 (the snapshot counts supersteps and ``batch.compute`` spans,
     the capture names ``fused_window`` on a device lane) and ``cli trace``
     on the span export exits 2, as the JAX CLI's does on a rate run's
     export (it holds no causal-trace events); on the same prefix a
     bounded run with periodic
     checkpoints plus ``--resume`` must equal a one-shot checkpointed run
     bit for bit, and so must ``cli rate --hot-rows``; ``cli rate
     --obs-port 0 --kernel fused --checkpoint`` on the prefix, with a thread
     scraping obsd's ``/metrics`` at 20 Hz, must write [prefix]'s table bit
     for bit, and its last scrape's ``fused.windows_total`` must equal the
     run's ``fused_window`` launches;
 10. serve-http: ``python -m analyzer_tpu_torch.cli serve --checkpoint`` on
     that one-shot checkpoint as a subprocess on the card, queried through
     ``cli query`` for each kind: bodies equal the in-process engine's;
 11. rater: one 3v3 of fresh tier-15 players through ``rater.rate_match``
     on the card: winner shared mu 2052.41, equal to ``rate_and_apply`` on
     the same match;
 12. db: the reference's DB round trip at its documented size — 1M
     matches / 333,333 players written by ``io.dbgen`` (no
     participant_items rows, as the JAX package's ingest fixture), then
     ``cli rate --db --db-write --kernel fused`` in a subprocess (its
     load / rate / db_write seconds, its ``fused_window`` launches, and
     the native scanner's scans, which must be nonzero with no fallback)
     and ``--kernel reference`` on a copy: the player rows of the two
     files equal bit for bit; then ``cli serve --db`` on the written file,
     whose ``cli query ratings`` and ``leaderboard --k 10`` bodies must
     equal the database rows exactly;
 13. worker: the service_bench fixture (50,000 matches / 16,666 players
     with participant_items rows) in four copies: ``Worker(InMemoryBroker(),
     SqlStore(copy), ServiceConfig(batch_size=500, idle_timeout=0))``
     sequential, and pipelined with the lag ``warmup()`` chose and a serve
     plane (``serve_port=0``): both rate all 50,000 with no dead letter, the
     two files' player / participant / participant_items / match rows are
     equal bit for bit, ``/v1/ratings`` over HTTP equals the committed
     rows, and ``cli rate --db --db-write --kernel fused`` on the third
     copy writes the same player rows; on the fourth copy one match loses
     its participant_items rows and the pipelined loop, fed the first
     10,000 ids, dead-letters exactly that message. Each loop's matches/s,
     lag, probe, native-scan fallbacks and per-batch span split are
     printed, and each full loop's wall split into feed wait (broker
     polls), encode, pack, dispatch, fetch and hooks (within
     ``SPLIT_TOL``). Causal tracing is on for those two runs; the
     sequential one is armed with ``Worker(profile_dir=)`` and asks for
     ``WORKER_CAPTURES`` device-profiler windows mid-run, each attributed
     (device busy and idle share beside its batch's ``batch.compute``);
     ``cli trace`` reconstructs its span export and ``cli profile
     --trace-events`` joins a capture to it (both exit 0). The poison
     drill's dead letter must leave one capture directory with its
     ``manifest.json``. The sequential run has the calibration ledger on
     (the Worker's default): its quality block (matches scored, Brier,
     log-loss, ECE, reliability bins) is printed; then two more copies
     rate the first ``QUALITY_IDS`` ids sequentially with ``quality=True``
     and ``quality=False``: written rows, deterministic stats and topic
     traffic equal bit for bit;
 13a. planes: two more copies rate the first ``PLANES_IDS`` ids
     sequentially with the serve plane on — one Worker with obsd, the
     flight recorder, the SLO plane and a shadow audit of every served
     query, one with every plane off — each answering one query of each
     kind after every flush: rows and responses equal bit for bit, both
     walls printed. While the planes run a client thread hits every
     ``/v1/*`` route and every obsd route (each route's HTTP statuses
     printed); then ``cli fleet --check`` on its obsd exits 0, the audit
     has checked responses with 0 mismatches, and a poisoned match's dead
     letter burns a doctored zero-dead-letters objective over a 2 s window:
     ``/readyz`` turns 503, and the flight dump the burn wrote holds
     ``history.json``, which ``cli history`` renders;
 13b. models: BASELINE configs 1, 3 and 4 through the port's cli on the
     card. ``synth --matches 200000 --players 40000 --seed 7`` with
     ``--telemetry``, and with ``--synergy 2.0`` (BASELINE.md's
     model-quality provenance streams), then ``train`` with ``--model
     logistic``, ``--model mlp --hidden 64`` and ``--model mlp
     --telemetry`` on the first and logistic and mlp on the second: each
     JSON line with its features / train seconds; losses finite, the
     telemetry MLP's eval accuracy > 0.95, both synergy heads beating
     ``baseline_rating_only`` on eval log-loss. On a 20,000-match /
     4,000-player stream ``train --model logistic|mlp --out`` and ``elo
     --out`` on the card against the same commands with ``--device cpu``
     (subprocesses, run beside the card's work): weights within
     ``MODEL_ATOL``, Elo within ``ELO_ATOL``/``EXP_ATOL``. The features pass
     on that stream's first ``FEATURES_EAGER_MATCHES`` matches with its
     per-step CUDA graph and with eager dispatch: bit-identical, both
     timed. ``models.elo_history`` over [main]'s 10M schedule: seconds,
     matches/s, finite ratings, and the total rating mass's drift from
     P x 1500 beside the share unequal teams explain exactly and the
     float32 rounding bound; then ``cli elo`` on the 1M prefix as a file.
     TF32 stays off (printed). The phase's wall is printed;
 14. bench: ``cli bench --kernel fused --hot-rows 32768 --profile`` in a
     subprocess at bench's default workload (500,000 matches, 166,666
     players, conc 0.8, max share 1e-4), ``BENCH_REPEATS=1``: the BENCH line
     is printed whole, with the fused kernel's launches over the run; it
     must show both bit-identities (fused = reference, tiered = resident),
     a roofline whose device time came from the profile with
     ``fused_window`` the dominant kernel, and ``min_over_reference``,
     ``streamed.min_over_device``, the tracing tax and the
     ``watchdog_overhead`` and ``federate_overhead`` blocks (printed);
 15. ingest: ``cli bench --ingest`` at its defaults (200,000 matches,
     windows of 4096 rows), ``BENCH_REPEATS=2``: native decoder, pinned
     slabs, arena hit rate >= 0.9, ``ingest.fallbacks_total`` 0 in its
     snapshot; then the 1M prefix written as CSV: ``load_stream_csv``
     through fastcsv equals the python parser bit for bit, and every
     decoder window staged onto the card by ``stage_ingest_window`` (the
     next ones decoded while earlier copies may still run) and fetched
     back at the end equals its host columns and the parser's rows;
 15a. migrate: the zero-downtime re-rate (``migrate``) of that 1M-prefix
     CSV over the whole player table: ``run_migration(kernel="fused")``
     into a ``LineageManager`` over a live ``ViewPublisher`` primed with
     the seed table, under an ``AdmissionController`` with no live backlog
     (its halvings printed), every ``fused_window`` launch timed by CUDA
     events: the migrated and the served (cut over) tables equal [prefix]'s
     bit for bit, the consumer loop split as [main]'s; a run killed at half
     its steps and resumed from its checkpoint, and the tiered run at
     ``hot_rows=262144``, bit for bit too; in subprocesses ``cli migrate
     --kernel fused`` on the first 100,000 matches against ``cli rate``
     (checkpoint tables bit for bit) and ``cli bench --migrate`` at 50,000
     (one repeat, a 200,000-match assign microbench): streamed,
     bit-identical, the native assigner, with its matches/s, ttfd, cutover
     pause, live p99 and the assign rates printed;
 16. oracle: a seeded sample of 256 real matches from the first step of
     the first 16 fused windows of a [bench]-sized schedule, rated by the
     CUDA kernel with collect, against the port's 50-digit mpmath oracle
     (``ops.oracle``): shared and per-mode mu / sigma and the quality
     within tests/test_oracle.py's relative bounds (1e-5, 1e-4, 1e-5);
 16a. soak: two closed-loop soaks (``loadgen``) on the card at the rig
     widths (1,000,000 players, 2,000 matches and 500 queries a virtual
     second, batches of 500, queries over ``/v1/*``), 1 virtual second,
     not realtime: A on one queue and one serve shard, B on four broker
     partitions with priority lanes, four serve shards and a
     100,000-match migration under the load. B's deterministic block
     equals A's byte for byte, its migrated lineage its from-scratch
     reference, both pass ``soak_violations``; matches/s, the query
     workload's p50 / p99 per kind and the migration block are printed;
 17. timing: the fused window per window at the main path's shapes
     (``python -m analyzer_tpu_torch.experiments.window_timing``'s
     measurement: windows cut to 1..16 looped steps for the per-step
     slope, then as the main path calls it, with every step looped, and
     with a cluster of 16), beside its plain version and its bound; then
     [main]'s fused_window by CUDA events x launches beside its profiler
     attribution; one ``{"kernels": [...]}`` line: per kernel its launches on its path
     (the fused window's on the tiered path, the DB lane, the worker
     phase's ``cli rate --db``, [bench]'s run and [migrate]'s runs — with
     the migration's ms a window by CUDA events — beside them; the row
     scatter's on [mesh]'s sharded re-rate, at its shapes, with the
     scatter-floor experiment's numbers as ``floor_*``), the error
     against its plain version, its time at its path's shapes beside the
     plain version's, the library call's and the card's bound, and the
     time of its earlier launch pattern measured in this run (the row
     scatter launched per step; the fused window with its inert tail
     looped).

``--matches``/``--players`` shrink the history for a quick rehearsal on
the card (``--db-matches``, ``--worker-matches`` and ``--bench-matches``
the phases of their name). The last line is ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero without that line; so does a machine without
a visible CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_PLAYERS = 1_500_000
N_MATCHES = 10_000_000
SEED = 42
N_CHECK_WINDOWS = 8
PREFIX_STEPS = 128
# The phases that re-rate [main]'s history a second time — [stream], [tier]
# and both [cli] drills — run on this prefix of the stream (over the whole
# player table), held bit for bit against rate_history(kernel="fused") on
# the same prefix: the same checks at a tenth of the depth, which makes
# room for [db] and [worker].
CLI_PREFIX_MATCHES = 1_000_000
# [db]: the DB round trip at the reference's documented size (1M matches,
# 333,333 players, max_activity_share=1e-4, seed 42), the file built
# without participant_items rows, as the JAX package's ingest fixture is
# (the columnar lane never reads them).
DB_MATCHES = 1_000_000
DB_PLAYERS = 333_333
# [worker]: the service_bench fixture (n_players = matches // 3, with
# participant_items rows) in batches of 500 ids.
WORKER_MATCHES = 50_000
WORKER_BATCH = 500
# The consumer-loop splits must account for the loop's wall to this share.
SPLIT_TOL = 0.05
# The device profiler windows of the sequential [worker] run: this many
# batches from the middle of the run, one capture each.
WORKER_CAPTURES = 3
# [main]'s unprofiled wall, seconds, in the two runs PERF.md §5 records from
# before the profiler wrapped it (NVIDIA H100 80GB HBM3, 700.00 W).
MAIN_UNPROFILED_S = (52.283, 55.953)
# Runs the port's cli in a subprocess and reports, on stderr, the kernel
# launches and native-scanner counters of that process.
COUNTED_CLI = (
    "import json, sys\n"
    "from analyzer_tpu_torch import cli\n"
    "from analyzer_tpu_torch.kernels import fused_window as fw\n"
    "from analyzer_tpu_torch.obs import get_registry\n"
    "rc = cli.main(sys.argv[1:])\n"
    "c = get_registry().snapshot()['counters']\n"
    "print(json.dumps({'fused_window_launches': fw.launches,\n"
    "                  'native_scans': c['sql.native_scans_total'],\n"
    "                  'native_fallbacks': c['sql.native_fallbacks_total']}),\n"
    "      file=sys.stderr)\n"
    "sys.exit(rc)\n"
)
# The tiered re-rate's hot set (of 1.5M players), and the hot set of the
# thrashing run: larger than one superstep's rows, smaller than a chunk's.
TIER_HOT_ROWS = 262_144
THRASH_HOT_ROWS = 32_768

# Kernel vs plain on identical inputs: both run the same float32 operations
# in the same order (rate_match.cuh mirrors the plain version, no FMA
# contraction, IEEE sqrt/div); what may differ is the device math library's
# erff/erfcf/expf/logf against the ones inside torch's CUDA kernels. Error is
# |kernel - plain| / max(|plain|, 1).
KERNEL_RTOL = 2e-6
# The fused path (the kernel) against the reference path (plain PyTorch) over
# the whole history: per-step differences of KERNEL_RTOL size may compound
# through later matches of the same players.
PATH_RTOL = 1e-4

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations one match costs in rate_match.cuh at T=5 without
# collect, counting each erff/erfcf/logf/expf/sqrtf as one: quality ~73,
# each two-team update ~194 (sums 51, per-slot updates 100, v/w ~17, rest).
OPS_PER_MATCH = 460


# [bench]: cli bench's default workload (500,000 matches), a hot set of
# 32,768 rows, and one repeat a line after its warmup (two until [mesh]
# needed the time; [ingest] keeps two).
BENCH_MATCHES = 500_000
BENCH_HOT_ROWS = 32_768
BENCH_REPEATS = 1
INGEST_REPEATS = 2
# [oracle]: matches drawn from the first step of each of the first
# ORACLE_WINDOWS fused windows of a [bench]-sized schedule, held to the
# 50-digit oracle with tests/test_oracle.py's relative bounds.
ORACLE_WINDOWS = 16
ORACLE_SAMPLE = 256
ORACLE_BOUNDS = {"mu": 1e-5, "sigma": 1e-4, "quality": 1e-5}
# [models]: BASELINE.md's model-quality provenance streams (200,000 matches,
# 40,000 players, seed 7; with telemetry, and with --synergy 2.0), the
# card-vs-CPU stream, and the first matches of that stream for the
# features pass's graph-vs-eager check.
PROV_MATCHES = 200_000
PROV_PLAYERS = 40_000
CMP_MATCHES = 20_000
CMP_PLAYERS = 4_000
FEATURES_EAGER_MATCHES = 1_000
TELEMETRY_MIN_ACC = 0.95
# Card against CPU (tests/test_torch_models.py says why each has one):
# trained weights (the logistic head's 30 epochs of Adam, the MLP's first
# MLP_SHORT_EPOCHS), the MLP's 30-epoch losses as the JSON line rounds
# them, Elo ratings and predictions.
MODEL_ATOL = 1e-4
MLP_SHORT_EPOCHS = 5
LOSS_ATOL = 2e-4
ELO_ATOL, EXP_ATOL = 2e-3, 1e-5
# [worker]: the ledger-on and ledger-off sequential runs over these ids.
QUALITY_IDS = 10_000
# [planes]: the live obs planes on against every plane off, sequential over
# these ids of [worker]'s fixture, one query of each kind after every
# PLANES_QUERY_EVERY-th flush, and a client thread hitting the serve plane
# and these obsd routes every PLANES_CLIENT_S seconds while the planes run.
# The audit replays every served response through the pure-Python oracle,
# and a leaderboard, tier or percentile replay walks the whole table
# (~16,666 rows here), so the query rates are kept low.
PLANES_IDS = 10_000
PLANES_QUERY_EVERY = 4
PLANES_CLIENT_S = 1.0
OBSD_ROUTES = (
    "/healthz", "/readyz", "/metrics", "/statusz", "/historyz", "/sloz",
    "/qualityz", "/debug/snapshot", "/debug/flight?reason=chip-smoke",
)
# [cli]: the /metrics scrape of a rate run's obsd, 20 Hz.
SCRAPE_S = 0.05
# [mesh]: the sharded re-rate's logical shards on the card over the 1M
# prefix; the other widths, rate_stream(mesh=) and BENCH_MESH's bench line
# on the first MESH_SMALL_MATCHES matches; the NCCL world-size-1 cli run on
# the first MESH_NCCL_MATCHES; cli train --mesh 2 on BASELINE.md's
# card-vs-CPU stream size (20,000 matches / 4,000 players), its weights
# within MESH_TRAIN_ATOL of a single-device run (float32 reduction order,
# tests/test_torch_models.py).
MESH_SHARDS = 4
MESH_WIDTHS = (1, 2, 8)
MESH_SMALL_MATCHES = 100_000
MESH_NCCL_MATCHES = 20_000
MESH_TRAIN_MATCHES = 20_000
MESH_TRAIN_PLAYERS = 4_000
MESH_TRAIN_ATOL = 1e-5
# [migrate]: the zero-downtime re-rate of [ingest]'s 1M-prefix CSV over the
# whole player table; cli migrate against cli rate on its first
# MIGRATE_CLI_MATCHES matches; cli bench --migrate at its default 50,000
# matches with one repeat and a 200,000-match assign microbench (its
# defaults are 3 and 1M: depth cuts for time).
MIGRATE_CLI_MATCHES = 100_000
MIGRATE_BENCH_REPEATS = 1
MIGRATE_ASSIGN_MATCHES = 200_000
# [soak]: the rig soak's widths (docs/OPERATIONS.md, "Running and reading a
# soak"), queries over /v1/*, cut to SOAK_SECONDS virtual seconds and not
# realtime (a depth cut: a virtual second of run A at these widths took
# ~25-28 s of wall on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md); run B
# migrates SOAK_MIGRATE_MATCHES matches under the load.
SOAK_WIDTHS = dict(n_players=1_000_000, qps=2000.0, query_qps=500.0, batch_size=500)
SOAK_SECONDS = 1.0
SOAK_MIGRATE_MATCHES = 100_000


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    finite = ~np.isnan(want)
    if not finite.any():
        return 0.0
    g = got[finite].astype(np.float64)
    w = want[finite].astype(np.float64)
    return float((np.abs(g - w) / np.maximum(np.abs(w), 1.0)).max())


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return np.array_equal(a.cpu().numpy(), b.cpu().numpy(), equal_nan=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    fn()  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def oracle_window_samples(table, chunk, views, cfg, n_windows: int) -> list:
    """Runs the first ``n_windows`` windows of a chunk staged with collect
    through ``kernels.fused_window`` in order, in place on ``table`` (the
    CUDA kernel on a card's tensors, its plain version on the CPU's), and
    returns every real, non-AFK, supported-mode match of each window's
    first step as ``(pre-window working-set rows, its [2, T] slots,
    winner, mode_id, its packed output row)``."""
    from analyzer_tpu_torch.kernels.fused_window import fused_window

    out = []
    for win in chunk.windows[:n_windows]:
        slot_rows, slot_idx, winner, mode_id, afk = (views[i] for i in win[:5])
        rows = slot_rows.long()
        ws = table.index_select(0, rows)
        pre = ws.cpu().numpy().copy()  # a copy: ws is updated in place
        ws, ys = fused_window(ws, slot_idx, winner, mode_id, afk, cfg, True,
                              n_steps=win.n_steps)
        table.index_copy_(0, rows, ws)
        y0, s0 = ys[0].cpu().numpy(), slot_idx[0].cpu().numpy()
        w0, m0, a0 = (x[0].cpu().numpy() for x in (winner, mode_id, afk))
        for b in np.flatnonzero((y0[:, 2] > 0.5) & (a0 == 0) & (m0 >= 0)):
            out.append((pre, s0[b], int(w0[b]), int(m0[b]), y0[b]))
    return out


def oracle_errors(samples, cfg) -> dict:
    """Worst relative errors of the samples' posteriors against the port's
    50-digit oracle (``ops.oracle``): shared and per-mode mu and sigma, and
    the quality (which the reference computes from the mode priors). The
    priors are the pre-window rows, resolved as ``core.update`` does."""
    from analyzer_tpu_torch.core.state import COL_SEED_MU, COL_SEED_SIGMA, N_COLS
    from analyzer_tpu_torch.ops import oracle

    worst = {"mu": 0.0, "sigma": 0.0, "quality": 0.0}
    for pre, slots, winner, mode, y in samples:
        t = slots.shape[1]
        prior = {"sh": ([[], []], [[], []]), "q": ([[], []], [[], []])}
        where = [[], []]
        for ti in range(2):
            for si in range(t):
                if slots[ti, si] == 0:  # slot 0: the padding row
                    continue
                row = pre[slots[ti, si]].astype(np.float64)
                mu_sh, sg_sh = row[0], row[N_COLS]
                if np.isnan(mu_sh):
                    mu_sh, sg_sh = row[COL_SEED_MU], row[COL_SEED_SIGMA]
                mu_q, sg_q = row[mode + 1], row[N_COLS + mode + 1]
                if np.isnan(mu_q):
                    mu_q, sg_q = mu_sh, sg_sh
                for key, m, sg in (("sh", mu_sh, sg_sh), ("q", mu_q, sg_q)):
                    prior[key][0][ti].append(float(m))
                    prior[key][1][ti].append(float(sg))
                where[ti].append(si)
        blocks = {"sh": (0, 1), "q": (3, 4)}  # packed blocks of mu, sigma
        for key, (bm, bs) in blocks.items():
            om, os_ = oracle.two_team_update(*prior[key], winner, cfg.beta, cfg.tau)
            got_mu = y[3 + bm * 2 * t: 3 + (bm + 1) * 2 * t].reshape(2, t)
            got_sg = y[3 + bs * 2 * t: 3 + (bs + 1) * 2 * t].reshape(2, t)
            for ti in range(2):
                for j, si in enumerate(where[ti]):
                    o_mu, o_sg = float(om[ti][j]), float(os_[ti][j])
                    worst["mu"] = max(worst["mu"], abs(float(got_mu[ti, si]) - o_mu) / abs(o_mu))
                    worst["sigma"] = max(worst["sigma"], abs(float(got_sg[ti, si]) - o_sg) / abs(o_sg))
        oq = float(oracle.quality(*prior["q"], cfg.beta))
        worst["quality"] = max(worst["quality"], abs(float(y[0]) - oq) / max(oq, 1e-12))
    return worst


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def build_all(builds) -> None:
    """Runs every ``(name, load)`` at once, one thread each (nvcc and g++
    run in parallel), logs the seconds each took and re-raises a failure."""
    built: dict = {}

    def build(name, fn):
        t0 = time.perf_counter()
        try:
            built[name] = (fn(), time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            built[name] = (e, time.perf_counter() - t0)

    threads = [threading.Thread(target=build, args=b) for b in builds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (res, secs) in built.items():
        if isinstance(res, BaseException):
            raise res
        if res is None:
            raise RuntimeError(f"{name} did not load")
        log(f"[build] {name}: {secs:.2f} s")


def device_ms(fn, calls: int, kernels: int | None = None) -> float | None:
    """Device time per call of the CUDA kernels ``fn()`` launches, summed
    from a ``torch.profiler`` trace and divided by ``calls``; None where the
    trace holds no device events, holds other than ``kernels`` of them (a
    partial capture) or the profiler fails (the time is then not
    measured)."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA]
    except Exception as e:  # noqa: BLE001 — a diagnostic, reported as not measured
        log(f"[profiler] not measured: {type(e).__name__}: {e}")
        return None
    if kernels is not None and len(us) != kernels:
        log(f"[profiler] not measured: the trace holds {len(us)} device events "
            f"for {kernels} kernel launches")
        return None
    return sum(us) / calls / 1e3 if us else None


def host_ms(fn, reps: int) -> float:
    """Host time per call of ``fn()`` (no sync inside the loop), after one
    warm call; the stream is drained before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    out = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return out


def queued_ms(fn, reps: int) -> float | None:
    """Device time per call of ``fn()``, by CUDA events, with the host's
    launch gaps hidden: a sleep kernel holds the stream while the ``reps``
    calls queue up behind it, so the events time the device's work and its
    gaps between queued kernels alone. None where queueing outlasted the
    sleep (the device then waited on the host)."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(50_000_000)  # ~25 ms at 2 GHz
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    ev[2].record()
    ev[2].synchronize()
    if ev[0].elapsed_time(ev[1]) <= host_ms:
        log(f"[queued] not measured: queueing {reps} calls took {host_ms:.3f} ms, "
            f"the sleep {ev[0].elapsed_time(ev[1]):.3f} ms")
        return None
    return ev[1].elapsed_time(ev[2]) / reps


def scatter_phase(dev) -> dict:
    """Phase 3: the scatter-floor experiment through the row-scatter
    kernel (one launch per run), then, at each width, the multi-step kernel
    and the one-step kernel launched per step against index_copy_."""
    from analyzer_tpu_torch.experiments import scatter_floor as sf
    from analyzer_tpu_torch.kernels import row_scatter as rs

    rs.launches = 0
    sf.main([])
    launches = rs.launches
    runs = sum(1 + sf.REPEATS for name in sf.VARIANTS if name.startswith("cuda"))
    if launches != runs:
        raise AssertionError(
            f"the scatter-floor experiment launched row_scatter {launches} times "
            f"for {runs} runs of the kernel (one launch per run)")
    log(f"[scatter] experiment: row_scatter launches {launches}, one per run")
    out = {"launches": launches, "max_abs_err": 0.0}
    for w in (16, 128):
        steps = sf.STEPS[w]
        idx_np, rows_np = sf.make_xs(steps, w, np.random.default_rng(SEED))
        idx = torch.from_numpy(idx_np).to(dev)
        idx64 = idx.long()
        rows = torch.from_numpy(rows_np).to(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        table0 = torch.rand((sf.P, w), generator=gen, device=dev)
        want = rs.row_scatter_steps_plain(table0.clone(), idx, rows)
        errs = []
        for name, run in (("row_scatter_steps", sf.run_cuda),
                          ("row_scatter per step",
                           lambda t, i, r: sf.run_steps(sf.scatter_cuda, t, i, r))):
            got = run(table0.clone(), idx, rows)
            torch.cuda.synchronize()
            errs.append(float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{name} at W={w} differs from index_copy_ (max abs {errs[-1]})")
            del got
        out["max_abs_err"] = max(out["max_abs_err"], *errs)
        del want
        table = table0.clone()
        ms = cuda_ms(lambda: sf.run_cuda(table, idx, rows), 5) / steps
        step_ms = cuda_ms(
            lambda: sf.run_steps(sf.scatter_cuda, table, idx, rows), 5) / steps
        plain_ms = cuda_ms(
            lambda: rs.row_scatter_steps_plain(table, idx, rows), 5) / steps
        library_ms = cuda_ms(lambda: sf.run_torch(table, idx64, rows), 5) / steps
        # The same runs' device time alone, without the host's launch gaps.
        k_dev = device_ms(lambda: sf.run_cuda(table, idx, rows), steps, kernels=1)
        s_dev = device_ms(lambda: sf.run_steps(sf.scatter_cuda, table, idx, rows), steps,
                          kernels=steps)
        l_dev = device_ms(lambda: sf.run_torch(table, idx64, rows), steps)
        n_bytes = 2 * sf.R * w * 4 + sf.R * 4  # rows in, rows out, indices in
        bound_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
        key = "" if w == 16 else f"_w{w}"
        out.update({f"ms{key}": ms, f"plain_ms{key}": plain_ms,
                    f"library_ms{key}": library_ms, f"bound_ms{key}": bound_ms,
                    f"bound_by{key}": "bytes", f"device_ms{key}": k_dev,
                    f"step_launch_ms{key}": step_ms,
                    f"step_launch_device_ms{key}": s_dev,
                    f"library_device_ms{key}": l_dev})
        log(f"[scatter] W={w}: {steps} steps; row_scatter_steps (one launch) and "
            f"row_scatter (a launch per step) bit-identical to index_copy_ (max abs "
            f"err {max(errs):g}); per step: row_scatter_steps {ms:.5f} ms, row_scatter "
            f"per step {step_ms:.5f} ms, plain {plain_ms:.5f} ms, index_copy_ "
            f"{library_ms:.5f} ms, bound {bound_ms:.6f} ms (bytes, {n_bytes} B); "
            f"row_scatter_steps at {100 * bound_ms / ms:.1f}% of the bound; device "
            f"time per step (profiler): row_scatter_steps {k_dev} ms, row_scatter "
            f"per step {s_dev} ms, index_copy_ {l_dev} ms")
        del table, table0, rows, idx, idx64
    return out


def tier_counters() -> dict:
    """The six ``tier.*`` counters of the process-wide registry, as ints."""
    from analyzer_tpu_torch.obs import get_registry

    snap = get_registry().snapshot()["counters"]
    return {k.split(".")[1].removesuffix("_total"): int(v)
            for k, v in snap.items() if k.startswith("tier.")}


def conservative(host: np.ndarray, n: int):
    """(score, rated) of the first ``n`` rows, in the oracle's float32
    rounding order (``serve.oracle.conservative_score``), vectorised: numpy
    float32 array adds and subtracts are the same correctly rounded
    operations as its scalar ones."""
    mu, sg = host[:n, 0], host[:n, 7]
    return mu - ((sg + sg) + sg), ~np.isnan(mu)


def expected_leaders(host, n, k, id_of=str) -> list:
    """The oracle's leaderboard order (score descending, row ascending)
    over the whole table, vectorised, in the engine's response format."""
    score, rated = conservative(host, n)
    rows = np.flatnonzero(rated)
    order = rows[np.lexsort((rows, -score[rows].astype(np.float64)))][:k]
    return [{"rank": i + 1, "id": id_of(int(r)), "mu": float(host[r, 0]),
             "sigma": float(host[r, 7]), "conservative": float(score[r])}
            for i, r in enumerate(order)]


def expected_ratings(oracle, host, version, ids) -> dict:
    out = []
    for pid in ids:
        r = host[int(pid)]
        rated = not np.isnan(r[0])
        out.append({
            "id": pid, "rated": rated,
            "mu": float(r[0]) if rated else None,
            "sigma": float(r[7]) if rated else None,
            "conservative": (float(oracle.conservative_score(host, int(pid)))
                             if rated else None),
            "seed_mu": float(r[14]), "seed_sigma": float(r[15]),
        })
    return {"version": version, "ratings": out, "unknown": []}


def expected_winprob(oracle, host, version, a, b, beta2) -> dict:
    ra, rb = [int(x) for x in a], [int(x) for x in b]
    return {"version": version,
            "p_a": float(oracle.win_probability(host, ra, rb, beta2)),
            "quality": float(oracle.quality(host, ra, rb, beta2))}


def expected_percentile(host, n, version, value) -> dict:
    score, rated = conservative(host, n)
    below = int((score[rated] < np.float32(value)).sum())
    total = int(rated.sum())
    return {"version": version, "score": float(np.float32(value)),
            "below": below, "rated": total,
            "percentile": below / total if total else None}


def latency_line(kind: str, reqs: list, wall: float, occupancy) -> str:
    lat = np.array([r.latency_s for r in reqs]) * 1e3
    return (f"[serve] {kind}: {len(reqs)} requests, {len(reqs) / wall:,.0f} "
            f"requests/s over the burst's {wall:.3f} s, latency p50 "
            f"{np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} ms, "
            f"mean microbatch occupancy {occupancy}")


def serve_phase(cfg, pub, final_state, n_players) -> None:
    """Phase 8: the view the tiered run published last against a rebuild;
    a warmed QueryEngine on the card answering a burst from 8 threads,
    every response held to ``serve.oracle`` on the view's host table; then
    readers against a republishing writer."""
    from analyzer_tpu_torch.obs import get_registry, reset_registry
    from analyzer_tpu_torch.serve import QueryEngine, ViewPublisher, oracle

    view = pub.current()
    host = view.host_table()
    t0 = time.perf_counter()
    rebuilt = ViewPublisher().publish_state(final_state)
    t_rebuild = time.perf_counter() - t0
    same = np.array_equal(host, rebuilt.host_table(), equal_nan=True)
    log(f"[serve] the tiered run's last view (version {view.version}, patch "
        f"path, {view.table.shape[0]} rows on {view.table.device}) equals "
        f"ViewPublisher().publish_state(final_state) bit for bit: {same}; "
        f"a full publish of that table takes {t_rebuild:.3f} s")
    if not same or view.n_players != n_players:
        raise AssertionError("the published view differs from a rebuild")
    del rebuilt

    n, beta2 = view.n_players, cfg.beta2
    engine = QueryEngine(pub, cfg=cfg)  # device=None: the card
    t0 = time.perf_counter()
    engine.warmup(view)
    t_warm = time.perf_counter() - t0
    t_sort = cuda_ms(lambda: torch.sort(view.table[:, 0], descending=True, stable=True), 5)
    log(f"[serve] QueryEngine warmup {t_warm:.3f} s; one stable descending "
        f"sort of the {view.table.shape[0]}-row score column {t_sort:.3f} ms")
    rng = np.random.default_rng(SEED)
    score, rated = conservative(host, n)
    work = [("ratings", tuple(str(r) for r in rng.integers(0, n, 64)))
            for _ in range(256)]
    for _ in range(1024):
        rows = rng.choice(n, size=10, replace=False)
        work.append(("winprob", (tuple(str(r) for r in rows[:5]),
                                 tuple(str(r) for r in rows[5:]))))
    work += [("leaderboard", k) for k in (10, 100, 1000)]
    work += [("tiers", None)] * 8
    values = np.concatenate([rng.uniform(-2500, 2500, 224),
                             score[rated][rng.integers(0, int(rated.sum()), 32)]])
    work += [("percentile", float(v)) for v in values]
    order = rng.permutation(len(work))
    reset_registry()
    engine.start()
    done: list = [None] * 8

    def client(i):
        mine = [work[j] for j in order[i::8]]
        reqs = [engine.submit(kind, payload) for kind, payload in mine]
        for r in reqs:
            r.result(timeout=120)
        done[i] = reqs

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if any(d is None for d in done):
        raise AssertionError("a client thread of the serve burst failed")
    reqs = [r for d in done for r in d]
    by_kind: dict = {}
    for r in reqs:
        by_kind.setdefault(r.kind, []).append(r)
    reg = get_registry()
    for kind, rs in by_kind.items():
        occ = reg.histogram("serve.microbatch_occupancy", kind=kind).summary()["mean"]
        log(latency_line(kind, rs, wall, occ))
    # -- every response against the oracle on the view's host table --
    t0 = time.perf_counter()
    top = oracle.leaderboard(host, n, 1000)  # the pure-Python pass
    counts, n_rated = oracle.tier_histogram(host, n, engine.tier_edges)
    exact_pct = {float(v): oracle.percentile(host, n, v) for v in values[[0, 100, 230]]}
    checked = 0
    for r in reqs:
        got, v = r.value, view.version
        if r.kind == "ratings":
            want = expected_ratings(oracle, host, v, r.payload)
        elif r.kind == "winprob":
            want = expected_winprob(oracle, host, v, *r.payload, beta2)
        elif r.kind == "leaderboard":
            want = {"version": v, "leaders": [
                {"rank": i + 1, "id": str(row), "mu": float(host[row, 0]),
                 "sigma": float(host[row, 7]), "conservative": float(s)}
                for i, (row, s) in enumerate(top[:r.payload])]}
            if want["leaders"] != expected_leaders(host, n, r.payload):
                raise AssertionError("the vectorised leaderboard replay "
                                     "differs from serve.oracle.leaderboard")
        elif r.kind == "tiers":
            want = {"version": v, "edges": [float(e) for e in engine.tier_edges],
                    "counts": counts, "rated": n_rated}
        else:
            want = expected_percentile(host, n, v, r.payload)
            if r.payload in exact_pct and exact_pct[r.payload] != (
                    want["below"], want["rated"]):
                raise AssertionError("the vectorised percentile replay "
                                     "differs from serve.oracle.percentile")
        if got != want:
            raise AssertionError(f"{r.kind} {r.payload!r}: served {got}, oracle {want}")
        checked += 1
    # Ties that straddle the k-th place: 64 rows given the score of the
    # row ranked 8th, on a table of their own.
    tie = host.copy()
    tie[rng.choice(n, size=64, replace=False), :14] = host[top[7][0], :14]
    tie_pub = ViewPublisher()
    tie_pub.publish_state(tie)
    tie_engine = QueryEngine(tie_pub, cfg=cfg)
    for k in (8, 10, 40, 100):
        if tie_engine.leaderboard(k) != {
                "version": 1, "leaders": expected_leaders(tie, n, k)}:
            raise AssertionError(f"leaderboard k={k} breaks a tie class wrongly")
    del tie, tie_pub, tie_engine
    ties = int(n_rated - np.unique(score[rated]).size)
    log(f"[serve] {checked} responses equal serve.oracle on view.host_table() "
        f"bit for bit (ratings and winprob through its functions; the "
        f"leaderboard through oracle.leaderboard(k=1000) and the tier "
        f"histogram through oracle.tier_histogram, one pure-Python pass each; "
        f"{len(values)} percentiles through a vectorised float32 replay, "
        f"{len(exact_pct)} of them also through oracle.percentile); "
        f"{n_rated} rated rows, {ties} of them share a score with a lower "
        f"row; on a copy with 64 more rows tied at the 8th place, leaderboards "
        f"at k = 8, 10, 40, 100 order (score desc, row asc); checking took "
        f"{time.perf_counter() - t0:.1f} s")

    # -- readers against a republishing writer --
    views = {view.version: view}
    base = host.copy()
    stop = threading.Event()
    errors: list = []

    def writer():
        wrng = np.random.default_rng(SEED + 1)
        try:
            while not stop.is_set():
                idx = np.unique(wrng.integers(0, n, 4096))
                rows = base[idx]
                rows[:, 0] += np.float32(1.0)  # never-rated rows stay NaN
                base[idx] = rows
                v = pub.publish_state_patch(idx, rows, n, full_table=lambda: base)
                views[v.version] = v
                time.sleep(0.25)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    seen: list = [[] for _ in range(4)]

    def reader(i):
        rrng = np.random.default_rng(SEED + 10 + i)
        try:
            while not stop.is_set():
                rows = rrng.choice(n, size=10, replace=False)
                a, b = (tuple(str(r) for r in rows[:5]),
                        tuple(str(r) for r in rows[5:]))
                v = float(rrng.uniform(-2000, 2000))
                seen[i].append(("ratings", a, engine.get_ratings(a)))
                seen[i].append(("winprob", (a, b), engine.win_probability(a, b)))
                seen[i].append(("leaderboard", 10, engine.leaderboard(10)))
                seen[i].append(("percentile", v, engine.percentile(v)))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(3.0)
    stop.set()
    for t in threads:
        t.join()
    engine.close()
    if errors:
        raise errors[0]
    n_checked, versions = 0, set()
    leaders: dict = {}
    for mine in seen:
        vs = [resp["version"] for _k, _p, resp in mine]
        if vs != sorted(vs):
            raise AssertionError("a reader saw the view version go backwards")
        for kind, payload, resp in mine:
            v = resp["version"]
            h = views[v].host_table()
            versions.add(v)
            if kind == "ratings":
                want = expected_ratings(oracle, h, v, payload)
            elif kind == "winprob":
                want = expected_winprob(oracle, h, v, *payload, beta2)
            elif kind == "leaderboard":
                if v not in leaders:
                    leaders[v] = expected_leaders(h, n, 10)
                want = {"version": v, "leaders": leaders[v]}
            else:
                want = expected_percentile(h, n, v, payload)
            if resp != want:
                raise AssertionError(
                    f"under publish, {kind} at version {v}: served {resp}, oracle {want}")
            n_checked += 1
    log(f"[serve] writer republishing patches of ~4096 rows every 0.25 s for 3 s "
        f"(versions {view.version + 1}..{max(views)}), 4 readers: {n_checked} "
        f"responses over {len(versions)} versions, versions monotone per "
        f"reader, each equal to the oracle at its own version")
    if len(versions) < 2:
        raise AssertionError("the readers never saw a second version")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _cli_popen(*argv, env=None, stderr=subprocess.PIPE) -> subprocess.Popen:
    """``python -m analyzer_tpu_torch.cli ARGV`` started in the background
    from the checkout's root, ``env`` added to this process's."""
    return subprocess.Popen(
        [sys.executable, "-m", "analyzer_tpu_torch.cli", *argv],
        stdout=subprocess.PIPE, stderr=stderr, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, **(env or {})},
    )


def _finish(proc, tag: str, timeout: float = 300) -> tuple[str, str]:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{tag} did not finish in {timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"{tag} exited {proc.returncode}: {err[-3000:]}")
    return out, err


def _stats_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def expected_tiers(host, n, version, edges) -> dict:
    """``serve.oracle.tier_histogram``'s counts, vectorised (float32
    compares of the oracle's scores), in the engine's response format."""
    score, rated = conservative(host, n)
    ge = [int(((score >= np.float32(e)) & rated).sum()) for e in edges]
    total = int(rated.sum())
    counts = [total - ge[0]] + [ge[i] - ge[i + 1] for i in range(len(ge) - 1)]
    return {"version": version, "edges": [float(e) for e in edges],
            "counts": counts + [ge[-1]], "rated": total}


def mesh_serve_check(cfg, pub, final_state) -> None:
    """[mesh]'s serve half: the ShardedViewPublisher the D-shard run fed,
    a burst of every query kind from 8 threads through a started
    ShardedQueryEngine on the card, each response equal to a single-plane
    QueryEngine's on the same final table (version aside) and to
    ``serve.oracle`` on the sharded view's host table."""
    from analyzer_tpu_torch.obs import get_registry
    from analyzer_tpu_torch.serve import (
        QueryEngine, ShardedQueryEngine, ViewPublisher, oracle,
    )

    view = pub.current()
    host = view.host_table()
    n, beta2 = view.n_players, cfg.beta2
    single = ViewPublisher()
    single.publish_state(final_state)
    e1 = QueryEngine(single, cfg=cfg)
    eS = ShardedQueryEngine(pub, cfg=cfg)
    t0 = time.perf_counter()
    shapes = eS.warmup(view)
    e1.warmup()
    t_warm = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 7)
    score, rated = conservative(host, n)
    work = [("ratings", tuple(str(r) for r in rng.integers(0, n, 64)))
            for _ in range(64)]
    for _ in range(256):
        rows = rng.choice(n, size=10, replace=False)
        work.append(("winprob", (tuple(str(r) for r in rows[:5]),
                                 tuple(str(r) for r in rows[5:]))))
    work += [("leaderboard", k) for k in (10, 100, 1000)]
    work += [("tiers", None)] * 4
    values = np.concatenate([rng.uniform(-2500, 2500, 48),
                             score[rated][rng.integers(0, int(rated.sum()), 16)]])
    work += [("percentile", float(v)) for v in values]
    order = rng.permutation(len(work))
    eS.start()
    done: list = [None] * 8

    def client(i):
        mine = [work[j] for j in order[i::8]]
        reqs = [eS.submit(kind, payload) for kind, payload in mine]
        for r in reqs:
            r.result(timeout=120)
        done[i] = reqs

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    eS.close()
    if any(d is None for d in done):
        raise AssertionError("[mesh]: a client thread of the sharded burst failed")
    reqs = [r for d in done for r in d]
    # The vectorised tier replay against the oracle's loop on a slice.
    cut = 20_000
    small = expected_tiers(host, cut, 0, eS.tier_edges)
    if (small["counts"], small["rated"]) != oracle.tier_histogram(host, cut, eS.tier_edges):
        raise AssertionError("[mesh]: the vectorised tier replay differs from the oracle")
    for r in reqs:
        got, v = r.value, view.version
        single_resp = {**e1.query_now(r.kind, r.payload), "version": v}
        if r.kind == "ratings":
            want = expected_ratings(oracle, host, v, r.payload)
        elif r.kind == "winprob":
            want = expected_winprob(oracle, host, v, *r.payload, beta2)
        elif r.kind == "leaderboard":
            want = {"version": v, "leaders": expected_leaders(host, n, r.payload)}
        elif r.kind == "tiers":
            want = expected_tiers(host, n, v, eS.tier_edges)
        else:
            want = expected_percentile(host, n, v, r.payload)
        if got != single_resp or got != want:
            raise AssertionError(f"[mesh] sharded {r.kind} {r.payload!r}: served {got}, "
                                 f"single plane {single_resp}, oracle {want}")
    reg = get_registry().snapshot()["counters"]
    per_shard = {k: int(v) for k, v in reg.items()
                 if k.startswith("serve.shard.queries_total{")}
    log(f"[mesh] ShardedQueryEngine over the {view.n_shards}-shard view (version "
        f"{view.version}, {view.shards[0].table.shape[0]} local rows a shard on "
        f"{view.shards[0].table.device}; warmup {shapes} functions, {t_warm:.2f} s): "
        f"{len(reqs)} requests of every kind from 8 threads in {wall:.3f} s "
        f"({len(reqs) / wall:,.0f} requests/s), every response equal to the "
        f"single-plane QueryEngine's on the same final table and to serve.oracle "
        f"on the sharded host table; routed per-shard queries {per_shard}, "
        f"merges {int(reg['serve.shard.merges_total'])}")


def mesh_phase(dev, cfg, state0, stream, pre, pre_sched, a_pre, tmp) -> dict:
    """Phase [mesh]: the sharded re-rate (``parallel/``) on the card,
    ``MESH_SHARDS`` logical shards over the 1M prefix with the sharded serve
    plane wired in (bit for bit [prefix]'s table, one ``row_scatter`` launch
    a superstep), the other widths and ``rate_stream(mesh=)`` against the
    reference runner, the drop-mode kernel against its plain version at the
    run's shapes, an NCCL group of world size 1 under ``cli rate --mesh 0``,
    ``cli serve --shards``, ``cli train --mesh`` and the BENCH_MESH line.
    Returns the row scatter's numbers for the kernels line."""
    from analyzer_tpu_torch.io.checkpoint import load_checkpoint
    from analyzer_tpu_torch.io.csv_codec import save_stream_npz
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
    from analyzer_tpu_torch.kernels import row_scatter as rs
    from analyzer_tpu_torch.obs import get_registry, reset_registry, reset_tracer
    from analyzer_tpu_torch.parallel import make_mesh, rate_history_sharded
    from analyzer_tpu_torch.parallel.mesh import ShardedRun
    from analyzer_tpu_torch.sched import pack_schedule, rate_history, rate_stream
    from analyzer_tpu_torch.serve import ShardedViewPublisher

    t_phase = time.perf_counter()
    # The NCCL run and its single-device twin start first and run beside
    # the in-process work.
    small_path = os.path.join(tmp, "mesh_small.npz")
    save_stream_npz(small_path, pre.slice(0, MESH_NCCL_MATCHES))
    ck_mesh, ck_one = os.path.join(tmp, "mesh0.npz"), os.path.join(tmp, "one.npz")
    nccl = _cli_popen("rate", "--csv", small_path, "--checkpoint", ck_mesh,
                      "--mesh", "0", env={
                          "COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
                          "NUM_PROCESSES": "1", "PROCESS_ID": "0"})
    plain = _cli_popen("rate", "--csv", small_path, "--checkpoint", ck_one)
    # cli train --mesh 2 and cli train too: their features passes are the
    # phase's longest wait, and they move no number of the runs below.
    t_stream = synthetic_stream(MESH_TRAIN_MATCHES,
                                synthetic_players(MESH_TRAIN_PLAYERS, seed=7), seed=7)
    t_path = os.path.join(tmp, "train.npz")
    save_stream_npz(t_path, t_stream)
    w = [os.path.join(tmp, f"w{i}.npz") for i in range(2)]
    trains = [_cli_popen("train", "--csv", t_path, "--model", "logistic", "--out", w[i],
                         *extra) for i, extra in enumerate(((), ("--mesh", "2")))]

    # -- D shards over the 1M prefix, the sharded serve plane wired in --
    mesh = make_mesh(MESH_SHARDS)
    pub = ShardedViewPublisher(MESH_SHARDS)
    reset_registry()
    tracer = reset_tracer()
    counters0 = feed_counters()
    rs.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u0 = tracer_us(tracer)
    final = rate_history_sharded(state0, pre_sched, cfg, mesh=mesh, view_publisher=pub)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    u1 = tracer_us(tracer)
    launches = rs.launches
    same = np.array_equal(final.table.cpu().numpy(), a_pre, equal_nan=True)
    c = get_registry().snapshot()["counters"]
    log(f"[mesh] rate_history_sharded over {MESH_SHARDS} shards on {mesh.device}, the "
        f"first {pre.n_matches} matches / {state0.n_players} players: wall "
        f"{t_run:.3f} s, {pre_sched.n_steps} steps x B={pre_sched.batch_size} "
        f"({1e3 * t_run / pre_sched.n_steps:.3f} ms a superstep); row_scatter "
        f"launches {launches}; mesh.puts_total {int(c['mesh.puts_total'])}, "
        f"mesh.put_bytes_total {int(c['mesh.put_bytes_total'])}, "
        f"mesh.writebacks_avoidable_total {int(c['mesh.writebacks_avoidable_total'])}; "
        f"views published {pub.version}; table bit-identical to [prefix]'s: {same}")
    if launches != pre_sched.n_steps:
        raise AssertionError(f"[mesh]: {launches} row_scatter launches for "
                             f"{pre_sched.n_steps} supersteps")
    if not same:
        raise AssertionError("[mesh]: the sharded table differs from [prefix]'s")
    log(runner_split("[mesh]", tracer, u0, u1, counters0, hooks=("view.publish",)))
    mesh_serve_check(cfg, pub, final)
    del final, pub

    # -- the other widths and rate_stream(mesh=) on the first 100,000 --
    small = stream.slice(0, min(MESH_SMALL_MATCHES, stream.n_matches))
    s_sched = pack_schedule(small, pad_row=state0.pad_row, windowed=True)
    t0 = time.perf_counter()
    ref, _ = rate_history(state0, s_sched, cfg, kernel="reference")
    torch.cuda.synchronize()
    walls = [f"reference {time.perf_counter() - t0:.3f} s"]
    a_ref = ref.table.cpu().numpy()
    del ref
    for d in MESH_WIDTHS:
        rs.launches = 0
        t0 = time.perf_counter()
        st = rate_history_sharded(state0, s_sched, cfg, mesh=make_mesh(d))
        torch.cuda.synchronize()
        walls.append(f"D={d} {time.perf_counter() - t0:.3f} s")
        if not np.array_equal(st.table.cpu().numpy(), a_ref, equal_nan=True):
            raise AssertionError(f"[mesh]: D={d} differs from the reference runner")
        if rs.launches != s_sched.n_steps:
            raise AssertionError(f"[mesh]: D={d} launched row_scatter {rs.launches} "
                                 f"times for {s_sched.n_steps} steps")
        del st
    rs.launches = 0
    s_stats: dict = {}
    t0 = time.perf_counter()
    st, _ = rate_stream(state0, small, cfg, mesh=make_mesh(2), stats_out=s_stats)
    torch.cuda.synchronize()
    walls.append(f"rate_stream(mesh=2) {time.perf_counter() - t0:.3f} s "
                 f"({s_stats['n_steps']} steps x B={s_stats['batch_size']})")
    if not np.array_equal(st.table.cpu().numpy(), a_ref, equal_nan=True) \
            or rs.launches != s_stats["n_steps"]:
        raise AssertionError("[mesh]: rate_stream(mesh=2) differs from the reference runner")
    del st, a_ref
    log(f"[mesh] first {small.n_matches} matches ({s_sched.n_steps} steps x "
        f"B={s_sched.batch_size}): D = {', '.join(map(str, MESH_WIDTHS))} and "
        f"rate_stream(mesh=2) bit-identical to rate_history(kernel='reference'), "
        f"one row_scatter launch a superstep; walls {'; '.join(walls)}")

    # -- the kernel at the D-shard run's shapes, against its plain version --
    run = ShardedRun(state0, cfg, mesh)
    slab, _ = run.stage(*pre_sched.host_window(0, 16))
    _p, _w, _m, _a, _sel, target = slab.to_device(dev)
    idx = target[0].contiguous()
    r = idx.numel()
    rows = torch.rand((r, state0.table.shape[1]),
                      generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    block = run._block
    got = rs.row_scatter(block.clone(), idx, rows, check=True, mode="drop")
    want = rs.row_scatter_plain(block.clone(), idx, rows, mode="drop")
    torch.cuda.synchronize()
    # The block holds never-rated rows (NaN): compared bit for bit, NaN
    # pattern included.
    max_abs = float(np.nanmax(np.abs(got.cpu().numpy() - want.cpu().numpy())))
    if not same_bits(got, want):
        raise AssertionError(f"[mesh]: row_scatter(mode='drop') differs from its plain "
                             f"version (max abs {max_abs})")
    del got, want
    keep = (idx >= 0) & (idx < block.shape[0])
    n_kept = int(keep.sum())
    kept_idx, kept_rows = idx[keep].long(), rows[keep]
    table = block.clone()
    ms = cuda_ms(lambda: rs.row_scatter(table, idx, rows, mode="drop"), 50)
    plain_ms = cuda_ms(lambda: rs.row_scatter_plain(table, idx, rows, mode="drop"), 50)
    library_ms = cuda_ms(lambda: table.index_copy_(0, kept_idx, kept_rows), 50)
    k_dev = device_ms(lambda: [rs.row_scatter(table, idx, rows, mode="drop")
                               for _ in range(20)], 20, kernels=20)
    k_queued = queued_ms(lambda: rs.row_scatter(table, idx, rows, mode="drop"), 20)
    l_queued = queued_ms(lambda: table.index_copy_(0, kept_idx, kept_rows), 20)
    # Where a launch's host time goes: the whole wrapper, against the bare
    # ctypes launch with the same arguments (no checks, no stream lookup).
    lib, stream = rs.load(), torch.cuda.current_stream(dev).cuda_stream
    blocks = min(-(-r * (rows.shape[1] // 4) // rs.THREADS), rs.max_resident_blocks(dev))
    args = (table.data_ptr(), idx.data_ptr(), rows.data_ptr(), 1, r, rows.shape[1],
            blocks, dev.index or 0, stream, table.shape[0], 1)


    def bare_launch():
        if lib.row_scatter_launch(*args) != 0:
            raise RuntimeError("[mesh]: the bare row_scatter launch failed")

    wrapper_host_ms = host_ms(lambda: rs.row_scatter(table, idx, rows, mode="drop"), 200)
    launch_host_ms = host_ms(bare_launch, 200)
    n_bytes = 2 * n_kept * rows.shape[1] * 4 + r * 4
    bound_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    log(f"[mesh] row_scatter(mode='drop') at the {MESH_SHARDS}-shard step's shapes "
        f"(R = {mesh.n_local} shards x K {r // mesh.n_local} = {r} rows, {n_kept} kept, "
        f"into a [{block.shape[0]}, {block.shape[1]}] block): bit-identical to its "
        f"plain version (masked index_copy_); a launch back to back (events): "
        f"{ms:.5f} ms, plain {plain_ms:.5f} ms, index_copy_ of the kept rows "
        f"{library_ms:.5f} ms; device time a launch queued behind a sleep (events): "
        f"row_scatter {k_queued} ms, index_copy_ {l_queued} ms; profiler {k_dev} ms; "
        f"host time a call: the wrapper {wrapper_host_ms:.5f} ms, the bare cooperative "
        f"launch {launch_host_ms:.5f} ms; bound {bound_ms:.6f} ms (bytes, {n_bytes} B)")
    del table, block, run, slab, target, idx, rows

    # -- NCCL at world size 1: cli rate --mesh 0 against cli rate --
    out, err = _finish(nccl, "cli rate --mesh 0 (NCCL)")
    out1, _ = _finish(plain, "cli rate")
    got_s, want_s = _stats_line(out), _stats_line(out1)
    joined = [ln for ln in err.splitlines() if ln.startswith("rate --mesh: joined")]
    if not joined or "nccl" not in joined[-1]:
        raise AssertionError(f"[mesh]: cli rate --mesh 0 joined no NCCL group: {err[-2000:]}")
    a = load_checkpoint(ck_mesh, device="cpu").state.table.numpy()
    b = load_checkpoint(ck_one, device="cpu").state.table.numpy()
    same = np.array_equal(a, b, equal_nan=True)
    log(f"[mesh] cli rate --mesh 0 with COORDINATOR_ADDRESS / NUM_PROCESSES=1 / "
        f"PROCESS_ID=0 on the first {MESH_NCCL_MATCHES} matches: '{joined[-1]}'; "
        f"mesh_devices {got_s['mesh_devices']}, processes {got_s['processes']}, "
        f"rate phase {got_s['phases']['rate']} s (cli rate {want_s['phases']['rate']} s); "
        f"checkpoint bit-identical to cli rate's: {same}")
    if not same or (got_s["players_rated"], got_s["mean_mu"]) != (
            want_s["players_rated"], want_s["mean_mu"]):
        raise AssertionError("[mesh]: the NCCL cli rate --mesh 0 run differs from cli rate")

    # -- cli serve --shards 4 against --shards 1 on that checkpoint --
    import signal
    import urllib.request

    errs = [open(os.path.join(tmp, f"serve{i}.err"), "w") for i in range(2)]
    procs = [_cli_popen("serve", "--checkpoint", ck_mesh, "--port", "0",
                        "--max-seconds", "240", *extra, stderr=errs[i])
             for i, extra in enumerate((("--shards", str(MESH_SHARDS)), ()))]
    try:
        urls = []
        for proc in procs:
            line = ""
            while not line.startswith('{"serving"'):
                line = proc.stdout.readline()
                if not line:
                    raise AssertionError(f"[mesh]: cli serve exited {proc.wait()}")
            urls.append(json.loads(line)["serving"])
        paths = ("/v1/ratings?ids=0,1,2,17,999999999,x", "/v1/leaderboard?k=100",
                 "/v1/winprob?a=0,1,2&b=3,4", "/v1/tiers", "/v1/tiers?score=250.5")
        bodies = [[urllib.request.urlopen(u + q, timeout=30).read() for q in paths]
                  for u in urls]
        if bodies[0] != bodies[1]:
            raise AssertionError("[mesh]: cli serve --shards differs from --shards 1")
        log(f"[mesh] cli serve --shards {MESH_SHARDS} on that checkpoint: "
            f"{len(paths)} /v1/* bodies byte-equal to cli serve --shards 1's")
    finally:
        for proc, f in zip(procs, errs):
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()
            proc.stderr is None or proc.stderr.close()
            f.close()
    j1, j2 = (_stats_line(_finish(t, "cli train")[0]) for t in trains)
    with np.load(w[0]) as f1, np.load(w[1]) as f2:
        diff = max(float(np.abs(f1[k] - f2[k]).max()) for k in ("w", "b"))
    log(f"[mesh] cli train --mesh 2 against cli train on {MESH_TRAIN_MATCHES} matches "
        f"(subprocesses): weights max abs difference {diff:.3e} (tol "
        f"{MESH_TRAIN_ATOL:g}), train_nll {j2['train_nll']} / {j1['train_nll']}, "
        f"phases {j2['phases']} / {j1['phases']}")
    if diff > MESH_TRAIN_ATOL:
        raise AssertionError(f"[mesh]: train --mesh 2 weights differ by {diff}")

    # -- one BENCH_MESH line --
    proc = _cli_popen("bench", env={"BENCH_MESH": "2", "BENCH_MATCHES": str(MESH_SMALL_MATCHES),
                                    "BENCH_REPEATS": "1"})
    out, _err = _finish(proc, "cli bench (BENCH_MESH=2)", timeout=600)
    line = _stats_line(out)
    log(f"[mesh] BENCH_MESH=2 BENCH_MATCHES={MESH_SMALL_MATCHES} bench line: "
        f"{json.dumps(line)}")
    log(f"[mesh] phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
            "device_ms": k_dev, "queued_ms": k_queued, "library_queued_ms": l_queued,
            "wrapper_host_ms": wrapper_host_ms, "launch_host_ms": launch_host_ms,
            "rows": r, "rows_kept": n_kept,
            "ms_per_superstep": 1e3 * t_run / pre_sched.n_steps}


def http_phase(cli, dev, cfg, ck_path: str) -> None:
    """Phase 10: ``cli serve`` on the card as a subprocess over a checkpoint
    that ``cli rate`` wrote, queried through ``cli query``; every body must
    equal the in-process engine's answer on the same table."""
    import signal

    from analyzer_tpu_torch.io.checkpoint import load_checkpoint
    from analyzer_tpu_torch.serve import QueryEngine, ViewPublisher

    pub = ViewPublisher()
    pub.publish_state(load_checkpoint(ck_path, device=dev).state)
    engine = QueryEngine(pub, cfg=cfg)  # inline: one microbatch per call
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "analyzer_tpu_torch.cli", "serve", "--checkpoint",
         ck_path, "--port", "0", "--max-seconds", "240"],
        stdout=subprocess.PIPE, text=True,
    )
    try:
        line = ""
        while not line.startswith('{"serving"'):
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"cli serve exited {proc.wait()} before serving")
        info = json.loads(line)
        t_up = time.perf_counter() - t0
        url = info["serving"]

        def query(*argv):
            buf = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["query", *argv, "--url", url])
            if rc != 0:
                raise AssertionError(f"cli query {' '.join(argv)} exited {rc}")
            return json.loads(buf.getvalue()), (time.perf_counter() - t1) * 1e3

        lb = engine.leaderboard(5)
        top = [e["id"] for e in lb["leaders"]]
        ids = top + ["0", "1", "no-such-player"]
        cases = [
            (("ratings", "--ids", ",".join(ids)), engine.get_ratings(ids)),
            (("leaderboard", "--k", "100"), engine.leaderboard(100)),
            (("winprob", "--a", ",".join(top[:3]), "--b", ",".join(top[3:] + ["0"])),
             engine.win_probability(top[:3], top[3:] + ["0"])),
            (("tiers",), engine.tier_histogram()),
        ]
        pct = engine.percentile(250.0)
        cases.append((("tiers", "--score", "250.0"),
                      {**engine.tier_histogram(), "percentile": pct["percentile"],
                       "score": pct["score"], "below": pct["below"]}))
        times = []
        for argv, want in cases:
            got, ms = query(*argv)
            times.append(f"{argv[0]} {ms:.1f}")
            if got != want:
                raise AssertionError(f"cli query {argv}: {got} != in-process {want}")
        log(f"[serve-http] cli serve --checkpoint (players {info['players']}, "
            f"version {info['version']}) serving on the card {t_up:.2f} s after "
            f"start; {len(cases)} cli query bodies equal the in-process "
            f"engine's on the same table; ms per query over HTTP: "
            f"{', '.join(times)}")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        proc.stdout.close()
    if rc != 0:
        raise AssertionError(f"cli serve exited {rc} after an interrupt")


def rater_phase(dev, cfg) -> None:
    """Phase 11: one 3v3 of fresh tier-15 players through the object API
    on the card, against the tensor path on the same match."""
    from types import SimpleNamespace as NS

    from analyzer_tpu_torch.core.constants import RATING_COLUMNS
    from analyzer_tpu_torch.core.state import MatchBatch, PlayerState
    from analyzer_tpu_torch.core.update import rate_and_apply
    from analyzer_tpu_torch.rater import rate_match

    def participant():
        cols = {f"{c}_{k}": None for c in RATING_COLUMNS for k in ("mu", "sigma")}
        player = NS(rank_points_ranked=None, rank_points_blitz=None,
                    skill_tier=15, **cols)
        return NS(player=[player], participant_items=[NS()], went_afk=0)

    rosters = [NS(winner=w, participants=[participant() for _ in range(3)])
               for w in (True, False)]
    match = NS(api_id="smoke-3v3", game_mode="ranked", rosters=rosters,
               participants=[p for r in rosters for p in r.participants])
    rate_match(match, cfg)  # device=None: the card
    mu = match.rosters[0].participants[0].player[0].trueskill_mu
    state = PlayerState.create(6, skill_tier=np.full(6, 15), cfg=cfg, device=dev)
    pidx = torch.full((1, 2, 5), 6, dtype=torch.int64, device=dev)
    pidx[0, 0, :3] = torch.arange(0, 3, device=dev)
    pidx[0, 1, :3] = torch.arange(3, 6, device=dev)
    batch = MatchBatch(
        player_idx=pidx, slot_mask=pidx != 6,
        winner=torch.zeros(1, dtype=torch.int64, device=dev),
        mode_id=torch.ones(1, dtype=torch.int64, device=dev),  # "ranked"
        afk=torch.zeros(1, dtype=torch.bool, device=dev),
    )
    after, _ = rate_and_apply(state, batch, cfg)
    want = float(after.table[0, 0])
    log(f"[rater] rate_match on the card, 3v3 of fresh tier-15 players: winner "
        f"shared mu {mu:.4f}, quality {match.trueskill_quality:.6f}; "
        f"rate_and_apply on the same match: {want:.4f}; equal: {mu == want}")
    if round(mu, 2) != 2052.41 or mu != want:
        raise AssertionError(f"rate_match gave {mu}, rate_and_apply {want}, want 2052.41")


def counted_cli(*argv, timeout=900, env=None) -> tuple[dict, dict, float]:
    """``cli <argv>`` of the port in a subprocess (:data:`COUNTED_CLI`),
    with ``env`` added to this process's environment: its stats line, its
    kernel-launch and native-scanner counts, and its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", COUNTED_CLI, *argv],
        capture_output=True, text=True, timeout=timeout,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, **(env or {})},
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    counts = [ln for ln in proc.stderr.splitlines()
              if ln.startswith('{"fused_window_launches"')]
    return json.loads(proc.stdout.strip().splitlines()[-1]), json.loads(counts[-1]), wall


def player_rows(path: str) -> list:
    """Every player row of a database, in insertion order."""
    import sqlite3

    conn = sqlite3.connect(path)
    try:
        return conn.execute('SELECT * FROM "player" ORDER BY rowid').fetchall()
    finally:
        conn.close()


def db_phase(cli, tmp: str, dev, n_matches: int = DB_MATCHES) -> dict:
    """Phase [db]: the reference's DB round trip at its documented size —
    ``io.dbgen`` writes the history, ``cli rate --db --db-write`` re-rates
    it on the card through the fused kernel (a subprocess, its launches and
    native scans counted there) and, on a copy, through the reference
    kernel: the player rows must be equal bit for bit; then ``cli serve
    --db`` serves the written file and ``cli query`` bodies must equal the
    database rows exactly."""
    import signal

    from analyzer_tpu_torch.io.dbgen import write_history_db
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream

    fused_db = os.path.join(tmp, "history.db")
    ref_db = os.path.join(tmp, "history_ref.db")
    t0 = time.perf_counter()
    n_players = DB_PLAYERS if n_matches == DB_MATCHES else n_matches // 3
    players = synthetic_players(n_players, seed=SEED)
    stream = synthetic_stream(n_matches, players, seed=SEED, max_activity_share=1e-4)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_history_db(fused_db, stream, players, items=False)
    t_db = time.perf_counter() - t0
    shutil.copy(fused_db, ref_db)
    log(f"[db] {n_matches} matches / {n_players} players (max_activity_share "
        f"1e-4, seed {SEED}): stream {t_gen:.2f} s, io.dbgen write (no "
        f"participant_items rows) {t_db:.2f} s, {os.path.getsize(fused_db):,} bytes")
    del stream, players

    out = {}
    for kernel, path in (("fused", fused_db), ("reference", ref_db)):
        stats, counts, wall = counted_cli(
            "rate", "--db", f"sqlite:///{path}", "--db-write", "--kernel", kernel,
            "--device", dev.type)
        out[kernel] = (stats, counts)
        ph = stats["phases"]
        log(f"[db] cli rate --db --db-write --kernel {kernel} (subprocess, "
            f"{wall:.2f} s): load {ph['load']} s, rate {ph['rate']} s, db_write "
            f"{ph['db_write']} s; {stats['matches']} matches, players_rated "
            f"{stats['players_rated']}, players_written {stats['players_written']}, "
            f"mean_mu {stats['mean_mu']}, supersteps {stats['supersteps']}; "
            f"fused_window launches {counts['fused_window_launches']}; native "
            f"scans {counts['native_scans']}, fallbacks {counts['native_fallbacks']}")
        if counts["native_scans"] == 0 or counts["native_fallbacks"] != 0:
            raise AssertionError(f"the native sqlite scanner did not serve the "
                                 f"{kernel} run's load: {counts}")
    launches = out["fused"][1]["fused_window_launches"]
    # (A CPU rehearsal of this phase launches no kernel: its fused path is
    # the plain version.)
    if (launches == 0) == (dev.type == "cuda") or (
            out["reference"][1]["fused_window_launches"] != 0):
        raise AssertionError(f"fused_window launches: fused run {launches}, "
                             f"reference run {out['reference'][1]}")
    rows_f, rows_r = player_rows(fused_db), player_rows(ref_db)
    same = rows_f == rows_r
    written = sum(1 for r in rows_f if r[4] is not None)
    log(f"[db] player rows of the fused and reference files: {len(rows_f)} rows, "
        f"{written} with ratings; equal bit for bit: {same}")
    if not same or written != out["fused"][0]["players_written"]:
        raise AssertionError("fused and reference DB write-backs differ")

    # serve the written file
    by_id = {r[0]: r for r in rows_f}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "analyzer_tpu_torch.cli", "serve", "--db",
         f"sqlite:///{fused_db}", "--port", "0", "--max-seconds", "300",
         "--device", dev.type],
        stdout=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    try:
        line = ""
        while not line.startswith('{"serving"'):
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"cli serve --db exited {proc.wait()} before serving")
        info = json.loads(line)
        t_up = time.perf_counter() - t0

        def query(*argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["query", *argv, "--url", info["serving"]])
            if rc != 0:
                raise AssertionError(f"cli query {' '.join(argv)} exited {rc}")
            return json.loads(buf.getvalue())

        rated_ids = [r[0] for r in rows_f if r[4] is not None]
        rng = np.random.default_rng(SEED)
        ids = [rated_ids[i] for i in rng.choice(len(rated_ids), 64, replace=False)]
        got = query("ratings", "--ids", ",".join(ids))
        for e in got["ratings"]:
            row = by_id[e["id"]]
            if not e["rated"] or e["mu"] != float(np.float32(row[4])) or (
                    e["sigma"] != float(np.float32(row[5]))):
                raise AssertionError(f"served {e} != DB row {row[:6]}")
        if got["unknown"] or len(got["ratings"]) != 64:
            raise AssertionError(f"served ratings: {got}")
        # The leaderboard over the DB rows, in the oracle's order.
        host = np.full((len(rows_f) + 1, 16), np.nan, np.float32)
        for i, r in enumerate(rows_f):
            if r[4] is not None:
                host[i, 0], host[i, 7] = r[4], r[5]
        want = expected_leaders(host, len(rows_f), 10, id_of=lambda i: rows_f[i][0])
        lb = query("leaderboard", "--k", "10")
        if lb["leaders"] != want:
            raise AssertionError(f"served leaderboard {lb['leaders']} != {want}")
        log(f"[db] cli serve --db on the written file (players {info['players']}, "
            f"version {info['version']}) up {t_up:.2f} s after start; cli query "
            f"ratings of 64 rated ids and leaderboard --k 10 equal the DB rows "
            f"exactly (served mu/sigma = the rows' f32)")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        proc.stdout.close()
    if rc != 0:
        raise AssertionError(f"cli serve --db exited {rc} after an interrupt")
    for path in (fused_db, ref_db):
        os.unlink(path)
    return {"launches_db": launches}


def batch_split(names) -> str:
    """Mean ms per batch of each named worker / pipeline span since the last
    tracer reset (the runner's own chunk spans, category ``sched``, are left
    out)."""
    from analyzer_tpu_torch.obs import get_tracer

    evs = [e for e in get_tracer().events()
           if e.get("ph") == "X" and e.get("cat") in ("worker", "pipeline")]
    parts = []
    for name in names:
        d = [e["dur"] for e in evs if e["name"] == name]
        if d:
            parts.append(f"{name} {np.mean(d) / 1e3:.2f} ms x{len(d)}")
    return ", ".join(parts)


def tracer_us(tracer) -> float:
    """Now, on ``tracer``'s clock (the microseconds its spans carry)."""
    return (time.perf_counter() - tracer.epoch_perf) * 1e6


def spans_on(events, tid, names, t0: float, t1: float) -> list:
    """The complete spans named in ``names`` (a set of names, or of (name,
    cat) pairs) that thread ``tid`` emitted inside [t0, t1]."""
    return [e for e in events
            if e.get("ph") == "X" and e["tid"] == tid and t0 <= e["ts"] <= t1
            and (e["name"] in names or (e["name"], e["cat"]) in names)]


def busy_s(spans) -> float:
    return sum(e["dur"] for e in spans) / 1e6


def gap_s(spans, t0: float, t1: float) -> tuple[float, float]:
    """(seconds of [t0, t1] before and between ``spans``, seconds after the
    last): the time the thread spent outside them."""
    gap, cursor = 0.0, t0
    for e in sorted(spans, key=lambda e: e["ts"]):
        gap += max(0.0, e["ts"] - cursor)
        cursor = max(cursor, e["ts"] + e["dur"])
    return gap / 1e6, (t1 - cursor) / 1e6


def check_sum(tag: str, parts: dict, wall: float) -> float:
    """Fails unless the parts account for ``wall`` to within 5%; returns
    their share of it."""
    share = sum(parts.values()) / wall
    if abs(1.0 - share) > SPLIT_TOL:
        raise AssertionError(
            f"{tag}: the split's parts sum to {share:.3f} of the wall "
            f"(tolerance {SPLIT_TOL}): {parts}")
    return share


def runner_split(tag: str, tracer, t0: float, t1: float, counters0: dict,
                 hooks: tuple = ()) -> str:
    """One line splitting a runner's consumer loop — the ``rate_history`` /
    ``rate_stream`` call between tracer times ``t0`` and ``t1``, on this
    thread — into feed wait (the gaps between its spans: waiting on the
    feed for a staged chunk), dispatch (``batch.compute`` and the
    consumer's ``feed.transfer``, the slab's copy to the card), fetch
    (``batch.fetch``) and hooks (the spans named in ``hooks``: a view
    publish; none on most runs this is called for). Fails unless they
    account for the wall within ``SPLIT_TOL``. Adds the producer thread's
    staging totals and the feed's counters over the run."""
    from analyzer_tpu_torch.obs import get_registry

    me = threading.get_ident() % 1_000_000
    evs = tracer.events()
    transfer = spans_on(evs, me, {"feed.transfer"}, t0, t1)
    compute = spans_on(evs, me, {"batch.compute"}, t0, t1)
    fetch = spans_on(evs, me, {"batch.fetch"}, t0, t1)
    hook = spans_on(evs, me, set(hooks), t0, t1)
    wait, tail = gap_s(transfer + compute + fetch + hook, t0, t1)
    wall = (t1 - t0) / 1e6
    parts = {"feed wait": wait, "dispatch": busy_s(transfer + compute),
             "fetch": busy_s(fetch), "hooks": busy_s(hook)}
    share = check_sum(tag, parts, wall)
    producer = [e for e in evs if e.get("ph") == "X" and e["tid"] != me
                and t0 <= e["ts"] <= t1]
    c = get_registry().snapshot()["counters"]
    starved = int(c["feed.starved_total"] - counters0["feed.starved_total"])
    backpressure = int(c["feed.backpressure_total"]
                       - counters0["feed.backpressure_total"])
    return (
        f"{tag} consumer loop split (wall {wall:.3f} s, {len(compute)} chunks): "
        f"feed wait {wait:.3f} s (feed.starved_total {starved}), dispatch "
        f"{parts['dispatch']:.3f} s (batch.compute {busy_s(compute):.3f}, "
        f"feed.transfer on the consumer {busy_s(transfer):.3f}), fetch "
        f"{parts['fetch']:.3f} s, hooks {parts['hooks']:.3f} s"
        f"{' (' + ', '.join(hooks) + f', {len(hook)} spans)' if hooks else ' (none on this run)'}; parts = "
        f"{100 * share:.2f}% of the wall (after the last span {tail:.3f} s); "
        f"producer thread: feed.materialize "
        f"{busy_s([e for e in producer if e['name'] == 'feed.materialize']):.3f} s, "
        f"feed.transfer "
        f"{busy_s([e for e in producer if e['name'] == 'feed.transfer']):.3f} s; "
        f"feed.backpressure_total {backpressure}")


def feed_counters() -> dict:
    from analyzer_tpu_torch.obs import get_registry

    c = get_registry().snapshot()["counters"]
    return {k: c[k] for k in ("feed.starved_total", "feed.backpressure_total")}


def attribution(tag: str, capture: str) -> dict:
    """``obs.profview.analyze_capture`` over a capture directory, printed:
    device-busy seconds, idle share, lanes, top kernels. Fails where the
    capture parsed nothing or found no device lane."""
    from analyzer_tpu_torch.obs.profview import analyze_capture

    att = analyze_capture(capture, update_metrics=False)
    if not att["parsed"] or not att["device"]["lanes"]:
        raise AssertionError(
            f"{tag}: the capture in {capture} parsed {att['parsed']}, device "
            f"lanes {(att['device'] or {}).get('lanes')}: {att['error']}")
    dev = att["device"]
    top = "; ".join(f"{k['name'][:48]} {k['total_us'] / 1e3:.3f} ms x{k['count']}"
                    for k in att["kernels"][:5])
    log(f"{tag} profiler attribution ({len(att['trace_files'])} trace file(s)): "
        f"device busy {dev['busy_us'] / 1e6:.4f} s of a "
        f"{dev['window_us'] / 1e6:.4f} s device window, idle share "
        f"{dev['idle_frac']:.4f}, {dev['lanes']} device lane(s), compile "
        f"{att['compile']['compile_us']} us; top kernels: {top}")
    return att


def fused_row(att: dict) -> dict | None:
    """The attribution's ``fused_window`` entry, or None."""
    rows = [k for k in att["kernels"] if "fused_window" in k["name"]]
    return rows[0] if rows else None


def worker_split(mode: str, tracer, got: dict) -> str:
    """One line splitting the worker's consume loop (first poll to last,
    this thread) into feed wait (the gaps between its batches: polling the
    broker), encode, pack, dispatch (sequential: the batch's rate_history
    less its fetches; pipelined: chain patch and dispatch), fetch
    (sequential: the runner's ``batch.fetch``) and hooks (commit, view
    publish, acks — and, pipelined, waiting on the writer). Fails unless
    they account for the loop's wall within ``SPLIT_TOL``. Adds the writer
    thread's totals (pipelined) and the drain after the last poll."""
    me = threading.get_ident() % 1_000_000
    u0, u1 = ((got[k] - tracer.epoch_perf) * 1e6 for k in ("polls_from", "polls_to"))
    drain_s = got["seconds"] - (got["polls_to"] - got["polls_from"])
    evs = tracer.events()

    def on_me(*names):
        return busy_s(spans_on(evs, me, set(names), u0, u1))

    life = spans_on(evs, me, {"batch.lifecycle"}, u0, u1)
    wait, _tail = gap_s(life, u0, u1)
    encode, pack = on_me("batch.encode"), on_me("batch.pack")
    fetch = on_me(("batch.fetch", "sched"))
    if mode == "sequential":
        dispatch = on_me(("batch.compute", "worker")) - fetch
        commit = on_me(("batch.commit", "worker"))
    else:
        dispatch = on_me("batch.chain", "batch.dispatch")
        commit = 0.0
    hooks = busy_s(life) - encode - pack - dispatch - fetch
    wall = (u1 - u0) / 1e6
    parts = {"feed wait": wait, "encode": encode, "pack": pack,
             "dispatch": dispatch, "fetch": fetch, "hooks": hooks}
    share = check_sum(f"[worker] {mode}", parts, wall)
    writer = [e for e in evs if e.get("ph") == "X" and e["tid"] != me
              and e["cat"] == "pipeline" and u0 <= e["ts"] <= u1 + drain_s * 1e6]
    writer_part = ", ".join(
        f"{name} {busy_s([e for e in writer if e['name'] == name]):.3f} s"
        for name in ("batch.fetch", "batch.write_back", "batch.commit"))
    n = len(life)
    return (
        f"[worker] {mode} consumer loop split (wall {wall:.3f} s, {n} batches; "
        f"per batch in ms): feed wait {1e3 * wait / n:.2f} (broker polls), "
        f"encode {1e3 * encode / n:.2f}, pack {1e3 * pack / n:.2f}, dispatch "
        f"{1e3 * dispatch / n:.2f}, fetch {1e3 * fetch / n:.2f}, hooks "
        f"{1e3 * hooks / n:.2f} (commit {1e3 * commit / n:.2f} on this thread); "
        f"parts = {100 * share:.2f}% of the wall; drain after the last poll "
        f"{drain_s:.3f} s"
        + (f"; writer thread: {writer_part}" if mode != "sequential" else ""))


def worker_captures(tracer, prof_dir: str, export: str) -> dict:
    """The sequential run's device-profiler windows: one attribution line
    (busy and idle per captured batch, beside that batch's
    ``batch.compute``), then ``cli trace`` on the run's span export and
    ``cli profile --trace-events`` joining the first capture to it, both
    in subprocesses with exit 0."""
    from analyzer_tpu_torch.obs.profview import analyze_capture

    caps = sorted(os.path.join(prof_dir, d) for d in os.listdir(prof_dir)
                  if d.startswith("profile-") and "bench" in d)
    if len(caps) != WORKER_CAPTURES:
        raise AssertionError(f"[worker] {len(caps)} profiler windows, expected "
                             f"{WORKER_CAPTURES}: {caps}")
    compute = {e["args"].get("trace"): e["dur"] / 1e3 for e in tracer.events()
               if (e["name"], e["cat"]) == ("batch.compute", "worker")}
    rows = []
    for cap in caps:
        att = analyze_capture(cap, update_metrics=False)
        if not att["parsed"] or not att["device"]["lanes"]:
            raise AssertionError(f"[worker] capture {cap}: parsed {att['parsed']}, "
                                 f"no device lane: {att['error']}")
        batch = att["manifest"]["batches"][0]
        rows.append((batch, att, compute.get(batch)))
    first = rows[0][1]
    top = "; ".join(f"{k['name'][:40]} {k['total_us'] / 1e3:.3f} ms x{k['count']}"
                    for k in first["kernels"][:5])
    per = ", ".join(
        f"{b}: busy {a['device']['busy_us'] / 1e3:.3f} ms, idle share "
        f"{a['device']['idle_frac']:.4f}, batch.compute {c:.2f} ms"
        for b, a, c in rows)
    log(f"[worker] sequential, {len(rows)} device profiler windows (Worker("
        f"profile_dir=), one batch each): {per}; top kernels of {rows[0][0]}: {top}")
    tr = cli_sub("trace", export, "--json")
    if tr.returncode != 0:
        raise AssertionError(f"cli trace on the worker export exited "
                             f"{tr.returncode}: {tr.stderr}")
    cp = json.loads(tr.stdout)
    pr = cli_sub("profile", caps[0], "--trace-events", export, "--json")
    if pr.returncode != 0:
        raise AssertionError(f"cli profile --trace-events exited {pr.returncode}: "
                             f"{pr.stderr}")
    d = json.loads(pr.stdout).get("dispatch_decomposition")
    if d is None or d["scope"] != "manifest":
        raise AssertionError(f"cli profile: the capture did not join the worker "
                             f"trace: {d}")
    shares = " / ".join(f"{k} {v:.4f}" for k, v in (d.get("shares") or {}).items())
    log(f"[worker] cli trace exit 0: {cp['batches']} batches, dominant stage "
        f"{cp['dominant_stage']}, stage shares "
        + ", ".join(f"{k} {v:.3f}" for k, v in cp["stage_share"].items() if v)
        + f"; cli profile --trace-events exit 0: dispatch of {d['batches']} "
        f"{d['dispatch_ms']:.3f} ms = device execute {d['device_execute_ms']:.3f} + "
        f"device idle {d['device_idle_ms']:.3f} + host {d['host_overhead_ms']:.3f} ms "
        f"({shares})")
    return {"busy_ms": [a["device"]["busy_us"] / 1e3 for _, a, _ in rows]}


def worker_phase(cli, tmp: str, dev, n_matches: int = WORKER_MATCHES) -> dict:
    """Phase [worker]: the reference's consume loop — ``Worker`` over
    ``InMemoryBroker`` + ``SqlStore`` in 500-id batches on the card,
    sequential and pipelined (auto lag from ``warmup()``, serving over
    HTTP), against ``cli rate --db --db-write --kernel fused`` on a copy of
    the same file; then one poisoned match under the pipelined loop."""
    import shutil as _sh
    import sqlite3
    import urllib.request

    from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
    from analyzer_tpu_torch.experiments.service_bench import build_db, match_ids, run_loop
    from analyzer_tpu_torch.kernels import fused_window as fw
    from analyzer_tpu_torch.obs import get_registry, reset_tracer, tracectx, write_chrome_trace
    from analyzer_tpu_torch.obs.profview import analyze_capture
    from analyzer_tpu_torch.service import InMemoryBroker, SqlStore, Worker

    n_players = n_matches // 3
    pristine = os.path.join(tmp, "service.db")
    t0 = time.perf_counter()
    build_db(pristine, n_matches, n_players, SEED, items=True)
    t_build = time.perf_counter() - t0
    copies = {k: os.path.join(tmp, f"service_{k}.db")
              for k in ("sequential", "pipelined", "cli", "poison", "quality_on",
                        "quality_off", "planes_on", "planes_off")}
    for path in copies.values():
        _sh.copy(pristine, path)
    ids = match_ids(pristine)
    log(f"[worker] fixture: {n_matches} matches / {n_players} players with "
        f"participant_items rows, {t_build:.2f} s; {len(copies)} copies")

    def dump(path):
        conn = sqlite3.connect(path)
        try:
            return [conn.execute(f'SELECT * FROM "{t}" ORDER BY rowid').fetchall()
                    for t in ("player", "participant", "participant_items", "match")]
        finally:
            conn.close()

    results = {}
    for mode in ("sequential", "pipelined", "poison"):
        path = copies[mode]
        if mode == "poison":
            conn = sqlite3.connect(path)
            bad = conn.execute("SELECT api_id FROM match WHERE game_mode != 'aral' "
                               "ORDER BY created_at LIMIT 1 OFFSET ?",
                               (n_matches // 10,)).fetchone()[0]
            conn.execute("DELETE FROM participant_items WHERE participant_api_id "
                         "IN (SELECT api_id FROM participant WHERE match_api_id = ?)",
                         (bad,))
            conn.commit()
            conn.close()
        pipelined = mode != "sequential"
        broker = InMemoryBroker()
        cfg = ServiceConfig(batch_size=WORKER_BATCH, idle_timeout=0)
        # The device profiler is armed for the sequential run (windows it
        # asks for) and the poison drill (the dead letter asks for one);
        # causal tracing is on for the two full runs.
        prof_dir = os.path.join(tmp, f"prof_{mode}")
        w = Worker(broker, SqlStore(f"sqlite:///{path}"), cfg, RatingConfig(),
                   pipeline=pipelined, serve_port=0 if mode == "pipelined" else None,
                   profile_dir=None if mode == "pipelined" else prof_dir,
                   device=dev)
        t0 = time.perf_counter()
        w.warmup()
        t_warm = time.perf_counter() - t0
        tracer = reset_tracer()
        tracectx.enable_tracing(mode != "poison")
        fallbacks0 = get_registry().counter("sql.native_fallbacks_total").value
        # The poison drill consumes the first fifth of the ids (the
        # poisoned match among them): the same check at a fifth of the
        # depth of the full runs.
        run_ids = ids[: n_matches // 5] if mode == "poison" else ids
        mid = -(-len(run_ids) // WORKER_BATCH) // 2
        got = run_loop(w, broker, run_ids, cfg.queue,
                       capture_at=range(mid, mid + WORKER_CAPTURES)
                       if mode == "sequential" else ())
        tracectx.enable_tracing(False)
        stats = w.stats()
        if mode == "sequential":
            quality_block(w.quality)
        fallbacks = int(get_registry().counter("sql.native_fallbacks_total").value
                        - fallbacks0)
        failed = [m.body.decode() for m in broker.queues.get(cfg.failed_queue, [])]
        split = batch_split(("batch.encode", "batch.pack", "batch.chain",
                             "batch.dispatch", "batch.compute", "batch.fetch",
                             "batch.write_back", "batch.commit"))
        served = None
        if mode == "pipelined":
            conn = sqlite3.connect(path)
            rows = conn.execute("SELECT api_id, trueskill_mu, trueskill_sigma FROM "
                                "player WHERE trueskill_mu IS NOT NULL "
                                "ORDER BY rowid LIMIT 200").fetchall()
            conn.close()
            url = (w.serve_server.url + "/v1/ratings?ids="
                   + ",".join(r[0] for r in rows))
            with urllib.request.urlopen(url, timeout=30) as resp:
                body = json.loads(resp.read())
            served = [(e["id"], e["mu"], e["sigma"]) for e in body["ratings"]]
            want = [(r[0], float(np.float32(r[1])), float(np.float32(r[2]))) for r in rows]
            if served != want:
                raise AssertionError("served /v1/ratings differ from the committed rows")
        w.close()
        log(f"[worker] {mode}: {got['matches_per_s']:,.0f} matches/s "
            f"({len(run_ids)} ids in {got['seconds']:.2f} s, {got['batches']} "
            f"flushes; warmup {t_warm:.2f} s); matches_rated {stats['matches_rated']}, "
            f"dead letters {stats['dead_letters']}, lag {stats['pipeline_lag']}, "
            f"measured rtt {stats['measured_rtt_ms']} ms, host "
            f"{stats['measured_host_ms']} ms/batch; native-scan fallbacks "
            f"{fallbacks}; per batch: {split}"
            + (f"; /v1/ratings of {len(served)} players over HTTP = the committed "
               "rows bit for bit" if served is not None else ""))
        if mode != "poison":
            log(worker_split(mode, tracer, got))
        if mode == "sequential":
            export = os.path.join(tmp, "worker.jsonl")
            write_chrome_trace(export, tracer)
            captured = worker_captures(tracer, prof_dir, export)
        results[mode] = (stats, failed, got)
        if mode == "poison":
            if failed != [bad] or stats["matches_rated"] != len(run_ids) - 1:
                raise AssertionError(f"poison: dead-lettered {failed}, rated "
                                     f"{stats['matches_rated']} (want [{bad}])")
            log(f"[worker] poison: match {bad} without participant_items rows: "
                f"exactly that message dead-lettered, the other "
                f"{stats['matches_rated']} committed")
            # The dead letter asked the profiler for the next batch's
            # dispatch: one capture directory with its manifest.
            caps = [d for d in os.listdir(prof_dir) if "dead_letter" in d]
            if len(caps) != 1:
                raise AssertionError(f"poison: dead-letter captures {caps}")
            att = analyze_capture(os.path.join(prof_dir, caps[0]),
                                  update_metrics=False)
            if not att["parsed"] or att["manifest"]["reason"] != "dead_letter" \
                    or not att["device"]["lanes"]:
                raise AssertionError(f"poison: the dead-letter capture: {att['error']}")
            log(f"[worker] poison: the dead letter requested a capture of the next "
                f"batch's dispatch: {caps[0]} with manifest.json (reason "
                f"dead_letter, {att['manifest']['matches']} matches), device busy "
                f"{att['device']['busy_us'] / 1e3:.3f} ms, idle share "
                f"{att['device']['idle_frac']:.4f}")
        elif failed or stats["matches_rated"] != n_matches or stats["dead_letters"]:
            raise AssertionError(f"{mode}: dead letters {failed[:5]}, rated "
                                 f"{stats['matches_rated']}")
    seq, pipe = dump(copies["sequential"]), dump(copies["pipelined"])
    same = seq == pipe
    log(f"[worker] sequential = pipelined over player/participant/"
        f"participant_items/match rows ({sum(len(t) for t in seq)} rows): {same}")
    if not same:
        raise AssertionError("pipelined worker rows differ from the sequential worker's")

    quality_on_off(copies, ids[:QUALITY_IDS], dev, dump)

    fw.launches = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["rate", "--db", f"sqlite:///{copies['cli']}", "--db-write",
                       "--kernel", "fused", "--device", dev.type])
    wall = time.perf_counter() - t0
    cli_launches = fw.launches
    if rc != 0 or (cli_launches == 0) == (dev.type == "cuda"):
        raise AssertionError(f"cli rate --db exited {rc}, {cli_launches} launches")
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    same = seq[0] == dump(copies["cli"])[0]
    log(f"[worker] cli rate --db --db-write --kernel fused on the third copy: "
        f"{wall:.2f} s, players_written {stats['players_written']}, "
        f"fused_window launches {cli_launches}; the workers' player rows equal "
        f"its rows exactly: {same}")
    if not same:
        raise AssertionError("worker player rows differ from cli rate --db's")
    return {"launches_worker_cli": cli_launches, **captured,
            "planes": ({True: copies["planes_on"], False: copies["planes_off"]},
                       ids)}


def quality_block(ledger) -> None:
    """Prints the sequential run's calibration ledger (on by default):
    matches scored, Brier, log-loss, ECE and the reliability bins."""
    if ledger is None:
        raise AssertionError("[worker] the sequential Worker has no quality ledger")
    q = ledger.summary()
    if not q["matches_scored"]:
        raise AssertionError("[worker] the quality ledger scored no match")
    bins = "; ".join(f"[{b['lo']:.1f},{b['hi']:.1f}) {b['count']} "
                     f"p {b['mean_p']} y {b['mean_y']}" for b in q["bins"] if b["count"])
    log(f"[worker] sequential quality ledger: {q['matches_scored']} matches scored, "
        f"brier {q['brier']}, logloss {q['logloss']}, ece {q['ece']}, worst bin "
        f"{q['worst_bin']}; bins: {bins}")


def quality_on_off(copies: dict, ids: list, dev, dump) -> None:
    """The ledger is an observer: two sequential Workers over the same ids on
    two copies, ``quality=True`` (the default) and ``quality=False``, write
    the same rows and report the same deterministic stats, bit for bit."""
    from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
    from analyzer_tpu_torch.experiments.service_bench import run_loop
    from analyzer_tpu_torch.service import InMemoryBroker, SqlStore, Worker

    got = {}
    for on in (True, False):
        path = copies["quality_on" if on else "quality_off"]
        broker = InMemoryBroker()
        cfg = ServiceConfig(batch_size=WORKER_BATCH, idle_timeout=0)
        w = Worker(broker, SqlStore(f"sqlite:///{path}"), cfg, RatingConfig(),
                   pipeline=False, quality=on, device=dev)
        loop = run_loop(w, broker, ids, cfg.queue)
        st = w.stats()
        w.close()
        det = {k: st[k] for k in ("matches_rated", "batches_ok", "batches_failed",
                                  "dead_letters")}
        got[on] = (dump(path), det, broker.topics, st["quality"], loop["seconds"])
    same_rows = got[True][0] == got[False][0]
    same_det = got[True][1:3] == got[False][1:3]
    log(f"[worker] ledger on / off, sequential over the first {len(ids)} ids: "
        f"{got[True][4]:.2f} / {got[False][4]:.2f} s; quality block on "
        f"{got[True][3]}, off {got[False][3]}; written rows "
        f"({sum(len(t) for t in got[True][0])}) bit-identical: {same_rows}; "
        f"deterministic stats and topic traffic equal: {same_det}")
    if not (same_rows and same_det) or got[False][3] is not None \
            or not got[True][3]["matches_scored"]:
        raise AssertionError("[worker] the quality ledger changed the worker's output")


def http_status(url: str) -> tuple[int, bytes]:
    """One GET: (status, body), an HTTP error's included."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def served_now(engine) -> list:
    """One query of each kind through the engine, over the players the
    current view ranks first."""
    lb = engine.leaderboard(20)
    ids = [e["id"] for e in lb["leaders"]]
    return [lb, engine.get_ratings(ids), engine.win_probability(ids[:5], ids[5:10]),
            engine.tier_histogram(), engine.percentile(500.0)]


def planes_phase(cli, dev, paths: dict, all_ids: list, flight_dir: str) -> None:
    """Phase [planes]: the live obs planes on the card. Two sequential
    Workers over the first ``PLANES_IDS`` ids of [worker]'s fixture with
    the serve plane on: one with obsd, the flight recorder, the SLO plane
    and an audit of every served query, one with every plane off. After
    each flush both answer one query of each kind in process; the rows they
    commit and those responses must be equal bit for bit. While the first
    runs, a client thread hits ``/v1/*`` and every obsd route; then
    ``cli fleet --check`` exits 0, the audit has checked responses with no
    mismatch, and a poisoned match's dead letter burns a doctored
    zero-tolerance objective over a 2 s window: ``/readyz`` turns 503 and
    the flight dump the burn wrote holds ``history.json``, which ``cli
    history`` renders."""
    import glob
    import sqlite3

    from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
    from analyzer_tpu_torch.obs import (
        get_registry, reset_flight_recorder, reset_history, reset_registry,
        reset_watchdog,
    )
    from analyzer_tpu_torch.obs import slo
    from analyzer_tpu_torch.service import InMemoryBroker, SqlStore, Worker

    standard = slo.STANDARD_OBJECTIVES
    n = min(PLANES_IDS, len(all_ids) // 2)
    ids = all_ids[:n]
    # The phase's own process-wide telemetry: [worker]'s poison drill left a
    # dead letter in the registry that a fleet check would read.
    reset_registry()
    reset_history()
    reset_watchdog()
    reset_flight_recorder()

    def dump(path):
        conn = sqlite3.connect(path)
        try:
            return [conn.execute(f'SELECT * FROM "{t}" ORDER BY rowid').fetchall()
                    for t in ("player", "participant", "participant_items", "match")]
        finally:
            conn.close()

    got = {}
    for on in (True, False):
        planes = (dict(obs_port=0, flight_dir=flight_dir, audit=True,
                       audit_sample_denom=1) if on
                  else dict(slo_plane=False, quality=False))
        broker = InMemoryBroker()
        cfg = ServiceConfig(batch_size=WORKER_BATCH, idle_timeout=0)
        w = Worker(broker, SqlStore(f"sqlite:///{paths[on]}"), cfg, RatingConfig(),
                   pipeline=False, serve_port=0, device=dev, **planes)
        statuses: dict = {}
        stop = threading.Event()

        def client():
            serve, obsd = w.serve_server.url, w.obs_server.url
            while not stop.is_set():
                routes = {"/v1/leaderboard": serve + "/v1/leaderboard?k=10",
                          "/v1/tiers": serve + "/v1/tiers?score=500"}
                view = w.view_publisher.current()
                if view is not None and view.n_players >= 10:
                    a = ",".join(view.id_of(r) for r in range(5))
                    b = ",".join(view.id_of(r) for r in range(5, 10))
                    routes["/v1/ratings"] = f"{serve}/v1/ratings?ids={a},{b}"
                    routes["/v1/winprob"] = f"{serve}/v1/winprob?a={a}&b={b}"
                for route in OBSD_ROUTES:
                    routes[route.split("?")[0]] = obsd + route
                for name, url in routes.items():
                    statuses.setdefault(name, set()).add(http_status(url)[0])
                stop.wait(PLANES_CLIENT_S)

        replay = [0, 0.0]  # responses the audit replayed, seconds it took
        if on:
            drain = w.auditor.drain

            def timed_drain(limit=None):
                t = time.perf_counter()
                k = drain(limit)
                replay[0] += k
                replay[1] += time.perf_counter() - t
                return k

            w.auditor.drain = timed_drain
        try:
            w.warmup()
            thread = threading.Thread(target=client, daemon=True) if on else None
            for mid in ids:
                broker.publish(cfg.queue, mid.encode())
            served = []
            flushes = 0
            t0 = time.perf_counter()
            if thread is not None:
                thread.start()
            while w.poll():
                flushes += 1
                if flushes % PLANES_QUERY_EVERY == 1:
                    served.append(served_now(w.query_engine))
            served.append(served_now(w.query_engine))
            w.drain()
            wall = time.perf_counter() - t0
            stop.set()
            if thread is not None:
                thread.join(timeout=60)
            stats = w.stats()
            if not on:
                got[on] = (dump(paths[on]), served, wall, stats)
                continue
            target = w.obs_server.url[len("http://"):]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["fleet", "--check", target])
            log(f"[planes] cli fleet --check {target} while healthy: exit {rc}, "
                f"{buf.getvalue().strip()!r}")
            if rc != 0:
                raise AssertionError("[planes]: cli fleet --check failed on a healthy worker")
            audit = w.auditor.stats()
            log(f"[planes] while the planes ran, HTTP status of every route: "
                + ", ".join(f"{k} {sorted(v)}" for k, v in sorted(statuses.items())))
            log(f"[planes] shadow audit on the card: {audit}; the consumer thread "
                f"replayed {replay[0]} responses in {replay[1]:.3f} s "
                f"({replay[0] / max(replay[1], 1e-9):,.1f} responses/s)")
            if audit["checked"] == 0 or audit["mismatches"] or \
                    get_registry().counter("audit.mismatches_total").value:
                raise AssertionError(f"[planes]: audit {audit}")
            if any(route not in statuses for route in
                   ("/v1/ratings", "/v1/winprob", "/v1/leaderboard", "/v1/tiers")):
                raise AssertionError(f"[planes]: routes never hit: {sorted(statuses)}")
            for route in OBSD_ROUTES:
                name = route.split("?")[0]
                if not statuses[name] <= ({200, 503} if name == "/readyz" else {200}):
                    raise AssertionError(f"[planes]: {name} answered {statuses[name]}")
            got[on] = (dump(paths[on]), served, wall, stats)
            # The injected burn: one poisoned match after the compared run,
            # judged by a doctored objective — zero-dead-letters over a 2 s
            # window. The standard 60 s window cannot be relied on in a
            # process whose history is younger than a minute: its 1m tier's
            # bucket may hold the dead letter already and serve as the
            # baseline (the JAX package's window_rows, ported as it is).
            slo.STANDARD_OBJECTIVES = standard + (slo.Objective(
                "smoke-dead-letters", "counter_zero", "worker.dead_letters_total",
                windows=(2.0,)),)
            conn = sqlite3.connect(paths[on])
            bad = conn.execute("SELECT api_id FROM match WHERE game_mode != 'aral' "
                               "ORDER BY created_at LIMIT 1 OFFSET ?", (n + 10,)).fetchone()[0]
            conn.execute("DELETE FROM participant_items WHERE participant_api_id "
                         "IN (SELECT api_id FROM participant WHERE match_api_id = ?)",
                         (bad,))
            conn.commit()
            conn.close()
            broker.publish(cfg.queue, bad.encode())
            deadline = time.monotonic() + 30
            while "smoke-dead-letters" not in w.watchdog.burning \
                    and time.monotonic() < deadline:
                w.poll()
                time.sleep(0.1)
            code, body = http_status(w.obs_server.url + "/readyz")
            dumps = glob.glob(os.path.join(flight_dir, "flight-*slo-smoke-dead-letters*"))
            log(f"[planes] poisoned match {bad}: dead letters {w.dead_letters}, burning "
                f"{w.watchdog.burning}; /readyz {code}: {body.decode().strip()!r}; "
                f"flight dumps {sorted(os.path.basename(d) for d in dumps)}")
            if code != 503 or b"smoke-dead-letters" not in body or len(dumps) != 1:
                raise AssertionError("[planes]: the burn did not flip /readyz or dump")
            files = sorted(os.listdir(dumps[0]))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["history", dumps[0], "--series", "worker.dead_letters"])
            out = buf.getvalue()
            log(f"[planes] the burn's dump holds {files}; cli history <dump> exit {rc}: "
                f"{out.strip()!r}")
            if "history.json" not in files or rc != 0 or \
                    "worker.dead_letters_total" not in out:
                raise AssertionError("[planes]: the dump's history did not render")
        finally:
            slo.STANDARD_OBJECTIVES = standard
            stop.set()
            w.close()
    same_rows = got[True][0] == got[False][0]
    same_served = got[True][1] == got[False][1]
    log(f"[planes] sequential over {n} ids, planes on / off: {got[True][2]:.3f} / "
        f"{got[False][2]:.3f} s ({100 * (got[True][2] / got[False][2] - 1):+.1f}% with "
        f"the planes and a client thread on the serve plane and obsd every "
        f"{PLANES_CLIENT_S} s); SLO block {got[True][3]['slo']}; written rows "
        f"({sum(len(t) for t in got[True][0])}) bit-identical: {same_rows}; "
        f"{len(got[True][1])} rounds of served responses equal: {same_served}")
    if not (same_rows and same_served and got[True][1]):
        raise AssertionError("[planes]: the planes changed the worker's rows or answers")


def bench_phase(n_matches: int) -> dict:
    """Phase [bench]: ``cli bench --kernel fused --hot-rows 32768 --profile``
    in a subprocess at bench's default workload (``n_matches`` matches,
    a third as many players, conc 0.8, max share 1e-4), ``BENCH_REPEATS``
    repeats a line.
    Its BENCH line must carry both bit-identities, a roofline from the
    profile with ``fused_window`` the dominant kernel, and the ratios the
    line exists for."""
    prof_dir = tempfile.mkdtemp(prefix="chip_smoke_bench_prof_")
    try:
        line, counts, wall = counted_cli(
            "bench", "--kernel", "fused", "--hot-rows", str(BENCH_HOT_ROWS),
            "--profile", "--profile-dir", prof_dir,
            env={"BENCH_REPEATS": str(BENCH_REPEATS),
                 "BENCH_MATCHES": str(n_matches)},
        )
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    log(f"[bench] {json.dumps(line)}")
    fused, tiered = line["fused"], line["tiered"]
    profile, roof = line.get("profile") or {}, line["roofline"]
    log(f"[bench] {n_matches} matches: fused device-only {line['value']:,.1f} "
        f"matches/s ({fused['min_s']} s), reference {fused['reference_min_s']} s, "
        f"min_over_reference {fused['min_over_reference']}; streamed "
        f"min_over_device {line['streamed']['min_over_device']}; tiered "
        f"min_over_resident {tiered['min_over_resident']} at hit rate "
        f"{tiered['hit_rate']}; tracing tax "
        f"{line['trace_overhead']['overhead_pct']}%; profile busy "
        f"{profile.get('device_busy_s')} s, idle share "
        f"{profile.get('device_idle_frac')}, dominant {profile.get('dominant_kernel')}; "
        f"fused_window launches over the run {counts['fused_window_launches']}; "
        f"wall {wall:.1f} s; device {line['device']}")
    if fused["bit_identical_to_reference"] is not True:
        raise AssertionError("[bench]: the fused table differs from the reference's")
    if tiered["bit_identical_to_resident"] is not True:
        raise AssertionError("[bench]: the tiered table differs from the resident run's")
    if roof["device_time_source"] != "profile":
        raise AssertionError(f"[bench]: roofline from {roof['device_time_source']}, "
                             "not from the profile")
    if "fused_window" not in (profile.get("dominant_kernel") or ""):
        raise AssertionError(f"[bench]: dominant kernel {profile.get('dominant_kernel')}")
    for block in ("watchdog_overhead", "federate_overhead"):
        log(f"[bench] {block}: {json.dumps(line[block])}")
    for block, key in (("fused", "min_over_reference"), ("streamed", "min_over_device"),
                       ("trace_overhead", "overhead_pct"),
                       ("watchdog_overhead", "overhead_pct"),
                       ("federate_overhead", "overhead_pct")):
        if line[block].get(key) is None:
            raise AssertionError(f"[bench]: {block}.{key} missing")
    if counts["fused_window_launches"] == 0:
        raise AssertionError("[bench]: fused_window never launched")
    return {"launches_bench": counts["fused_window_launches"], "line": line}


def ingest_phase(tmp: str, dev, pre) -> None:
    """Phase [ingest]: ``cli bench --ingest`` at its defaults with two
    repeats (native decoder, pinned slabs, arena hit rate >= 0.9, no
    fallback counted); then ``pre`` written as CSV: the native
    ``load_stream_csv`` must equal the python parser bit for bit, and every
    decoder window staged onto the card through ``stage_ingest_window`` —
    the next windows decoded while earlier copies may still run — and
    fetched back at the end must equal its host columns and the parser's."""
    from analyzer_tpu_torch.io.csv_codec import _parse, load_stream_csv, save_stream_csv
    from analyzer_tpu_torch.io.ingest import ColumnarDecoder
    from analyzer_tpu_torch.sched.feed import PinnedArena, stage_ingest_window

    m_json = os.path.join(tmp, "ingest_metrics.json")
    line, _counts, wall = counted_cli(
        "bench", "--ingest", "--metrics-out", m_json,
        env={"BENCH_REPEATS": str(INGEST_REPEATS)},
    )
    with open(m_json) as f:
        fallbacks = json.load(f)["counters"]["ingest.fallbacks_total"]
    log(f"[ingest] {json.dumps(line)}")
    ing, arena_st = line["ingest"], line["arena"]
    log(f"[ingest] {ing['csv_bytes']} CSV bytes, {ing['windows']} windows of "
        f"{ing['window_rows']}: {line['value']:,.1f} bytes/s, queue-to-H2D p50 / "
        f"p99 {line['latency_ms']['p50']} / {line['latency_ms']['p99']} ms, "
        f"{ing['speedup_over_python']}x the python codec; arena hit rate "
        f"{arena_st['hit_rate']}, pinned {arena_st['pinned']}; fallbacks "
        f"{fallbacks}; wall {wall:.1f} s")
    if not (ing["native"] is True and arena_st["pinned"] is True
            and arena_st["hit_rate"] >= 0.9 and fallbacks == 0):
        raise AssertionError(f"[ingest]: native {ing['native']}, pinned "
                             f"{arena_st['pinned']}, hit rate {arena_st['hit_rate']}, "
                             f"fallbacks {fallbacks}")

    path = os.path.join(tmp, "prefix.csv")
    t0 = time.perf_counter()
    save_stream_csv(path, pre)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = load_stream_csv(path)
    t_fast = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path, newline="") as f:
        slow = _parse(f)
    t_slow = time.perf_counter() - t0
    for key in ("player_idx", "winner", "mode_id", "afk"):
        a, b = getattr(fast, key), getattr(slow, key)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"[ingest]: fastcsv {key} differs from the python parser")
    with open(path, "rb") as f:
        data = f.read()
    arena = PinnedArena()
    staged = []
    t0 = time.perf_counter()
    for win in ColumnarDecoder(data, arena=arena).windows():
        host = [s[: win.rows].copy() for s in win.slabs]
        staged.append((win.start_row, host, stage_ingest_window(win, arena, dev)))
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    t = slow.player_idx.shape[2]
    for start, host, (n, *devs) in staged:
        for got, want in zip(devs, host):
            if not np.array_equal(got[:n].cpu().numpy(), want):
                raise AssertionError(f"[ingest]: window at row {start} differs on the card")
        if not (np.array_equal(host[0][:, :, :t], slow.player_idx[start:start + n])
                and np.array_equal(host[1], slow.winner[start:start + n])
                and np.array_equal(host[2], slow.mode_id[start:start + n])
                and np.array_equal(host[3].astype(bool), slow.afk[start:start + n])):
            raise AssertionError(f"[ingest]: window at row {start} differs from the parser")
    rows = sum(n for _s, _h, (n, *_d) in staged)
    st = arena.stats()
    log(f"[ingest] {pre.n_matches} matches as CSV ({len(data)} bytes, written in "
        f"{t_write:.2f} s): load_stream_csv (fastcsv) {t_fast:.3f} s = python "
        f"parser ({t_slow:.2f} s) bit for bit; {len(staged)} windows ({rows} rows) "
        f"staged on the card in {t_stage:.3f} s, fetched back equal to the host "
        f"columns; arena allocs {st['allocs']}, reuses {st['reuses']}, pinned "
        f"{st['pinned']}")
    if rows != pre.n_matches or not st["pinned"]:
        raise AssertionError(f"[ingest]: {rows} rows staged, pinned {st['pinned']}")


def oracle_phase(dev, cfg, n_matches: int) -> dict:
    """Phase [oracle]: a seeded sample of the real matches of the first step
    of the first fused windows of a [bench]-sized schedule (the players'
    rank points and tiers seeding, as bench.py), rated by the CUDA kernel
    with collect, held to the port's 50-digit oracle
    (:func:`oracle_errors`) within tests/test_oracle.py's bounds."""
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
    from analyzer_tpu_torch.sched import pack_schedule
    from analyzer_tpu_torch.sched.feed import stage_chunk_fused
    from analyzer_tpu_torch.sched.residency import resolve_fuse

    n_players = max(n_matches // 3, 100)
    players = synthetic_players(n_players, seed=SEED)
    stream = synthetic_stream(n_matches, players, seed=SEED,
                              activity_concentration=0.8, max_activity_share=1e-4)
    state = PlayerState.create(
        n_players, players.rank_points_ranked, players.rank_points_blitz,
        players.skill_tier, cfg=cfg, device=dev,
    )
    sched = pack_schedule(stream, pad_row=state.pad_row, windowed=True)
    chunk = stage_chunk_fused(sched, 0, min(2 * PREFIX_STEPS, sched.n_steps),
                              resolve_fuse("fused"), True, True)
    views = chunk.slab.to_device(dev)
    t0 = time.perf_counter()
    samples = oracle_window_samples(state.table.clone(), chunk, views, cfg,
                                    ORACLE_WINDOWS)
    pick = np.random.default_rng(SEED).choice(
        len(samples), min(ORACLE_SAMPLE, len(samples)), replace=False
    )
    worst = oracle_errors([samples[i] for i in pick], cfg)
    log(f"[oracle] {len(pick)} of {len(samples)} real matches from the first step "
        f"of the first {ORACLE_WINDOWS} fused windows ({n_matches} matches, B="
        f"{sched.batch_size}), the CUDA kernel against the 50-digit oracle: worst "
        f"relative error mu {worst['mu']:.3e} (bound {ORACLE_BOUNDS['mu']:g}), "
        f"sigma {worst['sigma']:.3e} (bound {ORACLE_BOUNDS['sigma']:g}), quality "
        f"{worst['quality']:.3e} (bound {ORACLE_BOUNDS['quality']:g}); "
        f"{time.perf_counter() - t0:.1f} s")
    if len(pick) < ORACLE_SAMPLE // 2:
        raise AssertionError(f"[oracle]: only {len(pick)} matches sampled")
    for key, bound in ORACLE_BOUNDS.items():
        if not worst[key] < bound:
            raise AssertionError(f"[oracle]: {key} error {worst[key]} >= {bound}")
    return worst


def last_span_us(tracer, t0: float) -> float:
    """The end of the last span this thread emitted after tracer time
    ``t0`` (what follows it — a final publish, a checkpoint, a cutover —
    is outside a consumer loop's split)."""
    me = threading.get_ident() % 1_000_000
    return max((e["ts"] + e["dur"] for e in tracer.events()
                if e.get("ph") == "X" and e["tid"] == me and e["ts"] >= t0),
               default=t0)


def migrate_phase(cli, tmp: str, dev, cfg, state0, csv_path: str, pre,
                  a_pre: np.ndarray, tier_hot: int) -> dict:
    """Phase [migrate]: the zero-downtime re-rate of ``csv_path`` (``pre``
    as CSV) over the whole player table. ``run_migration(kernel="fused")``
    into a ``LineageManager`` over a live ``ViewPublisher`` primed with the
    seed table, under an ``AdmissionController`` with no live backlog (its
    halvings counted), each ``fused_window`` launch timed by CUDA events:
    the cutover's table must equal [prefix]'s bit for bit. Then a bounded
    run killed at half the steps and resumed from its checkpoint, and the
    tiered run at ``tier_hot``: both bit for bit. In subprocesses, ``cli
    migrate --kernel fused`` on the first ``MIGRATE_CLI_MATCHES`` matches
    against ``cli rate`` (checkpoint tables bit for bit), and ``cli bench
    --migrate``."""
    from analyzer_tpu_torch.io.checkpoint import load_checkpoint
    from analyzer_tpu_torch.io.csv_codec import save_stream_csv
    from analyzer_tpu_torch.kernels import fused_window as fw
    from analyzer_tpu_torch.migrate import LineageManager, run_migration
    from analyzer_tpu_torch.obs import get_registry, reset_tracer
    from analyzer_tpu_torch.serve import ViewPublisher
    from analyzer_tpu_torch.service.broker import AdmissionController

    t_phase = time.perf_counter()
    with open(csv_path, "rb") as f:
        data = f.read()
    n = state0.n_players
    live = ViewPublisher()  # device=None: the card
    live.publish_state(state0)
    lineage = LineageManager(live)
    real, events = fw.fused_window, []

    def timed(*args, **kw):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real(*args, **kw)
        ev[1].record()
        events.append(ev)
        return out

    throttled0 = get_registry().counter("migrate.throttled_total").value
    fw.launches = 0
    fw.fused_window = timed
    tracer = reset_tracer()
    counters0 = feed_counters()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u0 = tracer_us(tracer)
        report = run_migration(
            state0, data, cfg, lineage=lineage, kernel="fused",
            admission=AdmissionController(), live_backlog=lambda: 0,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        fw.fused_window = real
    launches = fw.launches
    st = report.stats
    ms = float(np.mean([a.elapsed_time(b) for a, b in events])) if events else None
    got = report.state.table.cpu().numpy()
    view = live.current()
    served = view.host_table()[:n]
    same = np.array_equal(got, a_pre, equal_nan=True)
    same_served = np.array_equal(served, a_pre[:n], equal_nan=True)
    log(f"[migrate] run_migration(kernel='fused') of {st['matches']} CSV matches "
        f"({len(data)} bytes) over {n} players: wall {wall:.3f} s, "
        f"{st['matches'] / wall:,.0f} matches/s, ttfd_s {st['ttfd_s']:.4f}; "
        f"{st['n_steps']} steps x B={st['batch_size']}, occupancy "
        f"{st['occupancy']:.4f}, plan windows {st['prefix_windows']} of "
        f"{st['window_rows']} rows; assign_native {st['assign_native']}; windows "
        f"{st['windows']}, fused_window launches {launches}, {ms:.5f} ms a call "
        f"(CUDA events around each of the {len(events)} calls; the card waits on "
        f"staging, so each reading holds the wrapper's host time too); admission (one quota "
        f"a chunk, no live backlog): halvings {st['admission_halvings']}, throttled "
        f"{int(get_registry().counter('migrate.throttled_total').value - throttled0)}; "
        f"cutover pause {report.cutover_pause_ms} ms, live v{view.version}; table "
        f"bit-identical to [prefix]'s: {same}; served table = it: {same_served}")
    log(runner_split("[migrate]", tracer, u0, last_span_us(tracer, u0), counters0,
                     hooks=("view.publish",)))
    if not (report.finished and st["streamed"] and same and same_served):
        raise AssertionError("[migrate]: the migrated or served table differs from [prefix]'s")
    if launches == 0 or launches != st["windows"]:
        raise AssertionError(f"[migrate]: {launches} launches for {st['windows']} windows")
    if st["assign_native"] is not True or view.version != 2:
        raise AssertionError(f"[migrate]: assign_native {st['assign_native']}, "
                             f"live version {view.version}")
    del report, got

    # Kill and resume: a bounded run to about half the steps, then --resume.
    ck = os.path.join(tmp, "migrate.npz")
    half = max(1, st["n_steps"] // 2)
    fw.launches = 0
    t0 = time.perf_counter()
    bounded = run_migration(state0, data, cfg, checkpoint=ck, stop_after=half,
                            kernel="fused")
    mid = load_checkpoint(ck, device="cpu")
    resumed = run_migration(None, data, cfg, checkpoint=ck, resume=True,
                            kernel="fused")
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    same = np.array_equal(resumed.state.table.cpu().numpy(), a_pre, equal_nan=True)
    log(f"[migrate] kill-and-resume: stopped at step {mid.step_cursor} (asked "
        f"{half}) with a checkpoint, resumed to the end: {t_resume:.3f} s for both, "
        f"fused_window launches {fw.launches}; finished {bounded.finished} / "
        f"{resumed.finished}; table bit-identical to the one-shot migration: {same}")
    if bounded.finished or not resumed.finished or not same or mid.step_cursor < half:
        raise AssertionError("[migrate]: the resumed migration differs from the one-shot run")
    del bounded, resumed, mid

    # The tiered migration.
    fw.launches = 0
    t0 = time.perf_counter()
    tiered = run_migration(state0, data, cfg, kernel="fused", hot_rows=tier_hot)
    torch.cuda.synchronize()
    t_tier = time.perf_counter() - t0
    same = np.array_equal(tiered.state.table.cpu().numpy(), a_pre, equal_nan=True)
    log(f"[migrate] tiered, hot_rows={tier_hot}: wall {t_tier:.3f} s "
        f"({t_tier / wall:.2f}x the resident migration), windows "
        f"{tiered.stats['windows']}, fused_window launches {fw.launches}; table "
        f"bit-identical: {same}")
    if not same or fw.launches == 0:
        raise AssertionError("[migrate]: the tiered migration differs from [prefix]'s")
    del tiered

    # cli migrate against cli rate, both in subprocesses, on a shorter prefix.
    small = os.path.join(tmp, "migrate_small.csv")
    save_stream_csv(small, pre.slice(0, min(MIGRATE_CLI_MATCHES, pre.n_matches)))
    ck_m, ck_r = os.path.join(tmp, "cli_migrate.npz"), os.path.join(tmp, "cli_rate.npz")
    with ThreadPoolExecutor(2) as pool:  # two processes, side by side
        mig_run = pool.submit(counted_cli, "migrate", "--csv", small, "--kernel",
                              "fused", "--checkpoint", ck_m)
        rate_run = pool.submit(counted_cli, "rate", "--csv", small, "--kernel",
                               "fused", "--checkpoint", ck_r)
        line_m, counts_m, wall_m = mig_run.result()
        line_r, counts_r, wall_r = rate_run.result()
    a = load_checkpoint(ck_m, device="cpu").state.table.numpy()
    b = load_checkpoint(ck_r, device="cpu").state.table.numpy()
    same = np.array_equal(a, b, equal_nan=True)
    log(f"[migrate] cli migrate --kernel fused ({wall_m:.1f} s): {json.dumps(line_m)}; "
        f"fused_window launches {counts_m['fused_window_launches']}")
    log(f"[migrate] cli rate --kernel fused on the same {line_m['matches']} matches "
        f"(beside it, {wall_r:.1f} s, launches {counts_r['fused_window_launches']}): "
        f"checkpoint tables bit-identical: {same}")
    if not same or counts_m["fused_window_launches"] == 0 or not line_m["streamed"]:
        raise AssertionError("[migrate]: cli migrate's checkpoint differs from cli rate's")

    # cli bench --migrate.
    line, counts, wall_b = counted_cli(
        "bench", "--migrate",
        env={"BENCH_REPEATS": str(MIGRATE_BENCH_REPEATS),
             "BENCH_ASSIGN_MATCHES": str(MIGRATE_ASSIGN_MATCHES),
             "BENCH_KERNEL": "fused"},
    )
    log(f"[migrate] {json.dumps(line)}")
    mig, assign = line["migrate"], line["assign"]
    log(f"[migrate] cli bench --migrate ({mig['matches']} matches, {wall_b:.1f} s): "
        f"{line['value']:,.1f} matches/s, ttfd_s {mig['ttfd_s']}, cutover pause "
        f"{mig['cutover_pause_ms']} ms, live p50 / p99 during the migration "
        f"{line['latency_ms']['p50']} / {line['latency_ms']['p99']} ms (idle p99 "
        f"{mig['idle_p99_ms']}); assign front half ({assign['matches']} matches): "
        f"native {assign['native']} {assign['matches_per_sec']:,.1f} matches/s, "
        f"python {assign['python_matches_per_sec']:,.1f} ({assign['speedup_over_python']}x); "
        f"fused_window launches {counts['fused_window_launches']}; device {line['device']}")
    if not (mig["streamed"] and mig["bit_identical"] and assign["native"]
            and counts["fused_window_launches"] > 0):
        raise AssertionError(f"[migrate]: bench --migrate {mig}")
    log(f"[migrate] phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"launches_migrate": launches, "migrate_call_ms": ms,
            "launches_migrate_cli": counts_m["fused_window_launches"],
            "launches_migrate_bench": counts["fused_window_launches"]}


def soak_phase(dev) -> None:
    """Phase [soak]: two closed-loop soaks on the card at the rig widths
    (``SOAK_WIDTHS``), queries over ``/v1/*``, ``SOAK_SECONDS`` virtual
    seconds, not realtime: A on one queue and one serve shard, B on
    ``broker_partitions=4`` with priority lanes, ``serve_shards=4`` and a
    ``SOAK_MIGRATE_MATCHES``-match migration under the load. B's
    deterministic block must equal A's byte for byte, its migrated lineage
    its from-scratch reference, and both artifacts must pass
    ``soak_violations``. Prints matches/s, the query workload's p50 / p99
    per kind and the migration block."""
    from analyzer_tpu_torch.loadgen import SoakConfig, SoakDriver
    from analyzer_tpu_torch.obs.slo import soak_violations

    t_phase = time.perf_counter()
    base = dict(seed=SEED, duration_s=SOAK_SECONDS, tick_s=1.0, use_http=True,
                **SOAK_WIDTHS)
    arts = {}
    for tag, extra in (("A", {}), ("B", dict(
            broker_partitions=4, priority_lanes=True, serve_shards=4,
            migrate=True, migrate_matches=SOAK_MIGRATE_MATCHES))):
        driver = SoakDriver(SoakConfig(**base, **extra))
        lat: dict = {}
        in_queries = [False]
        for kind, name in (("ratings", "get_ratings"), ("winprob", "win_probability"),
                           ("leaderboard", "leaderboard"), ("tiers", "tiers")):
            def wrap(fn=getattr(driver.client, name), kind=kind):
                def call(*a):
                    t = time.perf_counter()
                    out = fn(*a)
                    if in_queries[0]:
                        lat.setdefault(kind, []).append((time.perf_counter() - t) * 1e3)
                    return out
                return call
            setattr(driver.client, name, wrap())
        issue = driver._issue_queries

        def queries(*a, issue=issue):
            in_queries[0] = True
            try:
                return issue(*a)
            finally:
                in_queries[0] = False

        driver._issue_queries = queries
        t0 = time.perf_counter()
        try:
            art = driver.run()
        finally:
            driver.close()
        wall = time.perf_counter() - t0
        det = art["deterministic"]
        per_kind = "; ".join(
            f"{k} p50 {np.percentile(v, 50):.3f} / p99 {np.percentile(v, 99):.3f} ms x{len(v)}"
            for k, v in sorted(lat.items()))
        log(f"[soak] {tag} ({', '.join(f'{k}={v}' for k, v in extra.items()) or 'one queue, one shard'}): "
            f"{det['matches_rated']} matches rated of {det['matches_published']} over "
            f"{det['ticks']} virtual s, {art['value']:,.2f} matches/s (wall "
            f"{art['measured']['wall_s']} s, run {wall:.1f} s); queries "
            f"{art['measured']['queries_per_sec']:,.2f}/s, all kinds p50 / p99 "
            f"{art['latency_ms']['p50']} / {art['latency_ms']['p99']} ms; {per_kind}; "
            f"queue depth max {det['queue_depth_max']}, view lag max "
            f"{det['view_lag_ticks_max']} ticks, dead letters {det['dead_letters']}, "
            f"retraces {det['retraces_steady']}, drained {det['drained']}; "
            f"slo {art['slo']}")
        if "migration" in art:
            log(f"[soak] {tag} migration: {json.dumps(art['migration'])}")
        violations = soak_violations(art)
        if violations or not art["slo"]["pass"]:
            raise AssertionError(f"[soak] {tag}: {violations or art['slo']['violations']}")
        arts[tag] = art
    mig = arts["B"]["migration"]
    same = json.dumps(arts["A"]["deterministic"], sort_keys=True) == json.dumps(
        arts["B"]["deterministic"], sort_keys=True)
    log(f"[soak] B's deterministic block equal to A's byte for byte: {same}; B's "
        f"migrated lineage equal to its from-scratch reference: "
        f"{mig.get('bit_identical')}, served after the cutover: "
        f"{mig.get('cutover_serves_migrated_table')}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not (same and mig.get("finished") and mig.get("bit_identical")
            and mig.get("cutover_serves_migrated_table")):
        raise AssertionError("[soak]: B's block differs from A's, or its migration failed")


def cli_sub(*argv) -> subprocess.CompletedProcess:
    """``python -m analyzer_tpu_torch.cli ARGV`` in a subprocess from the
    checkout's root."""
    return subprocess.run(
        [sys.executable, "-m", "analyzer_tpu_torch.cli", *argv],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )


def cli_obs_port_phase(cli, pre_path: str, ck: str, want: np.ndarray) -> None:
    """``cli rate --obs-port 0 --kernel fused --checkpoint`` on the prefix
    while a thread scrapes obsd's ``/metrics`` every ``SCRAPE_S`` seconds,
    with one last scrape when the run closes obsd: the checkpoint's table
    must equal [prefix]'s bit for bit (rows past the file's players are
    unrated there), and the last scrape's ``fused.windows_total`` must
    equal the run's ``fused_window`` launches."""
    import re

    from analyzer_tpu_torch.io.checkpoint import load_checkpoint
    from analyzer_tpu_torch.kernels import fused_window as fw
    from analyzer_tpu_torch.obs import reset_registry
    from analyzer_tpu_torch.obs import server as obs_server

    started, bodies = [], []
    final, done = threading.Event(), threading.Event()

    class Scraped(obs_server.ObsServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            started.append(self)
            threading.Thread(target=self.scrape, daemon=True).start()

        def scrape(self):
            while True:
                last = final.is_set()
                code, body = http_status(self.url + "/metrics")
                if code == 200:
                    bodies.append(body.decode())
                if last:
                    done.set()
                    return
                final.wait(SCRAPE_S)

        def close(self):
            final.set()
            done.wait(30)
            super().close()

    reset_registry()
    fw.launches = 0
    orig = obs_server.ObsServer
    obs_server.ObsServer = Scraped
    try:
        run_cli(cli, "rate", "--csv", pre_path, "--kernel", "fused",
                "--checkpoint", ck, "--obs-port", "0")
    finally:
        obs_server.ObsServer = orig
    launches = fw.launches
    windows = [re.search(r"^fused_windows_total (\S+)$", b, re.M) for b in bodies]
    last = float(windows[-1].group(1)) if bodies and windows[-1] else None
    table = load_checkpoint(ck, device="cpu").state.table.numpy()
    p = table.shape[0] - 1
    same = (np.array_equal(table[:p], want[:p], equal_nan=True)
            and np.array_equal(table[p], want[-1], equal_nan=True)
            and bool(np.isnan(want[p:-1, 0]).all()))
    log(f"[cli] rate --obs-port 0 --kernel fused --checkpoint: {len(started)} obsd, "
        f"{len(bodies)} /metrics scrapes at {1 / SCRAPE_S:.0f} Hz; last scrape's "
        f"fused.windows_total {last}, fused_window launches {launches}; checkpoint "
        f"table ({p} players) bit-identical to [prefix]'s: {same}")
    if len(started) != 1 or launches == 0 or last != launches or not same:
        raise AssertionError("[cli] rate --obs-port differs from [prefix] or its scrape")


def cli_obs_phase(m_json: str, t_jsonl: str, capture: str, launches: int) -> None:
    """The artifacts of ``cli rate --trace --metrics-out --trace-events``
    through ``cli metrics``, ``cli profile`` and ``cli trace``, each in a
    subprocess: the snapshot counts supersteps and ``batch.compute`` spans,
    the capture attributes ``fused_window`` on a device lane, and the span
    export — which holds no causal-trace events — exits 2 in ``cli trace``,
    as the JAX package's does on a rate run's export."""
    snap = json.load(open(m_json))
    steps = snap["counters"]["sched.steps_total"]
    computes = sum(1 for e in snap["spans"] if e["name"] == "batch.compute")
    if not steps or not computes:
        raise AssertionError(f"--metrics-out: sched.steps_total {steps}, "
                             f"batch.compute spans {computes}")
    summ = cli_sub("metrics", m_json, "--format", "summary")
    if summ.returncode != 0 or "sched.steps_total" not in summ.stdout:
        raise AssertionError(f"cli metrics exited {summ.returncode}: {summ.stderr}")
    prof = cli_sub("profile", capture, "--json")
    if prof.returncode != 0:
        raise AssertionError(f"cli profile exited {prof.returncode}: {prof.stderr}")
    att = json.loads(prof.stdout)
    row = fused_row(att)
    if row is None or not att["device"]["lanes"]:
        raise AssertionError(f"cli profile: no fused_window on a device lane: "
                             f"{[k['name'] for k in att['kernels'][:8]]}")
    tr = cli_sub("trace", t_jsonl)
    if tr.returncode != 2 or "no causal-trace events" not in tr.stderr:
        raise AssertionError(f"cli trace on a rate export exited {tr.returncode} "
                             f"(expected 2, as the JAX CLI): {tr.stderr}")
    log(f"[cli] --metrics-out: sched.steps_total {int(steps)}, {computes} "
        f"batch.compute spans, {len(snap['spans'])} spans; cli metrics --format "
        f"summary exit 0 ({len(summ.stdout.splitlines())} lines); cli profile exit "
        f"0: fused_window x{row['count']} (launches {launches}), "
        f"{row['total_us'] / 1e3 / row['count']:.5f} ms per launch, device busy "
        f"{att['device']['busy_us'] / 1e6:.4f} s, idle share "
        f"{att['device']['idle_frac']:.4f}; cli trace on the span export exit 2 "
        "(no causal-trace events in a rate run, as the JAX CLI)")


def run_cli(cli, *argv, tag="[cli]") -> dict:
    """``cli.main(argv)`` in this process; its stats line, parsed."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    log(f"{tag} {' '.join(os.path.basename(a) for a in argv)}: {wall:.2f} s -> {lines[-1]}")
    if not lines[-1].startswith("{"):
        return {"line": lines[-1]}
    return json.loads(lines[-1])


def models_phase(cli, tmp: str, dev, sched, n_players: int, pre) -> dict:
    """Phase [models]: BASELINE configs 1, 3 and 4 through the port's cli on
    the card — five heads at BASELINE.md's provenance sizes, the card
    against the port's own CPU run, the features pass's CUDA graph against
    its eager dispatch, Elo over [main]'s 10M schedule and ``cli elo`` on
    the 1M prefix as a file."""
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.io.csv_codec import load_stream, save_stream_npz
    from analyzer_tpu_torch.models import elo_history, history_features, model_from_numpy
    from analyzer_tpu_torch.sched import pack_schedule

    t_phase = time.perf_counter()
    log(f"[models] float32 matmul precision "
        f"{torch.get_float32_matmul_precision()!r}, "
        f"torch.backends.cuda.matmul.allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must stay off: the heads train in full float32")

    # The card against the port's CPU run: the CPU half runs in subprocesses
    # beside the card's work (one core each).
    cmp_path = os.path.join(tmp, "cmp.npz")
    run_cli(cli, "synth", "--matches", str(CMP_MATCHES), "--players",
            str(CMP_PLAYERS), "--seed", "7", "--out", cmp_path, tag="[models]")
    jobs = {
        "logistic": ("train", "--model", "logistic"),
        "mlp": ("train", "--model", "mlp", "--hidden", "64"),
        "mlp_short": ("train", "--model", "mlp", "--hidden", "64", "--epochs",
                      str(MLP_SHORT_EPOCHS)),
        "elo": ("elo",),
    }
    procs = {}
    for name, argv in jobs.items():
        out = os.path.join(tmp, f"cpu_{name}.npz")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "analyzer_tpu_torch.cli", *argv, "--csv",
             cmp_path, "--out", out, "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env={**os.environ, "OMP_NUM_THREADS": "1"},
        )
    try:
        heads = models_heads(cli, tmp)
        card = {name: os.path.join(tmp, f"card_{name}.npz") for name in jobs}
        card_lines = {
            name: run_cli(cli, *argv, "--csv", cmp_path, "--out", card[name],
                          tag="[models]")
            for name, argv in jobs.items()
        }
        cpu_lines = {}
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"[models] cpu {name} exited {proc.returncode}: "
                                     f"{err[-2000:]}")
            cpu_lines[name] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    worst = {}
    for name in ("logistic", "mlp_short", "mlp"):
        with np.load(card[name]) as a, np.load(os.path.join(tmp, f"cpu_{name}.npz")) as b:
            kind = str(a["model"])
            m, mc = (model_from_numpy(kind, dict(z), device="cpu") for z in (a, b))
        with torch.no_grad():
            err = max(float((p - q).abs().max())
                      for p, q in zip(m.parameters(), mc.parameters()))
        worst[name] = err
        ours, cpu = card_lines[name], cpu_lines[name]
        loss_err = max(abs(ours[k] - cpu[k]) for k in ("train_nll", "eval_logloss"))
        log(f"[models] card vs cpu, {' '.join(jobs[name][1:])} on {CMP_MATCHES} / "
            f"{CMP_PLAYERS}: max |weight difference| {err:.3e}, train_nll "
            f"{ours['train_nll']} / {cpu['train_nll']}, eval_logloss "
            f"{ours['eval_logloss']} / {cpu['eval_logloss']}")
        # The MLP's full 30 epochs are held by their losses: a ReLU unit
        # whose pre-activation crosses zero on one device only parts the two
        # weight trajectories (tests/test_torch_models.py); its first
        # MLP_SHORT_EPOCHS epochs and the logistic head by their weights.
        ok = loss_err <= LOSS_ATOL if name == "mlp" else err <= MODEL_ATOL
        if not ok:
            raise AssertionError(f"[models] {name} on the card differs from the "
                                 f"CPU run: weights {err}, losses {loss_err}")
    with np.load(card["elo"]) as a, np.load(os.path.join(tmp, "cpu_elo.npz")) as b:
        r_err = float(np.abs(a["ratings"] - b["ratings"]).max())
        e_err = float(np.abs(a["expected"] - b["expected"]).max())
    worst["elo"] = r_err
    log(f"[models] card vs cpu, elo: max |rating difference| {r_err:.3e} (tol "
        f"{ELO_ATOL:g}), max |prediction difference| {e_err:.3e} (tol "
        f"{EXP_ATOL:g}); prediction_accuracy {card_lines['elo']['prediction_accuracy']}"
        f" / {cpu_lines['elo']['prediction_accuracy']}")
    if not (r_err <= ELO_ATOL and e_err <= EXP_ATOL):
        raise AssertionError("[models] elo on the card differs from the CPU run")

    # The features pass: one CUDA graph per step against eager dispatch.
    cfg = RatingConfig()
    sub = load_stream(cmp_path).slice(0, FEATURES_EAGER_MATCHES)
    n_sub = int(sub.player_idx.max()) + 1
    state = PlayerState.create(n_sub, cfg=cfg, device=dev)
    sub_sched = pack_schedule(sub, pad_row=state.pad_row, windowed=True)
    passes = {}
    for graph in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f, rat, fin = history_features(state, sub_sched, cfg, graph=graph)
        torch.cuda.synchronize()
        passes[graph] = (f, fin.table.cpu().numpy(), time.perf_counter() - t0)
    same = (np.array_equal(passes[True][0], passes[False][0])
            and np.array_equal(passes[True][1], passes[False][1], equal_nan=True))
    per = {g: 1e3 * passes[g][2] / sub_sched.n_steps for g in passes}
    log(f"[models] features pass on the first {sub.n_matches} matches "
        f"({sub_sched.n_steps} steps x B={sub_sched.batch_size}): CUDA graph "
        f"{passes[True][2]:.3f} s ({per[True]:.4f} ms/step), eager dispatch "
        f"{passes[False][2]:.3f} s ({per[False]:.4f} ms/step); features and "
        f"final table bit-identical: {same}")
    if not same:
        raise AssertionError("[models] the graphed features pass differs from eager")

    # Elo over [main]'s schedule at full size.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ratings, expected = elo_history(sched, n_players)
    torch.cuda.synchronize()
    t_elo = time.perf_counter() - t0
    if not np.isfinite(ratings).all() or not np.isfinite(expected).all():
        raise AssertionError("[models] a non-finite Elo rating or prediction")
    stream = sched.stream
    drift = float(ratings.astype(np.float64).sum() - n_players * 1500.0)
    sizes = (stream.player_idx >= 0).sum(axis=2)
    uneq = stream.ratable & (sizes[:, 0] != sizes[:, 1])
    s0 = (stream.winner == 0).astype(np.float64)
    team_term = float((32.0 * (s0 - expected.astype(np.float64))
                       * (sizes[:, 0] - sizes[:, 1]))[uneq].sum())
    adds = int(sizes[stream.ratable].sum())
    half_ulp = float(np.spacing(np.float32(max(abs(ratings).max(), 1.0)))) / 2
    log(f"[models] elo_history over [main]'s schedule ({sched.n_matches} matches, "
        f"{sched.n_steps} steps x B={sched.batch_size}, {n_players} players): "
        f"{t_elo:.3f} s, {sched.n_matches / t_elo:,.0f} matches/s; ratings "
        f"finite, min {ratings.min():.2f} max {ratings.max():.2f}; total mass "
        f"drift from P x 1500: {drift:+.4f} (matches with unequal teams "
        f"{int(uneq.sum())}, their exact share {team_term:+.4f}; f32 rounding "
        f"bound {adds} adds x half an ulp {half_ulp:.3e} = {adds * half_ulp:.1f}, "
        f"random-walk scale {np.sqrt(adds) * half_ulp:.3f})")
    if abs(drift - team_term) > adds * half_ulp:
        raise AssertionError(f"[models] Elo mass drift {drift} beyond its bound")

    # cli elo on the 1M prefix as a file.
    pre_path = os.path.join(tmp, "prefix.npz")
    save_stream_npz(pre_path, pre)
    got = run_cli(cli, "elo", "--csv", pre_path, tag="[models]")
    if got["matches"] != pre.n_matches or got["prediction_accuracy"] is None:
        raise AssertionError(f"[models] cli elo on the prefix: {got}")
    wall = time.perf_counter() - t_phase
    log(f"[models] phase wall {wall:.1f} s")
    return {"heads": heads, "card_vs_cpu": worst, "elo_s": t_elo, "wall_s": wall}


def models_heads(cli, tmp: str) -> dict:
    """The five heads at BASELINE.md's provenance sizes, each through ``cli
    train`` on the card: its JSON line with the features and train phase
    seconds, finite losses, the telemetry MLP's eval accuracy above
    ``TELEMETRY_MIN_ACC`` and both synergy heads beating the rating-only
    baseline on eval log-loss."""
    prov, syn = os.path.join(tmp, "prov.npz"), os.path.join(tmp, "prov_syn.npz")
    base = ("synth", "--matches", str(PROV_MATCHES), "--players", str(PROV_PLAYERS),
            "--seed", "7")
    run_cli(cli, *base, "--telemetry", "--out", prov, tag="[models]")
    run_cli(cli, *base, "--synergy", "2.0", "--out", syn, tag="[models]")
    runs = {
        "logistic": (prov, "--model", "logistic"),
        "mlp": (prov, "--model", "mlp", "--hidden", "64"),
        "mlp_telemetry": (prov, "--model", "mlp", "--telemetry"),
        "synergy_logistic": (syn, "--model", "logistic"),
        "synergy_mlp": (syn, "--model", "mlp", "--hidden", "64"),
    }
    heads = {}
    for name, (path, *argv) in runs.items():
        got = run_cli(cli, "train", "--csv", path, *argv, tag="[models]")
        heads[name] = got
        nums = [got["train_nll"], got["eval_logloss"], got["eval_accuracy"]]
        if not all(v is not None and np.isfinite(v) for v in nums):
            raise AssertionError(f"[models] {name}: a non-finite loss: {got}")
        log(f"[models] {name}: features {got['phases']['features']:.3f} s, train "
            f"{got['phases']['train']:.3f} s; eval log-loss {got['eval_logloss']} "
            f"(baseline {got['baseline_rating_only']['logloss']}), accuracy "
            f"{got['eval_accuracy']}, auc {got['eval_auc']}, ece {got['eval_ece']}")
    acc = heads["mlp_telemetry"]["eval_accuracy"]
    if not acc > TELEMETRY_MIN_ACC:
        raise AssertionError(f"[models] telemetry MLP eval accuracy {acc} <= "
                             f"{TELEMETRY_MIN_ACC}")
    for name in ("synergy_logistic", "synergy_mlp"):
        h = heads[name]
        if not h["eval_logloss"] < h["baseline_rating_only"]["logloss"]:
            raise AssertionError(f"[models] {name} does not beat the rating "
                                 f"baseline: {h['eval_logloss']} vs "
                                 f"{h['baseline_rating_only']['logloss']}")
    return heads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matches", type=int, default=N_MATCHES)
    ap.add_argument("--players", type=int, default=N_PLAYERS)
    ap.add_argument("--db-matches", type=int, default=DB_MATCHES)
    ap.add_argument("--worker-matches", type=int, default=WORKER_MATCHES)
    ap.add_argument("--bench-matches", type=int, default=BENCH_MATCHES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2

    from analyzer_tpu_torch import cli
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.core.fused import _window_plain
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.experiments import window_timing
    from analyzer_tpu_torch.io.checkpoint import load_checkpoint
    from analyzer_tpu_torch.io.csv_codec import save_stream_npz
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
    from analyzer_tpu_torch.kernels import fused_window as fw
    from analyzer_tpu_torch.kernels import row_scatter as rs
    from analyzer_tpu_torch.obs import get_registry, reset_registry, reset_tracer
    from analyzer_tpu_torch.sched import _native, pack_schedule, rate_history, rate_stream
    from analyzer_tpu_torch.serve import ViewPublisher
    from analyzer_tpu_torch.sched.feed import stage_chunk_fused
    from analyzer_tpu_torch.sched.residency import resolve_fuse
    from analyzer_tpu_torch.io import _native_csv
    from analyzer_tpu_torch.service import _native_sql
    from analyzer_tpu_torch.utils.profiling import trace

    dev = torch.device("cuda")
    cfg = RatingConfig()

    # -- 1. device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {kind} x{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)

    # -- 2. build (nvcc and g++ started together) ---------------------------
    build_all((("nvcc fused_window", fw.load), ("nvcc row_scatter", rs.load),
               ("g++ packer", _native.load), ("g++ fastsql", _native_sql.load),
               ("g++ fastcsv", _native_csv.load)))
    for name, mod in (("fused_window", fw), ("row_scatter", rs)):
        for line in mod.kernel_build_log().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas {name}: {line.strip()}")

    # -- 3. scatter ----------------------------------------------------------
    scatter = scatter_phase(dev)

    # -- the north-star history --------------------------------------------
    t0 = time.perf_counter()
    players = synthetic_players(args.players, seed=SEED)
    stream = synthetic_stream(
        args.matches, players, seed=SEED,
        activity_concentration=0.8, max_activity_share=1e-4,
    )
    del players
    n_players = int(stream.player_idx.max()) + 1  # as cli rate sizes the table
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    state0 = PlayerState.create(n_players, cfg=cfg, device=dev)
    torch.cuda.synchronize()
    t_state = time.perf_counter() - t0
    t0 = time.perf_counter()
    sched = pack_schedule(stream, pad_row=state0.pad_row, windowed=True)
    t_pack = time.perf_counter() - t0
    log(f"[data] {args.matches} matches / {n_players} players: generate {t_gen:.2f} s, "
        f"state {t_state:.2f} s, pack {t_pack:.2f} s -> {sched.n_steps} steps "
        f"x B={sched.batch_size}, occupancy {sched.occupancy:.4f}")

    # -- 4. kernel vs plain at full width -----------------------------------
    fuse = resolve_fuse("fused")
    chunk = stage_chunk_fused(sched, 0, PREFIX_STEPS, fuse, True, True)
    views = chunk.slab.to_device(dev)
    # The first windows of the schedule; where none of them was cut short
    # (a small rehearsal history), the first window with an inert tail too.
    picked = chunk.windows[:N_CHECK_WINDOWS]
    tails = [w for w in chunk.windows if w.n_steps < fuse.window]
    if tails and all(w.n_steps == fuse.window for w in picked):
        picked = picked[:-1] + tails[:1]
    windows = []
    for win in picked:
        slot_rows, slot_idx, winner, mode_id, afk = (views[i] for i in win[:5])
        ws = state0.table.index_select(0, slot_rows.long())
        windows.append((ws, slot_idx, winner, mode_id, afk, win.n_steps))
    worst_rel = 0.0
    worst_abs = 0.0
    for ws, slot_idx, winner, mode_id, afk, n_real in windows:
        ws_p, ys_p = _window_plain(ws.clone(), slot_idx, winner, mode_id, afk, cfg, True)
        a_p, y_p = ws_p.cpu().numpy(), ys_p.cpu().numpy()
        for cluster in (8, 16):
            ws_k, ys_k = fw.fused_window(ws.clone(), slot_idx, winner, mode_id, afk,
                                         cfg, True, n_steps=n_real, cluster=cluster)
            torch.cuda.synchronize()
            a_k, y_k = ws_k.cpu().numpy(), ys_k.cpu().numpy()
            if not np.array_equal(np.isnan(a_p), np.isnan(a_k)):
                raise AssertionError("kernel working set NaN pattern differs from plain")
            if not np.array_equal(np.isnan(y_p), np.isnan(y_k)):
                raise AssertionError("kernel outputs NaN pattern differs from plain")
            if not np.array_equal(y_p[..., 1:3], y_k[..., 1:3]):
                raise AssertionError("kernel gates (any_afk, updated) differ from plain")
            worst_rel = max(worst_rel, rel_err(a_k, a_p), rel_err(y_k, y_p))
            worst_abs = max(worst_abs, float(np.nanmax(np.abs(a_k - a_p))),
                            float(np.nanmax(np.abs(y_k - y_p))))
    real_steps = [w[5] for w in windows]
    if min(real_steps) >= fuse.window and args.matches >= N_MATCHES:
        raise AssertionError("no checked window has an inert tail")
    log(f"[kernel-vs-plain] {len(windows)} windows (K={fuse.window}, "
        f"B={sched.batch_size}, T={sched.team_size}, spills in prefix "
        f"{chunk.stats['spills']}, real steps {real_steps}, the rest an inert "
        f"tail), clusters of 8 and 16 CTAs, collect on: max rel err "
        f"{worst_rel:.3e} (tol {KERNEL_RTOL:g}), max abs err {worst_abs:.3e}")
    if worst_rel > KERNEL_RTOL:
        raise AssertionError(f"kernel vs plain error {worst_rel} > {KERNEL_RTOL}")

    prefix = {}
    for w in (1, 4, 16, 16):
        st, _ = rate_history(
            state0, sched, cfg, kernel="fused", fuse_window=w,
            stop_after=PREFIX_STEPS, steps_per_chunk=PREFIX_STEPS,
        )
        if w in prefix and not same_bits(prefix[w], st.table):
            raise AssertionError("two kernel runs at window 16 differ")
        prefix.setdefault(w, st.table)
    for w in (1, 4):
        if not same_bits(prefix[w], prefix[16]):
            raise AssertionError(f"kernel at window {w} differs from window 16")
    log(f"[kernel-vs-plain] first {PREFIX_STEPS} steps: windows 1/4/16 and a "
        "repeat at 16 give bit-identical tables")
    del prefix

    # -- 5. the main path at full size, spans on, under the profiler --------
    fw.launches = 0
    stats: dict = {}
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    tracer = reset_tracer()
    counters0 = feed_counters()
    cap_main = tempfile.mkdtemp(prefix="chip_smoke_main_prof_")
    with trace(cap_main):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u0 = tracer_us(tracer)
        ev0.record()
        fused_state, _ = rate_history(state0, sched, cfg, kernel="fused",
                                      stats_out=stats)
        ev1.record()
        torch.cuda.synchronize()
        t_fused = time.perf_counter() - t0
        u1 = tracer_us(tracer)
    launches = fw.launches
    dev_ms = ev0.elapsed_time(ev1)
    table = fused_state.table[:n_players]
    rated = ~torch.isnan(table[:, 0])
    n_rated = int(rated.sum())
    ratings = table[:, :14]
    if launches == 0 or launches != stats["windows"]:
        raise AssertionError(
            f"fused_window launched {launches} times for {stats['windows']} windows"
        )
    if n_rated == 0 or bool(torch.isinf(ratings).any()):
        raise AssertionError("no player rated, or a rating is infinite")
    if bool(torch.isnan(table[rated][:, [0, 7]]).any()):
        raise AssertionError("a rated player has a NaN shared mu/sigma")
    log(f"[main] rate_history(kernel='fused'): wall {t_fused:.3f} s, device span "
        f"{dev_ms / 1e3:.3f} s, {sched.n_matches / t_fused:,.0f} matches/s; "
        f"windows {stats['windows']}, spills {stats['spills']}, pad steps "
        f"{stats['pad_steps']}, working set high-water {stats['working_set_rows']} "
        f"rows; fused_window launches {launches}; players rated {n_rated}")
    del table, rated, ratings, fused_state
    log(f"[main] the wall above was taken under torch.profiler (CPU + CUDA) with "
        f"spans on; unprofiled on this card (PERF.md): "
        f"{MAIN_UNPROFILED_S[0]} / {MAIN_UNPROFILED_S[1]} s")
    log(runner_split("[main]", tracer, u0, u1, counters0))
    main_att = attribution("[main]", cap_main)
    main_fused = fused_row(main_att)
    if main_fused is None:
        raise AssertionError("[main]: fused_window is not in the capture's kernel table")
    log(f"[main] fused_window in the attribution: {main_fused['count']} launches "
        f"(counted {launches}), {main_fused['total_us'] / 1e6:.4f} s device time, "
        f"{main_fused['total_us'] / 1e3 / main_fused['count']:.5f} ms per launch; "
        f"CUDA events x launches in [timing]")
    shutil.rmtree(cap_main, ignore_errors=True)

    # The reference kernel (plain PyTorch on the card) over the first
    # twentieth of the schedule (a tenth until the [db] and [worker] phases
    # needed the time), against the fused path over the same steps.
    ref_steps = min(sched.n_steps, max(PREFIX_STEPS, sched.n_steps // 20))
    pre = {}
    for kernel in ("reference", "fused"):
        t0 = time.perf_counter()
        st, _ = rate_history(state0, sched, cfg, kernel=kernel,
                             stop_after=ref_steps, steps_per_chunk=ref_steps)
        torch.cuda.synchronize()
        pre[kernel] = (st.table.cpu().numpy(), time.perf_counter() - t0)
        del st
    a_r, t_ref = pre["reference"]
    a_p = pre["fused"][0]
    if not np.array_equal(np.isnan(a_p), np.isnan(a_r)):
        raise AssertionError("fused vs reference NaN pattern differs")
    path_rel = rel_err(a_p, a_r)
    log(f"[main] first {ref_steps} of {sched.n_steps} steps, "
        f"rate_history(kernel='reference') on the card: wall {t_ref:.3f} s "
        f"(fused over the same steps {pre['fused'][1]:.3f} s); fused vs "
        f"reference: NaN pattern equal, bit-identical "
        f"{np.array_equal(a_p, a_r, equal_nan=True)}, max rel err {path_rel:.3e} "
        f"(tol {PATH_RTOL:g})")
    if path_rel > PATH_RTOL:
        raise AssertionError(f"fused vs reference error {path_rel} > {PATH_RTOL}")
    del a_p, pre

    # -- the prefix the re-running phases use ------------------------------
    pre = stream.slice(0, min(CLI_PREFIX_MATCHES, stream.n_matches))
    pre_sched = pack_schedule(pre, pad_row=state0.pad_row, windowed=True)
    fw.launches = 0
    p_stats: dict = {}
    tracer = reset_tracer()
    counters0 = feed_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u0 = tracer_us(tracer)
    pre_state, _ = rate_history(state0, pre_sched, cfg, kernel="fused", stats_out=p_stats)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    u1 = tracer_us(tracer)
    a_pre = pre_state.table.cpu().numpy()
    del pre_state
    if fw.launches == 0 or fw.launches != p_stats["windows"]:
        raise AssertionError(f"prefix run: {fw.launches} launches for {p_stats['windows']} windows")
    pre_mu = a_pre[:, 0]
    pre_rated = int((~np.isnan(pre_mu)).sum())
    pre_mean_mu = round(float(pre_mu[~np.isnan(pre_mu)].mean()), 2)
    log(f"[prefix] first {pre.n_matches} matches: rate_history(kernel='fused') "
        f"{t_pre:.3f} s, {pre_sched.n_steps} steps, windows {p_stats['windows']}, "
        f"fused_window launches {fw.launches}; players rated {pre_rated}")
    log(runner_split("[prefix]", tracer, u0, u1, counters0))

    # -- 6. the streamed feed (on the prefix) -------------------------------
    fw.launches = 0
    s_stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream_state, _ = rate_stream(state0, pre, cfg, kernel="fused", stats_out=s_stats)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    s_launches = fw.launches
    same = np.array_equal(stream_state.table.cpu().numpy(), a_pre, equal_nan=True)
    del stream_state
    log(f"[stream] rate_stream(kernel='fused') on the first {pre.n_matches} matches: "
        f"wall {t_stream:.3f} s, "
        f"{pre.n_matches / t_stream:,.0f} matches/s; n_steps {s_stats['n_steps']} "
        f"x B={s_stats['batch_size']}, occupancy {s_stats['occupancy']:.4f}, choose "
        f"batch size {s_stats['choose_batch_size_s']:.3f} s; windows {s_stats['windows']}, "
        f"spills {s_stats['spills']}; fused_window launches {s_launches}; table "
        f"bit-identical to rate_history(kernel='fused') on the prefix: {same}")
    if s_launches == 0 or s_launches != s_stats["windows"]:
        raise AssertionError(
            f"rate_stream launched fused_window {s_launches} times for "
            f"{s_stats['windows']} windows"
        )
    if not same:
        raise AssertionError("rate_stream's table differs from rate_history's")

    # -- 6a. the data-parallel mesh and the sharded serve plane -------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        mesh_counts = mesh_phase(dev, cfg, state0, stream, pre, pre_sched, a_pre, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 7. the tiered table ---------------------------------------------------
    full = args.players >= N_PLAYERS
    tier_hot = TIER_HOT_ROWS if full else TIER_HOT_ROWS // 8
    thrash_hot = THRASH_HOT_ROWS if full else THRASH_HOT_ROWS // 4
    pub = ViewPublisher()  # device=None: the card
    reset_registry()
    fw.launches = 0
    t_stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tier_state, _ = rate_history(
        state0, pre_sched, cfg, kernel="fused", hot_rows=tier_hot,
        view_publisher=pub, stats_out=t_stats,
    )
    torch.cuda.synchronize()
    t_tier = time.perf_counter() - t0
    tier_launches = fw.launches
    tc = tier_counters()
    reg = get_registry().snapshot()
    same = np.array_equal(tier_state.table.cpu().numpy(), a_pre, equal_nan=True)
    log(f"[tier] rate_history(kernel='fused', hot_rows={tier_hot}, "
        f"view_publisher=pub) on the first {pre.n_matches} matches: wall "
        f"{t_tier:.3f} s, {pre.n_matches / t_tier:,.0f} matches/s "
        f"({t_tier / t_pre:.2f}x the untiered prefix's wall); hits {tc['hits']}, "
        f"misses {tc['misses']} (hit rate "
        f"{tc['hits'] / max(tc['hits'] + tc['misses'], 1):.4f}), promotions "
        f"{tc['promotions']}, demotions {tc['demotions']}, dirty writebacks "
        f"{tc['dirty_writebacks']}, spills {tc['spills']}; hot set "
        f"{reg['gauges']['tier.hot_rows']} rows, cold tier "
        f"{reg['gauges']['tier.host_bytes']} host bytes (pinned); windows "
        f"{t_stats['windows']}, fused_window launches {tier_launches}; views "
        f"published {pub.version}, "
        f"{int(reg['counters']['serve.view_publish_bytes_total'])} bytes to the "
        f"device; table bit-identical to the untiered fused prefix: {same}")
    if tier_launches == 0 or tier_launches != t_stats["windows"]:
        raise AssertionError(
            f"the tiered run launched fused_window {tier_launches} times for "
            f"{t_stats['windows']} windows")
    if not same:
        raise AssertionError("the tiered table differs from the untiered one")
    if tc["misses"] == 0 or tc["demotions"] == 0:
        raise AssertionError("the tiered run never paged: the hot set held everything")

    reset_registry()
    t0 = time.perf_counter()
    thrash, _ = rate_history(
        state0, sched, cfg, kernel="reference", hot_rows=thrash_hot,
        stop_after=ref_steps, steps_per_chunk=256,
    )
    torch.cuda.synchronize()
    t_thrash = time.perf_counter() - t0
    tc = tier_counters()
    same = np.array_equal(thrash.table.cpu().numpy(), a_r, equal_nan=True)
    del thrash, a_r
    log(f"[tier] thrashing: first {ref_steps} steps, kernel='reference', "
        f"hot_rows={thrash_hot}, chunks of 256 steps: wall {t_thrash:.3f} s "
        f"({t_thrash / t_ref:.2f}x the untiered prefix); hits {tc['hits']}, "
        f"misses {tc['misses']} (hit rate "
        f"{tc['hits'] / max(tc['hits'] + tc['misses'], 1):.4f}), demotions "
        f"{tc['demotions']}, dirty writebacks {tc['dirty_writebacks']}, spills "
        f"{tc['spills']}; table bit-identical to the untiered prefix: {same}")
    if not same or tc["spills"] == 0:
        raise AssertionError("the thrashing tiered prefix differs, or never split a chunk")

    # -- 8. the serve plane ----------------------------------------------------
    serve_phase(cfg, pub, tier_state, n_players)
    del tier_state, pub

    # -- 9. the command line ------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        pre_path = os.path.join(tmp, "prefix.npz")
        save_stream_npz(pre_path, pre)
        fw.launches = 0
        reset_registry()
        reset_tracer()
        cap_cli = os.path.join(tmp, "cli_prof")
        m_json, t_jsonl = os.path.join(tmp, "m.json"), os.path.join(tmp, "t.jsonl")
        got = run_cli(cli, "rate", "--csv", pre_path, "--kernel", "fused",
                      "--trace", cap_cli, "--metrics-out", m_json,
                      "--trace-events", t_jsonl)
        c_launches = fw.launches
        if c_launches == 0:
            raise AssertionError("cli rate never launched fused_window")
        if (got["players_rated"], got["mean_mu"]) != (pre_rated, pre_mean_mu):
            raise AssertionError(
                f"cli rate: players_rated {got['players_rated']}, mean_mu "
                f"{got['mean_mu']}; rate_history on the prefix: {pre_rated}, "
                f"{pre_mean_mu}"
            )
        log(f"[cli] streamed rate of the first {pre.n_matches} matches agrees with "
            f"rate_history on the prefix: players_rated {pre_rated}, mean_mu "
            f"{pre_mean_mu}; fused_window launches {c_launches}")
        cli_obs_phase(m_json, t_jsonl, cap_cli, c_launches)
        log(f"[cli] profiler cost on the fused path: the profiled run's rate phase "
            f"{got['phases']['rate']:.3f} s (capture export included) against "
            f"[stream]'s unprofiled rate_stream {t_stream:.3f} s over the same "
            f"matches: {100 * (got['phases']['rate'] / t_stream - 1):+.1f}%")
        cli_obs_port_phase(cli, pre_path, os.path.join(tmp, "obs.npz"), a_pre)

        pre_steps = pack_schedule(
            pre, pad_row=int(pre.player_idx.max()) + 1, windowed=True
        ).n_steps
        stop, every = max(1, pre_steps // 2), max(1, pre_steps // 5)
        ck_a, ck_b = os.path.join(tmp, "killed.npz"), os.path.join(tmp, "oneshot.npz")
        fw.launches = 0
        run_cli(cli, "rate", "--csv", pre_path, "--kernel", "fused",
                "--checkpoint", ck_a, "--checkpoint-every", str(every),
                "--stop-after-steps", str(stop))
        mid = load_checkpoint(ck_a, device="cpu")
        if mid.step_cursor < stop or not mid.schedule_fingerprint:
            raise AssertionError(f"bounded run saved step {mid.step_cursor} < {stop}")
        run_cli(cli, "rate", "--csv", pre_path, "--kernel", "fused",
                "--checkpoint", ck_a, "--resume")
        run_cli(cli, "rate", "--csv", pre_path, "--kernel", "fused",
                "--checkpoint", ck_b)
        k_launches = fw.launches
        a, b = load_checkpoint(ck_a, device="cpu"), load_checkpoint(ck_b, device="cpu")
        same = np.array_equal(a.state.table.numpy(), b.state.table.numpy(), equal_nan=True)
        log(f"[cli] kill-and-resume on {pre.n_matches} matches / "
            f"{a.state.n_players} players: {pre_steps} steps, killed at step "
            f"{mid.step_cursor} (every {every}), resumed to cursor {a.cursor}; "
            f"final table bit-identical to the one-shot run: {same}; "
            f"fused_window launches {k_launches}")
        if not same or a.cursor != pre.n_matches or a.step_cursor != 0 or k_launches == 0:
            raise AssertionError("kill-and-resume differs from the one-shot run")
        ck_c = os.path.join(tmp, "tiered.npz")
        run_cli(cli, "rate", "--csv", pre_path, "--kernel", "fused",
                "--checkpoint", ck_c, "--hot-rows", str(thrash_hot))
        c = load_checkpoint(ck_c, device="cpu")
        same = np.array_equal(c.state.table.numpy(), b.state.table.numpy(), equal_nan=True)
        log(f"[cli] rate --hot-rows {thrash_hot} on the same prefix: "
            f"checkpoint table bit-identical to the untiered one-shot run: {same}")
        if not same:
            raise AssertionError("cli rate --hot-rows differs from the untiered run")

        # -- 10. serve over HTTP, from the checkpoint cli rate wrote ----------
        http_phase(cli, dev, cfg, ck_b)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 11. the object API -------------------------------------------------
    rater_phase(dev, cfg)

    # -- 12-13. the DB round trip and the service loop ----------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_db_")
    try:
        db_counts = db_phase(cli, tmp, dev, args.db_matches)
        worker_counts = worker_phase(cli, tmp, dev, args.worker_matches)
        # -- 13a. the live obs planes, on [worker]'s fixture ---------------
        t0 = time.perf_counter()
        planes_phase(cli, dev, *worker_counts["planes"], os.path.join(tmp, "flight"))
        log(f"[planes] phase wall {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 13b. the model zoo ------------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_models_")
    try:
        models_phase(cli, tmp, dev, sched, n_players, pre)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 14-16. cli bench, the ingest plane, the oracle ----------------------
    bench_counts = bench_phase(args.bench_matches)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    try:
        ingest_phase(tmp, dev, pre)
        # -- 15a. the migration, over [ingest]'s prefix CSV ------------------
        migrate_counts = migrate_phase(cli, tmp, dev, cfg, state0,
                                       os.path.join(tmp, "prefix.csv"), pre,
                                       a_pre, tier_hot)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    oracle_phase(dev, cfg, args.bench_matches)

    # -- 16a. the closed-loop soak ------------------------------------------
    soak_phase(dev)

    # -- 17. kernel times at the main path's shapes (collect off) -------------
    slope = window_timing.measure(windows)
    for n, r in slope["by_steps"].items():
        log(f"[timing] fused_window, first {n:2d} steps of each window looped: "
            f"{r['ms']:.5f} ms per window (events), device {r['device_ms']} ms")
    main_call = slope["skip_tail"]
    cluster = fw.pick_cluster(dev, sched.team_size, sched.batch_size)
    c8 = window_timing.time_windows(windows, fuse.window, "real", cluster=8)
    p_ms, b_ms, n_bytes, n_ops = [], [], 0, 0
    for ws, slot_idx, winner, mode_id, afk, n_real in windows:
        p_ms.append(cuda_ms(
            lambda: _window_plain(ws.clone(), slot_idx, winner, mode_id, afk, cfg, False),
            2,
        ))
        live = int(torch.unique(slot_idx).numel())
        real = int((slot_idx != 0).flatten(2).any(-1).sum())
        w_bytes = 2 * live * 64 + (slot_idx[:n_real].numel() + 3 * winner[:n_real].numel()) * 4
        w_ops = real * OPS_PER_MATCH
        n_bytes, n_ops = n_bytes + w_bytes, n_ops + w_ops
        b_ms.append(1e3 * max(w_bytes / PEAK_BYTES_PER_S, w_ops / PEAK_F32_OPS_PER_S))
    ms, plain_ms, bound_ms = main_call["ms"], float(np.mean(p_ms)), float(np.mean(b_ms))
    bound_by = "bytes" if n_bytes / PEAK_BYTES_PER_S >= n_ops / PEAK_F32_OPS_PER_S else "operations"
    log(f"[timing] fused_window per window (K={fuse.window}, B={sched.batch_size}, "
        f"cluster of {cluster} CTAs, real steps looped, mean "
        f"{slope['real_steps_mean']:.2f}): {ms:.5f} ms (events), device "
        f"{main_call['device_ms']} ms; every step looped {slope['all_steps']['ms']:.5f} ms, "
        f"device {slope['all_steps']['device_ms']} ms; cluster of 8: {c8['ms']:.5f} ms, "
        f"device {c8['device_ms']} ms; per-step slope {slope['slope_ms_per_step']:.5f} ms "
        f"+ {slope['intercept_ms']:.5f} ms per launch (fit of {slope['fit_of']}); plain "
        f"{plain_ms:.4f} ms; bound {bound_ms:.6f} ms ({bound_by}); main-path kernel "
        f"total ~{ms * launches / 1e3:.3f} s over {launches} launches")
    attr_ms = main_fused["total_us"] / 1e3 / main_fused["count"]
    log(f"[timing] fused_window on [main]: CUDA events x launches {ms:.5f} ms x "
        f"{launches} = {ms * launches / 1e3:.4f} s; profiler attribution of the "
        f"[main] capture {attr_ms:.5f} ms x {main_fused['count']} = "
        f"{main_fused['total_us'] / 1e6:.4f} s; capture's whole device busy time "
        f"{main_att['device']['busy_us'] / 1e6:.4f} s")

    log(json.dumps({"kernels": [
        {
            "name": "fused_window",
            "route": "cuda",
            "source": "analyzer_tpu_torch/kernels/csrc/fused_window.cu",
            "replaces": "analyzer_tpu/core/fused.py:129",
            "launches": launches,
            "launches_tiered": tier_launches,
            "launches_db": db_counts["launches_db"],
            "launches_worker_cli": worker_counts["launches_worker_cli"],
            "launches_bench": bench_counts["launches_bench"],
            "launches_migrate": migrate_counts["launches_migrate"],
            "migrate_call_ms": migrate_counts["migrate_call_ms"],
            "launches_migrate_cli": migrate_counts["launches_migrate_cli"],
            "launches_migrate_bench": migrate_counts["launches_migrate_bench"],
            "max_abs_err": worst_abs,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "device_ms": main_call["device_ms"],
            "attribution_ms": attr_ms,
            "attribution_launches": main_fused["count"],
            "all_steps_ms": slope["all_steps"]["ms"],
            "cluster": cluster,
            "cluster8_ms": c8["ms"],
            "slope_ms_per_step": slope["slope_ms_per_step"],
            "intercept_ms": slope["intercept_ms"],
        },
        {
            # On the sharded re-rate's path ([mesh], mode="drop", one launch
            # a superstep), at its shapes; the scatter-floor experiment's
            # numbers under floor_*.
            "name": "row_scatter",
            "route": "cuda",
            "source": "analyzer_tpu_torch/kernels/csrc/row_scatter.cu",
            "replaces": "experiments/scatter_floor.py:90",
            **mesh_counts,
            **{f"floor_{k}": v for k, v in scatter.items()},
        },
    ]}))
    log(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
