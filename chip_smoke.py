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
  2. build: the two CUDA kernels (nvcc) and the host packer (g++), built
     from the checkout's sources in parallel; the native packer must load;
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
     exactly that run (it must equal the windows dispatched); then the
     first tenth of the schedule through ``kernel="reference"`` (plain
     PyTorch on the card) and through the fused path: NaN pattern exact,
     floats within ``PATH_RTOL``;
  6. stream: ``rate_stream(kernel="fused")`` over the same stream must give
     the main path's table bit for bit, through the kernel;
  7. tier: the same schedule through ``rate_history(kernel="fused",
     hot_rows=262144, view_publisher=pub)`` — a hot set of 17% of the
     players over a pinned host tier — with the kernel's launch count taken
     over that run: the table must equal phase 5's bit for bit, and the run
     must have paged; then the first tenth of the schedule at
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
  9. cli: the stream saved as npz, then ``cli rate --kernel fused`` (the
     streamed path) must report the main path's ``players_rated`` and
     ``mean_mu``; on a 1M-match prefix a bounded run with periodic
     checkpoints plus ``--resume`` must equal a one-shot checkpointed run
     bit for bit, and so must ``cli rate --hot-rows``;
 10. serve-http: ``python -m analyzer_tpu_torch.cli serve --checkpoint`` on
     that one-shot checkpoint as a subprocess on the card, queried through
     ``cli query`` for each kind: bodies equal the in-process engine's;
 11. rater: one 3v3 of fresh tier-15 players through ``rater.rate_match``
     on the card: winner shared mu 2052.41, equal to ``rate_and_apply`` on
     the same match;
 12. timing: the fused window per window at the main path's shapes
     (``python -m analyzer_tpu_torch.experiments.window_timing``'s
     measurement: windows cut to 1..16 looped steps for the per-step
     slope, then as the main path calls it, with every step looped, and
     with a cluster of 16), beside its plain version and its bound; then
     one ``{"kernels": [...]}`` line: per kernel its launches on its path
     (the fused window's on the tiered path beside them), the error
     against its plain version, its time at its path's shapes beside the
     plain version's, the library call's and the card's bound, and the
     time of its earlier launch pattern measured in this run (the row
     scatter launched per step; the fused window with its inert tail
     looped).

``--matches``/``--players`` shrink the history for a quick rehearsal on
the card. The last line is ``{"ok": true, "device": {...}}``. Any failed check raises
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

import numpy as np
import torch

N_PLAYERS = 1_500_000
N_MATCHES = 10_000_000
SEED = 42
N_CHECK_WINDOWS = 8
PREFIX_STEPS = 128
# The kill-and-resume drill of the cli phase runs on this prefix of the
# stream (over the whole player table).
CLI_PREFIX_MATCHES = 1_000_000
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


def device_ms(fn, calls: int) -> float | None:
    """Device time per call of the CUDA kernels ``fn()`` launches, summed
    from a ``torch.profiler`` trace; None where the trace holds no device
    events or the profiler fails (the time is then not measured)."""
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
    return sum(us) / calls / 1e3 if us else None


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
        k_dev = device_ms(lambda: sf.run_cuda(table, idx, rows), steps)
        s_dev = device_ms(lambda: sf.run_steps(sf.scatter_cuda, table, idx, rows), steps)
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


def run_cli(cli, *argv) -> dict:
    """``cli.main(argv)`` in this process; its stats line, parsed."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    log(f"[cli] {' '.join(os.path.basename(a) for a in argv)}: {wall:.2f} s -> {lines[-1]}")
    return json.loads(lines[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matches", type=int, default=N_MATCHES)
    ap.add_argument("--players", type=int, default=N_PLAYERS)
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
    from analyzer_tpu_torch.obs import get_registry, reset_registry
    from analyzer_tpu_torch.sched import _native, pack_schedule, rate_history, rate_stream
    from analyzer_tpu_torch.serve import ViewPublisher
    from analyzer_tpu_torch.sched.feed import stage_chunk_fused
    from analyzer_tpu_torch.sched.residency import resolve_fuse

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
               ("g++ packer", _native.load)))
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

    # -- 5. the main path at full size --------------------------------------
    fw.launches = 0
    stats: dict = {}
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev0.record()
    fused_state, _ = rate_history(state0, sched, cfg, kernel="fused", stats_out=stats)
    ev1.record()
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
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
    a_f = fused_state.table.cpu().numpy()
    del table, rated, ratings, fused_state

    # The reference kernel (plain PyTorch on the card) over the first tenth
    # of the schedule, against the fused path over the same steps.
    ref_steps = min(sched.n_steps, max(PREFIX_STEPS, sched.n_steps // 10))
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
    mu = a_f[:n_players, 0]
    main_rated = int((~np.isnan(mu)).sum())
    main_mean_mu = round(float(mu[~np.isnan(mu)].mean()), 2)

    # -- 6. the streamed feed -----------------------------------------------
    fw.launches = 0
    s_stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream_state, _ = rate_stream(state0, stream, cfg, kernel="fused", stats_out=s_stats)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    s_launches = fw.launches
    same = np.array_equal(stream_state.table.cpu().numpy(), a_f, equal_nan=True)
    del stream_state
    log(f"[stream] rate_stream(kernel='fused'): wall {t_stream:.3f} s, "
        f"{stream.n_matches / t_stream:,.0f} matches/s; n_steps {s_stats['n_steps']} "
        f"x B={s_stats['batch_size']}, occupancy {s_stats['occupancy']:.4f}, choose "
        f"batch size {s_stats['choose_batch_size_s']:.3f} s; windows {s_stats['windows']}, "
        f"spills {s_stats['spills']}; fused_window launches {s_launches}; table "
        f"bit-identical to rate_history(kernel='fused'): {same}")
    if s_launches == 0 or s_launches != s_stats["windows"]:
        raise AssertionError(
            f"rate_stream launched fused_window {s_launches} times for "
            f"{s_stats['windows']} windows"
        )
    if not same:
        raise AssertionError("rate_stream's table differs from rate_history's")

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
        state0, sched, cfg, kernel="fused", hot_rows=tier_hot,
        view_publisher=pub, stats_out=t_stats,
    )
    torch.cuda.synchronize()
    t_tier = time.perf_counter() - t0
    tier_launches = fw.launches
    tc = tier_counters()
    reg = get_registry().snapshot()
    same = np.array_equal(tier_state.table.cpu().numpy(), a_f, equal_nan=True)
    log(f"[tier] rate_history(kernel='fused', hot_rows={tier_hot}, "
        f"view_publisher=pub): wall {t_tier:.3f} s, "
        f"{sched.n_matches / t_tier:,.0f} matches/s ({t_tier / t_fused:.2f}x the "
        f"untiered wall); hits {tc['hits']}, misses {tc['misses']} (hit rate "
        f"{tc['hits'] / max(tc['hits'] + tc['misses'], 1):.4f}), promotions "
        f"{tc['promotions']}, demotions {tc['demotions']}, dirty writebacks "
        f"{tc['dirty_writebacks']}, spills {tc['spills']}; hot set "
        f"{reg['gauges']['tier.hot_rows']} rows, cold tier "
        f"{reg['gauges']['tier.host_bytes']} host bytes (pinned); windows "
        f"{t_stats['windows']}, fused_window launches {tier_launches}; views "
        f"published {pub.version}, "
        f"{int(reg['counters']['serve.view_publish_bytes_total'])} bytes to the "
        f"device; table bit-identical to [main]'s untiered fused table: {same}")
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
        path = os.path.join(tmp, "stream.npz")
        save_stream_npz(path, stream)
        fw.launches = 0
        got = run_cli(cli, "rate", "--csv", path, "--kernel", "fused")
        c_launches = fw.launches
        if c_launches == 0:
            raise AssertionError("cli rate never launched fused_window")
        if (got["players_rated"], got["mean_mu"]) != (main_rated, main_mean_mu):
            raise AssertionError(
                f"cli rate: players_rated {got['players_rated']}, mean_mu "
                f"{got['mean_mu']}; the main path: {main_rated}, {main_mean_mu}"
            )
        log(f"[cli] streamed rate agrees with the main path: players_rated "
            f"{main_rated}, mean_mu {main_mean_mu}; fused_window launches {c_launches}")

        pre = stream.slice(0, min(CLI_PREFIX_MATCHES, stream.n_matches))
        pre_path = os.path.join(tmp, "prefix.npz")
        save_stream_npz(pre_path, pre)
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

    # -- 12. kernel times at the main path's shapes (collect off) -------------
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

    log(json.dumps({"kernels": [
        {
            "name": "fused_window",
            "route": "cuda",
            "source": "analyzer_tpu_torch/kernels/csrc/fused_window.cu",
            "replaces": "analyzer_tpu/core/fused.py:129",
            "launches": launches,
            "launches_tiered": tier_launches,
            "max_abs_err": worst_abs,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "device_ms": main_call["device_ms"],
            "all_steps_ms": slope["all_steps"]["ms"],
            "cluster": cluster,
            "cluster8_ms": c8["ms"],
            "slope_ms_per_step": slope["slope_ms_per_step"],
            "intercept_ms": slope["intercept_ms"],
        },
        {
            "name": "row_scatter",
            "route": "cuda",
            "source": "analyzer_tpu_torch/kernels/csrc/row_scatter.cu",
            "replaces": "experiments/scatter_floor.py:90",
            **scatter,
        },
    ]}))
    log(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
