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
     counted over it; then S steps (400 at W=16, 50 at W=128) through the
     kernel and through ``index_copy_`` from the same starting table must
     give bit-identical tables, and both are timed per step;
  4. kernel vs plain at full width: the first 8 fused windows of the
     schedule through the fused-window kernel and its plain PyTorch
     version on the same CUDA inputs (gates and NaN pattern exact, floats
     within ``KERNEL_RTOL``); then the same history prefix through the
     kernel at fuse windows 1, 4 and 16, and twice at 16, must give
     bit-identical tables;
  5. main: ``pack_schedule(windowed=True)`` + ``rate_history(kernel=
     "fused")`` at full size, with the kernel's launch count taken over
     exactly that run (it must equal the windows dispatched), then the same
     history through ``kernel="reference"`` (plain PyTorch on the card):
     NaN pattern exact, floats within ``PATH_RTOL``;
  6. stream: ``rate_stream(kernel="fused")`` over the same stream must give
     the main path's table bit for bit, through the kernel;
  7. cli: the stream saved as npz, then ``cli rate --kernel fused`` (the
     streamed path) must report the main path's ``players_rated`` and
     ``mean_mu``; on a 1M-match prefix a bounded run with periodic
     checkpoints plus ``--resume`` must equal a one-shot checkpointed run
     bit for bit;
  8. one ``{"kernels": [...]}`` line: per kernel its launches on its path,
     the error against its plain version, its time at its path's shapes
     beside the plain version's, the library call's and the card's bound.

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
    kernel, then the kernel against index_copy_ at each width."""
    from analyzer_tpu_torch.experiments import scatter_floor as sf
    from analyzer_tpu_torch.kernels import row_scatter as rs

    rs.launches = 0
    sf.main([])
    launches = rs.launches
    if launches == 0:
        raise AssertionError("the scatter-floor experiment never launched row_scatter")
    log(f"[scatter] experiment: row_scatter launches {launches}")
    out = {"launches": launches, "max_abs_err": 0.0}
    for w in (16, 128):
        steps = sf.STEPS[w]
        idx_np, rows_np = sf.make_xs(steps, w, np.random.default_rng(SEED))
        idx = torch.from_numpy(idx_np).to(dev)
        idx64 = idx.long()
        rows = torch.from_numpy(rows_np).to(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        table0 = torch.rand((sf.P, w), generator=gen, device=dev)
        got = sf.run_steps(sf.scatter_cuda, table0.clone(), idx, rows)
        want = sf.run_steps(rs.row_scatter_plain, table0.clone(), idx, rows)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"row_scatter at W={w} differs from index_copy_ (max abs {err})")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        del got, want
        table = table0.clone()
        ms = cuda_ms(lambda: sf.run_steps(sf.scatter_cuda, table, idx, rows), 5) / steps
        plain_ms = cuda_ms(
            lambda: sf.run_steps(rs.row_scatter_plain, table, idx, rows), 5) / steps
        library_ms = cuda_ms(
            lambda: sf.run_steps(sf.scatter_torch, table, idx64, rows), 5) / steps
        # The same runs' device time alone, without the host's launch gaps.
        k_dev = device_ms(lambda: sf.run_steps(sf.scatter_cuda, table, idx, rows), steps)
        l_dev = device_ms(lambda: sf.run_steps(sf.scatter_torch, table, idx64, rows), steps)
        n_bytes = 2 * sf.R * w * 4 + sf.R * 4  # rows in, rows out, indices in
        bound_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
        key = "" if w == 16 else f"_w{w}"
        out.update({f"ms{key}": ms, f"plain_ms{key}": plain_ms,
                    f"library_ms{key}": library_ms, f"bound_ms{key}": bound_ms,
                    f"bound_by{key}": "bytes", f"device_ms{key}": k_dev,
                    f"library_device_ms{key}": l_dev})
        log(f"[scatter] W={w}: {steps} steps, kernel vs index_copy_ bit-identical "
            f"(max abs err {err:g}); per step kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
            f"index_copy_ {library_ms:.5f} ms, bound {bound_ms:.6f} ms (bytes, "
            f"{n_bytes} B); kernel at {100 * bound_ms / ms:.1f}% of the bound; "
            f"device time per step (profiler): kernel {k_dev} ms, index_copy_ {l_dev} ms")
        del table, table0, rows, idx, idx64
    return out


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
    from analyzer_tpu_torch.io.checkpoint import load_checkpoint
    from analyzer_tpu_torch.io.csv_codec import save_stream_npz
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
    from analyzer_tpu_torch.kernels import fused_window as fw
    from analyzer_tpu_torch.kernels import row_scatter as rs
    from analyzer_tpu_torch.sched import _native, pack_schedule, rate_history, rate_stream
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
    windows = []
    for parts in chunk.windows[:N_CHECK_WINDOWS]:
        slot_rows, slot_idx, winner, mode_id, afk = (views[i] for i in parts)
        ws = state0.table.index_select(0, slot_rows.long())
        windows.append((ws, slot_idx, winner, mode_id, afk))
    worst_rel = 0.0
    worst_abs = 0.0
    for ws, slot_idx, winner, mode_id, afk in windows:
        ws_p, ys_p = _window_plain(ws.clone(), slot_idx, winner, mode_id, afk, cfg, True)
        ws_k, ys_k = fw.fused_window(ws.clone(), slot_idx, winner, mode_id, afk, cfg, True)
        torch.cuda.synchronize()
        a_p, a_k = ws_p.cpu().numpy(), ws_k.cpu().numpy()
        y_p, y_k = ys_p.cpu().numpy(), ys_k.cpu().numpy()
        if not np.array_equal(np.isnan(a_p), np.isnan(a_k)):
            raise AssertionError("kernel working set NaN pattern differs from plain")
        if not np.array_equal(np.isnan(y_p), np.isnan(y_k)):
            raise AssertionError("kernel outputs NaN pattern differs from plain")
        if not np.array_equal(y_p[..., 1:3], y_k[..., 1:3]):
            raise AssertionError("kernel gates (any_afk, updated) differ from plain")
        worst_rel = max(worst_rel, rel_err(a_k, a_p), rel_err(y_k, y_p))
        worst_abs = max(worst_abs, float(np.nanmax(np.abs(a_k - a_p))),
                        float(np.nanmax(np.abs(y_k - y_p))))
    log(f"[kernel-vs-plain] {len(windows)} windows (K={fuse.window}, "
        f"B={sched.batch_size}, T={sched.team_size}, spills in prefix "
        f"{chunk.stats['spills']}): max rel err {worst_rel:.3e} "
        f"(tol {KERNEL_RTOL:g}), max abs err {worst_abs:.3e}")
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

    t0 = time.perf_counter()
    ref_state, _ = rate_history(state0, sched, cfg, kernel="reference")
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    a_r = ref_state.table.cpu().numpy()
    if not np.array_equal(np.isnan(a_f), np.isnan(a_r)):
        raise AssertionError("fused vs reference NaN pattern differs")
    path_rel = rel_err(a_f, a_r)
    log(f"[main] rate_history(kernel='reference') on the card: wall {t_ref:.3f} s; "
        f"fused vs reference: NaN pattern equal, bit-identical "
        f"{np.array_equal(a_f, a_r, equal_nan=True)}, max rel err {path_rel:.3e} "
        f"(tol {PATH_RTOL:g})")
    if path_rel > PATH_RTOL:
        raise AssertionError(f"fused vs reference error {path_rel} > {PATH_RTOL}")
    del a_r, ref_state
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

    # -- 7. the command line ------------------------------------------------
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 8. kernel times at the main path's shapes (collect off) -------------
    k_ms, p_ms, b_ms, n_bytes, n_ops = [], [], [], 0, 0
    for ws, slot_idx, winner, mode_id, afk in windows:
        reps = 20
        clones = [ws.clone() for _ in range(reps + 1)]
        it = iter(clones)
        k_ms.append(cuda_ms(
            lambda: fw.fused_window(next(it), slot_idx, winner, mode_id, afk, cfg, False),
            reps,
        ))
        p_ms.append(cuda_ms(
            lambda: _window_plain(ws.clone(), slot_idx, winner, mode_id, afk, cfg, False),
            2,
        ))
        live = int(torch.unique(slot_idx).numel())
        real = int((slot_idx != 0).flatten(2).any(-1).sum())
        w_bytes = 2 * live * 64 + slot_idx.numel() * 4 + 3 * winner.numel() * 4
        w_ops = real * OPS_PER_MATCH
        n_bytes, n_ops = n_bytes + w_bytes, n_ops + w_ops
        b_ms.append(1e3 * max(w_bytes / PEAK_BYTES_PER_S, w_ops / PEAK_F32_OPS_PER_S))
    ms, plain_ms, bound_ms = (float(np.mean(x)) for x in (k_ms, p_ms, b_ms))
    bound_by = "bytes" if n_bytes / PEAK_BYTES_PER_S >= n_ops / PEAK_F32_OPS_PER_S else "operations"
    log(f"[timing] fused_window per window (K={fuse.window}, B={sched.batch_size}): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}); main-path kernel total ~{ms * launches / 1e3:.3f} s "
        f"over {launches} launches")

    log(json.dumps({"kernels": [
        {
            "name": "fused_window",
            "route": "cuda",
            "source": "analyzer_tpu_torch/kernels/csrc/fused_window.cu",
            "replaces": "analyzer_tpu/core/fused.py:129",
            "launches": launches,
            "max_abs_err": worst_abs,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
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
