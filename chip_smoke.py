#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``analyzer_tpu_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main path — the full-history TrueSkill re-rate of the
north-star configuration (10M synthetic matches, 1.5M players; bench.py's
defaults ``activity_concentration=0.8``, ``max_activity_share=1e-4``,
seed 42) — through the entry points a user calls: ``PlayerState.create``
on ``cuda``, ``pack_schedule(windowed=True)`` and
``rate_history(kernel="fused")``. Phases, each printing its own lines:

  1. device: the card's name and power limit;
  2. build: the CUDA kernel (nvcc) and the host packer (g++), built from the
     checkout's sources in parallel; the native packer must load;
  3. kernel vs plain at full width: the first 8 fused windows of the
     schedule through the CUDA kernel and its plain PyTorch version on the
     same CUDA inputs (gates and NaN pattern exact, floats within
     ``KERNEL_RTOL``); then the same history prefix through the kernel at
     fuse windows 1, 4 and 16, and twice at 16, must give bit-identical
     tables;
  4. the main path at full size, with the kernel's launch count taken over
     exactly that run (it must equal the windows dispatched), then the same
     history through ``kernel="reference"`` (plain PyTorch on the card):
     NaN pattern exact, floats within ``PATH_RTOL``;
  5. one ``{"kernels": [...]}`` line: per kernel its launches on the main
     path, the error against its plain version, its time per window at the
     main path's shapes beside the plain version's and the card's bound.

``--matches``/``--players`` shrink the history for a quick rehearsal on
the card. The last line is ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero without that line; so does a machine without
a visible CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

N_PLAYERS = 1_500_000
N_MATCHES = 10_000_000
SEED = 42
N_CHECK_WINDOWS = 8
PREFIX_STEPS = 128

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matches", type=int, default=N_MATCHES)
    ap.add_argument("--players", type=int, default=N_PLAYERS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2

    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.core.fused import _window_plain
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
    from analyzer_tpu_torch.kernels import fused_window as fw
    from analyzer_tpu_torch.sched import _native, pack_schedule, rate_history
    from analyzer_tpu_torch.sched.feed import stage_chunk_fused
    from analyzer_tpu_torch.sched.residency import resolve_fuse

    dev = torch.device("cuda")
    cfg = RatingConfig()

    # -- 1. device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {kind} x{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)

    # -- 2. build (nvcc and g++ started together) ---------------------------
    built: dict = {}

    def build(name, fn):
        t0 = time.perf_counter()
        try:
            built[name] = (fn(), time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            built[name] = (e, time.perf_counter() - t0)

    threads = [threading.Thread(target=build, args=a) for a in
               (("nvcc fused_window", fw.load), ("g++ packer", _native.load))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (res, secs) in built.items():
        if isinstance(res, BaseException):
            raise res
        log(f"[build] {name}: {secs:.2f} s")
    if built["g++ packer"][0] is None:
        raise RuntimeError("native packer did not load (no g++)")
    for line in fw.kernel_build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")

    # -- the north-star history --------------------------------------------
    t0 = time.perf_counter()
    players = synthetic_players(args.players, seed=SEED)
    stream = synthetic_stream(
        args.matches, players, seed=SEED,
        activity_concentration=0.8, max_activity_share=1e-4,
    )
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    state0 = PlayerState.create(
        args.players,
        rank_points_ranked=players.rank_points_ranked,
        rank_points_blitz=players.rank_points_blitz,
        skill_tier=players.skill_tier,
        cfg=cfg,
        device=dev,
    )
    torch.cuda.synchronize()
    t_state = time.perf_counter() - t0
    t0 = time.perf_counter()
    sched = pack_schedule(stream, pad_row=state0.pad_row, windowed=True)
    t_pack = time.perf_counter() - t0
    log(f"[data] {args.matches} matches / {args.players} players: generate {t_gen:.2f} s, "
        f"state {t_state:.2f} s, pack {t_pack:.2f} s -> {sched.n_steps} steps "
        f"x B={sched.batch_size}, occupancy {sched.occupancy:.4f}")

    # -- 3. kernel vs plain at full width -----------------------------------
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

    # -- 4. the main path at full size --------------------------------------
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
    table = fused_state.table[: args.players]
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

    t0 = time.perf_counter()
    ref_state, _ = rate_history(state0, sched, cfg, kernel="reference")
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    a_f = fused_state.table.cpu().numpy()
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
    del a_f, a_r, fused_state, ref_state

    # -- 5. kernel times at the main path's shapes (collect off) -------------
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

    log(json.dumps({"kernels": [{
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
    }]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
