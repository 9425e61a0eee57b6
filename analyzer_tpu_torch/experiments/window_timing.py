"""Per-step cost of the fused-window kernel on the card.

Times :func:`analyzer_tpu_torch.kernels.fused_window.fused_window` (collect
off) on the first windows of the north-star schedule (10M synthetic
matches, 1.5M players, ``chip_smoke.py``'s stream settings), each window
cut to its first n steps, n = 1, 2, 4, 8, 12, 16, every step looped: the
least-squares slope of the kernel's device time per window against n is
its cost per step, the intercept its fixed cost per launch. Each time is
taken twice: by CUDA events around back-to-back launches (what a caller
waits for, host launch overhead included where it exceeds the kernel) and
as the kernel's own device time from a ``torch.profiler`` trace. Where the
wrapper takes ``n_steps``, the uncut windows also run as the main path
runs them (only their real steps looped) and with every step looped.

    python -m analyzer_tpu_torch.experiments.window_timing \
        [--matches N] [--players P] [--windows W]

Needs a CUDA device. It uses only entry points the wrapper has had since
the kernel was first ported, so the same script times an older checkout's
kernel when that checkout's package is first on ``sys.path``.
"""

from __future__ import annotations

import argparse
import inspect
import json

import numpy as np
import torch

#: Steps per window at which the cut windows are timed.
STEPS = (1, 2, 4, 8, 12, 16)
#: Supersteps staged to find the windows (the first chunk).
PREFIX_STEPS = 128
#: Launches per window per timing.
REPS = 20


def north_star_windows(n_matches: int, n_players: int, n_windows: int,
                       device, seed: int = 42):
    """The first ``n_windows`` fused windows of the north-star schedule on
    ``device``: ``(ws, slot_idx, winner, mode_id, afk, n_steps)`` each,
    ``ws`` gathered from a fresh table."""
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
    from analyzer_tpu_torch.sched import pack_schedule
    from analyzer_tpu_torch.sched.feed import stage_chunk_fused
    from analyzer_tpu_torch.sched.residency import resolve_fuse

    players = synthetic_players(n_players, seed=seed)
    stream = synthetic_stream(n_matches, players, seed=seed,
                              activity_concentration=0.8,
                              max_activity_share=1e-4)
    state = PlayerState.create(int(stream.player_idx.max()) + 1,
                               cfg=RatingConfig(), device=device)
    sched = pack_schedule(stream, pad_row=state.pad_row, windowed=True)
    chunk = stage_chunk_fused(sched, 0, PREFIX_STEPS, resolve_fuse("fused"),
                              False, True)
    views = chunk.slab.to_device(device)
    out = []
    for w in chunk.windows[:n_windows]:
        slot_rows, slot_idx, winner, mode_id, afk = (views[i] for i in tuple(w)[:5])
        n_steps = getattr(w, "n_steps", slot_idx.shape[0])
        ws = state.table.index_select(0, slot_rows.long())
        out.append((ws, slot_idx, winner, mode_id, afk, n_steps))
    return out


def _calls(windows, k: int, n_steps, reps: int, kw: dict):
    """``reps`` launches per window, each with a fresh copy of its working
    set: ``(ws, args, kwargs)``. ``n_steps`` "real" takes each window's
    own real step count."""
    calls = []
    for ws, slot_idx, winner, mode_id, afk, real in windows:
        args = [x[:k].contiguous() for x in (slot_idx, winner, mode_id, afk)]
        extra = dict(kw)
        if n_steps is not None:
            extra["n_steps"] = min(real if n_steps == "real" else n_steps, k)
        calls += [(ws.clone(), args, extra) for _ in range(reps)]
    return calls


def time_windows(windows, k: int, n_steps=None, reps: int = REPS, **kw) -> dict:
    """ms per window of the kernel on ``windows`` cut to ``k`` steps
    (``n_steps`` of them looped, where given; extra keyword arguments go to
    the wrapper): ``ms`` by CUDA events around all launches back to back,
    ``device_ms`` the kernel's time in a profiler trace (None where the
    trace holds no device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.kernels import fused_window as fw

    cfg = RatingConfig()

    def run(calls):
        for ws, args, extra in calls:
            fw.fused_window(ws, *args, cfg, False, **extra)

    run(_calls(windows, k, n_steps, 1, kw))  # built and warm
    calls = _calls(windows, k, n_steps, reps, kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(calls)
    end.record()
    end.synchronize()
    out = {"ms": start.elapsed_time(end) / len(calls), "device_ms": None}
    calls = _calls(windows, k, n_steps, reps, kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(calls)
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == DeviceType.CUDA and "fused_window" in ev.name]
    if us:
        out["device_ms"] = sum(us) / 1e3 / len(calls)
    return out


def measure(windows, steps=STEPS) -> dict:
    """ms per window at each cut and the fitted per-step slope and
    intercept (of the device time where the profiler gives one); where the
    wrapper takes ``n_steps``, the uncut windows with their inert tail
    skipped (the main path's call) and with every step looped."""
    from analyzer_tpu_torch.kernels import fused_window as fw

    k_full = windows[0][1].shape[0]
    steps = [n for n in steps if n <= k_full]
    by_n = {n: time_windows(windows, n) for n in steps}
    key = ("device_ms" if all(r["device_ms"] is not None for r in by_n.values())
           else "ms")
    ys = [by_n[n][key] for n in steps]
    slope, intercept = (np.polyfit(steps, ys, 1) if len(steps) > 1
                        else (float("nan"), ys[0]))
    out = {"by_steps": by_n, "fit_of": key, "slope_ms_per_step": float(slope),
           "intercept_ms": float(intercept),
           "real_steps_mean": float(np.mean([w[5] for w in windows]))}
    if "n_steps" in inspect.signature(fw.fused_window).parameters:
        out["skip_tail"] = time_windows(windows, k_full, "real")
        out["all_steps"] = time_windows(windows, k_full, k_full)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matches", type=int, default=10_000_000)
    ap.add_argument("--players", type=int, default=1_500_000)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--clusters", default="",
                    help="comma-separated cluster sizes to time the main "
                         "path's call at (e.g. 1,2,4,8,16)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("window_timing: no CUDA device visible")
    from analyzer_tpu_torch.kernels import fused_window as fw

    device = torch.device("cuda")
    windows = north_star_windows(args.matches, args.players, args.windows, device)
    res = measure(windows)
    k_full = windows[0][1].shape[0]
    for c in (int(x) for x in args.clusters.split(",") if x):
        res[f"cluster{c}"] = time_windows(windows, k_full, "real", cluster=c)
        print(f"cluster {c:2d}: {res[f'cluster{c}']}", flush=True)
    for line in fw.kernel_build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}; {len(windows)} windows, "
          f"K={windows[0][1].shape[0]}, B={windows[0][1].shape[1]}", flush=True)
    for n, r in res["by_steps"].items():
        print(f"steps {n:2d}: {r['ms']:.5f} ms per window (events), device "
              f"{r['device_ms']} ms", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
