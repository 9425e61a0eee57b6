"""Wrapper of the hand-written CUDA fused-window kernel (``csrc/fused_window.cu``).

:func:`fused_window` runs one fused window in place on a working set:
on a CUDA tensor it launches the kernel — one thread-block cluster of
CTAs per window (:data:`CLUSTER_PREFERENCE`), built with nvcc for
``sm_90a`` on first use — or raises; on a CPU tensor — and only because
the tensor lies on the CPU — it runs the kernel's plain PyTorch version,
:func:`analyzer_tpu_torch.core.fused._window_plain`. There is no fallback
from the card to the plain version.

:data:`launches` counts kernel launches (incremented only where the kernel
is launched), so a run can show it went through the kernel.

The kernel replaces ``analyzer_tpu/core/fused.py::_pallas_window``; the
source's header says what bounds it on an H100 and how the design answers.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.native_build import build_and_load, build_log, nvcc_path
from analyzer_tpu_torch.ops.trueskill import _f32

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCE = os.path.join(_CSRC, "fused_window.cu")
HEADERS = [os.path.join(_CSRC, "rate_match.cuh")]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills into the build log
]

#: CTAs in the thread-block cluster that runs one window, where the caller
#: names none: the first of these whose cluster fits on the card. 16 (a
#: non-portable cluster size) ran a north-star window ~17% faster than 8
#: (the portable maximum) on an H100 (PERF.md).
CLUSTER_PREFERENCE = (16, 8)
CLUSTER_SIZES = (1, 2, 4, 8, 16)

#: Number of kernel launches so far (set to 0 to start a count).
launches = 0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_resident: dict = {}  # (device, team, batch, cluster) -> clusters that fit

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)


def nvcc_command() -> list[str]:
    """The nvcc command line the kernel is built with."""
    return [nvcc_path(), *NVCC_FLAGS]


def load() -> ctypes.CDLL:
    """The kernel library, built from the sources on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = build_and_load(
                "fused_window", nvcc_command(), [SOURCE], HEADERS
            )
            lib.fused_window_launch.argtypes = [
                _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P,
            ]
            lib.fused_window_launch.restype = _I
            lib.fused_window_occupancy.argtypes = [_I, _I, _I, _I, _IP, _IP, _IP]
            lib.fused_window_occupancy.restype = _I
            _lib = lib
        return _lib


def kernel_build_log() -> str:
    """nvcc's messages (``-Xptxas -v``: registers, spills) of the build."""
    return build_log("fused_window", nvcc_command(), [SOURCE, *HEADERS])


def launch_shape(device: torch.device, team: int, batch: int,
                 cluster: int) -> dict:
    """The cluster launch of a window on ``device``: ``threads`` and
    ``smem`` (bytes) per CTA and ``clusters``, how many such clusters the
    card holds at once (``cudaOccupancyMaxActiveClusters``). Cached."""
    key = (device.index or 0, team, batch, cluster)
    if key not in _resident:
        n, threads, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        err = load().fused_window_occupancy(
            batch, team, cluster, key[0], ctypes.byref(n), ctypes.byref(threads),
            ctypes.byref(smem),
        )
        if err != 0:
            raise RuntimeError(
                f"fused_window occupancy query failed for a cluster of {cluster} "
                f"CTAs (B={batch}, T={team}): CUDA error {err}"
            )
        _resident[key] = {"clusters": n.value, "threads": threads.value,
                          "smem": smem.value}
    return _resident[key]


def pick_cluster(device: torch.device, team: int, batch: int) -> int:
    """The first size of :data:`CLUSTER_PREFERENCE` whose cluster fits on
    ``device`` for this team size and batch; raises where none does."""
    for cluster in CLUSTER_PREFERENCE:
        if launch_shape(device, team, batch, cluster)["clusters"] >= 1:
            return cluster
    raise RuntimeError(
        f"no cluster of {CLUSTER_PREFERENCE} CTAs fits on {device} "
        f"(B={batch}, T={team})"
    )


def _check(ws, slot_idx, winner, mode_id, afk) -> tuple[int, int, int]:
    if ws.dtype != torch.float32 or ws.dim() != 2 or ws.shape[1] != 16:
        raise ValueError(f"ws must be float32 [n_slots, 16], got {ws.dtype} {tuple(ws.shape)}")
    if slot_idx.dim() != 4 or slot_idx.shape[2] != 2:
        raise ValueError(f"slot_idx must be [K, B, 2, T], got {tuple(slot_idx.shape)}")
    k, b, _, t = slot_idx.shape
    for name, x, shape in (
        ("slot_idx", slot_idx, (k, b, 2, t)),
        ("winner", winner, (k, b)),
        ("mode_id", mode_id, (k, b)),
        ("afk", afk, (k, b)),
    ):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    for name, x in (("ws", ws), ("slot_idx", slot_idx), ("winner", winner),
                    ("mode_id", mode_id), ("afk", afk)):
        if x.device != ws.device:
            raise ValueError(f"{name} is on {x.device}, ws on {ws.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= t <= 5:
        raise ValueError(f"team size must be 1..5, got {t}")
    return k, b, t


def _check_steps(n_steps, k: int) -> int:
    if n_steps is None:
        return k
    if isinstance(n_steps, bool) or not isinstance(n_steps, (int, np.integer)):
        raise ValueError(f"n_steps must be an int, got {type(n_steps).__name__}")
    if not 0 <= n_steps <= k:
        raise ValueError(f"n_steps must lie in [0, {k}] (the window's K), got {n_steps}")
    return int(n_steps)


def fused_window(
    ws: torch.Tensor,
    slot_idx: torch.Tensor,
    winner: torch.Tensor,
    mode_id: torch.Tensor,
    afk: torch.Tensor,
    cfg: RatingConfig,
    collect: bool,
    n_steps: int | None = None,
    cluster: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One fused window, in place on ``ws`` ``[n_slots, 16]`` float32.

    ``slot_idx`` ``[K, B, 2, T]`` and ``winner``/``mode_id``/``afk``
    ``[K, B]`` are int32 (afk 0/1). Slot indices must lie in
    ``[0, n_slots)`` — the residency planner guarantees it and
    ``sched.residency.check_plan`` validates untrusted plans.

    ``n_steps`` (default K) is the window's real step count: steps from
    ``n_steps`` on must be inert — each match non-ratable or on slot 0
    only, as the feed pads short windows — so they write nothing. The
    kernel loops only the real steps and computes the inert tail's outputs
    (with ``collect``) after them; the plain version runs all K steps.
    ``cluster`` is the number of CTAs in the window's thread-block cluster
    (one of :data:`CLUSTER_SIZES`; None picks by :func:`pick_cluster`).
    Returns ``(ws, ys)`` with ``ys`` ``[K, B, 3 + 10T]`` when
    ``collect``."""
    global launches
    k, b, t = _check(ws, slot_idx, winner, mode_id, afk)
    n = _check_steps(n_steps, k)
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got {cluster}")
    if ws.device.type == "cpu":
        from analyzer_tpu_torch.core.fused import _window_plain

        return _window_plain(ws, slot_idx, winner, mode_id, afk, cfg, collect)
    if ws.device.type != "cuda":
        raise ValueError(f"fused_window runs on cuda or cpu, not {ws.device}")
    lib = load()
    if cluster is None:
        cluster = pick_cluster(ws.device, t, b)
    shape = launch_shape(ws.device, t, b, cluster)
    if shape["clusters"] < 1:
        raise RuntimeError(
            f"no cluster of {cluster} CTAs x {shape['threads']} threads with "
            f"{shape['smem']} B of shared memory fits on {ws.device} "
            f"(B={b}, T={t}); use a smaller cluster"
        )
    ys = (
        torch.empty((k, b, 3 + 10 * t), dtype=torch.float32, device=ws.device)
        if collect else None
    )
    stream = torch.cuda.current_stream(ws.device).cuda_stream
    err = lib.fused_window_launch(
        ws.data_ptr(), slot_idx.data_ptr(), winner.data_ptr(),
        mode_id.data_ptr(), afk.data_ptr(),
        ys.data_ptr() if ys is not None else None,
        k, n, b, t, cluster, _f32(cfg.tau2), _f32(cfg.beta2),
        ws.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_window kernel launch failed: CUDA error {err}")
    launches += 1
    return ws, ys
