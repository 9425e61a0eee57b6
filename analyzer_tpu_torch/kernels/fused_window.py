"""Wrapper of the hand-written CUDA fused-window kernel (``csrc/fused_window.cu``).

:func:`fused_window` runs one fused window in place on a working set:
on a CUDA tensor it launches the kernel (building it with nvcc for
``sm_90a`` on first use) or raises; on a CPU tensor — and only because the
tensor lies on the CPU — it runs the kernel's plain PyTorch version,
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
HOST_SOURCE = os.path.join(_CSRC, "fused_window_host.cc")
HEADERS = [os.path.join(_CSRC, "rate_match.cuh")]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills into the build log
]
HOST_COMMAND = [
    "g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17",
]

#: Number of kernel launches so far (set to 0 to start a count).
launches = 0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_host_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


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
                _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P,
            ]
            lib.fused_window_launch.restype = _I
            _lib = lib
        return _lib


def kernel_build_log() -> str:
    """nvcc's messages (``-Xptxas -v``: registers, spills) of the build."""
    return build_log("fused_window", nvcc_command(), [SOURCE, *HEADERS])


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


def fused_window(
    ws: torch.Tensor,
    slot_idx: torch.Tensor,
    winner: torch.Tensor,
    mode_id: torch.Tensor,
    afk: torch.Tensor,
    cfg: RatingConfig,
    collect: bool,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One fused window, in place on ``ws`` ``[n_slots, 16]`` float32.

    ``slot_idx`` ``[K, B, 2, T]`` and ``winner``/``mode_id``/``afk``
    ``[K, B]`` are int32 (afk 0/1). Slot indices must lie in
    ``[0, n_slots)`` — the residency planner guarantees it and
    ``sched.residency.check_plan`` validates untrusted plans. Returns
    ``(ws, ys)`` with ``ys`` ``[K, B, 3 + 10T]`` when ``collect``."""
    global launches
    k, b, t = _check(ws, slot_idx, winner, mode_id, afk)
    if ws.device.type == "cpu":
        from analyzer_tpu_torch.core.fused import _window_plain

        return _window_plain(ws, slot_idx, winner, mode_id, afk, cfg, collect)
    if ws.device.type != "cuda":
        raise ValueError(f"fused_window runs on cuda or cpu, not {ws.device}")
    lib = load()
    ys = (
        torch.empty((k, b, 3 + 10 * t), dtype=torch.float32, device=ws.device)
        if collect else None
    )
    scratch = torch.empty((b, 2 * t, 4), dtype=torch.float32, device=ws.device)
    stream = torch.cuda.current_stream(ws.device).cuda_stream
    err = lib.fused_window_launch(
        ws.data_ptr(), slot_idx.data_ptr(), winner.data_ptr(),
        mode_id.data_ptr(), afk.data_ptr(),
        ys.data_ptr() if ys is not None else None, scratch.data_ptr(),
        k, b, t, _f32(cfg.tau2), _f32(cfg.beta2), ws.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_window kernel launch failed: CUDA error {err}")
    launches += 1
    return ws, ys


def load_host() -> ctypes.CDLL:
    """The host (g++) build of the kernel's phases, for the CPU tests."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            lib = build_and_load(
                "fused_window_host", HOST_COMMAND, [HOST_SOURCE], HEADERS
            )
            lib.fused_window_host.argtypes = [
                _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
            ]
            lib.fused_window_host.restype = _I
            _host_lib = lib
        return _host_lib


def fused_window_host(ws, slot_idx, winner, mode_id, afk, cfg, collect):
    """The kernel's per-match phases from ``rate_match.cuh``, built with g++
    and run as a sequential CPU loop on numpy arrays (``ws`` is updated in
    place). Returns ``(ws, ys | None)``."""
    k, b, _, t = slot_idx.shape
    arrays = [np.ascontiguousarray(x, np.int32)
              for x in (slot_idx, winner, mode_id, afk)]
    if ws.dtype != np.float32 or not ws.flags["C_CONTIGUOUS"]:
        raise ValueError("ws must be a C-contiguous float32 array")
    ys = np.empty((k, b, 3 + 10 * t), np.float32) if collect else None
    rc = load_host().fused_window_host(
        ws.ctypes.data, *(a.ctypes.data for a in arrays),
        ys.ctypes.data if ys is not None else None,
        k, b, t, _f32(cfg.tau2), _f32(cfg.beta2),
    )
    if rc != 0:
        raise ValueError(f"team size must be 1..5, got {t}")
    return ws, ys
