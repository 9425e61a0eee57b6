"""The fused window's per-match math built for the CPU (``csrc/fused_window_host.cc``).

g++ builds the kernel's ``__host__ __device__`` lane functions
(``csrc/rate_match.cuh``) into a host library, so the CPU tests can hold
the kernel's math, in its lane order, against the plain window; only the
launch geometry of :mod:`analyzer_tpu_torch.kernels.fused_window` waits
for the card. A loader of its own: each ctypes loader declares one
library's symbols against that library's source.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from analyzer_tpu_torch.kernels.fused_window import HEADERS, _check_steps
from analyzer_tpu_torch.native_build import build_and_load
from analyzer_tpu_torch.ops.trueskill import _f32

HOST_SOURCE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "csrc", "fused_window_host.cc"
)
HOST_COMMAND = [
    "g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17",
]

_lock = threading.Lock()
_host_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def load_host() -> ctypes.CDLL:
    """The host (g++) build of the kernel's lane functions, for the CPU
    tests."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            lib = build_and_load(
                "fused_window_host", HOST_COMMAND, [HOST_SOURCE], HEADERS
            )
            lib.fused_window_host.argtypes = [
                _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
            ]
            lib.fused_window_host.restype = _I
            _host_lib = lib
        return _host_lib


def fused_window_host(ws, slot_idx, winner, mode_id, afk, cfg, collect,
                      n_steps=None):
    """The kernel's lane functions from ``rate_match.cuh``, built with g++
    and run as a sequential CPU loop in lane order on numpy arrays (``ws``
    is updated in place): the ``n_steps`` real steps, then the inert tail's
    outputs, as the kernel runs them. Returns ``(ws, ys | None)``."""
    k, b, _, t = slot_idx.shape
    n = _check_steps(n_steps, k)
    arrays = [np.ascontiguousarray(x, np.int32)
              for x in (slot_idx, winner, mode_id, afk)]
    if ws.dtype != np.float32 or not ws.flags["C_CONTIGUOUS"]:
        raise ValueError("ws must be a C-contiguous float32 array")
    ys = np.empty((k, b, 3 + 10 * t), np.float32) if collect else None
    rc = load_host().fused_window_host(
        ws.ctypes.data, *(a.ctypes.data for a in arrays),
        ys.ctypes.data if ys is not None else None,
        k, n, b, t, _f32(cfg.tau2), _f32(cfg.beta2),
    )
    if rc != 0:
        raise ValueError(f"team size must be 1..5, got {t}")
    return ws, ys
