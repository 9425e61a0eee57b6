"""ctypes loader for the native superstep packer (``csrc/packer.cc``).

Built with g++ at first use (:mod:`analyzer_tpu_torch.native_build`).
:func:`load` returns None only when no g++ is installed — the schedulers in
``superstep.py`` then run their python loops and count it; a g++ that
fails to build the packer raises. Results equal the python loops exactly
(tests/test_torch_sched.py).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from analyzer_tpu_torch.native_build import build_and_load

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "packer.cc")
COMMAND = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def load() -> ctypes.CDLL | None:
    """The packer library (built on first call), or None without g++."""
    global _lib
    with _lock:
        if _lib is None:
            if shutil.which(COMMAND[0]) is None:
                return None
            lib = build_and_load("packer", COMMAND, [_SRC])
            lib.assign_supersteps.argtypes = [
                _I32P, ctypes.c_int64, ctypes.c_int64, _U8P, ctypes.c_int64,
                _I64P,
            ]
            lib.assign_supersteps.restype = None
            lib.assign_batches_first_fit.argtypes = [
                _I32P, ctypes.c_int64, ctypes.c_int64, _U8P, ctypes.c_int64,
                ctypes.c_int64, _I64P, _I64P, _I64P,
            ]
            lib.assign_batches_first_fit.restype = None
            _lib = lib
        return _lib


def _prep(stream):
    n = stream.n_matches
    idx = np.ascontiguousarray(
        stream.player_idx.reshape(n, 2 * stream.team_size), dtype=np.int32
    )
    ratable = np.ascontiguousarray(stream.ratable, dtype=np.uint8)
    n_players = int(idx.max()) + 1 if n else 1
    return n, idx, ratable, n_players


def assign_supersteps(lib: ctypes.CDLL, stream) -> np.ndarray:
    n, idx, ratable, n_players = _prep(stream)
    out = np.empty(n, dtype=np.int64)
    if n == 0:
        return out
    lib.assign_supersteps(
        idx.ctypes.data_as(_I32P), n, idx.shape[1],
        ratable.ctypes.data_as(_U8P), n_players, out.ctypes.data_as(_I64P),
    )
    return out


def check_out_buffer(name: str, buf: np.ndarray, size: int) -> None:
    """A caller-supplied result buffer must be a C-contiguous int64 array of
    exactly ``size`` entries: the C loop writes through the raw pointer, so
    anything else would corrupt memory."""
    if buf.dtype != np.int64 or buf.size != size or not buf.flags["C_CONTIGUOUS"]:
        raise ValueError(
            f"{name} must be a C-contiguous int64 array of size {size}, "
            f"got dtype={buf.dtype} size={buf.size} "
            f"contiguous={buf.flags['C_CONTIGUOUS']}"
        )


def assign_batches_first_fit(
    lib: ctypes.CDLL,
    stream,
    capacity: int,
    progress: np.ndarray | None = None,
    out: np.ndarray | None = None,
    out_slot: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(batch_id, slot_in_batch), each [N] int64, -1 for non-ratable.

    ``progress`` (optional ``[2]`` int64) is published by the C loop while
    it runs — (matches processed, batch watermark) — and can be polled from
    another thread (ctypes releases the GIL for the call). ``out`` /
    ``out_slot`` let that thread pre-allocate the result buffers and read
    the entries below the published count while the loop fills the rest."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    n, idx, ratable, n_players = _prep(stream)
    out = np.empty(n, dtype=np.int64) if out is None else out
    out_slot = np.empty(n, dtype=np.int64) if out_slot is None else out_slot
    for name, buf, size in (("out", out, n), ("out_slot", out_slot, n),
                            ("progress", progress, 2)):
        if buf is not None:
            check_out_buffer(name, buf, size)
    if n == 0:
        if progress is not None:
            progress[:] = (0, 0)
        return out, out_slot
    lib.assign_batches_first_fit(
        idx.ctypes.data_as(_I32P), n, idx.shape[1],
        ratable.ctypes.data_as(_U8P), n_players, capacity,
        out.ctypes.data_as(_I64P), out_slot.ctypes.data_as(_I64P),
        progress.ctypes.data_as(_I64P) if progress is not None else _I64P(),
    )
    return out, out_slot
