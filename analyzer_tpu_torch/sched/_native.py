"""ctypes loader for the native superstep packer (``csrc/packer.cc``): the
one-shot ASAP and first-fit loops, the restartable windowed first-fit
(``assign_ff_create`` / ``feed`` / ``finish`` / ``destroy``) that the
migration engine's front half runs (``migrate/assign.py``), and the fused
feed's one-pass residency planner (``plan_residency``, behind
``residency.plan_windows``).

Built with g++ at first use (:mod:`analyzer_tpu_torch.native_build`).
:func:`load` returns None only when no g++ is installed — the schedulers in
``superstep.py`` and the planner in ``residency.py`` then run their numpy
loops and count it; a g++ that fails to build the packer raises. Results
equal the python loops exactly (tests/test_torch_sched.py).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import NamedTuple

import numpy as np

from analyzer_tpu_torch.native_build import build_and_load

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "packer.cc")
COMMAND = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U64P = ctypes.POINTER(ctypes.c_uint64)


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
            lib.assign_ff_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
            lib.assign_ff_create.restype = ctypes.c_void_p
            lib.assign_ff_feed.argtypes = [
                ctypes.c_void_p, _I32P, ctypes.c_int64, _U8P, ctypes.c_int64,
                ctypes.c_int64, _I64P, _I64P, _I64P,
            ]
            lib.assign_ff_feed.restype = ctypes.c_int64
            lib.assign_ff_finish.argtypes = [ctypes.c_void_p, _I64P]
            lib.assign_ff_finish.restype = ctypes.c_int64
            lib.assign_ff_destroy.argtypes = [ctypes.c_void_p]
            lib.assign_ff_destroy.restype = None
            lib.plan_residency.argtypes = [
                _I32P, _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int64, _U64P, ctypes.c_int64, _U32P,
                _I32P, _I32P, _I32P, _I32P, ctypes.c_int64, _I64P, _I64P,
            ]
            lib.plan_residency.restype = ctypes.c_int64
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


# -- the windowed restartable first-fit (migrate/assign.py's native path) --
def _check_min_buffer(name: str, buf: np.ndarray, min_size: int) -> None:
    """The windowed loop writes int64 entries at ABSOLUTE stream positions
    through the raw pointer, so a buffer must hold at least ``min_size``."""
    if buf.dtype != np.int64 or buf.size < min_size or not buf.flags["C_CONTIGUOUS"]:
        raise ValueError(
            f"{name} must be a C-contiguous int64 array of size >= "
            f"{min_size}, got dtype={buf.dtype} size={buf.size} "
            f"contiguous={buf.flags['C_CONTIGUOUS']}"
        )


def assign_ff_create(lib: ctypes.CDLL, capacity: int, n_hint: int = 0) -> int:
    """A restartable first-fit state handle (``n_hint`` pre-sizes the player
    frontier; 0 -> 1024, it grows either way). Release it with
    :func:`assign_ff_destroy`."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    handle = lib.assign_ff_create(int(capacity), int(n_hint))
    if not handle:
        raise MemoryError("assign_ff_create returned NULL")
    return handle


def assign_ff_feed(
    lib: ctypes.CDLL,
    handle: int,
    idx_window: np.ndarray,
    ratable_window: np.ndarray,
    lo: int,
    hi: int,
    out_batch: np.ndarray,
    out_slot: np.ndarray,
    progress: np.ndarray | None = None,
) -> int:
    """Consumes stream slice ``[lo, hi)``: ``idx_window`` is its
    window-local ``[hi - lo, slots]`` int32 player rows, ``ratable_window``
    its ``[hi - lo]`` uint8 gate; ``out_batch`` / ``out_slot`` /
    ``progress`` hold absolute positions. Runs with the GIL released and
    publishes ``progress[0]`` with release stores every 2048 matches and
    at the end. Returns ``hi - lo``; raises on a slice that does not
    continue the last one."""
    n = hi - lo
    if n < 0:
        raise ValueError(f"feed window [{lo}, {hi}) is negative")
    idx = np.ascontiguousarray(idx_window, dtype=np.int32)
    if idx.ndim != 2 or idx.shape[0] != n:
        raise ValueError(f"idx_window must be [{n}, slots], got shape {idx.shape}")
    rat = np.ascontiguousarray(ratable_window, dtype=np.uint8)
    if rat.shape != (n,):
        raise ValueError(f"ratable_window must be [{n}], got shape {rat.shape}")
    _check_min_buffer("out_batch", out_batch, hi)
    _check_min_buffer("out_slot", out_slot, hi)
    if progress is not None:
        _check_min_buffer("progress", progress, 2)
    if n == 0:
        return 0
    consumed = lib.assign_ff_feed(
        handle, idx.ctypes.data_as(_I32P), idx.shape[1],
        rat.ctypes.data_as(_U8P), lo, hi,
        out_batch.ctypes.data_as(_I64P), out_slot.ctypes.data_as(_I64P),
        progress.ctypes.data_as(_I64P) if progress is not None else _I64P(),
    )
    if consumed != n:
        raise ValueError(
            f"feed slices must be contiguous (native loop refused window "
            f"[{lo}, {hi}))"
        )
    return consumed


def assign_ff_finish(lib: ctypes.CDLL, handle: int,
                     progress: np.ndarray | None = None) -> int:
    """Publishes (matches assigned, batches used) into ``progress`` when
    given and returns batches used. Idempotent: callable mid-stream to read
    the high-water batch count."""
    if progress is not None:
        _check_min_buffer("progress", progress, 2)
    used = lib.assign_ff_finish(
        handle, progress.ctypes.data_as(_I64P) if progress is not None else _I64P()
    )
    if used < 0:
        raise ValueError("assign_ff_finish on a null handle")
    return used


def assign_ff_destroy(lib: ctypes.CDLL, handle: int) -> None:
    """Frees the state; safe on a handle never finished, once per create."""
    if handle:
        lib.assign_ff_destroy(handle)


# -- the fused feed's residency planner (residency.plan_windows) ----------
class ResidencyPlanned(NamedTuple):
    """One :func:`plan_residency` call's raw result: ``code`` is the window
    count (>= 0) or the fault code (< 0, with ``fault`` its two numbers);
    ``meta`` [windows, 4] int64 rows are (steps, n_live, spilled,
    writebacks_avoided); ``live_rows`` / ``first_use`` / ``last_use`` hold
    the windows' live slots back to back."""

    code: int
    fault: tuple[int, int]
    slot_idx: np.ndarray
    meta: np.ndarray
    live_rows: np.ndarray
    first_use: np.ndarray
    last_use: np.ndarray


def plan_residency(
    lib: ctypes.CDLL,
    rows: np.ndarray,
    valid: np.ndarray,
    pad_row: int,
    window: int,
    max_rows: int,
    table: np.ndarray,
    generation: np.ndarray,
) -> ResidencyPlanned:
    """Plans ``rows`` (``[S, ...]`` int32 player rows in ``[0, pad_row]``)
    into fused windows with the GIL released. ``table`` (uint64, at least
    ``pad_row + 1`` entries) and ``generation`` (``[1]`` uint32) are the
    caller's row -> slot scratch, carried from call to call; one caller at
    a time may hold them."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    valid = np.ascontiguousarray(valid, dtype=bool)
    if valid.shape != rows.shape:
        raise ValueError(
            f"valid must have the rows' shape {rows.shape}, got {valid.shape}"
        )
    n_rows = int(pad_row) + 1
    if (table.dtype != np.uint64 or table.size < n_rows
            or not table.flags["C_CONTIGUOUS"]):
        raise ValueError(
            f"table must be a C-contiguous uint64 array of size >= {n_rows}"
        )
    if generation.dtype != np.uint32 or generation.shape != (1,):
        raise ValueError("generation must be a [1] uint32 array")
    n_steps = rows.shape[0]
    per_step = int(np.prod(rows.shape[1:]))
    capacity = n_steps * (per_step + 1) + 1
    slot_idx = np.empty(rows.shape, np.int32)
    live_rows = np.empty(capacity, np.int32)
    first_use = np.empty(capacity, np.int32)
    last_use = np.empty(capacity, np.int32)
    meta = np.empty((max(n_steps, 1), 4), np.int64)
    fault = np.zeros(2, np.int64)
    code = lib.plan_residency(
        rows.ctypes.data_as(_I32P), valid.view(np.uint8).ctypes.data_as(_U8P),
        n_steps, per_step, int(pad_row), int(window), int(max_rows),
        table.ctypes.data_as(_U64P), n_rows,
        generation.ctypes.data_as(_U32P), slot_idx.ctypes.data_as(_I32P),
        live_rows.ctypes.data_as(_I32P), first_use.ctypes.data_as(_I32P),
        last_use.ctypes.data_as(_I32P), capacity,
        meta.ctypes.data_as(_I64P), fault.ctypes.data_as(_I64P),
    )
    return ResidencyPlanned(
        int(code), (int(fault[0]), int(fault[1])), slot_idx,
        meta[: max(int(code), 0)], live_rows, first_use, last_use,
    )
