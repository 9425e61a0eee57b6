"""ctypes loader for the native CSV scanner (``csrc/fastcsv.cc``).

The port's copy of ``analyzer_tpu.io._native_csv``. The library is built
with g++ from the checkout's source into ``analyzer_tpu_torch/_build/`` the
first time a caller asks for it (:mod:`analyzer_tpu_torch.native_build`),
never at import. :func:`load` raises ImportError on ANY build or load
failure, so the callers' python parser engages instead (``csv_codec``
logs it once; ``io.ingest.ColumnarDecoder`` counts it in
``ingest.fallbacks_total``).

Two surfaces: :func:`parse_stream_csv`, the whole-file two-pass loader,
and :func:`parse_csv_window`, the ingest plane's entry that decodes up to
a slab's worth of rows into caller-provided (reusable, pinned) column
buffers and resumes from a byte cursor. The scanner writes through raw
pointers, so every caller buffer is checked for dtype, shape and
C-contiguity before the call.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from analyzer_tpu_torch.native_build import build_and_load

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "fastcsv.cc")
COMMAND = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    """The scanner library, built on first call. ImportError when it cannot
    be built or loaded (no g++, a read-only checkout, a broken toolchain)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = build_and_load("fastcsv", COMMAND, [_SRC])
        except (OSError, RuntimeError) as e:
            raise ImportError(f"native CSV scanner unavailable: {e}") from e
        lib.parse_stream_csv.argtypes = [
            ctypes.c_char_p,                  # buf
            ctypes.c_int64,                   # len
            ctypes.c_char_p,                  # '\n'-joined mode names
            ctypes.c_int64,                   # n_modes
            ctypes.c_int64,                   # max_team
            ctypes.c_int64,                   # cap_rows
            ctypes.POINTER(ctypes.c_int32),   # player_idx [cap, 2, max_team]
            ctypes.POINTER(ctypes.c_int32),   # winner [cap]
            ctypes.POINTER(ctypes.c_int32),   # mode_id [cap]
            ctypes.POINTER(ctypes.c_uint8),   # afk [cap]
            ctypes.POINTER(ctypes.c_int64),   # out_tmax
        ]
        lib.parse_stream_csv.restype = ctypes.c_int64
        lib.parse_csv_window.argtypes = [
            ctypes.c_char_p,                  # buf
            ctypes.c_int64,                   # len
            ctypes.c_char_p,                  # '\n'-joined mode names
            ctypes.c_int64,                   # n_modes
            ctypes.c_int64,                   # max_team
            ctypes.c_int64,                   # cap_rows
            ctypes.POINTER(ctypes.c_int64),   # cursor (in/out)
            ctypes.POINTER(ctypes.c_int32),   # player_idx [cap, 2, max_team]
            ctypes.POINTER(ctypes.c_int32),   # winner [cap]
            ctypes.POINTER(ctypes.c_int32),   # mode_id [cap]
            ctypes.POINTER(ctypes.c_uint8),   # afk [cap]
            ctypes.POINTER(ctypes.c_int64),   # out_tmax
        ]
        lib.parse_csv_window.restype = ctypes.c_int64
        _lib = lib
        return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check_buffer(name: str, arr, dtype, shape: tuple) -> None:
    """A caller buffer the scanner writes through a raw pointer: exactly
    this dtype and shape, C-contiguous and writeable."""
    if not isinstance(arr, np.ndarray):
        raise TypeError(f"{name} must be a numpy array, got {type(arr).__name__}")
    if arr.dtype != np.dtype(dtype) or arr.shape != shape:
        raise ValueError(
            f"{name} must be {np.dtype(dtype)} {list(shape)}, got "
            f"{arr.dtype} {list(arr.shape)}"
        )
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        raise ValueError(f"{name} must be C-contiguous and writeable")


def parse_stream_csv(data: bytes, mode_names: list[str], max_team: int):
    """Parses the writer's CSV format. Returns (player_idx [N,2,tmax],
    winner, mode_id, afk) numpy arrays, or None when the data doesn't
    match the fast path (caller falls back to the python parser).
    ImportError when the scanner cannot be built.

    Two passes: a write-free probe learns (rows, widest team) so the
    arrays are allocated at exactly the data's width — a worst-case
    ``max_team``-wide buffer would be ~1.3 GB of mostly padding at the
    10M-row scale this parser exists for."""
    if b'"' in data:
        # Quoting is csv-module territory; the scanner would compare a
        # quoted mode name literally and mis-map it. Rare -> python path.
        return None
    lib = load()
    modes = "\n".join(mode_names).encode()
    null_i32 = ctypes.POINTER(ctypes.c_int32)()
    null_u8 = ctypes.POINTER(ctypes.c_uint8)()
    tmax = np.zeros(1, np.int64)
    tmax_ptr = _ptr(tmax, ctypes.c_int64)
    n = lib.parse_stream_csv(
        data, len(data), modes, len(mode_names), max_team,
        np.iinfo(np.int64).max,
        null_i32, null_i32, null_i32, null_u8, tmax_ptr,
    )
    if n < 0:
        return None  # malformed for the fast path; python parser decides
    t = max(int(tmax[0]), 1)
    player_idx = np.full((n, 2, t), -1, np.int32)
    winner = np.zeros(n, np.int32)
    mode_id = np.zeros(n, np.int32)
    afk = np.zeros(n, np.uint8)
    n2 = lib.parse_stream_csv(
        data, len(data), modes, len(mode_names), t, n,
        _ptr(player_idx, ctypes.c_int32), _ptr(winner, ctypes.c_int32),
        _ptr(mode_id, ctypes.c_int32), _ptr(afk, ctypes.c_uint8), tmax_ptr,
    )
    if n2 != n:  # same bytes, same grammar: cannot differ
        raise RuntimeError(f"fastcsv decoded {n2} rows on the second pass, {n} on the first")
    return player_idx, winner, mode_id, afk.astype(bool)


class WindowDecodeError(ValueError):
    """A malformed row inside :func:`parse_csv_window`'s grammar,
    attributed to the WINDOW-RELATIVE row index (the caller adds its
    stream offset for the absolute poison row) and the byte offset of
    the offending row."""

    def __init__(self, row: int, byte_offset: int) -> None:
        super().__init__(
            f"malformed CSV row at window row {row} (byte {byte_offset})"
        )
        self.row = row
        self.byte_offset = byte_offset


def parse_csv_window(
    data: bytes,
    modes_blob: bytes,
    n_modes: int,
    max_team: int,
    cursor: np.ndarray,
    player_idx: np.ndarray,
    winner: np.ndarray,
    mode_id: np.ndarray,
    afk: np.ndarray,
) -> int:
    """Decodes up to ``player_idx.shape[0]`` rows of ``data`` starting at
    byte ``cursor[0]`` into the caller's column slabs (C-contiguous
    int32 [W, 2, max_team] / int32 [W] / int32 [W] / uint8 [W] — the
    pinned staging arena's reusable buffers; unused team slots are
    written -1 by the scanner, so slabs need NO reset between windows).
    Advances ``cursor`` in place and returns rows decoded (0 = end of
    stream). Raises :class:`WindowDecodeError` on a malformed row, with
    ``cursor`` left at the offending row's first byte. ImportError when
    the scanner cannot be built.

    ``modes_blob`` is the pre-encoded '\\n'-joined mode-name list —
    encoded ONCE per stream by the caller, not per window (the whole
    point of this entry is no per-window python staging work)."""
    if player_idx.ndim != 3:
        raise ValueError(f"player_idx must be [W, 2, max_team], got {list(player_idx.shape)}")
    cap = int(player_idx.shape[0])
    _check_buffer("player_idx", player_idx, np.int32, (cap, 2, int(max_team)))
    _check_buffer("winner", winner, np.int32, (cap,))
    _check_buffer("mode_id", mode_id, np.int32, (cap,))
    _check_buffer("afk", afk, np.uint8, (cap,))
    _check_buffer("cursor", cursor, np.int64, (1,))
    if not 0 <= int(cursor[0]) <= len(data):
        raise ValueError(f"cursor {int(cursor[0])} lies outside the {len(data)} data bytes")
    lib = load()
    tmax = np.zeros(1, np.int64)
    n = lib.parse_csv_window(
        data, len(data), modes_blob, n_modes, max_team, cap,
        _ptr(cursor, ctypes.c_int64),
        _ptr(player_idx, ctypes.c_int32), _ptr(winner, ctypes.c_int32),
        _ptr(mode_id, ctypes.c_int32), _ptr(afk, ctypes.c_uint8),
        _ptr(tmax, ctypes.c_int64),
    )
    if n < 0:
        raise WindowDecodeError(int(-n - 1), int(cursor[0]))
    return int(n)
