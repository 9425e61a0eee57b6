"""ctypes loader for the native columnar sqlite scanner (``csrc/fastsql.cc``).

The port's copy of ``analyzer_tpu.service._native_sql``. The library is
built with g++ from the checkout's source into ``analyzer_tpu_torch/_build/``
the first time a store asks for it (:mod:`analyzer_tpu_torch.native_build`),
never at import. :func:`load` raises ImportError on ANY build or load
failure, so the store's python bulk scans engage instead (logged and
counted in ``sql.native_fallbacks_total``). ``fastsql.cc`` itself dlopens
``libsqlite3.so.0`` at first use — a host without the library fails at call
time, which the wrappers convert to RuntimeError for the same fallback
treatment. Unlike the JAX package's copy, a scan waits up to 30 s on a lock
another connection holds (the python store's ``busy_timeout``) instead of
failing at once: under a pipelined worker a batch load can meet the
writer's commit or WAL checkpoint.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from analyzer_tpu_torch.native_build import build_and_load

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "fastsql.cc")
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
            lib = build_and_load("fastsql", COMMAND, [_SRC])
        except (OSError, RuntimeError) as e:
            raise ImportError(f"native sqlite scanner unavailable: {e}") from e
        lib.sq_scan_open.argtypes = [
            ctypes.c_char_p,                  # db path
            ctypes.c_char_p,                  # sql
            ctypes.c_int32,                   # ncols
            ctypes.POINTER(ctypes.c_int32),   # spec
            ctypes.c_char_p,                  # err
            ctypes.c_int32,                   # errlen
        ]
        lib.sq_scan_open.restype = ctypes.c_void_p
        lib.sq_scan_nrows.argtypes = [ctypes.c_void_p]
        lib.sq_scan_nrows.restype = ctypes.c_int64
        lib.sq_scan_width.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.sq_scan_width.restype = ctypes.c_int64
        lib.sq_scan_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.sq_scan_copy.restype = ctypes.c_int32
        lib.sq_scan_free.argtypes = [ctypes.c_void_p]
        lib.sq_scan_free.restype = None
        lib.sq_cumcount.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sq_cumcount.restype = ctypes.c_int32
        lib.sq_lookup.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sq_lookup.restype = ctypes.c_int32
        _lib = lib
        return _lib


_KIND = {"str": 0, "int": 1, "float": 2}
_ERRLEN = 512


def scan_query(path: str, sql: str, cols: list[tuple[str, str]]) -> dict:
    """Runs ``sql`` (read-only, by path — committed data only, like the
    python bulk path's second connection) and returns ``{name: array}``:
    fixed-width bytes (``S``) for ``"str"`` columns, int64 for ``"int"``
    (NULL -> 0), float64 for ``"float"`` (NULL -> NaN) — the exact dtype
    and NULL conventions of ``SqlStore._sqlite_bulk``.

    One pass over the query: the C side buffers each column (string
    values in a byte arena) and numpy arrays fill by memcpy. Raises
    RuntimeError on any sqlite error; callers fall back to the python
    scan.
    """
    _l = load()
    spec = np.array([_KIND[k] for _, k in cols], np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    h = _l.sq_scan_open(
        path.encode(), sql.encode(), len(cols),
        spec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), err, _ERRLEN,
    )
    if not h:
        raise RuntimeError(f"native sqlite scan failed: {err.value.decode()}")
    try:
        n = _l.sq_scan_nrows(h)
        arrays: dict[str, np.ndarray] = {}
        for c, (name, kind) in enumerate(cols):
            if kind == "str":
                width = max(int(_l.sq_scan_width(h, c)), 1)
                a = np.empty(n, dtype=f"S{width}")
            elif kind == "int":
                a = np.empty(n, np.int64)
            else:
                a = np.empty(n, np.float64)
            if n:
                rc = _l.sq_scan_copy(
                    h, c, ctypes.c_void_p(a.ctypes.data), a.dtype.itemsize
                )
                if rc != 0:
                    raise RuntimeError(
                        f"native sqlite scan: copy failed for column {name}"
                    )
            arrays[name] = a
        return arrays
    finally:
        _l.sq_scan_free(h)


def cumcount(keys: np.ndarray, minlength: int) -> np.ndarray:
    """Arrival-order occurrence index within each key group (the numpy
    version needs a stable argsort + segmented arange). ``keys`` must be
    int64 in ``[0, minlength)`` — the C loop now enforces the bound per
    element (rc=-2) instead of trusting the caller, so a future caller
    that violates it raises here (and sql_store falls back to the numpy
    path) rather than silently corrupting heap memory."""
    _l = load()
    keys = np.ascontiguousarray(keys, np.int64)
    out = np.empty(keys.size, np.int64)
    if keys.size == 0:
        return out
    rc = _l.sq_cumcount(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), keys.size,
        int(minlength), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc == -2:
        raise RuntimeError(
            "native cumcount: key outside [0, minlength) — caller bug"
        )
    if rc != 0:
        raise RuntimeError("native cumcount: counter allocation failed")
    return out


def lookup(keys: np.ndarray, needles: np.ndarray) -> np.ndarray:
    """Vectorized id join: index of each ``needle`` in ``keys`` (both
    fixed-width ``S`` arrays), -1 for misses; duplicate keys resolve to
    the smallest index — exactly numpy's stable argsort + searchsorted-
    left join, but via an FNV-1a hash table in C (the numpy version costs
    ~4.3 s at the 7.3M-needle scale, this a few hundred ms). Returns
    int64 ``[len(needles)]``.
    """
    if keys.dtype.kind != "S" or needles.dtype.kind != "S":
        raise TypeError("lookup joins fixed-width bytes (S) id arrays")
    _l = load()
    keys = np.ascontiguousarray(keys)
    needles = np.ascontiguousarray(needles)
    out = np.empty(needles.size, np.int64)
    if needles.size == 0:
        return out
    if keys.size == 0:
        out.fill(-1)
        return out
    rc = _l.sq_lookup(
        ctypes.c_char_p(keys.ctypes.data), keys.dtype.itemsize, keys.size,
        ctypes.c_char_p(needles.ctypes.data), needles.dtype.itemsize,
        needles.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise RuntimeError("native id join: hash table allocation failed")
    return out
