"""ctypes loader for the native response codec (``csrc/fastjson.cc``).

The port's copy of ``analyzer_tpu.serve._native_json``. The library is
built with g++ from the checkout's source into ``analyzer_tpu_torch/_build/``
the first time a caller asks for it (:mod:`analyzer_tpu_torch.native_build`),
never at import. :func:`load` raises ImportError on ANY build or load
failure, so the caller's python ``json.dumps`` encoder engages instead,
counted (``frontdoor.codec_fallbacks_total``; ``FrontDoor.codec_stats()``
reports ``native: false``).

The argtypes/restype declarations below are the ABI contract with the
``extern "C"`` signatures in the ``.cc`` — keep them in lockstep.
"""

from __future__ import annotations

import ctypes
import os
import threading

from analyzer_tpu_torch.native_build import build_and_load

_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "csrc", "fastjson.cc"
)
COMMAND = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    """The codec library, built on first call. ImportError when it cannot
    be built or loaded (no g++, a read-only checkout, a broken
    toolchain)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = build_and_load("fastjson", COMMAND, [_SRC])
        except (OSError, RuntimeError) as e:
            raise ImportError(f"native response codec unavailable: {e}") from e
        lib.fj_repr_double.argtypes = [ctypes.c_double, ctypes.c_char_p]
        lib.fj_repr_double.restype = ctypes.c_int64
        lib.fj_encode_ratings.argtypes = [
            ctypes.c_int64,                    # n
            ctypes.c_char_p,                   # ids blob
            ctypes.POINTER(ctypes.c_int64),    # ids offsets [n+1]
            ctypes.POINTER(ctypes.c_uint8),    # rated flags [n]
            ctypes.POINTER(ctypes.c_double),   # vals [n, 5]
            ctypes.c_int64,                    # n_unknown
            ctypes.c_char_p,                   # unknown blob
            ctypes.POINTER(ctypes.c_int64),    # unknown offsets
            ctypes.c_int64,                    # version
            ctypes.c_char_p,                   # out arena
            ctypes.c_int64,                    # arena bytes
        ]
        lib.fj_encode_ratings.restype = ctypes.c_int64
        lib.fj_encode_leaderboard.argtypes = [
            ctypes.c_int64,                    # n
            ctypes.POINTER(ctypes.c_int64),    # ranks [n]
            ctypes.c_char_p,                   # ids blob
            ctypes.POINTER(ctypes.c_int64),    # ids offsets [n+1]
            ctypes.POINTER(ctypes.c_double),   # vals [n, 3]
            ctypes.c_int64,                    # version
            ctypes.c_char_p,                   # out arena
            ctypes.c_int64,                    # arena bytes
        ]
        lib.fj_encode_leaderboard.restype = ctypes.c_int64
        lib.fj_encode_winprob.argtypes = [
            ctypes.c_double,                   # p_a
            ctypes.c_double,                   # quality
            ctypes.c_int64,                    # version
            ctypes.c_char_p,                   # out arena
            ctypes.c_int64,                    # arena bytes
        ]
        lib.fj_encode_winprob.restype = ctypes.c_int64
        lib.fj_encode_tiers.argtypes = [
            ctypes.POINTER(ctypes.c_double),   # edges
            ctypes.c_int64,                    # n_edges
            ctypes.POINTER(ctypes.c_int64),    # counts
            ctypes.c_int64,                    # n_counts
            ctypes.c_int64,                    # rated
            ctypes.c_int64,                    # version
            ctypes.c_int32,                    # has_score
            ctypes.c_double,                   # score
            ctypes.c_int64,                    # below
            ctypes.c_int32,                    # has_pct
            ctypes.c_double,                   # percentile
            ctypes.c_char_p,                   # out arena
            ctypes.c_int64,                    # arena bytes
        ]
        lib.fj_encode_tiers.restype = ctypes.c_int64
        _lib = lib
        return lib


def repr_double(v: float) -> bytes:
    """CPython ``repr(float)`` bytes via the native formatter. Raises
    ValueError for non-finite ``v`` (the NaN/inf-free guarantee)."""
    buf = ctypes.create_string_buffer(32)
    n = load().fj_repr_double(float(v), buf)
    if n < 0:
        raise ValueError(f"non-finite float {v!r} has no JSON rendering")
    return buf.raw[:n]
