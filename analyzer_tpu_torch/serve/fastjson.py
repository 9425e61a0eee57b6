"""Response codec for the serve front door: native fast path + counted
python fallback.

The port's copy of ``analyzer_tpu.serve.fastjson``: the same bytes for the
same response dicts. The native library is built at the first
:class:`ResponseCodec` (:func:`native_available`), never at import.

:class:`ResponseCodec` renders the four hot ``/v1/*`` response shapes
(ratings, leaderboard, winprob, tiers — the dicts
:class:`~analyzer_tpu_torch.serve.engine.QueryEngine` resolves) to the exact
bytes ``json.dumps(obj, sort_keys=True) + "\\n"`` would produce — the
wire contract every client of the RoutedHTTPServer path already parses.
The fast path packs each response's numeric fields into reusable numpy
slabs and hands them to ``csrc/fastjson.cc`` (built on demand via
``native_build.build_and_load``), which formats floats with CPython's
repr algorithm and writes the whole body into a reusable output arena:
no per-response dict-to-str walk on the hot path.

Route discipline: anything the fast path does not recognize — an
unexpected key (a fabric ``versions`` vector, a future field), a
non-float where a float belongs, a string that will not encode — falls
back to the python encoder, bit-identical by construction, and is
COUNTED (``frontdoor.codec_fallbacks_total`` + :attr:`fallbacks`):
``FrontDoor.codec_stats()`` reports ``native: false`` when the fallback
carried any response.

NaN/inf guarantee: a non-finite float raises :class:`ValueError`
instead of encoding — JSON has no NaN/Infinity and the engine never
produces one (unrated rows render null), so a non-finite here is a bug
upstream, not a value to serialize (``json.dumps`` would happily emit
python-only ``NaN`` and break every client).

One codec instance is single-threaded (reusable arenas); the front
door builds one per reader thread.
"""

from __future__ import annotations

import ctypes
import json
from itertools import accumulate as _accumulate

import numpy as np

from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs import get_registry
from analyzer_tpu_torch.serve import _native_json

logger = get_logger(__name__)

_native_state: list = []  # [bool] once the first codec asked


def native_available() -> bool:
    """True when the native encoder built and loaded in this process (the
    build runs at the first call; a failure is logged once and every
    codec then takes the counted python route)."""
    if not _native_state:
        try:
            _native_json.load()
            _native_state.append(True)
        except ImportError as err:
            logger.warning("native response codec off: %s", err)
            _native_state.append(False)
    return _native_state[0]

# Shape recognition relies on the oracle sorting keys: a dict with
# exactly the expected key SET encodes identically regardless of
# insertion order, so `len(d) == N` plus N successful lookups (KeyError
# falls back) proves the set without building comparison tuples.


class _Fallback(Exception):
    """Internal: this response is not fast-path-shaped."""


def _dumps(obj) -> bytes:
    # The codec's designated python fallback — the json.dumps oracle the
    # native path is differential-pinned against (every other serve/ hot
    # path must come here or go native).
    return (json.dumps(obj, sort_keys=True) + "\n").encode("utf-8")


def _float(x) -> float:
    if type(x) is not float:
        raise _Fallback
    return x


def _int(x) -> int:
    if type(x) is not int:
        raise _Fallback
    return x


class ResponseCodec:
    """Encodes serve responses to wire bytes; see the module docstring.

    :attr:`native` is this instance's route (False when the extension
    failed to build); :attr:`encodes`/:attr:`fallbacks` count traffic
    for the bench block's ``native`` flag.
    """

    def __init__(self, arena_bytes: int = 1 << 16) -> None:
        self.native = native_available()
        self.encodes = 0
        self.fallbacks = 0
        if self.native:
            self._lib = _native_json.load()
            self._out = ctypes.create_string_buffer(arena_bytes)
            self._vals = np.zeros((256, 5), np.float64)
            self._vals3 = np.zeros((256, 3), np.float64)
            self._flags = np.zeros(256, np.uint8)
            self._ranks = np.zeros(256, np.int64)
            self._off = np.zeros(257, np.int64)
            self._unk_off = np.zeros(257, np.int64)
            self._counts = np.zeros(64, np.int64)
            self._edges = np.zeros(64, np.float64)

    # -- arena plumbing ---------------------------------------------------
    def _grow_rows(self, n: int) -> None:
        cap = len(self._flags)
        while cap < n:
            cap *= 2
        if cap != len(self._flags):
            self._vals = np.zeros((cap, 5), np.float64)
            self._vals3 = np.zeros((cap, 3), np.float64)
            self._flags = np.zeros(cap, np.uint8)
            self._ranks = np.zeros(cap, np.int64)
            self._off = np.zeros(cap + 1, np.int64)

    def _pack_ids(self, ids, off: np.ndarray) -> bytes:
        n = len(ids)
        try:
            blob = "".join(ids).encode("utf-8")
        except (TypeError, UnicodeEncodeError) as err:  # non-str / lone
            raise _Fallback from err                    # surrogates
        lens = list(map(len, ids))
        if len(blob) == sum(lens):  # pure ASCII: char offsets == bytes
            off[0] = 0
            off[1:n + 1] = list(_accumulate(lens))
            return blob
        pos = 0
        for i, s in enumerate(ids):
            off[i] = pos
            pos += len(s.encode("utf-8"))
        off[n] = pos
        return blob

    def _call(self, fn, *args) -> bytes:
        """One encoder call with grow-and-retry on arena overflow."""
        while True:
            n = fn(*args, self._out, len(self._out))
            if n >= 0:
                return self._out.raw[:n]
            if n == -2:
                raise ValueError(
                    "non-finite float in a serve response — JSON has no "
                    "NaN/Infinity and the engine never emits one"
                )
            if n == -3:
                raise _Fallback
            self._out = ctypes.create_string_buffer(len(self._out) * 2)

    # -- public surface ---------------------------------------------------
    def encode(self, kind: str, obj: dict) -> bytes:
        """``json.dumps(obj, sort_keys=True) + "\\n"`` as UTF-8 bytes,
        natively when ``obj`` matches the engine's ``kind`` shape."""
        self.encodes += 1
        if self.native:
            try:
                return getattr(self, "_encode_" + kind)(obj)
            except (_Fallback, KeyError, TypeError, AttributeError):
                pass  # not fast-path-shaped: counted python route
        self.fallbacks += 1
        get_registry().counter("frontdoor.codec_fallbacks_total").add(1)
        return _dumps(obj)

    # -- per-shape fast paths ---------------------------------------------
    def _encode_ratings(self, obj: dict) -> bytes:
        if len(obj) != 3:
            raise _Fallback
        version = _int(obj["version"])
        entries = obj["ratings"]
        unknown = obj["unknown"]
        if type(entries) is not list or type(unknown) is not list:
            raise _Fallback
        n = len(entries)
        self._grow_rows(n)
        flags_l = []
        rows = []
        for e in entries:
            if len(e) != 7:
                raise _Fallback
            rated = e["rated"]
            seed_mu = e["seed_mu"]
            seed_sigma = e["seed_sigma"]
            if type(seed_mu) is not float or type(seed_sigma) is not float:
                raise _Fallback
            if rated is True:
                mu, sg, cons = e["mu"], e["sigma"], e["conservative"]
                if (type(mu) is not float or type(sg) is not float
                        or type(cons) is not float):
                    raise _Fallback
                flags_l.append(1)
                rows.append((mu, sg, cons, seed_mu, seed_sigma))
            elif rated is False:
                if (e["mu"] is not None or e["sigma"] is not None
                        or e["conservative"] is not None):
                    raise _Fallback
                flags_l.append(0)
                rows.append((0.0, 0.0, 0.0, seed_mu, seed_sigma))
            else:
                raise _Fallback
        if n:
            self._vals[:n] = rows
            self._flags[:n] = flags_l
        blob = self._pack_ids([e["id"] for e in entries], self._off)
        m = len(unknown)
        if m + 1 > len(self._unk_off):
            self._unk_off = np.zeros(m + 1, np.int64)
        unk_blob = self._pack_ids(unknown, self._unk_off)
        return self._call(
            self._lib.fj_encode_ratings,
            n, blob, _p_i64(self._off), _p_u8(self._flags),
            _p_f64(self._vals), m, unk_blob, _p_i64(self._unk_off), version,
        )

    def _encode_leaderboard(self, obj: dict) -> bytes:
        if len(obj) != 2:
            raise _Fallback
        version = _int(obj["version"])
        leaders = obj["leaders"]
        if type(leaders) is not list:
            raise _Fallback
        n = len(leaders)
        self._grow_rows(n)
        rows = []
        ranks_l = []
        ids = []
        for e in leaders:
            if len(e) != 5:
                raise _Fallback
            mu, sg, cons, r = e["mu"], e["sigma"], e["conservative"], e["rank"]
            if not (type(mu) is float and type(sg) is float
                    and type(cons) is float and type(r) is int):
                raise _Fallback
            rows.append((mu, sg, cons))
            ranks_l.append(r)
            ids.append(e["id"])
        if n:
            self._vals3[:n] = rows
            self._ranks[:n] = ranks_l
        blob = self._pack_ids(ids, self._off)
        return self._call(
            self._lib.fj_encode_leaderboard,
            n, _p_i64(self._ranks), blob, _p_i64(self._off),
            _p_f64(self._vals3), version,
        )

    def _encode_winprob(self, obj: dict) -> bytes:
        if len(obj) != 3:
            raise _Fallback
        return self._call(
            self._lib.fj_encode_winprob,
            _float(obj["p_a"]), _float(obj["quality"]),
            _int(obj["version"]),
        )

    def _encode_tiers(self, obj: dict) -> bytes:
        if len(obj) == 4:
            has_score = 0
        elif len(obj) == 7:
            has_score = 1
        else:
            raise _Fallback
        edges = obj["edges"]
        counts = obj["counts"]
        if type(edges) is not list or type(counts) is not list:
            raise _Fallback
        ne, nc = len(edges), len(counts)
        if ne > len(self._edges) or nc > len(self._counts):
            self._edges = np.zeros(max(ne, len(self._edges) * 2), np.float64)
            self._counts = np.zeros(max(nc, len(self._counts) * 2), np.int64)
        for e in edges:
            if type(e) is not float:
                raise _Fallback
        for c in counts:
            if type(c) is not int:
                raise _Fallback
        if ne:
            self._edges[:ne] = edges
        if nc:
            self._counts[:nc] = counts
        score = below = 0
        has_pct = 0
        pct = 0.0
        if has_score:
            score = _float(obj["score"])
            below = _int(obj["below"])
            if obj["percentile"] is not None:
                has_pct = 1
                pct = _float(obj["percentile"])
        return self._call(
            self._lib.fj_encode_tiers,
            _p_f64(self._edges), ne, _p_i64(self._counts), nc,
            _int(obj["rated"]), _int(obj["version"]),
            has_score, float(score), int(below), has_pct, pct,
        )


def _p_f64(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _p_i64(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _p_u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
