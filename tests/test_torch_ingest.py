"""The port's ingest plane against the JAX package's: the native CSV scanner
(``io/_native_csv.py`` over ``io/csrc/fastcsv.cc``), ``load_stream_csv``'s
fast path, the columnar decoder (``io/ingest.py``), the staging arena and
``stage_ingest_window`` (``sched/feed.py``), and the tiered table's cold
tier on the arena.

Everything here is integer or byte data: the port must equal the JAX
package EXACTLY (arrays, dtypes, window boundaries, cursors, poison rows
and byte offsets), with tolerance 0. The arena tests mirror
tests/test_ingest.py's ``TestPinnedArena`` on the CPU, where a commit is a
synchronous copy and a deferred release is immediate; the card's pinned
path is held by tests/test_torch_cuda.py.
"""

import io
import os

import numpy as np
import pytest
import torch

from analyzer_tpu.io import _native_csv as j_native
from analyzer_tpu.io import csv_codec as j_codec
from analyzer_tpu.io import ingest as j_ingest
from analyzer_tpu.obs import registry as jreg
from analyzer_tpu.sched.feed import PinnedArena as JaxArena
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core import constants
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.io import _native_csv, csv_codec, ingest
from analyzer_tpu_torch.io.ingest import (
    ColumnarDecoder,
    IngestDecodeError,
    decode_stream_csv,
)
from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
from analyzer_tpu_torch.obs import get_registry
from analyzer_tpu_torch.obs import registry as preg
from analyzer_tpu_torch.obs.registry import reset_registry
from analyzer_tpu_torch.sched import pack_schedule, rate_history
from analyzer_tpu_torch.sched.feed import (
    ARENA_ALIGNMENT,
    PinnedArena,
    get_arena,
    reset_arena,
    stage_ingest_window,
)

CFG = RatingConfig()
ARRAYS = ("player_idx", "winner", "mode_id", "afk")
MODES = list(constants.MODES)


def _csv_bytes(n_matches=300, seed=12, **kw):
    players = synthetic_players(60, seed=seed)
    s = synthetic_stream(n_matches, players, seed=seed, **kw)
    buf = io.StringIO(newline="")
    import csv

    w = csv.writer(buf)
    w.writerow(csv_codec.HEADER)
    for i in range(s.n_matches):
        mode = MODES[s.mode_id[i]] if s.mode_id[i] >= 0 else "unsupported"
        teams = [";".join(str(x) for x in s.player_idx[i, t][s.player_idx[i, t] >= 0])
                 for t in range(2)]
        w.writerow([i, mode, int(s.winner[i]), int(s.afk[i])] + teams)
    return buf.getvalue().encode(), s


RAW = {
    "gating": _csv_bytes(300, afk_rate=0.2, unsupported_rate=0.1)[0],
    "plain": _csv_bytes(120, seed=3)[0],
    "no_header_blank_lines": (
        b"0,ranked,1,0,1;2;3,4;5;6\n\n1,casual_aral,0,1,7;8;9,10;11;12"
    ),
    "crlf": b"0,ranked,1,0,1;2;3,4;5;6\r\n1,blitz_pvp_ranked,0,0,7,8\r\n",
    "empty": b"",
    "header_only": b"match_id,mode,winner,afk,team0,team1\n",
    "quoted": b'0,"ranked",0,0,1;2;3,4;5;6\n',
    "malformed": b"0,ranked,1,0,1;2;3,4;5;6\n1,ranked,z,0,1;2,3;4\n",
    "stray_column": b"0,ranked,1,0,1;2;3,4;5;6,9\n",
    "huge_id": b"0,ranked,1,0,3000000000;2;3,4;5;6\n",
}


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


class TestScannerEqualsJax:
    @pytest.mark.parametrize("name", sorted(RAW))
    def test_parse_stream_csv(self, name):
        got = _native_csv.parse_stream_csv(RAW[name], MODES, max_team=16)
        want = j_native.parse_stream_csv(RAW[name], MODES, max_team=16)
        assert (got is None) == (want is None)
        if want is not None:
            for g, w in zip(got, want):
                _same(g, np.asarray(w))

    @pytest.mark.parametrize("name", ["gating", "plain", "quoted", "stray_column",
                                      "no_header_blank_lines", "crlf"])
    def test_load_stream_csv_from_a_path(self, name, tmp_path):
        path = str(tmp_path / "s.csv")
        with open(path, "wb") as f:
            f.write(RAW[name])
        got, want = csv_codec.load_stream_csv(path), j_codec.load_stream_csv(path)
        for key in ARRAYS:
            _same(getattr(got, key), getattr(want, key))

    def test_fast_path_equals_python_parser(self, tmp_path):
        path = str(tmp_path / "s.csv")
        with open(path, "wb") as f:
            f.write(RAW["gating"])
        fast = csv_codec.load_stream_csv(path)
        slow = csv_codec._parse(io.StringIO(RAW["gating"].decode()))
        for key in ARRAYS:
            _same(getattr(fast, key), getattr(slow, key))

    def test_build_failure_falls_back_and_logs_once(self, tmp_path, monkeypatch,
                                                    capsys):
        def broken():
            raise ImportError("no g++ here")

        monkeypatch.setattr(_native_csv, "load", broken)
        monkeypatch.setattr(csv_codec, "_fallback_logged", False)
        path = str(tmp_path / "s.csv")
        with open(path, "wb") as f:
            f.write(RAW["plain"])
        capsys.readouterr()
        a = csv_codec.load_stream_csv(path)
        b = csv_codec.load_stream_csv(path)
        err = capsys.readouterr().err  # the port's logger writes to stderr
        assert err.count("native CSV scanner unavailable") == 1
        want = j_codec.load_stream_csv(path)
        for key in ARRAYS:
            _same(getattr(a, key), getattr(want, key))
            _same(getattr(b, key), getattr(want, key))

    def test_window_entry_checks_caller_buffers(self):
        w, t = 4, 16
        good = dict(player_idx=np.empty((w, 2, t), np.int32),
                    winner=np.empty(w, np.int32), mode_id=np.empty(w, np.int32),
                    afk=np.empty(w, np.uint8))
        blob = "\n".join(MODES).encode()

        def call(cursor=None, **over):
            bufs = {**good, **over}
            return _native_csv.parse_csv_window(
                RAW["plain"], blob, len(MODES), t,
                np.zeros(1, np.int64) if cursor is None else cursor,
                bufs["player_idx"], bufs["winner"], bufs["mode_id"], bufs["afk"],
            )

        assert call() == w
        for over in (dict(winner=np.empty(w, np.int64)),
                     dict(afk=np.empty(w + 1, np.uint8)),
                     dict(player_idx=np.empty((w, 2, 8), np.int32)),
                     dict(mode_id=np.empty(2 * w, np.int32)[::2])):
            with pytest.raises(ValueError):
                call(**over)
        with pytest.raises(ValueError):
            call(cursor=np.full(1, len(RAW["plain"]) + 1, np.int64))
        with pytest.raises(ValueError):
            call(cursor=np.zeros(1, np.int32))


def _windows(mod, data, window_rows, arena):
    out = []
    dec = mod.ColumnarDecoder(data, window_rows=window_rows, arena=arena)
    for win in dec.windows():
        out.append((win.rows, win.start_row, dec.bytes_consumed,
                    win.player_idx.copy(), win.winner.copy(),
                    win.mode_id.copy(), win.afk.copy()))
        win.release()
    return out


class TestColumnarDecoderEqualsJax:
    @pytest.mark.parametrize("window_rows", [1, 7, 64, 4096])
    @pytest.mark.parametrize("name", ["gating", "plain", "no_header_blank_lines",
                                      "crlf", "empty", "header_only"])
    def test_windows_equal_window_for_window(self, name, window_rows):
        got = _windows(ingest, RAW[name], window_rows, PinnedArena())
        want = _windows(j_ingest, RAW[name], window_rows, JaxArena())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[:3] == w[:3]
            for a, b in zip(g[3:], w[3:]):
                _same(a, b)

    @pytest.mark.parametrize("name", ["gating", "plain", "empty"])
    def test_decode_stream_csv_equals_jax_and_codec(self, name):
        got = decode_stream_csv(RAW[name], window_rows=32, arena=PinnedArena())
        want = j_ingest.decode_stream_csv(RAW[name], window_rows=32,
                                          arena=JaxArena())
        codec = csv_codec._parse(io.StringIO(RAW[name].decode()))
        for key in ARRAYS:
            _same(getattr(got, key), getattr(want, key))
            if codec.n_matches:
                _same(getattr(got, key), getattr(codec, key))

    @pytest.mark.parametrize("bad_row,window_rows", [(0, 2), (5, 2), (5, 4),
                                                     (6, 3), (9, 64)])
    def test_malformed_row_attribution_equals_jax(self, bad_row, window_rows):
        good = b"0,ranked,1,0,1;2;3,4;5;6\n"
        data = good * bad_row + b"5,ranked,z,0,1;2;3,4;5;6\n" + good * 3

        def run(mod, arena):
            seen = 0
            with pytest.raises(mod.IngestDecodeError) as err:
                for win in mod.ColumnarDecoder(
                    data, window_rows=window_rows, arena=arena
                ).windows():
                    seen += win.rows
                    win.release()
            return seen, err.value.row, err.value.byte_offset

        got = run(ingest, PinnedArena())
        assert got == run(j_ingest, JaxArena())
        assert got == (bad_row, bad_row, len(good) * bad_row)

    def test_out_of_int32_ids_poison_the_window(self):
        with pytest.raises(IngestDecodeError) as err:
            list(ColumnarDecoder(RAW["huge_id"], arena=PinnedArena()).windows())
        assert (err.value.row, err.value.byte_offset) == (0, 0)

    def test_quoted_fields_fall_back_and_count(self):
        reset_registry()
        assert decode_stream_csv(RAW["quoted"], arena=PinnedArena()) is None
        dec = ColumnarDecoder(RAW["quoted"], arena=PinnedArena())
        assert not dec.available
        with pytest.raises(RuntimeError):
            next(dec.windows())
        assert get_registry().counter("ingest.fallbacks_total").value == 2

    def test_build_failure_is_a_counted_fallback(self, monkeypatch):
        reset_registry()

        def broken():
            raise ImportError("no g++ here")

        monkeypatch.setattr(_native_csv, "load", broken)
        dec = ColumnarDecoder(RAW["plain"], arena=PinnedArena())
        assert not dec.available
        assert get_registry().counter("ingest.fallbacks_total").value == 1

    def test_decode_counters_move(self):
        reset_registry()
        decode_stream_csv(RAW["plain"][: RAW["plain"].index(b"\n100,")],
                          window_rows=32, arena=PinnedArena())
        reg = get_registry()
        assert reg.counter("ingest.rows_decoded_total").value == 100
        assert reg.counter("ingest.bytes_decoded_total").value > 0
        assert reg.counter("ingest.windows_total").value == 4


class TestPinnedArena:
    """tests/test_ingest.py::TestPinnedArena's assertions on the port."""

    def test_page_alignment(self):
        arena = PinnedArena()
        for shape, dtype in (((64, 2, 16), np.int32), ((7,), np.uint8),
                             ((33, 16), np.float32)):
            buf = arena.take(shape, dtype)
            assert buf.ctypes.data % ARENA_ALIGNMENT == 0
            assert buf.shape == shape and buf.dtype == dtype
            assert buf.flags.c_contiguous
        long_lived = arena.empty((10, 16), np.float32)
        assert long_lived.ctypes.data % ARENA_ALIGNMENT == 0

    def test_steady_state_allocation_is_flat(self):
        reset_registry()
        arena = PinnedArena()
        reg = get_registry()
        for _ in range(50):
            a = arena.take((16, 2, 16), np.int32)
            b = arena.take((16,), np.int32)
            arena.give(a)
            arena.give(b)
        assert reg.counter("ingest.arena_allocs_total").value == 2
        assert reg.counter("ingest.arena_reuses_total").value == 98
        assert arena.stats()["hit_rate"] > 0.9

    def test_commit_round_trips_values(self):
        arena = PinnedArena()
        buf = arena.take((8,), np.int32)
        buf[:] = np.arange(8)
        dev = arena.commit(buf, "cpu")
        np.testing.assert_array_equal(dev.numpy(), np.arange(8))
        buf[:] = -1  # the commit is a copy, not a view of the slab
        np.testing.assert_array_equal(dev.numpy(), np.arange(8))

    def test_deferred_release_returns_to_freelist(self):
        reset_registry()
        arena = PinnedArena()
        buf = arena.take((8,), np.int32)
        dev = arena.commit(buf, "cpu")
        arena.give_when_done(buf, dev)
        buf2 = arena.take((8,), np.int32)  # drains the deferred entry
        assert buf2 is buf  # recycled, not reallocated
        assert get_registry().counter("ingest.arena_allocs_total").value == 1

    def test_empty_buffers_can_be_pooled_if_given(self):
        arena = PinnedArena()
        cold = arena.empty((4, 16), np.float32)
        arena.give(cold)
        other = arena.take((4, 16), np.float32)
        assert other is cold

    def test_stats_shape(self):
        st = PinnedArena().stats()
        assert set(st) == set(JaxArena().stats())
        assert set(st) == {"allocs", "reuses", "hit_rate", "bytes", "pinned"}
        assert st["pinned"] is False  # unresolved until the first commit

    def test_cpu_commits_report_unpinned(self):
        arena = PinnedArena()
        arena.commit(arena.take((4,), np.int32), "cpu")
        assert arena.stats()["pinned"] is False

    def test_tensor_owns_the_view_memory(self):
        arena = PinnedArena()
        buf = arena.take((3, 5), np.float32)
        t = arena.tensor(buf)
        assert t.dtype == torch.float32 and tuple(t.shape) == (3, 5)
        assert t.data_ptr() == buf.ctypes.data
        buf[:] = 7.0
        assert float(t.sum()) == 105.0
        with pytest.raises(ValueError):
            arena.tensor(np.zeros((3, 5), np.float32))

    def test_dropped_buffer_is_forgotten(self):
        reset_registry()
        arena = PinnedArena()
        gauge = get_registry().gauge("ingest.arena_bytes")
        keep = arena.empty((8, 16), np.float32)
        cold = arena.empty((100, 16), np.float32)
        assert gauge.value == keep.nbytes + cold.nbytes
        del cold
        assert gauge.value == keep.nbytes
        assert arena.stats()["bytes"] == keep.nbytes

    def test_process_arena_resets(self):
        a = reset_arena()
        assert get_arena() is a
        assert reset_arena() is not a


class TestStageIngestWindow:
    def test_commits_values_and_recycles_slabs(self):
        reset_registry()
        data = RAW["plain"][: RAW["plain"].index(b"\n100,") + 1]
        arena = PinnedArena()
        ref = csv_codec._parse(io.StringIO(data.decode()))
        t = ref.player_idx.shape[2]
        rows_seen = 0
        for win in ColumnarDecoder(data, window_rows=32, arena=arena).windows():
            n, pidx, winner, mode_id, afk = stage_ingest_window(win, arena, "cpu")
            assert pidx.device.type == "cpu" and pidx.shape == (32, 2, 16)
            np.testing.assert_array_equal(
                pidx.numpy()[:n, :, :t], ref.player_idx[rows_seen:rows_seen + n]
            )
            np.testing.assert_array_equal(
                winner.numpy()[:n], ref.winner[rows_seen:rows_seen + n]
            )
            np.testing.assert_array_equal(
                mode_id.numpy()[:n], ref.mode_id[rows_seen:rows_seen + n]
            )
            np.testing.assert_array_equal(
                afk.numpy()[:n].astype(bool), ref.afk[rows_seen:rows_seen + n]
            )
            rows_seen += n
        assert rows_seen == 100
        reg = get_registry()
        assert reg.counter("ingest.arena_allocs_total").value <= 8
        assert reg.counter("ingest.h2d_commits_total").value == 16
        spans = [e for e in __import__(
            "analyzer_tpu_torch.obs", fromlist=["get_tracer"]
        ).get_tracer().events() if e.get("name") == "ingest.commit"]
        assert spans and spans[-1]["args"]["rows"] == 100 - 96

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible: the default would run")
        arena = PinnedArena()
        win = next(ColumnarDecoder(RAW["plain"], arena=arena).windows())
        with pytest.raises(RuntimeError, match="CUDA"):
            stage_ingest_window(win, arena)


class TestTierColdArena:
    def test_cold_tier_is_arena_allocated_and_aligned(self):
        from analyzer_tpu_torch.sched.tier import TierManager

        reset_registry()
        reset_arena()
        state = PlayerState.create(50, cfg=CFG, device="cpu")
        tm = TierManager(state, hot_rows=16)
        assert tm._host_table.ctypes.data % ARENA_ALIGNMENT == 0
        reg = get_registry()
        assert reg.counter("ingest.arena_allocs_total").value >= 1
        assert reg.gauge("ingest.arena_bytes").value >= tm._host_table.nbytes
        assert get_arena().tensor(tm._host_table) is tm._host_tensor
        np.testing.assert_array_equal(tm._host_table, state.table.numpy())

    def test_tiered_run_still_bit_identical(self):
        players = synthetic_players(40, seed=9)
        stream = synthetic_stream(120, players, seed=9)
        state = PlayerState.create(40, cfg=CFG, device="cpu")
        sched = pack_schedule(stream, pad_row=state.pad_row)
        plain, _ = rate_history(state, sched, CFG)
        tiered, _ = rate_history(state, sched, CFG, hot_rows=16)
        np.testing.assert_array_equal(plain.table.numpy(), tiered.table.numpy())


def test_ingest_schema_equals_jax():
    def ours(names):
        return sorted(n for n in names if n.startswith("ingest."))

    for cat in ("STANDARD_COUNTERS", "STANDARD_GAUGES", "SPAN_CATALOG"):
        assert ours(getattr(preg, cat)) == ours(getattr(jreg, cat)), cat
    for key in ours(jreg.SCHEMA_HELP):
        assert preg.SCHEMA_HELP[key] == jreg.SCHEMA_HELP[key], key
    assert ours(preg.SCHEMA_HELP) == ours(jreg.SCHEMA_HELP)


def test_no_scanner_build_at_import():
    import subprocess
    import sys

    probe = ("from analyzer_tpu_torch.io import _native_csv, ingest, csv_codec\n"
             "assert _native_csv._lib is None\n")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
