"""The port's streamed feed: ``assign_batches`` with progress publishing and
``rate_stream``.

Against the JAX package: the assignment (native and python loops) byte for
byte, progress included; ``rate_stream``'s schedule observables exactly;
its final table within the tolerances of tests/test_torch_fused.py (the
two packages' transcendentals and sum orders differ in the last ulps,
tests/test_torch_ops.py), with the NaN pattern exact. Inside the port:
``rate_stream`` equals ``rate_history(pack_schedule(...))`` at the same
batch size BIT FOR BIT — tables and collected outputs — at every chunking,
prefetch depth, kernel and fuse window, on filler-heavy, chain-bound and
empty streams.
"""

import sys

import numpy as np
import pytest

import analyzer_tpu.sched as jsched
from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.core.state import PlayerState as JaxPlayerState
from analyzer_tpu.io import synthetic as jsynth
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.io import synthetic
from analyzer_tpu_torch.sched import (
    MatchStream,
    _native,
    pack_schedule,
    rate_history,
    rate_stream,
    superstep,
)

CFG = RatingConfig()
JCFG = JaxRatingConfig()
OUT_FIELDS = ("quality", "shared_mu", "shared_sigma", "delta",
              "mode_mu", "mode_sigma", "any_afk", "updated")
RTOL, ATOL = 2e-6, 2e-3

CASES = {
    "plain": dict(n_matches=300, n_players=60, seed=11),
    "filler_heavy": dict(n_matches=240, n_players=50, seed=7, afk_rate=0.4,
                         unsupported_rate=0.3),
    "chain_bound": dict(n_matches=120, n_players=14, seed=3),
    "long": dict(n_matches=5000, n_players=900, seed=5,
                 activity_concentration=0.8, max_activity_share=1e-2),
}


def _case(name):
    kw = dict(CASES[name])
    n, p, seed = kw.pop("n_matches"), kw.pop("n_players"), kw.pop("seed")
    players = synthetic.synthetic_players(p, seed=seed)
    stream = synthetic.synthetic_stream(n, players, seed=seed, **kw)
    jplayers = jsynth.synthetic_players(p, seed=seed)
    jstream = jsynth.synthetic_stream(n, jplayers, seed=seed, **kw)
    feats = (players.rank_points_ranked, players.rank_points_blitz,
             players.skill_tier)
    return (PlayerState.create(p, *feats, device="cpu"), stream,
            JaxPlayerState.create(p, *feats), jstream)


def _empty():
    stream = MatchStream(np.empty((0, 2, 5), np.int32), np.empty(0), np.empty(0),
                         np.empty(0, bool))
    return PlayerState.create(10, device="cpu"), stream


class TestAssignBatches:
    @pytest.mark.parametrize("name", ["plain", "long", "filler_heavy"])
    @pytest.mark.parametrize("cap", [1, 8, 64])
    def test_native_and_python_equal_jax(self, name, cap):
        _s, stream, _j, jstream = _case(name)
        n = stream.n_matches
        want_b, want_s = jsched.assign_batches(jstream, cap)
        want_prog = np.zeros(2, np.int64)
        jsched.assign_batches(jstream, cap, want_prog, np.empty(n, np.int64),
                              np.empty(n, np.int64))
        calls = []
        for path in ("native", "python"):
            prog = np.full(2, -7, np.int64)
            out_b, out_s = np.full(n, -9, np.int64), np.full(n, -9, np.int64)
            if path == "native":
                assert _native.load() is not None, "g++ is expected here"
                got = superstep.assign_batches(stream, cap, prog, out_b, out_s)
            else:
                got = superstep._assign_batches_first_fit_py(
                    stream, cap, prog, out_b, out_s,
                    on_progress=lambda: calls.append(int(prog[0])),
                )
            assert got[0] is out_b and got[1] is out_s
            np.testing.assert_array_equal(out_b, want_b)
            np.testing.assert_array_equal(out_s, want_s)
            np.testing.assert_array_equal(prog, want_prog)
            assert tuple(prog) == (n, int(want_b.max()) + 1)
        every = superstep._PY_PROGRESS_EVERY
        assert calls == list(range(every, n, every))

    def test_empty_stream_progress(self):
        _state, stream = _empty()
        for fn in (superstep.assign_batches, superstep._assign_batches_first_fit_py):
            prog = np.full(2, 5, np.int64)
            fn(stream, 8, prog, np.empty(0, np.int64), np.empty(0, np.int64))
            assert tuple(prog) == (0, 0)

    @pytest.mark.parametrize("bad", ["dtype", "size", "strided", "progress"])
    def test_buffers_are_validated(self, bad):
        _s, stream, _j, _js = _case("plain")
        n = stream.n_matches
        out, out_s, prog = np.empty(n, np.int64), np.empty(n, np.int64), None
        if bad == "dtype":
            out = np.empty(n, np.int32)
        elif bad == "size":
            out_s = np.empty(n + 1, np.int64)
        elif bad == "strided":
            out = np.empty(2 * n, np.int64)[::2]
        else:
            prog = np.zeros(3, np.int64)
        for fn in (superstep.assign_batches, superstep._assign_batches_first_fit_py):
            with pytest.raises(ValueError, match="C-contiguous int64"):
                fn(stream, 8, prog, out, out_s)
        lib = _native.load()
        with pytest.raises(ValueError, match="C-contiguous int64"):
            _native.assign_batches_first_fit(lib, stream, 8, prog, out, out_s)


def _assert_same(a, a_out, b, b_out):
    assert np.array_equal(a.table.numpy(), b.table.numpy(), equal_nan=True)
    for f in OUT_FIELDS:
        np.testing.assert_array_equal(getattr(a_out, f), getattr(b_out, f),
                                      err_msg=f)


def _history(state, stream, batch_size, **kw):
    sched = pack_schedule(stream, pad_row=state.pad_row, batch_size=batch_size,
                          windowed=True)
    return sched, rate_history(state, sched, CFG, collect=True, **kw)


class TestRateStreamInPort:
    @pytest.mark.parametrize("spc", [7, 64])
    @pytest.mark.parametrize("depth", [1, 3])
    @pytest.mark.parametrize("kernel,window", [
        ("reference", None), ("fused", 1), ("fused", 4), ("fused", 16),
    ])
    def test_equals_rate_history(self, spc, depth, kernel, window):
        state, stream, _j, _js = _case("plain")
        _sched, (want, want_out) = _history(state, stream, 8)
        got, got_out = rate_stream(
            state, stream, CFG, collect=True, batch_size=8, steps_per_chunk=spc,
            prefetch_depth=depth, kernel=kernel, fuse_window=window,
        )
        _assert_same(got, got_out, want, want_out)

    @pytest.mark.parametrize("name", ["filler_heavy", "chain_bound"])
    @pytest.mark.parametrize("kernel", ["reference", "fused"])
    def test_filler_heavy_and_chain_bound(self, name, kernel):
        state, stream, _j, _js = _case(name)
        sched, (want, want_out) = _history(state, stream, 8)
        stats = {}
        got, got_out = rate_stream(
            state, stream, CFG, collect=True, batch_size=8, steps_per_chunk=5,
            kernel=kernel, stats_out=stats,
        )
        _assert_same(got, got_out, want, want_out)
        assert (stats["n_steps"], stats["batch_size"]) == (sched.n_steps, 8)
        assert stats["occupancy"] == pytest.approx(sched.occupancy)
        if name == "chain_bound":
            assert stats["occupancy"] < 0.5

    @pytest.mark.parametrize("assigner", ["native", "python"])
    def test_threads_under_a_tiny_switch_interval(self, monkeypatch, assigner):
        """The assigner, feed and consumer threads interleaved as finely
        as the interpreter allows (and, natively, the assigner running
        without the GIL): what is emitted does not depend on timing."""
        state, stream, _j, _js = _case("long")
        _sched, (want, want_out) = _history(state, stream, 64)
        if assigner == "python":
            monkeypatch.setattr(_native, "load", lambda: None)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            got, got_out = rate_stream(
                state, stream, CFG, collect=True, batch_size=64,
                steps_per_chunk=3, prefetch_depth=1, poll_interval=1e-4,
            )
        finally:
            sys.setswitchinterval(old)
        _assert_same(got, got_out, want, want_out)

    def test_caller_state_untouched_and_hook(self):
        state, stream, _j, _js = _case("plain")
        before = state.table.clone()
        seen = []
        got, _ = rate_stream(state, stream, CFG, batch_size=8, steps_per_chunk=9,
                             on_chunk=lambda st, step: seen.append(step))
        assert np.array_equal(state.table.numpy(), before.numpy(), equal_nan=True)
        assert seen == sorted(seen) and seen[-1] >= 1 and len(seen) > 1
        assert not np.array_equal(got.table.numpy(), before.numpy(), equal_nan=True)

    @pytest.mark.parametrize("collect", [False, True])
    def test_empty_stream(self, collect):
        state, stream = _empty()
        stats = {}
        got, out = rate_stream(state, stream, CFG, collect=collect, stats_out=stats)
        assert np.array_equal(got.table.numpy(), state.table.numpy(), equal_nan=True)
        assert stats == dict(n_steps=0, batch_size=0, occupancy=0.0,
                             choose_batch_size_s=0.0)
        assert (out is None) != collect
        if collect:
            assert out.quality.shape == (0,)

    def test_unported_options_and_bad_rows_raise(self):
        """Every option of ``rate_stream`` is ported: ``mesh=`` runs the
        sharded feed (equal to the single-device run bit for bit) and
        refuses, as the JAX package does, what does not compose with it
        (``collect``, ``kernel="fused"``, ``hot_rows``); ``hot_rows`` and
        ``view_publisher`` run."""
        from analyzer_tpu_torch.parallel import make_mesh
        from analyzer_tpu_torch.serve import ViewPublisher

        state, stream, _j, _js = _case("plain")
        mesh = make_mesh(2, device="cpu")
        for kw, text in ((dict(collect=True), "collect"),
                         (dict(kernel="fused"), "kernel='fused'"),
                         (dict(hot_rows=8), "hot_rows")):
            with pytest.raises(ValueError, match=text):
                rate_stream(state, stream, CFG, mesh=mesh, **kw)
        want, _ = rate_stream(state, stream, CFG)
        sharded, _ = rate_stream(state, stream, CFG, mesh=mesh)
        assert np.array_equal(sharded.table.numpy(), want.table.numpy(),
                              equal_nan=True)
        pub = ViewPublisher(device="cpu")
        got, _ = rate_stream(state, stream, CFG, hot_rows=4096, view_publisher=pub)
        assert np.array_equal(got.table.numpy(), want.table.numpy(), equal_nan=True)
        n = state.n_players
        assert np.array_equal(pub.current().host_table()[:n],
                              want.table.numpy()[:n], equal_nan=True)
        small = PlayerState.create(10, device="cpu")
        with pytest.raises(ValueError, match="player row"):
            rate_stream(small, stream, CFG)


class TestRateStreamAgainstJax:
    @pytest.mark.parametrize("name", ["plain", "filler_heavy", "chain_bound"])
    @pytest.mark.parametrize("batch_size", [None, 8])
    def test_stats_and_table(self, name, batch_size):
        state, stream, jstate, jstream = _case(name)
        stats, jstats = {}, {}
        got, got_out = rate_stream(state, stream, CFG, collect=True,
                                   batch_size=batch_size, steps_per_chunk=16,
                                   stats_out=stats)
        want, want_out = jsched.rate_stream(jstate, jstream, JCFG, collect=True,
                                            batch_size=batch_size,
                                            steps_per_chunk=16, stats_out=jstats)
        for key in ("n_steps", "batch_size", "occupancy"):
            assert stats[key] == jstats[key], key
        a, b = got.table.numpy(), np.asarray(want.table)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got_out.updated, want_out.updated)
        np.testing.assert_array_equal(got_out.any_afk, want_out.any_afk)
