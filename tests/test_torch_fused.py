"""The port's fused window and history runner.

Against the JAX package: the plain fused window (``core.fused._window_plain``,
what the CUDA kernel is held against on the card) against
``analyzer_tpu.core.fused`` with ``backend="interpret"`` (the Pallas kernel
in interpret mode, as tests/test_fused.py runs it) and ``"scan"``, and the
port's ``rate_history`` against JAX's. Gates and the NaN pattern are exact;
floats carry a tolerance because the two packages' transcendentals and sum
orders differ in the last ulps (tests/test_torch_ops.py), and a history
compounds those through later matches of the same players: relative 2e-6
of the rating scale (1e3), i.e. 2e-3 absolute, where measured runs stay
below 5e-4.

Inside the port: the fused path equals the reference path BIT FOR BIT on
the CPU (same per-step math, different routing), at every window size,
with spills and fillers, at every ``steps_per_chunk`` and prefetch depth.
The g++ build of the kernel's lane functions (``rate_match.cuh``, run in
the kernel's lane order) is held against the plain window: the working set
bit for bit, the outputs within a few ulps (glibc's expf/logf/erff against
torch's), also with the inert tail after ``n_steps`` not looped. The
staged chunks carry each window's real step count to the kernel.
"""

import numpy as np
import pytest
import torch

import analyzer_tpu.sched as jsched
from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.core import fused as jfused
from analyzer_tpu.core.state import PlayerState as JaxPlayerState
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.constants import UNSUPPORTED_MODE_ID
from analyzer_tpu_torch.core.fused import _window_plain, fused_apply_window
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
from analyzer_tpu_torch.kernels import fused_window as fw
from analyzer_tpu_torch.sched import (
    FeedStageError,
    pack_schedule,
    plan_windows,
    rate_history,
    rate_window_checked,
)
from analyzer_tpu_torch.sched.feed import StagedWindow, stage_fused_windows
from analyzer_tpu_torch.sched.residency import resolve_fuse

CFG = RatingConfig()
JCFG = JaxRatingConfig()
OUT_FIELDS = ("quality", "shared_mu", "shared_sigma", "delta",
              "mode_mu", "mode_sigma", "any_afk", "updated")
FLOAT_FIELDS = OUT_FIELDS[:6]
RTOL, ATOL = 2e-6, 2e-3


def _setup(n_matches=300, n_players=60, seed=11, batch_size=8, **kw):
    players = synthetic_players(n_players, seed=seed)
    stream = synthetic_stream(n_matches, players, seed=seed, **kw)
    feats = (players.rank_points_ranked, players.rank_points_blitz,
             players.skill_tier)
    state = PlayerState.create(n_players, *feats, device="cpu")
    jstate = JaxPlayerState.create(n_players, *feats)
    sched = pack_schedule(stream, pad_row=n_players, batch_size=batch_size)
    jstream = jsched.MatchStream(stream.player_idx, stream.winner,
                                 stream.mode_id, stream.afk)
    jsch = jsched.pack_schedule(jstream, pad_row=n_players, batch_size=batch_size)
    return state, sched, jstate, jsch


def _assert_tables_close(got, want):
    a, b = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _assert_outputs_close(got, want):
    np.testing.assert_array_equal(got.updated, want.updated)
    np.testing.assert_array_equal(got.any_afk, want.any_afk)
    for f in FLOAT_FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f)


def _assert_same(a_state, a_out, b_state, b_out, msg=""):
    assert np.array_equal(a_state.table.numpy(), b_state.table.numpy(),
                          equal_nan=True), msg
    if a_out is not None:
        for f in OUT_FIELDS:
            np.testing.assert_array_equal(getattr(a_out, f), getattr(b_out, f),
                                          err_msg=f"{msg} {f}")


def _need_pallas():
    if not jfused.pallas_available():
        pytest.skip("Pallas unavailable in this JAX build")


class TestAgainstJax:
    @pytest.mark.parametrize("backend", ["interpret", "scan"])
    @pytest.mark.parametrize("window", [1, 4, 16])
    def test_fused_history(self, backend, window):
        if backend == "interpret":
            _need_pallas()
        state, sched, jstate, jsch = _setup(n_matches=200, n_players=50, seed=43)
        got, outs = rate_history(
            state, sched, CFG, collect=True, steps_per_chunk=6,
            kernel="fused", fuse_window=window, fuse_backend="torch",
        )
        want, wouts = jsched.rate_history(
            jstate, jsch, JCFG, collect=True, steps_per_chunk=6,
            kernel="fused", fuse_window=window, fuse_backend=backend,
        )
        _assert_tables_close(got.table, want.table)
        _assert_outputs_close(outs, wouts)

    @pytest.mark.parametrize("backend", ["interpret", "scan"])
    def test_spills_and_fillers(self, backend):
        if backend == "interpret":
            _need_pallas()
        state, sched, jstate, jsch = _setup(
            n_matches=150, n_players=40, seed=47, afk_rate=0.3,
            unsupported_rate=0.2,
        )
        kw = dict(collect=True, steps_per_chunk=5, kernel="fused",
                  fuse_window=8, fuse_max_rows=64)
        got, outs = rate_history(state, sched, CFG, fuse_backend="torch", **kw)
        want, wouts = jsched.rate_history(jstate, jsch, JCFG,
                                          fuse_backend=backend, **kw)
        _assert_tables_close(got.table, want.table)
        _assert_outputs_close(outs, wouts)

    def test_one_window_with_collect(self):
        _need_pallas()
        state, sched, jstate, _jsch = _setup(seed=13, afk_rate=0.2)
        pidx, _m, winner, mode_id, afk = sched.host_window(0, 12)
        valid = (pidx != sched.pad_row) & ((mode_id >= 0) & ~afk)[:, :, None, None]
        plan = plan_windows(pidx, valid, sched.pad_row, 12, 32768)[0]
        args = (plan.slot_rows, plan.slot_idx, winner, mode_id, afk)
        got, ys = fused_apply_window(state, *args, CFG, collect=True)
        want, wys = jfused.fused_apply_window(
            jstate, *args, JCFG, collect=True, backend="interpret"
        )
        _assert_tables_close(got.table, want.table)
        a, b = ys.numpy(), np.asarray(wys)
        np.testing.assert_array_equal(a[..., 1:3], b[..., 1:3])  # any_afk, updated
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("kernel", ["reference", "fused"])
    def test_rate_history(self, kernel):
        state, sched, jstate, jsch = _setup(n_matches=400, n_players=80, seed=3)
        got, outs = rate_history(state, sched, CFG, collect=True, kernel=kernel)
        want, wouts = jsched.rate_history(jstate, jsch, JCFG, collect=True,
                                          kernel=kernel)
        _assert_tables_close(got.table, want.table)
        _assert_outputs_close(outs, wouts)


class TestInsidePort:
    @pytest.mark.parametrize("window", [1, 4, 16])
    def test_fused_equals_reference_bitwise(self, window):
        state, sched, _j, _js = _setup(n_matches=300, n_players=60, seed=17,
                                       afk_rate=0.2, unsupported_rate=0.1)
        base = rate_history(state, sched, CFG, collect=True)
        got = rate_history(state, sched, CFG, collect=True, steps_per_chunk=7,
                           kernel="fused", fuse_window=window)
        _assert_same(*base, *got, f"window={window}")

    def test_fused_with_spills_equals_reference(self):
        state, sched, _j, _js = _setup(n_matches=200, n_players=40, seed=19)
        base = rate_history(state, sched, CFG, collect=True)
        stats = {}
        got = rate_history(state, sched, CFG, collect=True, kernel="fused",
                           fuse_window=16, fuse_max_rows=32, stats_out=stats)
        assert stats["spills"] > 0 and stats["windows"] > 0
        _assert_same(*base, *got)

    @pytest.mark.parametrize("depth", [1, 2, 3])
    @pytest.mark.parametrize("kernel", ["reference", "fused"])
    def test_chunking_and_depth_invariant(self, depth, kernel):
        state, sched, _j, _js = _setup(n_matches=150, n_players=50, seed=23)
        kw = dict(collect=True, kernel=kernel)
        if kernel == "fused":
            kw["fuse_window"] = 4
        base = rate_history(state, sched, CFG, **kw)
        for spc in (3, 64):
            got = rate_history(state, sched, CFG, steps_per_chunk=spc,
                               prefetch_depth=depth, **kw)
            _assert_same(*base, *got, f"spc={spc} depth={depth}")

    def test_resume_and_hooks(self):
        state, sched, _j, _js = _setup(n_matches=200, n_players=50, seed=29)
        one_shot, _ = rate_history(state, sched, CFG, kernel="fused")
        seen = []
        mid, _ = rate_history(
            state, sched, CFG, kernel="fused", steps_per_chunk=10, stop_after=25,
            on_chunk=lambda st, nxt: seen.append(nxt),
        )
        assert seen == [10, 20, 25]
        rest, _ = rate_history(mid, sched, CFG, kernel="fused", start_step=25)
        _assert_same(one_shot, None, rest, None)
        # the caller's state is never written
        assert np.isnan(state.table.numpy()[:, 0]).all()

    def test_unported_options_raise(self):
        """Nothing of ``rate_history`` is left unported: ``hot_rows`` and
        ``view_publisher`` (refused until the tiered table and the serve
        plane were ported) now run; a bad backend still raises."""
        from analyzer_tpu_torch.serve import ViewPublisher

        state, sched, _j, _js = _setup(n_matches=40, n_players=20, seed=1)
        want, _ = rate_history(state, sched, CFG)
        pub = ViewPublisher(device="cpu")
        got, _ = rate_history(state, sched, CFG, hot_rows=64, view_publisher=pub)
        assert np.array_equal(got.table.numpy(), want.table.numpy(), equal_nan=True)
        assert np.array_equal(pub.current().host_table()[:20],
                              want.table.numpy()[:20], equal_nan=True)
        with pytest.raises(ValueError, match="hot_rows"):
            rate_history(state, sched, CFG, hot_rows=-1)
        with pytest.raises(ValueError, match="backend"):
            rate_history(state, sched, CFG, kernel="fused", fuse_backend="pallas")

    def test_staging_failure_names_the_window(self):
        state, sched, _j, _js = _setup(n_matches=60, n_players=20, seed=1)
        with pytest.raises(FeedStageError, match=r"\[0, ") as info:
            rate_history(state, sched, CFG, kernel="fused", fuse_max_rows=2)
        assert isinstance(info.value.__cause__, ValueError)

    def test_rate_window_checked(self):
        state, sched, _j, _js = _setup(seed=31)
        pidx, _m, winner, mode_id, afk = sched.host_window(0, 6)
        got, _ = rate_window_checked(state, pidx, winner, mode_id, afk, CFG)
        want, _ = rate_history(state, sched, CFG, stop_after=6, steps_per_chunk=6)
        _assert_same(got, None, want, None)
        bad = pidx.copy()
        bad[0, 1] = bad[0, 0]  # two ratable matches share players
        with pytest.raises(ValueError, match="conflict-free"):
            rate_window_checked(state, bad, winner, np.zeros_like(mode_id),
                                np.zeros_like(afk), CFG)


class TestKernelWrapperOnCpu:
    def _window(self, seed=37):
        state, sched, _j, _js = _setup(n_matches=400, n_players=70, seed=seed,
                                       afk_rate=0.25, unsupported_rate=0.15,
                                       batch_size=16)
        # rate a prefix first so the working set mixes rated and fresh rows
        state, _ = rate_history(state, sched, CFG, stop_after=10, steps_per_chunk=10)
        pidx, _m, winner, mode_id, afk = sched.host_window(10, 26)
        valid = (pidx != sched.pad_row) & ((mode_id >= 0) & ~afk)[:, :, None, None]
        plan = plan_windows(pidx, valid, sched.pad_row, 16, 32768)[0]
        ws = state.table[torch.from_numpy(plan.slot_rows).long()].clone()
        i32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32))  # noqa: E731
        return ws, i32(plan.slot_idx), i32(winner), i32(mode_id), i32(afk)

    def test_cpu_tensors_take_the_plain_version_uncounted(self):
        ws, sidx, winner, mode_id, afk = self._window()
        before = fw.launches
        got_ws, got_ys = fw.fused_window(ws.clone(), sidx, winner, mode_id, afk, CFG, True)
        want_ws, want_ys = _window_plain(ws.clone(), sidx, winner, mode_id, afk, CFG, True)
        assert fw.launches == before
        assert torch.equal(torch.nan_to_num(got_ws, nan=-1.0), torch.nan_to_num(want_ws, nan=-1.0))
        assert torch.equal(got_ys, want_ys)

    def test_wrapper_validates_inputs(self):
        ws, sidx, winner, mode_id, afk = self._window()
        with pytest.raises(ValueError, match="int32"):
            fw.fused_window(ws, sidx.long(), winner, mode_id, afk, CFG, False)
        with pytest.raises(ValueError, match="float32"):
            fw.fused_window(ws.double(), sidx, winner, mode_id, afk, CFG, False)
        with pytest.raises(ValueError, match="winner"):
            fw.fused_window(ws, sidx, winner[:, :3], mode_id, afk, CFG, False)
        with pytest.raises(ValueError, match="contiguous"):
            fw.fused_window(ws, sidx, winner.t().contiguous().t(), mode_id, afk, CFG, False)

    @pytest.mark.parametrize("seed", [37, 41])
    def test_host_build_of_kernel_phases_matches_plain(self, seed):
        ws, sidx, winner, mode_id, afk = self._window(seed)
        want_ws, want_ys = _window_plain(ws.clone(), sidx, winner, mode_id, afk, CFG, True)
        got_ws, got_ys = fw.fused_window_host(
            ws.clone().numpy(), sidx.numpy(), winner.numpy(), mode_id.numpy(),
            afk.numpy(), CFG, True,
        )
        # Same float32 operations in the same order; the libraries' erff/
        # expf/logf may differ by an ulp — measured: the working set bit
        # for bit, outputs within 1 ulp.
        np.testing.assert_allclose(got_ws, want_ws.numpy(), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(np.isnan(got_ws), np.isnan(want_ws.numpy()))
        wy = want_ys.numpy()
        np.testing.assert_array_equal(got_ys[..., 1:3], wy[..., 1:3])
        np.testing.assert_allclose(got_ys, wy, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("n_steps", range(1, 17))
    @pytest.mark.parametrize("seed", [37, 41])
    def test_host_build_with_inert_tail_matches_plain(self, seed, n_steps):
        """The window's steps from ``n_steps`` on made inert (slot 0,
        unsupported mode), as the feed pads a window cut short: the host
        build loops only the real steps and computes the tail's outputs
        after them; the plain version loops all 16."""
        ws, sidx, winner, mode_id, afk = self._window(seed)
        sidx[n_steps:] = 0
        winner[n_steps:] = 0
        mode_id[n_steps:] = UNSUPPORTED_MODE_ID
        afk[n_steps:] = 0
        want_ws, want_ys = _window_plain(ws.clone(), sidx, winner, mode_id, afk, CFG, True)
        for collect in (False, True):
            got_ws, got_ys = fw.fused_window_host(
                ws.clone().numpy(), sidx.numpy(), winner.numpy(), mode_id.numpy(),
                afk.numpy(), CFG, collect, n_steps=n_steps,
            )
            # the tolerances of the uncut window above
            np.testing.assert_allclose(got_ws, want_ws.numpy(), rtol=1e-6, atol=0)
            np.testing.assert_array_equal(np.isnan(got_ws), np.isnan(want_ws.numpy()))
        wy = want_ys.numpy()
        np.testing.assert_array_equal(got_ys[..., 1:3], wy[..., 1:3])
        np.testing.assert_array_equal(np.isnan(got_ys), np.isnan(wy))
        np.testing.assert_allclose(got_ys, wy, rtol=1e-6, atol=1e-6)

    def test_wrapper_validates_n_steps_and_cluster(self):
        ws, sidx, winner, mode_id, afk = self._window()
        args = (ws, sidx, winner, mode_id, afk, CFG, False)
        for bad in (-1, 17, 2.0, True, "4"):
            with pytest.raises(ValueError, match="n_steps"):
                fw.fused_window(*args, n_steps=bad)
            with pytest.raises(ValueError, match="n_steps"):
                fw.fused_window_host(ws.clone().numpy(), sidx.numpy(), winner.numpy(),
                                     mode_id.numpy(), afk.numpy(), CFG, False,
                                     n_steps=bad)
        for bad in (0, 3, 32):
            with pytest.raises(ValueError, match="cluster"):
                fw.fused_window(*args, cluster=bad)
        before = fw.launches
        for n in (0, 7, 16, np.int64(5)):  # in range: the plain version runs
            fw.fused_window(ws.clone(), *args[1:], n_steps=n, cluster=16)
        assert fw.launches == before


class TestStagedWindows:
    def test_staged_chunk_carries_each_plans_real_steps(self):
        """Windows cut short by the working-set budget carry their real
        step count; the steps after it are inert padding."""
        _state, sched, _j, _js = _setup(n_matches=300, n_players=60, seed=53,
                                        afk_rate=0.2, unsupported_rate=0.1)
        pidx, _m, winner, mode_id, afk = sched.host_window(0, sched.n_steps)
        fuse = resolve_fuse("fused", fuse_window=8, fuse_max_rows=64)
        chunk = stage_fused_windows(pidx, winner, mode_id, afk, sched.pad_row, fuse)
        valid = (pidx != sched.pad_row) & ((mode_id >= 0) & ~afk)[:, :, None, None]
        plans = plan_windows(pidx, valid, sched.pad_row, 8, 64)
        assert [w.n_steps for w in chunk.windows] == [p.n_steps for p in plans]
        assert any(w.n_steps < 8 for w in chunk.windows)
        assert chunk.stats["pad_steps"] == sum(8 - w.n_steps for w in chunk.windows)
        views = chunk.slab.to_device(torch.device("cpu"))
        for w in chunk.windows:
            assert isinstance(w, StagedWindow)
            slot_rows, sidx, win, mode, afk_w = (views[i] for i in w[:5])
            assert sidx.shape[0] == 8 and slot_rows[0] == sched.pad_row
            assert (sidx[w.n_steps:] == 0).all()
            assert (mode[w.n_steps:] == UNSUPPORTED_MODE_ID).all()
            assert (afk_w[w.n_steps:] == 0).all() and (win[w.n_steps:] == 0).all()
