"""The hand-written CUDA kernels on the card: the fused window held against
its plain PyTorch version on a small window, its launch counter, and the
fused path against the reference path on the card; the row scatter held
against ``index_copy_``, bit for bit. Every test needs a CUDA
device (marker ``cuda``) and skips with a reason without one. On the card,
where JAX is not installed, run them without the suite's conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.fused import _window_plain, fused_window_table
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
from analyzer_tpu_torch.kernels import fused_window as fw
from analyzer_tpu_torch.sched import pack_schedule, plan_windows, rate_history

pytestmark = pytest.mark.cuda

CFG = RatingConfig()
# Kernel vs plain on one window: the same float32 operations in the same
# order; only the device math library's transcendentals may differ by ulps.
RTOL = 2e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible")
    return torch.device("cuda")


def _setup(device, seed=7):
    players = synthetic_players(300, seed=seed)
    stream = synthetic_stream(3000, players, seed=seed, afk_rate=0.2,
                              unsupported_rate=0.1)
    state = PlayerState.create(300, players.rank_points_ranked,
                               players.rank_points_blitz, players.skill_tier,
                               device=device)
    return state, pack_schedule(stream, pad_row=300, batch_size=64)


def _window(state, sched, start, k):
    pidx, _m, winner, mode_id, afk = sched.host_window(start, start + k)
    valid = (pidx != sched.pad_row) & ((mode_id >= 0) & ~afk)[:, :, None, None]
    plan = plan_windows(pidx, valid, sched.pad_row, k, 32768)[0]
    dev = state.table.device
    i32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)  # noqa: E731
    return (i32(plan.slot_rows), i32(plan.slot_idx), i32(winner[:plan.n_steps]),
            i32(mode_id[:plan.n_steps]), i32(afk[:plan.n_steps]))


def test_kernel_matches_plain_and_counts(cuda):
    state, sched = _setup(cuda)
    state, _ = rate_history(state, sched, CFG, stop_after=20, steps_per_chunk=20)
    slot_rows, sidx, winner, mode_id, afk = _window(state, sched, 20, 16)
    ws = state.table.index_select(0, slot_rows.long())
    before = fw.launches
    k_ws, k_ys = fw.fused_window(ws.clone(), sidx, winner, mode_id, afk, CFG, True)
    assert fw.launches == before + 1
    p_ws, p_ys = _window_plain(ws.clone(), sidx, winner, mode_id, afk, CFG, True)
    assert fw.launches == before + 1  # the plain version is not counted
    torch.cuda.synchronize()
    for got, want in ((k_ws, p_ws), (k_ys, p_ys)):
        g, w = got.cpu().numpy(), want.cpu().numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(k_ys[..., 1:3].cpu().numpy(), p_ys[..., 1:3].cpu().numpy())


def test_fused_path_is_the_kernel_on_cuda(cuda):
    state, sched = _setup(cuda, seed=9)
    ref, ref_out = rate_history(state, sched, CFG, collect=True)
    before = fw.launches
    stats = {}
    got, out = rate_history(state, sched, CFG, collect=True, kernel="fused",
                            stats_out=stats)
    assert fw.launches - before == stats["windows"] > 0
    a, b = got.table.cpu().numpy(), ref.table.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(out.updated, ref_out.updated)
    with pytest.raises(ValueError, match="CPU tensors only"):
        slot_rows, sidx, winner, mode_id, afk = _window(state, sched, 0, 4)
        fused_window_table(state.table.clone(), slot_rows, sidx, winner, mode_id,
                           afk, CFG, False, backend="torch")


def test_row_scatter_matches_index_copy_and_counts(cuda):
    from analyzer_tpu_torch.kernels import row_scatter as rs

    rng = np.random.default_rng(3)
    for width, n_rows in ((16, 5120), (128, 777)):
        idx = torch.from_numpy(
            rng.choice(20000, size=n_rows, replace=False).astype(np.int32)).to(cuda)
        rows = torch.from_numpy(rng.random((n_rows, width)).astype(np.float32)).to(cuda)
        table = torch.from_numpy(rng.random((20000, width)).astype(np.float32)).to(cuda)
        before = rs.launches
        got = rs.row_scatter(table.clone(), idx, rows, check=True)
        assert rs.launches == before + 1
        want = rs.row_scatter_plain(table.clone(), idx, rows)
        assert rs.launches == before + 1  # the plain version is not counted
        torch.cuda.synchronize()
        assert torch.equal(got, want)
