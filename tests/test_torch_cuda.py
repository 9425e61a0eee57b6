"""The hand-written CUDA kernels on the card: the fused window (one
thread-block cluster per window) held against its plain PyTorch version on
real and random windows — team sizes, batch sizes that are not a multiple
of the cluster or exceed its lanes, collect on and off, an inert tail — its
launch counter, and the fused path against the reference path on the card;
the row scatter, one step and a multi-step run in one launch, held against
``index_copy_``, bit for bit. Every test needs a CUDA device (marker
``cuda``) and skips with a reason without one. On the card, where JAX is
not installed, run them without the suite's conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.constants import N_MODES, UNSUPPORTED_MODE_ID
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


def _random_window(rng, k, n_real, b, t):
    """A window of ``k`` steps, ``n_real`` of them real and the rest inert
    padding (slot 0, unsupported mode), on a random working set: a third
    of the rows never rated (NaN shared columns), half of the mode columns
    NaN, 10% padded team slots, and non-ratable fillers that share slots
    with the step's ratable matches. Returns numpy arrays."""
    n_slots = 1 << (b * 2 * t).bit_length()
    ws = np.empty((n_slots, 16), np.float32)
    ws[:, :7] = rng.normal(1500, 300, (n_slots, 7))
    ws[:, 7:14] = rng.uniform(50, 400, (n_slots, 7))
    ws[:, 14] = rng.normal(1500, 200, n_slots)
    ws[:, 15] = rng.uniform(300, 500, n_slots)
    ws[rng.random(n_slots) < 0.3, 0] = np.nan
    ws[:, 1:7][rng.random((n_slots, 6)) < 0.5] = np.nan
    sidx = np.zeros((k, b, 2, t), np.int32)
    winner = np.zeros((k, b), np.int32)
    mode = np.full((k, b), UNSUPPORTED_MODE_ID, np.int32)
    afk = np.zeros((k, b), np.int32)
    for s in range(n_real):
        step = rng.permutation(n_slots - 1)[: b * 2 * t].reshape(b, 2, t) + 1
        step[rng.random((b, 2, t)) < 0.1] = 0
        mode[s] = rng.integers(0, N_MODES, b)
        mode[s, rng.random(b) < 0.1] = UNSUPPORTED_MODE_ID
        afk[s] = rng.random(b) < 0.1
        ratable = (mode[s] >= 0) & (afk[s] == 0)
        fillers = np.flatnonzero(~ratable)
        if fillers.size and ratable.any():
            step[fillers] = step[rng.choice(np.flatnonzero(ratable), fillers.size)]
        sidx[s] = step
        winner[s] = rng.integers(0, 2, b)
    return ws, sidx, winner, mode, afk


def _assert_kernel_matches_plain(k_ws, k_ys, p_ws, p_ys):
    pairs = [(k_ws, p_ws)] + ([(k_ys, p_ys)] if p_ys is not None else [])
    for got, want in pairs:
        g, w = got.cpu().numpy(), want.cpu().numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6)
    if p_ys is not None:
        np.testing.assert_array_equal(k_ys[..., 1:3].cpu().numpy(),
                                      p_ys[..., 1:3].cpu().numpy())


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
    _assert_kernel_matches_plain(k_ws, k_ys, p_ws, p_ys)


@pytest.mark.parametrize("collect", [True, False])
@pytest.mark.parametrize("team", [3, 5])
@pytest.mark.parametrize("batch,cluster", [
    (1, 8), (7, 8), (700, 8), (700, 16), (45, 1), (1500, 8), (700, 4),
])
def test_cluster_kernel_matches_plain(cuda, batch, cluster, team, collect):
    """B = 1 and 7 (not a multiple of the cluster); 1500 at C = 8 and 700
    at C = 4, more matches than the cluster's lanes (a CTA holds 32 x 3
    match groups at T = 5, 32 x 5 at T = 3): a stride loop of two
    matches per group; an inert tail of 5 steps; and two launches of the
    same window bit-identical."""
    rng = np.random.default_rng(1000 * batch + 10 * team + cluster)
    arrays = _random_window(rng, 16, 11, batch, team)
    ws, sidx, winner, mode_id, afk = (torch.from_numpy(a).to(cuda) for a in arrays)
    p_ws, p_ys = _window_plain(ws.clone(), sidx, winner, mode_id, afk, CFG, collect)
    runs = [fw.fused_window(ws.clone(), sidx, winner, mode_id, afk, CFG, collect,
                            n_steps=11, cluster=cluster) for _ in range(2)]
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(*runs[0], p_ws, p_ys)
    for a, b in zip(runs[0], runs[1]):
        if a is not None:
            assert np.array_equal(a.cpu().numpy(), b.cpu().numpy(), equal_nan=True)


def test_inert_tail_skipped_or_looped_gives_the_same_bits(cuda):
    rng = np.random.default_rng(5)
    arrays = _random_window(rng, 16, 9, 432, 5)
    ws, sidx, winner, mode_id, afk = (torch.from_numpy(a).to(cuda) for a in arrays)
    got = [fw.fused_window(ws.clone(), sidx, winner, mode_id, afk, CFG, True,
                           n_steps=n) for n in (9, 16)]
    torch.cuda.synchronize()
    for a, b in zip(*got):
        assert np.array_equal(a.cpu().numpy(), b.cpu().numpy(), equal_nan=True)


def test_launch_shape_and_refusals(cuda):
    # B=432 at T=5: 54 (27) matches per CTA of a cluster of 8 (16), three
    # 10-lane match groups per warp
    for cluster, warps in ((8, 18), (16, 9)):
        shape = fw.launch_shape(cuda, 5, 432, cluster)
        assert shape["clusters"] >= 1 and shape["threads"] == warps * 32
    # 188 matches per CTA exceed its 96 groups: full CTAs, spilled values
    shape = fw.launch_shape(cuda, 5, 1500, 8)
    assert shape["threads"] == 1024 and shape["smem"] > 2 * 188 * 13 * 4
    rng = np.random.default_rng(2)
    ws, sidx, winner, mode_id, afk = (
        torch.from_numpy(a).to(cuda) for a in _random_window(rng, 4, 4, 8, 2))
    with pytest.raises(ValueError, match="n_steps"):
        fw.fused_window(ws, sidx, winner, mode_id, afk, CFG, False, n_steps=5)
    with pytest.raises(ValueError, match="cluster"):
        fw.fused_window(ws, sidx, winner, mode_id, afk, CFG, False, cluster=3)


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


@pytest.mark.parametrize("width,steps", [(16, 40), (128, 12)])
def test_row_scatter_steps_is_one_launch_equal_to_index_copy_loop(cuda, width, steps):
    """Index sets repeat every 3 steps, and every step shares a third of
    its rows with the step before, so the order of steps decides the
    result."""
    from analyzer_tpu_torch.kernels import row_scatter as rs

    rng = np.random.default_rng(width)
    p, r = 30000, 5120
    perm = rng.permutation(p)
    shift = r - r // 3  # consecutive sets overlap by a third
    sets = [perm[i * shift: i * shift + r] for i in range(3)]
    idx = torch.from_numpy(np.stack([sets[s % 3] for s in range(steps)]).astype(np.int32)).to(cuda)
    rows = torch.from_numpy(rng.random((steps, r, width)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.random((p, width)).astype(np.float32)).to(cuda)
    before = rs.launches
    got = rs.row_scatter_steps(table.clone(), idx, rows, check=True)
    assert rs.launches == before + 1
    want = rs.row_scatter_steps_plain(table.clone(), idx, rows)
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    assert torch.equal(got, want)
    # the largest grid that is all resident runs; one block more is refused
    cap = rs.max_resident_blocks(cuda)
    got = rs.row_scatter_steps(table.clone(), idx, rows, grid_blocks=cap)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="resident"):
        rs.row_scatter_steps(table.clone(), idx, rows, grid_blocks=cap + 1)
    assert rs.launches == before + 2
