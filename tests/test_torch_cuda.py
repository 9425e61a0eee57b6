"""The hand-written CUDA kernels on the card: the fused window (one
thread-block cluster per window) held against its plain PyTorch version on
real and random windows — team sizes, batch sizes that are not a multiple
of the cluster or exceed its lanes, collect on and off, an inert tail — its
launch counter, and the fused path against the reference path on the card;
the row scatter, one step and a multi-step run in one launch, held against
``index_copy_``, bit for bit; the tiered table on the card (paging through
pinned memory, a demotion's copy waited on before the cold tier is
written) and the query engine on the card against its oracle. Every test
needs a CUDA device (marker
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


# -- the tiered table and the serve plane on the card -------------------------


def _assert_same_run(got, want):
    (g_state, g_out), (w_state, w_out) = got, want
    assert np.array_equal(g_state.table.cpu().numpy(), w_state.table.cpu().numpy(),
                          equal_nan=True)
    for f in ("quality", "shared_mu", "shared_sigma", "delta", "mode_mu",
              "mode_sigma", "any_afk", "updated"):
        assert np.array_equal(getattr(g_out, f), getattr(w_out, f), equal_nan=True), f


@pytest.mark.parametrize("kernel", ["reference", "fused"])
@pytest.mark.parametrize("hot_rows", [700, 2048])
def test_tiered_run_on_cuda_is_bit_identical(cuda, kernel, hot_rows):
    """A hot set of 1024 slots (from 700) thrashes under chunks that touch
    every one of the 300 players many times over B=64 x 10 slots a step —
    demotions stream through pinned memory while later windows run — and
    one of 2048 holds everything; both must equal the untiered run."""
    from analyzer_tpu_torch.obs import get_registry, reset_registry

    players = synthetic_players(3000, seed=11)
    stream = synthetic_stream(6000, players, seed=11, afk_rate=0.1,
                              unsupported_rate=0.05)
    state = PlayerState.create(3000, players.rank_points_ranked,
                               players.rank_points_blitz, players.skill_tier,
                               device=cuda)
    sched = pack_schedule(stream, pad_row=3000, batch_size=64)
    want = rate_history(state, sched, CFG, collect=True, kernel=kernel,
                        steps_per_chunk=8)
    reset_registry()
    got = rate_history(state, sched, CFG, collect=True, kernel=kernel,
                       steps_per_chunk=8, hot_rows=hot_rows, prefetch_depth=3)
    _assert_same_run(got, want)
    counters = get_registry().snapshot()["counters"]
    if hot_rows < 3000:
        assert counters["tier.dirty_writebacks_total"] > 0
    else:
        assert counters["tier.demotions_total"] == 0


def test_tier_demotion_lands_only_after_its_copy(cuda):
    """The writeback of a dirty eviction is an asynchronous copy into pinned
    memory. Behind a long queue of device work it has not landed when
    ``apply`` returns: until its event completes, the cold tier keeps the
    old row and ``applied`` stays behind the plan, so the producer cannot
    stage that row as fresh; after the drain the cold tier holds the
    device's value."""
    from analyzer_tpu_torch.sched.tier import TierManager

    state = PlayerState.create(64, device=cuda)
    tier = TierManager(state, 8)
    table = tier.hot_state().table
    first = np.arange(8, dtype=np.int32)
    tier.apply(table, tier.plan_rows(first, first))
    table[:8, 0] = torch.arange(100.0, 108.0, device=cuda)  # the "update"
    old = tier._host_table[:8, 0].copy()
    big = torch.randn(8192, 8192, device=cuda)
    for _ in range(40):  # a few hundred ms of queued work ahead of the copy
        big = big @ big * 1e-4
    nxt = np.arange(8, 16, dtype=np.int32)
    plan = tier.plan_rows(nxt, nxt)
    assert plan.wb_rows.size == 8 and plan.evict_rows.size == 8
    tier.apply(table, plan)
    pending_before = len(tier._pending)
    tier._drain(wait=False)  # polls: must not write what has not landed
    if tier._pending:
        assert np.array_equal(tier._host_table[:8, 0], old, equal_nan=True)
        later = tier.plan_rows(first, first)  # rows 0..7 come back
        assert later.deferred_rows.size == 8 and later.fresh_slots.size == 0
        tier.apply(table, later)  # a deferred promotion drains first
    else:
        later = None
    tier._drain()
    assert pending_before == 1 and not tier._pending
    assert np.array_equal(tier._host_table[:8, 0], np.arange(100.0, 108.0, dtype=np.float32))
    if later is not None:
        slots = torch.from_numpy(later.promote_slots).to(cuda).long()
        assert torch.equal(table[slots, 0], torch.arange(100.0, 108.0, device=cuda))


def _serve_table(rng, p):
    t = np.full((p + 1, 16), np.nan, np.float32)
    t[:, 14] = rng.normal(1500, 200, p + 1)
    t[:, 15] = rng.uniform(300, 500, p + 1)
    rated = rng.random(p) < 0.7
    t[:p][rated, 0] = rng.normal(1500, 300, rated.sum())
    t[:p][rated, 7] = rng.uniform(50, 400, rated.sum())
    t[40:70, 0], t[40:70, 7] = 2600.0, 50.0  # a tie class at the top
    return t


def test_engine_on_cuda_equals_oracle(cuda):
    from analyzer_tpu_torch.serve import QueryEngine, ViewPublisher, oracle

    rng = np.random.default_rng(5)
    p = 3000
    pub = ViewPublisher()  # device=None: the card
    view = pub.publish_state(_serve_table(rng, p))
    assert view.table.is_cuda
    host = view.host_table()
    engine = QueryEngine(pub)
    assert engine.warmup() == 5
    for k in (1, 10, 29, 30, 31, 200):  # the tie class straddles k
        got = engine.leaderboard(k)["leaders"]
        want = oracle.leaderboard(host, p, k)
        assert [(int(e["id"]), e["conservative"]) for e in got] == [
            (row, float(s)) for row, s in want]
    counts, rated = oracle.tier_histogram(host, p, engine.tier_edges)
    tiers = engine.tier_histogram()
    assert (tiers["counts"], tiers["rated"]) == (counts, rated)
    for v in (-3000.0, 0.0, 777.5, float(host[40, 0] - 150.0), 1e9):
        got = engine.percentile(v)
        assert (got["below"], got["rated"]) == oracle.percentile(host, p, v)
    for _ in range(50):
        rows = rng.choice(p, size=10, replace=False)
        na, nb = rng.integers(1, 6, 2)
        a, b = [int(r) for r in rows[:na]], [int(r) for r in rows[5:5 + nb]]
        got = engine.win_probability([str(r) for r in a], [str(r) for r in b])
        assert got["p_a"] == float(oracle.win_probability(host, a, b, CFG.beta2))
        assert got["quality"] == float(oracle.quality(host, a, b, CFG.beta2))
    got = engine.get_ratings(["40", "0", "nobody"])
    assert got["unknown"] == ["nobody"]
    assert got["ratings"][0]["conservative"] == float(oracle.conservative_score(host, 40))


def test_views_on_cuda_are_immutable_under_a_publishing_writer(cuda):
    """Readers on their own threads against a writer that patches the view:
    versions only rise for a reader, and each ratings response equals the
    host table of the version it names."""
    import threading

    from analyzer_tpu_torch.serve import QueryEngine, ViewPublisher

    rng = np.random.default_rng(6)
    p = 3000
    base = _serve_table(rng, p)
    pub = ViewPublisher()
    views = {1: pub.publish_state(base)}
    frozen = views[1].host_table().copy()
    engine = QueryEngine(pub).start()
    stop, errors, seen = threading.Event(), [], [[] for _ in range(3)]

    def writer():
        try:
            done = 0
            while done < 40 or (min(len(s) for s in seen) < 2 and done < 4000):
                done += 1
                idx = np.unique(rng.integers(0, p, 256))
                rows = base[idx]
                rows[:, 0] += np.float32(1.0)
                base[idx] = rows
                v = pub.publish_state_patch(idx, rows, p, full_table=lambda: base)
                views[v.version] = v
        except BaseException as e:  # noqa: BLE001 — re-raised by the test
            errors.append(e)
        finally:
            stop.set()

    def reader(i):
        try:
            while not stop.is_set():
                seen[i].append(engine.get_ratings([str(j) for j in range(i, p, 97)]))
        except BaseException as e:  # noqa: BLE001 — re-raised by the test
            errors.append(e)

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    engine.close()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    assert pub.version >= 41 and len(views) == pub.version
    # the first view still holds what it was published with
    assert np.array_equal(views[1].table.cpu().numpy(), frozen, equal_nan=True)
    for mine in seen:
        vs = [r["version"] for r in mine]
        assert vs == sorted(vs) and mine
        for r in mine:
            host = views[r["version"]].host_table()
            for e in r["ratings"]:
                mu = host[int(e["id"]), 0]
                assert (e["mu"] is None and np.isnan(mu)) or e["mu"] == float(mu)


def test_pipelined_worker_equals_sequential_on_the_card(cuda, tmp_path, monkeypatch):
    """The service loop on the card: the pipelined Worker (chain patch on
    the device, outputs copied asynchronously into pinned memory and waited
    on by CUDA event in the writer thread) commits the same rows as the
    sequential Worker, and every batch's final table — pad row included —
    is bit-identical. Each copy is queued behind a few hundred ms of
    device work, so the writer really has to wait on its event."""
    import sqlite3

    from analyzer_tpu_torch.config import ServiceConfig
    from analyzer_tpu_torch.io.dbgen import write_history_db
    from analyzer_tpu_torch.sched.runner import _Fetch
    from analyzer_tpu_torch.service import InMemoryBroker, SqlStore, Worker
    from analyzer_tpu_torch.service import pipeline

    class Recorder(Worker):
        def __init__(self, *a, **kw):
            super().__init__(*a, device=cuda, **kw)
            self.view_publisher = object()
            self.tables = []

        def _publish_view(self, enc, table):
            self.tables.append(table.cpu().numpy().copy())

    late = []

    class DelayedFetch(_Fetch):
        def __init__(self, ys):
            big = torch.randn(4096, 4096, device=ys.device)
            for _ in range(8):
                big = big @ big * 1e-4
            super().__init__(ys)
            late.append(not self._event.query())

    monkeypatch.setattr(pipeline, "_Fetch", DelayedFetch)

    def run(pipelined):
        path = str(tmp_path / f"h_{pipelined}.db")
        players = synthetic_players(30, seed=2)
        write_history_db(path, synthetic_stream(200, players, seed=2), players)
        broker = InMemoryBroker()
        cfg = ServiceConfig(batch_size=20, idle_timeout=0.0, pipeline_lag=3)
        w = Recorder(broker, SqlStore(f"sqlite:///{path}"), cfg, CFG,
                     pipeline=pipelined)
        for i in range(200):
            broker.publish(cfg.queue, f"m{i:09d}".encode())
        while w.poll():
            pass
        w.drain()
        w.close()
        assert broker.qsize(cfg.failed_queue) == 0 and not broker._unacked
        conn = sqlite3.connect(path)
        rows = [conn.execute(f'SELECT * FROM "{t}" ORDER BY api_id').fetchall()
                for t in ("player", "participant", "participant_items", "match")]
        conn.close()
        return rows, w.tables

    (ra, ta), (rb, tb) = run(False), run(True)
    assert any(late), "no copy was still in flight at dispatch"
    assert ra == rb
    assert len(ta) == len(tb) == 10
    assert all(x.tobytes() == y.tobytes() for x, y in zip(ta, tb))
