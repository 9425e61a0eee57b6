"""The hand-written CUDA kernels on the card: the fused window (one
thread-block cluster per window) held against its plain PyTorch version on
real and random windows — team sizes, batch sizes that are not a multiple
of the cluster or exceed its lanes, collect on and off, an inert tail — its
launch counter, and the fused path against the reference path on the card;
the row scatter, one step and a multi-step run in one launch, held against
``index_copy_``, bit for bit; the tiered table on the card (paging through
pinned memory, a demotion's copy waited on before the cold tier is
written), the query engine on the card against its oracle, and a
``torch.profiler`` capture of the fused path attributed to the kernel on a
device lane; the ingest plane's pinned staging arena (commit, release only
after the copy's event, ``stage_ingest_window``), the cold tier on it, and
a tiny ``cli bench`` on the card; the model zoo on the card against the
port's CPU run (the features pass, its CUDA graph against eager dispatch
bit for bit, Elo, both heads' training, the Worker with and without the
calibration ledger); the shadow audit of a Worker serving from the card
(0 mismatches against the oracle, rows equal to a Worker with every plane
off); the row scatter's drop mode and the sharded re-rate (``parallel``)
on the card. Every test
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


def test_trace_capture_finds_fused_window_on_a_device_lane(cuda, tmp_path):
    """``utils.profiling.trace`` around a fused run on the card: the capture
    has the layout ``obs/profview`` reads, its "GPU 0" lane is found as a
    device lane, the host lanes are not, and the per-kernel table names
    ``fused_window_kernel`` with one entry per launch."""
    from analyzer_tpu_torch.obs.profview import analyze_capture
    from analyzer_tpu_torch.utils.profiling import trace

    state, sched = _setup(cuda)
    rate_history(state, sched, CFG, kernel="fused", stop_after=32)  # warm
    torch.cuda.synchronize()
    fw.launches = 0
    with trace(str(tmp_path)):
        rate_history(state, sched, CFG, kernel="fused", stop_after=32)
    launches = fw.launches
    att = analyze_capture(str(tmp_path), update_metrics=False)
    assert att["parsed"] is True, att["error"]
    assert att["device"]["lanes"] >= 1 and att["device"]["busy_us"] > 0
    kernels = {k["name"]: k for k in att["kernels"]}
    fused = [k for name, k in kernels.items() if "fused_window" in name]
    assert len(fused) == 1 and fused[0]["count"] == launches > 0
    # Host events (operators, runtime calls) never land in the device table.
    assert not any(name.startswith(("aten::", "cuda")) for name in kernels)
    assert att["compile"]["compile_us"] == 0.0


# -- the ingest plane and cli bench on the card ----------------------------


def test_arena_slab_round_trips_through_commit_and_is_pinned(cuda):
    """A slab of the staging arena is page-aligned pinned memory (its owning
    tensor says so, not an assumption), and ``commit`` copies it to the card
    asynchronously and faithfully."""
    from analyzer_tpu_torch.sched.feed import ARENA_ALIGNMENT, PinnedArena

    arena = PinnedArena()
    buf = arena.take((4096, 2, 16), np.int32)
    assert buf.ctypes.data % ARENA_ALIGNMENT == 0
    assert arena.tensor(buf).is_pinned()
    buf[:] = np.arange(buf.size, dtype=np.int32).reshape(buf.shape)
    dev = arena.commit(buf)  # device=None: the card
    assert dev.is_cuda
    np.testing.assert_array_equal(dev.cpu().numpy(), buf)
    assert arena.stats()["pinned"] is True


def test_give_when_done_recycles_only_after_the_copy(cuda):
    """A slab handed back while its copy is still queued behind a long
    kernel is NOT reused; once the copy has completed (synchronized here,
    before asserting) it is, and the copied values are the slab's."""
    from analyzer_tpu_torch.sched.feed import PinnedArena

    arena = PinnedArena()
    shape = (1 << 20,)
    buf = arena.take(shape, np.int32)
    buf[:] = np.arange(shape[0], dtype=np.int32)
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s of GPU time ahead of the copy
    dev = arena.commit(buf)
    arena.give_when_done(buf, dev)
    other = arena.take(shape, np.int32)
    assert other is not buf  # its copy is still in flight
    torch.cuda.synchronize()
    assert arena.take(shape, np.int32) is buf
    np.testing.assert_array_equal(dev.cpu().numpy(), np.arange(shape[0]))


def test_stage_ingest_window_equals_host_columns_on_card(cuda):
    import io as _io
    import os
    import tempfile

    from analyzer_tpu_torch.io.csv_codec import _parse, save_stream_csv
    from analyzer_tpu_torch.io.ingest import ColumnarDecoder
    from analyzer_tpu_torch.sched.feed import PinnedArena, stage_ingest_window

    players = synthetic_players(500, seed=4)
    stream = synthetic_stream(3000, players, seed=4, afk_rate=0.1,
                              unsupported_rate=0.05)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "s.csv")
        save_stream_csv(path, stream)
        with open(path, "rb") as f:
            data = f.read()
    ref = _parse(_io.StringIO(data.decode()))
    t = ref.player_idx.shape[2]
    arena = PinnedArena()
    rows = 0
    for win in ColumnarDecoder(data, window_rows=256, arena=arena).windows():
        host = [s.copy() for s in win.slabs]
        n, pidx, winner, mode_id, afk = stage_ingest_window(win, arena)
        for got, want in zip((pidx, winner, mode_id, afk), host):
            assert got.is_cuda
            np.testing.assert_array_equal(got.cpu().numpy()[:n], want[:n])
        np.testing.assert_array_equal(pidx.cpu().numpy()[:n, :, :t],
                                      ref.player_idx[rows:rows + n])
        rows += n
    assert rows == 3000
    assert arena.stats()["pinned"] is True


def test_cold_tier_on_card_is_pinned_arena_memory(cuda):
    from analyzer_tpu_torch.sched.feed import get_arena
    from analyzer_tpu_torch.sched.tier import TierManager

    state, _ = _setup(cuda)
    tm = TierManager(state, hot_rows=64)
    assert tm._host_tensor.is_pinned()
    assert get_arena().tensor(tm._host_table) is tm._host_tensor
    np.testing.assert_array_equal(tm._host_table, state.table.cpu().numpy())


def test_cli_bench_tiny_on_card(cuda):
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_MATCHES="3000", BENCH_REPEATS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "analyzer_tpu_torch", "bench", "--kernel",
         "fused", "--hot-rows", "256"],
        capture_output=True, text=True, timeout=600, cwd=repo, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["fused"]["bit_identical_to_reference"] is True
    assert line["tiered"]["bit_identical_to_resident"] is True
    assert line["device"]["name"] and line["device"]["power_limit"]


# The model zoo on the card against the port's CPU run on the same inputs.
# The card's eager ops and the CPU's are the same float32 operations, but
# reductions (team sums, matmuls, the loss) run in another order and the
# transcendentals come from another library: features within the
# tests/test_torch_models.py tolerance, Elo within its, and trained weights
# within MODEL_ATOL (ulps a step for 30 epochs of Adam).
MODEL_ATOL = 1e-4


def _model_history(device):
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream

    players = synthetic_players(300, seed=21)
    stream = synthetic_stream(3000, players, seed=21, afk_rate=0.05,
                              unsupported_rate=0.05)
    state = PlayerState.create(300, players.rank_points_ranked,
                               players.rank_points_blitz, players.skill_tier,
                               device=device)
    return stream, state, pack_schedule(stream, pad_row=300, windowed=True)


def test_features_pass_graph_equals_eager_and_cpu(cuda):
    from analyzer_tpu_torch.models import history_features

    stream, state, sched = _model_history(cuda)
    g, rg, fg = history_features(state, sched, CFG, steps_per_chunk=700)
    e, re_, fe = history_features(state, sched, CFG, graph=False)
    assert np.array_equal(g, e) and np.array_equal(rg, re_)
    assert torch.equal(fg.table.isnan(), fe.table.isnan())
    assert torch.equal(fg.table.nan_to_num(), fe.table.nan_to_num())
    ref, _ = rate_history(state, sched, CFG, kernel="reference")
    assert torch.equal(fg.table.nan_to_num(), ref.table.nan_to_num())
    c, rc, _ = history_features(state.clone(), sched, CFG, device="cpu")
    assert np.array_equal(rg, rc) and np.array_equal(np.isnan(g), np.isnan(c))
    np.testing.assert_array_equal(g[:, 4:], c[:, 4:])
    np.testing.assert_allclose(g[:, :4], c[:, :4], rtol=1e-5, atol=1e-5)


def test_elo_and_heads_on_card_equal_cpu(cuda):
    from analyzer_tpu_torch.models import (
        elo_history, history_features, train_logistic, train_mlp,
    )

    stream, state, sched = _model_history(cuda)
    r, e = elo_history(sched, 300)
    rc, ec = elo_history(sched, 300, device="cpu")
    np.testing.assert_allclose(r, rc, rtol=0, atol=2e-3)
    np.testing.assert_allclose(e, ec, rtol=0, atol=1e-5)
    f, rat, _ = history_features(state, sched, CFG, device="cpu")
    y = (stream.winner == 0).astype(np.float32)
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    for train, kw in ((train_logistic, {}), (train_mlp, {"hidden": 32})):
        m, nll = train(f[rat], y[rat], batch_size=512, **kw)
        mc, nllc = train(f[rat], y[rat], batch_size=512, device="cpu", **kw)
        assert nll == pytest.approx(nllc, rel=1e-4)
        for (name, p), (_, q) in zip(m.named_parameters(), mc.named_parameters()):
            assert p.is_cuda and not q.is_cuda
            np.testing.assert_allclose(p.detach().cpu().numpy(), q.detach().numpy(),
                                       rtol=0, atol=MODEL_ATOL, err_msg=name)


def test_worker_ledger_on_card_is_an_observer(cuda, tmp_path):
    import sqlite3

    from analyzer_tpu_torch.config import ServiceConfig
    from analyzer_tpu_torch.experiments.service_bench import build_db, match_ids, run_loop
    from analyzer_tpu_torch.service import InMemoryBroker, SqlStore, Worker

    dumps, stats = [], []
    for on in (True, False):
        path = str(tmp_path / f"q{on}.db")
        build_db(path, 1500, 500, 3, items=True)
        broker = InMemoryBroker()
        cfg = ServiceConfig(batch_size=250, idle_timeout=0)
        w = Worker(broker, SqlStore(f"sqlite:///{path}"), cfg, pipeline=False,
                   quality=on)
        run_loop(w, broker, match_ids(path), cfg.queue)
        stats.append(w.stats())
        w.close()
        conn = sqlite3.connect(path)
        dumps.append([conn.execute(f'SELECT * FROM "{t}" ORDER BY rowid').fetchall()
                      for t in ("player", "participant", "participant_items", "match")])
        conn.close()
    assert dumps[0] == dumps[1]
    assert stats[0]["quality"]["matches_scored"] > 0 and stats[1]["quality"] is None


def test_audited_worker_on_card_has_zero_mismatches(cuda, tmp_path):
    """The shadow audit on the card: a Worker with the SLO plane and an
    audit of every served query replays each response through the float32
    oracle on the view's host table — every number the card served equals
    it bit for bit — and commits the rows of a Worker with every plane
    off."""
    import sqlite3

    from analyzer_tpu_torch.config import ServiceConfig
    from analyzer_tpu_torch.experiments.service_bench import build_db, match_ids
    from analyzer_tpu_torch.service import InMemoryBroker, SqlStore, Worker

    dumps, audits = [], []
    for on in (True, False):
        path = str(tmp_path / f"a{on}.db")
        build_db(path, 1500, 500, 3, items=True)
        broker = InMemoryBroker()
        cfg = ServiceConfig(batch_size=250, idle_timeout=0)
        planes = (dict(obs_port=0, audit=True, audit_sample_denom=1,
                       history_interval_s=0.0) if on
                  else dict(slo_plane=False, quality=False))
        w = Worker(broker, SqlStore(f"sqlite:///{path}"), cfg, pipeline=False,
                   serve_port=0, **planes)
        try:
            for mid in match_ids(path):
                broker.publish(cfg.queue, mid.encode())
            while w.poll():
                lb = w.query_engine.leaderboard(50)
                ids = [e["id"] for e in lb["leaders"]]
                w.query_engine.get_ratings(ids[:20])
                w.query_engine.win_probability(ids[:5], ids[5:10])
                w.query_engine.tier_histogram()
                w.query_engine.percentile(100.0)
            w.drain()
            audits.append(w.auditor.stats() if w.auditor is not None else None)
        finally:
            w.close()
        conn = sqlite3.connect(path)
        dumps.append([conn.execute(f'SELECT * FROM "{t}" ORDER BY rowid').fetchall()
                      for t in ("player", "participant", "participant_items", "match")])
        conn.close()
    assert dumps[0] == dumps[1]
    assert audits[0]["checked"] == audits[0]["sampled"] > 0
    assert audits[0]["mismatches"] == 0 and audits[1] is None


@pytest.mark.parametrize("steps", [1, 7])
def test_row_scatter_drop_mode_equals_plain(cuda, steps):
    """``mode="drop"`` on the card: padding entries past the table (and a
    negative one) write nothing, in one launch, bit for bit the plain
    version's masked ``index_copy_``; every thread still reaches the grid
    barrier between steps (the multi-step run would hang otherwise)."""
    from analyzer_tpu_torch.kernels import row_scatter as rs

    rng = np.random.default_rng(steps)
    p, r, width = 20000, 4096, 16
    idx = np.stack([rng.choice(p, r, replace=False) for _ in range(steps)])
    idx[:, rng.random(r) < 0.3] = p  # the mesh's padding: one past the block
    idx[:, 0] = -1
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    rows = torch.from_numpy(rng.random((steps, r, width)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.random((p, width)).astype(np.float32)).to(cuda)
    before = rs.launches
    got = rs.row_scatter_steps(table.clone(), idx, rows, check=True, mode="drop")
    assert rs.launches == before + 1
    want = rs.row_scatter_steps_plain(table.clone(), idx, rows, mode="drop")
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    assert torch.equal(got, want)


def test_sharded_rerate_on_the_card_equals_the_reference(cuda):
    """``rate_history_sharded`` at D=2 on the card, one ``row_scatter``
    launch a superstep, bit for bit the reference runner; and
    ``rate_stream(mesh=)`` too."""
    from analyzer_tpu_torch.kernels import row_scatter as rs
    from analyzer_tpu_torch.parallel import make_mesh, rate_history_sharded
    from analyzer_tpu_torch.sched import rate_stream

    players = synthetic_players(300, seed=3)
    stream = synthetic_stream(3000, players, seed=3, afk_rate=0.1)
    state = PlayerState.create(300, players.rank_points_ranked,
                               players.rank_points_blitz, players.skill_tier,
                               device=cuda)
    sched = pack_schedule(stream, pad_row=300, batch_size=64)
    want, _ = rate_history(state, sched, CFG)
    mesh = make_mesh(2)
    assert mesh.device.type == "cuda"
    before = rs.launches
    got = rate_history_sharded(state, sched, CFG, mesh=mesh, steps_per_chunk=50)
    torch.cuda.synchronize()
    assert rs.launches - before == sched.n_steps
    assert got.table.is_cuda and torch.equal(got.table.isnan(), want.table.isnan())
    assert torch.equal(got.table.nan_to_num(), want.table.nan_to_num())
    streamed, _ = rate_stream(state, stream, CFG, mesh=mesh)
    assert torch.equal(streamed.table.nan_to_num(), want.table.nan_to_num())
