"""The port's tiered ratings table (``analyzer_tpu_torch.sched.tier``).

Two contracts, both exact (tolerance 0):

  * inside the port, tiering changes where rows live and nothing else: the
    final table, the collected per-match outputs, every hook snapshot and
    every published view equal the untiered runner's bit for bit at every
    hot-set size (thrashing, exact fit, oversized), kernel, feed depth and
    runner;
  * against ``analyzer_tpu.sched.tier`` on the same schedule: the span
    cuts, every plan's page-table transaction (evictions, promotions and
    their slots, dirty writebacks, deferred rows, written rows) and the six
    ``tier.*`` counters are equal. (The JAX package pads its promotion and
    writeback lists to power-of-two buckets for its compile ladder; the
    port does not, so the lists are compared at their real lengths.)

The unit half pins the promotion protocol: a dirty eviction's re-promotion
is deferred until its writeback has been materialized.
"""

import numpy as np
import pytest
import torch

from analyzer_tpu.config import RatingConfig as JaxConfig
from analyzer_tpu.core.state import PlayerState as JaxState
from analyzer_tpu.obs import get_registry as jax_registry
from analyzer_tpu.sched import tier as jax_tier
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
from analyzer_tpu_torch.obs import get_registry, reset_registry
from analyzer_tpu_torch.sched import pack_schedule, rate_history, rate_stream
from analyzer_tpu_torch.sched.feed import FeedStageError
from analyzer_tpu_torch.sched.residency import plan_windows, resolve_fuse
from analyzer_tpu_torch.sched.superstep import MatchStream
from analyzer_tpu_torch.sched.tier import TierManager
from analyzer_tpu_torch.serve.view import ViewPublisher

CFG = RatingConfig()

OUT_FIELDS = (
    "quality", "shared_mu", "shared_sigma", "delta",
    "mode_mu", "mode_sigma", "any_afk", "updated",
)
COUNTERS = ("hits", "misses", "promotions", "demotions", "dirty_writebacks",
            "spills")


def small_stream(n_matches=300, n_players=60, seed=11, **kw):
    players = synthetic_players(n_players, seed=seed)
    stream = synthetic_stream(n_matches, players, seed=seed, **kw)
    state = PlayerState.create(
        n_players,
        rank_points_ranked=players.rank_points_ranked,
        rank_points_blitz=players.rank_points_blitz,
        skill_tier=players.skill_tier,
        device="cpu",
    )
    return stream, state, players


def table_of(state) -> np.ndarray:
    return state.table.numpy().copy()


def assert_same_table(a, b, msg=""):
    assert np.array_equal(a, b, equal_nan=True), msg


def assert_same_outputs(a, b, msg=""):
    for field in OUT_FIELDS:
        np.testing.assert_array_equal(
            getattr(a, field), getattr(b, field), err_msg=f"{msg} {field}"
        )


@pytest.fixture(scope="module")
def workload():
    """One shared stream/state/schedule plus the untiered baselines."""
    stream, state, _ = small_stream()
    sched = pack_schedule(stream, pad_row=state.pad_row, windowed=True)
    hist_state, hist_outs = rate_history(
        state, sched, CFG, collect=True, steps_per_chunk=6
    )
    stream_state, stream_outs = rate_stream(
        state, stream, CFG, collect=True, batch_size=8, steps_per_chunk=5
    )
    return {
        "stream": stream,
        "state": state,
        "sched": sched,
        "hist": (table_of(hist_state), hist_outs),
        "stream_run": (table_of(stream_state), stream_outs),
    }


# hot_rows=16 is a 16-slot hot set — far below the ~60 touched rows of the
# workload (thrash); 64 is the exact player-count fit; 4096 is oversized
# (everything resident after first touch). The streamed matrix floors at
# 32: its fixed batch_size=8 supersteps can touch >16 distinct rows, which
# is the (tested) hard-error case, not thrash.
HOT_SIZES = (16, 64, 4096)
HOT_SIZES_STREAM = (32, 64, 4096)


class TestBitIdentityMatrix:
    @pytest.mark.parametrize("hot_rows", HOT_SIZES)
    @pytest.mark.parametrize("kernel", ["reference", "fused"])
    @pytest.mark.parametrize("depth", [1, 3])
    def test_rate_history(self, workload, hot_rows, kernel, depth):
        base_table, base_outs = workload["hist"]
        got, outs = rate_history(
            workload["state"], workload["sched"], CFG, collect=True,
            steps_per_chunk=6, prefetch_depth=depth, hot_rows=hot_rows,
            kernel=kernel, fuse_window=4, fuse_backend="torch",
        )
        assert_same_table(base_table, table_of(got),
                          f"hot_rows={hot_rows} kernel={kernel} depth={depth}")
        assert_same_outputs(base_outs, outs, f"hot_rows={hot_rows} kernel={kernel}")

    @pytest.mark.parametrize("hot_rows", HOT_SIZES_STREAM)
    @pytest.mark.parametrize("kernel", ["reference", "fused"])
    @pytest.mark.parametrize("depth", [1, 3])
    def test_rate_stream(self, workload, hot_rows, kernel, depth):
        base_table, base_outs = workload["stream_run"]
        got, outs = rate_stream(
            workload["state"], workload["stream"], CFG, collect=True,
            batch_size=8, steps_per_chunk=5, prefetch_depth=depth,
            hot_rows=hot_rows, kernel=kernel, fuse_window=4,
            fuse_backend="torch",
        )
        assert_same_table(base_table, table_of(got),
                          f"hot_rows={hot_rows} kernel={kernel} depth={depth}")
        assert_same_outputs(base_outs, outs, f"hot_rows={hot_rows} kernel={kernel}")

    @pytest.mark.parametrize("hot_rows", HOT_SIZES)
    def test_fused_kernel_wrapper_reads_through_the_hot_set(self, workload, hot_rows):
        """``fuse_backend=None``: the kernel's wrapper (on a CPU table, its
        host build or plain version) on hot-slot indices."""
        base_table, _ = workload["hist"]
        got, _ = rate_history(
            workload["state"], workload["sched"], CFG, steps_per_chunk=6,
            hot_rows=hot_rows, kernel="fused", fuse_window=4,
        )
        assert_same_table(base_table, table_of(got))

    @pytest.mark.parametrize("runner", ["history", "stream"])
    def test_hook_snapshots_match_untiered(self, workload, runner):
        """The checkpoint hook sees the logical FULL state on a tiered
        run — every boundary snapshot equals the untiered hook's."""
        def capture(**kw):
            snaps = []
            hook = lambda st, stop: snaps.append((stop, table_of(st)))  # noqa: E731
            if runner == "history":
                rate_history(workload["state"], workload["sched"], CFG,
                             steps_per_chunk=6, on_chunk=hook, **kw)
            else:
                rate_stream(workload["state"], workload["stream"], CFG,
                            batch_size=8, steps_per_chunk=5, on_chunk=hook, **kw)
            return snaps

        base = capture()
        got = capture(hot_rows=32)
        assert [s for s, _ in base] == [s for s, _ in got] and len(base) > 2
        for (stop, a), (_, b) in zip(base, got):
            assert_same_table(a, b, f"stop={stop}")

    def test_caller_state_survives(self, workload):
        state = workload["state"]
        before = table_of(state)
        rate_history(state, workload["sched"], CFG, hot_rows=32)
        assert_same_table(before, table_of(state))

    def test_resume_mid_schedule_tiered(self, workload):
        """A tiered run stopped at a chunk boundary and re-entered from its
        hook snapshot equals the one-shot untiered run."""
        base_table, _ = workload["hist"]
        half, _ = rate_history(workload["state"], workload["sched"], CFG,
                               steps_per_chunk=6, stop_after=12, hot_rows=16)
        got, _ = rate_history(half, workload["sched"], CFG, steps_per_chunk=6,
                              start_step=12, hot_rows=64)
        assert_same_table(base_table, table_of(got))

    def test_empty_stream_tiered(self):
        state = PlayerState.create(12, device="cpu")
        empty = MatchStream(
            np.zeros((0, 2, 3), np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.int32), np.zeros(0, bool),
        )
        got, outs = rate_stream(state, empty, CFG, collect=True, hot_rows=8)
        assert_same_table(table_of(state), table_of(got))
        assert outs.updated.shape == (0,)


def chain_heavy_stream(n=60, width=1):
    """A 1v1 stream over many distinct players: step working sets stay
    tiny (<= 2 * batch rows) while the chunk working set spans the whole
    roster — the forced-miss shape for a small hot set."""
    rng = np.random.default_rng(5)
    idx = np.zeros((n, 2, width), np.int32)
    idx[:, 0, 0] = rng.permutation(n) % 40
    idx[:, 1, 0] = (idx[:, 0, 0] + 1 + rng.integers(0, 38, n)) % 40
    return MatchStream(
        player_idx=idx,
        winner=(np.arange(n) % 2).astype(np.int32),
        mode_id=np.zeros(n, np.int32),
        afk=np.zeros(n, bool),
    ), PlayerState.create(40, device="cpu")


class TestForcedMissThrash:
    def test_hot_set_smaller_than_window_splits_and_stays_correct(self):
        stream, state = chain_heavy_stream()
        base, _ = rate_stream(state, stream, CFG, batch_size=4,
                              steps_per_chunk=8)
        reg = reset_registry()
        # capacity 8 slots vs ~40 distinct rows per 8-step chunk: every
        # chunk must split (counted spills) and still rate exactly.
        got, _ = rate_stream(state, stream, CFG, batch_size=4,
                             steps_per_chunk=8, hot_rows=8)
        assert_same_table(table_of(base), table_of(got))
        assert reg.counter("tier.spills_total").value > 0

    def test_single_step_over_budget_raises(self):
        stream, state, _ = small_stream(n_matches=40, n_players=60)
        with pytest.raises(FeedStageError) as ei:
            # 8-slot hot set, 3v3 batches of 8: one superstep can touch
            # up to 48 rows — no step-boundary cut can fit it.
            rate_history(
                state,
                pack_schedule(stream, pad_row=state.pad_row, batch_size=8,
                              windowed=True),
                CFG, hot_rows=8,
            )
        assert "hot set" in str(ei.value.__cause__)
        assert "one superstep touches" in str(ei.value.__cause__)


EMPTY = np.empty(0, np.int32)


class TestPromotionProtocol:
    """Unit half: the dirty-writeback -> deferred re-promotion ordering
    that makes the cold tier correct under pipelining."""

    def manager(self, n_players=32, hot_rows=8):
        state = PlayerState.create(n_players, device="cpu")
        return TierManager(state, hot_rows), state

    def test_lru_demotes_dirty_row_and_defers_its_repromotion(self):
        tier, state = self.manager()
        table = tier.hot_state().table
        rows0 = np.arange(8, dtype=np.int32)
        p0 = tier.plan_rows(rows0, rows0)  # fill the hot set, all dirty
        tier.apply(table, p0)
        # Emulate the device writing row 0's slot (the window's compute).
        table[int(tier._slot_lut[0]), 0] = 123.0
        # Next window touches 8 fresh rows: all 8 slots evict, dirty.
        p1 = tier.plan_rows(np.arange(8, 16, dtype=np.int32), EMPTY)
        assert p1.wb_rows.size == 8  # LRU demoted the dirty residents
        tier.apply(table, p1)
        # Row 0 again: its writeback is still in flight at plan time, so
        # the promotion must be DEFERRED, not staged from the stale host.
        assert tier._host_table[0, 0] != 123.0
        p2 = tier.plan_rows(np.asarray([0], np.int32), EMPTY)
        assert p2.deferred_rows.tolist() == [0]
        assert p2.fresh_slots.size == 0 and p2.fresh_data is None
        tier.apply(table, p2)  # drains p1's writeback first
        assert tier._host_table[0, 0] == 123.0  # writeback landed
        assert table[int(tier._slot_lut[0]), 0] == 123.0  # and came back

    def test_clean_demotion_repromotes_fresh(self):
        tier, _ = self.manager()
        table = tier.hot_state().table
        tier.apply(table, tier.plan_rows(np.arange(8, dtype=np.int32), EMPTY))
        p1 = tier.plan_rows(np.arange(8, 16, dtype=np.int32), EMPTY)
        assert p1.wb_rows.size == 0  # clean demotions need no writeback
        tier.apply(table, p1)
        p2 = tier.plan_rows(np.asarray([0], np.int32), EMPTY)
        assert p2.deferred_rows.size == 0  # host copy never went stale
        assert p2.fresh_slots.size == 1

    def test_lru_picks_least_recently_used(self):
        tier, _ = self.manager()
        table = tier.hot_state().table
        tier.apply(table, tier.plan_rows(np.arange(8, dtype=np.int32), EMPTY))
        # Touch rows 4..7 again: rows 0..3 become the LRU candidates.
        tier.apply(table, tier.plan_rows(np.arange(4, 8, dtype=np.int32), EMPTY))
        p = tier.plan_rows(np.asarray([20, 21], np.int32), EMPTY)
        assert sorted(p.evict_rows.tolist()) == [0, 1]

    def test_applied_trails_a_copy_in_flight(self):
        """``applied`` names the last plan whose writebacks are in the cold
        tier. With a copy still in flight (an event that has not completed)
        it stays behind, and a polling drain writes nothing."""
        tier, _ = self.manager()
        table = tier.hot_state().table
        rows0 = np.arange(8, dtype=np.int32)
        tier.apply(table, tier.plan_rows(rows0, rows0))
        table[:8, 0] = 7.0
        tier.apply(table, tier.plan_rows(np.arange(8, 16, dtype=np.int32), EMPTY))

        class NeverDone:
            done = False

            def query(self):
                return self.done

            def synchronize(self):
                self.done = True

        seq, rows, host, _ = tier._pending[0]
        event = NeverDone()
        tier._pending[0] = (seq, rows, host, event)
        p2 = tier.plan_rows(np.arange(16, 24, dtype=np.int32), EMPTY)
        tier.apply(table, p2)  # nothing deferred: polls, does not wait
        assert tier._applied == seq - 1 and len(tier._pending) == 1
        assert np.isnan(tier._host_table[:8, 0]).all()  # not written yet
        p3 = tier.plan_rows(rows0, EMPTY)
        assert p3.deferred_rows.size == 8  # so rows 0..7 cannot be fresh
        tier.apply(table, p3)  # deferred: waits, then writes, then reads
        assert event.done and not tier._pending
        assert (tier._host_table[:8, 0] == 7.0).all()
        assert tier._applied == p3.seq - 1
        assert (table[torch.from_numpy(p3.promote_slots).long(), 0] == 7.0).all()

    def test_hot_rows_validation(self):
        state = PlayerState.create(16, device="cpu")
        with pytest.raises(ValueError, match="hot_rows"):
            TierManager(state, 0)
        empty = MatchStream(
            np.zeros((0, 2, 3), np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.int32), np.zeros(0, bool),
        )
        with pytest.raises(ValueError, match="hot_rows must be >= 0"):
            rate_history(
                state, pack_schedule(empty, pad_row=state.pad_row, windowed=True),
                CFG, hot_rows=-1,
            )
        with pytest.raises(ValueError, match="hot_rows must be >= 0"):
            rate_stream(state, empty, CFG, hot_rows=-1)

    def test_mesh_refuses_hot_rows(self):
        """The mesh and the tiered table do not compose (JAX's ValueError);
        the mesh alone runs (ported) and equals the unsharded run."""
        from analyzer_tpu_torch.parallel import make_mesh

        stream, state, _ = small_stream(n_matches=20, n_players=20)
        mesh = make_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="hot_rows > 0 is not supported with mesh"):
            rate_stream(state, stream, CFG, mesh=mesh, hot_rows=8)
        got, _ = rate_stream(state, stream, CFG, mesh=mesh)
        want, _ = rate_stream(state, stream, CFG)
        assert np.array_equal(got.table.numpy(), want.table.numpy(), equal_nan=True)

    def test_manager_follows_the_state_to_its_device(self):
        tier, state = self.manager()
        assert tier.device == state.table.device
        hot = tier.hot_state()
        assert hot.table.shape == (9, 16) and hot.pad_row == tier.hot_pad == 8
        assert not tier._host_tensor.is_pinned()  # pinned only beside a card
        assert np.array_equal(hot.table[8].numpy(), state.table[32].numpy(),
                              equal_nan=True)

    def test_telemetry_counters_and_gauges_move(self):
        reg = reset_registry()
        stream, state, _ = small_stream(n_matches=200, n_players=50, seed=23)
        rate_stream(state, stream, CFG, batch_size=8, steps_per_chunk=4,
                    hot_rows=16)
        for n in ("hits", "misses", "promotions", "demotions"):
            assert reg.counter(f"tier.{n}_total").value > 0, n
        assert reg.gauge("tier.hot_rows").value == 16
        assert reg.gauge("tier.host_bytes").value > 0


def _jax_state(players, n):
    return JaxState.create(
        n, rank_points_ranked=players.rank_points_ranked,
        rank_points_blitz=players.rank_points_blitz,
        skill_tier=players.skill_tier, cfg=JaxConfig(),
    )


def _plan_fields(plan, jax_side: bool) -> dict:
    out = {k: np.asarray(getattr(plan, k)).tolist()
           for k in ("wb_rows", "deferred_rows", "deferred_slots", "evict_rows",
                     "promote_rows", "promote_slots", "written_rows")}
    out["seq"] = plan.seq
    n_wb = len(out["wb_rows"])
    if jax_side:
        # bucket-padded: the real entries lead
        out["wb_slots"] = (np.asarray(plan.wb_idx)[:n_wb].tolist()
                           if plan.wb_idx is not None else [])
        n_fresh = len(out["promote_rows"]) - len(out["deferred_rows"])
        out["fresh_slots"] = (np.asarray(plan.fresh_idx)[:n_fresh].tolist()
                              if plan.fresh_idx is not None else [])
        out["fresh_data"] = (np.asarray(plan.fresh_rows)[:n_fresh]
                             if plan.fresh_rows is not None else None)
    else:
        out["wb_slots"] = plan.wb_slots.tolist()
        out["fresh_slots"] = plan.fresh_slots.tolist()
        out["fresh_data"] = plan.fresh_data
    return out


def _assert_same_plan(got, want, where):
    g, w = _plan_fields(got, False), _plan_fields(want, True)
    gd, wd = g.pop("fresh_data"), w.pop("fresh_data")
    assert g == w, where
    assert (gd is None) == (wd is None), where
    if gd is not None:
        assert np.array_equal(gd, wd, equal_nan=True), where


def _counter_values(reg) -> dict:
    return {n: reg.counter(f"tier.{n}_total").value for n in COUNTERS}


@pytest.mark.parametrize("hot_rows", [16, 64, 4096])
@pytest.mark.parametrize("kernel", ["reference", "fused"])
def test_plan_transactions_and_counters_equal_the_jax_package(hot_rows, kernel):
    """Both managers plan and apply the same chunks in the same order on
    one thread (so ``applied`` advances identically): equal span cuts,
    equal plans, equal remapped indices, equal counters, and equal logical
    tables after hand-made writes."""
    stream, state, players = small_stream(n_matches=240, n_players=60, seed=3)
    sched = pack_schedule(stream, pad_row=state.pad_row, windowed=True)
    jstate = _jax_state(players, 60)
    assert np.array_equal(np.asarray(jstate.table), state.table.numpy(), equal_nan=True)
    jreg = jax_registry()
    before = _counter_values(jreg)
    reg = reset_registry()
    ours, theirs = TierManager(state, hot_rows), jax_tier.TierManager(jstate, hot_rows)
    assert (ours.capacity, ours.hot_pad, ours.host_nbytes) == (
        theirs.capacity, theirs.hot_pad, theirs.host_nbytes)
    table, jtable = ours.hot_state().table, theirs.hot_state().table
    fuse = ours.clamp_fuse(resolve_fuse("fused", 4))
    assert fuse.max_rows == theirs.clamp_fuse(
        __import__("analyzer_tpu.sched.residency", fromlist=["x"]).resolve_fuse("fused", 4)
    ).max_rows
    rng = np.random.default_rng(0)
    for start in range(0, sched.n_steps, 6):
        pidx, _m, winner, mode_id, afk = sched.host_window(start, start + 6)
        ratable = (mode_id >= 0) & ~afk
        valid = (pidx != sched.pad_row) & ratable[:, :, None, None]
        if kernel == "reference":
            spans = ours.split_spans(pidx)
            assert spans == theirs.split_spans(pidx), start
            units = [(pidx[a:b], valid[a:b], None) for a, b in spans]
        else:
            plans = plan_windows(pidx, valid, sched.pad_row, fuse.window, fuse.max_rows)
            units, s0 = [], 0
            for p in plans:
                units.append((pidx[s0:s0 + p.n_steps], valid[s0:s0 + p.n_steps], p))
                s0 += p.n_steps
        for sub, sub_valid, rplan in units:
            if rplan is None:
                got, remap = ours.plan_window(sub, sub_valid)
                want, jremap = theirs.plan_window(sub, sub_valid)
            else:
                got, remap = ours.plan_fused(rplan.slot_rows, rplan.n_live, sub, sub_valid)
                want, jremap = theirs.plan_fused(rplan.slot_rows, rplan.n_live, sub, sub_valid)
            _assert_same_plan(got, want, start)
            assert np.array_equal(remap, jremap), start
            ours.apply(table, got)
            jtable = theirs.apply(jtable, want)
            # the "compute": the same new values into every written row
            if got.written_rows.size:
                vals = rng.normal(1500, 300, got.written_rows.size).astype(np.float32)
                slots = ours._slot_lut[got.written_rows]
                table[torch.from_numpy(slots).long(), 0] = torch.from_numpy(vals)
                jtable = jtable.at[slots, 0].set(vals)
            assert ours._applied == theirs._applied, start
    assert _counter_values(reg) == {
        n: v - before[n] for n, v in _counter_values(jreg).items()}
    assert np.array_equal(ours.full_table(table), theirs.full_table(jtable),
                          equal_nan=True)
    assert reg.gauge("tier.hot_rows").value == jreg.gauge("tier.hot_rows").value


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lru_choice_equals_the_jax_package_under_random_windows(seed):
    """300 random windows against a 64-slot hot set, many of them tied in
    last use (whole windows share a clock value): the evicted rows and the
    slots handed to the promoted rows — which depend on the ORDER of the
    evictions, slot id breaking ties — equal the JAX manager's full
    lexsort every time."""
    rng = np.random.default_rng(seed)
    state = PlayerState.create(400, device="cpu")
    ours = TierManager(state, 64)
    theirs = jax_tier.TierManager(JaxState.create(400), 64)
    for step in range(300):
        touched = np.unique(rng.integers(0, 400, rng.integers(1, 60))).astype(np.int32)
        written = touched[rng.random(touched.size) < 0.6]
        got, want = ours.plan_rows(touched, written), theirs.plan_rows(touched, written)
        for field in ("evict_rows", "promote_rows", "promote_slots", "wb_rows"):
            assert np.array_equal(getattr(got, field), getattr(want, field)), (step, field)
    assert np.array_equal(ours._slot_lut, theirs._slot_lut)
    assert np.array_equal(ours._last_use, theirs._last_use)


class TestServeViewParity:
    def capture_views(self, workload, runner="history", **kw):
        pub = ViewPublisher(min_publish_interval_s=0.0, device="cpu")
        versions = []
        orig = pub._swap

        def swap(table, n):
            view = orig(table, n)
            versions.append((view.version, view.host_table().copy()))
            return view

        pub._swap = swap
        if runner == "history":
            rate_history(workload["state"], workload["sched"], CFG,
                         steps_per_chunk=6, view_publisher=pub, **kw)
        else:
            rate_stream(workload["state"], workload["stream"], CFG,
                        batch_size=8, steps_per_chunk=5, view_publisher=pub, **kw)
        return versions, pub

    @pytest.mark.parametrize("runner", ["history", "stream"])
    @pytest.mark.parametrize("kernel", ["reference", "fused"])
    def test_tiered_views_bit_identical_to_untiered(self, workload, runner, kernel):
        kw = dict(kernel=kernel, fuse_window=4, fuse_backend="torch")
        base, _ = self.capture_views(workload, runner, **kw)
        got, _ = self.capture_views(workload, runner, hot_rows=32, **kw)
        assert [v for v, _ in base] == [v for v, _ in got] and len(base) > 3
        for (version, a), (_, b) in zip(base, got):
            assert_same_table(a, b, f"version={version}")
        final = workload["hist" if runner == "history" else "stream_run"][0]
        assert_same_table(got[-1][1][:60], final[:60])

    def test_tiered_publishes_ride_the_patch_path(self, workload):
        """After the first (full-rebuild) publish, tiered publishes move
        only the rows written since the last one."""
        reset_registry()
        _, pub = self.capture_views(workload, hot_rows=32)
        full = (64 + 1) * 16 * 4
        moved = get_registry().counter("serve.view_publish_bytes_total").value
        assert pub.version > 3
        assert full < moved < full * pub.version / 2

    def test_publish_state_patch_matches_full_rebuild(self):
        state = PlayerState.create(20, device="cpu")
        table = table_of(state)
        table[3, 0] = 30.0
        pub_patch = ViewPublisher(min_publish_interval_s=0.0, device="cpu")
        pub_full = ViewPublisher(min_publish_interval_s=0.0, device="cpu")
        pub_patch.publish_state(state)
        pub_full.publish_state(state)
        pub_patch.publish_state_patch(
            np.asarray([3]), table[3:4], 20,
            full_table=lambda: pytest.fail("patch path must not rebuild"),
        )
        pub_full.publish_state(table)
        assert_same_table(pub_patch.current().host_table(),
                          pub_full.current().host_table())

    def test_due_throttles(self):
        pub = ViewPublisher(min_publish_interval_s=3600.0, device="cpu")
        assert pub.due()  # first publish always due
        pub.publish_state(PlayerState.create(4, device="cpu"))
        assert not pub.due()
