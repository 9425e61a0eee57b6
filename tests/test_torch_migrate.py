"""The port's zero-downtime migration (``analyzer_tpu_torch.migrate``)
against the JAX package's (``analyzer_tpu.migrate``) and against itself.

Against the JAX package:

  * the incremental assigners (native and python, each package's) give
    byte-equal (batch, slot, batches-used, progress) over JAX's window
    matrix (tests/test_migrate.py: windows of 1, 7, 300 and 4096 matches
    on plain, filler-heavy and heavy-tailed ladders, capacities 1 and 8);
  * ``migration_fingerprint`` is the same sha1 over the same bytes;
  * ``rate_backfill``'s schedule (batch size, supersteps, occupancy,
    fingerprint, prefix) is the JAX engine's exactly, and its final table
    and collected outputs are within tests/test_torch_stream.py's
    tolerances (rtol 2e-6, atol 2e-3: the two packages' transcendentals
    and sum orders differ in the last ulps, tests/test_torch_ops.py), with
    the NaN pattern and the ``updated`` / ``any_afk`` gates exact;
  * ``AdmissionController`` makes JAX's decisions on the same counter
    deltas (tests/test_torch_broker_partitioned.py holds the full sequence;
    here, the engine's throttle under it).

Inside the port, bit for bit: ``rate_backfill`` equals ``rate_stream``
over the same decoded stream for both kernels with and without a tiered
table, a run resumed from a checkpoint equals the one-shot run, the
assigner route and the batch size do not change the table, the
lineage cutover is atomic and monotone on single and sharded planes, and
``cli migrate`` (killed and resumed) writes ``cli rate``'s checkpoint
table, with the JAX CLI's flag errors word for word.

Everything runs on the CPU (``device="cpu"``) at a few hundred matches.
"""

import json
import os
import threading

import numpy as np
import pytest

import analyzer_tpu.migrate as jmigrate
from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.core.state import PlayerState as JaxPlayerState
from analyzer_tpu.sched import _native as jnative
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import TABLE_WIDTH, PlayerState
from analyzer_tpu_torch.io.csv_codec import load_stream_csv, save_stream_csv
from analyzer_tpu_torch.io.ingest import ColumnarDecoder, decode_stream_csv
from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
from analyzer_tpu_torch.migrate import (
    IncrementalAssigner,
    LineageManager,
    NativeIncrementalAssigner,
    PyIncrementalAssigner,
    assign_native_available,
    get_migration_progress,
    migration_fingerprint,
    rate_backfill,
    reset_migration_progress,
    run_migration,
)
from analyzer_tpu_torch.obs import get_registry
from analyzer_tpu_torch.sched import _native
from analyzer_tpu_torch.sched.runner import rate_stream
from analyzer_tpu_torch.sched.superstep import MatchStream
from analyzer_tpu_torch.serve import ShardedViewPublisher, ViewPublisher
from analyzer_tpu_torch.service.broker import AdmissionController

CFG = RatingConfig()
JCFG = JaxRatingConfig()
RTOL, ATOL = 2e-6, 2e-3
OUT_FIELDS = ("quality", "shared_mu", "shared_sigma", "delta",
              "mode_mu", "mode_sigma", "any_afk", "updated")
PARITY_CASES = [("reference", 0), ("fused", 0), ("reference", 32), ("fused", 32)]


@pytest.fixture(autouse=True)
def _idle_progress():
    """The migration progress record is process-wide: leave it idle, so a
    later test's ``Worker.stats()['migration']`` reads None as it would in
    a fresh process."""
    yield
    reset_migration_progress()


def _csv_bytes(tmp_path, n_matches=400, n_players=80, seed=11, **kw):
    players = synthetic_players(n_players, seed=seed)
    s = synthetic_stream(n_matches, players, seed=seed, **kw)
    path = os.path.join(tmp_path, f"s{seed}_{n_matches}.csv")
    save_stream_csv(path, s)
    with open(path, "rb") as f:
        return f.read(), s


def _state(n_players=80):
    return PlayerState.create(n_players, cfg=CFG, device="cpu")


def _jstate(n_players=80):
    return JaxPlayerState.create(n_players, cfg=JCFG)


def _table(state) -> np.ndarray:
    return state.table.numpy()


# -- the incremental assigners ------------------------------------------------


def _run_assigner(cls, capacity, stream, step):
    """One windowed pass; returns (batch, slot, batches_used, progress)."""
    n = stream.n_matches
    out_b = np.full(n, -9, np.int64)
    out_s = np.full(n, -9, np.int64)
    progress = np.zeros(2, np.int64)
    a = cls(capacity, out_b, out_s, progress)
    for lo in range(0, n, step):
        a.feed(stream.player_idx, stream.mode_id, stream.afk,
               lo, min(lo + step, n))
    used = a.batches_used
    a.finish()
    a.close()
    return out_b, out_s, used, progress


class TestAssignersAgainstJax:
    """Each package's native and python assigner over JAX's window matrix:
    all four give the same integers."""

    STREAMS = {
        "plain": dict(seed=5),
        "filler_heavy": dict(seed=7, afk_rate=0.5),
        "heavy_tailed": dict(seed=9, max_activity_share=0.5),
    }

    @pytest.mark.parametrize("shape", sorted(STREAMS))
    @pytest.mark.parametrize("step", [1, 7, 300, 4096])
    def test_window_matrix_equals_jax(self, shape, step):
        kw = dict(self.STREAMS[shape])
        players = synthetic_players(40, seed=kw.pop("seed"))
        s = synthetic_stream(600, players, seed=8, **kw)
        for cap in (1, 8):
            want = _run_assigner(jmigrate.NativeIncrementalAssigner, cap, s, step)
            for cls in (NativeIncrementalAssigner, PyIncrementalAssigner,
                        jmigrate.PyIncrementalAssigner):
                got = _run_assigner(cls, cap, s, step)
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
                assert got[2] == want[2]
                np.testing.assert_array_equal(got[3], want[3])

    def test_windowed_equals_one_shot_on_a_ratable_stream(self):
        raw = synthetic_stream(600, synthetic_players(50, seed=5), seed=5)
        keep = raw.ratable
        s = MatchStream(raw.player_idx[keep], raw.winner[keep],
                        raw.mode_id[keep], raw.afk[keep])
        got = _run_assigner(NativeIncrementalAssigner, 8, s, 97)
        ref_b, ref_s = _native.assign_batches_first_fit(_native.load(), s, 8)
        np.testing.assert_array_equal(got[0], ref_b)
        np.testing.assert_array_equal(got[1], ref_s)
        jb, js = jnative.assign_batches_first_fit(s, 8)
        np.testing.assert_array_equal(got[0], jb)
        np.testing.assert_array_equal(got[1], js)

    def test_fillers_placed_inline_with_chronology(self):
        s = synthetic_stream(400, synthetic_players(30, seed=3), seed=3,
                             afk_rate=0.3)
        out_b, _out_s, _used, _p = _run_assigner(IncrementalAssigner, 8, s, 400)
        assert (out_b >= 0).all()  # every match, fillers too, placed
        last = {}
        for i in np.flatnonzero(s.ratable):
            for p in s.player_idx[i].ravel():
                if p >= 0:
                    assert out_b[i] > last.get(int(p), -1)
                    last[int(p)] = out_b[i]
        assert np.bincount(out_b).max() <= 8

    @pytest.mark.parametrize("cls", [NativeIncrementalAssigner, PyIncrementalAssigner])
    def test_contiguity_contract(self, cls):
        s = synthetic_stream(50, synthetic_players(10, seed=1), seed=1)
        out = np.full(50, -1, np.int64)
        a = cls(4, out, out.copy())
        a.feed(s.player_idx, s.mode_id, s.afk, 0, 10)
        with pytest.raises(ValueError, match="contiguous"):
            a.feed(s.player_idx, s.mode_id, s.afk, 20, 30)
        a.close()
        a.close()  # idempotent

    def test_native_close_and_router(self):
        s = synthetic_stream(50, synthetic_players(10, seed=1), seed=1)
        out = np.full(50, -1, np.int64)
        a = NativeIncrementalAssigner(4, out, out.copy())
        a.close()
        with pytest.raises(ValueError, match="closed"):
            a.feed(s.player_idx, s.mode_id, s.afk, 0, 10)
        assert assign_native_available()  # g++ is here
        for native, want in ((None, True), (True, True), (False, False)):
            r = IncrementalAssigner(4, out, out.copy(), native=native)
            assert r.is_native is want
            r.close()


# -- the fingerprint -----------------------------------------------------------


@pytest.mark.parametrize("args", [
    (b"x" * 100, 8, 4),
    (b"y" * 100, 8, 4),
    (b"x" * 100, 16, 4),
    (b"x" * 100, 8, 8),
    (b"x" * 100, 8, 4, 4, 4096),
    (b"x" * 100, 8, 4, 2, 4096),
    (b"x" * 100, 8, 4, 4, 128),
    (b"", 1, 256, 1, None),
])
def test_fingerprint_equals_jax(args):
    assert migration_fingerprint(*args) == jmigrate.migration_fingerprint(*args)


def test_fingerprint_is_content_and_policy_addressed():
    a = migration_fingerprint(b"x" * 100, 8, 4)
    assert a == migration_fingerprint(b"x" * 100, 8, 4)
    assert a != migration_fingerprint(b"y" * 100, 8, 4)
    b = migration_fingerprint(b"x" * 100, 8, 4, plan_windows=4, window_rows=4096)
    assert b != a and b == migration_fingerprint(b"x" * 100, 8, 4, 4, 4096)


# -- rate_backfill --------------------------------------------------------------


class TestBackfillParity:
    @pytest.mark.parametrize("kernel,hot_rows", PARITY_CASES)
    def test_bit_identical_to_rate_stream(self, kernel, hot_rows, tmp_path):
        """The whole-stream result equals the port's ``rate_stream`` over
        the decoded stream bit for bit — every output field, since the
        port's reference and fused paths both compute a filler's gate
        outputs wherever it sits."""
        data, _ = _csv_bytes(tmp_path, 500, seed=13, afk_rate=0.1)
        dec = decode_stream_csv(data)
        ref, ref_out = rate_stream(_state(), dec, CFG, collect=True,
                                   kernel=kernel, hot_rows=hot_rows,
                                   fuse_window=4)
        got, got_out = rate_backfill(
            _state(), data, CFG, collect=True, kernel=kernel,
            hot_rows=hot_rows, fuse_window=4, window_rows=128,
            steps_per_chunk=4,
        )
        np.testing.assert_array_equal(_table(ref), _table(got))
        upd = ref_out.updated
        np.testing.assert_array_equal(upd, got_out.updated)
        for field in ("quality", "any_afk"):
            np.testing.assert_array_equal(getattr(ref_out, field),
                                          getattr(got_out, field), err_msg=field)
        for field in ("shared_mu", "shared_sigma", "delta", "mode_mu", "mode_sigma"):
            np.testing.assert_array_equal(getattr(ref_out, field)[upd],
                                          getattr(got_out, field)[upd],
                                          err_msg=field)

    @pytest.mark.parametrize("kernel,hot_rows", PARITY_CASES)
    def test_against_jax_rate_backfill(self, kernel, hot_rows, tmp_path):
        """The schedule equals the JAX engine's exactly; the table and the
        outputs agree within the stated tolerance."""
        data, _ = _csv_bytes(tmp_path, 500, seed=13, afk_rate=0.1)
        kw = dict(collect=True, kernel=kernel, hot_rows=hot_rows, fuse_window=4,
                  window_rows=128, plan_windows=2)
        stats, jstats = {}, {}
        got, got_out = rate_backfill(_state(), data, CFG, stats_out=stats, **kw)
        want, want_out = jmigrate.rate_backfill(_jstate(), data, JCFG,
                                                stats_out=jstats, **kw)
        for key in ("n_steps", "batch_size", "occupancy", "matches", "fingerprint",
                    "streamed", "prefix_rows", "prefix_windows", "plan_windows",
                    "emitted_steps", "stopped", "assign_native"):
            assert stats[key] == jstats[key], key
        a, b = _table(got), np.asarray(want.table)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got_out.updated, want_out.updated)
        np.testing.assert_array_equal(got_out.any_afk, want_out.any_afk)
        upd = want_out.updated
        for field in OUT_FIELDS[:6]:
            np.testing.assert_allclose(getattr(got_out, field)[upd],
                                       getattr(want_out, field)[upd],
                                       rtol=RTOL, atol=ATOL, err_msg=field)

    def test_assigner_route_is_result_invisible(self, tmp_path):
        data, _ = _csv_bytes(tmp_path, 500, seed=29, afk_rate=0.15)
        runs = {}
        for native in (True, False):
            stats: dict = {}
            st, outs = rate_backfill(_state(), data, CFG, collect=True,
                                     window_rows=64, steps_per_chunk=4,
                                     assign_native=native, stats_out=stats)
            assert stats["assign_native"] is native and stats["streamed"]
            runs[native] = (_table(st), outs)
        np.testing.assert_array_equal(runs[True][0], runs[False][0])
        for field in OUT_FIELDS:
            np.testing.assert_array_equal(getattr(runs[True][1], field),
                                          getattr(runs[False][1], field),
                                          err_msg=field)

    def test_batch_size_and_prefix_policy_leave_the_table(self, tmp_path):
        data, _ = _csv_bytes(tmp_path, 300, seed=19)
        tables, fps = [], set()
        for kw in (dict(batch_size=4), dict(batch_size=16),
                   dict(plan_windows=1, window_rows=64),
                   dict(plan_windows=3, window_rows=64)):
            stats: dict = {}
            st, _ = rate_backfill(_state(), data, CFG, stats_out=stats, **kw)
            tables.append(_table(st))
            fps.add(stats["fingerprint"])
        assert len(fps) == 4
        for t in tables[1:]:
            np.testing.assert_array_equal(tables[0], t)

    def test_plan_prefix_covers_k_windows(self, tmp_path):
        data, _ = _csv_bytes(tmp_path, 300, seed=37)
        stats: dict = {}
        rate_backfill(_state(), data, CFG, window_rows=64, plan_windows=2,
                      stats_out=stats)
        assert (stats["plan_windows"], stats["prefix_windows"],
                stats["prefix_rows"]) == (2, 2, 128)
        stats2: dict = {}
        rate_backfill(_state(), data, CFG, window_rows=64, plan_windows=50,
                      stats_out=stats2)
        assert (stats2["prefix_rows"], stats2["prefix_windows"]) == (300, 5)
        with pytest.raises(ValueError, match="plan_windows"):
            rate_backfill(_state(), data, CFG, plan_windows=0)

    def test_gauge_counters_and_progress(self, tmp_path):
        data, _ = _csv_bytes(tmp_path, 200, seed=31)
        reg = get_registry()
        before = reg.counter("migrate.assign_matches_total").value
        steps0 = reg.counter("migrate.steps_total").value
        stats: dict = {}
        rate_backfill(_state(), data, CFG, stats_out=stats)
        assert reg.gauge("migrate.assign_native").value == stats["assign_native"] is True
        assert reg.counter("migrate.assign_matches_total").value - before == 200
        assert reg.counter("migrate.steps_total").value - steps0 == stats["n_steps"]
        snap = get_migration_progress().snapshot()
        assert snap["phase"] == "done"
        assert snap["backfill_watermark_steps"] == stats["n_steps"]
        assert snap["steps_total"] == stats["n_steps"]
        assert snap["progress_pct"] == 100.0

    def test_fallback_on_quoted_grammar(self, tmp_path):
        data, _ = _csv_bytes(tmp_path, 200, seed=23)
        data = data + b'"quoted",ranked,0,0,1;2;3,4;5;6\n'
        reg = get_registry()
        before = reg.counter("migrate.fallbacks_total").value
        stats: dict = {}
        st, _ = rate_backfill(_state(), data, CFG, stats_out=stats)
        assert stats["streamed"] is False
        assert reg.counter("migrate.fallbacks_total").value == before + 1
        ref, _ = rate_stream(_state(), load_stream_csv(
            __import__("io").StringIO(data.decode())), CFG)
        np.testing.assert_array_equal(_table(ref), _table(st))
        jstats: dict = {}
        jst, _ = jmigrate.rate_backfill(_jstate(), data, JCFG, stats_out=jstats)
        assert jstats["streamed"] is False
        np.testing.assert_allclose(_table(st), np.asarray(jst.table),
                                   rtol=RTOL, atol=ATOL)
        with pytest.raises(ValueError, match="fallback"):
            rate_backfill(_state(), data, CFG, start_step=4)

    def test_empty_stream(self):
        header = b"match_id,mode,winner,afk,team0,team1\n"
        pub = ViewPublisher(device="cpu")
        st, outs = rate_backfill(_state(), header, CFG, collect=True, staging=pub)
        assert outs.updated.shape == (0,)
        np.testing.assert_array_equal(_table(st), _table(_state()))
        assert pub.version == 1
        _jst, jouts = jmigrate.rate_backfill(_jstate(), header, JCFG, collect=True)
        assert jouts.updated.shape == (0,)

    def test_card_default_and_bad_args(self, tmp_path):
        data, _ = _csv_bytes(tmp_path, 50, seed=2)
        with pytest.raises(ValueError, match="collect"):
            rate_backfill(_state(), data, CFG, collect=True, start_step=4)
        with pytest.raises(ValueError, match="hot_rows"):
            rate_backfill(_state(), data, CFG, hot_rows=-1)
        with pytest.raises(ValueError, match="window boundary"):
            rate_backfill(_state(), data, CFG, steps_per_chunk=4, start_step=3)

    def test_first_dispatch_before_decode_completes(self, monkeypatch, tmp_path):
        """Decode past the planning prefix blocks until the first chunk has
        dispatched: an engine that needed the whole file first would time
        out here instead of passing."""
        import analyzer_tpu_torch.migrate.engine as engine_mod

        gate = threading.Event()
        plan = 2

        class GatedDecoder(ColumnarDecoder):
            def windows(self):
                served = 0
                for win in super().windows():
                    if served >= plan and not gate.wait(timeout=60):
                        raise RuntimeError("no dispatch while decode was pending")
                    served += 1
                    yield win

        monkeypatch.setattr(engine_mod, "ColumnarDecoder", GatedDecoder)
        data, _ = _csv_bytes(tmp_path, 1200, n_players=200, seed=31)
        stats: dict = {}
        rate_backfill(_state(200), data, CFG, window_rows=64, plan_windows=plan,
                      steps_per_chunk=2, on_chunk=lambda _s, _n: gate.set(),
                      stats_out=stats)
        assert gate.is_set() and stats["matches"] == 1200
        assert stats["ttfd_s"] is not None


# -- checkpoint and resume ------------------------------------------------------


class TestResume:
    @pytest.mark.parametrize("kernel,hot_rows", PARITY_CASES)
    def test_resume_bit_identical(self, kernel, hot_rows, tmp_path):
        data, _ = _csv_bytes(tmp_path, 400, seed=41, afk_rate=0.1)
        kw = dict(kernel=kernel, hot_rows=hot_rows, fuse_window=4,
                  window_rows=128, steps_per_chunk=4, device="cpu")
        full = run_migration(_state(), data, CFG, **kw)
        assert full.finished
        ref = _table(full.state)
        total = full.stats["n_steps"]
        for stop in (4, max(4, (total // 2) // 4 * 4)):
            ck = str(tmp_path / f"mig-{kernel}-{hot_rows}-{stop}.npz")
            bounded = run_migration(_state(), data, CFG, checkpoint=ck,
                                    stop_after=stop, **kw)
            assert not bounded.finished and os.path.exists(ck)
            resumed = run_migration(None, data, CFG, checkpoint=ck, resume=True, **kw)
            assert resumed.finished and resumed.stats["streamed"]
            np.testing.assert_array_equal(ref, _table(resumed.state),
                                          err_msg=f"stop={stop}")

    def test_periodic_checkpoints_resume(self, tmp_path):
        data, _ = _csv_bytes(tmp_path, 400, seed=43)
        kw = dict(window_rows=128, steps_per_chunk=4, device="cpu")
        ref = _table(run_migration(_state(), data, CFG, **kw).state)
        ck = str(tmp_path / "periodic.npz")
        run_migration(_state(), data, CFG, checkpoint=ck, checkpoint_every=8,
                      stop_after=16, **kw)
        resumed = run_migration(None, data, CFG, checkpoint=ck, resume=True, **kw)
        np.testing.assert_array_equal(ref, _table(resumed.state))

    @pytest.mark.parametrize("change", ["bytes", "plan_policy"])
    def test_changed_schedule_rejected_on_resume(self, change, tmp_path):
        data, _ = _csv_bytes(tmp_path, 300, seed=47)
        other, _ = _csv_bytes(tmp_path, 300, seed=48)
        ck = str(tmp_path / "fp.npz")
        kw = dict(window_rows=64, steps_per_chunk=4, device="cpu")
        run_migration(_state(), data, CFG, checkpoint=ck, stop_after=4,
                      plan_windows=1, **kw)
        resume_kw = (dict(plan_windows=1) if change == "bytes"
                     else dict(plan_windows=3))
        with pytest.raises(ValueError, match="no longer matches"):
            run_migration(None, other if change == "bytes" else data, CFG,
                          checkpoint=ck, resume=True, **resume_kw, **kw)

    def test_port_checkpoint_resumes_in_jax(self, tmp_path):
        """A mid-migration checkpoint carries the JAX engine's fingerprint,
        so the JAX package resumes it (and the table agrees within the
        tolerance)."""
        data, _ = _csv_bytes(tmp_path, 400, seed=59, afk_rate=0.1)
        kw = dict(window_rows=128, steps_per_chunk=4)
        ck = str(tmp_path / "cross.npz")
        run_migration(_state(), data, CFG, checkpoint=ck, stop_after=8,
                      device="cpu", **kw)
        resumed = jmigrate.run_migration(None, data, JCFG, checkpoint=ck,
                                         resume=True, **kw)
        full = run_migration(_state(), data, CFG, device="cpu", **kw)
        np.testing.assert_allclose(_table(full.state), np.asarray(resumed.state.table),
                                   rtol=RTOL, atol=ATOL)


# -- the lineage cutover ---------------------------------------------------------


def _rows(n, fill):
    return np.full((n, TABLE_WIDTH), fill, np.float32)


class TestLineageCutover:
    def test_cutover_monotone_and_adopts_table(self):
        live = ViewPublisher(device="cpu")
        live.publish_rows(["a", "b"], _rows(2, 1.0))
        live.publish_rows(["a"], _rows(1, 2.0))
        lineage = LineageManager(live)
        staging = lineage.begin()
        assert staging.device == live.device
        staging.publish_state(PlayerState.create(4, cfg=CFG, device="cpu"),
                              ids=["a", "b", "c", "d"])
        assert staging.version == 1
        staged = staging.current()
        view = lineage.cutover()
        assert view.version == 3 and live.current() is view
        assert view.n_players == 4 and view.resolve("c") == 2
        assert view.table is staged.table  # adopted by reference, no copy
        assert lineage.cutover_pause_s is not None
        assert get_migration_progress().snapshot()["cutover_pause_ms"] is not None

    def test_readers_never_see_torn_or_backward_versions(self):
        live = ViewPublisher(device="cpu")
        live.publish_rows(["p"], _rows(1, 1.0))
        stop = threading.Event()
        bad: list = []

        def reader():
            last = 0
            while not stop.is_set():
                v = live.current()
                if v is None or v.version < last:
                    bad.append(v and v.version)
                    continue
                last = v.version

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        for _ in range(20):
            lineage = LineageManager(live)
            lineage.begin().publish_state(PlayerState.create(2, cfg=CFG, device="cpu"))
            lineage.cutover()
            live.publish_state(PlayerState.create(2, cfg=CFG, device="cpu"))
        stop.set()
        t.join()
        assert not bad and live.version == 41

    def test_retired_staging_and_missing_view(self):
        live = ViewPublisher(device="cpu")
        lineage = LineageManager(live)
        staging = lineage.begin()
        with pytest.raises(RuntimeError, match="already in flight"):
            lineage.begin()
        with pytest.raises(ValueError, match="no published view"):
            lineage.cutover()
        staging.publish_state(PlayerState.create(2, cfg=CFG, device="cpu"))
        lineage.staging = staging
        lineage.cutover()
        with pytest.raises(RuntimeError, match="retired"):
            staging.publish_state(PlayerState.create(2, cfg=CFG, device="cpu"))
        with pytest.raises(RuntimeError, match="no staging"):
            lineage.cutover()

    def test_live_publishes_continue_after_cutover(self):
        live = ViewPublisher(device="cpu")
        live.publish_rows(["a"], _rows(1, 1.0))
        lineage = LineageManager(live)
        lineage.begin().publish_state(PlayerState.create(2, cfg=CFG, device="cpu"),
                                      ids=["a", "b"])
        lineage.cutover()
        view = live.publish_rows(["b"], _rows(1, 9.0))
        assert view.resolve("b") == 1
        assert float(view.host_table()[1, 0]) == 9.0

    def test_sharded_cutover_and_topology(self):
        live = ShardedViewPublisher(2, device="cpu")
        live.publish_state(PlayerState.create(6, cfg=CFG, device="cpu"))
        lineage = LineageManager(live)
        staging = lineage.begin()
        assert isinstance(staging, ShardedViewPublisher) and staging.n_shards == 2
        state = PlayerState.create(6, cfg=CFG, device="cpu")
        staging.publish_state(state, ids=[f"p{i}" for i in range(6)])
        view = lineage.cutover()
        assert view.version == live.version == 2
        np.testing.assert_array_equal(view.host_table(), _table(state)[:6])
        assert view.resolve("p3") == 3
        other = ShardedViewPublisher(4, device="cpu")
        other.publish_state(PlayerState.create(4, cfg=CFG, device="cpu"))
        with pytest.raises(ValueError, match="shard"):
            live.cutover_from(other)

    def test_abort_leaves_live_untouched_and_fabric_waits(self):
        """Abort leaves the live lineage as it was, for a plain staging
        lineage and for the fabric's (``begin_fabric``, once refused), which
        wraps a staging lineage of the live plane's topology."""
        from analyzer_tpu_torch.fabric import (
            FabricDirectory, FabricShardPublisher, FabricTopology,
        )

        live = ViewPublisher(device="cpu")
        live.publish_rows(["a"], _rows(1, 1.0))
        before = live.current()
        lineage = LineageManager(live)
        lineage.begin().publish_state(PlayerState.create(2, cfg=CFG, device="cpu"))
        lineage.abort()
        assert live.current() is before and live.version == 1
        sharded = ShardedViewPublisher(2, device="cpu")
        lineage = LineageManager(sharded)
        directory = FabricDirectory(FabricTopology(2, 2))
        wrapped = lineage.begin_fabric(directory, 1, clock=lambda: 5.0)
        assert isinstance(wrapped, FabricShardPublisher)
        assert isinstance(lineage.staging, ShardedViewPublisher)
        assert wrapped.inner is lineage.staging and wrapped.owned == {1}
        lineage.abort()
        assert lineage.staging is None and sharded.current() is None

    def test_run_migration_cuts_over_a_served_table(self, tmp_path):
        data, _ = _csv_bytes(tmp_path, 300, seed=61)
        live = ViewPublisher(device="cpu")
        live.publish_state(_state())
        ids = [f"p{i}" for i in range(80)]
        report = run_migration(_state(), data, CFG, lineage=LineageManager(live),
                               ids=ids, kernel="fused", device="cpu")
        assert report.finished and report.cutover_pause_ms is not None
        assert report.view is live.current() and live.version == 2
        np.testing.assert_array_equal(live.current().host_table()[:80],
                                      _table(report.state)[:80])
        assert live.current().resolve("p7") == 7

    def test_bounded_run_never_touches_live(self, tmp_path):
        data, _ = _csv_bytes(tmp_path, 300, seed=67)
        live = ViewPublisher(device="cpu")
        live.publish_state(_state())
        before = live.current()
        lineage = LineageManager(live)
        report = run_migration(_state(), data, CFG, lineage=lineage,
                               checkpoint=str(tmp_path / "b.npz"), stop_after=4,
                               steps_per_chunk=4, device="cpu")
        assert not report.finished and report.view is None
        assert live.current() is before and lineage.staging is None


# -- the admission gate ---------------------------------------------------------


class TestAdmissionThrottle:
    def test_backfill_pauses_for_live_backlog_then_finishes(self, tmp_path):
        data, _ = _csv_bytes(tmp_path, 300, seed=53)
        calls = {"n": 0}

        def live_backlog():
            calls["n"] += 1
            return 5 if calls["n"] <= 3 else 0  # live drains after a few polls

        reg = get_registry()
        before = reg.counter("migrate.throttled_total").value
        stats: dict = {}
        st, _ = rate_backfill(_state(), data, CFG, window_rows=128,
                              steps_per_chunk=4, admission=AdmissionController(),
                              live_backlog=live_backlog, throttle_poll_s=0.001,
                              stats_out=stats)
        assert reg.counter("migrate.throttled_total").value - before == 3
        ref, _ = rate_stream(_state(), decode_stream_csv(data), CFG)
        np.testing.assert_array_equal(_table(ref), _table(st))
        assert stats["admission_halvings"] == 0  # quiet telemetry

    def test_halvings_counted_on_starvation_telemetry(self, tmp_path):
        """A controller reading a growing ``feed.starved_total`` halves its
        window; the engine admits all the same and counts each halving."""
        from analyzer_tpu_torch.obs.registry import MetricsRegistry

        data, _ = _csv_bytes(tmp_path, 300, seed=71)
        private = MetricsRegistry()
        starved = private.counter("feed.starved_total")

        def live_backlog():
            starved.add(1)  # the host looks starved at every dispatch
            return 0

        stats: dict = {}
        st, _ = rate_backfill(_state(), data, CFG, window_rows=128,
                              steps_per_chunk=4,
                              admission=AdmissionController(registry=private),
                              live_backlog=live_backlog, stats_out=stats)
        windows = -(-stats["n_steps"] // 4)
        # The first quota sets the controller's baseline; every later one
        # sees a delta of 1 and halves.
        assert stats["admission_halvings"] == windows - 1
        ref, _ = rate_stream(_state(), decode_stream_csv(data), CFG)
        np.testing.assert_array_equal(_table(ref), _table(st))


def test_worker_stats_carry_the_migration_block(tmp_path):
    from analyzer_tpu_torch.config import ServiceConfig
    from analyzer_tpu_torch.service.broker import InMemoryBroker
    from analyzer_tpu_torch.service.store import InMemoryStore
    from analyzer_tpu_torch.service.worker import Worker

    worker = Worker(InMemoryBroker(), InMemoryStore(),
                    ServiceConfig(batch_size=4, idle_timeout=0.0), CFG,
                    pipeline=False, slo_plane=False, device="cpu")
    try:
        reset_migration_progress()
        assert worker.stats()["migration"] is None
        data, _ = _csv_bytes(tmp_path, 200, seed=73)
        stats: dict = {}
        rate_backfill(_state(), data, CFG, stats_out=stats)
        block = worker.stats()["migration"]
        assert block["phase"] == "done"
        assert block["matches_assigned"] == 200 and block["assign_native"] is True
        assert block["steps_total"] == stats["n_steps"]
    finally:
        worker.close()


# -- cli migrate ------------------------------------------------------------------


class TestCliMigrate:
    def _run(self, argv, capsys):
        from analyzer_tpu_torch import cli

        rc = cli.main(argv)
        out = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(out[-1]) if out and out[-1].startswith("{") else None)

    @pytest.mark.parametrize("kernel,hot_rows", [("reference", 0), ("fused", 32)])
    def test_kill_resume_and_cutover_equal_cli_rate(self, kernel, hot_rows,
                                                    tmp_path, capsys):
        from analyzer_tpu_torch.io.checkpoint import load_checkpoint

        data, _ = _csv_bytes(tmp_path, 400, seed=79, afk_rate=0.1)
        path = str(tmp_path / "h.csv")
        with open(path, "wb") as f:
            f.write(data)
        common = ["--csv", path, "--device", "cpu", "--kernel", kernel,
                  "--hot-rows", str(hot_rows)]
        ck_rate = str(tmp_path / "rate.npz")
        from analyzer_tpu_torch import cli

        assert cli.main(["rate", "--csv", path, "--device", "cpu", "--kernel",
                         kernel, "--checkpoint", ck_rate]) == 0
        capsys.readouterr()
        ck = str(tmp_path / "mig.npz")
        rc, line = self._run(["migrate", *common, "--checkpoint", ck,
                              "--checkpoint-every", "8", "--stop-after-steps",
                              "16"], capsys)
        assert rc == 0 and line["stopped"] is True and line["cutover_pause_ms"] is None
        assert load_checkpoint(ck, device="cpu").step_cursor >= 16
        rc, line = self._run(["migrate", *common, "--checkpoint", ck, "--resume"],
                             capsys)
        assert rc == 0 and line["stopped"] is False and line["streamed"] is True
        assert line["lineage_live_version"] == 1 and line["assign_native"] is True
        assert set(line["quality"]["migrated"]) == {"matches_scored", "brier",
                                                    "logloss", "ece"}
        got = load_checkpoint(ck, device="cpu")
        want = load_checkpoint(ck_rate, device="cpu")
        np.testing.assert_array_equal(got.state.table.numpy(),
                                      want.state.table.numpy())
        assert got.cursor == 400 and got.step_cursor == 0

    def test_from_checkpoint_primes_the_live_lineage(self, tmp_path, capsys):
        data, _ = _csv_bytes(tmp_path, 200, seed=83)
        path = str(tmp_path / "h.csv")
        with open(path, "wb") as f:
            f.write(data)
        ck = str(tmp_path / "live.npz")
        rc, _ = self._run(["migrate", "--csv", path, "--device", "cpu",
                           "--checkpoint", ck, "--no-quality"], capsys)
        assert rc == 0
        rc, line = self._run(["migrate", "--csv", path, "--device", "cpu",
                              "--from-checkpoint", ck, "--players", "80"], capsys)
        assert rc == 0 and line["lineage_live_version"] == 2
        assert set(line["quality"]) == {"migrated", "live_pre_cutover"}
        assert line["phases"].keys() >= {"load", "migrate", "quality"}

    @pytest.mark.parametrize("argv", [
        ["--resume"], ["--checkpoint-every", "4"], ["--hot-rows", "-1"],
        ["--batch-size", "0"], ["--plan-windows", "0"],
        ["--checkpoint", "x.npz", "--stop-after-steps", "-2"],
    ])
    def test_bad_args_exit_2_as_jax(self, argv, tmp_path, capsys):
        from analyzer_tpu.cli import main as jmain

        from analyzer_tpu_torch import cli

        path = str(tmp_path / "none.csv")
        assert cli.main(["migrate", "--csv", path, "--device", "cpu", *argv]) == 2
        got = capsys.readouterr().err
        assert jmain(["migrate", "--csv", path, *argv]) == 2
        assert got == capsys.readouterr().err

    def test_without_a_card_exits_2(self, tmp_path, capsys):
        import torch

        from analyzer_tpu_torch import cli

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible: the default device would run")
        assert cli.main(["migrate", "--csv", str(tmp_path / "x.csv")]) == 2
        assert "--device cpu" in capsys.readouterr().err
