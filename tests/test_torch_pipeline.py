"""The port's pipelined service loop (``analyzer_tpu_torch.service.
pipeline``): equal to the port's sequential loop bit for bit, and its
host-side helpers equal to the JAX package's.

Worst-case overlap as in ``tests/test_pipeline.py``: a tiny player pool so
every consecutive batch pair shares players. Beyond the database dump, each
batch's final player table — the padding row included — is held equal
between the two loops: the chain patch scatters only its real pairs, so
the pad row stays the pinned fixed point ``core.update.scatter_rows_``
keeps (the JAX package lets padding pairs race on its garbage pad row).
"""

import sqlite3

import numpy as np
import pytest
import torch

from analyzer_tpu.service import pipeline as jax_pipeline
from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
from analyzer_tpu_torch.core.state import TABLE_WIDTH
from analyzer_tpu_torch.service import InMemoryBroker, InMemoryStore, SqlStore, Worker
from analyzer_tpu_torch.service import pipeline
from analyzer_tpu_torch.service.store import UncloneableStoreError
from tests.fakes import fake_items, fake_match, fake_participant, fake_player, fake_roster
from tests.test_sql_store import seed_db
from tests.test_torch_sql_store import assert_dumps_f32_equal, dump, synth_db


class TableRecorder(Worker):
    """A Worker that keeps every committed batch's final device table
    (what the serve plane would publish), in commit order."""

    def __init__(self, *a, **kw):
        super().__init__(*a, device="cpu", **kw)
        self.view_publisher = object()  # marker: the loops keep the tables
        self.tables: list = []

    def _publish_view(self, enc, table) -> None:
        self.tables.append(table.detach().cpu().numpy().copy())


def build_mem_store(n_matches: int, n_players: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    players = []
    for i in range(n_players):
        p = fake_player(skill_tier=int(rng.integers(1, 29)))
        p.api_id = f"p{i}"
        players.append(p)
    store = InMemoryStore()
    ids = []
    for m in range(n_matches):
        draw = rng.choice(n_players, size=6, replace=False)
        win = int(rng.integers(0, 2))
        rosters = []
        for t in range(2):
            parts = [
                fake_participant(
                    player=players[draw[t * 3 + s]], items=fake_items(),
                    skill_tier=players[draw[t * 3 + s]].skill_tier,
                )
                for s in range(3)
            ]
            rosters.append(fake_roster(winner=int(win == t), participants=parts))
        mid = f"m{m:05d}"
        match = fake_match("ranked", rosters, api_id=mid)
        match.created_at = m
        store.add_match(match)
        ids.append(mid)
    return store, ids


def consume_all(worker, broker, cfg, ids):
    for mid in ids:
        broker.publish(cfg.queue, mid.encode())
    for _ in range(max(3 * len(ids), 10)):
        if not worker.poll() and broker.qsize(cfg.queue) == 0:
            break
    worker.drain()
    worker.close()


def same_tables(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


def player_snapshot(store):
    return {
        pid: tuple(getattr(p, c, None) for c in (
            "trueskill_mu", "trueskill_sigma", "trueskill_ranked_mu",
            "trueskill_ranked_sigma"))
        for pid, p in store.players.items()
    }


class TestHelpers:
    def test_chain_pairs_equal_jax(self):
        rng = np.random.default_rng(1)
        chain = [(s, {f"p{i}": int(r) for r, i in enumerate(
            rng.choice(40, 12, replace=False))}) for s in range(5)]
        dst = {f"p{i}": r for r, i in enumerate(rng.choice(40, 20, replace=False))}
        for lag in (1, 2, 6):
            args = (chain[-lag:], lag, dst, 64, 81, np.int16)
            a, b = pipeline.chain_pairs(*args), jax_pipeline.chain_pairs(*args)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
            n = pipeline.n_real_pairs(a, 64)
            assert (a[2, :n] != 64).all() and (a[2, n:] == 64).all()
            assert len(set(a[2, :n].tolist())) == n  # unique destinations

    def test_choose_pipeline_lag_and_dtype_equal_jax(self):
        for rtt in (0.0, 1e-4, 0.01, 0.15, 3.0):
            for host in (0.0, 1e-3, 0.02, 0.5):
                assert (pipeline.choose_pipeline_lag(rtt, host)
                        == jax_pipeline.choose_pipeline_lag(rtt, host))
        for rows in (64, 32000, 32001):
            assert pipeline.pair_index_dtype(rows) == jax_pipeline.pair_index_dtype(rows)
        assert pipeline.DEFAULT_LAG == jax_pipeline.DEFAULT_LAG

    def test_patch_leaves_the_pad_row_alone(self):
        """Only the real pairs scatter: the destination's pad row keeps
        its bits even though the JAX layout points padding at it."""
        ring, pairs_buf, dtype = pipeline.chain_buffers(2, 9)
        ring_src = torch.arange(9 * TABLE_WIDTH, dtype=torch.float32).view(9, -1)
        pipeline.ring_put_(ring, 1, ring_src[:7])
        dst = torch.full((5, TABLE_WIDTH), float("nan"))
        dst[4] = -7.0  # the pad row
        pairs = pipeline.chain_pairs([(1, {"a": 2, "b": 5})], 2,
                                     {"a": 0, "b": 3, "c": 1}, 4, 9, dtype)
        n = pipeline.n_real_pairs(pairs, 4)
        assert n == 2 and pairs_buf.shape == (3, 9)
        pipeline._chain_patch_(dst, ring, torch.from_numpy(pairs[:, :n]))
        assert torch.equal(dst[4], torch.full((TABLE_WIDTH,), -7.0))
        assert torch.equal(dst[0, :14], ring_src[2, :14])
        assert torch.equal(dst[3, :14], ring_src[5, :14])
        assert torch.isnan(dst[0, 14:]).all() and torch.isnan(dst[1]).all()


class TestEquivalence:
    @pytest.mark.parametrize("lag", [1, 2, 6])
    def test_sqlite_columnar_lane(self, tmp_path, lag):
        def run(pipelined):
            path = str(tmp_path / f"pipe_{pipelined}.db")
            seed_db(path, n_matches=24)
            broker = InMemoryBroker()
            cfg = ServiceConfig(batch_size=4, idle_timeout=0.0, pipeline_lag=lag)
            w = TableRecorder(broker, SqlStore(f"sqlite:///{path}"), cfg,
                              RatingConfig(), pipeline=pipelined)
            consume_all(w, broker, cfg, [f"m{i}" for i in range(24)])
            assert broker.qsize(cfg.failed_queue) == 0 and not broker._unacked
            return dump(path), w.tables

        (da, ta), (db, tb) = run(False), run(True)
        assert_dumps_f32_equal(da, db)
        assert len(ta) == 6 and same_tables(ta, tb)

    @pytest.mark.parametrize("lag", [1, 2, 6])
    def test_sqlite_dbgen_history(self, tmp_path, lag):
        def run(pipelined):
            path = synth_db(str(tmp_path / f"h_{pipelined}.db"), n=160, p=24,
                            afk_rate=0.1, unsupported_rate=0.05)
            broker = InMemoryBroker()
            cfg = ServiceConfig(batch_size=20, idle_timeout=0.0, pipeline_lag=lag)
            w = TableRecorder(broker, SqlStore(f"sqlite:///{path}"), cfg,
                              RatingConfig(), pipeline=pipelined)
            consume_all(w, broker, cfg, [f"m{i:09d}" for i in range(160)])
            return dump(path), w.tables

        (da, ta), (db, tb) = run(False), run(True)
        assert_dumps_f32_equal(da, db)
        assert same_tables(ta, tb)

    @pytest.mark.parametrize("lag", [1, 2, 6])
    def test_mem_object_lane(self, lag):
        def run(pipelined):
            store, ids = build_mem_store(240, 18, seed=5)
            broker = InMemoryBroker()
            cfg = ServiceConfig(batch_size=24, idle_timeout=0.0, pipeline_lag=lag)
            w = TableRecorder(broker, store, cfg, RatingConfig(), pipeline=pipelined)
            consume_all(w, broker, cfg, ids)
            assert broker.qsize(cfg.failed_queue) == 0 and not broker._unacked
            return player_snapshot(store), w.tables

        (sa, ta), (sb, tb) = run(False), run(True)
        assert sa == sb and same_tables(ta, tb)

    def test_shared_player_chronology(self):
        """One player in consecutive single-match batches: each update
        builds on the previous one, through the chain patch."""
        def run(pipelined):
            store = InMemoryStore()
            shared = fake_player(skill_tier=15, api_id="shared")
            for i in range(4):
                others = [fake_player(skill_tier=15, api_id=f"o{i}{j}") for j in range(5)]
                parts = [fake_participant(player=p) for p in [shared] + others]
                m = fake_match("ranked", [fake_roster(True, parts[:3]),
                                          fake_roster(False, parts[3:])],
                               api_id=f"m{i}")
                m.created_at = i
                store.add_match(m)
            broker = InMemoryBroker()
            cfg = ServiceConfig(batch_size=1, idle_timeout=0.0, pipeline_lag=2)
            w = TableRecorder(broker, store, cfg, RatingConfig(), pipeline=pipelined)
            consume_all(w, broker, cfg, [f"m{i}" for i in range(4)])
            mus = [store.matches[f"m{i}"].rosters[0].participants[0].trueskill_mu
                   for i in range(4)]
            return mus, w.tables

        (ma, ta), (mb, tb) = run(False), run(True)
        assert ma == mb and same_tables(ta, tb)
        assert mb[0] > 1500 and all(b > a for a, b in zip(mb, mb[1:]))


class TestDegrade:
    def test_uncloneable_store_degrades_to_sequential(self, tmp_path):
        path = str(tmp_path / "seq.db")
        seed_db(path, n_matches=4)
        store = SqlStore(f"sqlite:///{path}")
        store.clone = lambda: (_ for _ in ()).throw(UncloneableStoreError("no"))
        broker = InMemoryBroker()
        cfg = ServiceConfig(batch_size=2, idle_timeout=0.0)
        w = Worker(broker, store, cfg, RatingConfig(), pipeline=True, device="cpu")
        consume_all(w, broker, cfg, [f"m{i}" for i in range(4)])
        assert w.pipeline_enabled is False and w.pipeline_degraded is True
        assert broker.prefetch == cfg.batch_size
        assert broker.qsize(cfg.failed_queue) == 0 and not broker._unacked

    def test_transient_clone_failure_retries(self, tmp_path):
        path = str(tmp_path / "transient.db")
        seed_db(path, n_matches=12)
        store = SqlStore(f"sqlite:///{path}")
        real_clone = store.clone
        fails = {"n": 1}

        def clone():
            if fails["n"]:
                fails["n"] -= 1
                raise OSError("transient DB outage")
            return real_clone()

        store.clone = clone
        broker = InMemoryBroker()
        t = [0.0]
        cfg = ServiceConfig(batch_size=4, idle_timeout=0.0)
        w = Worker(broker, store, cfg, RatingConfig(), clock=lambda: t[0],
                   pipeline=True, device="cpu")
        for i in range(12):
            broker.publish(cfg.queue, f"m{i}".encode())
        assert w.poll() and w.pipeline_enabled and w.pipeline_degraded
        assert w.pipeline_engine_failures == 1 and w._engine is None
        t[0] = 10.0
        assert w.poll() and w.poll()
        assert w._engine is not None and w.pipeline_degraded is False
        w.drain()
        w.close()
        assert broker.qsize(cfg.failed_queue) == 0 and not broker._unacked


class FlakyStore:
    """Delegating store whose Nth commit raises, shared across clones so
    the writer thread's commit trips it too (both commit surfaces)."""

    def __init__(self, inner, fail_on_commit: int, state=None):
        self._inner = inner
        self._state = state if state is not None else {"commits": 0}
        self._fail_on = fail_on_commit

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def clone(self):
        return FlakyStore(self._inner.clone(), self._fail_on, self._state)

    def _tick(self):
        self._state["commits"] += 1
        if self._state["commits"] == self._fail_on:
            raise RuntimeError("injected commit failure")

    def commit(self, matches):
        self._tick()
        return self._inner.commit(matches)

    def commit_columnar(self, plan):
        self._tick()
        return self._inner.commit_columnar(plan)


class TestFailures:
    def test_writer_death_midstream_degrades_without_stranding(self, tmp_path):
        n, bs = 24, 4

        def run(kill_after):
            path = str(tmp_path / f"dead_{kill_after}.db")
            seed_db(path, n_matches=n)
            broker = InMemoryBroker()
            cfg = ServiceConfig(batch_size=bs, idle_timeout=0.0)
            w = Worker(broker, SqlStore(f"sqlite:///{path}"), cfg, RatingConfig(),
                       pipeline=kill_after is not None, device="cpu")
            for i in range(n):
                broker.publish(cfg.queue, f"m{i}".encode())
            flushes = 0
            for _ in range(10 * n):
                if w.poll():
                    flushes += 1
                    if kill_after is not None and flushes == kill_after:
                        eng = w._engine
                        eng.writer.stop()
                        eng.writer.join(timeout=10)
                        assert not eng.writer.is_alive()
                if broker.qsize(cfg.queue) == 0 and not w.queue:
                    if w._engine is None or w._engine.idle:
                        break
            w.drain()
            w.close()
            assert not broker._unacked and broker.qsize(cfg.failed_queue) == 0
            return dump(path)

        assert_dumps_f32_equal(run(kill_after=2), run(kill_after=None))

    def test_failed_batch_does_not_taint_followers(self, tmp_path):
        n, bs = 24, 4

        def run(pipelined):
            path = str(tmp_path / f"flaky_{pipelined}.db")
            seed_db(path, n_matches=n)
            broker = InMemoryBroker()
            store = FlakyStore(SqlStore(f"sqlite:///{path}"), 3)
            cfg = ServiceConfig(batch_size=bs, idle_timeout=0.0)
            w = Worker(broker, store, cfg, RatingConfig(), pipeline=pipelined,
                       device="cpu")
            consume_all(w, broker, cfg, [f"m{i}" for i in range(n)])
            failed = sorted(m.body.decode() for m in broker.queues[cfg.failed_queue])
            assert not broker._unacked and w.batches_failed == 1
            return failed, dump(path)

        (fa, da), (fb, db) = run(False), run(True)
        assert fa == fb and len(fb) == bs
        assert_dumps_f32_equal(da, db)

    def test_poison_match_isolated_under_pipeline(self, tmp_path):
        n = 12

        def run(pipelined):
            path = str(tmp_path / f"poison_{pipelined}.db")
            seed_db(path, n_matches=n)
            conn = sqlite3.connect(path)
            conn.execute("DELETE FROM participant_items WHERE participant_api_id"
                         " LIKE 'm5-%'")
            conn.commit()
            conn.close()
            broker = InMemoryBroker()
            cfg = ServiceConfig(batch_size=4, idle_timeout=0.0)
            w = Worker(broker, SqlStore(f"sqlite:///{path}"), cfg, RatingConfig(),
                       pipeline=pipelined, device="cpu")
            consume_all(w, broker, cfg, [f"m{i}" for i in range(n)])
            assert [m.body.decode() for m in broker.queues[cfg.failed_queue]] == ["m5"]
            assert not broker._unacked
            return dump(path)

        assert_dumps_f32_equal(run(True), run(False))
