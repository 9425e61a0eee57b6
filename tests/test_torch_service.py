"""The port's service shell (``analyzer_tpu_torch.service``) against the JAX
package's: the same object graphs and sqlite files through both Workers,
the broker traffic they produce, poison isolation, the redrive, the batch
encoders, the pika adapter, and the cli verbs ``synth``, ``rate --db``,
``serve --db`` and ``worker``.

Exact: broker traffic (acks, nacks, the failed queue, crunch, sew,
telesuck and topic publishes, in order), dead-lettered ids, every id,
integer, text and NULL written back, the stats key set, the encoders'
streams, row maps and player tables. Float posteriors are within the
tolerance of ``tests/test_torch_stream.py`` (rtol 2e-6, atol 2e-3; see
``tests/test_torch_sql_store.py`` for why). Both Workers run with
``slo_plane=False`` (an observer; ``tests/test_torch_slo_plane.py`` holds
the two planes against each other) and with the rating-quality ledger on
(``tests/test_torch_quality.py`` holds the two ledgers' counters). The device profiler
(``profile_dir``) is ported: ``TestDeviceProfilerWorker`` holds its
requests and capture windows to the JAX worker's.

The JAX package's ``TestCompileChurn`` has no counterpart here: it counts
XLA recompiles of the service scan, and nothing in the port is jitted, so
there is no retrace counter to hold (``TestNoCompiles`` says so and only
checks that batches of different sizes rate).
"""

import json
import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

from analyzer_tpu import cli as jax_cli
from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.config import ServiceConfig as JaxServiceConfig
from analyzer_tpu.service import InMemoryBroker as JaxInMemoryBroker
from analyzer_tpu.service import InMemoryStore as JaxInMemoryStore
from analyzer_tpu.service import SqlStore as JaxSqlStore
from analyzer_tpu.service import Worker as JaxWorker
from analyzer_tpu.service.columnar import ColumnarBatch as JaxColumnarBatch
from analyzer_tpu.service.encode import EncodedBatch as JaxEncodedBatch
from analyzer_tpu.service.worker import requeue_failed as jax_requeue_failed
from analyzer_tpu_torch import cli
from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
from analyzer_tpu_torch.service import InMemoryBroker, InMemoryStore, SqlStore, Worker
from analyzer_tpu_torch.service.columnar import ColumnarBatch
from analyzer_tpu_torch.service.encode import EncodedBatch, PoisonError
from analyzer_tpu_torch.service.worker import requeue_failed
from tests.fakes import fake_items, fake_match, fake_participant, fake_player, fake_roster
from tests.test_sql_store import seed_db
from tests.test_torch_sql_store import (
    RTOL, ATOL, assert_dumps_close, assert_dumps_f32_equal, dump, synth_db,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "port"
JAX = "jax"


class RecordingBroker:
    """Wraps a package's InMemoryBroker and logs every call the worker
    makes on it, so the two packages' traffic can be compared in order."""

    def __init__(self, inner):
        self.inner = inner
        self.log: list = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def publish(self, queue, body, headers=None):
        self.log.append(("publish", queue, body, dict(headers or {})))
        return self.inner.publish(queue, body, headers)

    def publish_topic(self, exchange, routing_key, body):
        self.log.append(("topic", exchange, routing_key, body))
        return self.inner.publish_topic(exchange, routing_key, body)

    def ack(self, tag):
        self.log.append(("ack", tag))
        return self.inner.ack(tag)

    def nack(self, tag, requeue=False):
        self.log.append(("nack", tag, requeue))
        return self.inner.nack(tag, requeue)


def make_worker(side, broker, store, cfg_kw, **kw):
    """A Worker of either package over ``broker``/``store``."""
    if side == PORT:
        return Worker(broker, store, ServiceConfig(**cfg_kw), RatingConfig(),
                      device="cpu", slo_plane=False, **kw)
    return JaxWorker(broker, store, JaxServiceConfig(**cfg_kw),
                     JaxRatingConfig(), slo_plane=False, quality=True, **kw)


def broker_of(side):
    return RecordingBroker(InMemoryBroker() if side == PORT else JaxInMemoryBroker())


def mk_match(api_id, created_at=0, mode="ranked", players=None, afk=False):
    def part(p):
        return fake_participant(player=p, went_afk=1 if afk else 0)

    players = players or [fake_player(skill_tier=15, api_id=f"{api_id}-p{i}")
                          for i in range(6)]
    m = fake_match(
        mode,
        [fake_roster(True, [part(p) for p in players[:3]]),
         fake_roster(False, [part(p) for p in players[3:]])],
        api_id=api_id,
    )
    m.created_at = created_at
    return m


def mem_history(store_cls, n_matches=60, n_players=14, seed=5):
    """A small shared player pool (consecutive batches overlap), mixed
    modes, an AFK and an unsupported match, some rank-point seeds."""
    rng = np.random.default_rng(seed)
    players = []
    for i in range(n_players):
        rp = float(rng.integers(800, 2600)) if i % 4 == 0 else None
        p = fake_player(skill_tier=int(rng.integers(-1, 30)), rank_points_ranked=rp)
        p.api_id = f"p{i}"
        players.append(p)
    store = store_cls()
    ids = []
    modes = ("ranked", "casual", "blitz_pvp_ranked", "ranked", "aral")
    for m in range(n_matches):
        draw = rng.choice(n_players, size=6, replace=False)
        win = int(rng.integers(0, 2))
        rosters = []
        for t in range(2):
            parts = [
                fake_participant(
                    player=players[draw[t * 3 + s]], items=fake_items(),
                    skill_tier=players[draw[t * 3 + s]].skill_tier,
                    went_afk=1 if (m == 7 and t == 0 and s == 0) else 0,
                )
                for s in range(3)
            ]
            rosters.append(fake_roster(winner=int(win == t), participants=parts))
        mid = f"m{m:04d}"
        match = fake_match(modes[m % len(modes)], rosters, api_id=mid)
        match.created_at = m
        store.add_match(match)
        if m % 9 == 0:
            store.add_asset(mid, f"https://telemetry/{mid}.json")
        ids.append(mid)
    return store, ids, players


def graph_values(store) -> list:
    """Every rating attribute of every object in a store, in a fixed order
    (None where unwritten)."""
    out = []
    for mid in sorted(store.matches):
        m = store.matches[mid]
        out.append(("q", mid, m.trueskill_quality))
        for p in m.participants:
            out.append(("part", mid, p.trueskill_mu, p.trueskill_sigma,
                        p.trueskill_delta))
            it = p.participant_items[0] if p.participant_items else None
            if it is not None:
                out.append(("items", mid, it.any_afk) + tuple(
                    getattr(it, f"{c}_{x}", None)
                    for c in ("trueskill_casual", "trueskill_ranked",
                              "trueskill_blitz", "trueskill_br")
                    for x in ("mu", "sigma")))
    for pid in sorted(store.players):
        p = store.players[pid]
        out.append(("player", pid) + tuple(
            getattr(p, k) for k in sorted(vars(p)) if k.endswith(("_mu", "_sigma"))))
    return out


def assert_values_close(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y) and x[:2] == y[:2]
        for u, v in zip(x[2:], y[2:]):
            if isinstance(u, float) and not isinstance(u, bool):
                assert isinstance(v, float), (x[:2], u, v)
                np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL,
                                           err_msg=str(x[:2]))
            else:
                assert u == v, (x[:2], u, v)


def run_mem(side, cfg_kw, publish, prepare=None, pipeline=False):
    store, ids, players = mem_history(
        InMemoryStore if side == PORT else JaxInMemoryStore)
    if prepare is not None:
        prepare(store)
    broker = broker_of(side)
    w = make_worker(side, broker, store, cfg_kw, pipeline=pipeline)
    for body, headers in publish(ids):
        broker.inner.publish("analyze", body, headers)
    for _ in range(10 * len(ids)):
        if not w.poll() and broker.qsize("analyze") == 0:
            break
    w.drain()
    w.close()
    return store, broker, w


FANOUT = dict(batch_size=16, idle_timeout=0.0, do_crunch_match=True,
              do_sew_match=True, do_telesuck_match=True)


def _publish_with_notify(ids):
    return [(mid.encode(), {"notify": f"web.{mid}"} if i % 5 == 0 else None)
            for i, mid in enumerate(ids)]


class TestWorkerParity:
    @pytest.mark.parametrize("pipeline", [False, True])
    def test_mem_store_equals_jax(self, pipeline):
        """Object lane: same graphs, same traffic, close posteriors."""
        ours = run_mem(PORT, FANOUT, _publish_with_notify, pipeline=pipeline)
        theirs = run_mem(JAX, FANOUT, _publish_with_notify, pipeline=False)
        assert ours[1].log == theirs[1].log
        assert ours[1].inner.topics == theirs[1].inner.topics
        assert_values_close(graph_values(ours[0]), graph_values(theirs[0]))
        assert ours[2].matches_rated == theirs[2].matches_rated == 60
        assert set(ours[2].stats()) == set(theirs[2].stats())

    @pytest.mark.parametrize("pipeline", [False, True])
    def test_sqlite_equals_jax(self, tmp_path, pipeline):
        """Columnar lane on a dbgen history: full dumps, traffic exact."""
        def run(side):
            path = synth_db(str(tmp_path / f"{side}.db"), n=120, p=40,
                            afk_rate=0.1, unsupported_rate=0.05)
            conn = sqlite3.connect(path)
            conn.executemany("INSERT INTO asset (match_api_id, url) VALUES (?, ?)",
                             [(f"m{i:09d}", f"https://t/{i}") for i in range(0, 120, 7)])
            conn.commit()
            conn.close()
            broker = broker_of(side)
            store = (SqlStore if side == PORT else JaxSqlStore)(f"sqlite:///{path}")
            w = make_worker(side, broker, store, FANOUT,
                            pipeline=pipeline if side == PORT else False)
            for i in range(120):
                broker.inner.publish("analyze", f"m{i:09d}".encode(),
                                     {"notify": "x"} if i % 11 == 0 else None)
            while w.poll():
                pass
            w.drain()
            w.close()
            return dump(path), broker, w

        (da, ba, wa), (db, bb, wb) = run(PORT), run(JAX)
        assert ba.log == bb.log and ba.inner.topics == bb.inner.topics
        assert wa.matches_rated == wb.matches_rated > 0
        assert_dumps_close(da, db)

    def test_recipe_5_constant(self, tmp_path):
        """The first-ever 3v3 winner's shared mu is 2052.41 (f32, default
        config), written to sqlite by the port's worker."""
        path = str(tmp_path / "one.db")
        seed_db(path, n_matches=1)
        broker = InMemoryBroker()
        w = make_worker(PORT, broker, SqlStore(f"sqlite:///{path}"),
                        dict(batch_size=8, idle_timeout=0.0))
        broker.publish("analyze", b"m0")
        assert w.poll()
        mu = sqlite3.connect(path).execute(
            "SELECT trueskill_mu FROM player WHERE api_id='p0'").fetchone()[0]
        assert round(float(np.float32(mu)), 2) == 2052.41

    def test_stats_keys_equal_jax(self):
        ours = make_worker(PORT, InMemoryBroker(), InMemoryStore(),
                           dict(batch_size=4, idle_timeout=0.0))
        theirs = make_worker(JAX, JaxInMemoryBroker(), JaxInMemoryStore(),
                             dict(batch_size=4, idle_timeout=0.0))
        s = ours.stats()
        assert set(s) == set(theirs.stats())
        assert s["slo"] is s["migration"] is s["fabric"] is None
        assert s["quality"] == theirs.stats()["quality"]
        assert set(s["quality"]) == {"matches_scored", "brier", "ece", "psi_mu"}


def _tie(store):
    for r in store.matches["m0003"].rosters:
        r.winner = True


def _oversize(store):
    m = store.matches["m0010"]
    extra = [fake_participant(player=fake_player(skill_tier=3, api_id=f"x{i}"))
             for i in range(3)]
    m.rosters[0].participants = list(m.rosters[0].participants) + extra
    m.participants = list(m.participants) + extra


def _no_items(store):
    store.matches["m0021"].participants[2].participant_items = []


def _bad_tier(store):
    p = fake_player(skill_tier=31, api_id="cursed")
    m = store.matches["m0030"]
    m.rosters[0].participants[0].player = [p]
    store.players["cursed"] = p


def _several(store):
    for f in (_tie, _oversize, _no_items, _bad_tier):
        f(store)


class TestPoisonParity:
    @pytest.mark.parametrize("prepare,bad", [
        (_tie, ["m0003"]),
        (_oversize, ["m0010"]),
        (_no_items, ["m0021"]),
        (_bad_tier, ["m0030"]),
        (_several, ["m0003", "m0010", "m0021", "m0030"]),
    ], ids=["winner_tie", "oversized_team", "missing_items", "bad_tier", "several"])
    @pytest.mark.parametrize("pipeline", [False, True])
    def test_same_dead_letters_and_traffic(self, prepare, bad, pipeline):
        cfg = dict(batch_size=16, idle_timeout=0.0)

        def pub(ids):
            return [(m.encode(), None) for m in ids]

        ours = run_mem(PORT, cfg, pub, prepare, pipeline=pipeline)
        theirs = run_mem(JAX, cfg, pub, prepare)
        failed = sorted(m.body.decode() for m in ours[1].inner.queues["analyze_failed"])
        assert failed == sorted(bad)
        assert ours[1].log == theirs[1].log
        assert not ours[1].inner._unacked
        assert_values_close(graph_values(ours[0]), graph_values(theirs[0]))
        assert ours[2].dead_letters == theirs[2].dead_letters == len(bad)
        assert ours[2].batches_failed == theirs[2].batches_failed == 0

    def test_poison_messages_equal_jax(self):
        """The encoders raise the same PoisonError family with the same
        offending ids and message."""
        from analyzer_tpu.service.encode import PoisonError as JaxPoisonError

        def err(side):
            store, ids, _ = mem_history(
                InMemoryStore if side == PORT else JaxInMemoryStore)
            _several(store)
            ms = store.load_batch(ids[:40])
            try:
                if side == PORT:
                    EncodedBatch(ms, RatingConfig(), device="cpu")
                else:
                    JaxEncodedBatch(ms, JaxRatingConfig())
            except (PoisonError, JaxPoisonError) as e:
                return type(e).__name__, e.api_ids, str(e)
            raise AssertionError("no poison raised")

        assert err(PORT) == err(JAX)

    def test_requeue_failed_equals_jax(self):
        def run(side):
            store, ids, _ = mem_history(
                InMemoryStore if side == PORT else JaxInMemoryStore)
            _tie(store)
            broker = broker_of(side)
            w = make_worker(side, broker, store, dict(batch_size=16, idle_timeout=0.0))
            for i, mid in enumerate(ids):
                broker.inner.publish("analyze", mid.encode(), {"notify": f"n{i}"})
            while w.poll():
                pass
            store.matches["m0003"].rosters[1].winner = False  # fixed
            fn = requeue_failed if side == PORT else jax_requeue_failed
            n = fn(broker, w.config, sleep=lambda s: None)
            while w.poll():
                pass
            return n, broker.log, graph_values(store)

        (na, la, va), (nb, lb, vb) = run(PORT), run(JAX)
        assert na == nb == 1 and la == lb
        assert_values_close(va, vb)

    def test_unattributable_error_fails_whole_batch(self):
        store, ids, _ = mem_history(InMemoryStore)
        store.load_batch = lambda ids: (_ for _ in ()).throw(RuntimeError("db down"))
        broker = InMemoryBroker()
        w = make_worker(PORT, broker, store, dict(batch_size=4, idle_timeout=0.0))
        for mid in ids[:4]:
            broker.publish("analyze", mid.encode())
        assert w.poll()
        assert w.batches_failed == 1 and broker.qsize("analyze_failed") == 4


class TestEncoders:
    def test_encoded_batch_equals_jax(self):
        store, ids, _ = mem_history(InMemoryStore)
        jstore, _, _ = mem_history(JaxInMemoryStore)
        a = EncodedBatch(store.load_batch(ids), RatingConfig(), bucket_rows=True,
                         device="cpu")
        b = JaxEncodedBatch(jstore.load_batch(ids), JaxRatingConfig(), bucket_rows=True)
        assert a.row_of == b.row_of
        assert a.state.table.numpy().tobytes() == np.asarray(b.state.table).tobytes()
        for f in ("player_idx", "winner", "mode_id", "afk"):
            assert getattr(a.stream, f).tobytes() == getattr(b.stream, f).tobytes()

    def test_columnar_batch_equals_jax(self, tmp_path):
        path = synth_db(str(tmp_path / "h.db"), n=80, p=30)
        ids = [f"m{i:09d}" for i in range(0, 80, 2)]
        raw = SqlStore(f"sqlite:///{path}").load_batch_native(ids)
        jraw = JaxSqlStore(f"sqlite:///{path}").load_batch_native(ids)
        a = ColumnarBatch(raw, RatingConfig(), bucket_rows=True, device="cpu")
        b = JaxColumnarBatch(jraw, JaxRatingConfig(), bucket_rows=True)
        assert a.row_of == b.row_of and a.api_ids == b.api_ids
        assert a.state.table.numpy().tobytes() == np.asarray(b.state.table).tobytes()
        for f in ("player_idx", "winner", "mode_id", "afk"):
            assert getattr(a.stream, f).tobytes() == getattr(b.stream, f).tobytes()

    def test_row_bucket_owned_by_encode(self):
        from analyzer_tpu.service.encode import row_bucket as jax_row_bucket
        from analyzer_tpu_torch.serve import view
        from analyzer_tpu_torch.service.encode import row_bucket

        assert view.row_bucket is row_bucket
        for n in (0, 1, 63, 64, 65, 5000, 5001):
            assert row_bucket(n) == jax_row_bucket(n)


class TestNoCompiles:
    def test_batches_of_different_sizes_rate(self):
        """The JAX package counts recompiles of its jitted service scan
        here (``TestCompileChurn``). The port runs eager PyTorch, so there
        is no compile cache to hold; two batches of different match and
        player counts just rate and ack."""
        broker = InMemoryBroker()
        store = InMemoryStore()
        w = make_worker(PORT, broker, store, dict(batch_size=500, idle_timeout=0.0))
        for i in range(5):
            store.add_match(mk_match(f"a{i}", created_at=i))
            broker.publish("analyze", f"a{i}".encode())
        assert w.poll()
        for i in range(3):
            store.add_match(mk_match(f"b{i}", created_at=10 + i))
            broker.publish("analyze", f"b{i}".encode())
        assert w.poll()
        assert w.matches_rated == 8 and not broker._unacked

    def test_warmup_probe_feeds_auto_lag(self):
        from analyzer_tpu_torch.config import PIPELINE_MAX_LAG, PIPELINE_MIN_LAG

        w = make_worker(PORT, InMemoryBroker(), InMemoryStore(),
                        dict(batch_size=8, idle_timeout=0.0), pipeline=True)
        w.warmup()
        assert w.measured_rtt_s is not None and w.measured_rtt_s > 0
        assert w.measured_host_s is not None and w.measured_host_s > 0
        assert PIPELINE_MIN_LAG <= w.resolved_pipeline_lag() <= PIPELINE_MAX_LAG
        s = w.stats()
        assert s["pipeline_enabled"] is True and s["matches_rated"] == 0


class TestRefusals:
    @pytest.mark.parametrize("kw,item", [
        (dict(obs_port=0), "obs_server"),
        (dict(flight_dir=True), "flight"),
        (dict(audit=True, serve_port=0), "auditor"),
        (dict(slo_plane=True), "watchdog"),
        (dict(serve_shards=2, serve_port=0), "query_engine"),
    ])
    def test_unported_planes_raise(self, kw, item, tmp_path):
        """No plane is refused any more: each live plane, and the sharded
        serve plane (``serve_shards=2``), builds its object and closes with
        the worker."""
        from analyzer_tpu_torch.obs import reset_flight_recorder
        from analyzer_tpu_torch.serve import ShardedQueryEngine

        if kw.get("flight_dir"):
            kw = dict(flight_dir=str(tmp_path))
        try:
            w = Worker(InMemoryBroker(), InMemoryStore(), ServiceConfig(),
                       device="cpu", **kw)
            try:
                assert getattr(w, item) is not None
                if "serve_shards" in kw:
                    assert isinstance(w.query_engine, ShardedQueryEngine)
            finally:
                w.close()
            assert w.obs_server is None and w.serve_server is None
        finally:
            reset_flight_recorder()

    def test_no_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible: device=None runs on it")
        from analyzer_tpu_torch.fixtures import synthetic_batch, synthetic_raw_batch

        with pytest.raises(RuntimeError, match="CUDA"):
            Worker(InMemoryBroker(), InMemoryStore(), ServiceConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            EncodedBatch(synthetic_batch(2), RatingConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            ColumnarBatch(synthetic_raw_batch(2), RatingConfig())

    @pytest.mark.parametrize("argv,item", [
        (("--obs-port", "0"), None),
        (("--flight-dir", "x"), None),
        (("--audit",), None),
        (("--serve-shards", "2"), None),
    ])
    def test_worker_flags_exit_2(self, capsys, monkeypatch, argv, item):
        """Every worker flag is ported — the live planes' and
        ``--serve-shards 2`` (the sharded serve plane): each reaches the
        consume loop, which then needs pika like any other worker run."""
        if item is None:
            monkeypatch.delenv("DATABASE_URI", raising=False)
            monkeypatch.setitem(sys.modules, "pika", None)
            with pytest.raises(ImportError):
                cli.main(["worker", *argv, "--device", "cpu"])
            return
        assert cli.main(["worker", *argv, "--device", "cpu"]) == 2
        err = capsys.readouterr().err
        assert item in err and err.startswith("error:")

    def test_worker_without_card_exits_2(self, capsys):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible: the default runs on it")
        assert cli.main(["worker"]) == 2
        assert "CUDA" in capsys.readouterr().err

    def test_worker_without_pika_raises(self, monkeypatch):
        monkeypatch.delenv("DATABASE_URI", raising=False)
        monkeypatch.setitem(sys.modules, "pika", None)
        with pytest.raises(ImportError):
            cli.main(["worker", "--device", "cpu"])

    def test_worker_profile_dir_is_accepted(self, monkeypatch, tmp_path):
        # No longer refused: the flag reaches the consume loop, which then
        # needs pika like any other worker run.
        monkeypatch.delenv("DATABASE_URI", raising=False)
        monkeypatch.setitem(sys.modules, "pika", None)
        with pytest.raises(ImportError):
            cli.main(["worker", "--profile-dir", str(tmp_path), "--device", "cpu"])

    @pytest.mark.parametrize("argv,text", [
        (("--db-write", "--csv", "x.csv"), "--db-write requires --db"),
        (("--db", "sqlite:///x.db", "--db-write", "--stop-after-steps", "2"),
         "--db-write requires a finished run"),
        (("--db", "sqlite:///x.db", "--csv", "x.csv"),
         "exactly one of --csv / --db is required"),
    ])
    def test_rate_db_flag_errors_equal_jax(self, capsys, argv, text):
        assert cli.main(["rate", *argv, "--device", "cpu"]) == 2
        ours = capsys.readouterr().err.strip()
        assert jax_cli.main(["rate", *argv]) == 2
        assert ours == capsys.readouterr().err.strip() and text in ours

    def test_rate_db_without_card_exits_2(self, tmp_path, capsys):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible: the default runs on it")
        path = synth_db(str(tmp_path / "h.db"), n=20, p=12)
        assert cli.main(["rate", "--db", f"sqlite:///{path}"]) == 2
        assert "CUDA" in capsys.readouterr().err


class TestDeviceProfilerWorker:
    """The worker's device profiler (obs/prof.py) against the JAX
    worker's: the same requests on the same events, and a capture window
    around the next batch's dispatch that ``cli profile`` parses."""

    @pytest.fixture(autouse=True)
    def fresh_profilers(self):
        from analyzer_tpu.obs import prof as jax_prof
        from analyzer_tpu_torch.obs import prof

        prof.reset_device_profiler()
        jax_prof.reset_device_profiler()
        yield
        prof.reset_device_profiler()
        jax_prof.reset_device_profiler()

    def test_profile_dir_arms_the_process_profiler(self, tmp_path):
        w = make_worker(PORT, InMemoryBroker(), InMemoryStore(),
                        dict(batch_size=8), profile_dir=str(tmp_path))
        assert w.profiler.armed and w.profiler.profile_dir == str(tmp_path)
        assert w.profiler.capture_info()["captures"] == 0
        w.close()

    @pytest.mark.parametrize("side", [PORT, JAX])
    def test_dead_letter_requests_capture(self, side, tmp_path):
        w = make_worker(side, broker_of(side), InMemoryStore() if side == PORT
                        else JaxInMemoryStore(), dict(batch_size=2,
                                                      idle_timeout=0.0),
                        profile_dir=str(tmp_path))
        w.broker.inner.publish("analyze", b"missing-match")
        w.queue = w.broker.inner.get("analyze", 2)
        w._dead_letter(w.queue)
        assert w.profiler._pending == "dead_letter"
        w._disable_pipeline("test")
        assert w.profiler._pending == "pipeline_degraded"
        w.close()

    def test_sigusr2_forces_a_request(self, tmp_path):
        w = make_worker(PORT, InMemoryBroker(), InMemoryStore(),
                        dict(batch_size=8))
        w._on_sigusr2()  # unarmed: ignored
        assert w.profiler._pending is None
        w.profiler.configure(profile_dir=str(tmp_path))
        w._on_sigusr2()
        assert w.profiler._pending == "sigusr2"
        w.close()

    @pytest.mark.parametrize("pipeline", [False, True])
    def test_requested_capture_wraps_the_next_batch(self, tmp_path, capsys,
                                                    pipeline):
        store, ids, _players = mem_history(InMemoryStore)
        broker = InMemoryBroker()
        w = make_worker(PORT, broker, store,
                        dict(batch_size=16, idle_timeout=0.0),
                        pipeline=pipeline, profile_dir=str(tmp_path))
        assert w.profiler.request("sigusr2", force=True)
        for mid in ids:
            broker.publish("analyze", mid.encode())
        for _ in range(10 * len(ids)):
            if not w.poll() and broker.qsize("analyze") == 0:
                break
        w.drain()
        w.close()
        assert w.matches_rated == len(ids)
        assert w.profiler.captures == 1  # the latch clears after one window
        cap = w.profiler.last_capture
        man = json.load(open(os.path.join(cap, "manifest.json")))
        assert man["reason"] == "sigusr2" and man["matches"] == 16
        assert man["device"] == {"platform": "cpu", "device_kind": ""}
        capsys.readouterr()
        assert cli.main(["profile", cap, "--json"]) == 0
        att = json.loads(capsys.readouterr().out)
        assert att["parsed"] is True and att["manifest"] == man
        assert att["trace_files"][0].startswith(os.path.join("plugins", "profile"))


    def test_bench_loop_asks_for_captures(self, tmp_path):
        from analyzer_tpu_torch.experiments.service_bench import run_loop

        store, ids, _players = mem_history(InMemoryStore)
        broker = InMemoryBroker()
        w = make_worker(PORT, broker, store, dict(batch_size=16, idle_timeout=0.0),
                        profile_dir=str(tmp_path))
        got = run_loop(w, broker, ids, "analyze", capture_at=(1,))
        w.close()
        assert w.matches_rated == len(ids) and got["batches"] > 2
        assert w.profiler.captures == 1 and "bench" in w.profiler.last_capture
        assert got["polls_from"] <= got["polls_to"]


class TestCausalTrace:
    """``obs/tracectx`` in the worker against the JAX worker's: with tracing
    on, the same batches assemble the same members, every stage of each
    batch's chain is present in both packages' exports, ``cli trace``
    reconstructs the port's export, and a device capture of one batch
    joins its host trace through the manifest's batch id."""

    @pytest.fixture(autouse=True)
    def tracing(self):
        from analyzer_tpu.obs import tracectx as jax_tracectx
        from analyzer_tpu.obs.tracer import reset_tracer as jax_reset_tracer
        from analyzer_tpu_torch.obs import prof, reset_tracer, tracectx

        for ctx in (tracectx, jax_tracectx):
            ctx.enable_tracing(True)
        reset_tracer()
        jax_reset_tracer()
        yield
        for ctx in (tracectx, jax_tracectx):
            ctx.enable_tracing(False)
        prof.reset_device_profiler()

    def _events(self, side, pipeline):
        from analyzer_tpu.obs import get_tracer as jax_get_tracer
        from analyzer_tpu_torch.obs import get_tracer

        run_mem(side, dict(batch_size=16, idle_timeout=0.0), _publish_with_notify,
                pipeline=pipeline)
        return (get_tracer() if side == PORT else jax_get_tracer()).events()

    @pytest.mark.parametrize("pipeline", [False, True])
    def test_batches_and_stages_equal_jax(self, pipeline):
        from analyzer_tpu.obs.traceview import build_model as jax_build_model
        from analyzer_tpu_torch.obs.traceview import batch_report, build_model

        port = build_model(self._events(PORT, pipeline))
        jax = jax_build_model(self._events(JAX, pipeline))
        assert len(port.batches) == len(jax.batches) > 1

        def members(model):
            return sorted(tuple(bt.members) for bt in model.batches.values())

        assert members(port) == members(jax)
        for bt in port.batches.values():
            stages = {k for k, v in batch_report(bt)["stages_ms"].items()
                      if v is not None}
            # encode, pack, dispatch, fetch, commit and the serve-less
            # publish lag (None): the chain of a batch, every thread's.
            assert {"encode", "pack", "dispatch", "commit"} <= stages
            if not pipeline:
                assert {"feed_staging", "h2d", "fetch"} <= stages

    def test_cli_trace_and_profile_join_the_worker_export(self, tmp_path, capsys):
        from analyzer_tpu_torch.obs import get_tracer, write_chrome_trace

        store, ids, _players = mem_history(InMemoryStore)
        broker = InMemoryBroker()
        w = make_worker(PORT, broker, store, dict(batch_size=16, idle_timeout=0.0),
                        profile_dir=str(tmp_path))
        for mid in ids:
            broker.publish("analyze", mid.encode())
        w.poll()  # first batch: no capture
        w.profiler.request("sigusr2", force=True)
        while w.poll():
            pass
        w.close()
        export = str(tmp_path / "worker.jsonl")
        assert write_chrome_trace(export, get_tracer()) > 0
        assert cli.main(["trace", export, "--json"]) == 0
        cp = json.loads(capsys.readouterr().out)
        assert cp["batches"] == w.batches_ok and cp["dominant_stage"]
        man = w.profiler.last_manifest
        assert man["batches"] and man["batches"][0].startswith("b")
        assert cli.main(["profile", w.profiler.last_capture, "--trace-events",
                         export, "--json"]) == 0
        d = json.loads(capsys.readouterr().out)["dispatch_decomposition"]
        # --trace-events loads as a forest: batch ids carry the file's label.
        assert d["scope"] == "manifest"
        assert d["batches"] == [f"worker:{b}" for b in man["batches"]]
        assert d["dispatch_ms"] > 0


class TestPikaAdapter:
    def test_traffic_equals_jax(self, monkeypatch):
        from analyzer_tpu.service.broker import make_pika_broker as jax_make
        from analyzer_tpu_torch.service.broker import make_pika_broker
        from tests.test_pika_adapter import make_stub_pika

        def drive(make):
            monkeypatch.setitem(sys.modules, "pika", make_stub_pika())
            b = make("amqp://guest@localhost", prefetch=3)
            b.declare_queue("analyze")
            for i in range(5):
                b.publish("analyze", f"m{i}".encode(),
                          headers={"notify": "n"} if i == 1 else None)
            got = b.get("analyze", 10)
            b.ack(got[0].delivery_tag)
            b.nack(got[1].delivery_tag, requeue=False)
            b.publish_topic("amq.topic", "n", b"analyze_update")
            more = b.get("analyze", 10)
            ch = b._ch
            return ([(m.body, m.headers, m.delivery_tag) for m in got + more],
                    ch.acked, ch.nacked, ch.topic_published, b.qsize("analyze"))

        assert drive(make_pika_broker) == drive(jax_make)

    def test_main_wires_pika_and_sql_store(self, tmp_path, monkeypatch):
        from tests.test_pika_adapter import make_stub_pika
        import analyzer_tpu_torch.service.broker as broker_mod
        from analyzer_tpu_torch.service.worker import main

        monkeypatch.setitem(sys.modules, "pika", make_stub_pika())
        db = str(tmp_path / "vg.db")
        seed_db(db, n_matches=1)
        monkeypatch.setenv("DATABASE_URI", f"sqlite:///{db}")
        monkeypatch.setenv("BATCHSIZE", "1")
        monkeypatch.setenv("IDLE_TIMEOUT", "0")
        orig = broker_mod.make_pika_broker

        def seeded(uri, **kw):
            b = orig(uri, **kw)
            b.publish("analyze", b"m0")
            return b

        monkeypatch.setattr(broker_mod, "make_pika_broker", seeded)
        worker = main(max_flushes=1, device="cpu")
        assert worker.matches_rated == 1
        mu = sqlite3.connect(db).execute(
            "SELECT trueskill_mu FROM player WHERE api_id='p0'").fetchone()[0]
        assert round(float(np.float32(mu)), 2) == 2052.41


def _cli_json(capsys, fn, argv) -> dict:
    assert fn(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


class TestCliDb:
    @pytest.mark.parametrize("ext", [".db", ".csv", ".npz"])
    def test_synth_equals_jax(self, tmp_path, capsys, ext):
        a, b = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
        argv = ["--matches", "150", "--players", "40", "--seed", "4",
                "--max-share", "0.05"]
        assert cli.main(["synth", *argv, "--out", a]) == 0
        ours = capsys.readouterr().out.replace(a, "OUT")
        assert jax_cli.main(["synth", *argv, "--out", b]) == 0
        assert ours == capsys.readouterr().out.replace(b, "OUT")
        if ext == ".db":
            assert (list(sqlite3.connect(a).iterdump())
                    == list(sqlite3.connect(b).iterdump()))
        elif ext == ".csv":
            assert open(a, "rb").read() == open(b, "rb").read()
        else:
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for f in za.files:
                assert za[f].dtype == zb[f].dtype
                assert za[f].tobytes() == zb[f].tobytes(), f

    @pytest.mark.parametrize("ext", [".npz", ".csv", ".db"])
    def test_synth_telemetry_equals_jax(self, tmp_path, capsys, ext):
        """``synth --telemetry`` (refused until the models were ported):
        the npz gains JAX's telemetry block byte for byte; any other
        output exits 2 with JAX's text and writes nothing."""
        a, b = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
        argv = ["synth", "--matches", "120", "--players", "30", "--seed", "6",
                "--telemetry"]
        rc = cli.main([*argv, "--out", a])
        ours = capsys.readouterr()
        assert rc == jax_cli.main([*argv, "--out", b])
        theirs = capsys.readouterr()
        assert ours.out.replace(a, "OUT") == theirs.out.replace(b, "OUT")
        assert ours.err == theirs.err
        if ext != ".npz":
            assert rc == 2 and not os.path.exists(a)
            assert "--telemetry requires an .npz output" in ours.err
            return
        za, zb = np.load(a), np.load(b)
        assert sorted(za.files) == sorted(zb.files) and "telemetry" in za.files
        for f in za.files:
            assert za[f].dtype == zb[f].dtype and za[f].shape == zb[f].shape
            assert za[f].tobytes() == zb[f].tobytes(), f

    @pytest.mark.parametrize("kernel", ["reference", "fused"])
    @pytest.mark.parametrize("packed", [False, True])
    def test_rate_db_write_equals_jax(self, tmp_path, capsys, kernel, packed):
        a = synth_db(str(tmp_path / "port.db"), n=150, p=45)
        b = synth_db(str(tmp_path / "jax.db"), n=150, p=45)
        extra = ["--checkpoint", str(tmp_path / "ck.npz")] if packed else []
        ours = _cli_json(capsys, cli.main, [
            "rate", "--db", f"sqlite:///{a}", "--db-write", "--kernel", kernel,
            "--device", "cpu", *extra])
        extra = ["--checkpoint", str(tmp_path / "jck.npz")] if packed else []
        theirs = _cli_json(capsys, jax_cli.main, [
            "rate", "--db", f"sqlite:///{b}", "--db-write", *extra])
        assert set(ours) == set(theirs)
        for k in ("matches", "players_rated", "players_written", "supersteps",
                  "occupancy"):
            assert ours[k] == theirs[k], k
        assert set(ours["phases"]) == set(theirs["phases"])
        assert_dumps_close(dump(a), dump(b))

    def test_rate_db_fused_equals_reference_bit_for_bit(self, tmp_path, capsys):
        a = synth_db(str(tmp_path / "ref.db"), n=300, p=70)
        b = synth_db(str(tmp_path / "fused.db"), n=300, p=70)
        for path, kernel in ((a, "reference"), (b, "fused")):
            _cli_json(capsys, cli.main, [
                "rate", "--db", f"sqlite:///{path}", "--db-write",
                "--kernel", kernel, "--device", "cpu"])
        assert_dumps_f32_equal(dump(a), dump(b))

    def test_worker_rows_equal_rate_db(self, tmp_path, capsys):
        """The port's version of ``tests/test_sql_store.py``'s object-
        vs-columnar end to end: the worker's committed player rows equal
        ``cli rate --db --db-write`` on a copy, under both kernels."""
        a = synth_db(str(tmp_path / "w.db"), n=96, p=30)
        broker = InMemoryBroker()
        w = make_worker(PORT, broker, SqlStore(f"sqlite:///{a}"),
                        dict(batch_size=500, idle_timeout=0.0))
        for i in range(96):
            broker.publish("analyze", f"m{i:09d}".encode())
        assert w.poll()
        w.close()
        want = dump(a)["player"]
        for kernel in ("reference", "fused"):
            b = synth_db(str(tmp_path / f"r_{kernel}.db"), n=96, p=30)
            _cli_json(capsys, cli.main, [
                "rate", "--db", f"sqlite:///{b}", "--db-write",
                "--kernel", kernel, "--device", "cpu"])
            assert_dumps_f32_equal({"player": want}, {"player": dump(b)["player"]})

    def test_serve_db_bodies_equal_jax(self, tmp_path, capsys):
        """``cli serve --db`` of both packages on one written database:
        every ``cli query`` body equal."""
        from tests.test_torch_cli import _serve_process, _stop

        path = synth_db(str(tmp_path / "h.db"), n=120, p=40)
        _cli_json(capsys, cli.main, ["rate", "--db", f"sqlite:///{path}",
                                     "--db-write", "--device", "cpu"])
        ids = ",".join(f"p{i:08d}" for i in (0, 3, 39)) + ",nobody"
        queries = [("ratings", "--ids", ids), ("leaderboard", "--k", "10"),
                   ("winprob", "--a", "p00000001,p00000002", "--b", "p00000005"),
                   ("tiers", "--score", "900")]
        bodies = {}
        for module in ("analyzer_tpu_torch.cli", "analyzer_tpu.cli"):
            extra = ("--device", "cpu") if "torch" in module else ()
            proc, info = _serve_process(module, "--db", f"sqlite:///{path}", *extra)
            try:
                assert info["players"] == 40 and info["source"].endswith("h.db")
                got = []
                for q in queries:
                    assert cli.main(["query", *q, "--url", info["serving"]]) == 0
                    got.append(json.loads(capsys.readouterr().out))
                bodies[module] = got
            finally:
                _stop(proc)
        assert bodies["analyzer_tpu_torch.cli"] == bodies["analyzer_tpu.cli"]
        rows = dict((r[0], r[1]) for r in sqlite3.connect(path).execute(
            "SELECT api_id, trueskill_mu FROM player"))
        served = bodies["analyzer_tpu_torch.cli"][0]
        assert served["unknown"] == ["nobody"] and len(served["ratings"]) == 3
        for entry in served["ratings"]:
            assert np.float32(entry["mu"]) == np.float32(rows[entry["id"]])

    def test_serve_db_without_card_exits_2(self, tmp_path, capsys):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible: the default serves from it")
        path = synth_db(str(tmp_path / "h.db"), n=20, p=12)
        assert cli.main(["serve", "--db", f"sqlite:///{path}"]) == 2
        captured = capsys.readouterr()
        assert "CUDA" in captured.err and captured.out == ""


class TestServiceBench:
    def test_sqlite_bench_runs_on_cpu(self, tmp_path):
        proc = subprocess.run(
            [sys.executable, "-m", "analyzer_tpu_torch.experiments.service_bench",
             "--store", "sqlite", "--matches", "600", "--device", "cpu",
             "--fixture-dir", str(tmp_path)],
            capture_output=True, text=True, timeout=300, cwd=_REPO,
        )
        assert proc.returncode == 0, proc.stderr
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        assert got["matches"] == 600 and got["dead_letters"] == 0
        assert got["device"] == "cpu" and got["lag"] >= 2
        assert got["slo_plane"] is True

    def test_sqlite_bench_without_the_slo_plane(self, tmp_path):
        proc = subprocess.run(
            [sys.executable, "-m", "analyzer_tpu_torch.experiments.service_bench",
             "--store", "sqlite", "--matches", "600", "--device", "cpu",
             "--no-pipeline", "--no-slo-plane", "--fixture-dir", str(tmp_path)],
            capture_output=True, text=True, timeout=300, cwd=_REPO,
        )
        assert proc.returncode == 0, proc.stderr
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        assert got["matches"] == 600 and got["dead_letters"] == 0
        assert got["slo_plane"] is False and got["pipeline"] is False
