"""The port's rating-quality ledger (``analyzer_tpu_torch.obs.quality``)
and the Worker's use of it, against the JAX package's.

Ledger against ledger (tolerance 0): the same host table and the same
batches through both packages' ``CalibrationLedger`` — the ``quality.*``
registry counters and gauges, ``summary()``, ``stats()``, ``retained()``,
``worst_bin()``, the drift snapshots, ``render_quality`` text and
``score_table`` are equal, since both score with the same numpy oracle
(``serve.oracle.win_probability``, a copy) on the same bits.

Worker against Worker: the same sqlite history through the port's
``Worker`` (the ledger on, its default) and the JAX package's
``Worker(slo_plane=False, quality=True)``, sequential. Batches after the
first score against priors the two packages rated with the float
tolerance of ``tests/test_torch_sql_store.py``, so a predicted probability
may move by ~1e-6: ``quality.matches_scored_total`` and every bin's count
are exact except that a match whose probability lies within ``EDGE`` of a
bin edge may fall in the neighbouring bin (each such match can change two
bins' counts by one); the Brier / log-loss and per-bin sums are within
``SUM_RTOL``. Inside the port the ledger is an observer: the database rows
and the broker traffic are bit-identical with it on and off.
"""

import json
import sqlite3

import numpy as np
import pytest

from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.config import ServiceConfig as JaxServiceConfig
from analyzer_tpu.obs import quality as jquality
from analyzer_tpu.obs import registry as jregistry
from analyzer_tpu.sched import MatchStream as JaxMatchStream
from analyzer_tpu.service import InMemoryBroker as JaxInMemoryBroker
from analyzer_tpu.service import SqlStore as JaxSqlStore
from analyzer_tpu.service import Worker as JaxWorker
from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
from analyzer_tpu_torch.obs import quality, registry
from analyzer_tpu_torch.sched import MatchStream
from analyzer_tpu_torch.service import InMemoryBroker, InMemoryStore, SqlStore, Worker
from tests.test_torch_sql_store import dump, synth_db

EDGE = 1e-6
SUM_RTOL = 1e-5


def _counters(snap) -> dict:
    return {k: v for k, v in snap["counters"].items() if k.startswith("quality.")}


def _gauges(snap) -> dict:
    return {k: v for k, v in snap["gauges"].items() if k.startswith("quality.")}


def _table(rng, rows: int) -> np.ndarray:
    """A host [rows+1, 16] prior table: ~60% rated rows (mu, sigma in the
    shared columns), the rest NaN with baked seeds; the last row pads."""
    t = np.full((rows + 1, 16), np.nan, np.float32)
    t[:, 14] = rng.uniform(1000, 2500, rows + 1)
    t[:, 15] = rng.uniform(300, 1000, rows + 1)
    rated = rng.random(rows + 1) < 0.6
    t[rated, 0] = rng.uniform(200, 3000, rated.sum())
    t[rated, 7] = rng.uniform(30, 900, rated.sum())
    return t


def _batch(rng, rows: int, n: int, pad_row: int):
    idx = np.stack([rng.permutation(rows)[:10] for _ in range(n)]).reshape(n, 2, 5)
    idx = idx.astype(np.int32)
    idx[rng.random((n, 2, 5)) < 0.15] = -1  # empty slots, as in a stream
    idx[:4, :, 3:] = pad_row  # padding as in a packed schedule
    idx[4, 1, :] = -1  # a one-sided match: not scored
    winner = rng.integers(0, 2, n).astype(np.int32)
    mode = rng.integers(-1, 6, n).astype(np.int32)
    afk = rng.random(n) < 0.1
    return idx, winner, mode, afk


@pytest.fixture
def registries():
    yield registry.reset_registry(), jregistry.reset_registry()
    registry.reset_registry()
    jregistry.reset_registry()


class TestLedgerEqualsJax:
    def test_counters_summary_text_and_drift(self, registries):
        rng = np.random.default_rng(11)
        rows = 300
        ours = quality.CalibrationLedger(RatingConfig())
        theirs = jquality.CalibrationLedger(JaxRatingConfig())
        for step in range(6):
            table = _table(rng, rows)
            args = (table, *_batch(rng, rows, 200, rows))
            assert ours.score_batch(*args, pad_row=rows) == \
                theirs.score_batch(*args, pad_row=rows) > 0
            if step % 2:
                ours.observe_population(table, now=1.5 * step)
                theirs.observe_population(table, now=1.5 * step)
        snap, jsnap = registries[0].snapshot(), registries[1].snapshot()
        assert _counters(snap) == _counters(jsnap)
        assert any("bin=" in k for k in _counters(snap))
        assert _gauges(snap) == _gauges(jsnap)
        assert ours.summary() == theirs.summary()
        assert ours.stats() == theirs.stats()
        assert ours.worst_bin() == theirs.worst_bin()
        for a, b in zip(ours.retained(), theirs.retained()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        s = ours.summary()
        s["temperature"] = {"t": 1.2, "nll_before": 0.7, "nll_after": 0.69, "n": 9}
        assert quality.render_quality(s) == jquality.render_quality(s)
        assert quality.render_quality({}) == jquality.render_quality({})
        assert quality.QUALITY_TABLE == jquality.QUALITY_TABLE

    def test_retention_is_bounded_and_ece_from_bins(self):
        assert quality.ece_from_bins([], [], 0) is None
        assert quality.ece_from_bins([1.0, 2.5], [0.0, 3.0], 4) == \
            jquality.ece_from_bins([1.0, 2.5], [0.0, 3.0], 4)
        rng = np.random.default_rng(2)
        ours = quality.CalibrationLedger(RatingConfig(), mirror=False)
        table = _table(rng, 50)
        idx = np.stack([rng.permutation(50)[:6] for _ in range(5000)])
        idx = idx.reshape(5000, 2, 3).astype(np.int32)
        n = ours.score_batch(table, idx, np.zeros(5000, np.int32),
                             np.zeros(5000, np.int32), np.zeros(5000, bool), 50)
        assert n == 5000
        assert ours.retained()[0].size == quality.QUALITY_TABLE["retain_max"]

    def test_score_table_equals_jax(self):
        rng = np.random.default_rng(5)
        table = _table(rng, 80)
        idx, winner, mode, afk = _batch(rng, 120, 300, 80)  # rows past the table
        stream = MatchStream(idx, winner, mode, afk)
        jstream = JaxMatchStream(idx, winner, mode, afk)
        got = quality.score_table(table, stream, RatingConfig())
        assert got == jquality.score_table(table, jstream, JaxRatingConfig())
        assert "drift" not in got and got["matches_scored"] > 0

    def test_process_ledger_registration(self):
        assert quality.get_quality_ledger() is None
        led = quality.CalibrationLedger(RatingConfig(), mirror=False)
        quality.set_quality_ledger(led)
        assert quality.get_quality_ledger() is led
        quality.reset_quality_ledger()
        assert quality.get_quality_ledger() is None


def _run_worker(side, path, n, batch_size, **kw):
    cfg = dict(batch_size=batch_size, idle_timeout=0.0)
    if side == "port":
        broker = InMemoryBroker()
        w = Worker(broker, SqlStore(f"sqlite:///{path}"), ServiceConfig(**cfg),
                   RatingConfig(), pipeline=False, device="cpu", **kw)
    else:
        broker = JaxInMemoryBroker()
        w = JaxWorker(broker, JaxSqlStore(f"sqlite:///{path}"),
                      JaxServiceConfig(**cfg), JaxRatingConfig(),
                      pipeline=False, slo_plane=False, **kw)
    for i in range(n):
        broker.publish("analyze", f"m{i:09d}".encode())
    while w.poll():
        pass
    stats = w.stats()
    ledger = w.quality
    w.close()
    return stats, ledger, broker


class TestWorker:
    def test_counters_equal_jax_worker(self, tmp_path, registries):
        n = 600
        paths = [synth_db(str(tmp_path / f"{s}.db"), n=n, p=150,
                          afk_rate=0.05, unsupported_rate=0.05)
                 for s in ("port", "jax")]
        stats, ledger, _ = _run_worker("port", paths[0], n, 100)
        jstats, jledger, _ = _run_worker("jax", paths[1], n, 100, quality=True)
        ours = _counters(registries[0].snapshot())
        theirs = _counters(registries[1].snapshot())
        scored = ours["quality.matches_scored_total"]
        assert scored == theirs["quality.matches_scored_total"] > 0
        assert stats["quality"]["matches_scored"] == scored == \
            jstats["quality"]["matches_scored"]
        # Bin counts: exact but for probabilities within EDGE of an edge.
        z = jledger.retained()[0]
        assert z.size == scored
        p = 1.0 / (1.0 + np.exp(-z))
        edges = np.arange(1, 10) / 10.0
        near = int((np.abs(p[:, None] - edges[None, :]) < EDGE).any(axis=1).sum())
        moved = sum(abs(ours.get(f"quality.bin_count{{bin={k}}}", 0)
                        - theirs.get(f"quality.bin_count{{bin={k}}}", 0))
                    for k in range(10))
        assert moved <= 2 * near, (moved, near)
        for k in range(10):
            c = f"quality.bin_count{{bin={k}}}"
            if ours.get(c, 0) != theirs.get(c, 0):
                continue
            for s in ("bin_p_sum", "bin_y_sum"):
                key = f"quality.{s}{{bin={k}}}"
                assert ours.get(key, 0) == pytest.approx(theirs.get(key, 0),
                                                         rel=SUM_RTOL, abs=1e-9)
        for s in ("brier_sum", "logloss_sum"):
            assert ours[f"quality.{s}"] == pytest.approx(theirs[f"quality.{s}"],
                                                         rel=SUM_RTOL)
        assert stats["quality"]["brier"] == pytest.approx(
            jstats["quality"]["brier"], abs=2e-6)
        assert quality.get_quality_ledger() is None  # close() released it

    def test_outputs_identical_with_ledger_on_and_off(self, tmp_path):
        n = 400
        on, off = (synth_db(str(tmp_path / f"{s}.db"), n=n, p=120,
                            afk_rate=0.05, unsupported_rate=0.05)
                   for s in ("on", "off"))
        s_on, led, b_on = _run_worker("port", on, n, 64)
        s_off, none, b_off = _run_worker("port", off, n, 64, quality=False)
        assert led is not None and none is None
        assert s_on["quality"]["matches_scored"] > 0 and s_off["quality"] is None
        assert dump(on) == dump(off)
        assert b_on.topics == b_off.topics
        for k in ("matches_rated", "batches_ok", "dead_letters"):
            assert s_on[k] == s_off[k]
        conn = sqlite3.connect(on)
        assert conn.execute("SELECT count(*) FROM player WHERE trueskill_mu "
                            "IS NOT NULL").fetchone()[0] > 0
        conn.close()

    def test_quality_is_on_by_default(self):
        w = Worker(InMemoryBroker(), InMemoryStore(), ServiceConfig(),
                   device="cpu")
        try:
            assert isinstance(w.quality, quality.CalibrationLedger)
            assert quality.get_quality_ledger() is w.quality
            assert w.stats()["quality"] == json.loads(json.dumps(
                w.quality.stats()))
        finally:
            w.close()
        assert quality.get_quality_ledger() is None
