"""Traffic driver ``worker``: the service worker draining a backlog of
match ids, as the upstream ``worker.py`` consumes the ``analyze`` queue.

Configuration keys: ``players``, ``store_matches`` (the matches the store
holds: a rated history, then the backlog), ``activity_concentration``,
``max_activity_share``, ``afk_rate``, ``unsupported_rate``,
``structure_seed`` (the store's shape, the same for every seed),
``batch_size`` (``BATCHSIZE``), ``pipeline`` and ``pipeline_lag``
(``PIPELINE`` / ``PIPELINE_LAG``: null leaves the lag to the worker's
warm-up probe), ``chunk_size``.

Traffic keys: ``backlog_matches`` (the store's last matches, unrated, whose
ids are queued; a whole number of batches), ``warmup_batches`` (whole
batches flushed before the window, so the pipeline runs full when it
opens), ``refill_below`` and ``refill_matches`` (whenever fewer than
``refill_below`` ids are queued, the next ``refill_matches`` ids of the
backlog are published, from its start again once it is used up: the queue
never runs dry, whatever the worker's speed).

The store is a file-backed sqlite ``SqlStore`` (the worker turns on WAL)
built fresh under ``TMPDIR`` each run: the players, the history rated by
the plain reference (their ratings, and the history's rows as rated), and
the backlog. The broker is an ``InMemoryBroker`` that counts acks. The
window polls the worker as its consume loop does;
``worker_matches_per_s`` is the ids acked in the window over the window.

``correct``, after the window:

  * every id acked when the window closed was committed by then: no
    supported match among the acked ids of the backlog's first pass still
    has a NULL quality (a match queued again was rated before);
  * the acked ids are the ids published, in their order, and none was
    dead-lettered;
  * after the in-flight batches drain, the player table's ratings equal
    the plain reference rating every acked match in order from the
    ratings the store started with: no rating differs in being NULL, and
    the largest relative gap is under its limit.
"""

from __future__ import annotations

import os
import sqlite3
from collections import Counter
import tempfile
import time

import numpy as np
import torch

from portbench import dbfixture, gen, plain

LIMITS = {"null_mismatches": 0, "max_rel_err": 1e-4, "uncommitted_acked": 0,
          "dead_letters": 0, "acks_out_of_order": 0}


class Cell:
    def __init__(self, config, traffic, seed, device, log):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.log = seed, device, log
        self.setup_split = {}
        self.worker = self.store = None
        self.path = os.path.join(tempfile.gettempdir(),
                                 f"portbench_worker_{os.getpid()}.db")

    def setup(self) -> None:
        c, tr, dev = self.config, self.traffic, self.device
        self.backlog = tr["backlog_matches"]
        self.history = c["store_matches"] - self.backlog
        if self.backlog % c["batch_size"] or self.history < 0:
            raise ValueError("the backlog is a whole number of batches of the store")
        t = time.perf_counter()
        players = gen.make_players(c["players"], self.seed, dev)
        stream = gen.make_stream(
            c["store_matches"], players["latent"], self.seed,
            c["activity_concentration"], c["max_activity_share"],
            c["afk_rate"], c["unsupported_rate"], c["structure_seed"],
        )
        self.players = {k: v.cpu().numpy() for k, v in players.items()
                        if k != "latent"}
        for k in ("rank_points_ranked", "rank_points_blitz"):  # as the store holds them
            self.players[k] = dbfixture.stored_points(self.players[k])[1]
        del players
        self.stream = stream
        self.setup_split["generate_s"] = time.perf_counter() - t

        t = time.perf_counter()
        p, h = self.players, self.history
        start = plain.initial_table(c["players"], p["rank_points_ranked"],
                                    p["rank_points_blitz"], p["skill_tier"])
        rated = plain.rate_history(start, stream["player_idx"][:h],
                                   stream["winner"][:h], stream["mode_id"][:h],
                                   stream["afk"][:h], dev)
        ratings = rated[:-1, : 2 * plain.N_RATING_COLS]
        self.start = start
        self.start[:-1, : 2 * plain.N_RATING_COLS] = dbfixture.stored_ratings(ratings)[1]
        self.setup_split["history_s"] = time.perf_counter() - t

        t = time.perf_counter()
        dbfixture.build(self.path, stream, self.players, h, ratings)
        self.setup_split["db_build_s"] = time.perf_counter() - t

        t = time.perf_counter()
        from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
        from analyzer_tpu_torch.obs import get_tracer, reset_tracer
        from analyzer_tpu_torch.service import InMemoryBroker, SqlStore, Worker

        class CountingBroker(InMemoryBroker):
            """The configuration's broker, counting acks in order."""

            def __init__(self):
                super().__init__()
                self.acked: list[bytes] = []
                self._body_of = {}

            def get(self, queue, limit):
                got = super().get(queue, limit)
                for m in got:
                    self._body_of[m.delivery_tag] = m.body
                return got

            def ack(self, delivery_tag):
                super().ack(delivery_tag)
                body = self._body_of.pop(delivery_tag, None)
                if body is not None:
                    self.acked.append(body)

        self._get_tracer, self._reset_tracer = get_tracer, reset_tracer
        env = {
            "DATABASE_URI": f"sqlite:///{self.path}",
            "BATCHSIZE": str(c["batch_size"]),
            "CHUNKSIZE": str(c["chunk_size"]),
            "PIPELINE": "true" if c["pipeline"] else "false",
        }
        if c["pipeline_lag"] is not None:
            env["PIPELINE_LAG"] = str(c["pipeline_lag"])
        self.service = ServiceConfig.from_env(env)
        self.broker = CountingBroker()
        self.store = SqlStore(self.service.database_uri,
                              chunk_size=self.service.chunk_size)
        self.worker = Worker(self.broker, self.store, self.service,
                             RatingConfig.from_env({}), device=dev)
        self.setup_split["worker_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.worker.warmup()
        self.published = 0
        self._publish(self.backlog)
        flushes = 0
        while flushes < self.traffic["warmup_batches"]:
            flushes += bool(self.worker.poll())
        self._sync()
        self.setup_split["warmup_s"] = time.perf_counter() - t
        eng = self.worker._engine
        self.log(f"[choice] pipeline={self.worker.pipeline_enabled} "
                 f"lag={eng.lag if eng is not None else None} "
                 f"(pinned={c['pipeline_lag']}, probe rtt "
                 f"{self.worker.measured_rtt_s}, host {self.worker.measured_host_s}) "
                 f"batch={self.service.batch_size} store={c['store_matches']} "
                 f"backlog={self.backlog} "
                 f"warm-up batches={flushes}")

    def _publish(self, n: int) -> None:
        """Queues the next ``n`` ids of the backlog, from its start again
        once it is used up."""
        q, h, b = self.service.queue, self.history, self.backlog
        for j in range(self.published, self.published + n):
            self.broker.publish(q, dbfixture.match_id(h + j % b).encode())
        self.published += n

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_obs(self) -> None:
        self._reset_tracer()

    def tracer(self):
        return self._get_tracer()

    def window(self, seconds: float) -> dict:
        w, b, q = self.worker, self.broker, self.service.queue
        below, more = self.traffic["refill_below"], self.traffic["refill_matches"]
        a0, p0 = len(b.acked), self.published
        flushes = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if b.qsize(q) < below:
                self._publish(more)
            if w.poll():
                flushes += 1
        t1 = time.perf_counter()
        acked = len(b.acked) - a0
        self.acked_at_close = len(b.acked)
        self.uncommitted = self._uncommitted(min(self.acked_at_close, self.backlog))
        w.drain()
        self.log(f"[window] {flushes} batches flushed, {acked} ids acked in "
                 f"{t1 - t0:.3f} s; {self.published - p0} ids published in it; "
                 f"passes over the backlog {self.published / self.backlog:.3f}")
        return {
            "t0": t0, "t1": t1, "attempted": acked,
            "failed": b.qsize(self.service.failed_queue),
            "metrics": {"worker_matches_per_s": acked / (t1 - t0)},
            "raw": {"batches": flushes, "matches": acked},
        }

    def _uncommitted(self, k: int) -> int:
        """Supported matches among the first ``k`` ids of the backlog whose
        quality is still NULL in the database (a second, read-only
        connection)."""
        if k == 0:
            return 0
        conn = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)
        try:
            return conn.execute(
                "SELECT COUNT(*) FROM match WHERE api_id >= ? AND api_id < ?"
                " AND game_mode != ? AND trueskill_quality IS NULL",
                (dbfixture.match_id(self.history),
                 dbfixture.match_id(self.history + k), dbfixture.UNSUPPORTED_MODE),
            ).fetchone()[0]
        finally:
            conn.close()

    def sequence(self, k: int) -> np.ndarray:
        """The store's match numbers of the first ``k`` ids published."""
        return self.history + np.arange(k) % self.backlog

    def reference_table(self, k: int, dtype=torch.float32) -> np.ndarray:
        s, m = self.stream, self.sequence(k)
        return plain.rate_history(self.start, s["player_idx"][m], s["winner"][m],
                                  s["mode_id"][m], s["afk"][m], self.device,
                                  dtype=dtype)

    def check(self) -> list[dict]:
        b = self.broker
        k = len(b.acked)
        expect = [dbfixture.match_id(int(i)).encode() for i in self.sequence(k)]
        want, got = Counter(expect), Counter(b.acked)
        out_of_order = sum(((want - got) + (got - want)).values())
        self.close_worker()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        got = dbfixture.read_ratings(self.path, self.config["players"])
        self.ref = self.reference_table(k)[:-1, : 2 * plain.N_RATING_COLS]
        cmp = plain.compare_tables(got, self.ref)
        self.log(f"[check] {k} acked ids; reference in "
                 f"{time.perf_counter() - t:.3f} s; {cmp['entries']} ratings compared")
        vals = {"null_mismatches": cmp["null_mismatches"],
                "max_rel_err": cmp["max_rel_err"],
                "uncommitted_acked": self.uncommitted,
                "dead_letters": b.qsize(self.service.failed_queue),
                "acks_out_of_order": out_of_order}
        return [{"name": n, "value": vals[n], "limit": LIMITS[n],
                 "ok": vals[n] <= LIMITS[n]} for n in LIMITS]

    def control(self) -> dict:
        """The control's readings: the reference in bfloat16 put in the
        program's place (after :meth:`check`)."""
        low = self.reference_table(len(self.broker.acked), torch.bfloat16)
        return plain.compare_tables(low[:-1, : 2 * plain.N_RATING_COLS], self.ref)

    def close_worker(self) -> None:
        if self.worker is not None:
            self.worker.close()
            self.worker = None
        if self.store is not None:
            self.store.close()
            self.store = None

    def close(self) -> None:
        self.close_worker()
        for suffix in ("", "-wal", "-shm"):
            try:
                os.unlink(self.path + suffix)
            except FileNotFoundError:
                pass
