"""The port's serve plane (``analyzer_tpu_torch.serve``) against the JAX
package's and against its own oracle, on the CPU.

Every comparison here is EXACT (tolerance 0): the same numpy table, made
from a seed, goes through ``analyzer_tpu.serve`` and the port, and every
response dict must be equal — the device work of both engines is row
gathers, selects, comparisons and fixed-order float32 add chains, each a
correctly rounded IEEE operation, and the float64 host finish is the same
libm. The port's responses must also equal its oracle's
(``analyzer_tpu_torch.serve.oracle``) on ``view.host_table()``, and that
oracle the JAX package's.

Also here: a tie class that straddles the k-th place, patch-vs-rebuild
equality, view immutability (after later publishes and after the runner's
in-place scatter), a reader/publisher race, the HTTP status codes and
bodies against the JAX ``ServeServer``, and ``view_publisher=`` through both
runners, tiered and not, with the JAX package's version sequence.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from analyzer_tpu.config import RatingConfig as JaxConfig
from analyzer_tpu.core.state import PlayerState as JaxState
from analyzer_tpu.sched import pack_schedule as jax_pack, rate_history as jax_rate_history
from analyzer_tpu.sched import rate_stream as jax_rate_stream
from analyzer_tpu.serve import QueryEngine as JaxEngine, ViewPublisher as JaxPublisher
from analyzer_tpu.serve import oracle as jax_oracle
from analyzer_tpu.serve.server import ServeServer as JaxServer
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.core.update import scatter_rows_
from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
from analyzer_tpu_torch.obs import get_registry, reset_registry
from analyzer_tpu_torch.sched import pack_schedule, rate_history, rate_stream
from analyzer_tpu_torch.serve import (
    QueryEngine, ServePlane, UnknownPlayerError, ViewPublisher, oracle,
)
from analyzer_tpu_torch.serve.engine import (
    _conservative, _leaderboard, merge_topk_candidates, query_bucket,
)
from analyzer_tpu_torch.serve.server import ServeServer
from analyzer_tpu_torch.serve.view import (
    local_of_row, row_bucket, shard_of_row, shard_player_count,
)

CFG = RatingConfig()
JCFG = JaxConfig()


@pytest.fixture(autouse=True)
def fresh_registry():
    reset_registry()
    yield
    reset_registry()


def seeded_table(p=500, seed=0, ties=True) -> np.ndarray:
    """A ``[p+1, 16]`` packed table: ~70% of the rows rated, the rest NaN
    with baked seeds; with ``ties``, 30 rows sharing one (mu, sigma) near
    the top and 20 sharing another mid-table."""
    rng = np.random.default_rng(seed)
    t = np.full((p + 1, 16), np.nan, np.float32)
    t[:, 14] = rng.normal(1500, 200, p + 1)
    t[:, 15] = rng.uniform(300, 500, p + 1)
    rated = rng.random(p) < 0.7
    t[:p][rated, 0] = rng.normal(1500, 300, rated.sum())
    t[:p][rated, 7] = rng.uniform(50, 400, rated.sum())
    t[:p][rated, 1:7] = rng.normal(1500, 300, (rated.sum(), 6))
    t[:p][rated, 8:14] = rng.uniform(50, 400, (rated.sum(), 6))
    if ties:
        t[10:40, 0], t[10:40, 7] = 2600.0, 100.0
        t[200:220, 0], t[200:220, 7] = 1500.0, 200.0
    return t


def both_planes(table, ids=None, **engine_kw):
    jpub, tpub = JaxPublisher(), ViewPublisher(device="cpu")
    jview = jpub.publish_state(table, ids=ids)
    tview = tpub.publish_state(table, ids=ids)
    return (jpub, jview, JaxEngine(jpub, cfg=JCFG, **engine_kw)), (
        tpub, tview, QueryEngine(tpub, cfg=CFG, device="cpu", **engine_kw))


def http_get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


class TestAgainstTheJaxPlane:
    def test_view_host_tables_equal(self):
        table = seeded_table()
        (_, jview, _), (_, tview, _) = both_planes(table)
        assert np.array_equal(jview.host_table(), tview.host_table(), equal_nan=True)
        assert (jview.n_players, jview.pad_row, jview.version) == (
            tview.n_players, tview.pad_row, tview.version)
        assert tview.table.shape == (513, 16) and tview.table.dtype == torch.float32

    @pytest.mark.parametrize("k", [1, 5, 10, 29, 30, 31, 100, 349, 1000])
    def test_leaderboard_equal(self, k):
        (_, _, je), (_, _, te) = both_planes(seeded_table())
        assert te.leaderboard(k) == je.leaderboard(k)

    def test_tiers_and_percentiles_equal(self):
        table = seeded_table(seed=1)
        (_, _, je), (_, _, te) = both_planes(table)
        assert te.tier_histogram() == je.tier_histogram()
        exact = [float(table[10, 0] - 300.0), float(table[200, 0] - 600.0)]
        for s in [-5000.0, 0.0, 1300.0, 1e9, -1e9, 0.1] + exact:
            assert te.percentile(s) == je.percentile(s), s

    def test_custom_tier_edges_equal(self):
        edges = (-100.0, 500.0, 900.0, 2300.0)
        (_, _, je), (_, _, te) = both_planes(seeded_table(seed=2), tier_edges=edges)
        assert te.tier_histogram() == je.tier_histogram()

    def test_ratings_equal(self):
        rng = np.random.default_rng(3)
        (_, _, je), (_, _, te) = both_planes(seeded_table(seed=3))
        ids = [str(i) for i in rng.integers(0, 500, 40)] + ["9999", "x", "-1", "500"]
        assert te.get_ratings(ids) == je.get_ratings(ids)

    def test_winprob_equal(self):
        rng = np.random.default_rng(4)
        (_, _, je), (_, _, te) = both_planes(seeded_table(seed=4))
        for _ in range(60):
            a = [str(i) for i in rng.integers(0, 500, rng.integers(1, 6))]
            b = [str(i) for i in rng.integers(0, 500, rng.integers(1, 6))]
            assert te.win_probability(a, b) == je.win_probability(a, b)

    def test_id_mapped_plane_equal(self):
        table = seeded_table(p=90, seed=5)
        ids = [f"p{i}" for i in range(90)]
        (_, _, je), (_, _, te) = both_planes(table, ids=ids)
        assert te.leaderboard(50) == je.leaderboard(50)
        assert te.get_ratings(["p3", "ghost", "p89"]) == je.get_ratings(["p3", "ghost", "p89"])
        assert te.win_probability(["p10", "p11"], ["p12"]) == je.win_probability(
            ["p10", "p11"], ["p12"])

    def test_coalesced_tick_equal(self):
        """One tick with every kind queued, overflow included."""
        rng = np.random.default_rng(6)
        (_, _, je), (_, _, te) = both_planes(seeded_table(seed=6), max_batch=16)
        work = []
        for _ in range(40):
            rows = rng.choice(500, size=10, replace=False)
            work.append(("winprob", (tuple(str(r) for r in rows[:5]),
                                     tuple(str(r) for r in rows[5:]))))
        work += [("ratings", tuple(str(r) for r in rng.integers(0, 500, 30)))
                 for _ in range(9)]
        work += [("leaderboard", 7), ("leaderboard", 33), ("tiers", None)]
        work += [("percentile", float(v)) for v in rng.uniform(-2000, 3000, 20)]
        work.append(("winprob", (("1", "2", "3", "4", "5", "6"), ("7",))))  # too many
        work.append(("winprob", (("1",), ("nobody",))))
        results = []
        for engine in (je, te):
            reqs = [engine.submit(k, p) for k, p in work]
            served = []
            while any(not r.done.is_set() for r in reqs):
                served.append(engine.tick())
            results.append((served, [
                r.value if r.error is None else (type(r.error).__name__, str(r.error))
                for r in reqs]))
        assert results[0] == results[1]
        assert len(results[0][0]) > 1  # overflow took more than one tick

    def test_oracles_equal(self):
        table = seeded_table(seed=7)
        for k in (3, 40):
            assert oracle.leaderboard(table, 500, k) == jax_oracle.leaderboard(table, 500, k)
        edges = (-2000.0, 0.0, 900.0)
        assert oracle.tier_histogram(table, 500, edges) == jax_oracle.tier_histogram(
            table, 500, edges)
        assert oracle.percentile(table, 500, 777.0) == jax_oracle.percentile(table, 500, 777.0)
        assert oracle.win_probability(table, [1, 2], [3], CFG.beta2) == (
            jax_oracle.win_probability(table, [1, 2], [3], JCFG.beta2))
        assert oracle.quality(table, [1, 2], [3], CFG.beta2) == (
            jax_oracle.quality(table, [1, 2], [3], JCFG.beta2))

    def test_counters_and_occupancy_equal(self):
        from analyzer_tpu.obs import get_registry as jax_registry

        jreg = jax_registry()
        names = ("serve.queries_total", "serve.leaderboard_cache_hits_total",
                 "serve.tier_cache_hits_total", "serve.view_publishes_total")
        before = {n: jreg.counter(n).value for n in names}
        (_, _, je), (_, _, te) = both_planes(seeded_table(seed=8))
        for engine in (je, te):
            engine.leaderboard(10), engine.leaderboard(5), engine.leaderboard(64)
            engine.tier_histogram(), engine.tier_histogram()
            engine.get_ratings(["1", "2", "3"])
        reg = get_registry()
        for n in names:
            assert reg.counter(n).value == jreg.counter(n).value - before[n], n
        assert reg.histogram("serve.microbatch_occupancy", kind="ratings").summary()[
            "mean"] == 3 / 8
        ours, theirs = te.stats(), je.stats()
        assert set(ours) == set(theirs)
        for key in ("view_version", "queries_total"):  # view_age_s is a clock
            assert ours[key] == theirs[key], key


class TestAgainstTheOracle:
    def test_every_kind_bitexact(self):
        table = seeded_table(seed=11)
        pub = ViewPublisher(device="cpu")
        view = pub.publish_state(table)
        host = view.host_table()
        eng = QueryEngine(pub, cfg=CFG, device="cpu")
        for k in (1, 29, 30, 31, 1000):
            got = eng.leaderboard(k)["leaders"]
            want = oracle.leaderboard(host, view.n_players, k)
            assert [(int(e["id"]), e["conservative"]) for e in got] == [
                (r, float(s)) for r, s in want]
            assert [e["rank"] for e in got] == list(range(1, len(want) + 1))
        counts, rated = oracle.tier_histogram(host, view.n_players, eng.tier_edges)
        tiers = eng.tier_histogram()
        assert (tiers["counts"], tiers["rated"]) == (counts, rated)
        assert all(type(c) is int for c in tiers["counts"]) and type(tiers["rated"]) is int
        for s in (-3000.0, 100.0, float(host[10, 0] - 300.0), 5000.0, float("nan")):
            got = eng.percentile(s)
            assert (got["below"], got["rated"]) == oracle.percentile(
                host, view.n_players, s)
            assert type(got["below"]) is int
        rng = np.random.default_rng(11)
        for _ in range(40):
            na, nb = rng.integers(1, 6, 2)
            a = [int(r) for r in rng.integers(0, 500, na)]
            b = [int(r) for r in rng.integers(0, 500, nb)]
            got = eng.win_probability([str(r) for r in a], [str(r) for r in b])
            assert got["p_a"] == float(oracle.win_probability(host, a, b, CFG.beta2))
            assert got["quality"] == float(oracle.quality(host, a, b, CFG.beta2))
        e = eng.get_ratings(["10"])["ratings"][0]
        assert e["conservative"] == float(oracle.conservative_score(host, 10))

    def test_tie_class_straddling_k_orders_by_row(self):
        """30 rows tie for the top score and 20 tie mid-table: every cut
        through a tie class keeps the lower rows, as a stable sort does and
        an unordered top-k would not promise."""
        table = seeded_table(seed=12)
        scores = table[:500, 0] - 3 * table[:500, 7]
        assert np.nanmax(scores) == 2300.0
        pub = ViewPublisher(device="cpu")
        pub.publish_state(table)
        eng = QueryEngine(pub, cfg=CFG, device="cpu")
        for k in (1, 7, 29):
            assert [int(e["id"]) for e in eng.leaderboard(k)["leaders"]] == list(
                range(10, 10 + k))
        full = [int(e["id"]) for e in eng.leaderboard(1000)["leaders"]]
        at = full.index(200)
        assert full[at:at + 20] == list(range(200, 220))
        for k in (at + 1, at + 7, at + 19):
            assert [int(e["id"]) for e in eng.leaderboard(k)["leaders"]] == full[:k]
        # the device function on its own: scores descending, rows ascending
        vals, idx = _leaderboard(torch.from_numpy(table), 64)
        key = list(zip((-vals).tolist(), idx.tolist()))
        assert key == sorted(key)
        assert merge_topk_candidates(
            [(float(v), int(i), None) for v, i in zip(vals, idx)][::-1], 40
        ) == [(float(v), int(i), None) for v, i in zip(vals[:40], idx[:40])]

    def test_unrated_and_ghost_rows_never_lead(self):
        table = seeded_table(p=70, seed=13, ties=False)
        pub = ViewPublisher(device="cpu")
        view = pub.publish_state(table)
        eng = QueryEngine(pub, cfg=CFG, device="cpu")
        leaders = eng.leaderboard(1000)["leaders"]
        rated = int((~np.isnan(table[:70, 0])).sum())
        assert len(leaders) == rated < view.n_players
        assert all(not np.isnan(e["mu"]) for e in leaders)

    def test_conservative_has_no_multiply(self):
        rng = np.random.default_rng(14)
        mu = rng.normal(1500, 400, 4096).astype(np.float32)
        sg = rng.uniform(1, 900, 4096).astype(np.float32)
        got = _conservative(torch.from_numpy(mu), torch.from_numpy(sg)).numpy()
        want = np.array([np.float32(m - np.float32(np.float32(s + s) + s))
                         for m, s in zip(mu, sg)])
        assert np.array_equal(got, want)

    def test_query_bucket_ladder(self):
        assert [query_bucket(n, 256) for n in (0, 1, 8, 9, 200, 256, 999)] == [
            8, 8, 8, 16, 256, 256, 256]
        assert query_bucket(100, 4) == 8


class TestViews:
    def rows(self, n, seed):
        return seeded_table(p=n, seed=seed, ties=False)[:n]

    def test_patch_equals_rebuild_and_jax(self):
        ids = [f"p{i}" for i in range(60)]
        jpub, tpub = JaxPublisher(), ViewPublisher(device="cpu")
        for pub in (jpub, tpub):
            pub.publish_rows(ids, self.rows(60, 0))
            pub.publish_rows(["p10", "p11", "p12"], self.rows(60, 7)[10:13])
            pub.publish_rows(["new0", "p3", "new1"], self.rows(3, 8))
        jv, tv = jpub.current(), tpub.current()
        assert (jv.version, jv.n_players) == (tv.version, tv.n_players) == (3, 62)
        assert np.array_equal(jv.host_table(), tv.host_table(), equal_nan=True)
        # the patched device table equals the staging table (the would-be
        # full rebuild) bit for bit
        assert np.array_equal(tv.table.numpy(), tpub._staging[: tv.table.shape[0]],
                              equal_nan=True)
        assert tv.resolve("new1") == 61 and tv.id_of(60) == "new0"

    def test_duplicate_ids_in_one_publish_take_the_last_row(self):
        pub = ViewPublisher(device="cpu")
        pub.publish_rows(["a", "b"], self.rows(2, 1))
        rows = self.rows(3, 2)
        view = pub.publish_rows(["a", "b", "a"], rows)
        assert np.array_equal(view.host_table()[0], rows[2], equal_nan=True)
        assert np.array_equal(view.host_table()[1], rows[1], equal_nan=True)

    def test_views_are_immutable_after_later_publishes(self):
        ids = [f"p{i}" for i in range(60)]
        pub = ViewPublisher(device="cpu")
        v1 = pub.publish_rows(ids, self.rows(60, 0))
        before = v1.table.numpy().copy()
        v2 = pub.publish_rows(ids[:20], self.rows(20, 9))  # patch path
        v3 = pub.publish_rows([f"g{i}" for i in range(40)], self.rows(40, 4))  # rebuild
        assert v3.table.shape[0] == 129 and v1.table.shape[0] == 65
        assert np.array_equal(v1.table.numpy(), before, equal_nan=True)
        assert not np.array_equal(v2.table.numpy(), before, equal_nan=True)
        assert v1.resolve("g0") is None and v3.resolve("g39") == 99
        # no view aliases the staging buffer or another view
        ptrs = {v.table.data_ptr() for v in (v1, v2, v3)}
        assert len(ptrs) == 3 and pub._staging.ctypes.data not in ptrs

    def test_view_survives_the_runners_in_place_scatter(self):
        """``publish_state`` takes its own copy: the runner scatters into
        the very tensor it was handed right after."""
        state = PlayerState.from_numpy(
            seeded_table(p=40, seed=3, ties=False), np.zeros(41, np.float32),
            np.zeros(41, np.float32), np.zeros(41, np.int32), device="cpu")
        pub = ViewPublisher(device="cpu")
        view = pub.publish_state(state)
        before = view.host_table().copy()
        assert view.table.data_ptr() != state.table.data_ptr()
        idx = torch.arange(0, 10).reshape(1, 2, 5)
        scatter_rows_(state.table, state.pad_row, idx, torch.ones(1, 2, 5, dtype=torch.bool),
                      torch.ones(1, dtype=torch.bool), torch.full((1, 2, 5, 16), 5.0))
        state.table[20:, 0] = -1.0
        assert (state.table[:10] == 5.0).all()
        assert np.array_equal(view.table.numpy(), before, equal_nan=True)
        assert np.array_equal(view.host_table(), before, equal_nan=True)
        # a numpy table handed in is copied too
        arr = seeded_table(p=40, seed=4, ties=False)
        v2 = pub.publish_state(arr)
        kept = arr.copy()
        arr[:] = 0.0
        assert np.array_equal(v2.table.numpy()[:40], kept[:40], equal_nan=True)

    def test_identity_mode_and_validation(self):
        pub = ViewPublisher(device="cpu")
        view = pub.publish_state(PlayerState.create(10, cfg=CFG, device="cpu"))
        assert view.n_players == 10 and view.resolve("7") == 7
        assert view.resolve("11") is None and view.resolve("x") is None
        assert view.id_of(7) == "7"
        with pytest.raises(ValueError, match="table mode"):
            pub.publish_rows(["a"], self.rows(1, 1))
        with pytest.raises(ValueError):
            ViewPublisher(device="cpu").publish_rows(["a", "b"], np.zeros((1, 16), np.float32))
        with pytest.raises(ValueError):
            ViewPublisher(device="cpu").publish_state(np.zeros((5, 16), np.float32), ids=["a"])

    def test_state_patch_appends_within_bucket_and_rebuilds_across(self):
        jpub, tpub = JaxPublisher(), ViewPublisher(device="cpu")
        full = seeded_table(p=100, seed=5, ties=False)
        versions = []
        for pub in (jpub, tpub):
            pub.publish_state(full[:51])  # 50 players (+ pad row), bucket 64
            grown = np.concatenate([full[:60], full[-1:]])
            v2 = pub.publish_state_patch(
                np.arange(50, 60), full[50:60], 60,
                full_table=lambda: pytest.fail("an append inside the bucket patches"))
            v3 = pub.publish_state_patch(
                np.arange(60, 100), full[60:100], 100, full_table=lambda: full)
            versions.append((v2.n_players, v2.table.shape[0], v3.n_players,
                             v3.table.shape[0], v3.version))
            assert np.array_equal(np.asarray(v2.host_table())[:60], grown[:60], equal_nan=True)
        assert versions[0] == versions[1] == (60, 65, 100, 129, 3)
        assert np.array_equal(jpub.current().host_table(), tpub.current().host_table(),
                              equal_nan=True)

    def test_warm_patch_buckets_cutover_and_adopt(self):
        ids = [f"p{i}" for i in range(200)]
        seq = []
        for cls, kw in ((JaxPublisher, {}), (ViewPublisher, {"device": "cpu"})):
            live, staging, follower = cls(**kw), cls(**kw), cls(**kw)
            live.publish_rows(ids[:50], self.rows(50, 1))
            staging.publish_rows(ids, self.rows(200, 2))
            warm = staging.warm_patch_buckets(150)
            sview = staging.current()
            view = live.cutover_from(staging)
            assert view.table is sview.table  # by reference
            with pytest.raises(RuntimeError, match="retired"):
                staging.publish_rows(ids[:1], self.rows(1, 3))
            after = live.publish_rows(["p7"], self.rows(1, 4))
            assert follower.adopt_view(after) is True
            assert follower.adopt_view(after) is False
            with pytest.raises(ValueError, match="rewind"):
                follower.adopt_view(view)
            seq.append((warm, sview.version, view.version, after.version,
                        follower.version, after.n_players))
            seq.append(np.asarray(after.host_table()).tobytes())
        assert seq[0] == seq[2] == (3, 4, 2, 3, 3, 200)
        assert seq[1] == seq[3]

    def test_shard_helpers(self):
        from analyzer_tpu.serve import view as jax_view
        from analyzer_tpu.service.encode import row_bucket as jax_row_bucket

        for n in (0, 1, 63, 64, 65, 1000, 1_500_000):
            assert row_bucket(n) == jax_row_bucket(n)
        assert row_bucket(1_500_000) + 1 == 2_097_153
        for row in (0, 5, 17):
            for s in (1, 4):
                assert shard_of_row(row, s) == jax_view.shard_of_row(row, s)
                assert local_of_row(row, s) == jax_view.local_of_row(row, s)
        for n, sh, s in ((10, 3, 4), (7, 0, 4), (2, 3, 4)):
            assert shard_player_count(n, sh, s) == jax_view.shard_player_count(n, sh, s)

    def test_device_none_means_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible: nothing to refuse")
        with pytest.raises(RuntimeError, match="CUDA"):
            ViewPublisher()
        with pytest.raises(RuntimeError, match="CUDA"):
            QueryEngine(ViewPublisher(device="cpu"))
        # The shadow audit hook is ported: auditor= is kept, not refused.
        marker = object()
        engine = QueryEngine(ViewPublisher(device="cpu"), device="cpu",
                             auditor=marker)
        assert engine.auditor is marker


class TestCoalescing:
    def plane(self, **kw):
        pub = ViewPublisher(device="cpu")
        view = pub.publish_state(seeded_table(seed=21))
        return pub, view, QueryEngine(pub, cfg=CFG, device="cpu", **kw)

    def test_tick_coalesces_and_reports_one_version(self):
        pub, view, eng = self.plane()
        reqs = [eng.submit("ratings", (str(i),)) for i in range(5)]
        reqs += [eng.submit("winprob", (("1",), ("2",))) for _ in range(3)]
        assert eng.tick() == 8
        assert {r.result(0)["version"] for r in reqs} == {1}
        assert all(r.latency_s >= 0 for r in reqs)

    def test_unknown_id_fails_only_its_request(self):
        pub, view, eng = self.plane()
        good = eng.submit("winprob", (("1",), ("2",)))
        bad = eng.submit("winprob", (("1",), ("ghost",)))
        eng.tick()
        assert "p_a" in good.result(0)
        with pytest.raises(UnknownPlayerError, match="ghost"):
            bad.result(0)

    def test_overflow_defers_to_next_tick(self):
        pub, view, eng = self.plane(max_batch=4)
        reqs = [eng.submit("percentile", float(i)) for i in range(10)]
        assert [eng.tick(), eng.tick(), eng.tick(), eng.tick()] == [4, 4, 2, 0]
        assert all(r.done.is_set() for r in reqs)

    def test_version_keyed_caches(self):
        pub, view, eng = self.plane()
        reg = get_registry()
        eng.leaderboard(10), eng.leaderboard(3)
        assert reg.counter("serve.leaderboard_cache_hits_total").value == 1
        eng.percentile(1.0), eng.tier_histogram(), eng.tier_histogram()
        assert reg.counter("serve.tier_cache_hits_total").value == 1
        sorted_v1 = eng._score_cache[1]
        pub.publish_state(seeded_table(seed=22))
        assert eng.leaderboard(3)["version"] == 2
        assert reg.counter("serve.leaderboard_cache_hits_total").value == 1
        eng.percentile(1.0)
        assert eng._score_cache[0] == 2 and eng._score_cache[1] is not sorted_v1

    def test_no_view_fails_cleanly(self):
        eng = QueryEngine(ViewPublisher(device="cpu"), device="cpu")
        with pytest.raises(RuntimeError, match="no ratings view"):
            eng.leaderboard(3)
        with pytest.raises(ValueError, match="unknown query kind"):
            eng.submit("nope")

    def test_threaded_concurrent_callers_and_close(self):
        pub, view, eng = self.plane()
        eng.start()
        host = view.host_table()
        out, errors = [], []

        def caller(i):
            try:
                for j in range(20):
                    a, b = [str((i * 20 + j) % 500)], [str((i + j + 1) % 500)]
                    out.append((a, b, eng.win_probability(a, b)))
            except BaseException as e:  # noqa: BLE001 — re-raised by the test
                errors.append(e)

        threads = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and len(out) == 160
        for a, b, got in out:
            assert got["p_a"] == float(oracle.win_probability(
                host, [int(a[0])], [int(b[0])], CFG.beta2))
        assert isinstance(eng, ServePlane)
        assert eng.warmup() == 5
        eng.close()
        stranded = eng.submit("tiers")
        eng.start()
        eng.close()
        assert stranded.done.wait(5)


class TestReaderPublisherRace:
    def test_concurrent_publish_and_read(self):
        """Four readers against a writer that patches and rebuilds as fast
        as it can (at least 120 versions, and on until every reader has
        answers, however loaded the machine), with a short switch interval:
        each reader's versions only rise, and every response equals the
        oracle on the host table of the version it names — a torn or
        mutated view would not."""
        p = 300
        base = seeded_table(p=p, seed=31, ties=False)
        pub = ViewPublisher(device="cpu")
        views = {1: pub.publish_state(base)}
        eng = QueryEngine(pub, cfg=CFG, device="cpu").start()
        stop, errors = threading.Event(), []
        seen = [[] for _ in range(4)]
        rng = np.random.default_rng(31)

        def writer():
            deadline = time.monotonic() + 90
            try:
                i = 0
                while (i < 120 or min(len(s) for s in seen) < 4) and (
                        time.monotonic() < deadline):
                    idx = np.unique(rng.integers(0, p, 40))
                    rows = base[idx]
                    rows[:, 0] += np.float32(1.0)
                    base[idx] = rows
                    if i % 30 == 29:
                        v = pub.publish_state(base)
                    else:
                        v = pub.publish_state_patch(idx, rows, p, full_table=lambda: base)
                    views[v.version] = v
                    i += 1
            except BaseException as e:  # noqa: BLE001 — re-raised by the test
                errors.append(e)
            finally:
                stop.set()

        def reader(i):
            rrng = np.random.default_rng(100 + i)
            try:
                while not stop.is_set():
                    rows = [int(r) for r in rrng.choice(p, size=4, replace=False)]
                    a, b = [str(r) for r in rows[:2]], [str(r) for r in rows[2:]]
                    seen[i].append(("winprob", rows, eng.win_probability(a, b)))
                    seen[i].append(("leaderboard", 5, eng.leaderboard(5)))
            except BaseException as e:  # noqa: BLE001 — re-raised by the test
                errors.append(e)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=writer)] + [
                threading.Thread(target=reader, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
            eng.close()
        assert not errors, errors
        assert not any(t.is_alive() for t in threads)
        assert pub.version >= 121 and len(views) == pub.version
        n_checked = 0
        for mine in seen:
            vs = [r["version"] for _k, _p, r in mine]
            assert vs == sorted(vs) and vs
            for kind, payload, resp in mine:
                host = views[resp["version"]].host_table()
                if kind == "winprob":
                    assert resp["p_a"] == float(oracle.win_probability(
                        host, payload[:2], payload[2:], CFG.beta2))
                else:
                    want = oracle.leaderboard(host, p, 5)
                    assert [(int(e["id"]), e["conservative"]) for e in resp["leaders"]] == [
                        (r, float(s)) for r, s in want]
                n_checked += 1
        assert n_checked > 8


class TestServeServer:
    @pytest.fixture()
    def served(self):
        table = seeded_table(p=90, seed=41)
        ids = [f"p{i}" for i in range(90)]
        (jpub, jview, je), (tpub, tview, te) = both_planes(table, ids=ids)
        je.start(), te.start()
        jsrv, tsrv = JaxServer(je, port=0), ServeServer(te, port=0)
        yield jsrv, tsrv, tview
        for closer in (jsrv, tsrv, je, te):
            closer.close()

    @pytest.mark.parametrize("path", [
        "/healthz", "/v1/ratings?ids=p0,p1,ghost", "/v1/leaderboard?k=3",
        "/v1/leaderboard", "/v1/leaderboard?k=35", "/v1/winprob?a=p0,p1&b=p2",
        "/v1/tiers", "/v1/tiers?score=250", "/v1/tiers?score=-1e9",
        # errors
        "/v1/ratings", "/v1/ratings?ids=,,", "/v1/leaderboard?k=zero",
        "/v1/leaderboard?k=0", "/v1/leaderboard?k=10001", "/v1/winprob?a=p0",
        "/v1/winprob?a=p0&b=ghost", "/v1/winprob?a=p0,p1,p2,p3,p4,p5&b=p6",
        "/v1/tiers?score=high", "/nope",
    ])
    def test_status_and_body_equal_the_jax_server(self, served, path):
        jsrv, tsrv, _ = served

        def raw(url):
            try:
                with urllib.request.urlopen(url, timeout=10) as resp:
                    return resp.status, resp.headers["Content-Type"], resp.read()
            except urllib.error.HTTPError as err:
                return err.code, err.headers["Content-Type"], err.read()

        assert raw(tsrv.url + path) == raw(jsrv.url + path)

    def test_endpoints_against_the_oracle(self, served):
        _, srv, view = served
        host = view.host_table()
        code, body = http_get(srv.url + "/v1/leaderboard?k=3")
        assert code == 200
        assert [e["id"] for e in body["leaders"]] == [
            view.id_of(r) for r, _ in oracle.leaderboard(host, view.n_players, 3)]
        code, body = http_get(srv.url + "/v1/winprob?a=p0,p1&b=p2")
        assert code == 200 and np.float32(body["p_a"]) == oracle.win_probability(
            host, [0, 1], [2], CFG.beta2)
        code, body = http_get(srv.url + "/v1/tiers?score=250")
        below, rated = oracle.percentile(host, view.n_players, 250.0)
        assert code == 200 and (body["below"], body["rated"]) == (below, rated)

    def test_unpublished_view_is_503(self):
        eng = QueryEngine(ViewPublisher(device="cpu"), cfg=CFG, device="cpu").start()
        srv = ServeServer(eng, port=0)
        try:
            code, body = http_get(srv.url + "/v1/leaderboard")
            assert code == 503 and "no ratings view" in body["error"]
        finally:
            srv.close()
            eng.close()
        srv.close()  # idempotent

    def test_pooled_client_reuses_its_connection(self, served):
        from analyzer_tpu_torch.obs.httpd import PooledHTTPClient

        _, srv, _ = served
        client = PooledHTTPClient(srv.url)
        try:
            first = json.loads(client.get("/v1/leaderboard?k=2"))
            again = json.loads(client.get("/v1/leaderboard?k=2"))
            with pytest.raises(urllib.error.HTTPError) as ei:
                client.get("/v1/leaderboard?k=0")
            assert ei.value.code == 400 and first == again
            assert client.reuse_count == 2 and client.requests == 3
        finally:
            client.close()
        assert get_registry().counter("frontdoor.pool_reuse_total").value == 2


def _workload(seed=11, n_matches=300, n_players=60):
    players = synthetic_players(n_players, seed=seed)
    stream = synthetic_stream(n_matches, players, seed=seed)
    kw = dict(rank_points_ranked=players.rank_points_ranked,
              rank_points_blitz=players.rank_points_blitz,
              skill_tier=players.skill_tier)
    return stream, PlayerState.create(n_players, device="cpu", **kw), JaxState.create(
        n_players, **kw)


class _Recorder:
    """Wraps a publisher's ``_swap`` to record (version, host table)."""

    def __init__(self, pub):
        self.pub, self.versions = pub, []
        orig = pub._swap

        def swap(table, n):
            view = orig(table, n)
            self.versions.append((view.version, view.n_players,
                                  np.asarray(view.host_table()).copy()))
            return view

        pub._swap = swap


class TestSchedViewPublisher:
    """``view_publisher=`` through both runners, tiered and not: with an
    unthrottled publisher, one version per chunk plus the final one — the
    JAX package's sequence — and every untiered port view equal to the
    tiered one. (The float posteriors of the two packages agree within the
    tolerance of tests/test_torch_state_update.py, not bit for bit, so the
    tables are compared inside the port and the sequences across.)"""

    @pytest.mark.parametrize("runner", ["history", "stream"])
    @pytest.mark.parametrize("hot_rows", [0, 32])
    def test_version_sequence_equals_jax(self, runner, hot_rows):
        stream, state, jstate = _workload()
        rec = _Recorder(ViewPublisher(min_publish_interval_s=0.0, device="cpu"))
        jrec = _Recorder(JaxPublisher(min_publish_interval_s=0.0))
        if runner == "history":
            sched = pack_schedule(stream, pad_row=60, windowed=True)
            jsched = jax_pack(stream, pad_row=60, windowed=True)
            final, _ = rate_history(state, sched, CFG, steps_per_chunk=6,
                                    view_publisher=rec.pub, hot_rows=hot_rows)
            jax_rate_history(jstate, jsched, JCFG, steps_per_chunk=6,
                             view_publisher=jrec.pub, hot_rows=hot_rows)
        else:
            final, _ = rate_stream(state, stream, CFG, batch_size=8, steps_per_chunk=5,
                                   view_publisher=rec.pub, hot_rows=hot_rows)
            jax_rate_stream(jstate, stream, JCFG, batch_size=8, steps_per_chunk=5,
                            view_publisher=jrec.pub, hot_rows=hot_rows)
        assert [(v, n) for v, n, _ in rec.versions] == [(v, n) for v, n, _ in jrec.versions]
        assert len(rec.versions) > 3
        # the last view is the final table; NaN patterns agree with JAX's
        assert np.array_equal(rec.versions[-1][2][:60], final.table.numpy()[:60],
                              equal_nan=True)
        for (_, _, a), (_, _, b) in zip(rec.versions, jrec.versions):
            assert np.array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)

    def test_throttled_publisher_publishes_first_and_final(self):
        stream, state, _ = _workload()
        sched = pack_schedule(stream, pad_row=60, windowed=True)
        pub = ViewPublisher(min_publish_interval_s=3600.0, device="cpu")
        final, _ = rate_history(state, sched, CFG, steps_per_chunk=6, view_publisher=pub)
        assert pub.version == 2  # the first chunk's, then the unthrottled final one
        assert np.array_equal(pub.current().host_table()[:60], final.table.numpy()[:60],
                              equal_nan=True)
        eng = QueryEngine(pub, cfg=CFG, device="cpu")
        assert eng.leaderboard(3)["version"] == 2

    def test_publish_state_on_a_jax_table_carries_across(self):
        """State carried across: a table rated by the JAX package, handed
        over as numpy, serves from the port exactly as from JAX."""
        stream, _, jstate = _workload(seed=5)
        jfinal, _ = jax_rate_history(
            jstate, jax_pack(stream, pad_row=60, windowed=True), JCFG)
        table = np.asarray(jfinal.table)
        (_, jview, je), (_, tview, te) = both_planes(table)
        assert np.array_equal(jview.host_table(), tview.host_table(), equal_nan=True)
        assert te.leaderboard(20) == je.leaderboard(20)
        assert te.tier_histogram() == je.tier_histogram()
