"""The port's sharded serving plane (``ShardedViewPublisher``,
``ShardedQueryEngine``) against the port's single plane and the JAX
package's sharded plane, on the CPU.

Every comparison is EXACT (tolerance 0): the same seeded table goes through
the port's single plane, the port's sharded plane at S = 1, 2, 4, 8 and the
JAX package's ``ShardedQueryEngine``, and every response dict must be equal,
and equal to the port's oracle (``serve.oracle``) on the view's host table —
ties that cross shard boundaries, the stacked-sort top-k variant, unknown
ids and rolling publishes included. Also: the routing helpers against both
packages' mesh owner helpers, patch-equals-rebuild, no torn cross-shard read
under concurrent publishes, the mesh runner's chunk-boundary publishes and
final bit identity (``rate_history_sharded(view_publisher=)``), the shard
count mismatch refusal, a plain publisher getting the final table only, a
``Worker(serve_shards=2)`` serving over HTTP, ``cli serve --shards 2``
against ``--shards 1`` byte for byte, the shadow audit on a sharded view,
and the schema names.
"""

import json
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.serve import ShardedQueryEngine as JaxShardedEngine
from analyzer_tpu.serve import ShardedViewPublisher as JaxShardedPublisher
from analyzer_tpu.obs import reset_registry as jax_reset_registry
from analyzer_tpu.obs import get_registry as jax_get_registry
from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
from analyzer_tpu_torch.core.state import MU_LO, SIGMA_LO, PlayerState
from analyzer_tpu_torch.obs import get_registry, reset_registry
from analyzer_tpu_torch.serve import (
    QueryEngine,
    ServePlane,
    ShardedQueryEngine,
    ShardedRatingsView,
    ShardedViewPublisher,
    UnknownPlayerError,
    ViewPublisher,
    oracle,
)
from analyzer_tpu_torch.serve.server import ServeServer
from analyzer_tpu_torch.serve.view import (
    local_of_row,
    shard_of_row,
    shard_player_count,
)
from tests.test_serve import mk_match, rated_table
from tests.test_torch_cli import _REPO, _serve_process, _stop
from tests.test_torch_serve import http_get

CFG = RatingConfig()
JCFG = JaxRatingConfig()
CPU = "cpu"
SHARDS = [1, 2, 4, 8]


@pytest.fixture(autouse=True)
def fresh_registry():
    reset_registry()
    jax_reset_registry()
    yield
    reset_registry()
    jax_reset_registry()


def publish_all(n_players=60, n_rated=45, seed=0, n_shards=4, table=None):
    """The same rows published through the port's single plane, the port's
    sharded plane and the JAX package's sharded plane."""
    if table is None:
        table = rated_table(n_players, n_rated, seed)
    ids = [f"p{i}" for i in range(n_players)]
    pub1 = ViewPublisher(device=CPU)
    pubS = ShardedViewPublisher(n_shards, device=CPU)
    jpubS = JaxShardedPublisher(n_shards)
    v1 = pub1.publish_rows(ids, table)
    vS = pubS.publish_rows(ids, table)
    jpubS.publish_rows(ids, table)
    return pub1, pubS, jpubS, v1, vS, ids, table


def engines(pub1, pubS, jpubS, **kw):
    return (QueryEngine(pub1, cfg=CFG, device=CPU, **kw),
            ShardedQueryEngine(pubS, cfg=CFG, device=CPU, **kw),
            JaxShardedEngine(jpubS, cfg=JCFG, **kw))


def tied_table(n_players=40, seed=5) -> np.ndarray:
    """Exact score ties on rows owned by DIFFERENT shards (rows 3, 6, 9, 13
    -> shards 3, 2, 1, 1 at S=4): the merge's tie-break crosses shards."""
    table = rated_table(n_players, n_players, seed)
    for row in (3, 6, 9, 13):
        table[row, MU_LO] = np.float32(1987.5)
        table[row, SIGMA_LO] = np.float32(12.25)
    return table


class TestShardRouting:
    def test_matches_mesh_owner_helpers(self):
        from analyzer_tpu.parallel.mesh import _local_row as jlocal, _owner as jowner
        from analyzer_tpu_torch.parallel.mesh import _local_row, _owner

        rows = np.arange(1000, dtype=np.int64)
        for s in (1, 2, 3, 4, 8):
            np.testing.assert_array_equal(shard_of_row(rows, s), _owner(rows, s))
            np.testing.assert_array_equal(local_of_row(rows, s), _local_row(rows, s))
            np.testing.assert_array_equal(shard_of_row(rows, s), np.asarray(jowner(rows, s)))
            np.testing.assert_array_equal(local_of_row(rows, s), np.asarray(jlocal(rows, s)))

    def test_shard_player_count_partitions_exactly(self):
        for n in (0, 1, 7, 64, 100, 1001):
            for s in (1, 2, 4, 8):
                counts = [shard_player_count(n, d, s) for d in range(s)]
                assert sum(counts) == n
                for d in range(s):
                    assert counts[d] == sum(1 for r in range(n) if r % s == d)

    def test_locate_routes_by_ownership(self):
        *_, vS, _ids, _table = publish_all()
        for row in (0, 1, 7, 42, 59):
            assert vS.locate(f"p{row}") == (row % 4, row // 4)
        assert vS.locate("ghost") is None


class TestShardedViewPublisher:
    def test_one_version_spans_all_shards(self):
        _p1, pubS, _j, _v1, vS, ids, table = publish_all()
        assert vS.version == 1 and all(s.version == 1 for s in vS.shards)
        v2 = pubS.publish_rows(ids[:3], table[:3])
        assert v2.version == 2 and all(s.version == 2 for s in v2.shards)
        assert isinstance(v2, ShardedRatingsView)
        assert get_registry().gauge("serve.shards").value == 4

    @pytest.mark.parametrize("n_shards", SHARDS)
    def test_host_table_matches_single_plane_and_jax(self, n_shards):
        _p1, _pS, jpubS, v1, vS, _ids, _table = publish_all(n_shards=n_shards)
        np.testing.assert_array_equal(vS.host_table(), v1.host_table()[: v1.n_players])
        np.testing.assert_array_equal(vS.host_table(), jpubS.current().host_table())
        for shard, jshard in zip(vS.shards, jpubS.current().shards):
            assert shard.table.shape == tuple(jshard.table.shape)
            assert shard.n_players == jshard.n_players
            np.testing.assert_array_equal(shard.host_table(),
                                          np.asarray(jshard.table))

    def test_untouched_shards_carry_tables_forward(self):
        _p1, pubS, _j, _v1, vS, _ids, table = publish_all()
        mine = [i for i in range(60) if i % 4 == 0][:5]
        v2 = pubS.publish_rows([f"p{i}" for i in mine], table[mine])
        assert v2.shards[0].table is not vS.shards[0].table
        for d in (1, 2, 3):
            assert v2.shards[d].table is vS.shards[d].table  # zero transfer

    def test_shared_local_bucket_and_growth_rebuilds(self):
        pub1, pubS, _j, _v1, vS, _ids, _table = publish_all()
        assert all(s.table.shape[0] == 65 for s in vS.shards)
        extra = rated_table(200, 200, seed=8)
        eids = [f"x{i}" for i in range(200)]
        v2 = pubS.publish_rows(eids, extra)
        assert all(s.table.shape[0] == 129 for s in v2.shards)
        pub1.publish_rows(eids, extra)
        np.testing.assert_array_equal(v2.host_table(), pub1.current().host_table()[:260])
        assert all(s.table.shape[0] == 65 for s in vS.shards)  # old version frozen

    def test_mode_and_shape_validation(self):
        pub = ShardedViewPublisher(4, device=CPU)
        pub.publish_state(PlayerState.create(10, cfg=CFG, device=CPU))
        with pytest.raises(ValueError, match="table mode"):
            pub.publish_rows(["a"], rated_table(1, 1))
        with pytest.raises(ValueError):
            ShardedViewPublisher(0, device=CPU)
        with pytest.raises(ValueError):
            ShardedViewPublisher(4, device=CPU).publish_rows(
                ["a", "b"], np.zeros((1, 16), np.float32))
        with pytest.raises(ValueError, match="3 shard patches for a 4-shard"):
            pub.publish_shard_patches([(np.empty(0, np.int64), None)] * 3, 10, None)

    def test_publish_state_splits_by_interleaved_ownership(self):
        table = rated_table(30, 22, seed=3)
        state = PlayerState.create(30, cfg=CFG, device=CPU)
        state.table[:30] = torch.from_numpy(table)
        vS = ShardedViewPublisher(4, device=CPU).publish_state(state)
        for d, shard in enumerate(vS.shards):
            expect = table[d::4]
            np.testing.assert_array_equal(shard.host_table()[: expect.shape[0]], expect)
        np.testing.assert_array_equal(vS.host_table(), table)
        assert vS.id_of(7) == "7" and vS.resolve("7") == 7 and vS.resolve("x") is None

    def test_publish_shard_patches_patch_equals_rebuild(self):
        table = rated_table(60, 60, seed=2)
        pubS = ShardedViewPublisher(4, device=CPU)
        empty = [(np.empty(0, np.int64), np.empty((0, 16), np.float32))] * 4
        v1 = pubS.publish_shard_patches(empty, 60, lambda: [table[d::4] for d in range(4)])
        np.testing.assert_array_equal(v1.host_table(), table)
        table2 = table.copy()
        table2[[5, 9, 17], MU_LO] += np.float32(3.0)
        patches = []
        for d in range(4):
            rows_idx = np.asarray([r // 4 for r in (5, 9, 17) if r % 4 == d], np.int64)
            patches.append((rows_idx, table2[d::4][rows_idx]))
        v2 = pubS.publish_shard_patches(patches, 60, lambda: 1 / 0)
        rebuilt = ShardedViewPublisher(4, device=CPU).publish_shard_patches(
            empty, 60, lambda: [table2[d::4] for d in range(4)])
        assert v2.version == 2
        np.testing.assert_array_equal(v2.host_table(), table2)
        for a, b in zip(v2.shards, rebuilt.shards):
            assert torch.equal(a.table.isnan(), b.table.isnan())
            assert torch.equal(a.table.nan_to_num(), b.table.nan_to_num())
        np.testing.assert_array_equal(v1.host_table(), table)  # v1 froze

    def test_shard_patch_transfer_bytes_are_per_shard_rows(self):
        """Only the touched rows cross, at their real lengths (the single
        plane's rule): two shards patched, two carried forward free."""
        table = rated_table(60, 60, seed=2)
        pubS = ShardedViewPublisher(4, device=CPU)
        pubS.publish_shard_patches(
            [(np.empty(0, np.int64), np.empty((0, 16), np.float32))] * 4, 60,
            lambda: [table[d::4] for d in range(4)])
        counter = get_registry().counter("serve.view_publish_bytes_total")
        before = counter.value
        patches = [((np.asarray([0, 1], np.int64) if d < 2 else np.empty(0, np.int64)),)
                   for d in range(4)]
        patches = [(idx, table[d::4][idx]) for d, (idx,) in enumerate(patches)]
        pubS.publish_shard_patches(patches, 60, lambda: 1 / 0)
        assert counter.value - before == 2 * (2 * 8 + 2 * 16 * 4)

    def test_torn_read_absence_under_concurrent_publishes(self):
        """mu encodes the version on every row: a view mixing shard tables
        of two publishes would decode two versions."""
        n = 48
        ids = [f"p{i}" for i in range(n)]
        base = PlayerState.create(n, cfg=CFG, device=CPU).table.numpy()[:n].copy()
        pubS = ShardedViewPublisher(4, device=CPU)

        def rows_for(v: int) -> np.ndarray:
            rows = base.copy()
            rows[:, MU_LO] = np.float32(1000.0 * v) + np.arange(n, dtype=np.float32)
            rows[:, SIGMA_LO] = np.float32(50.0)
            return rows

        pubS.publish_rows(ids, rows_for(1))
        stop = threading.Event()
        failures: list = []

        def writer():
            for v in range(2, 30):
                pubS.publish_rows(ids, rows_for(v))
            stop.set()

        def reader():
            try:
                while not stop.is_set():
                    view = pubS.current()
                    v = view.version
                    for d, shard in enumerate(view.shards):
                        host = shard.host_table()
                        for j in range(shard.n_players):
                            assert float(host[j, MU_LO]) == 1000.0 * v + (j * 4 + d)
            except BaseException as err:  # noqa: BLE001 — surfaced below
                failures.append(err)

        readers = [threading.Thread(target=reader) for _ in range(3)]
        wt = threading.Thread(target=writer)
        for t in readers:
            t.start()
        wt.start()
        wt.join(timeout=60)
        stop.set()
        for t in readers:
            t.join(timeout=60)
        assert not failures, failures[0]
        assert pubS.version == 29

    def test_warm_patch_buckets_parity_with_single_plane_and_jax(self):
        pub1, pubS, jpubS, *_ = publish_all()
        n1, nS, nJ = (p.warm_patch_buckets(512) for p in (pub1, pubS, jpubS))
        assert n1 == nS == nJ > 0
        assert pub1.version == pubS.version == jpubS.version

    def test_cutover_from_adopts_all_shards_by_reference(self):
        _p1, live, _j, *_ = publish_all()
        staging = ShardedViewPublisher(4, device=CPU)
        sv = staging.publish_rows(["a", "b"], rated_table(2, 2, seed=4))
        v = live.cutover_from(staging)
        assert v.version == 2 and all(
            a.table is b.table for a, b in zip(v.shards, sv.shards))
        with pytest.raises(RuntimeError, match="retired"):
            staging.publish_rows(["a"], rated_table(1, 1))
        with pytest.raises(ValueError, match="cannot cut over a 2-shard"):
            live.cutover_from(ShardedViewPublisher(2, device=CPU))

    def test_devices_list_places_shards(self):
        pubS = ShardedViewPublisher(3, devices=[CPU, torch.device("cpu")])
        v = pubS.publish_rows([f"p{i}" for i in range(9)], rated_table(9, 9))
        assert [s.table.device.type for s in v.shards] == ["cpu"] * 3
        assert pubS.device_of(2) == torch.device("cpu")


class TestShardedEngineParity:
    @pytest.mark.parametrize("n_shards", SHARDS)
    def test_every_query_kind_bit_identical(self, n_shards):
        pub1, pubS, jpubS, _v1, vS, _ids, _table = publish_all(n_shards=n_shards)
        e1, eS, eJ = engines(pub1, pubS, jpubS)
        host = vS.host_table()
        ids = ["p2", "p50", "ghost"]
        assert eS.get_ratings(ids) == e1.get_ratings(ids) == eJ.get_ratings(ids)
        rng = np.random.default_rng(7)
        for _ in range(10):
            na, nb = rng.integers(1, 6), rng.integers(1, 6)
            picks = rng.choice(60, na + nb, replace=False)
            a = [f"p{i}" for i in picks[:na]]
            b = [f"p{i}" for i in picks[na:]]
            rS = eS.win_probability(a, b)
            assert rS == e1.win_probability(a, b) == eJ.win_probability(a, b)
            rows_a, rows_b = [int(i) for i in picks[:na]], [int(i) for i in picks[na:]]
            assert np.float32(rS["p_a"]) == oracle.win_probability(host, rows_a, rows_b, CFG.beta2)
            assert np.float32(rS["quality"]) == oracle.quality(host, rows_a, rows_b, CFG.beta2)
        for k in (1, 5, 44, 45, 60):
            lS = eS.leaderboard(k)
            assert lS == e1.leaderboard(k) == eJ.leaderboard(k)
            exp = oracle.leaderboard(host, vS.n_players, k)
            assert [e["id"] for e in lS["leaders"]] == [f"p{r}" for r, _ in exp]
            for lead, (row, score) in zip(lS["leaders"], exp):
                assert np.float32(lead["conservative"]) == score
                assert np.float32(lead["mu"]) == np.float32(host[row, MU_LO])
        tS = eS.tier_histogram()
        assert tS == e1.tier_histogram() == eJ.tier_histogram()
        counts, rated = oracle.tier_histogram(host, 60, eS.tier_edges)
        assert tS["counts"] == counts and tS["rated"] == rated
        for score in (-3000.0, 0.0, 612.25, 5000.0):
            pS = eS.percentile(score)
            assert pS == e1.percentile(score) == eJ.percentile(score)
            below, rated = oracle.percentile(host, 60, score)
            assert pS["below"] == below and pS["rated"] == rated

    @pytest.mark.parametrize("all_gather_topk", [False, True])
    def test_cross_shard_tie_break_matches_single_plane_and_oracle(self, all_gather_topk):
        table = tied_table()
        pub1, pubS, jpubS, _v1, vS, _ids, _t = publish_all(n_players=40, n_rated=40,
                                                           table=table)
        e1, eS, eJ = engines(pub1, pubS, jpubS)
        eS.all_gather_topk = all_gather_topk
        lS = eS.leaderboard(40)
        assert lS == e1.leaderboard(40) == eJ.leaderboard(40)
        tied = [e["id"] for e in lS["leaders"] if e["id"] in ("p3", "p6", "p9", "p13")]
        assert tied == ["p3", "p6", "p9", "p13"]
        exp = oracle.leaderboard(vS.host_table(), 40, 40)
        assert [e["id"] for e in lS["leaders"]] == [f"p{r}" for r, _ in exp]

    @pytest.mark.parametrize("n_shards", [2, 4, 8])
    def test_all_gather_topk_variant_bit_identical(self, n_shards):
        table = tied_table()
        pub1, pubS, jpubS, *_ = publish_all(n_players=40, n_rated=40, table=table,
                                            n_shards=n_shards)
        e1 = QueryEngine(pub1, cfg=CFG, device=CPU)
        eAG = ShardedQueryEngine(pubS, cfg=CFG, device=CPU, all_gather_topk=True)
        jAG = JaxShardedEngine(jpubS, cfg=JCFG, all_gather_topk=True)
        for k in (1, 7, 40):
            assert eAG.leaderboard(k) == e1.leaderboard(k) == jAG.leaderboard(k)

    def test_unknown_ids_and_errors_match(self):
        pub1, pubS, jpubS, *_ = publish_all()
        e1, eS, eJ = engines(pub1, pubS, jpubS)
        for eng in (eS, e1):
            with pytest.raises(UnknownPlayerError, match="ghost"):
                eng.win_probability(["p0"], ["ghost"])
            with pytest.raises(ValueError, match="teams must have"):
                eng.win_probability([], ["p1"])
        assert eS.get_ratings(["ghost"]) == e1.get_ratings(["ghost"]) == eJ.get_ratings(["ghost"])

    def test_rolling_publishes_keep_parity(self):
        pub1, pubS, jpubS, _v1, _vS, _ids, table = publish_all()
        e1, eS, eJ = engines(pub1, pubS, jpubS)
        rng = np.random.default_rng(3)
        for step in range(6):
            picks = rng.choice(60, 9, replace=False)
            upd = table[picks].copy()
            upd[:, MU_LO] += np.float32(step + 1)
            pids = [f"p{i}" for i in picks]
            for pub in (pub1, pubS, jpubS):
                pub.publish_rows(pids, upd)
            assert pub1.version == pubS.version == jpubS.version
            assert eS.leaderboard(10) == e1.leaderboard(10) == eJ.leaderboard(10)
            assert eS.get_ratings(pids[:4]) == e1.get_ratings(pids[:4])
            assert eS.tier_histogram() == e1.tier_histogram() == eJ.tier_histogram()
            assert eS.percentile(1500.0) == e1.percentile(1500.0)

    def test_coalesced_tick_bit_identical(self):
        pub1, pubS, jpubS, *_ = publish_all(n_shards=8)
        e1, eS, _eJ = engines(pub1, pubS, jpubS, max_batch=32)
        reqs = {}
        for eng in (e1, eS):
            reqs[eng] = [eng.submit("winprob", (("p0", "p1"), ("p2",))) for _ in range(17)]
            reqs[eng] += [eng.submit("ratings", tuple(f"p{i}" for i in range(40))),
                          eng.submit("percentile", 100.0),
                          eng.submit("leaderboard", 12), eng.submit("tiers")]
            while eng.tick():
                pass
        assert [r.result(timeout=0) for r in reqs[eS]] == [
            r.result(timeout=0) for r in reqs[e1]]

    def test_both_engines_satisfy_serve_plane(self):
        pub1, pubS, jpubS, *_ = publish_all()
        e1, eS, _eJ = engines(pub1, pubS, jpubS)
        assert isinstance(e1, ServePlane) and isinstance(eS, ServePlane)

    def test_warmup_walks_every_shard(self):
        pub1, pubS, jpubS, *_ = publish_all(n_shards=4)
        _e1, eS, _eJ = engines(pub1, pubS, jpubS)
        assert eS.warmup() == 4 * 2 + 2 * 4
        eS.all_gather_topk = True
        assert eS.warmup() == 4 * 2 + 2 * 4 + 1
        assert get_registry().gauge("serve.shards").value == 4

    def test_per_shard_query_counters_equal_jax(self):
        pub1, pubS, jpubS, *_ = publish_all(n_shards=4)
        _e1, eS, eJ = engines(pub1, pubS, jpubS)
        for eng in (eS, eJ):
            eng.get_ratings([f"p{i}" for i in range(8)])
            eng.leaderboard(5)
            eng.tier_histogram()
        reg, jreg = get_registry(), jax_get_registry()
        for d in range(4):
            # 2 ids, 1 top-k, the leaders' routed rows (5 rows over 4
            # shards: each owns one or two), 1 tier count.
            assert reg.counter("serve.shard.queries_total", shard=str(d)).value == \
                jreg.counter("serve.shard.queries_total", shard=str(d)).value >= 4
        for name in ("serve.shard.merges_total", "serve.shard.merge_candidates_total"):
            assert reg.counter(name).value == jreg.counter(name).value > 0, name

    def test_shadow_audit_replays_sharded_responses(self):
        from analyzer_tpu_torch.obs.audit import ShadowAuditor

        pub1, pubS, jpubS, *_ = publish_all()
        auditor = ShadowAuditor(cfg=CFG, sample_denom=1)
        eS = ShardedQueryEngine(pubS, cfg=CFG, device=CPU, auditor=auditor)
        eS.get_ratings(["p1", "p9"])
        eS.win_probability(["p0", "p1"], ["p2"])
        eS.leaderboard(10)
        eS.tier_histogram()
        eS.percentile(250.0)
        auditor.drain()
        assert auditor.checked == 5 and auditor.mismatch_count == 0


class TestShardedServeServer:
    def test_http_plane_is_topology_blind(self):
        pub1, pubS, jpubS, *_ = publish_all()
        e1, eS, _eJ = engines(pub1, pubS, jpubS)
        e1.start()
        eS.start()
        s1, sS = ServeServer(e1, port=0), ServeServer(eS, port=0)
        try:
            for path in ("/v1/ratings?ids=p0,p1,ghost", "/v1/leaderboard?k=5",
                         "/v1/winprob?a=p0,p1&b=p2", "/v1/tiers?score=250",
                         "/v1/winprob?a=p0&b=ghost"):
                assert http_get(s1.url + path) == http_get(sS.url + path), path
        finally:
            for x in (s1, sS, e1, eS):
                x.close()

    def test_cli_serve_shards_equals_single(self, tmp_path):
        """``cli serve --shards 2`` (and ``--all-gather-topk``) over a
        checkpoint answers every ``/v1/*`` kind with ``--shards 1``'s
        bytes."""
        import urllib.request

        from analyzer_tpu_torch.io.checkpoint import save_checkpoint

        state = PlayerState.create(60, cfg=CFG, device=CPU)
        state.table[:60] = torch.from_numpy(tied_table(60))
        ck = str(tmp_path / "ck.npz")
        save_checkpoint(ck, state, cursor=0)
        bodies = []
        for extra in ((), ("--shards", "2"), ("--shards", "4", "--all-gather-topk")):
            proc, info = _serve_process("analyzer_tpu_torch.cli", "--checkpoint", ck,
                                        "--device", CPU, *extra)
            try:
                assert info["shards"] == (int(extra[1]) if extra else 1)
                out = []
                for path in ("/v1/ratings?ids=1,2,3,999", "/v1/leaderboard?k=7",
                             "/v1/winprob?a=1,2&b=3,4,5", "/v1/tiers",
                             "/v1/tiers?score=-250.5"):
                    with urllib.request.urlopen(info["serving"] + path, timeout=10) as r:
                        out.append(r.read())
                bodies.append(out)
            finally:
                _stop(proc)
        assert bodies[0] == bodies[1] == bodies[2]


class TestWorkerShardedIntegration:
    def _feed(self, broker, store, prefix: str, n=4, t0=0):
        for i in range(n):
            mid = f"{prefix}{i}"
            store.add_match(mk_match(mid, created_at=t0 + i))
            broker.publish("analyze", mid.encode())

    def test_worker_serves_through_the_sharded_plane(self):
        from analyzer_tpu_torch.service import InMemoryBroker, InMemoryStore, Worker

        broker, store = InMemoryBroker(), InMemoryStore()
        cfg = ServiceConfig(batch_size=4, idle_timeout=0.0)
        worker = Worker(broker, store, cfg, serve_port=0, serve_shards=2, device=CPU)
        try:
            assert isinstance(worker.query_engine, ShardedQueryEngine)
            assert isinstance(worker.view_publisher, ShardedViewPublisher)
            self._feed(broker, store, "a")
            assert worker.poll()
            assert worker.stats()["serve"]["view_version"] == 1
            pid = "a0_pl0"
            code, body = http_get(worker.serve_server.url + f"/v1/ratings?ids={pid}")
            assert code == 200
            player = next(
                p for m in store.matches.values() for r in m.rosters
                for part in r.participants for p in part.player if p.api_id == pid
            )
            assert np.float32(body["ratings"][0]["mu"]) == np.float32(player.trueskill_mu)
            self._feed(broker, store, "b", t0=10)
            assert worker.poll()
            assert worker.stats()["serve"]["view_version"] == 2
        finally:
            worker.close()

    def test_env_selects_the_sharded_plane_for_main(self, monkeypatch):
        """``ANALYZER_TPU_SERVE_SHARDS`` reaches ``main()``, which then
        needs pika like any other worker run."""
        from analyzer_tpu_torch.service import worker as wmod

        monkeypatch.setenv("ANALYZER_TPU_SERVE_SHARDS", "2")
        monkeypatch.delenv("DATABASE_URI", raising=False)
        monkeypatch.setitem(sys.modules, "pika", None)
        with pytest.raises(ImportError):
            wmod.main(device=CPU)


class TestMeshRunnerPublish:
    def _setup(self, n_matches=120, n_players=50, batch_size=16, seed=11):
        from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
        from analyzer_tpu_torch.sched import pack_schedule

        players = synthetic_players(n_players, seed=seed)
        stream = synthetic_stream(n_matches, players, seed=seed)
        state = PlayerState.create(
            n_players, players.rank_points_ranked, players.rank_points_blitz,
            players.skill_tier, device=CPU,
        )
        return state, pack_schedule(stream, pad_row=state.pad_row, batch_size=batch_size)

    @pytest.mark.parametrize("n_dev", [1, 4])
    def test_chunk_boundary_publishes_and_final_bit_identity(self, n_dev):
        from analyzer_tpu_torch.parallel import make_mesh, rate_history_sharded
        from analyzer_tpu_torch.sched import rate_history

        state, sched = self._setup()
        pub = ShardedViewPublisher(n_dev, min_publish_interval_s=0.0, device=CPU)
        versions: list[int] = []
        final = rate_history_sharded(
            state, sched, CFG, mesh=make_mesh(n_dev, device=CPU), steps_per_chunk=7,
            view_publisher=pub, on_chunk=lambda _s, _n: versions.append(pub.version),
        )
        base, _ = rate_history(state, sched, CFG)
        view = pub.current()
        assert view is not None and view.n_players == 50
        assert versions == list(range(1, len(versions) + 1)) and versions[-1] >= 2
        assert view.version == versions[-1] + 1
        np.testing.assert_array_equal(view.host_table(), base.table.numpy()[:50])
        np.testing.assert_array_equal(view.host_table(), final.table.numpy()[:50])
        eS = ShardedQueryEngine(pub, cfg=CFG, device=CPU)
        assert eS.get_ratings(["7"])["ratings"][0]["mu"] == float(final.table[7, MU_LO])

    def test_throttled_publisher_still_gets_final(self):
        from analyzer_tpu_torch.parallel import make_mesh, rate_history_sharded

        state, sched = self._setup(n_matches=40)
        pub = ShardedViewPublisher(2, min_publish_interval_s=3600.0, device=CPU)
        final = rate_history_sharded(state, sched, CFG, mesh=make_mesh(2, device=CPU),
                                     view_publisher=pub)
        assert pub.version == 2  # the first-due chunk publish + the final one
        np.testing.assert_array_equal(pub.current().host_table(), final.table.numpy()[:50])

    def test_shard_count_mismatch_rejected(self):
        from analyzer_tpu_torch.parallel import make_mesh, rate_history_sharded

        state, sched = self._setup(n_matches=20)
        with pytest.raises(ValueError, match="n_shards == mesh size"):
            rate_history_sharded(state, sched, CFG, mesh=make_mesh(2, device=CPU),
                                 view_publisher=ShardedViewPublisher(7, device=CPU))

    def test_plain_publisher_gets_final_state_only(self):
        from analyzer_tpu_torch.parallel import make_mesh, rate_history_sharded

        state, sched = self._setup(n_matches=40)
        pub = ViewPublisher(min_publish_interval_s=0.0, device=CPU)
        final = rate_history_sharded(state, sched, CFG, mesh=make_mesh(2, device=CPU),
                                     view_publisher=pub)
        assert pub.current().version == 1
        np.testing.assert_array_equal(pub.current().host_table()[:50],
                                      final.table.numpy()[:50])

    def test_rate_stream_mesh_publishes_the_final_table(self):
        from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
        from analyzer_tpu_torch.parallel import make_mesh
        from analyzer_tpu_torch.sched import rate_stream

        players = synthetic_players(50, seed=4)
        stream = synthetic_stream(100, players, seed=4)
        state = PlayerState.create(50, device=CPU)
        pub = ShardedViewPublisher(2, min_publish_interval_s=0.0, device=CPU)
        final, _ = rate_stream(state, stream, CFG, mesh=make_mesh(2, device=CPU),
                               view_publisher=pub)
        assert pub.version == 1
        np.testing.assert_array_equal(pub.current().host_table(), final.table.numpy()[:50])


class TestShardSchema:
    def test_standard_schema_has_shard_series(self):
        from analyzer_tpu.obs import registry as jreg
        from analyzer_tpu_torch.obs import registry as preg

        for name in ("serve.view_publish_bytes_total", "serve.shard.queries_total",
                     "serve.shard.merges_total", "serve.shard.merge_candidates_total",
                     "mesh.put_bytes_total", "mesh.puts_total",
                     "mesh.writebacks_avoidable_total"):
            assert name in preg.STANDARD_COUNTERS, name
            assert name in jreg.STANDARD_COUNTERS, name
        assert "serve.shards" in preg.STANDARD_GAUGES
        for name in ("serve.shard.queries_total", "serve.shard.merges_total",
                     "serve.shard.merge_candidates_total", "serve.shards",
                     "mesh.put_bytes_total", "mesh.puts_total",
                     "mesh.writebacks_avoidable_total"):
            assert preg.SCHEMA_HELP[name] == jreg.SCHEMA_HELP[name], name
        snap = get_registry().snapshot()
        assert snap["gauges"]["serve.shards"] == 0
        assert snap["counters"]["mesh.puts_total"] == 0
