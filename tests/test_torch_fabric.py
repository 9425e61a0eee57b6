"""The port's fabric (``analyzer_tpu_torch.fabric``) in one process, against
the JAX package's (``analyzer_tpu.fabric``) and against its own single
plane, on the CPU.

Against the JAX package, exactly:

  * the ownership math over a sweep of shard counts, host counts and rows;
  * ``FabricDirectory`` on the same call sequence: the same vectors,
    snapshots, down sets, lags and errors (a rewind raises ``ValueError``);
  * ``FabricShardPublisher`` on a fake publisher: the same filtered patches
    and directory records;
  * ``FabricRouter`` over per-host planes of the same table: every response
    dict equal to JAX's router's — ids, order, counts and floats, at the
    tolerance of tests/test_torch_serve.py, which is 0;
  * ``ShardMatchmaker`` formations on the same stub ratings;
  * ``PartitionSubscription`` with the fabric layout: the same deliveries.

Inside the port: the router over ``EngineHostClient``s equals ONE engine
over the whole table bit for bit (versions stripped), a down host leaves the
merges, ``FollowerPlane`` adopts the leader's views by reference (the same
tensor, on the leader's device), ``LineageManager.begin_fabric`` wraps the
staging lineage, and the mesh seam ``rate_history_sharded(
fabric_directory=)`` publishes through the ownership filter.

The mesh seam keeps JAX's first-publish behaviour. A first publish has no
previous view, so ``ShardedViewPublisher.publish_shard_patches`` rebuilds
every shard from the runner's blocks, non-owned shards included; the
filter empties only patches. So owned rows always equal the table, and
non-owned rows hold the table of the FIRST publish (after the first chunk)
and are never patched after it. JAX's own test of this seam
(tests/test_fabric.py::TestMeshFabricGuard::
test_multiprocess_with_directory_publishes_owned_shards) asserts that
non-owned rows do not resolve at all, which its code never did (ROADMAP
queue C); the port's test does not copy that assertion and pins the
behaviour above instead.
"""

import dataclasses
import json

import numpy as np
import pytest

import analyzer_tpu.fabric as jfabric
from analyzer_tpu.config import RatingConfig as JaxConfig
from analyzer_tpu.fabric.route import EngineHostClient as JaxEngineClient
from analyzer_tpu.io import synthetic as jsynth
from analyzer_tpu.obs import get_registry as jax_registry
from analyzer_tpu.obs import reset_registry as jax_reset_registry
from analyzer_tpu.serve import QueryEngine as JaxEngine
from analyzer_tpu.serve import ViewPublisher as JaxPublisher
from analyzer_tpu.service.broker import PartitionedBroker as JaxBroker
from analyzer_tpu.service.broker import PartitionSubscription as JaxSubscription
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import MU_LO, SIGMA_LO, PlayerState
from analyzer_tpu_torch.fabric import (
    FabricDirectory,
    FabricRouter,
    FabricShardPublisher,
    FabricTopology,
    FollowerPlane,
    ShardMatchmaker,
    host_of_row,
    host_of_shard,
    owned_partitions,
    owned_rows,
    owned_shards,
    row_of_id,
)
from analyzer_tpu_torch.fabric.route import EngineHostClient, HostDownError
from analyzer_tpu_torch.io import synthetic
from analyzer_tpu_torch.migrate import reset_migration_progress
from analyzer_tpu_torch.migrate.lineage import LineageManager
from analyzer_tpu_torch.obs import get_registry, reset_registry
from analyzer_tpu_torch.serve import QueryEngine, ShardedViewPublisher, ViewPublisher
from analyzer_tpu_torch.serve.engine import UnknownPlayerError
from analyzer_tpu_torch.service.broker import PartitionedBroker, PartitionSubscription
from tests.test_torch_loadgen import _StubClient

CFG = RatingConfig()
JCFG = JaxConfig()
CPU = "cpu"


@pytest.fixture(autouse=True)
def fresh_registries():
    reset_registry()
    jax_reset_registry()
    yield
    reset_registry()
    jax_reset_registry()
    reset_migration_progress()


def rated_table(n_players: int, n_rated: int, seed: int = 0) -> np.ndarray:
    """``[n_players, 16]``: unknown-player seeds for every row, the first
    ``n_rated`` rows with a seeded rating (a tie class among them)."""
    rng = np.random.default_rng(seed)
    state = PlayerState.create(
        n_players, skill_tier=rng.integers(1, 29, n_players), cfg=CFG,
        device=CPU,
    )
    table = state.table.numpy().copy()
    table[:n_rated, MU_LO] = rng.normal(1500, 400, n_rated).astype(np.float32)
    table[:n_rated, SIGMA_LO] = rng.uniform(50, 600, n_rated).astype(np.float32)
    table[3:9, MU_LO], table[3:9, SIGMA_LO] = 1900.0, 100.0  # ties across hosts
    return table[:n_players]


def pid(r: int) -> str:
    return f"p{r:06d}"


class Fleet:
    """An in-process fabric of either package over the same numpy table:
    per-host planes over the owned rows, an oracle plane over the union,
    and a directory + router wired with EngineHostClients."""

    def __init__(self, jax=False, n_players=60, n_shards=4, n_hosts=2, seed=0):
        mod = jfabric if jax else __import__("analyzer_tpu_torch.fabric",
                                             fromlist=["x"])
        pub_of = (lambda: JaxPublisher(min_publish_interval_s=0.0)) if jax else (
            lambda: ViewPublisher(min_publish_interval_s=0.0, device=CPU))
        eng_of = (lambda p: JaxEngine(p, cfg=JCFG)) if jax else (
            lambda p: QueryEngine(p, cfg=CFG, device=CPU))
        client_of = JaxEngineClient if jax else EngineHostClient
        self.topology = mod.FabricTopology(n_shards, n_hosts)
        self.table = rated_table(n_players, int(n_players * 0.8), seed)
        self.ids = [pid(r) for r in range(n_players)]
        self.now = 0.0
        self.directory = mod.FabricDirectory(self.topology, down_after_s=10.0)
        self.engines = []
        clients = {}
        for h in range(n_hosts):
            rows = self.topology.owned_rows(h, n_players)
            pub = pub_of()
            pub.publish_rows([pid(r) for r in rows], self.table[rows])
            eng = eng_of(pub).start()
            self.engines.append(eng)
            clients[h] = client_of(eng)
            self.directory.register(h, now=self.now)
            self.directory.observe(h, pub.version, self.now)
        oracle_pub = pub_of()
        oracle_pub.publish_rows(self.ids, self.table)
        self.oracle = eng_of(oracle_pub).start()
        self.engines.append(self.oracle)
        self.router = mod.FabricRouter(
            self.directory, clients=clients, cfg=JCFG if jax else CFG,
            clock=lambda: self.now,
        )

    def close(self):
        for eng in self.engines:
            eng.close()


@pytest.fixture(scope="module")
def fleets():
    port, jax = Fleet(), Fleet(jax=True)
    yield port, jax
    port.close()
    jax.close()


def strip(resp: dict) -> dict:
    return FabricRouter.strip_versions(resp)


# ---------------------------------------------------------------------------
class TestOwnershipMathAgainstJax:
    @pytest.mark.parametrize("n_shards,n_hosts", [
        (1, 1), (3, 1), (4, 2), (5, 3), (6, 4), (8, 8), (9, 2), (16, 5),
    ])
    def test_maps_equal_jax(self, n_shards, n_hosts):
        for r in range(70):
            assert host_of_row(r, n_shards, n_hosts) == jfabric.host_of_row(
                r, n_shards, n_hosts)
        for s in range(n_shards):
            assert host_of_shard(s, n_hosts) == jfabric.host_of_shard(s, n_hosts)
        for h in range(n_hosts):
            assert owned_shards(h, n_shards, n_hosts) == jfabric.owned_shards(
                h, n_shards, n_hosts)
            assert owned_partitions(h, n_shards, n_hosts) == owned_shards(
                h, n_shards, n_hosts)
            assert owned_rows(h, 47, n_shards, n_hosts) == jfabric.owned_rows(
                h, 47, n_shards, n_hosts)
        rows = sorted(r for h in range(n_hosts)
                      for r in owned_rows(h, 47, n_shards, n_hosts))
        assert rows == list(range(47))
        t, jt = FabricTopology(n_shards, n_hosts), jfabric.FabricTopology(
            n_shards, n_hosts)
        for r in range(0, 70, 7):
            assert t.host_of_id(pid(r)) == jt.host_of_id(pid(r))

    def test_row_of_id_and_validation_equal_jax(self):
        assert row_of_id(pid(123)) == jfabric.row_of_id(pid(123)) == 123
        assert row_of_id("p7") == 7
        for bad in ("x7", "p", "", "p-3", "q000001"):
            with pytest.raises(ValueError, match="p<row>") as got:
                row_of_id(bad)
            with pytest.raises(ValueError) as want:
                jfabric.row_of_id(bad)
            assert str(got.value) == str(want.value)
        for s, h in ((2, 3), (0, 1), (1, 0)):
            with pytest.raises(ValueError) as got:
                FabricTopology(s, h)
            with pytest.raises(ValueError) as want:
                jfabric.FabricTopology(s, h)
            assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
def _directory_trace(mod):
    """One call sequence through either package's directory: the record of
    every observable answer, errors included."""
    d = mod.FabricDirectory(mod.FabricTopology(4, 2), down_after_s=5.0)
    out = []

    def note(fn):
        try:
            out.append(("ok", fn()))
        except (KeyError, ValueError) as err:
            out.append((type(err).__name__, str(err)))

    note(lambda: d.observe(1, 1, now=0.0))          # before register
    note(lambda: d.register(5, now=0.0))            # outside the topology
    d.register(0, serve_url="http://h0", now=0.0)
    d.register(1, now=0.0)
    note(lambda: d.snapshot(now=20.0))              # never observed: down
    d.observe(0, 3, now=1.0)
    d.observe(1, 1, now=1.0)
    note(d.vector)
    note(lambda: (d.entry(0).shards, d.route_shard(3).host, d.route_id(pid(6)).host))
    d.observe(0, 3, now=2.0)                        # equal is fine
    note(lambda: d.observe(0, 2, now=3.0))          # rewind
    d.observe(0, 4, now=8.0)
    note(lambda: (d.down_hosts(now=8.0), [e.host for e in d.alive_hosts(8.0)],
                  d.lag_s(8.0)))
    d.observe(1, 2, now=9.0)
    d.mark_down(0)
    note(lambda: (d.down_hosts(now=9.0), d.snapshot(now=9.0)))
    d.observe(0, 5, now=9.5)
    note(lambda: d.down_hosts(now=9.5))
    d.register(0, now=10.0)                         # restart resets the floor
    d.observe(0, 1, now=10.5)
    note(lambda: (d.vector(), d.snapshot(now=11.0), d.snapshot()))
    note(lambda: d.entry(1))
    return out


class TestDirectoryAgainstJax:
    def test_same_calls_same_answers(self):
        got, want = _directory_trace(__import__(
            "analyzer_tpu_torch.fabric", fromlist=["x"])), _directory_trace(jfabric)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if g[0] == "ok" and hasattr(g[1], "host"):
                g = ("ok", dataclasses.asdict(g[1]))
                w = ("ok", dataclasses.asdict(w[1]))
            assert g == w
        assert any(kind == "ValueError" and "rewound" in msg for kind, msg in got)
        counter = "fabric.version_observations_total"
        assert get_registry().counter(counter).value == jax_registry().counter(
            counter).value == 7
        assert get_registry().gauge("fabric.hosts").value == 2


# ---------------------------------------------------------------------------
class _FakeShardedPublisher:
    def __init__(self, n_shards):
        self.n_shards = n_shards
        self.version = 0
        self.published = []

    def publish_shard_patches(self, patches, n_players, blocks_thunk):
        self.published.append(patches)
        self.version += 1
        return f"view-v{self.version}"


class TestShardPublisherAgainstJax:
    @pytest.mark.parametrize("n_shards,n_hosts,host", [(4, 2, 1), (4, 2, 0), (5, 3, 2)])
    def test_filters_non_owned_and_records_version(self, n_shards, n_hosts, host):
        sent = []
        for mod in (__import__("analyzer_tpu_torch.fabric", fromlist=["x"]), jfabric):
            d = mod.FabricDirectory(mod.FabricTopology(n_shards, n_hosts))
            inner = _FakeShardedPublisher(n_shards)
            now = [3.5]
            wrapped = mod.FabricShardPublisher(d, host, inner, clock=lambda: now[0])
            patches = [(np.array([s, s + n_shards]), np.full((2, 16), s, np.float32))
                       for s in range(n_shards)]
            assert wrapped.publish_shard_patches(patches, 20, lambda: None) == "view-v1"
            now[0] = 4.0
            wrapped.publish_shard_patches(patches, 20, lambda: None)
            sent.append((
                [[(i.tolist(), r.tolist(), r.dtype.str) for i, r in p]
                 for p in inner.published],
                d.vector(), d.entry(host).last_seen, sorted(wrapped.owned),
            ))
        assert sent[0] == sent[1]
        owned = set(owned_shards(host, n_shards, n_hosts))
        for s, (idx, _rows, _dt) in enumerate(sent[0][0][0]):
            assert (len(idx) == 2) == (s in owned)
        assert sent[0][1] == {host: 2} and sent[0][2] == 4.0

    def test_topology_mismatch_rejected(self):
        d = FabricDirectory(FabricTopology(4, 2))
        with pytest.raises(ValueError, match="must agree"):
            FabricShardPublisher(d, 0, _FakeShardedPublisher(3))


# ---------------------------------------------------------------------------
class TestFollowerPlane:
    def test_adopts_by_reference_with_monotone_versions(self):
        leader = ViewPublisher(min_publish_interval_s=0.0, device=CPU)
        table = rated_table(20, 16, seed=3)
        leader.publish_rows([pid(r) for r in range(20)], table)
        follower = FollowerPlane(leader, cfg=CFG).start()
        leader_eng = QueryEngine(leader, cfg=CFG, device=CPU).start()
        try:
            assert follower.version == leader.version
            assert follower.engine.device == follower.publisher.device == leader.device
            ids = [pid(3), pid(7), "ghost"]
            assert leader_eng.get_ratings(ids) == follower.engine.get_ratings(ids)
            assert leader_eng.leaderboard(5) == follower.engine.leaderboard(5)
            assert follower.refresh() is False  # no new leader view
            t2 = table.copy()
            t2[:, MU_LO] += 10.0
            leader.publish_rows([pid(r) for r in range(20)], t2)
            assert follower.refresh() is True
            assert follower.version == leader.version == 2
            got = follower.engine.get_ratings([pid(0)])["ratings"][0]["mu"]
            assert np.float32(got) == np.float32(t2[0, MU_LO])
            # By reference: the adopted view and its table ARE the leader's.
            assert follower.publisher.current() is leader.current()
            assert follower.publisher.current().table is leader.current().table
            assert get_registry().counter("serve.view_adoptions_total").value == 2
        finally:
            follower.close()
            leader_eng.close()


# ---------------------------------------------------------------------------
class TestRouterAgainstOnePlane:
    """Routed reads against the single plane holding the union table — bit
    for bit after version stripping."""

    def test_point_lookups_split_by_owner_preserve_order(self, fleets):
        f = fleets[0]
        ids = [pid(7), pid(0), pid(13), "ghost", pid(2), pid(59), "p"]
        routed = f.router.get_ratings(ids)
        oracle = f.oracle.get_ratings([i for i in ids if i not in ("ghost", "p")])
        assert routed["unknown"] == ["ghost", "p"]
        assert routed["ratings"] == oracle["ratings"]
        assert set(routed["versions"]) == {"0", "1"}

    def test_winprob_single_and_cross_owner(self, fleets):
        f = fleets[0]
        for a, b, owners in (
            ([pid(1), pid(5), pid(9)], [pid(13), pid(17), pid(21)], ["1"]),
            ([pid(0), pid(1), pid(2)], [pid(3), pid(4), pid(5)], ["0", "1"]),
            ([pid(50), pid(51)], [pid(52), pid(53), pid(59)], ["0", "1"]),  # unrated
        ):
            routed = f.router.win_probability(a, b)
            assert strip(routed) == strip(f.oracle.win_probability(a, b))
            assert sorted(routed["versions"]) == owners
        with pytest.raises(UnknownPlayerError):
            f.router.win_probability([pid(0), "zzz"], [pid(1), pid(2)])
        with pytest.raises(UnknownPlayerError):
            f.router.win_probability([pid(0), pid(900)], [pid(1), pid(3)])

    def test_leaderboard_merge_bit_identical(self, fleets):
        f = fleets[0]
        for k in (1, 4, 5, 6, 10, 25, 60):
            assert f.router.leaderboard(k)["leaders"] == f.oracle.leaderboard(k)["leaders"]

    def test_tiers_and_percentile_sum_exactly(self, fleets):
        f = fleets[0]
        assert strip(f.router.tier_histogram()) == strip(f.oracle.tier_histogram())
        for score in (800.0, 1500.0, 1900.0, 2400.0):
            assert strip(f.router.percentile(score)) == strip(f.oracle.percentile(score))

    def test_version_vector_and_counters(self):
        f = Fleet(n_players=40)
        try:
            assert f.router.version_vector() == {0: 1, 1: 1}
            f.router.leaderboard(3)
            f.router.get_ratings([pid(1)])
            reg = get_registry()
            assert reg.counter("fabric.remote_lookups_total").value == 3
            assert f.router.calls == {"leaderboard": 2, "ratings": 1}
            snap = reg.snapshot()["histograms"]
            assert {k for k in snap if k.startswith("fabric.remote_lookup_ms")} == {
                "fabric.remote_lookup_ms{peer=0}", "fabric.remote_lookup_ms{peer=1}"}
        finally:
            f.close()


class TestRouterAgainstJax:
    """The port's router and JAX's over the same numpy table: every response
    dict equal, versions included (both publish each host once)."""

    def test_every_kind_equal(self):
        port, jax = Fleet(), Fleet(jax=True)
        try:
            self._every_kind(port, jax)
        finally:
            port.close()
            jax.close()

    @staticmethod
    def _every_kind(port, jax):
        ids = [pid(7), pid(0), "ghost", pid(13), pid(2), pid(59), pid(44)]
        assert port.router.get_ratings(ids) == jax.router.get_ratings(ids)
        for a, b in (([pid(1), pid(5), pid(9)], [pid(13), pid(17), pid(21)]),
                     ([pid(0), pid(1), pid(2)], [pid(3), pid(4), pid(5)]),
                     ([pid(50)], [pid(52), pid(53)])):
            assert port.router.win_probability(a, b) == jax.router.win_probability(a, b)
        for k in (1, 5, 6, 10, 60):
            assert port.router.leaderboard(k) == jax.router.leaderboard(k)
        assert port.router.tier_histogram() == jax.router.tier_histogram()
        for score in (800.0, 1500.0, 1900.0):
            assert port.router.percentile(score) == jax.router.percentile(score)
        assert port.router.calls == jax.router.calls


class TestRouterDownHost:
    def test_down_host_leaves_merge_without_wedging_readers(self):
        f = Fleet(n_players=40, n_shards=4, n_hosts=2)
        try:
            f.now = 100.0  # both hosts stale -> down by staleness
            with pytest.raises(HostDownError, match="every fabric host"):
                f.router.leaderboard(5)
            f.directory.observe(0, 2, now=f.now)
            resp = f.router.leaderboard(40)
            assert list(resp["versions"]) == ["0"]
            owned0 = {pid(r) for r in f.topology.owned_rows(0, 40)}
            assert {e["id"] for e in resp["leaders"]} <= owned0
            assert sum(f.router.tier_histogram()["counts"]) <= len(owned0)
        finally:
            f.close()

    def test_transport_failure_marks_down(self):
        f = Fleet(n_players=40, n_shards=4, n_hosts=2)

        class Boom:
            def leaderboard(self, k):
                raise OSError("connection refused")

            def get_ratings(self, ids):
                raise OSError("connection refused")

        try:
            f.router._clients[1] = Boom()
            resp = f.router.leaderboard(10)  # host 1 drops mid-merge
            assert list(resp["versions"]) == ["0"]
            assert f.directory.entry(1).down is True
            assert get_registry().counter("fabric.remote_errors_total").value == 1
            with pytest.raises(HostDownError, match="host 1"):
                f.router.get_ratings([pid(1)])  # only the owner has the row
        finally:
            f.close()


# ---------------------------------------------------------------------------
class TestShardMatchmakerAgainstJax:
    @pytest.mark.parametrize("shard,seed", [(0, 5), (3, 5), (1, 9)])
    def test_formations_equal_jax(self, shard, seed):
        n = 160
        mm = ShardMatchmaker(synthetic.synthetic_players(n, seed=seed),
                             _StubClient(n, seed), shard, 4, seed=seed, cfg=CFG)
        jmm = jfabric.ShardMatchmaker(jsynth.synthetic_players(n, seed=seed),
                                      _StubClient(n, seed), shard, 4, seed=seed,
                                      cfg=JCFG)
        for k in (1, 6, 12):
            got = [dataclasses.astuple(m) for m in mm.form(k)]
            assert got == [dataclasses.astuple(m) for m in jmm.form(k)]
            for m in got:
                assert all(r % 4 == shard for r in list(m[1]) + list(m[2]))
        rng, jrng = np.random.default_rng(2), np.random.default_rng(2)
        rows = mm.sample_rows(8, rng=rng)
        assert rows == jmm.sample_rows(8, rng=jrng)
        assert len(set(rows)) == 8 and all(r % 4 == shard for r in rows)
        assert mm.client.calls == jmm.client.calls

    def test_too_small_shard_rejected(self):
        with pytest.raises(ValueError, match="at least 10"):
            ShardMatchmaker(synthetic.synthetic_players(100, seed=0),
                            _StubClient(100, 0), 0, 16)
        with pytest.raises(ValueError, match="outside"):
            ShardMatchmaker(synthetic.synthetic_players(100, seed=0),
                            _StubClient(100, 0), 4, 4)


# ---------------------------------------------------------------------------
class TestPartitionSubscriptionFabricLayout:
    """The fabric's ingest: one partition per shard, each host subscribed
    to its owned partitions — the same deliveries as JAX's."""

    @pytest.mark.parametrize("n_shards,n_hosts", [(4, 2), (6, 3)])
    def test_owned_only_in_seq_order_equal_jax(self, n_shards, n_hosts):
        got = []
        for broker_cls, sub_cls, topo_cls in (
            (PartitionedBroker, PartitionSubscription, FabricTopology),
            (JaxBroker, JaxSubscription, jfabric.FabricTopology),
        ):
            b = broker_cls(partitions=n_shards)
            b.declare_queue("analyze")
            b.declare_queue("analyze.dead")
            for i in range(3 * n_shards):
                b.publish("analyze", json.dumps({"i": i}).encode(),
                          headers={"x-partition": (i * 7) % n_shards})
            topo = topo_cls(n_shards, n_hosts)
            per_host = []
            for h in range(n_hosts):
                sub = sub_cls(b, topo.owned_partitions(h))
                depth = sub.qsize("analyze")
                msgs = sub.get("analyze", 100)
                if msgs:  # a dead letter stays on its owner's partition
                    sub.publish("analyze.dead", msgs[0].body, headers=msgs[0].headers)
                for m in msgs:
                    sub.ack(m.delivery_tag)
                per_host.append((depth, [json.loads(m.body)["i"] for m in msgs]))
            dead = b.partition_depths("analyze.dead")
            got.append((per_host, {int(k): v["live"] for k, v in dead.items()}))
        assert got[0] == got[1]
        delivered = sorted(i for _d, ids in got[0][0] for i in ids)
        assert delivered == list(range(3 * n_shards))


# ---------------------------------------------------------------------------
class TestMeshFabricSeam:
    """``rate_history_sharded(fabric_directory=)`` in one process: the
    runner wraps the sharded publisher for host ``process_index()`` (0
    without a process group; 1 here by patching it, as JAX's test patches
    ``jax.process_count``)."""

    CHUNK = 3

    def _setup(self, n_matches=60, n_players=30, batch_size=8, seed=11):
        from analyzer_tpu_torch.sched import pack_schedule

        players = synthetic.synthetic_players(n_players, seed=seed)
        stream = synthetic.synthetic_stream(n_matches, players, seed=seed)
        state = PlayerState.create(
            n_players, rank_points_ranked=players.rank_points_ranked,
            rank_points_blitz=players.rank_points_blitz,
            skill_tier=players.skill_tier, device=CPU,
        )
        sched = pack_schedule(stream, pad_row=state.pad_row, batch_size=batch_size)
        return state, sched

    def test_multiprocess_without_directory_points_at_cli_fabric(self):
        from analyzer_tpu_torch.parallel import rate_history_sharded
        from analyzer_tpu_torch.parallel.mesh import Mesh

        state, sched = self._setup()
        mesh = Mesh(2, state.table.device, rank=0, world_size=2)
        with pytest.raises(ValueError, match="cli fabric"):
            rate_history_sharded(state, sched, CFG, mesh=mesh,
                                 view_publisher=ShardedViewPublisher(
                                     2, min_publish_interval_s=0.0, device=CPU))

    @pytest.mark.parametrize("n_shards,host", [(2, 0), (2, 1), (4, 0), (4, 1)])
    def test_owned_rows_patched_non_owned_from_first_publish(
            self, monkeypatch, n_shards, host):
        import analyzer_tpu_torch.parallel.mesh as mesh_mod
        from analyzer_tpu_torch.parallel import make_mesh, rate_history_sharded
        from analyzer_tpu_torch.sched import rate_history

        state, sched = self._setup()
        assert sched.n_steps > 2 * self.CHUNK
        mesh = make_mesh(n_shards, device=CPU)  # one process: rank 0
        monkeypatch.setattr(mesh_mod, "process_index", lambda: host)
        directory = FabricDirectory(FabricTopology(n_shards, 2))
        pub = ShardedViewPublisher(n_shards, min_publish_interval_s=0.0, device=CPU)
        final = rate_history_sharded(
            state, sched, CFG, mesh=mesh,
            steps_per_chunk=self.CHUNK, view_publisher=pub,
            fabric_directory=directory,
        )
        first, _ = rate_history(state, sched, CFG, stop_after=self.CHUNK)
        view = pub.current()
        n = state.n_players
        got, ft, t1 = view.host_table(), final.table.numpy(), first.table.numpy()
        # One version per chunk plus the final publish, all recorded for
        # this host (and only this host) in the directory.
        assert directory.vector() == {host: pub.version}
        assert pub.version == -(-sched.n_steps // self.CHUNK) + 1
        owned = set(owned_shards(host, n_shards, 2))
        assert view.n_players == n
        for r in range(n):
            assert view.resolve(str(r)) == r  # identity mode: every row resolves
            want = ft[r] if r % n_shards in owned else t1[r]
            assert np.array_equal(got[r], want, equal_nan=True), r
        # The non-owned rows really are stale: the run moved some of them.
        foreign = [r for r in range(n) if r % n_shards not in owned]
        assert not np.array_equal(got[foreign], ft[foreign], equal_nan=True)


# ---------------------------------------------------------------------------
class TestBeginFabric:
    def test_wraps_staging_in_ownership_filter(self):
        live = _FakeShardedPublisher(4)
        live.version = 7
        mgr = LineageManager(live, factory=lambda: _FakeShardedPublisher(4))
        d = FabricDirectory(FabricTopology(4, 2))
        wrapped = mgr.begin_fabric(d, host=1, clock=lambda: 2.0)
        assert isinstance(wrapped, FabricShardPublisher)
        assert wrapped.inner is mgr.staging  # the raw lineage stays managed
        patches = [(np.array([s]), np.full((1, 16), s, np.float32)) for s in range(4)]
        wrapped.publish_shard_patches(patches, 8, lambda: None)
        sent = mgr.staging.published[0]
        assert len(sent[0][0]) == 0 and sent[1][0].tolist() == [1]
        assert len(sent[2][0]) == 0 and sent[3][0].tolist() == [3]
        assert d.vector()[1] == 1 and d.entry(1).last_seen == 2.0
        assert mgr.versions() == {"live": 7, "staging": 1}
        mgr.abort()
        assert mgr.staging is None

    def test_one_migration_at_a_time_still_enforced(self):
        mgr = LineageManager(_FakeShardedPublisher(2),
                             factory=lambda: _FakeShardedPublisher(2))
        d = FabricDirectory(FabricTopology(2, 2))
        mgr.begin_fabric(d, host=0)
        with pytest.raises(RuntimeError, match="already in flight"):
            mgr.begin_fabric(d, host=0)

    def test_real_staging_lineage_cuts_over(self):
        live = ShardedViewPublisher(2, min_publish_interval_s=0.0, device=CPU)
        live.publish_state(PlayerState.create(6, cfg=CFG, device=CPU))
        mgr = LineageManager(live)
        d = FabricDirectory(FabricTopology(2, 2))
        wrapped = mgr.begin_fabric(d, host=0)
        state = PlayerState.create(6, cfg=CFG, device=CPU)
        table = state.table.numpy()[:6].copy()
        table[:, MU_LO] = np.arange(6, dtype=np.float32)
        blocks = [table[0::2], table[1::2]]
        wrapped.publish_shard_patches(
            [(np.arange(3), blocks[0]), (np.arange(3), blocks[1])], 6,
            lambda: blocks)
        view = mgr.cutover()
        assert view is live.current() and live.version == 2
        np.testing.assert_array_equal(view.host_table()[:, MU_LO], np.arange(6))
        assert d.vector() == {0: 1}


# ---------------------------------------------------------------------------
def test_entry_points_default_to_the_card(capsys):
    """Without a card, every fabric entry point refuses rather than carry on
    on the CPU: the host, the soak driver, ``cli soak --hosts`` and ``cli
    fabric`` (exit 2 naming the missing CUDA device)."""
    import torch

    from analyzer_tpu_torch import cli
    from analyzer_tpu_torch.fabric import (
        FabricHost,
        FabricHostConfig,
        FabricSoakConfig,
        FabricSoakDriver,
    )

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        FabricHost(FabricHostConfig(host=0, n_shards=2, n_hosts=1, n_players=40))
    with pytest.raises(RuntimeError, match="CUDA"):
        FabricSoakDriver(FabricSoakConfig(n_hosts=1))
    for argv in (["soak", "--hosts", "2"], ["fabric", "--hosts", "2"]):
        assert cli.main(argv) == 2
        assert "no CUDA device is visible" in capsys.readouterr().err
