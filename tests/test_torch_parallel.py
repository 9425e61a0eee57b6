"""The port's data-parallel mesh (``analyzer_tpu_torch.parallel``) against the
JAX package's and against the port's own single-device runner, on the CPU.

Exact, against the JAX package: the routing (``build_routing``,
``_window_routing`` — ``sel`` and ``dst`` integer for integer), the layout
helpers, every guard's message, and the ``mesh.*`` counters of the same run.
Within the parity contract's tolerance (tests/test_torch_ops.py's
docstring; rtol 2e-6, atol 2e-3 on a table, as tests/test_torch_stream.py):
the sharded table against JAX's ``rate_history_sharded`` on
``make_mesh(D)`` (the conftest's 8 CPU devices), with the NaN pattern and
the padding row exact. Inside the port, BIT FOR BIT: ``rate_history_sharded``
at D = 1, 2, 4, 8 equals ``rate_history(kernel="reference")`` — the whole
table, padding row included — eager or windowed, at any routing capacity,
resumed or not, and so does ``rate_stream(mesh=)``. Data-parallel training
is held against JAX's ``train_minibatch(mesh=make_mesh(D))`` (the weight
tolerance of tests/test_torch_models.py) and against the port's
single-device training (float32 reduction order only, ``MESH_ATOL``).
Multi-process runs are tests/test_torch_multihost.py's.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from analyzer_tpu import obs as jobs
from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.core.state import PlayerState as JaxPlayerState
from analyzer_tpu.io import synthetic as jsynth
from analyzer_tpu.models import train_logistic as jax_train_logistic
from analyzer_tpu.parallel import build_routing as jax_build_routing
from analyzer_tpu.parallel import make_mesh as jax_make_mesh
from analyzer_tpu.parallel import rate_history_sharded as jax_rate_history_sharded
from analyzer_tpu.parallel import mesh as jmesh
from analyzer_tpu.sched import pack_schedule as jax_pack_schedule
from analyzer_tpu.sched import rate_stream as jax_rate_stream
from analyzer_tpu_torch import obs
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.io import synthetic
from analyzer_tpu_torch.models import train_logistic, train_mlp
from analyzer_tpu_torch.parallel import (
    assert_processes_agree,
    build_routing,
    initialize_distributed,
    make_mesh,
    process_slice,
    rate_history_sharded,
)
from analyzer_tpu_torch.parallel import mesh as pmesh
from analyzer_tpu_torch.sched import pack_schedule, rate_history, rate_stream

CFG = RatingConfig()
JCFG = JaxRatingConfig()
CPU = "cpu"
#: The parity contract's table tolerance (tests/test_torch_stream.py).
RTOL, ATOL = 2e-6, 2e-3
#: Trained weights against the JAX package (tests/test_torch_models.py).
W_RTOL, W_ATOL = 1e-4, 1e-5
#: Data-parallel against single-device training in the port: float32
#: reduction order only (tests/test_torch_models.py).
MESH_ATOL = 1e-5
MESHES = [1, 2, 4, 8]
COUNTERS = ("mesh.put_bytes_total", "mesh.puts_total",
            "mesh.writebacks_avoidable_total")


def _both(n_matches=200, n_players=60, batch_size=32, seed=11, windowed=False,
          **kw):
    """The same seeded history through both packages: (port state, port
    schedule, JAX state, JAX schedule, port stream, JAX stream)."""
    players = synthetic.synthetic_players(n_players, seed=seed)
    stream = synthetic.synthetic_stream(n_matches, players, seed=seed, **kw)
    jplayers = jsynth.synthetic_players(n_players, seed=seed)
    jstream = jsynth.synthetic_stream(n_matches, jplayers, seed=seed, **kw)
    seeds = (players.rank_points_ranked, players.rank_points_blitz,
             players.skill_tier)
    state = PlayerState.create(n_players, *seeds, device=CPU)
    jstate = JaxPlayerState.create(n_players, *seeds)
    sched = pack_schedule(stream, pad_row=state.pad_row, batch_size=batch_size,
                          windowed=windowed)
    jsched = jax_pack_schedule(jstream, pad_row=jstate.pad_row,
                               batch_size=batch_size, windowed=windowed)
    return state, sched, jstate, jsched, stream, jstream


def _setup(**kw):
    state, sched, _j, _js, _s, _jstr = _both(**kw)
    return state, sched


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return np.array_equal(a.numpy(), b.numpy(), equal_nan=True)


def _assert_close_to_jax(table: np.ndarray, jtable: np.ndarray) -> None:
    """Players' rows within the parity tolerance, NaN pattern exact; the
    padding row exact (neither mesh ever writes it)."""
    assert table.shape == jtable.shape
    np.testing.assert_array_equal(np.isnan(table), np.isnan(jtable))
    np.testing.assert_allclose(table[:-1], jtable[:-1], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(table[-1], jtable[-1])


@pytest.fixture(autouse=True)
def fresh_registries():
    obs.reset_registry()
    jobs.reset_registry()
    yield
    obs.reset_registry()
    jobs.reset_registry()


class TestRouting:
    @pytest.mark.parametrize("n_dev", MESHES + [3])
    def test_build_routing_equals_jax(self, n_dev):
        state, sched, jstate, jsched, _s, _js = _both(
            n_matches=300, n_players=80, batch_size=24, afk_rate=0.2,
            unsupported_rate=0.1,
        )
        got = build_routing(sched, state.table.shape[0], n_dev)
        want = jax_build_routing(jsched, jstate.table.shape[0], n_dev)
        assert (got.rows_per_shard, got.n_shards, got.capacity) == (
            want.rows_per_shard, want.n_shards, want.capacity)
        for name in ("sel", "dst"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype == np.int32, name
            np.testing.assert_array_equal(a, b, err_msg=name)

    @pytest.mark.parametrize("n_dev", [1, 2, 5, 8])
    def test_window_routing_equals_jax(self, n_dev):
        rng = np.random.default_rng(n_dev)
        for _ in range(5):
            w, n = int(rng.integers(1, 9)), int(rng.integers(1, 60))
            idx = rng.integers(0, 400, (w, n)).astype(np.int64)
            valid = rng.random((w, n)) < 0.7
            rps = -(-401 // n_dev)
            got = pmesh._window_routing(idx, valid, n_dev, rps)
            want = jmesh._window_routing(idx, valid, n_dev, rps)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)

    def test_layout_helpers_equal_jax(self):
        rows = np.arange(1000, dtype=np.int64)
        for d in (1, 2, 3, 4, 8):
            np.testing.assert_array_equal(pmesh._owner(rows, d), jmesh._owner(rows, d))
            np.testing.assert_array_equal(pmesh._local_row(rows, d),
                                          jmesh._local_row(rows, d))
            rps = -(-1000 // d)
            table = np.arange(d * rps * 4, dtype=np.float32).reshape(-1, 4)
            sm = pmesh._to_shard_major(table, d, rps)
            np.testing.assert_array_equal(sm, np.asarray(jmesh._to_shard_major(table, d, rps)))
            np.testing.assert_array_equal(pmesh._from_shard_major(sm, d, rps), table)
            t = torch.from_numpy(table)
            assert torch.equal(pmesh._to_shard_major(t, d, rps), torch.from_numpy(sm))

    def test_routing_covers_every_ratable_slot(self):
        """Every written slot appears in exactly one shard's lists, at its
        owner shard, and padding entries are out of range (dropped)."""
        state, sched = _setup(n_matches=300, n_players=80, batch_size=24)
        n_rows = state.table.shape[0]
        ratable = (sched.mode_id >= 0) & ~sched.afk
        n = sched.batch_size * 2 * sched.player_idx.shape[-1]
        valid = (sched.slot_mask & ratable[:, :, None, None]).reshape(sched.n_steps, n)
        idx = sched.player_idx.reshape(sched.n_steps, n)
        for d in (1, 2, 4, 8):
            routing = build_routing(sched, n_rows, d)
            rps = routing.rows_per_shard
            assert rps * d >= n_rows
            for s in range(sched.n_steps):
                got = []
                for shard in range(d):
                    live = routing.dst[s, shard] < rps
                    assert (routing.dst[s, shard][~live] == rps).all()
                    for sl, dl in zip(routing.sel[s, shard][live],
                                      routing.dst[s, shard][live]):
                        got.append((int(sl), int(dl) * d + shard))
                want = [(int(i), int(idx[s, i])) for i in np.flatnonzero(valid[s])]
                assert sorted(got) == sorted(want)


class TestShardedHistory:
    @pytest.mark.parametrize("n_dev", MESHES)
    def test_bit_identical_to_the_reference_runner(self, n_dev):
        state, sched = _setup(afk_rate=0.1, unsupported_rate=0.1)
        base, _ = rate_history(state, sched, CFG, kernel="reference")
        got = rate_history_sharded(state, sched, CFG,
                                   mesh=make_mesh(n_dev, device=CPU),
                                   steps_per_chunk=13)
        assert got.table.shape == base.table.shape
        assert _same(got.table, base.table)  # padding row included

    @pytest.mark.parametrize("n_dev", MESHES)
    def test_within_tolerance_of_jax(self, n_dev):
        state, sched, jstate, jsched, _s, _js = _both()
        got = rate_history_sharded(state, sched, CFG,
                                   mesh=make_mesh(n_dev, device=CPU),
                                   steps_per_chunk=13)
        want = jax_rate_history_sharded(jstate, jsched, JCFG,
                                        mesh=jax_make_mesh(n_dev),
                                        steps_per_chunk=13)
        _assert_close_to_jax(got.table.numpy(), np.asarray(want.table))

    @pytest.mark.parametrize("n_dev", MESHES)
    def test_windowed_schedule_matches_eager(self, n_dev):
        state, wsched = _setup(windowed=True)
        base, _ = rate_history(state, wsched, CFG)

        def boom():
            raise AssertionError("windowed mesh path materialized eagerly")

        wsched.materialize = boom
        got = rate_history_sharded(state, wsched, CFG,
                                   mesh=make_mesh(n_dev, device=CPU),
                                   steps_per_chunk=13)
        assert _same(got.table, base.table)

    def test_routing_capacity_growth(self):
        state, wsched = _setup(windowed=True)
        base, _ = rate_history(state, wsched, CFG)
        run = []
        orig = pmesh.ShardedRun._route_window

        def spy(self, *a):
            out = orig(self, *a)
            run.append(out[0].shape[2])
            return out

        lines = []
        handler = logging.Handler()
        handler.emit = lambda rec: lines.append(rec.getMessage())
        pmesh.logger.addHandler(handler)
        pmesh.ShardedRun._route_window = spy
        try:
            got = rate_history_sharded(
                state, wsched, CFG, mesh=make_mesh(2, device=CPU),
                steps_per_chunk=7, routing_capacity=1,
            )
        finally:
            pmesh.ShardedRun._route_window = orig
            pmesh.logger.removeHandler(handler)
        assert _same(got.table, base.table)
        assert run == sorted(run) and run[0] > 1  # grew, never shrank
        assert lines and lines[0].startswith("sharded routing capacity grew 1 ->")

    def test_prebuilt_routing_reused_and_validated(self):
        state, sched = _setup()
        base, _ = rate_history(state, sched, CFG)
        mesh = make_mesh(2, device=CPU)
        routing = build_routing(sched, state.table.shape[0], 2)
        got = rate_history_sharded(state, sched, CFG, mesh=mesh, routing=routing)
        assert _same(got.table, base.table)

    @pytest.mark.parametrize("n_dev", [2, 8])
    def test_rate_stream_on_mesh_matches(self, n_dev):
        state, sched, jstate, _jsched, stream, jstream = _both(
            n_matches=300, seed=7)
        base, _ = rate_history(state, sched, CFG)
        stats: dict = {}
        got, out = rate_stream(state, stream, CFG, mesh=make_mesh(n_dev, device=CPU),
                               steps_per_chunk=5, stats_out=stats)
        assert out is None and _same(got.table, base.table)
        assert stats["batch_size"] % n_dev == 0
        jstats: dict = {}
        jax_rate_stream(jstate, jstream, JCFG, mesh=jax_make_mesh(n_dev),
                        steps_per_chunk=5, stats_out=jstats)
        for key in ("n_steps", "batch_size", "occupancy"):
            assert stats[key] == jstats[key], key

    def test_rate_stream_on_mesh_empty_stream(self):
        state, _sched = _setup()
        empty = synthetic.synthetic_stream(0, synthetic.synthetic_players(5, seed=1), seed=1)
        got, out = rate_stream(state, empty, CFG, mesh=make_mesh(2, device=CPU))
        assert out is None and _same(got.table, state.table)

    def test_caller_state_survives(self):
        state, sched = _setup(n_matches=40, n_players=30, batch_size=8)
        before = state.table.clone()
        mesh = make_mesh(1, device=CPU)
        a = rate_history_sharded(state, sched, CFG, mesh=mesh)
        b = rate_history_sharded(state, sched, CFG, mesh=mesh)
        assert _same(a.table, b.table)
        assert _same(state.table, before)
        assert torch.isnan(state.table[:, 0]).all()

    def test_resume_mid_schedule_equals_one_shot(self):
        state, sched = _setup()
        base, _ = rate_history(state, sched, CFG)
        mesh = make_mesh(4, device=CPU)
        half = rate_history_sharded(state, sched, CFG, mesh=mesh, stop_after=9,
                                    steps_per_chunk=4)
        rest = rate_history_sharded(half, sched, CFG, mesh=mesh, start_step=9,
                                    steps_per_chunk=4)
        assert _same(rest.table, base.table)

    def test_hook_gets_a_snapshot_thunk_valid_inside_the_hook_only(self):
        state, sched = _setup()
        mesh = make_mesh(2, device=CPU)
        seen, thunks = [], []

        def on_chunk(snapshot, next_step):
            seen.append((next_step, snapshot().table.clone()))
            thunks.append(snapshot)

        rate_history_sharded(state, sched, CFG, mesh=mesh, steps_per_chunk=5,
                             on_chunk=on_chunk)
        assert [s for s, _ in seen] == [
            min(s + 5, sched.n_steps) for s in range(0, sched.n_steps, 5)]
        for stop, table in seen[:3]:
            want, _ = rate_history(state, sched, CFG, stop_after=stop,
                                   steps_per_chunk=5)
            assert _same(table, want.table)
        with pytest.raises(RuntimeError, match="after on_chunk returned"):
            thunks[0]()

    def test_one_row_scatter_per_superstep(self, monkeypatch):
        """The sharded scatter goes through ``kernels.row_scatter`` in drop
        mode, once per superstep (its plain version here, on the CPU)."""
        state, sched = _setup()
        calls = []
        real = pmesh.row_scatter

        def counted(table, idx, rows, check=False, mode=None):
            calls.append((tuple(idx.shape), mode))
            return real(table, idx, rows, check=True, mode=mode)

        monkeypatch.setattr(pmesh, "row_scatter", counted)
        got = rate_history_sharded(state, sched, CFG, mesh=make_mesh(4, device=CPU),
                                   steps_per_chunk=13)
        base, _ = rate_history(state, sched, CFG)
        assert _same(got.table, base.table)
        assert len(calls) == sched.n_steps
        assert {mode for _s, mode in calls} == {"drop"}


class TestGuards:
    def _both_raise(self, port_call, jax_call, exc=ValueError) -> str:
        with pytest.raises(exc) as ours:
            port_call()
        with pytest.raises(exc) as theirs:
            jax_call()
        assert str(ours.value) == str(theirs.value)
        return str(ours.value)

    def test_batch_size_divisibility_enforced(self):
        state, sched, jstate, jsched, _s, _js = _both(batch_size=30)
        msg = self._both_raise(
            lambda: rate_history_sharded(state, sched, CFG, mesh=make_mesh(8, device=CPU)),
            lambda: jax_rate_history_sharded(jstate, jsched, JCFG, mesh=jax_make_mesh(8)),
        )
        assert "not divisible" in msg

    def test_pad_row_mismatch_rejected(self):
        state, _sched, jstate, _jsched, stream, jstream = _both()
        bigger = pack_schedule(stream, pad_row=state.pad_row + 8, batch_size=32)
        jbigger = jax_pack_schedule(jstream, pad_row=jstate.pad_row + 8, batch_size=32)
        msg = self._both_raise(
            lambda: rate_history_sharded(state, bigger, CFG, mesh=make_mesh(1, device=CPU)),
            lambda: jax_rate_history_sharded(jstate, jbigger, JCFG, mesh=jax_make_mesh(1)),
        )
        assert "pad_row" in msg

    def test_hand_built_mask_violation_rejected(self):
        state, sched, jstate, jsched, _s, _js = _both()
        mask = sched.slot_mask.copy()
        mask[0, 0, 0, 0] = not mask[0, 0, 0, 0]
        bad = dataclasses.replace(sched, slot_mask=mask, stream=None)
        jbad = dataclasses.replace(jsched, slot_mask=mask, stream=None)
        msg = self._both_raise(
            lambda: rate_history_sharded(state, bad, CFG, mesh=make_mesh(1, device=CPU)),
            lambda: jax_rate_history_sharded(jstate, jbad, JCFG, mesh=jax_make_mesh(1)),
        )
        assert "compact-feed invariant" in msg

    def test_mismatched_routing_rejected(self):
        state, sched, jstate, jsched, _s, _js = _both()
        wrong = build_routing(sched, state.table.shape[0], 4)
        jwrong = jax_build_routing(jsched, jstate.table.shape[0], 4)
        msg = self._both_raise(
            lambda: rate_history_sharded(state, sched, CFG,
                                         mesh=make_mesh(2, device=CPU), routing=wrong),
            lambda: jax_rate_history_sharded(jstate, jsched, JCFG,
                                             mesh=jax_make_mesh(2), routing=jwrong),
        )
        assert "routing was built" in msg

    def test_seed_config_mismatch_rejected(self):
        state, sched, jstate, jsched, _s, _js = _both()
        other = RatingConfig(unknown_player_sigma=CFG.unknown_player_sigma + 1)
        jother = JaxRatingConfig(unknown_player_sigma=JCFG.unknown_player_sigma + 1)
        state = dataclasses.replace(state, seed_cfg=CFG)
        jstate = dataclasses.replace(jstate, seed_cfg=JCFG)
        msg = self._both_raise(
            lambda: rate_history_sharded(state, sched, other, mesh=make_mesh(2, device=CPU)),
            lambda: jax_rate_history_sharded(jstate, jsched, jother, mesh=jax_make_mesh(2)),
        )
        assert "UNKNOWN_PLAYER_SIGMA" in msg

    @pytest.mark.parametrize("kw,text", [
        (dict(collect=True), "collect"),
        (dict(batch_size=9), "not divisible"),
        (dict(kernel="fused"), "kernel='fused'"),
        (dict(hot_rows=8), "hot_rows"),
    ])
    def test_rate_stream_mesh_guards_equal_jax(self, kw, text):
        state, _sched, jstate, _jsched, stream, jstream = _both(
            n_matches=20, n_players=20, batch_size=8, seed=3)
        msg = self._both_raise(
            lambda: rate_stream(state, stream, CFG, mesh=make_mesh(2, device=CPU), **kw),
            lambda: jax_rate_stream(jstate, jstream, JCFG, mesh=jax_make_mesh(2), **kw),
        )
        assert text in msg

    def test_fabric_directory_waits_for_a15(self):
        """``fabric_directory=`` (once refused) wraps the sharded publisher
        for host 0 of the directory's topology: the table is the plain
        run's, the view's host-0 rows equal it, and the directory holds the
        publisher's version; a directory over other shards is refused."""
        from analyzer_tpu_torch.fabric import FabricDirectory, FabricTopology
        from analyzer_tpu_torch.serve import ShardedViewPublisher

        state, sched = _setup(n_matches=20)
        want = rate_history_sharded(state, sched, CFG, mesh=make_mesh(2, device=CPU))
        directory = FabricDirectory(FabricTopology(2, 2))
        pub = ShardedViewPublisher(2, min_publish_interval_s=0.0, device=CPU)
        got = rate_history_sharded(state, sched, CFG, mesh=make_mesh(2, device=CPU),
                                   view_publisher=pub, fabric_directory=directory)
        table = got.table.numpy()
        assert np.array_equal(table, want.table.numpy(), equal_nan=True)
        assert directory.vector() == {0: pub.version} and pub.version >= 1
        view = pub.current().host_table()
        rows = np.arange(0, state.n_players, 2)
        assert np.array_equal(view[rows], table[rows], equal_nan=True)
        with pytest.raises(ValueError, match="must agree"):
            rate_history_sharded(
                state, sched, CFG, mesh=make_mesh(2, device=CPU),
                view_publisher=ShardedViewPublisher(2, device=CPU),
                fabric_directory=FabricDirectory(FabricTopology(4, 2)))

    def test_make_mesh_validation(self):
        with pytest.raises(ValueError, match="at least one shard"):
            make_mesh(0, device=CPU)
        mesh = make_mesh(device=CPU)  # one shard per process
        assert (mesh.n_shards, mesh.world_size, mesh.rank) == (1, 1, 0)
        assert not mesh.distributed
        mesh = make_mesh(6, device=CPU)
        assert (mesh.n_local, list(mesh.local_shards)) == (6, list(range(6)))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                make_mesh(2)

    def test_multihost_degenerate_single_process(self, monkeypatch):
        monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
        assert initialize_distributed() is False
        s = process_slice(100)
        assert (s.start, s.stop) == (0, 100)
        assert_processes_agree("one process", np.arange(3))  # no-op


class TestCounters:
    @pytest.mark.parametrize("n_dev", [1, 2, 4])
    def test_mesh_counters_equal_jax(self, n_dev):
        state, sched, jstate, jsched, _s, _js = _both(windowed=True)
        rate_history_sharded(state, sched, CFG, mesh=make_mesh(n_dev, device=CPU),
                             steps_per_chunk=13)
        jax_rate_history_sharded(jstate, jsched, JCFG, mesh=jax_make_mesh(n_dev),
                                 steps_per_chunk=13)
        ours = obs.get_registry()
        theirs = jobs.get_registry()
        for name in COUNTERS:
            assert ours.counter(name).value == theirs.counter(name).value, name
        assert ours.counter("mesh.puts_total").value == 1 + 6 * -(-sched.n_steps // 13)
        assert ours.counter("mesh.writebacks_avoidable_total").value > 0

    def test_prebuilt_routing_counts_no_reuse(self):
        state, sched, jstate, jsched, _s, _js = _both()
        rate_history_sharded(state, sched, CFG, mesh=make_mesh(2, device=CPU),
                             routing=build_routing(sched, state.table.shape[0], 2))
        jax_rate_history_sharded(jstate, jsched, JCFG, mesh=jax_make_mesh(2),
                                 routing=jax_build_routing(jsched, jstate.table.shape[0], 2))
        for name in COUNTERS:
            assert obs.get_registry().counter(name).value == \
                jobs.get_registry().counter(name).value, name
        assert obs.get_registry().counter("mesh.writebacks_avoidable_total").value == 0


class TestTraining:
    @pytest.fixture(scope="class")
    def data(self):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(1500, 7)).astype(np.float32)
        logit = x @ rng.normal(size=7).astype(np.float32)
        y = (rng.random(1500) < 1 / (1 + np.exp(-logit))).astype(np.float32)
        return x, y

    @pytest.mark.parametrize("n_dev", [2, 4, 8])
    def test_logistic_equals_jax_mesh_training(self, data, n_dev):
        x, y = data
        got, nll = train_logistic(x, y, epochs=10, batch_size=250,
                                  mesh=make_mesh(n_dev, device=CPU), device=CPU)
        want, jnll = jax_train_logistic(x, y, epochs=10, batch_size=250,
                                        mesh=jax_make_mesh(n_dev))
        assert nll == pytest.approx(jnll, rel=W_RTOL)
        np.testing.assert_allclose(got.w.detach().numpy(), np.asarray(want.w),
                                   rtol=W_RTOL, atol=W_ATOL)
        np.testing.assert_allclose(got.b.detach().numpy(), np.asarray(want.b),
                                   rtol=W_RTOL, atol=W_ATOL)

    @pytest.mark.parametrize("fn", [train_logistic, train_mlp],
                             ids=["logistic", "mlp"])
    @pytest.mark.parametrize("n_dev", [3, 8])
    def test_equals_single_device_training(self, data, fn, n_dev):
        """The batch rounds up to a multiple of D (250 -> 252 / 256); the
        single-device run at that size makes the same minibatches."""
        x, y = data
        rounded = -(-250 // n_dev) * n_dev
        want, wnll = fn(x, y, epochs=3, batch_size=rounded, device=CPU)
        got, nll = fn(x, y, epochs=3, batch_size=250,
                      mesh=make_mesh(n_dev, device=CPU), device=CPU)
        assert nll == pytest.approx(wnll, abs=MESH_ATOL)
        for (name, p), (_, q) in zip(got.named_parameters(), want.named_parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                       rtol=0, atol=MESH_ATOL, err_msg=name)
