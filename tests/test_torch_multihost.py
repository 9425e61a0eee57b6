"""The port's mesh across REAL processes: ``torch.distributed`` over gloo.

Each case starts ``world`` interpreters of this file (its ``__main__`` is
the worker), each given the rendezvous address of a free local port, its
rank and a timeout; every worker destroys its process group on the way
out. The workers build the SAME deterministic history, run the sharded
re-rate with the prior assembly's ``all_reduce`` crossing the process
boundary, and check it BIT FOR BIT against the single-device port run —
the whole table, padding row included — eager and windowed, with a
periodic-snapshot hook that every rank evaluates (a collective). They also
check that ``assert_processes_agree`` catches an input poisoned on one rank
on every rank, that ``make_mesh`` refuses a shard count the processes do
not divide, that a per-shard view publisher is refused on a multi-process
mesh, and that data-parallel training equals single-device training within
``MESH_ATOL`` (tests/test_torch_models.py). Runs at 2, 4 and 8 ranks print
the same table digest as the parent's single-device run. ``cli rate --mesh 0``
in two processes writes the checkpoint ``cli rate`` writes alone.

The fabric seam (``rate_history_sharded(fabric_directory=)``) across two
processes. JAX's branch wraps the publisher for host
``jax.process_index()`` of a ``FabricTopology(D, 2)``, and its filter
keeps the patches of the shards that host OWNS, ``s % 2 == host``: at
D = 2, process 0 publishes shard 0 and process 1 shard 1; at D = 4,
process 0 publishes shards 0 and 2, process 1 shards 1 and 3. What a
process HOLDS is another set: D / 2 consecutive shards (process 0 holds 0
and 1 at D = 4), in JAX's global mesh and in the port's. So at D = 4 a
process owns a shard it does not hold (JAX's ``publish_views`` then
indexes a block that is not addressable in that process; its own test
only ever runs one process with ``process_count`` patched). The port
keeps JAX's ownership and gathers every shard's block for the publish.
Each rank here asserts the same sets as JAX's filter: the rows of the
shards it owns equal the final table bit for bit, the rows of the others
hold the table of the first publish (the rebuild every first publish
makes, tests/test_torch_fabric.py), and its directory records its own
version only.
"""

import functools
import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
MESH_ATOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # several interpreters share the cores
    return env


def _launch(argvs, env_of=lambda rank: {}) -> list:
    """Runs one subprocess per argv (rank order), all at once; returns
    their (returncode, stdout, stderr), killing every one on a timeout."""
    procs = [
        subprocess.Popen(argv, cwd=REPO, env={**_env(), **env_of(rank)},
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for rank, argv in enumerate(argvs)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@functools.lru_cache(maxsize=None)
def _workers(world: int, n_shards: int) -> list[dict]:
    """Each rank's report of one run at (world, n_shards); a run is made
    once per session and shared by the cases that read it."""
    addr = f"127.0.0.1:{_free_port()}"
    outs = _launch([
        [sys.executable, os.path.abspath(__file__), addr, str(rank), str(world),
         str(n_shards)]
        for rank in range(world)
    ])
    results = []
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out}\n{err}"
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def _digest(table: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(table).tobytes()).hexdigest()


def _history():
    """The workers' deterministic history (every rank builds it)."""
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream

    players = synthetic_players(50, seed=19)
    stream = synthetic_stream(150, players, seed=19, afk_rate=0.1)
    state = PlayerState.create(
        50, players.rank_points_ranked, players.rank_points_blitz,
        players.skill_tier, device="cpu",
    )
    return stream, state


@functools.lru_cache(maxsize=None)
def _single_digest() -> str:
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.sched import pack_schedule, rate_history

    stream, state = _history()
    sched = pack_schedule(stream, pad_row=state.pad_row, batch_size=16)
    base, _ = rate_history(state, sched, RatingConfig())
    return _digest(base.table.numpy())


class TestGlooProcesses:
    def test_two_processes_two_shards_each_bit_identical(self):
        results = _workers(world=2, n_shards=4)
        for r in results:
            assert r["eager"] and r["windowed"] and r["snapshots"]
            assert r["digest"] == _single_digest()

    def test_poisoned_input_caught_on_every_rank(self):
        results = _workers(world=2, n_shards=2)
        assert [r["poison_caught"] for r in results] == [True, True]
        assert all(r["indivisible_refused"] and r["publisher_refused"]
                   for r in results)

    @pytest.mark.parametrize("world", [2, 4, 8])
    def test_ranks_bit_identical(self, world):
        """One shard a rank at 2, 4 and 8 ranks: every rank's table digest
        is the single-device run's."""
        results = _workers(world=world, n_shards=world)
        assert [r["rank"] for r in results] == list(range(world))
        assert {r["digest"] for r in results} == {_single_digest()}

    @pytest.mark.parametrize("n_shards", [2, 4])
    def test_fabric_publisher_owned_shards(self, n_shards):
        """Rank r publishes the shards ``s % 2 == r`` (JAX's ownership),
        whatever shards it holds; see the module docstring."""
        results = _workers(world=2, n_shards=n_shards)
        for r in results:
            fab = r["fabric"]
            assert fab["owned"] == [s for s in range(n_shards) if s % 2 == r["rank"]]
            assert fab["owned_rows_final"] and fab["foreign_rows_first_publish"]
            assert fab["vector"] == {str(r["rank"]): fab["version"]}

    def test_training_all_reduce_equals_single_device(self):
        results = _workers(world=2, n_shards=2)
        for r in results:
            assert r["train_max_abs"] <= MESH_ATOL
        assert results[0]["train_w"] == results[1]["train_w"]  # same replica

    def test_cli_rate_mesh_0_across_processes(self, tmp_path):
        """``cli rate --mesh 0`` with the JAX package's env in two gloo
        processes: rank 0 writes the checkpoint and the stats line, which
        equal ``cli rate``'s alone (tables bit for bit)."""
        from analyzer_tpu_torch.io.checkpoint import load_checkpoint
        from analyzer_tpu_torch.io.csv_codec import save_stream

        stream, _state = _history()
        path = str(tmp_path / "s.csv")
        save_stream(path, stream)
        one, mesh = str(tmp_path / "one.npz"), str(tmp_path / "mesh.npz")
        cli = [sys.executable, "-m", "analyzer_tpu_torch.cli", "rate", "--csv",
               path, "--device", "cpu"]
        [(rc, out, err)] = _launch([cli + ["--checkpoint", one]])
        assert rc == 0, err
        want = json.loads(out.strip().splitlines()[-1])
        addr = f"127.0.0.1:{_free_port()}"
        outs = _launch(
            [cli + ["--checkpoint", mesh, "--mesh", "0"]] * 2,
            env_of=lambda rank: {"COORDINATOR_ADDRESS": addr,
                                 "NUM_PROCESSES": "2", "PROCESS_ID": str(rank)},
        )
        for rank, (rc, out, err) in enumerate(outs):
            assert rc == 0, f"rank {rank}: {err}"
        got = json.loads(outs[0][1].strip().splitlines()[-1])
        assert not [ln for ln in outs[1][1].splitlines() if ln.startswith("{")]
        assert (got["mesh_devices"], got["processes"]) == (2, 2)
        for key in ("matches", "players_rated", "mean_mu"):
            assert got[key] == want[key], key
        a = load_checkpoint(one, device="cpu").state.table.numpy()
        b = load_checkpoint(mesh, device="cpu").state.table.numpy()
        assert np.array_equal(a, b, equal_nan=True)


def _worker(addr: str, rank: int, world: int, n_shards: int) -> dict:
    import torch
    import torch.distributed as dist

    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.models import train_logistic
    from analyzer_tpu_torch.parallel import (
        assert_processes_agree,
        initialize_distributed,
        make_mesh,
        rate_history_sharded,
    )
    from analyzer_tpu_torch.sched import pack_schedule, rate_history
    from analyzer_tpu_torch.serve import ShardedViewPublisher

    torch.set_num_threads(1)
    assert initialize_distributed(addr, world, rank, device="cpu")
    try:
        assert dist.get_world_size() == world and dist.get_backend() == "gloo"
        cfg = RatingConfig()
        stream, state = _history()
        out = {"rank": rank}
        assert_processes_agree("worker inputs", stream.player_idx, stream.winner)
        poisoned = stream.winner.copy()
        if rank == world - 1:
            poisoned[0] ^= 1
        try:
            assert_processes_agree("poisoned", poisoned)
            out["poison_caught"] = False
        except RuntimeError as err:
            out["poison_caught"] = "host inputs differ across processes" in str(err)
        try:
            make_mesh(world + 1, device="cpu")
            out["indivisible_refused"] = False
        except ValueError:
            out["indivisible_refused"] = True

        mesh = make_mesh(n_shards, device="cpu")
        assert mesh.distributed and mesh.n_local == n_shards // world
        sched = pack_schedule(stream, pad_row=state.pad_row, batch_size=16)
        base, _ = rate_history(state, sched, cfg)
        want = base.table.numpy()
        snaps = []

        def on_chunk(snapshot, next_step):
            if next_step % 14 == 0:  # a pure function of next_step
                snaps.append(np.array_equal(
                    snapshot().table.numpy(),
                    rate_history(state, sched, cfg, stop_after=next_step,
                                 steps_per_chunk=7)[0].table.numpy(),
                    equal_nan=True,
                ))

        got = rate_history_sharded(state, sched, cfg, mesh=mesh,
                                   steps_per_chunk=7, on_chunk=on_chunk)
        out["eager"] = np.array_equal(got.table.numpy(), want, equal_nan=True)
        out["snapshots"] = bool(snaps) and all(snaps)
        wsched = pack_schedule(stream, pad_row=state.pad_row, batch_size=16,
                               windowed=True)
        got_w = rate_history_sharded(state, wsched, cfg, mesh=mesh, steps_per_chunk=7)
        out["windowed"] = np.array_equal(got_w.table.numpy(), want, equal_nan=True)
        out["digest"] = _digest(got_w.table.numpy())
        try:
            rate_history_sharded(state, sched, cfg, mesh=mesh,
                                 view_publisher=ShardedViewPublisher(n_shards, device="cpu"))
            out["publisher_refused"] = False
        except ValueError as err:
            out["publisher_refused"] = "multi-process mesh" in str(err)

        out["fabric"] = _fabric_seam(state, sched, cfg, mesh, rank, world)

        rng = np.random.default_rng(5)
        x = rng.normal(size=(600, 5)).astype(np.float32)
        y = (rng.random(600) < 0.5).astype(np.float32)
        single, _ = train_logistic(x, y, epochs=3, batch_size=128, device="cpu")
        meshed, _ = train_logistic(x, y, epochs=3, batch_size=128, mesh=mesh,
                                   device="cpu")
        out["train_max_abs"] = float((meshed.w - single.w).abs().max())
        out["train_w"] = meshed.w.detach().numpy().tolist()
        return out
    finally:
        dist.destroy_process_group()


def _fabric_seam(state, sched, cfg, mesh, rank: int, world: int) -> dict:
    """``rate_history_sharded(fabric_directory=)`` on this rank, publishing
    after every chunk of 7 steps: which rows of the published view equal
    the final table and which the first publish's."""
    from analyzer_tpu_torch.fabric import FabricDirectory, FabricTopology
    from analyzer_tpu_torch.parallel import rate_history_sharded
    from analyzer_tpu_torch.sched import rate_history
    from analyzer_tpu_torch.serve import ShardedViewPublisher

    d = mesh.n_shards
    directory = FabricDirectory(FabricTopology(d, world))
    pub = ShardedViewPublisher(d, min_publish_interval_s=0.0, device="cpu")
    final = rate_history_sharded(state, sched, cfg, mesh=mesh, steps_per_chunk=7,
                                 view_publisher=pub, fabric_directory=directory)
    first = rate_history(state, sched, cfg, stop_after=7)[0].table.numpy()
    got, ft = pub.current().host_table(), final.table.numpy()
    owned = [s for s in range(d) if s % world == rank]
    rows = range(state.n_players)
    return {
        "owned": owned,
        "owned_rows_final": all(
            np.array_equal(got[r], ft[r], equal_nan=True)
            for r in rows if r % d in owned),
        "foreign_rows_first_publish": all(
            np.array_equal(got[r], first[r], equal_nan=True)
            for r in rows if r % d not in owned),
        "version": pub.version,
        "vector": {str(h): v for h, v in directory.vector().items()},
    }


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    print(json.dumps(_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                             int(sys.argv[4]))), flush=True)
