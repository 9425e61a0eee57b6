"""The port's stream files, checkpoints and command line (``rate``,
``serve``, ``query``) against the JAX package's.

Exact: stream files (CSV bytes and the arrays either package reads from
either package's files), checkpoint layout and cursors, the CLI's flag
checks (exit 2, the same messages), the integer stats (``players_rated``,
``supersteps``, ``occupancy``), and inside the port a kill-and-resume
against a one-shot run, bit for bit. ``mean_mu`` and tables that mix the
two packages' arithmetic carry the float tolerance of
tests/test_torch_fused.py (tests/test_torch_ops.py says why).

``rate --hot-rows`` (the tiered table) equals the untiered run bit for bit
and the JAX package's integer stats; a checkpoint written by either
package serves through ``cli serve`` of the other, and ``cli query`` bodies
equal the in-process engine's answers exactly.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from analyzer_tpu.cli import main as jax_main
from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.core.state import PlayerState as JaxPlayerState
from analyzer_tpu.io import checkpoint as jck
from analyzer_tpu.io import csv_codec as jcodec
from analyzer_tpu.io import synthetic as jsynth
from analyzer_tpu.sched import MatchStream as JaxMatchStream
from analyzer_tpu.sched import pack_schedule as jax_pack_schedule
from analyzer_tpu_torch.cli import main
from analyzer_tpu_torch.io import checkpoint as ck
from analyzer_tpu_torch.io import csv_codec as codec
from analyzer_tpu_torch.io import synthetic
from analyzer_tpu_torch.sched import MatchStream

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM_FIELDS = ("player_idx", "winner", "mode_id", "afk")
RTOL, ATOL = 2e-6, 2e-3
#: ``train --mesh`` against ``train``: the same Adam steps on gradients
#: reduced in another float32 order (tests/test_torch_models.py).
MESH_ATOL = 1e-5


def _stream(n=300, p=50, seed=1, **kw):
    return synthetic.synthetic_stream(n, synthetic.synthetic_players(p, seed=seed),
                                      seed=seed, **kw)


def _write(tmp_path, name="s.csv", **kw):
    path = str(tmp_path / name)
    codec.save_stream(path, _stream(**kw))
    return path


def _run(capsys, *argv) -> dict:
    assert main([*argv, "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _run_jax(capsys, *argv) -> dict:
    assert jax_main(list(argv)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _assert_streams_equal(a, b):
    for f in STREAM_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


class TestCodec:
    @pytest.mark.parametrize("ext", [".csv", ".npz"])
    @pytest.mark.parametrize("kw", [
        dict(), dict(afk_rate=0.3, unsupported_rate=0.2, seed=4),
    ], ids=["plain", "gated"])
    def test_files_cross_packages(self, tmp_path, ext, kw):
        stream = _stream(**kw)
        jstream = JaxMatchStream(*(getattr(stream, f) for f in STREAM_FIELDS))
        port_file, jax_file = str(tmp_path / f"p{ext}"), str(tmp_path / f"j{ext}")
        codec.save_stream(port_file, stream)
        jcodec.save_stream(jax_file, jstream)
        if ext == ".csv":
            with open(port_file, "rb") as f, open(jax_file, "rb") as g:
                assert f.read() == g.read()
        for path in (port_file, jax_file):
            _assert_streams_equal(codec.load_stream(path), jcodec.load_stream(path))
        _assert_streams_equal(codec.load_stream(port_file), stream)

    def test_narrow_teams_and_open_file(self, tmp_path):
        idx = np.full((3, 2, 3), -1, np.int32)
        idx[0, 0, :3], idx[0, 1, :2] = [0, 1, 2], [3, 4]
        idx[1, 0, :1], idx[1, 1, :1] = [5], [6]
        idx[2, 0, :2], idx[2, 1, :3] = [7, 8], [9, 10, 11]
        stream = MatchStream(idx, np.array([0, 1, 1]), np.array([1, -1, 3]),
                             np.array([False, True, False]))
        path = str(tmp_path / "n.csv")
        codec.save_stream_csv(path, stream)
        with open(path, newline="") as f:
            got = codec.load_stream_csv(f)
        _assert_streams_equal(got, stream)
        _assert_streams_equal(got, jcodec.load_stream_csv(path))

    def test_jax_npz_extras_are_ignored(self, tmp_path):
        players = jsynth.synthetic_players(40, seed=2)
        jstream = jsynth.synthetic_stream(50, players, seed=2)
        path = str(tmp_path / "t.npz")
        jcodec.save_stream_npz(
            path, jstream, telemetry=jsynth.synthetic_telemetry(jstream, players, seed=2),
            archetype=players.archetype,
        )
        _assert_streams_equal(codec.load_stream(path), jstream)


class TestCheckpoint:
    def test_port_checkpoint_loads_in_jax(self, tmp_path, capsys):
        csv = _write(tmp_path)
        path = str(tmp_path / "ck.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", path,
             "--checkpoint-every", "3", "--stop-after-steps", "6")
        ours = ck.load_checkpoint(path, device="cpu")
        theirs = jck.load_checkpoint(path)
        assert (theirs.cursor, theirs.step_cursor, theirs.schedule_fingerprint) == (
            ours.cursor, ours.step_cursor, ours.schedule_fingerprint)
        assert ours.step_cursor >= 6 and ours.schedule_fingerprint
        assert theirs.state.seed_cfg == JaxRatingConfig()
        for f in ck._FIELDS:
            assert np.array_equal(np.asarray(getattr(theirs.state, f)),
                                  getattr(ours.state, f).numpy(), equal_nan=True), f
        jpath = str(tmp_path / "jax.npz")
        jck.save_checkpoint(jpath, theirs.state, ours.cursor, ours.step_cursor,
                            ours.schedule_fingerprint)
        with np.load(path) as a, np.load(jpath) as b:
            assert sorted(a.keys()) == sorted(b.keys())
            assert int(a["format_version"]) == int(b["format_version"]) == 4
            for key in a.keys():
                assert a[key].dtype == b[key].dtype, key
                assert np.array_equal(a[key], b[key],
                                      equal_nan=a[key].dtype.kind == "f"), key

    def test_jax_mid_schedule_checkpoint_resumes_in_port(self, tmp_path, capsys):
        """A checkpoint written by the JAX package's ``save_checkpoint``
        (mid-schedule, with the JAX schedule's fingerprint) holding the
        port's state at step 6 resumes to the port's one-shot table."""
        csv = _write(tmp_path)
        full = str(tmp_path / "full.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", full)
        part = str(tmp_path / "part.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", part,
             "--stop-after-steps", "6")
        mid = ck.load_checkpoint(part, device="cpu")
        jstream = jcodec.load_stream(csv)
        fingerprint = jax_pack_schedule(jstream, pad_row=mid.state.pad_row).fingerprint
        jstate = JaxPlayerState(
            **{f: jnp.asarray(getattr(mid.state, f).numpy()) for f in ck._FIELDS},
            seed_cfg=JaxRatingConfig(),
        )
        jpath = str(tmp_path / "jax.npz")
        jck.save_checkpoint(jpath, jstate, cursor=0, step_cursor=mid.step_cursor,
                            schedule_fingerprint=fingerprint)
        stats = _run(capsys, "rate", "--csv", csv, "--checkpoint", jpath, "--resume")
        assert stats["supersteps"] > 0
        a = ck.load_checkpoint(full, device="cpu")
        b = ck.load_checkpoint(jpath, device="cpu")
        assert (b.cursor, b.step_cursor) == (300, 0)
        assert np.array_equal(a.state.table.numpy(), b.state.table.numpy(), equal_nan=True)

    def test_jax_run_resumes_in_port(self, tmp_path, capsys):
        """The JAX CLI's bounded run, resumed by the port: its first steps
        carry the JAX package's arithmetic, so the table is held to the
        cross-package tolerance with the NaN pattern exact."""
        csv = _write(tmp_path)
        jpath = str(tmp_path / "jax.npz")
        _run_jax(capsys, "rate", "--csv", csv, "--checkpoint", jpath,
                 "--checkpoint-every", "3", "--stop-after-steps", "6")
        assert ck.load_checkpoint(jpath, device="cpu").step_cursor >= 6
        _run(capsys, "rate", "--csv", csv, "--checkpoint", jpath, "--resume")
        full = str(tmp_path / "full.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", full)
        a = ck.load_checkpoint(full, device="cpu").state.table.numpy()
        b = ck.load_checkpoint(jpath, device="cpu").state.table.numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)

    def test_writer_is_latest_wins_and_reraises(self, tmp_path):
        from analyzer_tpu_torch.core.state import PlayerState

        state = PlayerState.create(5, device="cpu")
        path = str(tmp_path / "w.npz")
        writer = ck.CheckpointWriter(path)
        for step in (1, 2, 3):
            writer.save(state, cursor=0, step_cursor=step, schedule_fingerprint="f")
        writer.close()
        assert ck.load_checkpoint(path, device="cpu").step_cursor == 3
        bad = ck.CheckpointWriter(str(tmp_path / "missing" / "w.npz"))
        bad.save(state)
        with pytest.raises(FileNotFoundError):
            bad.close()

    def test_unknown_format_refused(self, tmp_path):
        path = str(tmp_path / "v9.npz")
        np.savez(path, format_version=np.int64(9))
        with pytest.raises(ValueError, match="format 9"):
            ck.load_checkpoint(path, device="cpu")


class TestRate:
    @pytest.mark.parametrize("kernel", ["reference", "fused"])
    def test_kill_and_resume_matches_single_run(self, tmp_path, capsys, kernel):
        csv = _write(tmp_path)
        full = str(tmp_path / "full.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", full, "--kernel", kernel)
        part = str(tmp_path / "part.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", part, "--kernel", kernel,
             "--checkpoint-every", "3", "--stop-after-steps", "6")
        mid = ck.load_checkpoint(part, device="cpu")
        assert mid.step_cursor >= 6 and mid.schedule_fingerprint
        stats = _run(capsys, "rate", "--csv", csv, "--checkpoint", part, "--resume",
                     "--kernel", kernel)
        assert stats["supersteps"] > 0
        a = ck.load_checkpoint(full, device="cpu")
        b = ck.load_checkpoint(part, device="cpu")
        assert (b.cursor, b.step_cursor) == (300, 0)
        assert np.array_equal(a.state.table.numpy(), b.state.table.numpy(), equal_nan=True)

    def test_bounded_run_checkpoints_at_stop_and_resume_at_end(self, tmp_path, capsys):
        csv = _write(tmp_path, n=200, p=40)
        path = str(tmp_path / "ck.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", path,
             "--stop-after-steps", "5")
        assert ck.load_checkpoint(path, device="cpu").step_cursor == 5
        _run(capsys, "rate", "--csv", csv, "--checkpoint", path, "--resume")
        stats = _run(capsys, "rate", "--csv", csv, "--checkpoint", path, "--resume")
        assert stats["matches"] == 0

    def test_resume_rejects_changed_schedule(self, tmp_path, capsys):
        csv = _write(tmp_path, n=200, p=40)
        path = str(tmp_path / "ck.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", path,
             "--checkpoint-every", "2", "--stop-after-steps", "4")
        other = _write(tmp_path, name="s2.csv", n=200, p=40, seed=7)
        assert main(["rate", "--csv", other, "--checkpoint", path, "--resume",
                     "--device", "cpu"]) == 2
        assert "no longer matches" in capsys.readouterr().err

    @pytest.mark.parametrize("extra", [(), ("--checkpoint", "ck.npz")],
                             ids=["streamed", "packed"])
    @pytest.mark.parametrize("kw", [dict(), dict(afk_rate=0.3, seed=8)],
                             ids=["plain", "gated"])
    def test_stats_agree_with_jax(self, tmp_path, capsys, extra, kw):
        csv = _write(tmp_path, **kw)
        extra = tuple(str(tmp_path / a) if a.endswith(".npz") else a for a in extra)
        ours = _run(capsys, "rate", "--csv", csv, *extra)
        theirs = _run_jax(capsys, "rate", "--csv", csv, *extra)
        for key in ("matches", "players_rated", "supersteps", "occupancy"):
            assert ours[key] == theirs[key], key
        assert ours["mean_mu"] == pytest.approx(theirs["mean_mu"], abs=0.02)
        assert ("choose_batch_size_s" in ours) == (not extra)
        assert set(ours) == set(theirs)

    @pytest.mark.parametrize("argv", [
        ("--resume",),
        ("--checkpoint-every", "4"),
        ("--checkpoint-every", "0", "--checkpoint", "x.npz"),
        ("--stop-after-steps", "-1"),
        ("--prefetch-depth", "0"),
        ("--fuse-window", "0"),
        ("--hot-rows", "-1"),
        ("--mesh", "-1"),
        ("--mesh", "2", "--kernel", "fused"),
        ("--mesh", "2", "--hot-rows", "8"),
    ])
    def test_flag_errors_match_jax(self, tmp_path, capsys, argv):
        csv = _write(tmp_path, n=10, p=12)
        assert main(["rate", "--csv", csv, *argv, "--device", "cpu"]) == 2
        ours = capsys.readouterr().err.strip()
        assert jax_main(["rate", "--csv", csv, *argv]) == 2
        assert ours == capsys.readouterr().err.strip() != ""

    def test_telemetry_flags_leave_the_run_unchanged(self, tmp_path, capsys):
        """--trace / --metrics-out / --trace-events on a kill-and-resume:
        the checkpoint equals a plain one-shot run's bit for bit, and the
        resumed run's snapshot counts exactly the supersteps it rated."""
        from analyzer_tpu_torch.obs import reset_registry

        csv = _write(tmp_path)
        full = str(tmp_path / "full.npz")
        whole = _run(capsys, "rate", "--csv", csv, "--checkpoint", full)
        part = str(tmp_path / "part.npz")
        obs_args = ("--metrics-out", str(tmp_path / "m.json"),
                    "--trace-events", str(tmp_path / "t.jsonl"),
                    "--trace", str(tmp_path / "cap"))
        _run(capsys, "rate", "--csv", csv, "--checkpoint", part,
             "--checkpoint-every", "3", "--stop-after-steps", "6", *obs_args)
        stop = ck.load_checkpoint(part, device="cpu").step_cursor
        reset_registry()  # the registry is per process: count this run alone
        _run(capsys, "rate", "--csv", csv, "--checkpoint", part, "--resume",
             *obs_args)
        a = ck.load_checkpoint(full, device="cpu")
        b = ck.load_checkpoint(part, device="cpu")
        assert np.array_equal(a.state.table.numpy(), b.state.table.numpy(),
                              equal_nan=True)
        snap = json.load(open(tmp_path / "m.json"))
        assert snap["counters"]["sched.steps_total"] == whole["supersteps"] - stop
        events = [json.loads(ln) for ln in open(tmp_path / "t.jsonl")]
        assert {e["name"] for e in events} >= {"feed.materialize", "batch.compute"}
        assert os.path.isdir(tmp_path / "cap" / "plugins" / "profile")

    def test_missing_csv(self, capsys):
        assert main(["rate", "--device", "cpu"]) == 2
        ours = capsys.readouterr().err.strip()
        assert jax_main(["rate"]) == 2
        assert ours == capsys.readouterr().err.strip()
        assert "exactly one of --csv / --db is required" in ours

    def test_no_card_is_refused_not_run_on_cpu(self, tmp_path, capsys):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible: the default runs on it")
        csv = _write(tmp_path, n=10, p=12)
        assert main(["rate", "--csv", csv]) == 2
        captured = capsys.readouterr()
        assert "CUDA" in captured.err and captured.out == ""
        proc = subprocess.run(
            [sys.executable, "-m", "analyzer_tpu_torch", "rate", "--csv", csv],
            capture_output=True, text=True, timeout=120, cwd=_REPO,
        )
        assert proc.returncode == 2
        assert "CUDA" in proc.stderr and '"players_rated"' not in proc.stdout


class TestRateMesh:
    """``rate --mesh N`` on the CPU: the stats line has the JAX CLI's keys
    (``mesh_devices``, ``processes``) and integer stats, and the table
    equals ``rate``'s bit for bit (the mesh packs at a multiple of
    lcm(8, N); a re-rate's table does not depend on the batch width)."""

    @pytest.mark.parametrize("extra", [(), ("--checkpoint", "ck.npz")],
                             ids=["streamed", "packed"])
    @pytest.mark.parametrize("n", ["1", "2", "4"])
    def test_equals_rate_and_jax_keys(self, tmp_path, capsys, extra, n):
        csv = _write(tmp_path, afk_rate=0.1, seed=3)
        ck_path = str(tmp_path / "ck.npz")
        extra = tuple(ck_path if a == "ck.npz" else a for a in extra)
        want = _run(capsys, "rate", "--csv", csv, *extra)
        want_table = ck.load_checkpoint(ck_path, device="cpu").state.table if extra else None
        got = _run(capsys, "rate", "--csv", csv, "--mesh", n, *extra)
        assert (got["mesh_devices"], got["processes"]) == (int(n), 1)
        for key in ("matches", "players_rated", "mean_mu"):
            assert got[key] == want[key], key
        if extra:
            table = ck.load_checkpoint(ck_path, device="cpu").state.table
            assert np.array_equal(table.numpy(), want_table.numpy(), equal_nan=True)
        jextra = tuple(str(tmp_path / "jck.npz") if a == ck_path else a for a in extra)
        theirs = _run_jax(capsys, "rate", "--csv", csv, "--mesh", n, *jextra)
        assert set(got) == set(theirs)
        for key in ("matches", "players_rated", "supersteps", "occupancy",
                    "mesh_devices", "processes"):
            assert got[key] == theirs[key], key

    def test_kill_and_resume_under_mesh_equals_one_shot(self, tmp_path, capsys):
        csv = _write(tmp_path)
        full, part = str(tmp_path / "full.npz"), str(tmp_path / "part.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", full, "--mesh", "2")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", part, "--mesh", "2",
             "--checkpoint-every", "3", "--stop-after-steps", "6")
        mid = ck.load_checkpoint(part, device="cpu")
        assert mid.step_cursor >= 6 and mid.schedule_fingerprint
        _run(capsys, "rate", "--csv", csv, "--checkpoint", part, "--resume",
             "--mesh", "2")
        a = ck.load_checkpoint(full, device="cpu")
        b = ck.load_checkpoint(part, device="cpu")
        assert (b.cursor, b.step_cursor) == (300, 0)
        assert np.array_equal(a.state.table.numpy(), b.state.table.numpy(),
                              equal_nan=True)

    def test_mid_schedule_resume_on_another_mesh_is_refused_as_jax(self, tmp_path,
                                                                  capsys):
        """The mesh's batch width follows its size (a multiple of lcm(8, D)),
        so a mid-schedule checkpoint belongs to its mesh size; the JAX
        CLI's text."""
        csv = _write(tmp_path, n=400, p=60)
        path = str(tmp_path / "ck.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", path, "--mesh", "2",
             "--checkpoint-every", "2", "--stop-after-steps", "4")
        other = _write(tmp_path, name="o.csv", n=400, p=60, seed=9)
        rc = main(["rate", "--csv", other, "--checkpoint", path, "--resume",
                   "--mesh", "2", "--device", "cpu"])
        ours = capsys.readouterr().err.strip()
        assert rc == 2 and "mesh size changed" in ours
        jpath = str(tmp_path / "jck.npz")
        assert jax_main(["rate", "--csv", csv, "--checkpoint", jpath, "--mesh", "2",
                         "--checkpoint-every", "2", "--stop-after-steps", "4"]) == 0
        capsys.readouterr()
        assert jax_main(["rate", "--csv", other, "--checkpoint", jpath, "--resume",
                         "--mesh", "2"]) == 2
        assert capsys.readouterr().err.strip() == ours


class TestHotRows:
    @pytest.mark.parametrize("extra", [(), ("--checkpoint", "ck.npz")],
                             ids=["streamed", "packed"])
    @pytest.mark.parametrize("kernel", ["reference", "fused"])
    def test_tiered_rate_equals_untiered_and_jax_stats(self, tmp_path, capsys,
                                                       extra, kernel):
        csv = _write(tmp_path, n=400, p=80, seed=4)
        extra = tuple(str(tmp_path / a) if a.endswith(".npz") else a for a in extra)
        base = _run(capsys, "rate", "--csv", csv, "--kernel", kernel, *extra)
        if extra:
            want = ck.load_checkpoint(extra[1], device="cpu").state.table.numpy().copy()
        tiered = _run(capsys, "rate", "--csv", csv, "--kernel", kernel,
                      "--hot-rows", "64", *extra)
        theirs = _run_jax(capsys, "rate", "--csv", csv, "--kernel", kernel,
                          "--hot-rows", "64", *extra)
        for key in ("matches", "players_rated", "mean_mu", "supersteps", "occupancy"):
            assert tiered[key] == base[key], key
        for key in ("matches", "players_rated", "supersteps", "occupancy"):
            assert tiered[key] == theirs[key], key
        assert set(tiered) == set(theirs)
        if extra:
            # the JAX run overwrote the file: compare against the port's
            # untiered table through a fresh tiered run
            _run(capsys, "rate", "--csv", csv, "--kernel", kernel,
                 "--hot-rows", "64", *extra)
            got = ck.load_checkpoint(extra[1], device="cpu").state.table.numpy()
            assert np.array_equal(got, want, equal_nan=True)

    def test_tiered_kill_and_resume(self, tmp_path, capsys):
        csv = _write(tmp_path, n=400, p=80, seed=5)
        a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", a, "--hot-rows", "64",
             "--checkpoint-every", "3", "--stop-after-steps", "6")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", a, "--hot-rows", "128",
             "--resume")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", b)
        assert np.array_equal(
            ck.load_checkpoint(a, device="cpu").state.table.numpy(),
            ck.load_checkpoint(b, device="cpu").state.table.numpy(), equal_nan=True)

    def test_env_default(self, tmp_path, capsys, monkeypatch):
        from analyzer_tpu_torch.cli import build_parser

        monkeypatch.setenv("BENCH_HOT_ROWS", "256")
        assert build_parser().parse_args(["rate", "--csv", "x"]).hot_rows == 256
        monkeypatch.delenv("BENCH_HOT_ROWS")
        assert build_parser().parse_args(["rate", "--csv", "x"]).hot_rows == 0


def _serve_process(module: str, *argv):
    """``python -m <module> serve ...`` as a subprocess; returns it with the
    JSON line it printed once it was serving."""
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "serve", *argv, "--port", "0",
         "--max-seconds", "120"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=_REPO,
    )
    line = ""
    while not line.startswith('{"serving"'):
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"serve exited {proc.wait()}: {proc.stderr.read()}")
    return proc, json.loads(line)


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    finally:
        proc.kill()
        proc.stdout.close()
        proc.stderr.close()


_QUERIES = [
    ("leaderboard", "--k", "7"),
    ("ratings", "--ids", "1,2,3,999,x"),
    ("winprob", "--a", "1,2", "--b", "3,4,5"),
    ("tiers",),
    ("tiers", "--score", "-250.5"),
]


def _answers(engine) -> list:
    pct = engine.percentile(-250.5)
    tiers = engine.tier_histogram()
    return [
        engine.leaderboard(7),
        engine.get_ratings(["1", "2", "3", "999", "x"]),
        engine.win_probability(["1", "2"], ["3", "4", "5"]),
        tiers,
        {**tiers, "percentile": pct["percentile"], "score": pct["score"],
         "below": pct["below"]},
    ]


class TestServeAndQuery:
    def _query(self, capsys, url, *argv, rc=0):
        capsys.readouterr()
        assert main(["query", *argv, "--url", url]) == rc
        return capsys.readouterr()

    def test_round_trip_on_a_jax_checkpoint(self, tmp_path, capsys):
        """``cli rate --checkpoint`` of the JAX package -> the port's ``cli
        serve --device cpu`` -> ``cli query``: every body equals the JAX
        engine's answer on the same checkpoint."""
        from analyzer_tpu.serve import QueryEngine as JaxEngine
        from analyzer_tpu.serve import ViewPublisher as JaxPublisher

        csv = _write(tmp_path, n=400, p=80, seed=6)
        path = str(tmp_path / "jax.npz")
        _run_jax(capsys, "rate", "--csv", csv, "--checkpoint", path)
        pub = JaxPublisher()
        pub.publish_state(jck.load_checkpoint(path).state)
        want = _answers(JaxEngine(pub, cfg=JaxRatingConfig.from_env()))
        proc, info = _serve_process("analyzer_tpu_torch.cli", "--checkpoint", path,
                                    "--device", "cpu")
        try:
            assert info == {"serving": info["serving"], "players": 80, "version": 1,
                            "shards": 1, "source": path}
            for argv, expect in zip(_QUERIES, want):
                out = self._query(capsys, info["serving"], *argv)
                assert json.loads(out.out) == expect, argv
            bad = self._query(capsys, info["serving"], "winprob", "--a", "1",
                              "--b", "nobody", rc=1)
            assert json.loads(bad.out) == {"error": "unknown player id(s): nobody"}
            assert "HTTP 404" in bad.err
            bad = self._query(capsys, info["serving"], "leaderboard", "--k", "0", rc=1)
            assert "HTTP 400" in bad.err
        finally:
            _stop(proc)

    def test_port_checkpoint_serves_from_the_jax_package(self, tmp_path, capsys):
        """The other way: the port's checkpoint through the JAX package's
        ``cli serve``, queried by the port's ``cli query``; bodies equal
        the port engine's answers."""
        from analyzer_tpu_torch.config import RatingConfig
        from analyzer_tpu_torch.serve import QueryEngine, ViewPublisher

        csv = _write(tmp_path, n=400, p=80, seed=7)
        path = str(tmp_path / "port.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", path, "--hot-rows", "64")
        pub = ViewPublisher(device="cpu")
        pub.publish_state(ck.load_checkpoint(path, device="cpu").state)
        want = _answers(QueryEngine(pub, cfg=RatingConfig.from_env(), device="cpu"))
        proc, info = _serve_process("analyzer_tpu.cli", "--checkpoint", path)
        try:
            assert info["players"] == 80
            for argv, expect in zip(_QUERIES, want):
                out = self._query(capsys, info["serving"], *argv)
                assert json.loads(out.out) == expect, argv
        finally:
            _stop(proc)

    def test_query_flag_errors_and_dead_endpoint(self, capsys):
        url = "http://127.0.0.1:9"
        assert main(["query", "ratings", "--url", url]) == 2
        assert "ratings needs --ids" in capsys.readouterr().err
        assert main(["query", "winprob", "--a", "1", "--url", url]) == 2
        assert "winprob needs --a ids and --b ids" in capsys.readouterr().err
        assert main(["query", "tiers", "--url", url, "--timeout", "2"]) == 1
        assert capsys.readouterr().err.startswith("error: http://127.0.0.1:9/v1/tiers")

    @pytest.mark.parametrize("argv,text", [
        ((), "exactly one of --checkpoint / --db is required"),
        (("--checkpoint", "a.npz", "--db", "sqlite:///x.db"),
         "exactly one of --checkpoint / --db is required"),
        (("--checkpoint", "a.npz", "--shards", "0"), "--shards must be >= 1"),
        (("--db", "sqlite:///x.db", "--shards", "-2"), "--shards must be >= 1"),
        (("--shards", "2", "--all-gather-topk"),
         "exactly one of --checkpoint / --db is required"),
    ])
    def test_serve_refusals(self, capsys, argv, text):
        assert main(["serve", *argv, "--device", "cpu"]) == 2
        captured = capsys.readouterr()
        assert text in captured.err and captured.out == ""

    def test_serve_without_a_card_is_refused(self, tmp_path, capsys):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible: the default serves from it")
        csv = _write(tmp_path, n=10, p=12)
        path = str(tmp_path / "ck.npz")
        _run(capsys, "rate", "--csv", csv, "--checkpoint", path)
        assert main(["serve", "--checkpoint", path]) == 2
        captured = capsys.readouterr()
        assert "CUDA" in captured.err and "serving" not in captured.out


# -- the model zoo's verbs: synth --telemetry, elo, train, quality ----------
#
# Exact: the npz telemetry / archetype blocks either package writes and
# reads, every flag error (exit 2, JAX's text), the JSON keys, and the
# integer fields. Continuous floats in the JSON lines (log-loss, AUC, NLL,
# temperature; rounded by both CLIs) are within ``JSON_ATOL``: the
# features and weights behind them differ by the tolerances of
# tests/test_torch_models.py (~1e-6). Accuracy and ECE count predictions
# on either side of a threshold (0.5, a bin edge): a prediction within
# ~1e-6 of one may land on the other side in the other package and move
# the metric by 1/eval_on, so they are within ``FLIPS``/eval_on. The
# port's MLP starts from its own seeded weights (init_mlp, ROADMAP Queue
# C), so its head metrics are not compared; the rating-only baseline is.

JSON_ATOL = 2e-3
FLIPS = 3


def _model_stream(tmp_path, capsys, name="m.npz", telemetry=True):
    path = str(tmp_path / name)
    argv = ["synth", "--matches", "2000", "--players", "300", "--seed", "5",
            "--max-share", "0.01", "--out", path]
    assert jax_main(argv + (["--telemetry"] if telemetry else [])) == 0
    capsys.readouterr()
    return path


def _assert_json_close(ours: dict, theirs: dict, n_eval=None, path=""):
    assert set(ours) == set(theirs), path
    n_eval = ours.get("eval_on", n_eval)
    for k, v in ours.items():
        w = theirs[k]
        if k == "phases":
            assert set(v) == set(w)
        elif isinstance(v, dict) and isinstance(w, dict):
            _assert_json_close(v, w, n_eval, f"{path}.{k}")
        elif isinstance(v, float) or isinstance(w, float):
            counted = k.endswith(("accuracy", "ece"))
            tol = FLIPS / n_eval + 1e-4 if counted and n_eval else JSON_ATOL
            assert v == pytest.approx(w, abs=tol), f"{path}.{k}"
        else:
            assert v == w, f"{path}.{k}"


class TestTelemetryBlocks:
    def test_blocks_cross_packages(self, tmp_path):
        players = synthetic.synthetic_players(40, seed=2)
        stream = synthetic.synthetic_stream(60, players, seed=2)
        tel = synthetic.synthetic_telemetry(stream, players, seed=2)
        jstream = JaxMatchStream(*(getattr(stream, f) for f in STREAM_FIELDS))
        port_file, jax_file = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
        codec.save_stream(port_file, stream, telemetry=tel,
                          archetype=players.archetype)
        jcodec.save_stream(jax_file, jstream, telemetry=tel,
                           archetype=players.archetype)
        for path in (port_file, jax_file):
            for load, jload in ((codec.load_telemetry, jcodec.load_telemetry),
                                (codec.load_archetypes, jcodec.load_archetypes)):
                got, want = load(path), jload(path)
                assert got.dtype == want.dtype and np.array_equal(got, want)
        with np.load(port_file) as a, np.load(jax_file) as b:
            assert sorted(a.files) == sorted(b.files)
            assert all(a[f].tobytes() == b[f].tobytes() for f in a.files)
        plain = str(tmp_path / "plain.npz")
        codec.save_stream_npz(plain, stream)
        assert codec.load_telemetry(plain) is None
        assert codec.load_archetypes(plain) is None
        assert codec.load_telemetry(str(tmp_path / "x.csv")) is None

    def test_errors_equal_jax(self, tmp_path):
        players = synthetic.synthetic_players(20, seed=1)
        stream = synthetic.synthetic_stream(30, players, seed=1)
        jstream = JaxMatchStream(*(getattr(stream, f) for f in STREAM_FIELDS))
        bad = np.zeros((30, 2, 5, 5), np.float32)
        for save, s in ((codec.save_stream_npz, stream),
                        (jcodec.save_stream_npz, jstream)):
            with pytest.raises(ValueError) as err:
                save(str(tmp_path / "b.npz"), s, telemetry=bad)
            assert "does not match the stream's (30, 2, 5, 6)" in str(err.value)
        for save, s in ((codec.save_stream, stream), (jcodec.save_stream, jstream)):
            with pytest.raises(ValueError, match="telemetry requires the .npz"):
                save(str(tmp_path / "b.csv"), s, telemetry=bad)


class TestModelsCli:
    def test_elo_equals_jax(self, tmp_path, capsys):
        path = _model_stream(tmp_path, capsys, telemetry=False)
        out, jout = str(tmp_path / "elo.npz"), str(tmp_path / "jelo.npz")
        ours = _run(capsys, "elo", "--csv", path, "--out", out)
        theirs = _run_jax(capsys, "elo", "--csv", path, "--out", jout)
        assert set(ours["phases"]) == set(theirs["phases"]) == {"load", "pack", "rate"}
        _assert_json_close(ours, theirs, n_eval=2000)
        with np.load(out) as a, np.load(jout) as b:
            assert sorted(a.files) == sorted(b.files) == ["expected", "ratings"]
            np.testing.assert_allclose(a["ratings"], b["ratings"], atol=2e-3)
            np.testing.assert_allclose(a["expected"], b["expected"], atol=1e-5)

    @pytest.mark.parametrize("argv", [
        ("--model", "logistic", "--epochs", "20", "--seed", "2"),
        ("--model", "mlp", "--hidden", "16", "--epochs", "10", "--telemetry",
         "--eval-frac", "0.3"),
    ], ids=["logistic", "mlp-telemetry"])
    def test_train_equals_jax(self, tmp_path, capsys, argv):
        from analyzer_tpu_torch.models import model_from_numpy

        path = _model_stream(tmp_path, capsys)
        out, jout = str(tmp_path / "w.npz"), str(tmp_path / "jw.npz")
        ours = _run(capsys, "train", "--csv", path, *argv, "--out", out)
        theirs = _run_jax(capsys, "train", "--csv", path, *argv, "--out", jout)
        assert set(ours["phases"]) == {"load", "features", "train"}
        assert ours["composition_features"] is True
        kind = ours["model"]
        if kind == "mlp":  # different initial weights: the head differs
            head = ("train_nll", "eval_accuracy", "eval_logloss", "eval_auc",
                    "eval_ece", "temperature")
            for k in head:
                assert np.isfinite(ours[k]) and set(ours) == set(theirs)
                ours[k] = theirs[k]
        _assert_json_close(ours, theirs)
        with np.load(out) as a, np.load(jout) as b:
            assert sorted(a.files) == sorted(b.files)
            assert str(a["model"]) == str(b["model"]) == kind
            # Each package's file loads into the port's model.
            m = model_from_numpy(kind, dict(a), device="cpu")
            jm = model_from_numpy(kind, dict(b), device="cpu")
            for (name, p), (_, q) in zip(m.named_parameters(), jm.named_parameters()):
                assert p.shape == q.shape and p.dtype == q.dtype, name
                if kind == "logistic":
                    np.testing.assert_allclose(p.detach().numpy(),
                                               q.detach().numpy(),
                                               rtol=1e-4, atol=1e-5, err_msg=name)

    @pytest.mark.parametrize("argv", [
        ("--eval-frac", "1.0"),
        ("--eval-frac", "-0.1"),
        ("--db", "sqlite:///x.db"),
        (),
        ("--db", "sqlite:///x.db", "--telemetry"),
    ])
    def test_train_flag_errors_equal_jax(self, tmp_path, capsys, argv):
        path = _model_stream(tmp_path, capsys, telemetry=False)
        src = ("--csv", path) if argv != () and "--db" not in argv else ()
        if argv == ("--db", "sqlite:///x.db"):
            src = ("--csv", path)  # both sources: refused
        assert main(["train", *src, *argv, "--device", "cpu"]) == 2
        ours = capsys.readouterr().err.strip()
        assert jax_main(["train", *src, *argv]) == 2
        assert ours == capsys.readouterr().err.strip() != ""

    def test_train_telemetry_without_block_equals_jax(self, tmp_path, capsys):
        path = _model_stream(tmp_path, capsys, telemetry=False)
        assert main(["train", "--csv", path, "--telemetry", "--device", "cpu"]) == 2
        ours = capsys.readouterr().err.strip()
        assert jax_main(["train", "--csv", path, "--telemetry"]) == 2
        assert ours == capsys.readouterr().err.strip()
        assert "synth --telemetry" in ours

    def test_mesh_exits_2_naming_a14_after_jax_checks(self, tmp_path, capsys):
        """``train --mesh`` is ported: ``--mesh 2`` trains data-parallel
        and its weights and metrics equal ``--mesh`` unset within
        ``MESH_ATOL`` (float32 reduction order); JAX's flag checks still
        come first, with their texts."""
        from analyzer_tpu_torch.models import model_from_numpy

        path = _model_stream(tmp_path, capsys, telemetry=False)
        runs = {}
        for mesh in ((), ("--mesh", "2")):
            out = str(tmp_path / f"w{len(mesh)}.npz")
            stats = _run(capsys, "train", "--csv", path, "--epochs", "5",
                         "--out", out, *mesh)
            with np.load(out) as f:
                runs[mesh] = (stats, model_from_numpy("logistic", dict(f),
                                                      device="cpu"))
        (single, m1), (meshed, m2) = runs[()], runs[("--mesh", "2")]
        assert set(single) == set(meshed)
        for key in ("train_nll", "eval_logloss"):
            assert meshed[key] == pytest.approx(single[key], abs=MESH_ATOL)
        for p, q in zip(m1.parameters(), m2.parameters()):
            np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                       rtol=0, atol=MESH_ATOL)
        assert main(["train", "--csv", path, "--mesh", "2", "--eval-frac", "2",
                     "--device", "cpu"]) == 2
        assert capsys.readouterr().err.strip() == "error: --eval-frac must be in [0, 1)"

    @pytest.mark.parametrize("verb", ["elo", "train"])
    def test_no_card_is_refused(self, tmp_path, capsys, verb):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible: the default runs on it")
        path = _model_stream(tmp_path, capsys, telemetry=False)
        assert main([verb, "--csv", path]) == 2
        captured = capsys.readouterr()
        assert "CUDA" in captured.err and captured.out == ""

    def test_db_lane_equals_jax(self, tmp_path, capsys):
        from tests.test_torch_sql_store import synth_db

        db = synth_db(str(tmp_path / "h.db"), n=1200, p=200)
        for verb in ("elo", "train"):
            ours = _run(capsys, verb, "--db", f"sqlite:///{db}")
            theirs = _run_jax(capsys, verb, "--db", f"sqlite:///{db}")
            _assert_json_close(ours, theirs, n_eval=1200)


def _scored_ledgers():
    """One port and one JAX ledger over the same seeded batches."""
    from analyzer_tpu.config import RatingConfig as JRC
    from analyzer_tpu.obs import quality as jq
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.obs import quality as q

    rng = np.random.default_rng(8)
    ours = q.CalibrationLedger(RatingConfig(), mirror=False)
    theirs = jq.CalibrationLedger(JRC(), mirror=False)
    table = np.full((201, 16), np.nan, np.float32)
    table[:, 14] = rng.uniform(1000, 2500, 201)
    table[:, 15] = rng.uniform(300, 900, 201)
    table[:150, 0] = rng.uniform(500, 2500, 150)
    table[:150, 7] = rng.uniform(50, 600, 150)
    idx = np.stack([rng.permutation(200)[:6] for _ in range(400)])
    idx = idx.reshape(400, 2, 3).astype(np.int32)
    args = (table, idx, rng.integers(0, 2, 400).astype(np.int32),
            rng.integers(0, 6, 400).astype(np.int32), np.zeros(400, bool))
    ours.score_batch(*args, pad_row=200)
    theirs.score_batch(*args, pad_row=200)
    ours.observe_population(table, now=3.0)
    theirs.observe_population(table, now=3.0)
    return (q, ours), (jq, theirs)


class TestQualityCli:
    @pytest.mark.parametrize("argv", [("--json",), (), ("--json", "--fit-temperature"),
                                      ("--fit-temperature",)])
    def test_live_ledger_equals_jax(self, capsys, argv):
        (q, ours), (jq, theirs) = _scored_ledgers()
        try:
            q.set_quality_ledger(ours)
            jq.set_quality_ledger(theirs)
            assert main(["quality", *argv]) == 0
            got = capsys.readouterr().out
            assert jax_main(["quality", *argv]) == 0
            assert got == capsys.readouterr().out
        finally:
            q.reset_quality_ledger()
            jq.reset_quality_ledger()
        if "--json" in argv:
            summary = json.loads(got)
            assert summary["matches_scored"] == 400
            if "--fit-temperature" in argv:
                assert set(summary["temperature"]) == {"t", "nll_before", "nll_after", "n"}

    def test_empty_process_ledger_equals_jax(self, capsys):
        for argv in (("--json",), ("--fit-temperature",)):
            rc = main(["quality", *argv])
            got = capsys.readouterr()
            assert rc == jax_main(["quality", *argv])
            want = capsys.readouterr()
            assert (got.out, got.err) == (want.out, want.err)

    def test_artifact_and_url_equal_jax(self, tmp_path, capsys):
        import http.server
        import threading

        (_q, ours), _ = _scored_ledgers()
        summary = ours.summary()
        art = str(tmp_path / "SOAK_r01.json")
        json.dump({"quality": summary}, open(art, "w"))
        bare = str(tmp_path / "bare.json")
        json.dump({"other": 1}, open(bare, "w"))
        bodies = {"/qualityz": summary, "/off/qualityz": {"enabled": False}}

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = json.dumps(bodies.get(self.path, {})).encode()
                self.send_response(200 if self.path in bodies else 404)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            for argv in (("--artifact", art), ("--artifact", art, "--json"),
                         ("--artifact", bare), ("--artifact", str(tmp_path / "no.json")),
                         ("--url", url), ("--url", url + "/", "--json"),
                         ("--url", url + "/off"), ("--url", url, "--fit-temperature")):
                rc = main(["quality", *argv])
                got = capsys.readouterr()
                assert rc == jax_main(["quality", *argv]), argv
                want = capsys.readouterr()
                assert (got.out, got.err) == (want.out, want.err), argv
        finally:
            srv.shutdown()
            srv.server_close()
