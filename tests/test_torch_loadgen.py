"""The port's closed-loop soak (``analyzer_tpu_torch.loadgen``) against the
JAX package's (``analyzer_tpu.loadgen``) part by part, and its own
determinism contract.

Against the JAX package:

  * ``VirtualClock`` / ``TrafficShaper`` / ``choose_kind``: exactly the same
    counts and draws;
  * ``OutcomeModel``: win probabilities within 1e-12 relative (both are
    float64 host math; in practice they are equal) and the same resolutions
    on the test seeds;
  * ``Matchmaker``: the same formations, field for field, when both read
    the same stub ratings;
  * the whole soak: measured on three seeds (3 to 8 virtual seconds, 80 to
    400 players, in-process queries), every formed pairing — mode, teams,
    split — is JAX's, and every value of the ``deterministic`` block other
    than the two digests equals JAX's (counts, versions, lags, depths,
    trajectory). The digests differ: they hash the SERVED win probability
    and match quality, which the port computes in float32 with its own
    erf / exp and sum order (tests/test_torch_ops.py), 1-2 ulp away from
    JAX's (at most 2.4e-7 on those seeds). So the port's block is not
    byte-equal to JAX's for the same seed; the test below holds the parts.

Inside the port, the ``deterministic`` block is BIT-IDENTICAL run to run,
with the queries in-process or over HTTP, across ``broker_partitions`` 1 /
4 (with priority lanes), ``serve_shards`` 1 / 4, and with the migration on
or off (which also cuts over a migrated lineage equal to its from-scratch
reference), and with the queries through the serve front door
(``serve_http``). ``cli soak`` exits 0 with the JAX artifact's shape; ``cli
soak --hosts`` runs the fabric soak and ``--serve-http`` the front door.
The port has nothing jitted, so ``retraces_steady`` is always 0 and the
flat-retrace objective passes trivially.

Everything runs on the CPU (``device="cpu"``) at a few virtual seconds.
"""

import dataclasses
import json

import numpy as np
import pytest

import analyzer_tpu.loadgen as jloadgen
from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.io import synthetic as jsynth
from analyzer_tpu.loadgen import shaper as jshaper
from analyzer_tpu_torch import cli
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.io import synthetic
from analyzer_tpu_torch.loadgen import (
    Matchmaker,
    OutcomeModel,
    SoakConfig,
    SoakDriver,
    TrafficShaper,
    VirtualClock,
)
from analyzer_tpu_torch.loadgen import shaper
from analyzer_tpu_torch.migrate import reset_migration_progress
from analyzer_tpu_torch.obs import get_registry

SMOKE = SoakConfig(
    seed=6, duration_s=3.0, tick_s=1.0, qps=10.0, query_qps=6.0,
    n_players=80, batch_size=32, polls_per_tick=4, use_http=False,
)


@pytest.fixture(autouse=True)
def _idle_progress():
    yield
    reset_migration_progress()


def _soak(cfg: SoakConfig, device="cpu", keep=None) -> dict:
    driver = SoakDriver(cfg, device=device)
    try:
        art = driver.run()
        if keep is not None:
            keep(driver)
        return art
    finally:
        driver.close()


def _block(art) -> str:
    return json.dumps(art["deterministic"], sort_keys=True)


# -- the parts against JAX -------------------------------------------------------


class TestShaperAgainstJax:
    def test_virtual_clock(self):
        for cls in (VirtualClock, jshaper.VirtualClock):
            c = cls(1.5)
            assert c.advance(0.25) == 1.75 == c.now == c.monotonic()
            with pytest.raises(ValueError):
                c.advance(-0.1)

    @pytest.mark.parametrize("rate,tick", [(7.5, 0.4), (24.0, 1.0), (2000.0, 1.0),
                                           (0.3, 0.7), (0.0, 1.0), (1 / 3, 0.25)])
    def test_shaper_counts_equal_jax(self, rate, tick):
        a, b = TrafficShaper(rate, tick), jshaper.TrafficShaper(rate, tick)
        got = [a.due() for _ in range(500)]
        assert got == [b.due() for _ in range(500)]
        assert abs(sum(got) - 500 * rate * tick) <= 1
        with pytest.raises(ValueError):
            TrafficShaper(-1.0, tick)

    def test_kind_draws_equal_jax(self):
        for seed in range(3):
            r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
            got = [shaper.choose_kind(r1) for _ in range(1000)]
            assert got == [jshaper.choose_kind(r2) for _ in range(1000)]
            assert set(got) == {"ratings", "winprob", "leaderboard", "tiers"}


class TestOutcomesAgainstJax:
    @pytest.mark.parametrize("seed", [0, 3, 11])
    def test_probabilities_and_resolutions(self, seed):
        players = synthetic.synthetic_players(200, seed=seed)
        jplayers = jsynth.synthetic_players(200, seed=seed)
        np.testing.assert_array_equal(players.latent_skill, jplayers.latent_skill)
        port = OutcomeModel(players, RatingConfig(), seed=seed)
        jax_ = jloadgen.OutcomeModel(jplayers, JaxRatingConfig(), seed=seed)
        rng = np.random.default_rng(seed)
        for _ in range(300):
            t = 5 if rng.random() < 0.3 else 3
            rows = rng.choice(200, 2 * t, replace=False)
            a, b = rows[:t].tolist(), rows[t:].tolist()
            p, jp = port.win_probability(a, b), jax_.win_probability(a, b)
            assert p == pytest.approx(jp, rel=1e-12, abs=1e-15)
            assert port.resolve(a, b) == jax_.resolve(a, b)


class _StubClient:
    """Serves the same fixed ratings to either package's matchmaker: a
    seeded table of conservative ratings, some players unrated or
    unknown, and a winprob / quality from the ids alone."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.mu = rng.normal(1500, 300, n)
        self.sigma = rng.uniform(50, 400, n)
        self.rated = rng.random(n) < 0.7
        self.known = rng.random(n) < 0.95
        self.calls: dict = {}

    def get_ratings(self, ids):
        self.calls["ratings"] = self.calls.get("ratings", 0) + 1
        out, unknown = [], []
        for pid in ids:
            r = int(pid[1:])
            if not self.known[r]:
                unknown.append(pid)
                continue
            out.append({"id": pid, "rated": bool(self.rated[r]),
                        "conservative": float(self.mu[r] - 3 * self.sigma[r]),
                        "seed_mu": float(self.mu[r]) - 100.0,
                        "seed_sigma": 350.0})
        return {"ratings": out, "unknown": unknown}

    def win_probability(self, a, b):
        self.calls["winprob"] = self.calls.get("winprob", 0) + 1
        gap = sum(self.mu[int(x[1:])] for x in a) - sum(self.mu[int(x[1:])] for x in b)
        p = 1.0 / (1.0 + np.exp(-gap / 400.0))
        return {"p_a": float(p), "quality": float(1.0 - abs(p - 0.5) * 2)}


@pytest.mark.parametrize("seed", [0, 5])
def test_matchmaker_formations_equal_jax(seed):
    n = 300
    players = synthetic.synthetic_players(n, seed=seed)
    jplayers = jsynth.synthetic_players(n, seed=seed)
    mm = Matchmaker(players, _StubClient(n, seed), seed=seed)
    jmm = jloadgen.Matchmaker(jplayers, _StubClient(n, seed), seed=seed)
    for k in (1, 7, 30):
        got = [dataclasses.astuple(m) for m in mm.form(k)]
        assert got == [dataclasses.astuple(m) for m in jmm.form(k)]
    rng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    assert mm.sample_rows(8, rng=rng) == jmm.sample_rows(8, rng=jrng)
    assert mm.client.calls == jmm.client.calls
    with pytest.raises(ValueError):
        Matchmaker(synthetic.synthetic_players(9, seed=0), _StubClient(9, 0))


def test_soak_pairings_and_counts_equal_jax():
    """The measurement in the module docstring, on one seed: the same
    pairings, the served floats within 1e-6, every non-digest value of the
    block equal."""
    kw = {f.name: getattr(SMOKE, f.name) for f in dataclasses.fields(SMOKE)}

    def formed(d, log):
        orig = d.matchmaker.form

        def form(n):
            out = orig(n)
            log.extend(out)
            return out

        d.matchmaker.form = form

    logs = ([], [])
    jd = jloadgen.SoakDriver(jloadgen.SoakConfig(**kw))
    formed(jd, logs[1])
    try:
        want = jd.run()
    finally:
        jd.close()
    d = SoakDriver(SMOKE, device="cpu")
    formed(d, logs[0])
    try:
        got = d.run()
    finally:
        d.close()
    assert len(logs[0]) == len(logs[1]) == got["deterministic"]["matches_published"]
    for m, jm in zip(*logs):
        assert (m.mode, m.team_a_ids, m.team_b_ids, m.split) == (
            jm.mode, jm.team_a_ids, jm.team_b_ids, jm.split)
        assert abs(m.p_a - jm.p_a) <= 1e-6 and abs(m.quality - jm.quality) <= 1e-6
    for key, val in want["deterministic"].items():
        if not key.endswith("_digest"):
            assert got["deterministic"][key] == val, key
    assert set(got) == set(want)
    assert set(got["deterministic"]) == set(want["deterministic"])


# -- the port's determinism contract ----------------------------------------------


@pytest.fixture(scope="module")
def smoke_artifacts():
    """Two runs of SMOKE, one with another seed, one over HTTP."""
    other = dataclasses.replace(SMOKE, seed=17)
    http = dataclasses.replace(SMOKE, use_http=True)
    arts = [_soak(cfg) for cfg in (SMOKE, SMOKE, other, http)]
    reset_migration_progress()
    return arts


class TestSoakDeterminism:
    def test_bit_identical_block_run_to_run(self, smoke_artifacts):
        a, b, _, _ = smoke_artifacts
        assert _block(a) == _block(b)

    def test_http_queries_give_the_in_process_block(self, smoke_artifacts):
        a, _, _, http = smoke_artifacts
        assert _block(a) == _block(http)

    def test_seed_changes_the_digests(self, smoke_artifacts):
        a, _, c, _ = smoke_artifacts
        for key in ("matches_digest", "queries_digest"):
            assert a["deterministic"][key] != c["deterministic"][key]

    def test_slos_green_and_loop_closed(self, smoke_artifacts):
        art = smoke_artifacts[0]
        det = art["deterministic"]
        assert art["slo"]["pass"] and art["slo"]["violations"] == []
        assert det["dead_letters"] == 0 and det["retraces_steady"] == 0
        assert det["drained"] and det["queue_depth_final"] == 0
        assert det["matches_rated"] == det["matches_published"] > 0
        assert det["view_lag_ticks_max"] <= SMOKE.max_view_lag_ticks
        assert art["latency_ms"]["p99"] is not None
        assert art["quality"]["matches_scored"] > 0

    @pytest.mark.parametrize("variant", [
        dict(broker_partitions=4),
        dict(broker_partitions=4, priority_lanes=True),
        dict(serve_shards=4),
        dict(broker_partitions=4, priority_lanes=True, serve_shards=4,
             migrate=True, migrate_matches=150),
    ], ids=["partitions4", "partitions4_lanes", "shards4", "all_migrate"])
    def test_block_invariant_across_topology_and_migration(self, smoke_artifacts,
                                                            variant):
        art = _soak(dataclasses.replace(SMOKE, **variant))
        assert art["slo"]["pass"], art["slo"]["violations"]
        assert _block(art) == _block(smoke_artifacts[0])

    def test_migration_under_load_cuts_over_the_reference(self, smoke_artifacts):
        kept = {}

        def keep(d):
            kept["live"] = d.worker.view_publisher.current()
            kept["ref"] = d._mig_reference

        art = _soak(dataclasses.replace(SMOKE, migrate=True, migrate_matches=150),
                    keep=keep)
        mig = art["migration"]
        assert art["slo"]["pass"], art["slo"]["violations"]
        assert mig["finished"] and mig["streamed"] and mig["bit_identical"]
        assert mig["cutover_serves_migrated_table"]
        versions = mig["lineage_versions"]
        assert versions["post_cutover_live"] == versions["pre_cutover_live"] + 1
        assert mig["admission_halvings"] is not None
        assert set(mig["quality"]) == {"replay_matches", "migrated",
                                       "live_pre_cutover"}
        n = SMOKE.n_players
        np.testing.assert_array_equal(kept["live"].host_table()[:n],
                                      kept["ref"][:n])
        assert _block(art) == _block(smoke_artifacts[0])

    def test_backfill_lane_traffic(self):
        cfg = dataclasses.replace(SMOKE, broker_partitions=2, priority_lanes=True,
                                  backfill_qps=4.0)
        art = _soak(cfg)
        det = art["deterministic"]
        assert art["slo"]["pass"], art["slo"]["violations"]
        assert det["backfill_published"] == 12 and det["drained"]
        with pytest.raises(ValueError, match="priority_lanes"):
            SoakDriver(dataclasses.replace(SMOKE, backfill_qps=1.0), device="cpu")

    def test_registry_series_and_worker_stats(self):
        def keep(d):
            st = d.worker.stats()
            assert st["matches_rated"] == d.worker.matches_rated
            assert st["migration"] is None

        _soak(SMOKE, keep=keep)
        snap = get_registry().snapshot()
        for name in ("soak.ticks_total", "soak.matches_published_total",
                     "soak.queries_sent_total"):
            assert snap["counters"][name] > 0, name
        assert "broker.queue_depth" in snap["gauges"]
        assert snap["gauges"]["soak.virtual_seconds"] >= SMOKE.duration_s


def test_serve_http_waits_for_the_front_door(smoke_artifacts):
    """``serve_http=True`` (once refused) queries through the front door:
    the same deterministic block as the in-process run, every response
    encoded by the native codec."""
    art = _soak(dataclasses.replace(SMOKE, serve_http=True))
    assert art["slo"]["pass"], art["slo"]["violations"]
    assert _block(art) == _block(smoke_artifacts[0])
    fd = art["frontdoor"]
    assert fd["encodes"] > 0 and fd["native"] and fd["fallbacks"] == 0


# -- cli soak ----------------------------------------------------------------------

SOAK_ARGS = ["soak", "--seed", "9", "--duration", "2", "--qps", "12",
             "--query-qps", "6", "--players", "120", "--batch-size", "32",
             "--in-process"]


def test_cli_soak_writes_the_jax_artifact_shape(tmp_path, capsys):
    out = tmp_path / "SOAK_r01.json"
    assert cli.main([*SOAK_ARGS, "--device", "cpu", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["slo"]["pass"] and "trajectory" not in line["deterministic"]
    art = json.loads(out.read_text())
    jd = jloadgen.SoakDriver(jloadgen.SoakConfig(
        seed=9, duration_s=2.0, qps=12.0, query_qps=6.0, n_players=120,
        batch_size=32, use_http=False))
    try:
        want = jd.run()
    finally:
        jd.close()
    assert set(art) == set(want)
    assert set(art["config"]) == set(want["config"])
    assert set(art["deterministic"]) == set(want["deterministic"])
    assert art["deterministic"]["trajectory"] == want["deterministic"]["trajectory"]


@pytest.mark.parametrize("argv,item", [
    (["--hosts", "2"], "fabric"),
    (["--fabric-shards", "4"], "soak"),
    (["--hosts", "2", "--fabric-shards", "4"], "fabric"),
    (["--serve-http"], "frontdoor"),
])
def test_cli_soak_refusals_name_the_item(argv, item, capsys):
    """The four flag sets once refused now run: ``--hosts`` the fabric soak
    (a FABRIC line, 2 hosts over 4 shards), ``--fabric-shards`` alone the
    ordinary soak as in JAX (the flag configures only ``--hosts``, so the
    line equals the run without it), ``--serve-http`` the soak over the
    front door (the in-process run's block)."""
    base = [a for a in SOAK_ARGS if a != "--in-process"]
    assert cli.main([*base, "--device", "cpu", *argv]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["slo"]["pass"]
    if item == "fabric":
        assert line["metric"] == "fabric.matches_per_sec_per_host"
        assert [h["host"] for h in line["measured"]["bringup"]] == [0, 1]
        assert line["deterministic"]["matches_rated"] == (
            line["deterministic"]["matches_published"])
        return
    assert line["metric"] == "soak.matches_per_sec"
    assert cli.main([*SOAK_ARGS, "--device", "cpu"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["deterministic"] == want["deterministic"]


@pytest.mark.parametrize("argv", [
    ["--duration", "0"], ["--players", "-1"], ["--query-qps", "-1"],
    ["--backfill-qps", "-1"], ["--backfill-qps", "2"],
    ["--forbid-dominant-stage", "queue_wait"], ["--migrate-matches", "0"],
])
def test_cli_soak_bad_args_exit_2_as_jax(argv, capsys):
    from analyzer_tpu.cli import main as jmain

    assert cli.main(["soak", "--device", "cpu", *argv]) == 2
    got = capsys.readouterr().err
    assert jmain(["soak", *argv]) == 2
    assert got == capsys.readouterr().err


def test_cli_soak_without_a_card_exits_2(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device would run")
    assert cli.main(["soak", "--duration", "1"]) == 2
    assert "--device cpu" in capsys.readouterr().err
