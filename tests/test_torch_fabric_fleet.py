"""The port's fabric across REAL host subprocesses on the CPU
(``python -m analyzer_tpu_torch.fabric.process``, ``"device": "cpu"``).

A three-host fabric (6 shards, ``shard % 3``), fed per-(tick, shard) match
groups by this process over ``/fabric/*``:

  * partitioned publish — every group lands on the shard's owner and
    drains inside the call; a foreign seed id and a shard-impure group are
    refused (400);
  * cross-host reads — routed point lookups, merged leaderboards, tiers,
    percentiles and a cross-owner winprob equal a single in-process plane
    over the union of the hosts' published tables, bit for bit, over one
    pooled keep-alive connection a host;
  * version monotonicity — every host's version rises and never rewinds;
  * fleet SLOs — a Collector over the three obsd planes, driven on the
    virtual clock, attributes an injected dead-letter burn to exactly the
    burned host (only ``zero-dead-letters`` is asserted: a wall-paced rate
    objective is not, see ROADMAP queue C on JAX's ``no-feed-starvation``);
  * host death — the merge keeps serving from the survivors, point lookups
    to the dead owner raise ``HostDownError``;
  * trace stitching — a traced match's chain is complete across the
    process boundary.

Then the headline: the ``FabricSoakDriver`` deterministic block is byte-
identical at hosts 1 and 2 (1 against 4 in the slow lane, as JAX's), and
``cli soak --hosts`` / ``cli fabric`` run (``/statusz`` carries each host's
``fabric`` block).

Against JAX's fabric soak on the same config (measured on two seeds, 120
to 200 players): every formed match — id, mode, teams, winner, afk — is
JAX's, and so is every count of the block (matches, batches, dead letters,
query counts per kind, staleness). None of the three digests equals
JAX's on those seeds: the matches digest hashes the served float32 win
probability and quality of each split, the queries digest every served
float, and the table digest the final float32 table, and the port's rating
path puts those floats 1-2 ulp from JAX's (ROADMAP queue C, as for the
single-process soak). Inside the port every digest is invariant.
"""

import ast
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import analyzer_tpu.fabric.driver as jdriver
from analyzer_tpu.obs import reset_registry as jax_reset_registry
from analyzer_tpu_torch import cli
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.fabric import (
    FabricDirectory,
    FabricRouter,
    FabricTopology,
    row_of_id,
)
from analyzer_tpu_torch.fabric.driver import FabricSoakConfig, FabricSoakDriver
from analyzer_tpu_torch.fabric.route import HostDownError
from analyzer_tpu_torch.loadgen.matchmaker import player_id
from analyzer_tpu_torch.obs import get_registry, reset_registry
from analyzer_tpu_torch.obs.federate import Collector
from analyzer_tpu_torch.obs.tracer import reset_tracer
from analyzer_tpu_torch.serve import QueryEngine, ViewPublisher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RatingConfig()

N_SHARDS = 6
N_HOSTS = 3
N_PLAYERS = 120
BATCH = 8
SEED = 13
TICKS = 2


@pytest.fixture(autouse=True)
def fresh_planes():
    reset_registry()
    reset_tracer()
    yield
    reset_registry()
    reset_tracer()


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # several interpreters share the cores
    return env


def http_get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def post_json(url, obj, timeout=300):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def seed_table() -> np.ndarray:
    """The population every host builds from ``SEED``; the parent keeps the
    union for oracle planes."""
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.io.synthetic import synthetic_players

    players = synthetic_players(N_PLAYERS, seed=SEED)
    state = PlayerState.create(
        N_PLAYERS, rank_points_ranked=players.rank_points_ranked,
        rank_points_blitz=players.rank_points_blitz,
        skill_tier=players.skill_tier, cfg=CFG, device="cpu",
    )
    return state.table.numpy()[:N_PLAYERS].copy()


def oracle_engine(table: np.ndarray) -> QueryEngine:
    pub = ViewPublisher(min_publish_interval_s=0.0, device="cpu")
    pub.publish_rows([player_id(r) for r in range(N_PLAYERS)], table)
    return QueryEngine(pub, cfg=CFG, device="cpu").start()


def strip(resp: dict) -> dict:
    return FabricRouter.strip_versions(resp)


class TestThreeHostFabric:
    def _spawn(self, tmp_path, host):
        spec = {
            "host": host, "n_shards": N_SHARDS, "n_hosts": N_HOSTS,
            "seed": SEED, "n_players": N_PLAYERS, "batch_size": BATCH,
            "trace": True, "trace_out": str(tmp_path / f"host{host}.jsonl"),
            "ready_file": str(tmp_path / f"ready{host}"),
            "exit_file": str(tmp_path / f"exit{host}"),
            "max_wall_s": 600.0, "device": "cpu",
        }
        spec_path = tmp_path / f"spec{host}.json"
        spec_path.write_text(json.dumps(spec))
        proc = subprocess.Popen(
            [sys.executable, "-m", "analyzer_tpu_torch.fabric.process",
             str(spec_path)],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        return proc, spec

    @staticmethod
    def _await_file(path, procs, timeout=240.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if os.path.exists(path):
                return
            for proc in procs:
                if proc.poll() is not None and proc.returncode != 0:
                    out, err = proc.communicate()
                    raise AssertionError(
                        f"fabric host died rc={proc.returncode}\n{out}\n{err}")
            time.sleep(0.1)
        raise AssertionError(f"timed out waiting for {path}")

    def _shard_pure_specs(self, tick: int):
        """One handcrafted 3v3 per shard per tick — every row ≡ shard
        (mod N_SHARDS), trace-minted, partition-stamped."""
        from analyzer_tpu_torch.obs import tracectx

        specs = {}
        for s in range(N_SHARDS):
            mid = f"fleet-t{tick}-s{s}"
            headers = dict(tracectx.headers(tracectx.mint(mid)) or {})
            headers["x-partition"] = s
            specs[s] = {
                "id": mid, "mode": "ranked",
                "a_rows": [s, s + N_SHARDS, s + 2 * N_SHARDS],
                "b_rows": [s + 3 * N_SHARDS, s + 4 * N_SHARDS, s + 5 * N_SHARDS],
                "winner": (tick + s) % 2, "afk": False,
                "created_at": tick * N_SHARDS + s, "headers": headers,
            }
        return specs

    def test_three_host_fabric_end_to_end(self, tmp_path):
        from analyzer_tpu_torch.obs import tracectx
        from analyzer_tpu_torch.obs.snapshot import write_chrome_trace
        from analyzer_tpu_torch.obs.traceview import (
            build_model,
            critical_path,
            load_forest,
            match_report,
            verify_chain,
        )

        topology = FabricTopology(N_SHARDS, N_HOSTS)
        table = seed_table()
        procs, specs = [], []
        engines = []
        try:
            for h in range(N_HOSTS):
                proc, spec = self._spawn(tmp_path, h)
                procs.append(proc)
                specs.append(spec)
            ready = []
            for spec in specs:
                self._await_file(spec["ready_file"], procs)
                with open(spec["ready_file"]) as f:
                    ready.append(json.load(f))
            assert all(set(r["bringup"]) == {"context_s", "build_s"} for r in ready)

            directory = FabricDirectory(topology, down_after_s=1e9)
            for info in ready:
                directory.register(info["host"], serve_url=info["serve_url"], now=0.0)
            router = FabricRouter(directory, cfg=CFG)

            # -- seed: each host gets exactly its owned slice ----------
            for info in ready:
                h = info["host"]
                owned = topology.owned_rows(h, N_PLAYERS)
                resp = post_json(info["control_url"] + "/fabric/seed", {
                    "ids": [player_id(r) for r in owned],
                    "rows": [[float(x) for x in table[r]] for r in owned],
                })
                assert resp["version"] == 1 and resp["n"] == len(owned)
                directory.observe(h, resp["version"], 0.0)
            foreign = player_id(next(
                r for r in range(N_PLAYERS) if topology.host_of_row(r) != 0))
            with pytest.raises(urllib.error.HTTPError) as err:
                post_json(ready[0]["control_url"] + "/fabric/seed",
                          {"ids": [foreign], "rows": [[0.0] * 16]})
            assert err.value.code == 400

            # -- pre-rating: routed reads == single union plane --------
            oracle = oracle_engine(table)
            engines.append(oracle)
            ids = [player_id(r) for r in (0, 7, 14, 33, 119)]
            assert strip(router.get_ratings(ids)) == strip(oracle.get_ratings(ids))
            assert strip(router.leaderboard(10)) == strip(oracle.leaderboard(10))
            assert strip(router.tier_histogram()) == strip(oracle.tier_histogram())

            # -- collector over all three hosts, on the virtual clock --
            targets = [f"127.0.0.1:{i['obs_port']}" for i in ready]
            collector = Collector(targets, request_flight_dumps=False)
            collector.scrape(0.0)
            assert collector.fleetz()["up"] == N_HOSTS

            # -- partitioned publish: per-(tick, shard) groups ---------
            tracectx.enable_tracing(True)
            versions = {h: [1] for h in range(N_HOSTS)}
            all_mids = []
            try:
                for tick in range(TICKS):
                    now = float(tick + 1)
                    shard_specs = self._shard_pure_specs(tick)
                    all_mids.extend(m["id"] for m in shard_specs.values())
                    for s in range(N_SHARDS):  # fixed shard order
                        h = topology.host_of_shard(s)
                        resp = post_json(ready[h]["control_url"] + "/fabric/rate", {
                            "now": now, "matches": [shard_specs[s]],
                            "peer_versions": {
                                str(k): v for k, v in directory.vector().items()},
                        })
                        assert resp["dead_letters"] == 0
                        directory.observe(h, resp["version"], now)
                        versions[h].append(resp["version"])
            finally:
                tracectx.enable_tracing(False)
            pub_trace = tmp_path / "publisher.jsonl"
            write_chrome_trace(str(pub_trace))
            for h, seq in versions.items():
                assert seq == sorted(seq) and seq[-1] > 1, (h, seq)

            with pytest.raises(urllib.error.HTTPError) as err:
                post_json(ready[0]["control_url"] + "/fabric/rate", {
                    "now": float(TICKS + 1),
                    "matches": [{"id": "impure", "mode": "ranked",
                                 "a_rows": [0, 1, 2], "b_rows": [3, 4, 5],
                                 "winner": 0, "afk": False, "created_at": 0}],
                })
            assert err.value.code == 400

            # -- post-rating: reassemble, then merge == union plane ----
            rated = np.zeros((N_PLAYERS, table.shape[1]), np.float32)
            seen = set()
            for info in ready:
                t = json.loads(http_get(info["control_url"] + "/fabric/table")[1])
                assert t["version"] >= versions[info["host"]][-1]
                for pid, row in zip(t["ids"], t["rows"]):
                    r = row_of_id(pid)
                    assert topology.host_of_row(r) == info["host"]
                    rated[r] = np.asarray(row, np.float32)
                    seen.add(r)
            assert len(seen) == N_PLAYERS, "hosts dropped rows"
            assert not np.array_equal(rated, table, equal_nan=True), "nothing rated"
            oracle2 = oracle_engine(rated)
            engines.append(oracle2)
            for k in (10, N_PLAYERS):
                assert strip(router.leaderboard(k)) == strip(oracle2.leaderboard(k))
            assert strip(router.tier_histogram()) == strip(oracle2.tier_histogram())
            assert strip(router.get_ratings(ids)) == strip(oracle2.get_ratings(ids))
            p, op = router.percentile(1500.0), oracle2.percentile(1500.0)
            assert strip(p) == strip(op)
            a = [player_id(r) for r in (0, 1, 2)]
            b = [player_id(r) for r in (3, 4, 5)]
            assert strip(router.win_probability(a, b)) == strip(
                oracle2.win_probability(a, b))
            pools = [router.client_of(h).pool for h in range(N_HOSTS)]
            assert all(p.requests > 1 for p in pools)
            assert sum(p.reuse_count for p in pools) > 0
            assert get_registry().counter("frontdoor.pool_reuse_total").value == sum(
                p.reuse_count for p in pools)

            # -- a burn attributed to host 1 ----------------------------
            collector.scrape(10.0)
            assert "zero-dead-letters" not in collector.burning
            merged = collector.fleet_snapshot()
            assert merged["counters"]["worker.matches_rated_total"] == TICKS * N_SHARDS
            for info, target in zip(ready, targets):
                owned_n = len(topology.owned_shards(info["host"]))
                key = f"worker.matches_rated_total{{host={target}}}"
                assert merged["counters"][key] == TICKS * owned_n
            post_json(ready[1]["control_url"] + "/fabric/burn", {"count": 3})
            collector.scrape(40.0)
            collector.scrape(71.0)
            assert "zero-dead-letters" in collector.burning
            assert collector.attribution()["zero-dead-letters"] == [targets[1]]

            # -- finish accounting --------------------------------------
            total = 0
            for info in ready:
                fin = post_json(info["control_url"] + "/fabric/finish", {})
                total += fin["matches_rated"]
                assert fin["dead_letters"] == 0 and fin["retraces_steady"] == 0
            assert total == TICKS * N_SHARDS

            # -- host death ---------------------------------------------
            with open(specs[2]["exit_file"], "w") as f:
                f.write("done\n")
            procs[2].wait(timeout=60)
            resp = router.leaderboard(N_PLAYERS)  # first call marks down
            assert directory.entry(2).down is True and "2" not in resp["versions"]
            survivors = {player_id(r) for r in range(N_PLAYERS)
                         if topology.host_of_row(r) != 2}
            leaders = {e["id"] for e in resp["leaders"]}
            assert leaders and leaders <= survivors
            dead_owned = player_id(next(
                r for r in range(N_PLAYERS) if topology.host_of_row(r) == 2))
            with pytest.raises(HostDownError):
                router.get_ratings([dead_owned])
            assert 0 < router.tier_histogram()["rated"] <= len(survivors)

            # -- graceful exit, then cross-process trace stitching -----
            for spec in specs[:2]:
                with open(spec["exit_file"], "w") as f:
                    f.write("done\n")
            for proc in procs[:2]:
                proc.wait(timeout=60)
            model = build_model(load_forest(
                [str(pub_trace)] + [s["trace_out"] for s in specs]))
            assert model.hosts == {"publisher", "host0", "host1", "host2"}
            assert sorted(model.match_batch) == sorted(all_mids)
            for mid in all_mids:
                assert verify_chain(model, mid) == [], mid
                rep = match_report(model, mid)
                shard = int(mid.rsplit("s", 1)[1])
                assert rep["enqueue_host"] == "publisher"
                assert rep["batch_host"] == f"host{topology.host_of_shard(shard)}"
                transit = rep["stages_ms"]["broker_transit"]
                assert transit is not None and transit >= 0
                assert rep["publish_version"] is not None
            cp = critical_path(model)
            assert set(cp["hosts"]) <= {"publisher", "host0", "host1", "host2"}
        finally:
            for eng in engines:
                eng.close()
            for spec in specs:
                try:
                    with open(spec["exit_file"], "w") as f:
                        f.write("done\n")
                except OSError:
                    pass
            for proc in procs:
                try:
                    proc.communicate(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.communicate(timeout=10)


# ---------------------------------------------------------------------------
SOAK = dict(seed=7, duration_s=3.0, tick_s=1.0, qps=8.0, query_qps=4.0,
            n_players=120, batch_size=16, n_shards=4, warmup=False,
            trace=False, scrape=False)


def _soak(hosts: int, log=None, **over) -> dict:
    reset_registry()
    reset_tracer()
    driver = FabricSoakDriver(FabricSoakConfig(**{**SOAK, **over}, n_hosts=hosts),
                              device="cpu")
    if log is not None:
        _log_specs(driver, log)
    try:
        return driver.run()
    finally:
        driver.close()


def _log_specs(driver, log) -> None:
    form = driver._form_specs

    def logged(shard, k):
        out = form(shard, k)
        log.extend((s["id"], s["mode"], s["a_rows"], s["b_rows"], s["winner"],
                    s["afk"]) for s in out)
        return out

    driver._form_specs = logged


def _block(art) -> str:
    return json.dumps(art["deterministic"], sort_keys=True)


class TestFabricSoakBitIdentity:
    """The headline: the deterministic block is a pure function of (seed,
    config) — the host count is not an input."""

    def test_hosts_1_vs_2_bit_identical(self):
        one, two = _soak(1), _soak(2)
        assert one["slo"]["pass"], one["slo"]["violations"]
        assert two["slo"]["pass"], two["slo"]["violations"]
        assert _block(one) == _block(two)
        assert two["fleet"]["n_hosts"] == 2 and len(two["fleet"]["hosts"]) == 2
        assert all(h["matches_rated"] > 0 for h in two["fleet"]["hosts"])
        assert set(one) >= {"config", "deterministic", "fleet", "slo", "capture"}
        assert [b["host"] for b in two["measured"]["bringup"]] == [0, 1]

    @pytest.mark.slow
    def test_hosts_4_bit_identical(self):
        assert _block(_soak(1)) == _block(_soak(4))

    @pytest.mark.parametrize("seed,players", [(7, 120), (3, 200)])
    def test_block_against_jax(self, seed, players):
        """The measurement in the module docstring: formations and counts
        equal JAX's fabric soak's; the digests as measured."""
        log, jlog = [], []
        got = _soak(2, log=log, seed=seed, n_players=players)
        jax_reset_registry()
        jd = jdriver.FabricSoakDriver(jdriver.FabricSoakConfig(
            **{**SOAK, "seed": seed, "n_players": players}, n_hosts=2))
        _log_specs(jd, jlog)
        try:
            want = jd.run()
        finally:
            jd.close()
        assert log == jlog and len(log) == got["deterministic"]["matches_published"]
        g, w = got["deterministic"], want["deterministic"]
        assert set(g) == set(w)
        for key in g:
            if not key.endswith("_digest"):
                assert g[key] == w[key], key
        assert set(got) == set(want)
        assert set(got["fleet"]) == set(want["fleet"])
        assert [h["matches_rated"] for h in got["fleet"]["hosts"]] == [
            h["matches_rated"] for h in want["fleet"]["hosts"]]


# ---------------------------------------------------------------------------
CLI_SOAK = ["soak", "--seed", "9", "--duration", "2", "--qps", "12",
            "--query-qps", "6", "--players", "120", "--batch-size", "32",
            "--device", "cpu"]


class TestCli:
    def test_cli_soak_hosts_writes_the_fabric_artifact(self, tmp_path, capsys):
        out = tmp_path / "FABRIC.json"
        assert cli.main([*CLI_SOAK, "--hosts", "2", "--fabric-shards", "4",
                         "--out", str(out)]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        art = json.loads(out.read_text())
        assert line["deterministic"] == art["deterministic"]
        assert art["fleet"]["n_hosts"] == 2 and art["fleet"]["scrapes"] > 0
        assert art["slo"]["pass"] and art["config"]["n_shards"] == 4

    @pytest.mark.parametrize("argv,text", [
        (["--hosts", "0"], "--hosts must be positive"),
        (["--hosts", "3", "--fabric-shards", "2"], "must be >= --hosts"),
        (["--hosts", "2", "--players", "0"], "--players must be positive"),
        (["--hosts", "2", "--query-qps", "-1"], "--query-qps must be >= 0"),
    ])
    def test_cli_soak_hosts_bad_args_exit_2_as_jax(self, argv, text, capsys):
        from analyzer_tpu.cli import main as jmain

        assert cli.main([*CLI_SOAK, *argv]) == 2
        got = capsys.readouterr().err
        assert text in got
        assert jmain([a for a in [*CLI_SOAK, *argv]
                      if a not in ("--device", "cpu")]) == 2
        assert got == capsys.readouterr().err

    def test_cli_fabric_up_statusz_and_down(self):
        proc = subprocess.Popen(
            [sys.executable, "-m", "analyzer_tpu_torch.cli", "fabric", "--hosts",
             "2", "--shards", "4", "--players", "80", "--duration", "60",
             "--device", "cpu"],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        try:
            lines = [json.loads(proc.stdout.readline()) for _ in range(2)]
            assert [ln["host"] for ln in lines] == [0, 1]
            for ln in lines:
                assert ln["shards"] == [ln["host"], ln["host"] + 2]
                _, text = http_get(f"http://127.0.0.1:{ln['obs_port']}/statusz")
                block = next(x for x in text.splitlines()
                             if x.strip().startswith("fabric = "))
                fab = ast.literal_eval(block.split("=", 1)[1].strip())
                assert fab == {"host": ln["host"], "n_hosts": 2, "n_shards": 4,
                               "shards": ln["shards"],
                               "vector": {str(ln["host"]): 0}}
                assert http_get(ln["serve_url"] + "/healthz") == (200, "ok\n")
            proc.send_signal(2)  # Ctrl-C: the fabric goes down, exit 0
            out, err = proc.communicate(timeout=60)
            assert proc.returncode == 0, err
            assert "signalling fabric down" in err
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()

    def test_cli_fabric_bad_args_exit_2_as_jax(self, capsys):
        from analyzer_tpu.cli import main as jmain

        for argv in (["--hosts", "0"], ["--hosts", "3", "--shards", "2"]):
            assert cli.main(["fabric", *argv, "--device", "cpu"]) == 2
            got = capsys.readouterr().err
            assert jmain(["fabric", *argv]) == 2
            assert got == capsys.readouterr().err
