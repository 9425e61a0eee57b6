"""Read-plane throughput: microbatched serving against one dispatch per query.

The port's copy of ``experiments/serve_bench.py``. It builds a rated
table, publishes one view, warms the engine, then measures
win-probability queries two ways:

  * **naive** — ``QueryEngine.query_now``: one padded device call per
    query, the cost model of every request opening its own device call;
  * **batched** — async submissions drained by the tick thread into
    ``max_batch``-deep microbatches: each query pays ~1/occupancy of a
    dispatch (Clipper, NSDI '17).

The acceptance bar is the JAX package's: batched queries/sec >= 5x naive
on the same table, with steady-state retraces flat. Nothing in the port
is jitted, so every ``retraces`` / ``backend_compiles`` field is kept and
reads 0 (``jax.retraces_total`` is declared and never moves), as in the
soak.

The SHARDED phase re-runs the batched workload through a
``ShardedQueryEngine`` over ``--shards`` per-shard views and emits a
``sharded`` block: shards, queries/sec, the shard-plane tax
``min_over_single`` (sharded batched seconds / single batched seconds,
lower is better), the leaderboard merge overhead (per-shard top-k + host
merge against the single plane's, uncached), the steady retraces and a
``bit_identical_to_single`` sample check. ``--shards 0`` skips it.

The FRONT-DOOR phase (``--frontdoor``) drives the concurrent socket plane
(``serve/frontdoor.py``) with keep-alive connections pipelining
``--pipeline-depth`` deep while a publisher thread republishes the view,
against the stdlib plane (``serve/server.py``) driven urlopen-per-request
on the same engine.

Output: one JSON line on stdout, the ``SERVE_BENCH`` artifact in the JAX
package's shape (``--out`` also writes it to a file for ``cli benchdiff
--family serve``).

Usage (the card by default; ``--device cpu`` for a CPU rehearsal):

    python -m analyzer_tpu_torch.experiments.serve_bench [--players 100000]
        [--queries 5000] [--shards 8] [--frontdoor] [--out SERVE_BENCH.json]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import MU_LO, SIGMA_LO, PlayerState
from analyzer_tpu_torch.device import resolve_device
from analyzer_tpu_torch.obs import get_registry
from analyzer_tpu_torch.serve import (
    QueryEngine,
    ShardedQueryEngine,
    ShardedViewPublisher,
    ViewPublisher,
)


def build_table(n_players: int, seed: int):
    """One fully-rated synthetic host table + id list + config — shared
    verbatim by the single-device and sharded phases, so the sharded
    bit-identity sample compares the same published rows."""
    rng = np.random.default_rng(seed)
    cfg = RatingConfig()
    state = PlayerState.create(
        n_players, skill_tier=rng.integers(1, 29, n_players), cfg=cfg,
        device="cpu",
    )
    table = state.table.numpy().copy()
    table[:n_players, MU_LO] = rng.normal(1500.0, 400.0, n_players).astype(
        np.float32
    )
    table[:n_players, SIGMA_LO] = rng.uniform(
        60.0, 600.0, n_players
    ).astype(np.float32)
    ids = [f"p{i}" for i in range(n_players)]
    return table, ids, cfg


def gen_matchups(n_players: int, count: int, seed: int):
    """``count`` random 3v3 matchups as id-tuple payloads."""
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, n_players, (count, 6))
    return [
        (
            tuple(f"p{i}" for i in row[:3]),
            tuple(f"p{i}" for i in row[3:]),
        )
        for row in draws
    ]


def quantile(xs, q: float):
    xs = sorted(xs)
    if not xs:
        return None
    return xs[min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))]


def run_batched(engine, payloads) -> float:
    """Floods ``payloads`` through the tick thread; returns wall seconds
    (the engine is started and closed here — one steady-state phase)."""
    engine.start()
    t0 = time.perf_counter()
    pendings = [engine.submit("winprob", p) for p in payloads]
    for p in pendings:
        p.result(timeout=120.0)
    dt = time.perf_counter() - t0
    engine.close()
    return dt


def leaderboard_ms(engine, k: int, reps: int = 5) -> float:
    """Best-of-``reps`` UNCACHED leaderboard milliseconds — the cache is
    cleared each rep so the sharded number prices the per-shard top-k
    dispatches PLUS the host merge, not a cache hit."""
    best = None
    for _ in range(reps):
        engine._lb_cache = None
        t0 = time.perf_counter()
        engine.query_now("leaderboard", k)
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    return best


def sharded_phase(
    args, table, ids, cfg, reg, single_batched_s: float,
    single_lb_ms: float, single_engine,
) -> dict:
    """The sharded plane measured on the single plane's exact workload,
    plus a response-level bit-identity sample against ``single_engine``
    (the CPU half of the acceptance contract; the full matrix lives in
    tests/test_serve_sharded.py)."""
    publisher = ShardedViewPublisher(args.shards, device=args.device)
    publisher.publish_rows(ids, table[: args.players])
    engine = ShardedQueryEngine(
        publisher, cfg=cfg, max_batch=args.max_batch, device=args.device
    )
    t0 = time.perf_counter()
    engine.warmup()
    t_warm = time.perf_counter() - t0

    retraces_before = reg.counter("jax.retraces_total").value
    batched_q = gen_matchups(args.players, args.queries, args.seed + 2)
    t_batched = run_batched(engine, batched_q)
    lb_ms = leaderboard_ms(engine, k=100)
    steady = reg.counter("jax.retraces_total").value - retraces_before

    # Response-level sample parity: every kind, same payloads both ways.
    sample = gen_matchups(args.players, 16, args.seed + 3)
    identical = all(
        engine.query_now("winprob", p) == single_engine.query_now("winprob", p)
        for p in sample
    )
    identical = identical and (
        engine.query_now("leaderboard", 50)
        == single_engine.query_now("leaderboard", 50)
    )
    identical = identical and (
        engine.query_now("tiers") == single_engine.query_now("tiers")
    )
    qps = args.queries / t_batched if t_batched > 0 else 0.0
    return {
        "shards": args.shards,
        "queries_per_sec": round(qps, 1),
        "min_over_single": (
            round(t_batched / single_batched_s, 3)
            if single_batched_s > 0 else None
        ),
        "merge": {
            "leaderboard_ms": round(lb_ms, 3),
            "leaderboard_single_ms": round(single_lb_ms, 3),
            "overhead_ms": round(lb_ms - single_lb_ms, 3),
        },
        "warmup_s": round(t_warm, 3),
        "steady_retraces": steady,
        "bit_identical_to_single": identical,
        # A retraced or divergent sharded phase is not a comparable
        # capture — benchdiff treats unstable like degraded (no gate).
        "stable": bool(steady == 0 and identical),
    }


def read_response(sock, buf: bytearray) -> tuple[int, bytes]:
    """One HTTP/1.1 response off a keep-alive socket (Content-Length
    framing — the only framing the serve planes emit)."""
    while True:
        end = buf.find(b"\r\n\r\n")
        if end >= 0:
            break
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("peer closed mid-response")
        buf += chunk
    head = bytes(buf[:end])
    status = int(head.split(None, 2)[1])
    clen = 0
    for line in head.split(b"\r\n")[1:]:
        name, _, value = line.partition(b":")
        if name.strip().lower() == b"content-length":
            clen = int(value)
    del buf[:end + 4]
    while len(buf) < clen:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("peer closed mid-body")
        buf += chunk
    body = bytes(buf[:clen])
    del buf[:clen]
    return status, body


def _frontdoor_client(port, paths, depth, lats, errs):
    """One keep-alive connection driving ``paths`` in pipelined windows
    of ``depth``; appends per-request client-observed latencies (s)."""
    import socket as socketlib

    sock = socketlib.create_connection(("127.0.0.1", port), timeout=60)
    sock.setsockopt(socketlib.IPPROTO_TCP, socketlib.TCP_NODELAY, 1)
    buf = bytearray()
    try:
        for i in range(0, len(paths), depth):
            window = paths[i:i + depth]
            payload = b"".join(
                f"GET {p} HTTP/1.1\r\nHost: bench\r\n\r\n".encode()
                for p in window
            )
            t_send = time.perf_counter()
            sock.sendall(payload)
            for _ in window:
                status, _body = read_response(sock, buf)
                if status != 200:
                    errs.append(status)
                lats.append(time.perf_counter() - t_send)
    finally:
        sock.close()


def frontdoor_phase(args, publisher, ids, table, cfg, reg, engine) -> dict:
    """The socket plane measured under concurrent publishes.

    Two sub-phases on the SAME engine: (a) the old stdlib
    RoutedHTTPServer path driven urlopen-per-request — the effective
    HTTP throughput every pre-frontdoor client saw (r01 has no HTTP
    number, so the baseline is self-measured); (b) the FrontDoor driven
    by ``--frontdoor-connections`` keep-alive sockets pipelining
    ``--pipeline-depth`` deep, while a publisher thread republishes the
    table — p99 under publish is the number an operator cares about.
    """
    import threading
    import urllib.request

    from analyzer_tpu_torch.serve.frontdoor import FrontDoor
    from analyzer_tpu_torch.serve.server import ServeServer

    matchups = gen_matchups(args.players, args.frontdoor_queries,
                            args.seed + 4)
    paths = [
        f"/v1/winprob?a={','.join(a)}&b={','.join(b)}"
        for a, b in matchups
    ]
    engine.start()

    # -- (a) stdlib-plane baseline: urlopen per request ------------------
    srv = ServeServer(engine)
    base_n = min(args.http_queries, len(paths))
    done = [0] * 8
    def _urlopen_worker(w):
        for p in paths[w:base_n:8]:
            with urllib.request.urlopen(srv.url + p, timeout=60) as resp:
                resp.read()
            done[w] += 1
    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=_urlopen_worker, args=(w,), daemon=True)
        for w in range(8)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_base = time.perf_counter() - t0
    srv.close()
    http_qps = sum(done) / t_base if t_base > 0 else 0.0

    # -- (b) the front door under concurrent publish ---------------------
    door = FrontDoor(engine, readers=args.frontdoor_readers)
    # Publish the 1024-row patch once so the measured window prices
    # steady republishes, not the first one-time costs.
    publisher.publish_rows(ids[:1024], table[:1024])
    retraces_before = reg.counter("jax.retraces_total").value
    stop = threading.Event()
    publishes = [0]
    def _publisher():
        while not stop.wait(0.005):
            publisher.publish_rows(ids[:1024], table[:1024])
            publishes[0] += 1
    pub_thread = threading.Thread(target=_publisher, daemon=True)
    pub_thread.start()
    lats: list[list] = [[] for _ in range(args.frontdoor_connections)]
    errs: list[list] = [[] for _ in range(args.frontdoor_connections)]
    shards = [
        paths[c::args.frontdoor_connections]
        for c in range(args.frontdoor_connections)
    ]
    clients = [
        threading.Thread(
            target=_frontdoor_client,
            args=(door.port, shards[c], args.pipeline_depth,
                  lats[c], errs[c]),
            daemon=True,
        )
        for c in range(args.frontdoor_connections)
    ]
    t0 = time.perf_counter()
    for t in clients:
        t.start()
    for t in clients:
        t.join()
    t_front = time.perf_counter() - t0
    stop.set()
    pub_thread.join(timeout=5)
    steady = reg.counter("jax.retraces_total").value - retraces_before
    stats = door.codec_stats()
    door.close()
    engine.close()
    flat = [x * 1e3 for part in lats for x in part]
    n_err = sum(len(e) for e in errs)
    qps = len(flat) / t_front if t_front > 0 else 0.0
    return {
        "native": stats["native"],
        "encodes": stats["encodes"],
        "fallbacks": stats["fallbacks"],
        "queries_per_sec": round(qps, 1),
        "p50_ms_under_publish": round(quantile(flat, 0.50), 3),
        "p99_ms_under_publish": round(quantile(flat, 0.99), 3),
        "http_baseline_queries_per_sec": round(http_qps, 1),
        "speedup_vs_http": round(qps / http_qps, 2) if http_qps else None,
        "connections": args.frontdoor_connections,
        "pipeline_depth": args.pipeline_depth,
        "readers": args.frontdoor_readers,
        "queries": len(flat),
        "errors": n_err,
        "publishes": publishes[0],
        "steady_retraces": steady,
        "stable": bool(steady == 0 and n_err == 0),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--players", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=5_000,
                    help="batched-phase winprob queries")
    ap.add_argument("--naive-queries", type=int, default=300,
                    help="naive-baseline winprob queries")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument(
        "--shards", type=int, default=8,
        help="sharded-plane phase width (0 skips the phase — the "
        "benchdiff gate will flag the vanished block)",
    )
    ap.add_argument(
        "--frontdoor", action="store_true",
        help="measure the concurrent socket plane (serve/frontdoor.py) "
        "vs the stdlib HTTP path, under concurrent publishes — emits "
        "the `frontdoor` block benchdiff gates on",
    )
    ap.add_argument("--frontdoor-queries", type=int, default=20_000)
    ap.add_argument("--frontdoor-connections", type=int, default=32)
    ap.add_argument("--pipeline-depth", type=int, default=8)
    ap.add_argument("--frontdoor-readers", type=int, default=4)
    ap.add_argument("--http-queries", type=int, default=1_000,
                    help="stdlib-plane baseline queries (urlopen each)")
    ap.add_argument("--out", help="also write the artifact to this path")
    ap.add_argument("--device", default=None,
                    help="torch device of the planes (default: the card)")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    reg = get_registry()

    t0 = time.perf_counter()
    table, ids, cfg = build_table(args.players, args.seed)
    publisher = ViewPublisher(device=args.device)
    view = publisher.publish_rows(ids, table[: args.players])
    t_build = time.perf_counter() - t0
    engine = QueryEngine(publisher, cfg=cfg, max_batch=args.max_batch,
                         device=args.device)

    t0 = time.perf_counter()
    shapes = engine.warmup(view)
    t_warm = time.perf_counter() - t0

    # -- naive baseline: one dispatch per query --------------------------
    naive_q = gen_matchups(args.players, args.naive_queries, args.seed + 1)
    t0 = time.perf_counter()
    for a, b in naive_q:
        engine.query_now("winprob", (a, b))
    t_naive = time.perf_counter() - t0
    naive_qps = args.naive_queries / t_naive if t_naive > 0 else 0.0

    # -- batched steady state: async flood through the tick thread ------
    batched_q = gen_matchups(args.players, args.queries, args.seed + 2)
    retraces_before = reg.counter("jax.retraces_total").value
    engine.start()
    t0 = time.perf_counter()
    pendings = [engine.submit("winprob", p) for p in batched_q]
    for p in pendings:
        p.result(timeout=120.0)
    t_batched = time.perf_counter() - t0
    engine.close()
    qps = args.queries / t_batched if t_batched > 0 else 0.0
    retraces_after = reg.counter("jax.retraces_total").value

    latencies_ms = [
        p.latency_s * 1e3 for p in pendings if p.latency_s is not None
    ]
    occ = reg.histogram(
        "serve.microbatch_occupancy", kind="winprob"
    ).summary()

    # -- sharded plane: same workload through per-shard views ------------
    single_lb_ms = leaderboard_ms(engine, k=100)
    sharded = None
    if args.shards > 0:
        sharded = sharded_phase(
            args, table, ids, cfg, reg, t_batched, single_lb_ms, engine
        )

    # -- front door: socket plane under concurrent publishes -------------
    frontdoor = None
    if args.frontdoor:
        frontdoor = frontdoor_phase(
            args, publisher, ids, table, cfg, reg, engine
        )

    steady_retraces = retraces_after - retraces_before
    speedup = qps / naive_qps if naive_qps > 0 else None
    line = {
        "metric": "serve.queries_per_sec",
        "value": round(qps, 1),
        "latency_ms": {
            "p50": round(quantile(latencies_ms, 0.50), 3),
            "p99": round(quantile(latencies_ms, 0.99), 3),
        },
        "naive": {
            "queries_per_sec": round(naive_qps, 1),
            "queries": args.naive_queries,
        },
        "speedup_vs_naive": round(speedup, 2) if speedup else None,
        "players": args.players,
        "queries": args.queries,
        "max_batch": args.max_batch,
        "occupancy": {
            "mean": occ["mean"], "p50": occ["p50"], "p99": occ["p99"],
        },
        "sharded": sharded,
        "frontdoor": frontdoor,
        "phases": {
            "build_s": round(t_build, 3),
            "warmup_s": round(t_warm, 3),
            "naive_s": round(t_naive, 3),
            "batched_s": round(t_batched, 3),
        },
        "telemetry": {
            "warmup_shapes": shapes,
            "retraces_total": retraces_after,
            "steady_retraces": steady_retraces,
            # Nothing compiles: every device function is eager PyTorch.
            "backend_compiles_total": 0,
            "steady_backend_compiles": 0,
        },
        "capture": {
            # The 5x bar and the flat-retrace bar are the artifact's
            # health: a capture missing either is reported degraded and
            # benchdiff will not gate on it.
            "degraded": bool(
                steady_retraces != 0 or (speedup is not None and speedup < 5.0)
            ),
        },
    }
    print(json.dumps(line))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(line, f, indent=1, sort_keys=True)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
