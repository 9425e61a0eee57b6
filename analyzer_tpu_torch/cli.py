"""Command-line interface of the port: ``python -m analyzer_tpu_torch.cli
synth | rate | serve | query | worker``.

Counterparts of the same subcommands of ``analyzer_tpu.cli``, with the JAX
package's flags, defaults, error texts (exit 2) and JSON lines.

``rate`` is the TrueSkill full-history re-rate of a match stream file with
checkpoint/resume. Routing is the JAX package's:

  * no ``--checkpoint`` and no ``--stop-after-steps``: the fully streamed
    path, :func:`~analyzer_tpu_torch.sched.runner.rate_stream` (the
    schedule is assigned on a worker thread while the card rates);
  * otherwise ``pack_schedule(windowed=True)`` then ``rate_history``, with
    periodic snapshots written asynchronously (``--checkpoint-every``), a
    snapshot at a ``--stop-after-steps`` bound, and a schedule-fingerprint
    check when ``--resume`` re-enters mid-schedule.

``--hot-rows N`` rates against a tiered table (an N-row hot set on the
device over a host cold tier; bit-identical results). ``rate --db URI``
reads the whole history from a reference-schema database instead of a
stream file (``SqlStore.load_stream``: the players' DB ratings are the
priors) and ``--db-write`` writes the final player ratings back.

``synth`` writes a synthetic history as ``.csv``, ``.npz`` or a
reference-schema sqlite ``.db``.

``serve --checkpoint ck.npz`` (or ``--db URI``, the player table of a
database, served by api id) publishes the table as version 1 and answers
``/v1/{ratings,leaderboard,winprob,tiers}`` from the device until
``--max-seconds`` passes or it is interrupted; ``query`` is one HTTP
request against such an endpoint.

``worker`` is the broker-consuming service loop (needs pika and a
RabbitMQ; ``--requeue-failed`` redrives the dead-letter queue).

``rate``, ``serve`` and ``worker`` run on the card (``--device cuda``, the
default) and refuse to start where there is none; ``--device cpu`` runs
them on the CPU. Not ported yet, each exiting 2 with its ROADMAP item:
``synth --telemetry`` (A12), ``serve --shards N>1`` and ``worker
--serve-shards N>1`` (A11b), ``worker --obs-port/--flight-dir/
--profile-dir/--audit`` (A16). The JAX ``rate`` flags ``--mesh``,
``--trace``, ``--metrics-out``, ``--trace-events`` and ``--obs-port``
(ROADMAP A14, A16) are not offered.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time
import types

import numpy as np


class PhaseTimer:
    """Accumulating wall-clock phase timer: ``with t.phase("pack"): ...``,
    then ``t.report()`` maps phase -> seconds."""

    def __init__(self) -> None:
        self.totals: dict = collections.defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0

    def report(self) -> dict:
        return dict(self.totals)


def _load_stream(path: str):
    from analyzer_tpu_torch.io.csv_codec import load_stream

    stream = load_stream(path)
    n_players = int(stream.player_idx.max()) + 1 if stream.n_matches else 0
    return stream, n_players


def _load_inputs(args, cfg, timer, device):
    """The rate paths' input loader: a CSV/npz stream file (--csv) or a
    columnar full-history DB ingest (--db, ``SqlStore.load_stream``).
    Returns (stream, n_players, db_state, db_store, player_ids) — the last
    three None on the file path; db_state carries the players' DB rating
    priors (on ``device``), which a fresh file run does not have."""
    if args.db:
        from analyzer_tpu_torch.service.sql_store import SqlStore

        with timer.phase("load"):
            store = SqlStore(args.db)
            hist = store.load_stream(cfg, device=device)
        return (
            hist.stream, hist.state.n_players, hist.state, store,
            hist.player_ids,
        )
    with timer.phase("load"):
        stream, n_players = _load_stream(args.csv)
    return stream, n_players, None, None, None


def _maybe_db_write(args, timer, db_store, state, player_ids) -> dict:
    """Final-table write-back for --db --db-write runs; returns a stats
    extra ({} when not writing)."""
    if db_store is None or not args.db_write:
        return {}
    with timer.phase("db_write"):
        n = db_store.write_players(state, player_ids)
    return {"players_written": n}


def _sync(state) -> None:
    """Waits for the card to finish the run, for honest phase times."""
    if state.table.is_cuda:
        import torch

        torch.cuda.synchronize(state.table.device)


def cmd_synth(args) -> int:
    """A synthetic match history: ``.csv``, ``.npz`` (with the players'
    archetype block, as the JAX package writes it) or a reference-schema
    sqlite ``.db`` for the DB lanes."""
    from analyzer_tpu_torch.io.csv_codec import save_stream
    from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream

    if args.synergy and not args.out.endswith(".npz"):
        # Archetypes ride only in the npz block; a synergy-driven stream
        # whose composition channel can't be saved would train heads
        # against unexplainable outcomes.
        print("error: --synergy requires an .npz output", file=sys.stderr)
        return 2
    if args.telemetry:
        print("error: synth --telemetry is not ported yet (ROADMAP A12, the "
              "models and their telemetry block)", file=sys.stderr)
        return 2
    players = synthetic_players(args.players, seed=args.seed)
    stream = synthetic_stream(
        args.matches, players, seed=args.seed,
        activity_concentration=args.concentration,
        max_activity_share=args.max_share or None,
        synergy_strength=args.synergy,
    )
    if args.out.endswith(".db"):
        from analyzer_tpu_torch.io.dbgen import write_history_db

        write_history_db(args.out, stream, players)
    else:
        save_stream(
            args.out, stream,
            # npz streams always carry the composition channel, as the JAX
            # package's do.
            archetype=players.archetype if args.out.endswith(".npz") else None,
        )
    print(f"wrote {stream.n_matches} matches / {args.players} players to "
          f"{args.out}")
    return 0


def _checkpoint_hook(args, sched, cursor, start_step, finished):
    """The periodic / bounded-run snapshot hook of the packed path. Returns
    ``(on_chunk, close)``: ``on_chunk`` is None when no save can be due;
    ``close`` drains the asynchronous writer (call it in a ``finally``).
    Periodic saves follow ``--checkpoint-every``; a bounded run always
    snapshots at its stop boundary; a finished run's final save is written
    by the caller, never here."""
    from analyzer_tpu_torch.io.checkpoint import CheckpointWriter

    if not args.checkpoint or (not args.checkpoint_every and finished):
        return None, lambda: None
    every = args.checkpoint_every or sched.n_steps + 1
    fingerprint = sched.fingerprint
    effective_stop = (
        sched.n_steps if finished else min(args.stop_after_steps, sched.n_steps)
    )
    last_saved = start_step
    writer = CheckpointWriter(args.checkpoint)

    def on_chunk(st, next_step):
        nonlocal last_saved
        due = next_step - last_saved >= every
        at_bound = not finished and next_step >= effective_stop
        if (not due and not at_bound) or (
            finished and next_step >= sched.n_steps
        ):
            return
        last_saved = next_step
        writer.save(
            st, cursor=cursor, step_cursor=next_step,
            schedule_fingerprint=fingerprint,
        )

    return on_chunk, writer.close


def _rate_stats(stream, cursor, n_players, state, sched, timer, **extra) -> str:
    """The JSON stats line of both rate paths."""
    mu = state.table[:n_players, 0].cpu().numpy()
    rated = ~np.isnan(mu)
    stats = {
        "matches": stream.n_matches - cursor,
        "players_rated": int(rated.sum()),
        "mean_mu": round(float(mu[rated].mean()), 2) if rated.any() else None,
        "supersteps": sched.n_steps,
        "occupancy": round(sched.occupancy, 3),
        **extra,
        "phases": {k: round(v, 3) for k, v in timer.report().items()},
    }
    return json.dumps(stats)


def _rate_streamed(args, cfg, timer, state, stream, cursor, n_players,
                   finalize=None) -> int:
    """The fully streamed path (``rate_stream``); its stats come from the
    runner's ``stats_out``, since the schedule never exists as one
    object. ``finalize(state) -> dict`` runs after the rate (the DB
    write-back) and its stats merge into the output line."""
    from analyzer_tpu_torch.sched import rate_stream

    stats: dict = {}
    with timer.phase("rate"):
        state, _ = rate_stream(
            state, stream.slice(cursor, stream.n_matches), cfg,
            stats_out=stats, prefetch_depth=args.prefetch_depth,
            kernel=args.kernel, fuse_window=args.fuse_window,
            hot_rows=args.hot_rows,
        )
        _sync(state)
    extra = finalize(state) if finalize is not None else {}
    sched_view = types.SimpleNamespace(
        n_steps=stats["n_steps"], occupancy=stats["occupancy"]
    )
    extra.setdefault(
        "choose_batch_size_s", round(stats["choose_batch_size_s"], 3)
    )
    print(_rate_stats(
        stream, cursor, n_players, state, sched_view, timer, **extra,
    ))
    return 0


def _validate_rate(args) -> bool:
    """The JAX package's flag checks (same texts); prints the first
    failure to stderr."""
    def fail(msg: str) -> bool:
        print(f"error: {msg}", file=sys.stderr)
        return False

    if args.resume and not args.checkpoint:
        return fail("--resume requires --checkpoint")
    for flag in ("checkpoint_every", "stop_after_steps", "prefetch_depth"):
        val = getattr(args, flag)
        if val is not None and val <= 0:
            return fail(f"--{flag.replace('_', '-')} must be positive")
    if args.checkpoint_every and not args.checkpoint:
        # Silently writing nothing would defeat the flag; --stop-after-steps
        # alone stays legal as a bounded smoke run (stats only).
        return fail("--checkpoint-every requires --checkpoint")
    if args.fuse_window is not None and args.fuse_window <= 0:
        return fail("--fuse-window must be positive")
    if args.hot_rows < 0:
        return fail("--hot-rows must be >= 0 (0 = untiered)")
    # Exactly one source; empty strings count as missing (``--db ""`` must
    # not slip past the xor and crash in the loader).
    args.csv = args.csv or None
    args.db = args.db or None
    if (args.csv is None) == (args.db is None):
        return fail("exactly one of --csv / --db is required")
    if args.db_write and not args.db:
        return fail("--db-write requires --db")
    if args.db_write and args.stop_after_steps is not None:
        # A bounded run never reaches the write-back; silently skipping it
        # would let a user believe partial ratings were persisted.
        return fail(
            "--db-write requires a finished run (drop --stop-after-steps, "
            "or resume to completion and write then)"
        )
    return True


def _resolve_device(args, verb: str):
    """The device ``--device`` names, or None after printing why not."""
    from analyzer_tpu_torch.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError:
        print(
            f"error: --device {args.device} asks for the CUDA card, but no "
            "CUDA device is visible (torch.cuda.is_available() is False); "
            f"pass --device cpu to {verb} on the CPU", file=sys.stderr,
        )
        return None


def cmd_rate(args) -> int:
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from analyzer_tpu_torch.sched import pack_schedule, rate_history

    cfg = RatingConfig.from_env()
    if not _validate_rate(args):
        return 2
    device = _resolve_device(args, "rate")
    if device is None:
        return 2
    timer = PhaseTimer()
    stream, n_players, db_state, db_store, player_ids = _load_inputs(
        args, cfg, timer, device
    )
    cursor, start_step = 0, 0
    ck = None
    if args.resume:
        with timer.phase("restore"):
            ck = load_checkpoint(args.checkpoint, device=device)
        state, cursor, start_step = ck.state, ck.cursor, ck.step_cursor
        print(
            f"resumed at match {cursor}/{stream.n_matches}"
            + (f", superstep {start_step}" if start_step else ""),
            file=sys.stderr,
        )
    elif db_state is not None:
        state = db_state  # DB rating priors, seeds baked by load_stream
    else:
        state = PlayerState.create(n_players, cfg=cfg, device=device)
    if not args.checkpoint and args.stop_after_steps is None:
        # No snapshots to coordinate: the fully streamed path.
        return _rate_streamed(
            args, cfg, timer, state, stream, cursor, n_players,
            finalize=lambda st: _maybe_db_write(
                args, timer, db_store, st, player_ids
            ),
        )
    with timer.phase("pack"):
        sched = pack_schedule(
            stream.slice(cursor, stream.n_matches),
            pad_row=state.pad_row,
            windowed=True,
        )
    if start_step and sched.fingerprint != ck.schedule_fingerprint:
        # A mid-schedule cursor means something only against the identical
        # schedule; resuming another would double-apply updates.
        print(
            "error: checkpoint was taken mid-schedule but the packed "
            "schedule no longer matches (stream file or packing policy "
            "changed); re-rate from scratch or from a full-run checkpoint",
            file=sys.stderr,
        )
        return 2
    finished = (args.stop_after_steps is None
                or args.stop_after_steps >= sched.n_steps)
    on_chunk, ck_close = _checkpoint_hook(args, sched, cursor, start_step, finished)
    try:
        with timer.phase("rate"):
            state, _ = rate_history(
                state, sched, cfg,
                start_step=start_step,
                stop_after=args.stop_after_steps,
                steps_per_chunk=(
                    min(8192, args.checkpoint_every)
                    if args.checkpoint_every else None
                ),
                on_chunk=on_chunk,
                prefetch_depth=args.prefetch_depth,
                kernel=args.kernel,
                fuse_window=args.fuse_window,
                hot_rows=args.hot_rows,
            )
            _sync(state)
    finally:
        ck_close()  # drains the asynchronous snapshot writes
    if args.checkpoint and finished:
        with timer.phase("checkpoint"):
            save_checkpoint(args.checkpoint, state, cursor=stream.n_matches)
    extra = (
        _maybe_db_write(args, timer, db_store, state, player_ids)
        if finished else {}
    )
    print(_rate_stats(stream, cursor, n_players, state, sched, timer, **extra))
    return 0


def cmd_serve(args) -> int:
    """ratesrv standalone: publish a rating table (checkpoint or DB) as
    version 1 and serve queries against it from the device."""
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.io.checkpoint import load_checkpoint
    from analyzer_tpu_torch.serve import QueryEngine, ViewPublisher
    from analyzer_tpu_torch.serve.server import ServeServer

    args.checkpoint = args.checkpoint or None
    args.db = args.db or None
    if (args.checkpoint is None) == (args.db is None):
        print("error: exactly one of --checkpoint / --db is required",
              file=sys.stderr)
        return 2
    if args.shards < 1:
        print("error: --shards must be >= 1", file=sys.stderr)
        return 2
    if args.shards > 1:
        print("error: serve --shards > 1 is not ported yet (ROADMAP A11b, "
              "the sharded plane); use --shards 1", file=sys.stderr)
        return 2
    device = _resolve_device(args, "serve")
    if device is None:
        return 2
    cfg = RatingConfig.from_env()
    publisher = ViewPublisher(device=device)
    if args.checkpoint:
        ck = load_checkpoint(args.checkpoint, device=device)
        # Checkpoints carry no id column: rows serve by index.
        view = publisher.publish_state(ck.state)
    else:
        from analyzer_tpu_torch.service.sql_store import SqlStore

        store = SqlStore(args.db)
        hist = store.load_stream(cfg, device=device)
        view = publisher.publish_state(hist.state, ids=hist.player_ids)
        store.close()
    engine = QueryEngine(
        publisher, cfg=cfg, max_batch=args.max_batch, device=device
    )
    engine.warmup(view)  # no first-query stall
    engine.start()
    server = ServeServer(engine, port=args.port)
    print(json.dumps({
        "serving": server.url,
        "players": view.n_players,
        "version": view.version,
        "shards": args.shards,
        "source": args.checkpoint or args.db,
    }))
    sys.stdout.flush()
    try:
        deadline = (
            None if args.max_seconds is None
            else time.monotonic() + args.max_seconds
        )
        while deadline is None or time.monotonic() < deadline:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        engine.close()
    return 0


def cmd_query(args) -> int:
    """One query against a running serve endpoint — the operator's curl
    with the URL assembly done for them."""
    import urllib.error
    import urllib.parse
    import urllib.request

    params = {}
    if args.kind == "ratings":
        if not args.ids:
            print("error: ratings needs --ids a,b,c", file=sys.stderr)
            return 2
        params["ids"] = args.ids
    elif args.kind == "leaderboard":
        params["k"] = str(args.k)
    elif args.kind == "winprob":
        if not (args.a and args.b):
            print("error: winprob needs --a ids and --b ids", file=sys.stderr)
            return 2
        params["a"] = args.a
        params["b"] = args.b
    elif args.kind == "tiers" and args.score is not None:
        params["score"] = str(args.score)
    url = (
        args.url.rstrip("/") + "/v1/" + args.kind
        + ("?" + urllib.parse.urlencode(params) if params else "")
    )
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            body = resp.read().decode("utf-8")
    except urllib.error.HTTPError as err:
        print(err.read().decode("utf-8"), end="")
        print(f"error: {url} -> HTTP {err.code}", file=sys.stderr)
        return 1
    except (urllib.error.URLError, ValueError) as err:
        # URLError: nothing listening; ValueError: a malformed --url
        reason = getattr(err, "reason", err)
        print(f"error: {url}: {reason}", file=sys.stderr)
        return 1
    print(body, end="")
    return 0


def cmd_worker(args) -> int:
    """The broker-consuming service loop (``service.worker.main``), or with
    ``--requeue-failed`` the dead-letter redrive. Both need pika and a
    RabbitMQ."""
    from analyzer_tpu_torch.service.worker import A11B, A16

    refused = [flag for flag, on in (
        ("--obs-port", args.obs_port is not None),
        ("--flight-dir", args.flight_dir is not None),
        ("--profile-dir", args.profile_dir is not None),
        ("--audit", args.audit),
    ) if on]
    if refused:
        print(f"error: worker {' '.join(refused)} is not ported yet ({A16})",
              file=sys.stderr)
        return 2
    if args.serve_shards is not None and args.serve_shards > 1:
        print(f"error: worker --serve-shards > 1 is not ported yet ({A11B}); "
              "use --serve-shards 1", file=sys.stderr)
        return 2
    if args.requeue_failed:
        # Dead-letter redrive: move <QUEUE>_failed back onto the main
        # queue and exit — run after fixing whatever poisoned them.
        from analyzer_tpu_torch.config import ServiceConfig
        from analyzer_tpu_torch.service.broker import make_pika_broker
        from analyzer_tpu_torch.service.worker import requeue_failed

        config = ServiceConfig.from_env()
        # Deliberately NOT config.prefetch_count: the redrive acks each
        # message right after republish (no deferred-ack window to
        # cover), and the prefetch bound is also the worst-case
        # duplicate window on a mid-drain crash — keep it one batch.
        broker = make_pika_broker(
            config.rabbitmq_uri, prefetch=config.batch_size
        )
        n = requeue_failed(broker, config)
        print(json.dumps({"requeued": n, "queue": config.queue}))
        return 0
    device = _resolve_device(args, "run the worker")
    if device is None:
        return 2
    from analyzer_tpu_torch.service.worker import main as worker_main

    worker_main(serve_port=args.serve_port, serve_shards=args.serve_shards,
                device=device)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="analyzer_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("synth", help="generate a synthetic match history (.csv/.npz)")
    s.add_argument("--matches", type=int, default=1000)
    s.add_argument("--players", type=int, default=300)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--concentration", type=float, default=0.8)
    s.add_argument(
        "--max-share", type=float, default=0.0, metavar="FRAC",
        help="cap any player's expected share of match slots (bench.py "
        "uses 1e-4: a physically plausible ladder; 0 = uncapped Zipf, "
        "whose top grinder chains the whole schedule — io/synthetic.py)",
    )
    s.add_argument(
        "--out", required=True,
        help=".csv (python parser), .npz (binary), or .db "
        "(reference-schema sqlite for the --db lanes)",
    )
    s.add_argument(
        "--telemetry", action="store_true",
        help="post-game telemetry for the analysis head (not ported yet: "
        "ROADMAP A12)",
    )
    s.add_argument(
        "--synergy", type=float, default=0.0, metavar="STRENGTH",
        help="composition-dependent outcome term: teams gain "
        "STRENGTH*400 skill points per unit of mean archetype-pair "
        "synergy (io/synthetic.py synergy_matrix) (.npz only)",
    )
    s.set_defaults(fn=cmd_synth)

    s = sub.add_parser("rate", help="TrueSkill full-history re-rate of a stream")
    s.add_argument("--csv", help="match stream, .csv or .npz")
    s.add_argument(
        "--db", metavar="URI",
        help="full-history columnar ingest straight from a database "
        "(sqlite:///... or mysql://...; the reference's actual data "
        "source, worker.py:176-191) — player rating priors come from "
        "the player table",
    )
    s.add_argument(
        "--db-write", action="store_true",
        help="with --db: bulk-write the final player ratings back",
    )
    s.add_argument("--checkpoint", help="state snapshot path (.npz)")
    s.add_argument("--resume", action="store_true", help="resume from --checkpoint")
    s.add_argument(
        "--checkpoint-every", type=int, metavar="STEPS",
        help="also snapshot every N supersteps mid-run (crash blast radius; "
        "the reference commits every 500-match batch, worker.py:194)",
    )
    s.add_argument(
        "--stop-after-steps", type=int, metavar="STEPS",
        help="stop after this superstep (bounded runs; a snapshot is always "
        "written at the stop boundary when --checkpoint is set)",
    )
    s.add_argument(
        "--prefetch-depth", type=int, metavar="N",
        help="feed ring depth (default 2): how many chunks ahead the feed "
        "thread stages while the card rates; results do not depend on it",
    )
    s.add_argument(
        "--kernel", choices=("reference", "fused"),
        default=os.environ.get("BENCH_KERNEL", "reference"),
        help="'reference' = one plain-PyTorch superstep at a time; 'fused' "
        "= windows of --fuse-window supersteps through the hand-written "
        "CUDA kernel (bit-identical results). Default from BENCH_KERNEL, "
        "else reference",
    )
    s.add_argument(
        "--fuse-window", type=int, metavar="K",
        default=int(os.environ.get("BENCH_FUSE_WINDOW", 0)) or None,
        help="supersteps per fused window (default 16; env "
        "BENCH_FUSE_WINDOW); a working set over its row budget splits the "
        "window (a counted spill)",
    )
    s.add_argument(
        "--hot-rows", type=int, metavar="N",
        default=int(os.environ.get("BENCH_HOT_ROWS", 0)),
        help="tiered ratings table (default 0 = untiered): keep only an "
        "N-row hot set (rounded up to a power of two) of the player table "
        "in device memory, spilling cold rows to a host tier promoted "
        "ahead of need on the feed thread; results bit-identical at every "
        "size (sched/tier.py)",
    )
    s.add_argument(
        "--device", default="cuda",
        help="where to rate: cuda (default; refuses to start without a "
        "card) or cpu",
    )
    s.set_defaults(fn=cmd_rate)

    s = sub.add_parser(
        "serve",
        help="ratesrv: serve lookups/leaderboards/win-probability over a "
        "rating table",
    )
    s.add_argument("--checkpoint", help="rating-state snapshot (.npz)")
    s.add_argument(
        "--db", metavar="URI",
        help="serve the player table of a reference-schema database "
        "(sqlite:///... or mysql://...)",
    )
    s.add_argument(
        "--port", type=int, default=0, metavar="PORT",
        help="bind port (default 0 = ephemeral; the bound URL prints as "
        "one JSON line on stdout)",
    )
    s.add_argument(
        "--max-batch", type=int, default=256, metavar="N",
        help="microbatch coalescing cap per tick (default: 256)",
    )
    s.add_argument(
        "--max-seconds", type=float, metavar="S",
        help="serve for S seconds then exit (default: forever; smoke "
        "tests and drills)",
    )
    s.add_argument(
        "--shards", type=int, default=1, metavar="S",
        help="serve through the sharded plane (not ported yet beyond 1: "
        "ROADMAP A11b)",
    )
    s.add_argument(
        "--device", default="cuda",
        help="where the served table lives: cuda (default; refuses to "
        "start without a card) or cpu",
    )
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser(
        "query",
        help="one query against a running serve endpoint",
    )
    s.add_argument(
        "kind", choices=("ratings", "leaderboard", "winprob", "tiers"),
    )
    s.add_argument(
        "--url", required=True, metavar="URL",
        help="serve endpoint base, e.g. http://127.0.0.1:8391",
    )
    s.add_argument("--ids", metavar="A,B,C", help="ratings: player ids")
    s.add_argument("--k", type=int, default=10, help="leaderboard depth")
    s.add_argument("--a", metavar="IDS", help="winprob: team A ids")
    s.add_argument("--b", metavar="IDS", help="winprob: team B ids")
    s.add_argument(
        "--score", type=float,
        help="tiers: also report this conservative score's percentile",
    )
    s.add_argument("--timeout", type=float, default=10.0)
    s.set_defaults(fn=cmd_query)

    s = sub.add_parser("worker", help="broker-consuming service loop")
    s.add_argument(
        "--requeue-failed", action="store_true",
        help="redrive <QUEUE>_failed back onto the main queue and exit "
        "(run after fixing what dead-lettered them)",
    )
    s.add_argument(
        "--obs-port", type=int, metavar="PORT",
        help="obsd (not ported yet: ROADMAP A16)",
    )
    s.add_argument(
        "--flight-dir", metavar="DIR",
        help="flight-recorder dumps (not ported yet: ROADMAP A16)",
    )
    s.add_argument(
        "--serve-port", type=int, metavar="PORT",
        help="co-host the ratesrv query plane (/v1/ratings /v1/leaderboard "
        "/v1/winprob /v1/tiers on localhost:PORT, also "
        "ANALYZER_TPU_SERVE_PORT): a new view version publishes at every "
        "batch commit",
    )
    s.add_argument(
        "--serve-shards", type=int, metavar="S",
        help="serve through the sharded plane (not ported yet beyond 1: "
        "ROADMAP A11b)",
    )
    s.add_argument(
        "--profile-dir", metavar="DIR",
        help="device capture windows (not ported yet: ROADMAP A16)",
    )
    s.add_argument(
        "--audit", action="store_true",
        help="shadow audit of served queries (not ported yet: ROADMAP A16)",
    )
    s.add_argument(
        "--no-slo-plane", action="store_true",
        help="accepted for parity: the SLO plane is off until ROADMAP A16",
    )
    s.add_argument(
        "--device", default="cuda",
        help="where batches are rated: cuda (default; refuses to start "
        "without a card) or cpu",
    )
    s.set_defaults(fn=cmd_worker)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
