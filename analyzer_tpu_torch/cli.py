"""Command-line interface of the port: ``python -m analyzer_tpu_torch.cli
rate | serve | query``.

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
device over a host cold tier; bit-identical results).

``serve --checkpoint ck.npz`` publishes a finished re-rate's table as
version 1 and answers ``/v1/{ratings,leaderboard,winprob,tiers}`` from the
device until ``--max-seconds`` passes or it is interrupted; ``query`` is
one HTTP request against such an endpoint.

``rate`` and ``serve`` run on the card (``--device cuda``, the default) and
refuse to start where there is none; ``--device cpu`` runs them on the
CPU. The JAX flags ``--db``/``--db-write``, ``--mesh``, ``--trace``,
``--metrics-out``, ``--trace-events`` and ``--obs-port`` are not ported
yet (ROADMAP A10, A14, A16): ``serve --db`` and ``serve --shards N>1``
exit 2 naming their ROADMAP items.
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


def _sync(state) -> None:
    """Waits for the card to finish the run, for honest phase times."""
    if state.table.is_cuda:
        import torch

        torch.cuda.synchronize(state.table.device)


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


def _rate_streamed(args, cfg, timer, state, stream, cursor, n_players) -> int:
    """The fully streamed path (``rate_stream``); its stats come from the
    runner's ``stats_out``, since the schedule never exists as one
    object."""
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
    sched_view = types.SimpleNamespace(
        n_steps=stats["n_steps"], occupancy=stats["occupancy"]
    )
    print(_rate_stats(
        stream, cursor, n_players, state, sched_view, timer,
        choose_batch_size_s=round(stats["choose_batch_size_s"], 3),
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
    if not args.csv:
        return fail("--csv is required")
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
    with timer.phase("load"):
        stream, n_players = _load_stream(args.csv)
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
    else:
        state = PlayerState.create(n_players, cfg=cfg, device=device)
    if not args.checkpoint and args.stop_after_steps is None:
        # No snapshots to coordinate: the fully streamed path.
        return _rate_streamed(args, cfg, timer, state, stream, cursor, n_players)
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
    print(_rate_stats(stream, cursor, n_players, state, sched, timer))
    return 0


def cmd_serve(args) -> int:
    """ratesrv standalone: publish a checkpoint's rating table as version
    1 and serve queries against it from the device."""
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
    if args.db is not None:
        print("error: serve --db is not ported yet (ROADMAP A10, the service "
              "shell's SQL store); serve a --checkpoint", file=sys.stderr)
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
    ck = load_checkpoint(args.checkpoint, device=device)
    # Checkpoints carry no id column: rows serve by index.
    view = publisher.publish_state(ck.state)
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
        "source": args.checkpoint,
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="analyzer_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("rate", help="TrueSkill full-history re-rate of a stream")
    s.add_argument("--csv", help="match stream, .csv or .npz")
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
        help="serve the player table of a reference-schema database (not "
        "ported yet: ROADMAP A10)",
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
