"""Command-line interface of the port: ``python -m analyzer_tpu_torch.cli
synth | rate | migrate | serve | query | worker | soak | fabric | bench |
benchdiff | tune | metrics | history | trace | profile | elo | train |
quality | fleet``.

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

``synth`` writes a synthetic history as ``.csv``, ``.npz`` (``--telemetry``
adds the post-game telemetry block) or a reference-schema sqlite ``.db``.

``elo`` re-rates a stream or database with the Elo model; ``train`` fits
the logistic or MLP win-probability head on leak-free features with a
chronological holdout; ``quality`` renders the calibration ledger
(BASELINE configs 1, 3, 4; :mod:`analyzer_tpu_torch.models`).

``serve --checkpoint ck.npz`` (or ``--db URI``, the player table of a
database, served by api id) publishes the table as version 1 and answers
``/v1/{ratings,leaderboard,winprob,tiers}`` from the device until
``--max-seconds`` passes or it is interrupted; ``query`` is one HTTP
request against such an endpoint.

``worker`` is the broker-consuming service loop (needs pika and a
RabbitMQ; ``--requeue-failed`` redrives the dead-letter queue), with the
JAX worker's live planes: obsd (``--obs-port``), the flight recorder
(``--flight-dir``), the shadow audit (``--audit``) and the SLO plane (on
unless ``--no-slo-plane``).

Live introspection: ``rate``, ``serve``, ``bench`` and ``worker`` take
``--obs-port`` (obsd — ``/healthz /readyz /metrics /statusz /historyz
/sloz /qualityz /debug/snapshot /debug/flight`` on localhost; 0 =
ephemeral, the URL prints on stderr). ``history`` trend-renders the
history rings of a live obsd (``--url``), a saved ``history.json`` or a
flight-dump directory; ``fleet`` scrapes N obsd endpoints into one fleet
view (``--check``: one scrape, exit 1 on any burn).

``rate --trace DIR`` captures a ``torch.profiler`` trace of the rating
phase (``cli profile DIR`` attributes it), ``--metrics-out PATH`` writes
the telemetry snapshot after a successful run and ``--trace-events PATH``
the span ring as Chrome trace-event JSONL. ``metrics`` renders a snapshot
(JSON, Prometheus text or a summary), ``trace`` reconstructs batch
timelines from a trace-events export, and ``profile`` attributes a
capture directory's device time per kernel; each has the JAX package's
flags, exit codes and JSON.

``bench`` is the headline capture (:mod:`analyzer_tpu_torch.bench`: the
BENCH line, with ``--ingest`` the ingest line, with ``--migrate`` the
migration line), with the JAX package's flags routed into the same env
knobs. ``benchdiff`` is the regression gate over two artifacts of a
family (BENCH, SERVE_BENCH, INGEST, MIGRATE, SOAK, FABRIC;
:mod:`analyzer_tpu_torch.obs.benchdiff`): exit 1 on a gated regression or
a violated absolute gate, 2 on unreadable input. ``tune`` is the tuning
advisor (:mod:`analyzer_tpu_torch.obs.advisor`): a deterministic report of
the knobs those artifacts and a profile capture point at. The JAX
package's ``cli lint`` has no counterpart: ``tests/test_torch_lint.py``
runs graftlint over the port.

``migrate`` is the zero-downtime re-rate of a CSV history
(:mod:`analyzer_tpu_torch.migrate`): the streamed decode -> assign ->
dispatch backfill into a staging view lineage, the atomic cutover, and
checkpoint / resume (``--checkpoint`` / ``--checkpoint-every`` /
``--stop-after-steps`` / ``--resume``). ``soak`` is the closed-loop
matchmaking soak (:mod:`analyzer_tpu_torch.loadgen`), exit 1 on an SLO
violation; ``--out`` writes the ``SOAK_r*.json`` artifact. ``soak
--serve-http`` queries through the serve front door
(:mod:`analyzer_tpu_torch.serve.frontdoor`); ``soak --hosts N`` runs the
soak over N shard-owning fabric host subprocesses
(:mod:`analyzer_tpu_torch.fabric`, a FABRIC-shaped artifact). ``fabric``
brings up a standing fabric of host processes and prints one JSON line a
host.

``rate``, ``migrate``, ``serve``, ``worker``, ``soak``, ``fabric``,
``bench``, ``elo`` and ``train`` run on the card (``--device cuda``, the
default) and refuse to start where there is none; ``--device cpu`` runs them on the CPU. ``rate --mesh N`` and ``train
--mesh N`` run data-parallel over an N-shard mesh (``parallel/``; with the
``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID`` env, ``--mesh
0`` runs one shard per process of a ``torch.distributed`` group, NCCL on
the card and gloo on the CPU); ``serve --shards N`` and ``worker
--serve-shards N`` serve through the sharded plane.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

import numpy as np

from analyzer_tpu_torch.utils.profiling import PhaseTimer, trace


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
    archetype block and, with ``--telemetry``, the post-game telemetry
    block, as the JAX package writes them) or a reference-schema sqlite
    ``.db`` for the DB lanes."""
    from analyzer_tpu_torch.io.csv_codec import save_stream
    from analyzer_tpu_torch.io.synthetic import (
        synthetic_players,
        synthetic_stream,
        synthetic_telemetry,
    )

    if args.synergy and not args.out.endswith(".npz"):
        # Archetypes ride only in the npz block; a synergy-driven stream
        # whose composition channel can't be saved would train heads
        # against unexplainable outcomes.
        print("error: --synergy requires an .npz output", file=sys.stderr)
        return 2
    players = synthetic_players(args.players, seed=args.seed)
    stream = synthetic_stream(
        args.matches, players, seed=args.seed,
        activity_concentration=args.concentration,
        max_activity_share=args.max_share or None,
        synergy_strength=args.synergy,
    )
    telemetry = None
    if args.telemetry:
        if not args.out.endswith(".npz"):
            print("error: --telemetry requires an .npz output", file=sys.stderr)
            return 2
        telemetry = synthetic_telemetry(stream, players, seed=args.seed)
    if args.out.endswith(".db"):
        from analyzer_tpu_torch.io.dbgen import write_history_db

        write_history_db(args.out, stream, players)
    else:
        save_stream(
            args.out, stream, telemetry=telemetry,
            # npz streams always carry the composition channel, as the JAX
            # package's do.
            archetype=players.archetype if args.out.endswith(".npz") else None,
        )
    print(f"wrote {stream.n_matches} matches / {args.players} players to "
          f"{args.out}" + (" (+telemetry)" if telemetry is not None else ""))
    return 0


def _require_one_source(args) -> bool:
    """Validates that EXACTLY one of --csv / --db names a source,
    normalizing empty strings to missing (``--db ""`` must not slip past
    the xor and crash in the loader). Shared by elo and train."""
    args.csv = getattr(args, "csv", None) or None
    args.db = getattr(args, "db", None) or None
    if (args.csv is None) == (args.db is None):
        print("error: exactly one of --csv / --db is required",
              file=sys.stderr)
        return False
    return True


def _auc(p: np.ndarray, y: np.ndarray) -> float | None:
    """ROC AUC via the Mann-Whitney U statistic, tie-averaged ranks."""
    pos = y == 1.0
    n1, n0 = int(pos.sum()), int((~pos).sum())
    if n1 == 0 or n0 == 0:
        return None
    order = np.argsort(p, kind="mergesort")
    sp = p[order]
    first = np.r_[True, sp[1:] != sp[:-1]]
    grp = np.cumsum(first) - 1
    counts = np.bincount(grp)
    starts = np.cumsum(counts) - counts
    avg = starts + (counts - 1) / 2.0 + 1.0
    ranks = np.empty(p.size)
    ranks[order] = avg[grp]
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2.0) / (n1 * n0))


def _ece(p: np.ndarray, y: np.ndarray, bins: int = 10) -> float:
    """Expected calibration error over equal-width probability bins."""
    idx = np.clip((p * bins).astype(int), 0, bins - 1)
    err = 0.0
    for b in range(bins):
        sel = idx == b
        if sel.any():
            err += abs(p[sel].mean() - y[sel].mean()) * sel.mean()
    return float(err)


def _half_credit_accuracy(p: np.ndarray, team0_won: np.ndarray) -> float:
    """Prediction accuracy with exact ties (p == 0.5, e.g. two fresh
    teams) scoring half credit instead of silently counting as "team 0
    predicted" — shared by the elo and train evals."""
    hit = np.where(p == 0.5, 0.5, (p > 0.5) == (team0_won == 1.0))
    return float(hit.mean())


def cmd_elo(args) -> int:
    """BASELINE config 1: the Elo re-rate of a stream or database over the
    TrueSkill schedule, with its pre-match prediction accuracy."""
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.models import elo_history
    from analyzer_tpu_torch.sched import pack_schedule

    if not _require_one_source(args):
        return 2
    device = _resolve_device(args, "elo")
    if device is None:
        return 2
    timer = PhaseTimer()
    stream, n_players, _, _, _ = _load_inputs(
        args, RatingConfig.from_env(), timer, device
    )
    # Windowed: elo_history reads windows and match_idx only, so the
    # gather tensors materialize per chunk here too.
    with timer.phase("pack"):
        sched = pack_schedule(stream, pad_row=n_players, windowed=True)
    with timer.phase("rate"):
        ratings, expected = elo_history(sched, n_players, device=device)
    ratable = stream.ratable
    if ratable.any():
        acc = _half_credit_accuracy(
            expected[ratable], (stream.winner[ratable] == 0).astype(np.float32)
        )
    else:
        acc = None
    if args.out:
        np.savez(args.out, ratings=ratings, expected=expected)
    print(json.dumps({
        "matches": stream.n_matches,
        "players": n_players,
        "mean_rating": round(float(ratings.mean()), 2),
        "prediction_accuracy": round(acc, 4) if acc is not None else None,
        "phases": {k: round(v, 3) for k, v in timer.report().items()},
    }))
    return 0


def cmd_train(args) -> int:
    """BASELINE configs 3-4: win-probability heads over rating features.

    Features are leak-free (each match's row comes from the PRE-match
    rating state during one pass — models/features.py), and the
    evaluation split is CHRONOLOGICAL: train on the first (1 - eval_frac)
    of ratable matches, evaluate on the tail, as a deployed predictor sees
    time. Exact-tie predictions score half credit, as in cmd_elo.
    ``--mesh N`` trains data-parallel over an N-shard mesh (0 = one shard
    per process)."""
    import torch

    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.models import history_features, train_logistic, train_mlp
    from analyzer_tpu_torch.models.calibration import apply_temperature, fit_temperature
    from analyzer_tpu_torch.sched import pack_schedule

    if not (0.0 <= args.eval_frac < 1.0):
        print("error: --eval-frac must be in [0, 1)", file=sys.stderr)
        return 2
    if not _require_one_source(args):
        return 2
    if args.telemetry and args.db:
        print(
            "error: --telemetry needs an .npz stream (databases carry no "
            "telemetry block); use --csv", file=sys.stderr,
        )
        return 2
    device = _resolve_device(args, "train")
    if device is None:
        return 2
    cfg = RatingConfig.from_env()
    timer = PhaseTimer()
    stream, n_players, _, _, _ = _load_inputs(args, cfg, timer, device)
    # ALWAYS cold-start, even on the DB lane: a database's stored ratings
    # are usually the END state of rating this very history, so seeding
    # features from them would leak every match's own outcome into its
    # "pre-match" features and inflate the chronological holdout.
    state = PlayerState.create(n_players, cfg=cfg, device=device)
    with timer.phase("features"):
        sched = pack_schedule(stream, pad_row=state.pad_row, windowed=True)
        feats, ratable, _ = history_features(state, sched, cfg, device=device)
        composition = False
        if args.csv:
            # PRE-MATCH composition features (teammate archetype-pair
            # count differences) when the stream carries the archetype
            # block — the channel through which a learned head can beat
            # the rating-only baseline (synth --synergy).
            from analyzer_tpu_torch.io.csv_codec import load_archetypes
            from analyzer_tpu_torch.models.features import composition_features

            arch = load_archetypes(args.csv)
            if arch is not None:
                feats = np.concatenate(
                    [feats, composition_features(arch, stream.player_idx)],
                    axis=1,
                )
                composition = True
        if args.telemetry:
            # Config 4's full-telemetry head: POST-GAME stats, so this
            # trains an analysis model (outcome from game stats), not a
            # forecast.
            from analyzer_tpu_torch.io.csv_codec import load_telemetry
            from analyzer_tpu_torch.models.features import telemetry_features

            tel = load_telemetry(args.csv)
            if tel is None:
                print(
                    "error: --telemetry needs an .npz stream with a "
                    "telemetry block (synth --telemetry)", file=sys.stderr,
                )
                return 2
            try:
                tfeat = telemetry_features(tel, stream.player_idx)
            except ValueError as err:  # e.g. an older-schema npz
                print(f"error: {err}", file=sys.stderr)
                return 2
            feats = np.concatenate([feats, tfeat], axis=1)
    y = (stream.winner == 0).astype(np.float32)
    rows = np.flatnonzero(ratable)  # stream order
    if rows.size < 10:
        print("error: too few ratable matches to train on", file=sys.stderr)
        return 2
    mesh = None
    if args.mesh is not None:
        from analyzer_tpu_torch.parallel import make_mesh

        mesh = make_mesh(args.mesh or None, device=device)
    cut = max(1, int(rows.size * (1.0 - args.eval_frac)))
    tr, ev = rows[:cut], rows[cut:]
    # Reserve the chronological tail of the train split for temperature
    # calibration — rows the model never fits. Too-small splits fall back
    # to fitting on (and calibrating from) everything.
    cal_cut = int(tr.size * 0.8)
    if tr.size - cal_cut >= 50:
        fit, cal = tr[:cal_cut], tr[cal_cut:]
    else:
        fit, cal = tr, tr
    with timer.phase("train"):
        if args.model == "logistic":
            model, nll = train_logistic(
                feats[fit], y[fit], epochs=args.epochs, seed=args.seed,
                mesh=mesh, device=device,
            )
        else:
            model, nll = train_mlp(
                feats[fit], y[fit], hidden=args.hidden,
                epochs=args.epochs, seed=args.seed, mesh=mesh,
                device=device,
            )

    def logits(rows_):
        with torch.no_grad():
            return model.logits(feats[rows_]).cpu().numpy()

    # Temperature-scale on the calibration slice (held out from the fit
    # above): fixes the head's raw over/under-confidence without touching
    # its ranking.
    temperature = fit_temperature(logits(cal), y[cal])

    def _metrics(p, yy):
        eps = 1e-7
        auc = _auc(p, yy)  # None on a single-class eval slice
        return {
            "accuracy": round(_half_credit_accuracy(p, yy), 4),
            "logloss": round(float(-np.mean(
                yy * np.log(p + eps) + (1 - yy) * np.log(1 - p + eps)
            )), 4),
            "auc": round(auc, 4) if auc is not None else None,
            "ece": round(_ece(p, yy), 4),
        }

    if ev.size:
        p = apply_temperature(logits(ev), temperature)
        m = _metrics(p, y[ev])
        acc, logloss = m["accuracy"], m["logloss"]
        auc, ece = m["auc"], m["ece"]
        # The rating-only baseline every head must beat: the closed-form
        # TrueSkill win probability from the same pre-match state
        # (feature column 2) with NO learned parameters, on the same split.
        baseline = _metrics(feats[ev, 2].astype(np.float64), y[ev])
    else:
        acc = logloss = auc = ece = baseline = None
    if args.out:
        # temperature rides along so artifact consumers reproduce the
        # reported (calibrated) probabilities; the weights under the JAX
        # package's names (models.model_from_numpy reads either file).
        np.savez(
            args.out,
            model=args.model,
            temperature=temperature,
            **{k: v.detach().cpu().numpy() for k, v in model.named_parameters()},
        )
    print(json.dumps({
        "model": args.model,
        "matches": stream.n_matches,
        "composition_features": composition,
        "trained_on": int(fit.size),
        "calibrated_on": int(cal.size) if cal is not fit else 0,
        "eval_on": int(ev.size),
        "train_nll": round(float(nll), 4),
        "eval_accuracy": acc,
        "eval_logloss": logloss,
        "eval_auc": auc,
        "eval_ece": ece,
        "baseline_rating_only": baseline,
        "temperature": round(temperature, 3),
        "phases": {k: round(v, 3) for k, v in timer.report().items()},
    }))
    return 0


def cmd_quality(args) -> int:
    """Rating-quality report: the calibration ledger's reliability table,
    streaming Brier / log-loss / ECE and the population-drift verdict —
    from a live worker's obsd ``/qualityz`` (``--url``), from a saved
    soak artifact's ``quality``
    block (``--artifact``), or from this process's own ledger (mostly
    empty outside a run). ``--fit-temperature`` fits a post-hoc
    temperature over the live ledger's retained (logit, outcome) prefix
    (models/calibration.py)."""
    summary = None
    if args.url:
        import urllib.request

        url = args.url.rstrip("/") + "/qualityz"
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                summary = json.load(resp)
        except OSError as err:
            print(f"error: cannot fetch {url}: {err}", file=sys.stderr)
            return 2
        if not summary.get("enabled", True):
            print(
                "error: worker runs with the quality ledger disabled",
                file=sys.stderr,
            )
            return 2
    elif args.artifact:
        try:
            with open(args.artifact, encoding="utf-8") as f:
                artifact = json.load(f)
        except (OSError, ValueError) as err:
            print(f"error: cannot read artifact: {err}", file=sys.stderr)
            return 2
        summary = artifact.get("quality")
        if not isinstance(summary, dict):
            print(
                "error: artifact has no quality block (soak ran with "
                "--no-quality?)", file=sys.stderr,
            )
            return 2
    ledger = None
    if summary is None:
        from analyzer_tpu_torch.obs.quality import get_quality_ledger

        ledger = get_quality_ledger()
        if ledger is None:
            from analyzer_tpu_torch.config import RatingConfig
            from analyzer_tpu_torch.obs.quality import CalibrationLedger

            ledger = CalibrationLedger(RatingConfig(), mirror=False)
        summary = ledger.summary()
    if args.fit_temperature:
        if ledger is None:
            print(
                "error: --fit-temperature needs the live ledger's "
                "retained (logit, outcome) pairs — /qualityz and the "
                "artifact carry only their count", file=sys.stderr,
            )
            return 2
        from analyzer_tpu_torch.models.calibration import fit_temperature

        z, y = ledger.retained()
        if not z.size:
            print(
                "error: no retained (logit, outcome) pairs to fit",
                file=sys.stderr,
            )
            return 2

        def _nll(t: float) -> float:
            zz = np.clip(z / t, -30.0, 30.0)
            p = 1.0 / (1.0 + np.exp(-zz))
            eps = 1e-12
            return float(-np.mean(
                y * np.log(p + eps) + (1.0 - y) * np.log(1.0 - p + eps)
            ))

        t = fit_temperature(z, y)
        summary["temperature"] = {
            "t": round(float(t), 4),
            "nll_before": round(_nll(1.0), 6),
            "nll_after": round(_nll(float(t)), 6),
            "n": int(z.size),
        }
    if args.json:
        json.dump(summary, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
        return 0
    from analyzer_tpu_torch.obs.quality import render_quality

    sys.stdout.write(render_quality(summary))
    return 0


def _checkpoint_hook(args, sched, cursor, start_step, finished, lead=True):
    """The periodic / bounded-run snapshot hook of the packed paths
    (single-device and ``--mesh``). Returns ``(on_chunk, close)``:
    ``on_chunk`` is None when no save can be due; ``close`` drains the
    asynchronous writer (call it in a ``finally``). Periodic saves follow
    ``--checkpoint-every``; a bounded run always snapshots at its stop
    boundary; a finished run's final save is written by the caller, never
    here.

    Multi-process discipline (the mesh path): the hook runs on EVERY
    process and gets the state as a thunk whose evaluation is a collective
    (the final gather); the cadence decision is a pure function of
    ``next_step``, so every process makes the same call. Only the lead
    process has a writer."""
    from analyzer_tpu_torch.io.checkpoint import CheckpointWriter

    if not args.checkpoint or (not args.checkpoint_every and finished):
        return None, lambda: None
    every = args.checkpoint_every or sched.n_steps + 1
    fingerprint = sched.fingerprint
    effective_stop = (
        sched.n_steps if finished else min(args.stop_after_steps, sched.n_steps)
    )
    last_saved = start_step
    writer = CheckpointWriter(args.checkpoint) if lead else None

    def on_chunk(st, next_step):
        nonlocal last_saved
        due = next_step - last_saved >= every
        at_bound = not finished and next_step >= effective_stop
        if (not due and not at_bound) or (
            finished and next_step >= sched.n_steps
        ):
            return
        last_saved = next_step
        if callable(st):  # mesh path: a collective snapshot, all processes
            st = st()
        if writer is not None:
            writer.save(
                st, cursor=cursor, step_cursor=next_step,
                schedule_fingerprint=fingerprint,
            )

    return on_chunk, (writer.close if writer is not None else lambda: None)


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
                   mesh=None, finalize=None, **extra) -> int:
    """The fully streamed path (``rate_stream``) of ``rate`` and ``rate
    --mesh``; its stats come from the runner's ``stats_out``, since the
    schedule never exists as one object. ``finalize(state) -> dict`` runs
    after the rate (the DB write-back) and its stats merge into the output
    line, as do ``extra``'s."""
    from analyzer_tpu_torch.sched import rate_stream

    stats: dict = {}
    with timer.phase("rate"), trace(args.trace):
        state, _ = rate_stream(
            state, stream.slice(cursor, stream.n_matches), cfg,
            stats_out=stats, mesh=mesh, prefetch_depth=args.prefetch_depth,
            kernel=args.kernel if mesh is None else "reference",
            fuse_window=args.fuse_window,
            hot_rows=args.hot_rows if mesh is None else 0,
        )
        _sync(state)
    if finalize is not None:
        extra.update(finalize(state))
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
    if args.mesh is not None and args.mesh < 0:
        return fail("--mesh must be >= 0 (0 = all devices)")
    if args.mesh is not None and args.kernel == "fused":
        return fail("--kernel fused is not supported with --mesh yet; "
                    "drop --mesh or use --kernel reference")
    if args.fuse_window is not None and args.fuse_window <= 0:
        return fail("--fuse-window must be positive")
    if args.hot_rows < 0:
        return fail("--hot-rows must be >= 0 (0 = untiered)")
    if args.mesh is not None and args.hot_rows:
        return fail("--hot-rows is not supported with --mesh yet; "
                    "drop --mesh or --hot-rows")
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


def _obs_serve(args):
    """Starts obsd for the duration of a CLI run when ``--obs-port`` was
    given (0 = ephemeral; the bound URL prints to stderr). Returns the
    server (the caller closes it) or None."""
    port = getattr(args, "obs_port", None)
    if port is None:
        return None
    from analyzer_tpu_torch.obs.server import ObsServer

    server = ObsServer(port=port)
    print(f"obsd listening on {server.url}", file=sys.stderr)
    return server


def _obs_write(args) -> None:
    """Writes the snapshot/trace artifacts a run asked for."""
    if getattr(args, "metrics_out", None):
        from analyzer_tpu_torch.obs import write_snapshot

        write_snapshot(args.metrics_out)
        print(f"wrote metrics snapshot to {args.metrics_out}", file=sys.stderr)
    if getattr(args, "trace_events", None):
        from analyzer_tpu_torch.obs import write_chrome_trace

        n = write_chrome_trace(args.trace_events)
        print(
            f"wrote {n} Chrome trace events to {args.trace_events} "
            "(open in Perfetto)", file=sys.stderr,
        )


def cmd_rate(args) -> int:
    server = _obs_serve(args)
    try:
        rc = _cmd_rate_impl(args)
        if rc == 0:
            _obs_write(args)
    finally:
        if server is not None:
            server.close()
    return rc


def _cmd_rate_impl(args) -> int:
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
    if args.mesh is not None:
        return _rate_mesh(args, cfg, timer, device)
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
        with timer.phase("rate"), trace(args.trace):
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


def _rate_mesh(args, cfg, timer, device) -> int:
    """The ``--mesh`` re-rate: data-parallel over an N-shard mesh
    (``parallel/``).

    One process: ``--mesh N`` runs N logical shards on ``device``.
    Several: set COORDINATOR_ADDRESS (``host:port``), NUM_PROCESSES and
    PROCESS_ID and run the same command in every process with ``--mesh 0``
    (one shard per process) or a multiple of the process count; the
    processes join one ``torch.distributed`` group (NCCL on the card, gloo
    on the CPU), each feeds its own shards of the identical deterministic
    schedule, and process 0 writes the checkpoint and the stats."""
    import math

    import torch.distributed as dist

    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from analyzer_tpu_torch.parallel import (
        assert_processes_agree,
        initialize_distributed,
        make_mesh,
        rate_history_sharded,
    )
    from analyzer_tpu_torch.parallel.multihost import process_count, process_index
    from analyzer_tpu_torch.sched import choose_batch_size, pack_schedule

    joined = not dist.is_initialized()
    distributed = initialize_distributed(device=device)
    joined = joined and distributed
    if distributed:
        print(f"rate --mesh: joined a {dist.get_backend()} process group, "
              f"rank {process_index()} of {process_count()}", file=sys.stderr)
    try:
        lead = process_index() == 0
        stream, n_players, db_state, db_store, player_ids = _load_inputs(
            args, cfg, timer, device
        )
        cursor, start_step = 0, 0
        ck = None
        if args.resume:
            with timer.phase("restore"):
                ck = load_checkpoint(args.checkpoint, device=device)
            state, cursor, start_step = ck.state, ck.cursor, ck.step_cursor
        elif db_state is not None:
            state = db_state
        else:
            state = PlayerState.create(n_players, cfg=cfg, device=device)
        # Every process must hold identical inputs before any is fed into
        # the sharded table — a stale checkpoint copy or divergent stream
        # file on one host would be silently wrong, not crash.
        assert_processes_agree(
            "rate --mesh inputs", state.table, stream.player_idx,
            stream.winner, stream.mode_id, stream.afk, np.int64(cursor),
            np.int64(start_step),
        )
        mesh = make_mesh(args.mesh or None, device=device)
        n_dev = mesh.n_shards
        if (
            not args.checkpoint
            and args.stop_after_steps is None
            and not distributed
        ):
            # No snapshots to coordinate: the fully streamed sharded path.
            # Multi-process runs keep the windowed schedule below: the
            # deterministic schedule keeps the processes in lockstep.
            return _rate_streamed(
                args, cfg, timer, state, stream, cursor, n_players,
                mesh=mesh, mesh_devices=n_dev, processes=1,
                finalize=lambda st: _maybe_db_write(
                    args, timer, db_store, st, player_ids
                ),
            )
        with timer.phase("pack"):
            work = stream.slice(cursor, stream.n_matches)
            # The sharded batch axis needs B % D == 0 and lane alignment
            # wants B % 8 == 0: round up to the lcm.
            m = math.lcm(8, n_dev)
            b = choose_batch_size(work, batch_multiple=m)
            b = -(-b // m) * m
            sched = pack_schedule(
                work, pad_row=state.pad_row, batch_size=b, windowed=True
            )
        if start_step and sched.fingerprint != ck.schedule_fingerprint:
            print(
                "error: checkpoint was taken mid-schedule but the packed "
                "schedule no longer matches (stream file, packing policy, or "
                "mesh size changed); re-rate from scratch or from a "
                "finished-run checkpoint",
                file=sys.stderr,
            )
            return 2
        finished = (args.stop_after_steps is None
                    or args.stop_after_steps >= sched.n_steps)
        on_chunk, ck_close = _checkpoint_hook(
            args, sched, cursor, start_step, finished, lead
        )
        try:
            with timer.phase("rate"), trace(args.trace):
                state = rate_history_sharded(
                    state, sched, cfg, mesh=mesh,
                    start_step=start_step, stop_after=args.stop_after_steps,
                    on_chunk=on_chunk,
                    steps_per_chunk=(
                        min(1024, args.checkpoint_every)
                        if args.checkpoint_every else 1024
                    ),
                    prefetch_depth=args.prefetch_depth,
                )
                _sync(state)
        finally:
            ck_close()  # drains the asynchronous snapshot writes
        if args.checkpoint and lead and finished:
            with timer.phase("checkpoint"):
                save_checkpoint(args.checkpoint, state, cursor=stream.n_matches)
        extra = (
            _maybe_db_write(args, timer, db_store, state, player_ids)
            if finished and lead else {}
        )
        if lead:
            print(_rate_stats(
                stream, cursor, n_players, state, sched, timer,
                mesh_devices=n_dev, processes=process_count(), **extra,
            ))
        return 0
    finally:
        if joined:
            dist.destroy_process_group()


def cmd_serve(args) -> int:
    """ratesrv standalone: publish a rating table (checkpoint or DB) as
    version 1 and serve queries against it from the device; with
    ``--obs-port`` obsd runs beside it (the ``serve.*`` metrics land in
    ``/metrics``)."""
    args.checkpoint = args.checkpoint or None
    args.db = args.db or None
    if (args.checkpoint is None) == (args.db is None):
        print("error: exactly one of --checkpoint / --db is required",
              file=sys.stderr)
        return 2
    if args.shards < 1:
        print("error: --shards must be >= 1", file=sys.stderr)
        return 2
    device = _resolve_device(args, "serve")
    if device is None:
        return 2
    obs = _obs_serve(args)
    try:
        return _serve(args, device)
    finally:
        if obs is not None:
            obs.close()


def _serve(args, device) -> int:
    """cmd_serve's body: publish, warm, serve until the deadline."""
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.io.checkpoint import load_checkpoint
    from analyzer_tpu_torch.serve import (
        QueryEngine,
        ShardedQueryEngine,
        ShardedViewPublisher,
        ViewPublisher,
    )
    from analyzer_tpu_torch.serve.server import ServeServer

    cfg = RatingConfig.from_env()
    # Topology-blind bootstrap (ServePlane): publish_state splits the table
    # by interleaved row ownership when sharded; everything below — warmup,
    # /v1/* — is the same code either way.
    sharded = args.shards > 1
    publisher = (
        ShardedViewPublisher(args.shards, device=device) if sharded
        else ViewPublisher(device=device)
    )
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
    if sharded:
        engine = ShardedQueryEngine(
            publisher, cfg=cfg, max_batch=args.max_batch,
            all_gather_topk=args.all_gather_topk, device=device,
        )
    else:
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


def cmd_metrics(args) -> int:
    """Renders a telemetry snapshot: a saved ``--metrics-out`` artifact
    (of either package) when a path is given, else the live registry of
    THIS process (mostly the declared schema — the metric catalog)."""
    from analyzer_tpu_torch.obs import prometheus_text, render_summary, snapshot

    if args.snapshot:
        try:
            with open(args.snapshot, encoding="utf-8") as f:
                snap = json.load(f)
        except (OSError, ValueError) as err:
            print(f"error: cannot read snapshot: {err}", file=sys.stderr)
            return 2
    else:
        snap = snapshot()
    if args.format == "prom":
        sys.stdout.write(prometheus_text(snap))
    elif args.format == "summary":
        sys.stdout.write(render_summary(snap))
    else:
        json.dump(snap, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    return 0


def cmd_trace(args) -> int:
    """Trace analyzer (obs/traceview.py): per-match / per-batch timelines
    from a trace-events JSONL (``--trace-events``) or a flight-recorder
    dump directory, with the stage decomposition and a critical-path
    report naming the dominant stage; several artifacts stitch into one
    cross-process forest. Needs an export with causal-trace events
    (``batch.assemble`` / ``trace.enqueue``: a worker's, with tracing on —
    ``ANALYZER_TPU_TRACE=1``); a ``rate`` run's export has none and exits
    2, as the JAX package's does."""
    from analyzer_tpu_torch.obs.traceview import (
        batch_report,
        build_model,
        critical_path,
        load_events,
        load_forest,
        match_report,
        render_batch,
        render_critical_path,
        render_match,
        verify_chain,
    )

    try:
        if len(args.artifact) == 1:
            events = load_events(args.artifact[0])
        else:
            events = load_forest(args.artifact)
    except (OSError, ValueError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    model = build_model(events)
    if not model.batches and not model.enqueue_ts:
        print(
            "error: no causal-trace events in the artifact — was the "
            "capture taken with tracing enabled (a worker run with "
            "ANALYZER_TPU_TRACE=1)? A rate run's export has none",
            file=sys.stderr,
        )
        return 2
    if args.match:
        report = match_report(model, args.match)
        if report is None:
            print(f"error: match {args.match!r} not in this trace",
                  file=sys.stderr)
            return 1
        problems = verify_chain(model, args.match)
        if args.json:
            report = dict(report, problems=problems)
            json.dump(report, sys.stdout, indent=1, sort_keys=True)
            sys.stdout.write("\n")
        else:
            sys.stdout.write(render_match(report))
            for p in problems:
                print(f"  incomplete: {p}")
        return 0
    if args.batch:
        bt = model.batches.get(args.batch)
        if bt is None:
            print(f"error: batch {args.batch!r} not in this trace",
                  file=sys.stderr)
            return 1
        report = batch_report(bt)
        if args.json:
            json.dump(report, sys.stdout, indent=1, sort_keys=True)
            sys.stdout.write("\n")
        else:
            sys.stdout.write(render_batch(report))
        return 0
    cp = critical_path(model, window=args.window or None)
    decomp = None
    if args.profile:
        # Join a capture dir's device trace against this host-side forest:
        # the critical path's `dispatch` stage decomposes into
        # device-execute / device-idle / host-overhead (obs/profview).
        from analyzer_tpu_torch.obs.profview import (
            analyze_capture,
            decompose_dispatch,
            render_decomposition,
        )

        att = analyze_capture(args.profile, update_metrics=False)
        decomp = decompose_dispatch(model, att)
        if decomp is None:
            print(
                f"note: profile {args.profile} did not join this trace "
                f"(parsed={str(bool(att.get('parsed'))).lower()})",
                file=sys.stderr,
            )
    if args.json:
        if decomp is not None:
            cp = dict(cp, dispatch_decomposition=decomp)
        json.dump(cp, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_critical_path(cp))
        if decomp is not None:
            sys.stdout.write(render_decomposition(decomp))
    return 0


def cmd_profile(args) -> int:
    """Profile attribution (obs/profview.py): reads a device-profiler
    capture dir (``rate --trace DIR``, or a ``worker --profile-dir``
    window's ``profile-<ts>-<reason>-<pid>/``), bins its device trace into
    a per-kernel device-time table and reports the busy/idle and
    compile/execute splits. A torn or missing trace reports ``parsed:
    false`` (exit 1) rather than crashing. With ``--trace-events``, also
    joins the capture against the host-side causal-trace forest and
    decomposes the ``dispatch`` stage."""
    from analyzer_tpu_torch.obs.profview import (
        analyze_capture,
        decompose_dispatch,
        render_attribution,
        render_decomposition,
    )

    att = analyze_capture(args.capture_dir, update_metrics=False)
    decomp = None
    if args.trace_events:
        from analyzer_tpu_torch.obs.traceview import build_model, load_forest

        try:
            model = build_model(load_forest(args.trace_events))
        except (OSError, ValueError) as err:
            print(f"error: {err}", file=sys.stderr)
            return 2
        decomp = decompose_dispatch(model, att)
    if args.json:
        out = dict(att)
        if decomp is not None:
            out["dispatch_decomposition"] = decomp
        json.dump(out, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_attribution(att))
        if decomp is not None:
            sys.stdout.write(render_decomposition(decomp))
    return 0 if att["parsed"] else 1


def cmd_bench(args) -> int:
    """The headline capture (:mod:`analyzer_tpu_torch.bench`). The flags
    ride the env, as the JAX package's ``cli bench`` routes them into
    bench.py's knobs, so ``cli bench --kernel ...`` and a bare
    ``BENCH_KERNEL=...`` run stay one code path."""
    from analyzer_tpu_torch import bench

    device = _resolve_device(args, "run the benchmark")
    if device is None:
        return 2
    if args.kernel:
        os.environ["BENCH_KERNEL"] = args.kernel
    if args.fuse_window:
        os.environ["BENCH_FUSE_WINDOW"] = str(args.fuse_window)
    if args.hot_rows:
        os.environ["BENCH_HOT_ROWS"] = str(args.hot_rows)
    if args.ingest:
        os.environ["BENCH_INGEST"] = "1"
    if args.migrate:
        os.environ["BENCH_MIGRATE"] = "1"
    if args.profile:
        os.environ["BENCH_PROFILE"] = "1"
    if args.profile_dir:
        os.environ["BENCH_PROFILE_DIR"] = args.profile_dir
    bench.main(metrics_out=args.metrics_out, obs_port=args.obs_port,
               device=device)
    return 0


def cmd_benchdiff(args) -> int:
    """Bench trajectory gate: per-config deltas between two BENCH_*.json
    artifacts; non-zero exit past ``--regress-pct`` (obs/benchdiff.py)."""
    from analyzer_tpu_torch.obs.benchdiff import (
        bench_configs,
        diff_configs,
        family_configs,
        find_bench_artifacts,
        latest_artifact,
        load_bench,
        render_diff,
    )

    paths = args.artifacts
    if args.against_latest:
        if len(paths) > 1:
            print(
                "error: --against-latest takes at most one artifact (the "
                "candidate)", file=sys.stderr,
            )
            return 2
        if paths:
            b_path = paths[0]
            a_path = latest_artifact(
                args.dir, exclude=b_path, family=args.family
            )
        else:
            arts = find_bench_artifacts(args.dir, family=args.family)
            a_path, b_path = (arts[-2], arts[-1]) if len(arts) >= 2 else (None, None)
        if a_path is None or b_path is None:
            from analyzer_tpu_torch.obs.benchdiff import FAMILIES

            print(
                f"error: not enough {FAMILIES[args.family]}_*.json "
                f"artifacts under {args.dir}",
                file=sys.stderr,
            )
            return 2
    elif len(paths) == 2:
        a_path, b_path = paths
    else:
        print(
            "error: benchdiff needs two artifacts (baseline candidate) or "
            "--against-latest", file=sys.stderr,
        )
        return 2
    try:
        a_raw = load_bench(a_path)
        b_raw = load_bench(b_path)
        a = family_configs(bench_configs(a_raw), args.family)
        b = family_configs(bench_configs(b_raw), args.family)
    except (OSError, ValueError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    rc = 0
    if args.family == "soak":
        # The soak family's ABSOLUTE half: SLOs re-derived from the
        # candidate's deterministic block (zero dead-letters, flat
        # steady-state retraces, bounded view staleness, drained
        # backlog), gated on the candidate alone — a regression-free
        # delta must not mask a violated SLO.
        from analyzer_tpu_torch.obs.benchdiff import soak_slo_violations

        violations = soak_slo_violations(b_raw)
        for v in violations:
            print(f"SLO VIOLATION: {v}")
        if violations:
            print(
                f"error: {os.path.basename(b_path)} violates "
                f"{len(violations)} soak SLO(s)", file=sys.stderr,
            )
            rc = 1
        # The vanished-block contract for the rating-quality plane: a
        # baseline whose artifact carried a calibration `quality` block
        # and a candidate without one means the ledger silently
        # disengaged (quality=False leaked into CI, or the scoring
        # site was dropped) — a delta gate would just diff fewer
        # configs and report "no regressions".
        a_quality = isinstance(a_raw.get("quality"), dict)
        b_quality = isinstance(b_raw.get("quality"), dict)
        if a_quality and not b_quality:
            print(
                f"error: {os.path.basename(b_path)} has no rating-quality "
                f"block but {os.path.basename(a_path)} does (calibration "
                "ledger silently disengaged?)",
                file=sys.stderr,
            )
            return 1
    if args.family == "fabric":
        # The fabric family's ABSOLUTE half, gated on the candidate
        # alone: lost work, dead letters, view staleness past the
        # configured tick bound, per-host steady-state retraces,
        # burning fleet objectives.
        from analyzer_tpu_torch.obs.benchdiff import fabric_slo_violations

        violations = fabric_slo_violations(b_raw)
        for v in violations:
            print(f"SLO VIOLATION: {v}")
        if violations:
            print(
                f"error: {os.path.basename(b_path)} violates "
                f"{len(violations)} fabric SLO(s)", file=sys.stderr,
            )
            rc = 1
        # The vanished-block contract for the fabric: a baseline
        # captured over a real multi-host topology and a candidate
        # whose fleet block reports a single process means the soak
        # silently fell back to one host — the exact regression this
        # family exists to catch (a single-process capture flatters
        # every remote-path number), and one a delta gate would merely
        # call "faster".
        a_hosts = int((a_raw.get("fleet") or {}).get("n_hosts") or 1)
        b_hosts = int((b_raw.get("fleet") or {}).get("n_hosts") or 1)
        if a_hosts > 1 and b_hosts <= 1:
            print(
                f"error: {os.path.basename(b_path)} captured a "
                f"single-process topology but {os.path.basename(a_path)} "
                f"ran {a_hosts} hosts (silent fall-back to "
                "single-process?)", file=sys.stderr,
            )
            return 1
    if args.family == "tiered" and a and not b:
        # The baseline captured a tiered block but the candidate has
        # none: the run silently fell back to untiered — exactly the
        # regression this family exists to catch.
        print(
            f"error: {os.path.basename(b_path)} has no tiered capture "
            f"but {os.path.basename(a_path)} does (silent fall-back to "
            "untiered?)", file=sys.stderr,
        )
        return 1
    if args.family == "ingest":
        # The vanished-block contract for the ingest plane: a baseline
        # captured with the native columnar decoder and a candidate
        # without it means the decode silently fell back to the python
        # codec — the exact regression this family exists to catch, and
        # one a delta gate would merely report as "slower".
        a_native = bool((a_raw.get("ingest") or {}).get("native"))
        b_native = bool((b_raw.get("ingest") or {}).get("native"))
        if a_native and not b_native:
            print(
                f"error: {os.path.basename(b_path)} has no native "
                f"columnar-decode capture but {os.path.basename(a_path)} "
                "does (silent fallback to the python codec?)",
                file=sys.stderr,
            )
            return 1
    if args.family == "migrate":
        # The vanished-block contract for the migration engine: a
        # baseline captured with the STREAMED backfill (decode->assign->
        # scan overlapped) and a candidate whose capture fell back to
        # the offline re-rate shape means the streaming front half
        # silently disengaged — the exact regression this family exists
        # to catch, and one a delta gate would merely call "slower".
        a_streamed = bool((a_raw.get("migrate") or {}).get("streamed"))
        b_streamed = bool((b_raw.get("migrate") or {}).get("streamed"))
        if a_streamed and not b_streamed:
            print(
                f"error: {os.path.basename(b_path)} has no streamed "
                f"backfill capture but {os.path.basename(a_path)} does "
                "(silent fall-back to the offline re-rate?)",
                file=sys.stderr,
            )
            return 1
        # And the assign-native contract (same pattern as the ingest
        # family's python-codec gate): a baseline whose front half ran
        # the GIL-released native windowed first-fit and a candidate
        # whose assign block reports native: false means the assigner
        # silently fell back to the python recurrence — a ~two-orders
        # front-half slowdown a delta gate would merely call "slower".
        a_native = bool((a_raw.get("assign") or {}).get("native"))
        b_native = bool((b_raw.get("assign") or {}).get("native"))
        if a_native and not b_native:
            print(
                f"error: {os.path.basename(b_path)} has no native "
                f"windowed-assigner capture but {os.path.basename(a_path)} "
                "does (silent fall-back to the python first-fit "
                "recurrence?)",
                file=sys.stderr,
            )
            return 1
    if args.family == "serve":
        # Same vanished-block contract for the shard plane: a baseline
        # with sharded.* configs and a candidate without them means the
        # bench silently fell back to the single-device engine.
        a_sharded = any(c.name.startswith("sharded.") for c in a)
        b_sharded = any(c.name.startswith("sharded.") for c in b)
        if a_sharded and not b_sharded:
            print(
                f"error: {os.path.basename(b_path)} has no sharded "
                f"capture but {os.path.basename(a_path)} does (silent "
                "fall-back to the single-device serve plane?)",
                file=sys.stderr,
            )
            return 1
        # And the front door's native-codec contract (same pattern as
        # the migrate family's assign-native gate): a baseline whose
        # socket plane rendered every response through the zero-copy
        # native codec and a candidate reporting native: false means the
        # codec silently fell back to python json.dumps — a route flip a
        # delta gate would merely call "slower".
        a_native = bool((a_raw.get("frontdoor") or {}).get("native"))
        b_native = bool((b_raw.get("frontdoor") or {}).get("native"))
        if a_native and not b_native:
            print(
                f"error: {os.path.basename(b_path)} has no native-codec "
                f"front door capture but {os.path.basename(a_path)} does "
                "(silent fall-back to the python json encoder?)",
                file=sys.stderr,
            )
            return 1
    # The vanished-block contract for profile intelligence (any family —
    # bench --profile stamps the block wherever a capture was armed): a
    # baseline whose device profile parsed and a candidate whose profile
    # block is missing or reports parsed:false means the candidate
    # silently stopped attributing its captures — its roofline rides
    # wall time again, and a delta gate would never notice.
    a_parsed = bool((a_raw.get("profile") or {}).get("parsed"))
    b_parsed = bool((b_raw.get("profile") or {}).get("parsed"))
    if a_parsed and not b_parsed:
        print(
            f"error: {os.path.basename(b_path)} has no parsed device "
            f"profile but {os.path.basename(a_path)} does (capture "
            "attribution silently broke?)", file=sys.stderr,
        )
        return 1
    if args.family in ("bench", "tiered"):
        # Absolute tracing-tax gate on the candidate alone: the bench's
        # trace_overhead block (tracing-on vs tracing-off on the same
        # config) must stay <= TRACE_OVERHEAD_MAX_PCT — causal tracing
        # that stops being ~free would silently tax every traced run.
        from analyzer_tpu_torch.obs.benchdiff import trace_overhead_violations

        overhead = trace_overhead_violations(b_raw)
        for v in overhead:
            print(f"TRACE OVERHEAD VIOLATION: {v}")
        if overhead:
            print(
                f"error: {os.path.basename(b_path)} fails the tracing "
                "overhead gate", file=sys.stderr,
            )
            rc = 1
        # Same absolute contract for the live SLO plane: the bench's
        # watchdog_overhead block (sampler+watchdog+audit on vs off on
        # the same e2e line) must stay <= WATCHDOG_OVERHEAD_MAX_PCT.
        from analyzer_tpu_torch.obs.benchdiff import watchdog_overhead_violations

        wd_overhead = watchdog_overhead_violations(b_raw)
        for v in wd_overhead:
            print(f"WATCHDOG OVERHEAD VIOLATION: {v}")
        if wd_overhead:
            print(
                f"error: {os.path.basename(b_path)} fails the SLO-plane "
                "overhead gate", file=sys.stderr,
            )
            rc = 1
        # And for the fleet plane: the bench's federate_overhead block
        # (a Collector scraping obsd under load vs unscraped on the
        # same e2e line) must stay <= FEDERATE_OVERHEAD_MAX_PCT.
        from analyzer_tpu_torch.obs.benchdiff import federate_overhead_violations

        fed_overhead = federate_overhead_violations(b_raw)
        for v in fed_overhead:
            print(f"FEDERATE OVERHEAD VIOLATION: {v}")
        if fed_overhead:
            print(
                f"error: {os.path.basename(b_path)} fails the "
                "federation overhead gate", file=sys.stderr,
            )
            rc = 1
    rows = diff_configs(a, b, args.regress_pct)
    sys.stdout.write(render_diff(a_path, b_path, rows))
    if any(r.regressed and r.gated for r in rows):
        print(
            f"error: throughput regressed more than {args.regress_pct:g}%",
            file=sys.stderr,
        )
        return 1
    return rc


def cmd_tune(args) -> int:
    """Tuning advisor (obs/advisor.py): a deterministic rule table over
    the artifacts the repo already emits (BENCH/SOAK/INGEST/MIGRATE
    JSON, history rings, profile attribution) that names the bottleneck
    and recommends concrete knob changes, each citing its evidence.
    Same inputs produce a byte-identical report — pipe it into a file
    and diff across runs. Exit 0 with findings or without; exit 2 only
    when no artifact loads at all."""
    from analyzer_tpu_torch.obs.advisor import advise, gather_inputs, render_report

    inputs = gather_inputs(
        paths=args.artifacts,
        scan_dir=args.dir if not args.artifacts else None,
        profile_dir=args.profile,
    )
    if not inputs["artifacts"] and not inputs["history"] \
            and inputs["profile"] is None:
        print(
            f"error: no artifacts loaded (looked at "
            f"{args.artifacts or args.dir})", file=sys.stderr,
        )
        return 2
    report = advise(inputs)
    if args.json:
        json.dump(report, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_report(report))
    return 0


def cmd_worker(args) -> int:
    """The broker-consuming service loop (``service.worker.main``), or with
    ``--requeue-failed`` the dead-letter redrive. Both need pika and a
    RabbitMQ."""
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

    worker_main(
        obs_port=args.obs_port, obs_host=args.obs_host,
        flight_dir=args.flight_dir,
        serve_port=args.serve_port, serve_shards=args.serve_shards,
        profile_dir=args.profile_dir,
        audit=True if args.audit else None,
        audit_sample_denom=args.audit_sample_denom,
        slo_plane=not args.no_slo_plane, device=device,
    )
    return 0


def cmd_history(args) -> int:
    """Telemetry history rings (obs/history.py): trend-render or dump the
    tiered time series — from a live obsd's ``/historyz`` (``--url``),
    from a saved ``history.json`` / flight-dump directory, or from this
    process's own sampler (mostly empty outside a run — useful to see the
    series list)."""
    payload = None
    if args.url:
        import urllib.request

        url = args.url.rstrip("/") + "/historyz"
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                payload = json.load(resp)
        except OSError as err:
            print(f"error: cannot fetch {url}: {err}", file=sys.stderr)
            return 2
    elif args.artifact:
        path = args.artifact
        if os.path.isdir(path):
            path = os.path.join(path, "history.json")
        try:
            with open(path, encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, ValueError) as err:
            print(f"error: cannot read history: {err}", file=sys.stderr)
            return 2
    else:
        from analyzer_tpu_torch.obs.history import get_history

        payload = get_history().to_json()
    series = payload.get("series", {})
    if args.series:
        series = {
            name: s for name, s in series.items()
            if any(name.startswith(p) for p in args.series)
        }
        payload = dict(payload, series=series)
    if args.json:
        json.dump(payload, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
        return 0
    from analyzer_tpu_torch.obs.history import render_history

    last_t = payload.get("last_sample_t")
    print(
        f"history: {len(series)} series, {payload.get('samples', 0)} "
        f"samples, last_t={last_t}"
    )
    sys.stdout.write(render_history(payload, tier=args.tier))
    return 0


def cmd_fleet(args) -> int:
    """Fleet observability plane (obs/federate.py): scrape N workers'
    obsd endpoints, merge their registries under the reserved ``host=``
    label, evaluate the STANDARD objectives at fleet scope with per-host
    attribution, and serve /fleetz, aggregated /metrics, a fleet /sloz
    and the fleet history rings. ``--check`` is the CI one-shot: scrape
    once, evaluate, exit 1 on any burn."""
    from analyzer_tpu_torch.obs.federate import Collector, FleetServer

    targets = list(args.targets_pos)
    if args.targets:
        targets.extend(
            t.strip() for t in args.targets.split(",") if t.strip()
        )
    if not targets:
        print(
            "error: no targets (positional host:port... or "
            "--targets host:port,...)", file=sys.stderr,
        )
        return 2
    collector = Collector(
        targets,
        flight_token=args.flight_token,
        request_flight_dumps=not args.no_flight_requests,
    )
    if args.check:
        burns = collector.check(time.monotonic())
        down = [
            t for t, row in collector.fleetz()["hosts"].items()
            if not row["up"]
        ]
        for target in down:
            print(f"DOWN: {target}")
        for burn, hosts in burns:
            where = ", ".join(hosts) if hosts else "fleet-wide"
            print(f"FLEET BURN: {burn.objective} [{where}] — {burn.detail}")
        if args.json:
            json.dump(
                collector.sloz(), sys.stdout, indent=1, sort_keys=True
            )
            sys.stdout.write("\n")
        if burns or (down and args.require_all_up):
            return 1
        up = collector.fleetz()["up"]
        print(f"fleet ok: {up}/{len(targets)} host(s) up, no burns")
        return 0
    server = FleetServer(collector, port=args.port)
    print(f"fleetd serving /fleetz /metrics /sloz /historyz at {server.url}")
    scrapes = 0
    try:
        while args.scrapes <= 0 or scrapes < args.scrapes:
            collector.scrape(time.monotonic())
            scrapes += 1
            burning = collector.burning
            if burning:
                attribution = collector.attribution()
                for name in burning:
                    hosts = attribution.get(name)
                    print(
                        f"FLEET BURNING: {name} "
                        f"[{', '.join(hosts) if hosts else 'fleet-wide'}]"
                    )
            if args.scrapes > 0 and scrapes >= args.scrapes:
                break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 1 if collector.burning else 0


def _migrate_quality(data: bytes, report, pre_live_view, cfg):
    """The staging-vs-live replay judge (``obs.quality.score_table``):
    scores the migrated table AND the pre-migration live table over the
    SAME replay window with the serve plane's Phi link. Advisory: the
    migrated table saw these matches and the live one may not have, so a
    fit gap is expected; the alarm is a migrated table that fits worse."""
    import io as _io

    from analyzer_tpu_torch.io.csv_codec import load_stream_csv
    from analyzer_tpu_torch.obs.quality import score_table

    stream = load_stream_csv(_io.StringIO(data.decode("utf-8")))
    keys = ("matches_scored", "brier", "logloss", "ece")
    migrated = score_table(report.state.table.cpu().numpy(), stream, cfg)
    out = {"migrated": {k: migrated[k] for k in keys}}
    if pre_live_view is not None:
        live_q = score_table(pre_live_view.host_table(), stream, cfg)
        out["live_pre_cutover"] = {k: live_q[k] for k in keys}
    return out


def cmd_migrate(args) -> int:
    """Zero-downtime global re-rate: the streamed decode -> assign ->
    dispatch backfill engine rates a CSV history while a live lineage keeps
    serving, publishes into a staging view lineage, and cuts traffic over
    atomically at the end. Checkpointed and resumable: a killed backfill
    restarts from its last window-boundary watermark and gives a
    bit-identical final table."""
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.migrate import LineageManager, run_migration
    from analyzer_tpu_torch.serve import ViewPublisher

    if args.resume and not args.checkpoint:
        print("error: --resume requires --checkpoint", file=sys.stderr)
        return 2
    if args.checkpoint_every and not args.checkpoint:
        print("error: --checkpoint-every requires --checkpoint",
              file=sys.stderr)
        return 2
    for flag in ("checkpoint_every", "stop_after_steps", "prefetch_depth",
                 "window_rows", "batch_size", "plan_windows"):
        val = getattr(args, flag)
        if val is not None and val <= 0:
            print(f"error: --{flag.replace('_', '-')} must be positive",
                  file=sys.stderr)
            return 2
    if args.hot_rows < 0:
        print("error: --hot-rows must be >= 0 (0 = untiered)", file=sys.stderr)
        return 2
    device = _resolve_device(args, "migrate")
    if device is None:
        return 2
    server = _obs_serve(args)
    timer = PhaseTimer()
    try:
        cfg = RatingConfig.from_env()
        with timer.phase("load"):
            with open(args.csv, "rb") as f:
                data = f.read()
        state = None
        if not args.resume:
            n_players = args.players
            if n_players is None:
                # No --players: probe the stream for its row ceiling (one
                # decode pass — pass --players to skip it).
                from analyzer_tpu_torch.io.ingest import decode_stream_csv

                with timer.phase("probe"):
                    probe = decode_stream_csv(data)
                    if probe is None:
                        import io as _io

                        from analyzer_tpu_torch.io.csv_codec import load_stream_csv

                        probe = load_stream_csv(_io.StringIO(data.decode("utf-8")))
                    n_players = (
                        int(probe.player_idx.max()) + 1 if probe.n_matches else 0
                    )
                    del probe
                print(
                    f"probed {n_players} players (pass --players to skip "
                    "the probe)", file=sys.stderr,
                )
            state = PlayerState.create(n_players, cfg=cfg, device=device)
        # The in-process live lineage: primed from --from-checkpoint when
        # serving continuity from an existing table matters, else empty
        # (the cutover publishes version 1).
        live = ViewPublisher(device=device)
        if args.from_checkpoint:
            from analyzer_tpu_torch.io.checkpoint import load_checkpoint

            live.publish_state(
                load_checkpoint(args.from_checkpoint, device=device).state
            )
        lineage = LineageManager(live)
        engine_kw = {}
        if args.window_rows:
            engine_kw["window_rows"] = args.window_rows
        if args.plan_windows:
            engine_kw["plan_windows"] = args.plan_windows
        # The pre-migration live view, taken NOW: the cutover repoints
        # `live` at the migrated table, and the judge needs the one replaced.
        pre_live_view = live.current()
        with timer.phase("migrate"):
            report = run_migration(
                state, data, cfg,
                lineage=lineage,
                checkpoint=args.checkpoint,
                resume=args.resume,
                checkpoint_every=args.checkpoint_every,
                stop_after=args.stop_after_steps,
                do_cutover=not args.no_cutover,
                device=device,
                batch_size=args.batch_size,
                prefetch_depth=args.prefetch_depth,
                kernel=args.kernel,
                fuse_window=args.fuse_window,
                hot_rows=args.hot_rows,
                **engine_kw,
            )
            _sync(report.state)
        if report.finished:
            _obs_write(args)
        quality = None
        if report.finished and not args.no_quality:
            with timer.phase("quality"):
                try:
                    quality = _migrate_quality(data, report, pre_live_view, cfg)
                except Exception as e:  # noqa: BLE001 — advisory evidence
                    quality = {"error": repr(e)}
        stats = report.stats
        print(json.dumps({
            "matches": stats.get("matches"),
            "supersteps": stats.get("n_steps"),
            "batch_size": stats.get("batch_size"),
            "occupancy": round(stats.get("occupancy", 0.0), 3),
            "streamed": stats.get("streamed"),
            "assign_native": stats.get("assign_native"),
            "plan_windows": stats.get("plan_windows"),
            "stopped": stats.get("stopped", False),
            "ttfd_s": (
                round(stats["ttfd_s"], 4)
                if stats.get("ttfd_s") is not None else None
            ),
            "cutover_pause_ms": report.cutover_pause_ms,
            "lineage_live_version": live.version,
            "quality": quality,
            "phases": {k: round(v, 3) for k, v in timer.report().items()},
        }))
        return 0
    finally:
        if server is not None:
            server.close()


def cmd_soak(args) -> int:
    """The closed-loop matchmaking soak (:mod:`analyzer_tpu_torch.loadgen`):
    matchmaker -> broker -> worker -> commit -> view publish, with /v1/*
    query traffic, SLO samples per virtual tick, and a SOAK_*.json artifact
    (``--out``). Deterministic per (seed, config); exit 1 when an SLO is
    violated."""
    from analyzer_tpu_torch.loadgen import SoakConfig, SoakDriver
    from analyzer_tpu_torch.loadgen.driver import write_artifact

    if args.hosts is not None:
        return _cmd_soak_fabric(args)
    for flag in ("duration", "qps", "tick", "players", "batch_size",
                 "polls_per_tick", "serve_shards", "broker_partitions",
                 "audit_sample_denom", "migrate_matches"):
        if getattr(args, flag) <= 0:
            print(f"error: --{flag.replace('_', '-')} must be positive",
                  file=sys.stderr)
            return 2
    if args.query_qps < 0:
        print("error: --query-qps must be >= 0 (0 = no read traffic)",
              file=sys.stderr)
        return 2
    if args.backfill_qps < 0:
        print("error: --backfill-qps must be >= 0", file=sys.stderr)
        return 2
    if args.serve_http and args.in_process:
        print("error: --serve-http drives the HTTP socket path; it cannot "
              "combine with --in-process", file=sys.stderr)
        return 2
    if args.backfill_qps > 0 and not args.priority_lanes:
        print("error: --backfill-qps needs --priority-lanes (backfill "
              "traffic rides the backfill lane)", file=sys.stderr)
        return 2
    if args.forbid_dominant_stages and not (args.trace or args.trace_events):
        print("error: --forbid-dominant-stage needs --trace (the check "
              "reads the trace block's critical path)", file=sys.stderr)
        return 2
    device = _resolve_device(args, "soak")
    if device is None:
        return 2
    # The soak's obsd rides the WORKER (SoakConfig.obs_port), so its
    # endpoints carry the worker's stats and readiness.
    cfg = SoakConfig(
        seed=args.seed,
        obs_port=args.obs_port,
        trace=bool(args.trace or args.trace_events),
        duration_s=args.duration,
        tick_s=args.tick,
        qps=args.qps,
        query_qps=args.query_qps,
        n_players=args.players,
        batch_size=args.batch_size,
        polls_per_tick=args.polls_per_tick,
        team5_frac=args.team5_frac,
        afk_rate=args.afk_rate,
        warmup=not args.no_warmup,
        use_http=not args.in_process,
        serve_http=args.serve_http,
        serve_shards=args.serve_shards,
        broker_partitions=args.broker_partitions,
        priority_lanes=args.priority_lanes,
        backfill_qps=args.backfill_qps,
        realtime=args.realtime,
        max_view_lag_ticks=args.max_view_lag_ticks,
        min_matches_per_sec=args.min_matches_per_sec,
        max_p99_ms=args.max_p99_ms,
        forbid_dominant_stages=tuple(args.forbid_dominant_stages),
        slo_plane=not args.no_slo_plane,
        audit=args.audit,
        audit_sample_denom=args.audit_sample_denom,
        migrate=args.migrate,
        migrate_matches=args.migrate_matches,
        quality=not args.no_quality,
    )
    driver = SoakDriver(cfg, device=device)
    try:
        artifact = driver.run()
    finally:
        driver.close()
    _obs_write(args)
    # One JSON line on stdout (the headline); the full artifact goes to
    # --out.
    line = {
        k: artifact[k]
        for k in ("metric", "value", "latency_ms", "measured", "slo")
    }
    line["deterministic"] = {
        k: v for k, v in artifact["deterministic"].items()
        if k != "trajectory"
    }
    print(json.dumps(line))
    if args.out:
        write_artifact(artifact, args.out)
        print(f"wrote soak artifact to {args.out}", file=sys.stderr)
    if not artifact["slo"]["pass"]:
        for v in artifact["slo"]["violations"]:
            print(f"SLO VIOLATION: {v}", file=sys.stderr)
        return 1
    return 0



def _cmd_soak_fabric(args) -> int:
    """``cli soak --hosts N``: the closed-loop soak over a REAL
    multi-process fabric (:mod:`analyzer_tpu_torch.fabric`) — N
    shard-owning host subprocesses on ``--device``, broker-partitioned
    ingest, routed /v1/* queries, and a fleet Collector judging the
    standard objectives across the hosts' obsd planes. The artifact's
    deterministic block is bit-identical per (seed, config) at any
    --hosts count (the FABRIC_BENCH shape)."""
    from analyzer_tpu_torch.fabric.driver import (
        FabricSoakConfig,
        FabricSoakDriver,
    )
    from analyzer_tpu_torch.loadgen.driver import write_artifact

    for flag in ("hosts", "duration", "qps", "tick", "players",
                 "batch_size", "fabric_shards"):
        if getattr(args, flag) <= 0:
            print(f"error: --{flag.replace('_', '-')} must be positive",
                  file=sys.stderr)
            return 2
    if args.query_qps < 0:
        print("error: --query-qps must be >= 0 (0 = no read traffic)",
              file=sys.stderr)
        return 2
    if args.fabric_shards < args.hosts:
        print(
            "error: --fabric-shards must be >= --hosts (every host "
            "must own at least one shard)", file=sys.stderr,
        )
        return 2
    device = _resolve_device(args, "soak")
    if device is None:
        return 2
    cfg = FabricSoakConfig(
        seed=args.seed,
        duration_s=args.duration,
        tick_s=args.tick,
        qps=args.qps,
        query_qps=args.query_qps,
        n_players=args.players,
        batch_size=args.batch_size,
        n_shards=args.fabric_shards,
        n_hosts=args.hosts,
        team5_frac=args.team5_frac,
        afk_rate=args.afk_rate,
        warmup=not args.no_warmup,
        trace=bool(args.trace or args.trace_events),
        quality=not args.no_quality,
        slo_plane=not args.no_slo_plane,
        max_view_lag_ticks=args.max_view_lag_ticks,
    )
    driver = FabricSoakDriver(cfg, device=device)
    try:
        artifact = driver.run()
    finally:
        driver.close()
    line = {
        k: artifact[k]
        for k in ("metric", "value", "latency_ms", "measured", "slo")
    }
    line["deterministic"] = artifact["deterministic"]
    print(json.dumps(line))
    if args.out:
        write_artifact(artifact, args.out)
        print(f"wrote fabric artifact to {args.out}", file=sys.stderr)
    if not artifact["slo"]["pass"]:
        for v in artifact["slo"]["violations"]:
            print(f"SLO VIOLATION: {v}", file=sys.stderr)
        return 1
    return 0


def cmd_fabric(args) -> int:
    """Brings up a standing fabric: N shard-owning host processes
    (:mod:`analyzer_tpu_torch.fabric.process`, on ``--device``), each with
    its own partitioned ingest, serve plane, obsd and ``/fabric/*``
    control surface. Prints one JSON line per host once its listeners are
    bound (the serve_url/control_url/obs_port a router or fleet Collector
    needs), then runs until --duration wall seconds elapse or Ctrl-C, and
    signals every host down on the way out."""
    import tempfile

    if args.hosts <= 0 or args.shards <= 0:
        print("error: --hosts and --shards must be positive",
              file=sys.stderr)
        return 2
    if args.shards < args.hosts:
        print(
            "error: --shards must be >= --hosts (every host must own "
            "at least one shard)", file=sys.stderr,
        )
        return 2
    device = _resolve_device(args, "fabric")
    if device is None:
        return 2
    from analyzer_tpu_torch.fabric.driver import (
        reap_fabric_hosts,
        spawn_fabric_hosts,
    )

    rc = 0
    with tempfile.TemporaryDirectory(prefix="fabric-cli-") as tmp:
        exit_file = os.path.join(tmp, "exit")
        base_spec = {
            "n_shards": args.shards,
            "n_hosts": args.hosts,
            "seed": args.seed,
            "n_players": args.players,
            "batch_size": args.batch_size,
            "max_wall_s": args.duration + 60.0,
            "device": str(device),
        }
        hosts: list = []
        try:
            hosts = spawn_fabric_hosts(base_spec, tmp, exit_file)
            for h in hosts:
                print(json.dumps({
                    "host": h["host"],
                    "shards": list(range(h["host"], args.shards,
                                         args.hosts)),
                    "serve_url": h["serve_url"],
                    "control_url": h["control_url"],
                    "obs_port": h["obs_port"],
                    "pid": h["pid"],
                }))
            sys.stdout.flush()
            deadline = time.monotonic() + args.duration
            try:
                while time.monotonic() < deadline:
                    for h in hosts:
                        if h["proc"].poll() is not None:
                            print(
                                f"error: fabric host {h['host']} exited "
                                f"rc={h['proc'].returncode}; see "
                                f"{h['log_path']}", file=sys.stderr,
                            )
                            rc = 1
                    if rc:
                        break
                    time.sleep(0.2)
            except KeyboardInterrupt:
                print("interrupt: signalling fabric down", file=sys.stderr)
        except RuntimeError as err:
            print(f"error: {err}", file=sys.stderr)
            rc = 1
        finally:
            reap_fabric_hosts(hosts, exit_file)
    return rc

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
        help="also generate post-game telemetry (K/D/A, gold, cs) for the "
        "config-4 analysis head (.npz only)",
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
        "--trace", metavar="DIR",
        help="torch.profiler trace of the rating phase (CPU + CUDA "
        "activities) into DIR, in the layout `cli profile DIR` reads",
    )
    s.add_argument(
        "--metrics-out", metavar="PATH",
        help="write the runtime telemetry snapshot (counters/gauges/"
        "histograms, batch and feed spans) as JSON after a successful run",
    )
    s.add_argument(
        "--trace-events", metavar="PATH",
        help="write the span ring as Chrome trace-event JSONL "
        "(Perfetto-loadable, alongside --trace's capture)",
    )
    s.add_argument(
        "--mesh", type=int, metavar="N",
        help="data-parallel re-rate over an N-shard mesh, or 0 for one "
        "shard per process (under torch.distributed — set "
        "COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID and run in every "
        "process)",
    )
    s.add_argument(
        "--obs-port", type=int, metavar="PORT",
        help="serve live introspection endpoints (/metrics /healthz "
        "/readyz /statusz /debug/snapshot) on localhost:PORT for the "
        "duration of the run (0 = ephemeral)",
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
        help="serve through the sharded plane: the table splits into S "
        "per-shard views (interleaved by row), lookups route by "
        "player-id shard, leaderboards merge per-shard top-k — "
        "bit-identical to --shards 1",
    )
    s.add_argument(
        "--all-gather-topk", action="store_true",
        help="with --shards > 1: one sort over the stacked per-shard "
        "score columns per device instead of S per-shard sorts",
    )
    s.add_argument(
        "--obs-port", type=int, metavar="PORT",
        help="also serve the obsd introspection endpoints (serve.* "
        "metrics land in /metrics)",
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
        help="obsd: /metrics /healthz /readyz /statusz /debug/snapshot on "
        "localhost:PORT (also ANALYZER_TPU_OBS_PORT); /readyz 503s while "
        "the pipelined lane is degraded",
    )
    s.add_argument(
        "--obs-host", metavar="HOST",
        help="bind obsd on HOST instead of localhost (widening the bind "
        "is an explicit operator decision)",
    )
    s.add_argument(
        "--flight-dir", metavar="DIR",
        help="arm flight-recorder dumps into DIR (also "
        "ANALYZER_TPU_FLIGHT_DIR): dead-letters, pipeline degradation "
        "and SIGUSR1 leave a timestamped artifact directory",
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
        help="serve through the sharded plane: S per-shard views + "
        "routed lookups + distributed top-k (also "
        "ANALYZER_TPU_SERVE_SHARDS; bit-identical results)",
    )
    s.add_argument(
        "--profile-dir", metavar="DIR",
        help="arm on-demand torch.profiler capture windows into DIR (also "
        "ANALYZER_TPU_PROFILE_DIR): SIGUSR2 captures the next batch's "
        "dispatch; dead-letters and pipeline degradation capture "
        "automatically (throttled); `cli profile` attributes a capture",
    )
    s.add_argument(
        "--audit", action="store_true",
        help="continuous shadow audit of served queries against the "
        "bit-exact oracle (needs --serve-port; also ANALYZER_TPU_AUDIT; "
        "audit.mismatches_total is a zero-tolerance SLO)",
    )
    s.add_argument(
        "--audit-sample-denom", type=int, metavar="N",
        help="audit 1-in-N served queries (default: 8; 1 = every query)",
    )
    s.add_argument(
        "--no-slo-plane", action="store_true",
        help="disable the live SLO plane (history rings + burn-rate "
        "watchdog + audit) — on by default; /historyz and /sloz then "
        "serve empty",
    )
    s.add_argument(
        "--device", default="cuda",
        help="where batches are rated: cuda (default; refuses to start "
        "without a card) or cpu",
    )
    s.set_defaults(fn=cmd_worker)

    s = sub.add_parser(
        "soak",
        help="closed-loop matchmaking soak with SLO gates "
        "(analyzer_tpu_torch/loadgen; --out writes the SOAK_*.json artifact)",
    )
    s.add_argument("--seed", type=int, default=0)
    s.add_argument(
        "--duration", type=float, default=8.0, metavar="S",
        help="VIRTUAL seconds to soak (ticks = duration/tick; wall time "
        "only matters with --realtime). Default: 8",
    )
    s.add_argument(
        "--qps", type=float, default=24.0,
        help="matches formed per virtual second (default: 24)",
    )
    s.add_argument(
        "--query-qps", type=float, default=10.0, metavar="QPS",
        help="serve queries per virtual second against /v1/* "
        "(default: 10; mix: ratings/winprob/leaderboard/tiers)",
    )
    s.add_argument(
        "--tick", type=float, default=1.0, metavar="S",
        help="virtual tick length (default: 1.0)",
    )
    s.add_argument("--players", type=int, default=400)
    s.add_argument(
        "--batch-size", type=int, default=64,
        help="worker micro-batch size (default: 64)",
    )
    s.add_argument(
        "--polls-per-tick", type=int, default=4,
        help="worker poll budget per tick — overload shows up as queue "
        "depth instead of stretching the tick (default: 4)",
    )
    s.add_argument("--team5-frac", type=float, default=0.3,
                   help="fraction of 5v5 matches (default: 0.3)")
    s.add_argument("--afk-rate", type=float, default=0.0,
                   help="fraction of matches with an AFK participant")
    s.add_argument(
        "--max-view-lag-ticks", type=int, default=2, metavar="N",
        help="SLO: ticks the served view may stay stale while commits "
        "are pending (default: 2)",
    )
    s.add_argument(
        "--min-matches-per-sec", type=float, metavar="N",
        help="SLO: absolute wall-throughput floor (default: ungated)",
    )
    s.add_argument(
        "--max-p99-ms", type=float, metavar="MS",
        help="SLO: absolute serve-query p99 cap (default: ungated)",
    )
    s.add_argument(
        "--no-warmup", action="store_true",
        help="skip the worker/serve/publish warmup (the first touches of "
        "the device then land in the measured window)",
    )
    s.add_argument(
        "--in-process", action="store_true",
        help="query the engine in-process instead of over HTTP /v1/*",
    )
    s.add_argument(
        "--serve-http", action="store_true",
        help="route the query workload through the serve front door "
        "(serve/frontdoor.py: keep-alive pipelined sockets + the native "
        "response codec) instead of the worker's stdlib plane; the "
        "deterministic block is bit-identical either way and the "
        "artifact gains a `frontdoor` codec block",
    )
    s.add_argument(
        "--serve-shards", type=int, default=1, metavar="S",
        help="serve the soak's read plane through S shards "
        "(ShardedViewPublisher + ShardedQueryEngine); the deterministic "
        "block is bit-identical to --serve-shards 1 for the same seed "
        "(docs/serving.md \"Sharded plane\")",
    )
    s.add_argument(
        "--broker-partitions", type=int, default=1, metavar="S",
        help="partition the analyze queue by player-shard (row %% S, the "
        "serve plane's mesh layout invariant): per-partition depth/"
        "dead-letter accounting, global delivery order preserved — the "
        "deterministic block is bit-identical to the single-queue run "
        "(docs/ingest.md \"Partition math\")",
    )
    s.add_argument(
        "--priority-lanes", action="store_true",
        help="live-vs-backfill priority lanes on the broker, with the "
        "admission controller arbitrating backfill behind live traffic "
        "on feed-starvation + tier-promotion telemetry "
        "(docs/ingest.md \"Lane arbitration\")",
    )
    s.add_argument(
        "--backfill-qps", type=float, default=0.0, metavar="QPS",
        help="re-publish already-rated matches on the backfill lane at "
        "this rate (requires --priority-lanes) — the re-rate/replay "
        "ingest shape",
    )
    s.add_argument(
        "--forbid-dominant-stage", action="append", default=[],
        metavar="STAGE", dest="forbid_dominant_stages",
        help="SLO: fail when the trace block's critical-path dominant "
        "stage is STAGE (repeatable; e.g. queue_wait encode — the "
        "ingest-edge gate; needs --trace)",
    )
    s.add_argument(
        "--realtime", action="store_true",
        help="pace ticks against the wall clock (rig soaks); decisions "
        "still run on the virtual clock, so results stay deterministic",
    )
    s.add_argument(
        "--out", metavar="PATH",
        help="write the SOAK_*.json artifact (the JAX package's shape; "
        "stdout always carries the one-line summary)",
    )
    s.add_argument(
        "--metrics-out", metavar="PATH",
        help="also write the full telemetry snapshot as JSON",
    )
    s.add_argument(
        "--obs-port", type=int, metavar="PORT",
        help="serve the soak worker's obsd introspection endpoints "
        "(watch soak.* and broker.queue_depth live, or point a "
        "`cli fleet` Collector at it; 0 = ephemeral)",
    )
    s.add_argument(
        "--trace", action="store_true",
        help="causal tracing: every match carries a TraceContext from "
        "broker enqueue to view publish, and the artifact gains a "
        "`trace` block (stage decomposition + dominant stage); the "
        "deterministic block stays bit-identical "
        "(docs/observability.md \"Causal tracing\")",
    )
    s.add_argument(
        "--trace-events", metavar="PATH",
        help="write the span ring as Chrome trace-event JSONL after the "
        "soak (implies --trace; the `cli trace` input)",
    )
    s.add_argument(
        "--audit", action="store_true",
        help="continuous shadow audit: a seeded-hash sample of the "
        "soak's served queries replays through the bit-exact oracle off "
        "the hot path; one mismatch fails the soak's SLO gate "
        "(docs/observability.md \"Shadow audit\")",
    )
    s.add_argument(
        "--audit-sample-denom", type=int, default=4, metavar="N",
        help="audit 1-in-N served queries (default: 4; 1 = every query)",
    )
    s.add_argument(
        "--no-slo-plane", action="store_true",
        help="disable the history sampler + SLO watchdog (the "
        "bit-identity AB knob; the deterministic block is identical "
        "either way)",
    )
    s.add_argument(
        "--no-quality", action="store_true",
        help="disable the calibration ledger (the rating-quality "
        "bit-identity AB knob; the artifact loses its `quality` block "
        "and the deterministic block is identical either way)",
    )
    s.add_argument(
        "--migrate", action="store_true",
        help="run a full zero-downtime re-rate UNDER the live soak "
        "load: the streamed backfill engine rates a seeded synthetic "
        "history into a staging lineage (admission-arbitrated against "
        "live traffic) while the soak serves, then cuts over "
        "atomically after the measured window; the artifact gains a "
        "`migration` block and the deterministic block is unchanged "
        "per (seed, config)",
    )
    s.add_argument(
        "--migrate-matches", type=int, default=400, metavar="N",
        help="matches in the migrated synthetic history (default: 400)",
    )
    s.add_argument(
        "--hosts", type=int, metavar="N",
        help="run the soak over a REAL multi-process fabric of N "
        "shard-owning host subprocesses (analyzer_tpu_torch/fabric): "
        "broker-partitioned ingest, routed /v1/* queries, fleet-scope "
        "SLOs; the deterministic block is bit-identical per (seed, "
        "config) at any N, and the artifact is FABRIC_BENCH-shaped. "
        "Flags that configure the single-process pipeline shape "
        "(--serve-shards, --broker-partitions, --migrate, --audit, ...) "
        "do not apply",
    )
    s.add_argument(
        "--fabric-shards", type=int, default=4, metavar="S",
        help="fabric shard count for --hosts (ownership: shard s -> "
        "host s %% N; must be >= --hosts; default: 4)",
    )
    s.add_argument(
        "--device", default="cuda",
        help="where the soak's worker rates and serves: cuda (default; "
        "refuses to start without a card) or cpu",
    )
    s.set_defaults(fn=cmd_soak)

    s = sub.add_parser(
        "fabric",
        help="launch a standing multi-host rate fabric: N shard-owning "
        "host processes with partitioned ingest, per-host serve "
        "planes, and /fabric/* control surfaces",
    )
    s.add_argument(
        "--hosts", type=int, default=2, metavar="N",
        help="host process count (default: 2)",
    )
    s.add_argument(
        "--shards", type=int, default=4, metavar="S",
        help="shard count; ownership is shard s -> host s %% N, so S "
        "must be >= --hosts (default: 4)",
    )
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--players", type=int, default=400)
    s.add_argument(
        "--batch-size", type=int, default=64,
        help="per-host worker micro-batch size (default: 64)",
    )
    s.add_argument(
        "--duration", type=float, default=600.0, metavar="S",
        help="wall seconds to keep the fabric up (default: 600; ^C "
        "exits early and signals the hosts down)",
    )
    s.add_argument(
        "--device", default="cuda",
        help="where every host rates and serves: cuda (default; refuses "
        "to start without a card) or cpu",
    )
    s.set_defaults(fn=cmd_fabric)

    s = sub.add_parser(
        "migrate",
        help="zero-downtime streamed re-rate: decode->assign->dispatch "
        "overlapped, dual-lineage serve cutover, checkpoint/resume "
        "(docs/migration.md)",
    )
    s.add_argument("--csv", required=True, help="match history CSV")
    s.add_argument(
        "--players", type=int, metavar="N",
        help="player-table rows (default: probed from the stream with "
        "one extra decode pass)",
    )
    s.add_argument(
        "--checkpoint", metavar="PATH",
        help="migration snapshot path (.npz; written at window "
        "boundaries with the schedule fingerprint)",
    )
    s.add_argument(
        "--resume", action="store_true",
        help="resume from --checkpoint's watermark (the front half "
        "re-derives the identical schedule from the bytes and skips "
        "device work below it; final table bit-identical)",
    )
    s.add_argument(
        "--checkpoint-every", type=int, metavar="STEPS",
        help="snapshot every N supersteps mid-backfill",
    )
    s.add_argument(
        "--stop-after-steps", type=int, metavar="STEPS",
        help="stop at the window boundary at/after this superstep "
        "(bounded runs; a snapshot is written there when --checkpoint "
        "is set; no cutover happens)",
    )
    s.add_argument(
        "--from-checkpoint", metavar="PATH",
        help="prime the live lineage from this snapshot (serving "
        "continuity while the backfill runs); default: empty live "
        "lineage",
    )
    s.add_argument(
        "--no-cutover", action="store_true",
        help="skip the final atomic cutover (inspect the staging "
        "lineage only)",
    )
    s.add_argument("--batch-size", type=int, metavar="B")
    s.add_argument(
        "--window-rows", type=int, metavar="N",
        help="decode window rows (default 4096; io/ingest.py)",
    )
    s.add_argument(
        "--plan-windows", type=int, metavar="K",
        help="decode windows in the batch-size planning prefix (default "
        "4; deterministic — the policy folds into the resume "
        "fingerprint, so resume with the value the run was started with)",
    )
    s.add_argument("--prefetch-depth", type=int, metavar="N")
    s.add_argument(
        "--kernel", choices=("reference", "fused"),
        default=os.environ.get("BENCH_KERNEL", "reference"),
    )
    s.add_argument("--fuse-window", type=int, metavar="K",
                   default=int(os.environ.get("BENCH_FUSE_WINDOW", 0)) or None)
    s.add_argument("--hot-rows", type=int, metavar="N",
                   default=int(os.environ.get("BENCH_HOT_ROWS", 0)))
    s.add_argument("--obs-port", type=int, metavar="PORT")
    s.add_argument("--metrics-out", metavar="PATH")
    s.add_argument("--trace-events", metavar="PATH")
    s.add_argument(
        "--no-quality", action="store_true",
        help="skip the staging-vs-live calibration replay judge "
        "(obs/quality.py score_table; it re-reads the stream once per "
        "lineage, so very large histories may want this)",
    )
    s.add_argument(
        "--device", default="cuda",
        help="where to rate: cuda (default; refuses to start without a "
        "card) or cpu",
    )
    s.set_defaults(fn=cmd_migrate)

    s = sub.add_parser("bench", help="headline throughput benchmark")
    s.add_argument(
        "--metrics-out", metavar="PATH",
        help="also write the full telemetry snapshot as JSON (the BENCH "
        "line embeds the phase breakdown either way)",
    )
    s.add_argument(
        "--obs-port", type=int, metavar="PORT",
        help="serve the live introspection endpoints while the benchmark "
        "runs (watch /metrics mid-capture; 0 = ephemeral)",
    )
    s.add_argument(
        "--kernel", choices=("reference", "fused"),
        help="headline kernel (default: BENCH_KERNEL env, else fused). "
        "'fused' times BOTH kernels and embeds a `fused` block with "
        "min_over_reference in the BENCH line",
    )
    s.add_argument(
        "--fuse-window", type=int, metavar="K",
        help="fused window size (default: BENCH_FUSE_WINDOW env, else 16)",
    )
    s.add_argument(
        "--hot-rows", type=int, metavar="N",
        help="also capture the tiered-table line with an N-row hot set "
        "(BENCH_HOT_ROWS env): the BENCH line gains a `tiered` block — "
        "hit rate, promotion bytes, min_over_resident",
    )
    s.add_argument(
        "--ingest", action="store_true",
        help="capture the wire-speed ingest line instead (BENCH_INGEST "
        "env): columnar windowed decode into the staging arena's slabs + "
        "per-window H2D through the prefetch ring (bytes/s, "
        "queue-to-H2D p99, arena hit rate)",
    )
    s.add_argument(
        "--migrate", action="store_true",
        help="capture the zero-downtime migration line instead "
        "(BENCH_MIGRATE env): the streamed backfill engine re-rates a CSV "
        "history into a staging lineage while the live plane answers "
        "queries, then cuts over (backfill matches/s, live p99 during the "
        "migration, cutover pause, the assign front half's rates)",
    )
    s.add_argument(
        "--profile", action="store_true",
        help="capture one device-only run of the headline kernel under "
        "torch.profiler (BENCH_PROFILE env): the `roofline` block then "
        "divides by MEASURED device-busy time and gains device_idle_frac, "
        "and the line gains a `profile` block",
    )
    s.add_argument(
        "--profile-dir", metavar="DIR",
        help="where --profile writes its capture dirs "
        "(BENCH_PROFILE_DIR env; default: a temp directory)",
    )
    s.add_argument(
        "--device", default="cuda",
        help="torch device to bench on (default cuda: the card; exits 2 "
        "where none is visible)",
    )
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser(
        "benchdiff",
        help="diff two BENCH_*.json artifacts; non-zero exit on a "
        "throughput regression past --regress-pct",
    )
    s.add_argument(
        "artifacts", nargs="*",
        help="baseline and candidate artifacts (raw bench lines or the "
        "{parsed: ...} capture wrappers); with --against-latest, at most "
        "the candidate",
    )
    s.add_argument(
        "--against-latest", action="store_true",
        help="compare the candidate (or the newest artifact) against the "
        "latest other BENCH_*.json under --dir",
    )
    s.add_argument(
        "--dir", default=".",
        help="directory scanned for BENCH_*.json (default: .)",
    )
    s.add_argument(
        "--regress-pct", type=float, default=5.0, metavar="PCT",
        help="fail (exit 1) when a non-degraded config is worse by more "
        "than PCT percent (default: 5)",
    )
    s.add_argument(
        "--family",
        choices=(
            "bench", "serve", "tiered", "soak", "ingest", "migrate",
            "fabric",
        ),
        default="bench",
        help="artifact family for --against-latest scans: bench "
        "(BENCH_*.json, the write path), serve (SERVE_BENCH_*.json — "
        "queries/sec + p99 latency, experiments/serve_bench.py), "
        "tiered (the same BENCH_*.json artifacts, gating only the "
        "tiered-table configs — min_over_resident + hit rate; a "
        "candidate that silently dropped its tiered block fails), or "
        "soak (SOAK_*.json from `cli soak` — throughput/p99 regression "
        "PLUS the absolute SLOs: zero dead-letters, flat steady-state "
        "retraces, bounded view staleness, drained backlog), or ingest "
        "(INGEST_BENCH_*.json from `cli bench --ingest` — decoded "
        "bytes/s, queue-to-H2D p99, arena hit rate; a candidate whose "
        "decode silently fell back to the python codec fails), or "
        "migrate (MIGRATE_BENCH_*.json from `cli bench --migrate` — "
        "backfill matches/s, live serve p99 under concurrent migration, "
        "cutover pause ms; a candidate whose backfill silently fell "
        "back to the offline re-rate fails), or fabric "
        "(FABRIC_BENCH_*.json from `cli soak --hosts N` — per-host "
        "ingest matches/s, routed-query p99, worst per-host view "
        "staleness, plus the fleet-scope absolute SLOs; a candidate "
        "that silently fell back to a single-process topology fails); "
        "explicit two-path diffs auto-detect from the metric name",
    )
    s.set_defaults(fn=cmd_benchdiff)

    s = sub.add_parser(
        "tune",
        help="telemetry-driven tuning advisor: name the bottleneck and "
        "the knob from bench/soak/migrate artifacts, history rings and "
        "profile captures (deterministic)",
    )
    s.add_argument(
        "artifacts", nargs="*",
        help="artifact paths (BENCH/SOAK/INGEST/MIGRATE_BENCH JSON, a "
        "history.json or flight-dump dir); none = scan --dir",
    )
    s.add_argument(
        "--dir", default=".",
        help="directory scanned for artifacts when none are named "
        "(default: .)",
    )
    s.add_argument(
        "--profile", metavar="DIR",
        help="also attribute a device-profiler capture dir and feed its "
        "busy/idle split to the rules",
    )
    s.add_argument("--json", action="store_true", help="JSON output")
    s.set_defaults(fn=cmd_tune)

    s = sub.add_parser(
        "metrics",
        help="render a runtime telemetry snapshot",
    )
    s.add_argument(
        "snapshot", nargs="?",
        help="a --metrics-out JSON artifact; omitted = this process's "
        "live registry (the declared metric catalog)",
    )
    s.add_argument(
        "--format", choices=("json", "prom", "summary"), default="json",
        help="json (default), prom (Prometheus text exposition), or "
        "summary (human digest)",
    )
    s.set_defaults(fn=cmd_metrics)

    s = sub.add_parser(
        "history",
        help="render telemetry history rings (live /historyz, a saved "
        "history.json / flight dump, or this process)",
    )
    s.add_argument(
        "artifact", nargs="?",
        help="a history.json file or a flight-dump directory "
        "(default: this process's sampler)",
    )
    s.add_argument(
        "--url", metavar="URL",
        help="fetch from a live worker's obsd endpoint "
        "(e.g. http://127.0.0.1:9100 — /historyz is appended)",
    )
    s.add_argument(
        "--series", action="append", default=[], metavar="PREFIX",
        help="only series whose name starts with PREFIX (repeatable)",
    )
    s.add_argument(
        "--tier", choices=["raw", "10s", "1m"], default="raw",
        help="downsampling tier to render (default: raw)",
    )
    s.add_argument(
        "--json", action="store_true",
        help="dump the (filtered) payload as JSON instead of trends",
    )
    s.set_defaults(fn=cmd_history)

    s = sub.add_parser(
        "trace",
        help="reconstruct per-match/per-batch causal timelines from a "
        "trace-events JSONL or a flight-recorder dump",
    )
    s.add_argument(
        "artifact", nargs="+",
        help="a --trace-events JSONL export, or a flight-recorder dump "
        "directory (its trace.jsonl is used); several stitch into one "
        "cross-process trace forest",
    )
    s.add_argument(
        "--match", metavar="ID",
        help="one match's journey: queue wait + its batch's stage "
        "decomposition + the view version that served it",
    )
    s.add_argument(
        "--batch", metavar="ID",
        help="one batch's stage decomposition (ids look like b17; "
        "`--match` prints the owning batch id)",
    )
    s.add_argument(
        "--window", type=int, default=0, metavar="N",
        help="restrict the critical-path report to the last N batches "
        "(default: all)",
    )
    s.add_argument(
        "--profile", metavar="DIR",
        help="a device-profiler capture dir: joins its attribution against "
        "this host trace and decomposes the `dispatch` stage into "
        "device-execute / device-idle / host-overhead",
    )
    s.add_argument("--json", action="store_true", help="JSON output")
    s.set_defaults(fn=cmd_trace)

    s = sub.add_parser(
        "profile",
        help="attribute a device-profiler capture dir: per-kernel device "
        "time, busy/idle and compile/execute splits",
    )
    s.add_argument(
        "capture_dir",
        help="a capture directory (`rate --trace DIR`, or a "
        "profile-<ts>-<reason>-<pid>/ window of `worker --profile-dir`)",
    )
    s.add_argument(
        "--trace-events", nargs="+", metavar="ARTIFACT", default=[],
        help="host-side trace artifacts (JSONL exports or flight-dump "
        "dirs): join the capture against the causal-trace forest and "
        "decompose the dispatch stage",
    )
    s.add_argument("--json", action="store_true", help="JSON output")
    s.set_defaults(fn=cmd_profile)

    s = sub.add_parser(
        "train",
        help="win-probability heads (logistic/MLP) on leak-free rating "
        "features, chronological holdout eval",
    )
    s.add_argument("--csv", help="match stream, .csv or .npz")
    s.add_argument(
        "--db", metavar="URI",
        help="train on a full history ingested straight from a database "
        "(columnar load_stream; features COLD-START even if the DB holds "
        "ratings — stored ratings are usually this history's own end "
        "state, and seeding from them would leak outcomes into the eval)",
    )
    s.add_argument("--model", choices=("logistic", "mlp"), default="logistic")
    s.add_argument("--epochs", type=int, default=30)
    s.add_argument("--hidden", type=int, default=64, help="MLP width")
    s.add_argument("--eval-frac", type=float, default=0.2,
                   help="chronological tail fraction held out for eval")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--out", help="npz output for the trained weights")
    s.add_argument(
        "--telemetry", action="store_true",
        help="append post-game telemetry features (analysis head, "
        "BASELINE config 4; needs an .npz stream from synth --telemetry)",
    )
    s.add_argument(
        "--mesh", type=int, metavar="N",
        help="data-parallel training: shard the minibatch axis over N "
        "shards (0 = one per process)",
    )
    s.add_argument(
        "--device", default="cuda",
        help="torch device to train on (default cuda: the card; exits 2 "
        "where none is visible)",
    )
    s.set_defaults(fn=cmd_train)

    s = sub.add_parser("elo", help="Elo re-rate of a stream + accuracy")
    s.add_argument("--csv", help="match stream, .csv or .npz")
    s.add_argument(
        "--db", metavar="URI",
        help="Elo re-rate a full history straight from a database",
    )
    s.add_argument("--out", help="npz output for ratings/predictions")
    s.add_argument(
        "--device", default="cuda",
        help="torch device to rate on (default cuda: the card; exits 2 "
        "where none is visible)",
    )
    s.set_defaults(fn=cmd_elo)

    s = sub.add_parser(
        "quality",
        help="rating-quality report: calibration reliability table, "
        "Brier/log-loss/ECE, population drift (a /qualityz endpoint, a "
        "saved soak artifact, or this process's ledger)",
    )
    s.add_argument(
        "--url", metavar="URL",
        help="fetch from a server's /qualityz endpoint "
        "(e.g. http://127.0.0.1:9100 — /qualityz is appended)",
    )
    s.add_argument(
        "--artifact", metavar="PATH",
        help="read the quality block of a saved SOAK_*.json artifact",
    )
    s.add_argument(
        "--fit-temperature", action="store_true",
        help="fit a post-hoc temperature over the live ledger's "
        "retained (logit, outcome) prefix (models/calibration.py) and "
        "report NLL before/after — quantifies over/under-confidence",
    )
    s.add_argument(
        "--json", action="store_true",
        help="dump the summary as JSON instead of the rendered report",
    )
    s.set_defaults(fn=cmd_quality)

    s = sub.add_parser(
        "fleet",
        help="fleet observability plane: scrape N workers' obsd "
        "endpoints, merge registries under host=, evaluate fleet-scope "
        "SLO burns with per-host attribution, serve /fleetz",
    )
    s.add_argument(
        "targets_pos", nargs="*", metavar="HOST:PORT",
        help="worker obsd endpoints to scrape",
    )
    s.add_argument(
        "--targets", metavar="HOST:PORT,...",
        help="comma-separated target list (merged with positionals)",
    )
    s.add_argument(
        "--port", type=int, default=0,
        help="fleetd serving port (default: ephemeral, printed)",
    )
    s.add_argument(
        "--interval", type=float, default=2.0, metavar="S",
        help="scrape cadence in seconds (default: 2)",
    )
    s.add_argument(
        "--scrapes", type=int, default=0, metavar="N",
        help="stop after N scrape rounds (default: run until ^C); the "
        "exit code reports whether anything was burning at the end",
    )
    s.add_argument(
        "--check", action="store_true",
        help="one-shot CI gate: scrape once, evaluate the objectives a "
        "single sample can judge (absolute counter_zero + worst-host "
        "gauge_max), exit 1 on any burn",
    )
    s.add_argument(
        "--require-all-up", action="store_true",
        help="--check also fails when any target is unreachable",
    )
    s.add_argument(
        "--flight-token", metavar="TOKEN",
        help="shared secret for the burning host's /debug/flight "
        "trigger (workers read ANALYZER_TPU_FLIGHT_TOKEN)",
    )
    s.add_argument(
        "--no-flight-requests", action="store_true",
        help="never ask burning hosts for flight dumps",
    )
    s.add_argument("--json", action="store_true",
                   help="--check prints the fleet /sloz payload as JSON")
    s.set_defaults(fn=cmd_fleet)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
