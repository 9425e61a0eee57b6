"""Trace analyzer: reconstruct per-match / per-batch timelines from a
trace-events export.

The port's own copy of ``analyzer_tpu.obs.traceview`` (stdlib only, the
same model, reports and renderers), so ``cli trace`` reads exports of
either package. In the port, ``feed.transfer`` (the ``h2d`` stage) is the
slab's copy to the card, issued on the consumer thread; the JAX package
issues its transfer on the feed's producer thread.

Input is the Chrome trace-event JSONL the tracer exports (``cli rate
--trace-events``, ``cli soak --trace-events``, or the ``trace.jsonl``
inside a flight-recorder dump directory). With causal tracing enabled
(obs/tracectx.py) those events carry the ids that make reconstruction
possible:

  * ``trace.enqueue`` instants anchor each match's timeline at the
    moment it entered the broker;
  * ``batch.assemble`` instants record which match traces joined which
    batch (``batch`` id + ``members`` + ``enqueues``);
  * every span the batch's pipeline emitted — encode, pack, the feed
    thread's materialize/transfer, dispatch, fetch, commit — carries
    ``args.trace`` = the batch id;
  * ``view.publish`` instants mark the version that made the batch's
    rows serve-visible.

:func:`build_model` joins those into a :class:`TraceModel`;
:func:`match_report` / :func:`batch_report` decompose one journey into
the operator-facing stages (queue wait, encode, pack, feed staging,
H2D, dispatch, fetch, commit, publish lag); :func:`critical_path`
aggregates a window of batches and names the dominant stage — the
number a staleness page actually needs. ``cli trace`` renders all
three; the soak driver embeds :func:`critical_path` into the SOAK
artifact. Stdlib-only, like the rest of the exposition layer.

**Cross-process stitching** (docs/observability.md "Fleet plane"):
trace ids already ride broker message headers across process
boundaries (obs/tracectx.py), so a match enqueued on host A and rated
on host B leaves its ``trace.enqueue`` anchor in A's export and the
rest of its chain in B's. :func:`load_forest` joins *multiple*
``--trace-events`` files / flight-dump dirs into one trace forest: each
export's leading ``trace_epoch`` metadata (the tracer's wall epoch)
rebases its microsecond timeline onto one wall-aligned axis, every
event is tagged with its source host label, and the enqueue→assemble
gap of a cross-host chain surfaces as its own ``broker_transit`` stage
(network + broker residency — queue wait measured across machines)
instead of silently inflating ``queue_wait``. :func:`critical_path`
then attributes each stage to the host whose spans produced it.
``cli trace --match M f1.jsonl f2.jsonl`` drives the whole join.
"""

from __future__ import annotations

import json
import os

#: Span name -> stage bucket of the operator-facing decomposition.
#: ``batch.compute`` / ``batch.dispatch`` are ENQUEUE cost (dispatch);
#: device time surfaces host-side in ``batch.fetch``; the tier manager's
#: promote/demote traffic is feed-thread staging work.
STAGE_OF = {
    "batch.encode": "encode",
    "batch.pack": "pack",
    "batch.chain": "dispatch",
    "batch.dispatch": "dispatch",
    "batch.compute": "dispatch",
    "feed.materialize": "feed_staging",
    "tier.promote": "feed_staging",
    "tier.demote": "feed_staging",
    "feed.transfer": "h2d",
    "batch.fetch": "fetch",
    "batch.write_back": "commit",
    "batch.commit": "commit",
}

#: Stage order for reports (queue wait first, publish lag last — the
#: journey's actual order). ``broker_transit`` is the cross-process
#: handoff gap of a STITCHED chain (enqueue on host A -> batch assembly
#: on host B, wall-aligned); single-process chains report it as None
#: and carry the same gap as ``queue_wait``.
STAGES = (
    "queue_wait", "broker_transit", "encode", "pack", "feed_staging", "h2d",
    "dispatch", "fetch", "commit", "publish_lag",
)


class BatchTrace:
    """One batch's reconstructed record."""

    __slots__ = (
        "batch_id", "assemble_ts", "members", "enqueues", "stage_us",
        "commit_end", "publish_ts", "publish_version", "mode",
        "host", "cross_host", "transit_label",
    )

    def __init__(self, batch_id: str, assemble_ts: float,
                 members: list, enqueues: list,
                 host: str | None = None) -> None:
        self.batch_id = batch_id
        self.assemble_ts = assemble_ts
        self.members = members
        self.enqueues = enqueues
        self.stage_us: dict[str, float] = {}
        self.commit_end: float | None = None
        self.publish_ts: float | None = None
        self.publish_version: int | None = None
        self.mode: str | None = None
        # Stitched-forest attribution (load_forest): which host's export
        # assembled this batch, whether any member was enqueued on a
        # DIFFERENT host (the broker_transit case), and the handoff's
        # "src->dst" label for the critical-path report.
        self.host = host
        self.cross_host = False
        self.transit_label: str | None = None


class TraceModel:
    """The joined view over one trace export (or a stitched forest)."""

    def __init__(self) -> None:
        self.batches: dict[str, BatchTrace] = {}
        self.match_batch: dict[str, str] = {}
        self.enqueue_ts: dict[str, float] = {}
        # Stitched forests only: which host's export anchored each
        # match's enqueue, and every host label seen.
        self.enqueue_host: dict[str, str] = {}
        self.hosts: set[str] = set()

    def batch_of(self, match_id: str) -> BatchTrace | None:
        bid = self.match_batch.get(match_id)
        return self.batches.get(bid) if bid else None


def load_events(path: str, host: str | None = None) -> list[dict]:
    """Parses a trace-events JSONL file — or, given a flight-recorder
    dump directory, its ``trace.jsonl``. ``host`` tags every event with
    a source label (the stitcher's attribution key). Raises
    OSError/ValueError on unreadable or malformed input (a truncated
    final line is tolerated: a crashed run must still analyze)."""
    if os.path.isdir(path):
        path = os.path.join(path, "trace.jsonl")
    events: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except ValueError:
                # Only the final line may be torn (crash mid-write).
                remainder = f.read().strip()
                if remainder:
                    raise ValueError(
                        f"{path}:{i + 1}: malformed trace event"
                    ) from None
                continue
            if host is not None:
                event["_host"] = host
            events.append(event)
    return events


def host_label(path: str) -> str:
    """A human host label for one trace source: the flight-dump
    directory name, or the file's basename minus extension."""
    path = path.rstrip("/\\")
    base = os.path.basename(path)
    if base == "trace.jsonl":  # inside a flight dump: the dir names it
        base = os.path.basename(os.path.dirname(path)) or base
    return base.rsplit(".", 1)[0] if base.endswith(".jsonl") else base


def _file_epoch(events: list[dict]) -> float | None:
    """The export's ``trace_epoch`` metadata (tracer wall epoch)."""
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "trace_epoch":
            epoch = (ev.get("args") or {}).get("epoch_wall")
            if epoch is not None:
                return float(epoch)
    return None


def load_forest(paths: list, hosts: list | None = None) -> list[dict]:
    """Joins MULTIPLE trace exports (files or flight-dump dirs) into one
    event list on a single wall-aligned timeline: each file's events are
    rebased by its ``trace_epoch`` metadata (offsets in microseconds
    from the earliest epoch) and tagged with a host label, so
    :func:`build_model` reconstructs chains that CROSS process
    boundaries — the enqueue anchor from the publisher's export joins
    the batch spans from the worker's. Every file must carry the epoch
    metadata (exports since the stitcher landed do); a file without it
    cannot be clock-aligned and fails loudly."""
    if hosts is None:
        hosts = []
        for p in paths:
            label = host_label(p)
            while label in hosts:  # two files, one basename: suffix
                label += "'"
            hosts.append(label)
    per_file = []
    for path, host in zip(paths, hosts):
        events = load_events(path, host=host)
        epoch = _file_epoch(events)
        if epoch is None and len(paths) > 1:
            raise ValueError(
                f"{path}: no trace_epoch metadata — this export cannot "
                "be clock-aligned with the others (re-capture it, or "
                "analyze the files singly)"
            )
        per_file.append((events, epoch or 0.0))
    base = min(epoch for _, epoch in per_file)
    out: list[dict] = []
    for events, epoch in per_file:
        offset_us = (epoch - base) * 1e6
        for ev in events:
            if ev.get("ph") == "M":
                continue
            if offset_us:
                ev = dict(ev, ts=float(ev.get("ts", 0.0)) + offset_us)
            out.append(ev)
    return out


def build_model(events: list[dict]) -> TraceModel:
    """Joins raw trace events into a :class:`TraceModel`. Events from
    untraced work (no causal ids — warmup, other runs sharing the ring)
    are skipped; a bounded ring that dropped a batch's early events
    yields a partial record, which :func:`verify_chain` reports instead
    of hiding."""
    model = TraceModel()
    # The ring appends in emission order per thread but interleaves
    # across threads; ts-sorting makes the join order-insensitive.
    for ev in sorted(events, key=lambda e: e.get("ts", 0.0)):
        name = ev.get("name")
        args = ev.get("args") or {}
        ts = float(ev.get("ts", 0.0))
        host = ev.get("_host")
        if host is not None:
            model.hosts.add(host)
        if name == "trace.enqueue":
            trace = args.get("trace")
            if trace is not None:
                model.enqueue_ts.setdefault(str(trace), ts)
                if host is not None:
                    model.enqueue_host.setdefault(str(trace), host)
            continue
        # Batch trace ids (``b<N>``) come from a PROCESS-local counter —
        # two stitched exports legitimately both carry a "b1". Namespace
        # them by the event's host so the forest keeps both; every span
        # referencing a batch id lives in the same export (same host),
        # so the mapping is consistent per file. Single-export models
        # (host None) keep the raw ids, unchanged.
        if name == "batch.assemble":
            bid = args.get("batch")
            if bid is None:
                continue
            bid = f"{host}:{bid}" if host is not None else str(bid)
            members = [str(m) for m in (args.get("members") or [])]
            bt = BatchTrace(
                bid, ts, members, list(args.get("enqueues") or []),
                host=host,
            )
            model.batches[bt.batch_id] = bt
            for m in members:
                model.match_batch[m] = bt.batch_id
            continue
        trace = args.get("trace")
        if trace is None:
            continue
        trace = f"{host}:{trace}" if host is not None else str(trace)
        if trace not in model.batches:
            continue
        bt = model.batches[trace]
        if name == "view.publish":
            if bt.publish_ts is None:  # first publish wins: the moment
                bt.publish_ts = ts     # the rows became serve-visible
                bt.publish_version = args.get("version")
            continue
        if ev.get("ph") != "X":
            continue
        if name == "batch.lifecycle":
            bt.mode = args.get("mode")
            continue
        stage = STAGE_OF.get(name)
        if stage is None:
            continue
        dur = float(ev.get("dur", 0.0))
        bt.stage_us[stage] = bt.stage_us.get(stage, 0.0) + dur
        if stage == "commit":
            end = ts + dur
            if bt.commit_end is None or end > bt.commit_end:
                bt.commit_end = end
    _finalize_cross_host(model)
    return model


def _finalize_cross_host(model: TraceModel) -> None:
    """Marks batches whose members were enqueued on a DIFFERENT host
    than the one that assembled them (stitched forests only), and
    rebinds their ``enqueues`` to the publisher-side wall-aligned
    anchors — the header-borne stamps a cross-host worker recorded are
    on the PUBLISHER's unrebased timeline, so only the anchors from the
    publisher's own export can be subtracted against this batch's
    timestamps. The handoff gap then reports as ``broker_transit``."""
    for bt in model.batches.values():
        if bt.host is None:
            continue
        member_hosts = [model.enqueue_host.get(m) for m in bt.members]
        if not any(h is not None and h != bt.host for h in member_hosts):
            continue
        bt.cross_host = True
        bt.enqueues = [model.enqueue_ts.get(m) for m in bt.members]
        src = next(
            h for h in member_hosts if h is not None and h != bt.host
        )
        bt.transit_label = f"{src}->{bt.host}"


def _ms(us: float | None) -> float | None:
    return None if us is None else round(us / 1e3, 3)


def batch_report(bt: BatchTrace) -> dict:
    """One batch's stage decomposition, milliseconds. A cross-host
    batch (stitched forest) reports its enqueue->assemble gap as
    ``broker_transit`` — the handoff crossed a process/machine boundary
    — where a same-process batch reports ``queue_wait``."""
    waits = [
        bt.assemble_ts - e
        for e in bt.enqueues
        if isinstance(e, (int, float))
    ]
    gap = _ms(max(waits)) if waits else None
    stages: dict[str, float | None] = {
        "queue_wait": None if bt.cross_host else gap,
        "broker_transit": gap if bt.cross_host else None,
    }
    for s in STAGES[2:-1]:
        stages[s] = _ms(bt.stage_us.get(s))
    stages["publish_lag"] = (
        _ms(bt.publish_ts - bt.commit_end)
        if bt.publish_ts is not None and bt.commit_end is not None
        else None
    )
    report = {
        "batch": bt.batch_id,
        "mode": bt.mode,
        "matches": len(bt.members),
        "assemble_us": round(bt.assemble_ts, 1),
        "stages_ms": stages,
        "publish_version": bt.publish_version,
        "end_to_end_ms": (
            _ms(bt.publish_ts - min(
                [e for e in bt.enqueues if isinstance(e, (int, float))],
                default=bt.assemble_ts,
            ))
            if bt.publish_ts is not None else None
        ),
    }
    if bt.host is not None:
        report["host"] = bt.host
    return report


def match_report(model: TraceModel, match_id: str) -> dict | None:
    """One match's journey: its own queue wait plus its batch's stage
    decomposition. None when the trace never saw the match."""
    bt = model.batch_of(match_id)
    enq = model.enqueue_ts.get(match_id)
    if enq is None and bt is not None and match_id in bt.members:
        e = bt.enqueues[bt.members.index(match_id)]
        enq = float(e) if isinstance(e, (int, float)) else None
    if bt is None and enq is None:
        return None
    report = {
        "match": match_id,
        "enqueue_us": None if enq is None else round(enq, 1),
        "batch": None,
        "queue_wait_ms": None,
        "stages_ms": None,
        "publish_version": None,
        "end_to_end_ms": None,
    }
    if bt is None:
        return report
    b = batch_report(bt)
    report["batch"] = bt.batch_id
    gap = _ms(bt.assemble_ts - enq) if enq is not None else None
    report["queue_wait_ms"] = None if bt.cross_host else gap
    stages = dict(b["stages_ms"])
    if bt.cross_host:
        # The stitched handoff: this match left host A's broker publish
        # and surfaced in host B's batch — network + broker residency.
        stages["queue_wait"] = None
        stages["broker_transit"] = gap
        report["broker_transit_ms"] = gap
        report["enqueue_host"] = model.enqueue_host.get(match_id)
        report["batch_host"] = bt.host
    else:
        stages["queue_wait"] = gap
    report["stages_ms"] = stages
    report["publish_version"] = bt.publish_version
    if bt.publish_ts is not None and enq is not None:
        report["end_to_end_ms"] = _ms(bt.publish_ts - enq)
    return report


def verify_chain(model: TraceModel, match_id: str) -> list[str]:
    """The completeness/monotonicity check the e2e tests gate on:
    returns human-readable problems (empty = the chain enqueue ->
    batch -> commit -> publish reconstructs completely with monotone
    timestamps)."""
    problems: list[str] = []
    bt = model.batch_of(match_id)
    if bt is None:
        return [f"{match_id}: no batch.assemble names this match"]
    enq = model.enqueue_ts.get(match_id)
    if enq is None and match_id in bt.members:
        e = bt.enqueues[bt.members.index(match_id)]
        enq = float(e) if isinstance(e, (int, float)) else None
    if enq is None:
        problems.append(
            f"{match_id}: no cross-host enqueue anchor — stitch the "
            "publishing host's trace export into the forest"
            if bt.cross_host else
            f"{match_id}: no enqueue timestamp"
        )
    if bt.cross_host and enq is not None:
        # The handoff gap is its own stage on a stitched chain: the
        # wall-aligned enqueue must precede assembly (a negative
        # broker_transit means the two exports' clocks disagree).
        transit_us = bt.assemble_ts - enq
        if transit_us < -1.0:
            problems.append(
                f"{match_id}: negative broker_transit "
                f"({transit_us:.1f} us) — enqueue on "
                f"{model.enqueue_host.get(match_id)} is AFTER assembly "
                f"on {bt.host}; the exports' clocks are not aligned"
            )
    for stage in ("encode", "dispatch", "commit"):
        if not bt.stage_us.get(stage):
            problems.append(
                f"{match_id}: batch {bt.batch_id} has no {stage} span"
            )
    if bt.publish_ts is None or bt.publish_version is None:
        problems.append(
            f"{match_id}: batch {bt.batch_id} never published a view "
            "version"
        )
    # Monotone timeline (us, one tracer epoch): enqueue <= assemble;
    # commit ends before the publish that exposes it.
    if enq is not None and enq > bt.assemble_ts + 1.0:
        problems.append(
            f"{match_id}: enqueue ({enq:.1f}) after batch assembly "
            f"({bt.assemble_ts:.1f})"
        )
    if (
        bt.publish_ts is not None
        and bt.commit_end is not None
        and bt.commit_end > bt.publish_ts + 1.0
    ):
        problems.append(
            f"{match_id}: commit end ({bt.commit_end:.1f}) after view "
            f"publish ({bt.publish_ts:.1f})"
        )
    if enq is not None and bt.publish_ts is not None and (
        enq > bt.publish_ts
    ):
        problems.append(
            f"{match_id}: enqueue after the publish that served it"
        )
    return problems


def critical_path(model: TraceModel, window: int | None = None) -> dict:
    """Aggregate stage decomposition over a window of batches (the last
    ``window`` by assembly time; None = all): total ms and share per
    stage, and the DOMINANT stage — what a staleness/p99 page should
    look at first. Queue wait and publish lag aggregate per batch
    (max-wait member and commit->publish gap respectively)."""
    batches = sorted(model.batches.values(), key=lambda b: b.assemble_ts)
    if window:
        batches = batches[-window:]
    totals = {s: 0.0 for s in STAGES}
    counted = {s: 0 for s in STAGES}
    stage_hosts: dict[str, dict[str, float]] = {s: {} for s in STAGES}
    matches = 0
    for bt in batches:
        matches += len(bt.members)
        rep = batch_report(bt)["stages_ms"]
        for s in STAGES:
            v = rep.get(s)
            if v is not None:
                totals[s] += v
                counted[s] += 1
                if bt.host is not None:
                    # Span stages ran on the assembling host; the
                    # handoff belongs to the src->dst pair.
                    owner = (
                        bt.transit_label
                        if s == "broker_transit" and bt.transit_label
                        else bt.host
                    )
                    hosts = stage_hosts[s]
                    hosts[owner] = hosts.get(owner, 0.0) + v
    grand = sum(totals.values())
    dominant = max(totals, key=lambda s: totals[s]) if grand > 0 else None
    out = {
        "batches": len(batches),
        "matches": matches,
        "stages_ms": {s: round(totals[s], 3) for s in STAGES},
        "stage_share": {
            s: (round(totals[s] / grand, 4) if grand > 0 else None)
            for s in STAGES
        },
        "batches_counted": counted,
        "dominant_stage": dominant,
    }
    if model.hosts:
        # Stitched forests attribute each stage to its host (the fleet
        # question: WHICH machine owns the dominant stage). Absent on
        # single-export models so existing artifacts are unchanged.
        out["hosts"] = sorted(model.hosts)
        out["stage_hosts"] = {
            s: {h: round(v, 3) for h, v in sorted(hosts.items())}
            for s, hosts in stage_hosts.items() if hosts
        }
        if dominant is not None and stage_hosts.get(dominant):
            out["dominant_host"] = max(
                stage_hosts[dominant], key=stage_hosts[dominant].get
            )
    return out


# -- rendering (cli trace) --------------------------------------------------

def _fmt_ms(v) -> str:
    return "-" if v is None else f"{v:.3f}"


def render_stages(stages: dict, indent: str = "  ") -> str:
    width = max(len(s) for s in STAGES)
    return "\n".join(
        f"{indent}{s.ljust(width)}  {_fmt_ms(stages.get(s))} ms"
        for s in STAGES
    )


def render_match(report: dict) -> str:
    out = [f"match {report['match']}"]
    if report["batch"] is None:
        out.append("  enqueued but never assembled into a batch "
                   "(still queued, dead-lettered, or outside the ring)")
        return "\n".join(out) + "\n"
    out.append(f"  batch {report['batch']}"
               + (f" ({report.get('mode')})" if report.get("mode") else ""))
    if report.get("enqueue_host") or report.get("batch_host"):
        out.append(
            f"  cross-host: enqueued on {report.get('enqueue_host') or '?'}"
            f", rated on {report.get('batch_host') or '?'}"
        )
    if report["stages_ms"]:
        out.append(render_stages(report["stages_ms"]))
    v = report["publish_version"]
    out.append(
        f"  served at view v{v}" if v is not None
        else "  never became serve-visible in this trace"
    )
    if report["end_to_end_ms"] is not None:
        out.append(f"  end-to-end {report['end_to_end_ms']:.3f} ms "
                   "(enqueue -> served-visible)")
    return "\n".join(out) + "\n"


def render_batch(report: dict) -> str:
    out = [
        f"batch {report['batch']} ({report['matches']} matches"
        + (f", {report['mode']}" if report.get("mode") else "") + ")"
    ]
    out.append(render_stages(report["stages_ms"]))
    v = report["publish_version"]
    out.append(
        f"  served at view v{v}" if v is not None
        else "  never became serve-visible in this trace"
    )
    return "\n".join(out) + "\n"


def render_critical_path(cp: dict) -> str:
    out = [
        f"critical path over {cp['batches']} batch(es) / "
        f"{cp['matches']} match(es)"
        + (f" across hosts {', '.join(cp['hosts'])}" if cp.get("hosts")
           else "") + ":"
    ]
    grand = sum(v for v in cp["stages_ms"].values())
    width = max(len(s) for s in STAGES)
    stage_hosts = cp.get("stage_hosts") or {}
    for s in STAGES:
        total = cp["stages_ms"][s]
        share = cp["stage_share"][s]
        pct = "" if share is None else f"  {100 * share:5.1f}%"
        hosts = stage_hosts.get(s)
        attribution = ""
        if hosts:
            attribution = "  [" + ", ".join(
                f"{h} {v:.3f}" for h, v in hosts.items()
            ) + "]"
        out.append(f"  {s.ljust(width)}  {total:10.3f} ms{pct}{attribution}")
    out.append(
        f"  dominant stage: {cp['dominant_stage']}"
        + (f" (on {cp['dominant_host']})" if cp.get("dominant_host") else "")
        if cp["dominant_stage"] else "  (no attributable stage time)"
    )
    out.append(f"  total attributed: {grand:.3f} ms")
    return "\n".join(out) + "\n"
