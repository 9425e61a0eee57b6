"""Tuning advisor: a deterministic rule table over the repo's artifacts.

The port's copy of ``analyzer_tpu.obs.advisor``: the same rule table,
thresholds and report, over the port's artifacts and its profile
attribution (``obs/profview.py``). Two wordings name the port's own
things: the fused rule's action names the window's working set in its
cluster's shared memory (the TPU kernel held it in VMEM), and the queue
rules name ``cli soak --broker-partitions``, the flag both CLIs define.

ROADMAP item 1's rig campaign is a tuning loop — name the dominant
stage at each scale point, turn a knob, re-measure. The telemetry to
answer "which knob" already ships in every artifact the repo emits
(BENCH/SOAK/INGEST/MIGRATE JSON lines, history rings, and now the
profile attribution + roofline ledger); this module is the missing
read side: ``cli tune`` loads whatever artifacts exist, walks a FIXED
rule table in severity order, and emits findings that each

  * name the bottleneck,
  * recommend a concrete knob change — ``fuse_window``, ``hot_rows``,
    prefetch depth, ``plan_windows``, broker admission — and
  * cite the exact evidence series (value + artifact) that triggered
    the rule,

rendered as text or JSON plus a ready-to-paste env/flag snippet.

**Pure, clock-free, deterministic** (graftlint GL046, like the
history/SLO plane's GL032): no wall-clock reads, no randomness, no
dict-order dependence — the same inputs produce a byte-identical
report, so a tuning recommendation can be diffed, committed, and
re-derived on another machine. Peak-magnitude literals are banned here
too; anything roofline-shaped comes pre-computed in the artifacts (the
roofs themselves live in :mod:`analyzer_tpu_torch.obs.hw`).
"""

from __future__ import annotations

import glob
import json
import os

#: Artifact filename families ``gather_inputs`` scans for (sorted, so
#: the newest ``rNN`` sorts last and becomes the family's evidence).
ARTIFACT_GLOBS = (
    "BENCH_*.json",
    "SOAK_*.json",
    "INGEST_BENCH_*.json",
    "MIGRATE_BENCH_*.json",
    "SERVE_BENCH_*.json",
)

#: Evidence thresholds, named so the rule table reads as policy.
IDLE_FRAC_HIGH = 0.4          # device idles >40% of the capture window
FUSED_RATIO_NOT_PAYING = 0.97  # fused/reference >= this = fusion moot
TIER_HIT_RATE_LOW = 0.95
TIER_TAX_HIGH = 1.25           # tiered/resident end-to-end ratio
BANDWIDTH_ROOF_FRAC = 0.5
QUEUE_GROWTH_FACTOR = 2.0      # broker depth last/first over the rings


def load_artifact(path: str) -> dict | None:
    """One artifact's metric line (unwraps a capture's ``{"parsed":
    ...}`` shape); None when unreadable — the advisor runs over
    whatever evidence actually loads."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict):
        return None
    if "metric" not in data and isinstance(data.get("parsed"), dict):
        data = data["parsed"]
    return data if "metric" in data else None


def family_of(data: dict) -> str:
    metric = str(data.get("metric", ""))
    for prefix, fam in (
        ("soak.", "soak"), ("ingest.", "ingest"), ("migrate.", "migrate"),
        ("serve.", "serve"),
    ):
        if metric.startswith(prefix):
            return fam
    return "bench"


def gather_inputs(paths=(), scan_dir: str | None = None,
                  profile_dir: str | None = None) -> dict:
    """Loads the advisor's evidence. Explicit ``paths`` win; otherwise
    ``scan_dir`` is globbed for the known artifact families. A path
    ending in ``history.json`` (or a flight-dump dir holding one) loads
    as the history rings; ``profile_dir`` attributes a capture dir via
    obs/profview (metrics updates off — the advisor is pure)."""
    from analyzer_tpu_torch.obs.profview import analyze_capture

    names: list[str] = []
    if paths:
        names = sorted(paths)
    elif scan_dir:
        for pattern in ARTIFACT_GLOBS:
            names.extend(glob.glob(os.path.join(scan_dir, pattern)))
        names = sorted(names)
    artifacts = []
    history = None
    for p in names:
        base = p
        if os.path.isdir(p):
            base = os.path.join(p, "history.json")
        if base.endswith("history.json"):
            try:
                with open(base, encoding="utf-8") as f:
                    payload = json.load(f)
                if isinstance(payload, dict) and "series" in payload:
                    history = payload
                    continue
            except (OSError, ValueError):
                continue
        data = load_artifact(p)
        if data is None:
            continue
        artifacts.append(
            {"path": p, "family": family_of(data),
             "metric": str(data.get("metric", "")), "data": data}
        )
    profile = None
    if profile_dir:
        profile = analyze_capture(profile_dir, update_metrics=False)
    return {"artifacts": artifacts, "history": history, "profile": profile}


def _latest(inputs: dict, family: str) -> dict | None:
    """Newest artifact of a family (sorted path order: rNN naming makes
    lexicographic == chronological)."""
    picked = None
    for art in inputs["artifacts"]:
        if art["family"] == family:
            picked = art
    return picked


def _finding(rule, bottleneck, action, evidence, env=None, flags=None):
    return {
        "rule": rule,
        "bottleneck": bottleneck,
        "action": action,
        "evidence": list(evidence),
        "env": dict(env or {}),
        "flags": list(flags or []),
    }


# -- the rule table (evaluated in order; order = severity) --------------

def _rule_ingest_native(inputs):
    art = _latest(inputs, "ingest")
    if art is None:
        return None
    ingest = art["data"].get("ingest") or {}
    if ingest.get("native") is False:
        return _finding(
            "ingest-native-fallback", "ingest decode (python codec)",
            "the columnar native decoder was unavailable and ingest ran "
            "the python codec — rebuild io/_native_csv before tuning "
            "anything else; every downstream number is decode-bound",
            [f"ingest.native=false ({art['path']})"],
        )
    return None


def _rule_migrate_assign(inputs):
    art = _latest(inputs, "migrate")
    if art is None:
        return None
    mig = art["data"].get("migrate") or {}
    if mig.get("assign_native") is False:
        return _finding(
            "migrate-assign-fallback", "backfill assignment (python loop)",
            "the migration's windowed first-fit ran the python fallback "
            "instead of the GIL-released native loop — rebuild "
            "sched/packer.cc; assignment throughput is ~two orders below "
            "the native route",
            [f"migrate.assign_native=false ({art['path']})"],
        )
    return None


def _rule_feed_starved(inputs):
    art = _latest(inputs, "bench")
    if art is None:
        return None
    feed = ((art["data"].get("telemetry") or {}).get("feed")) or {}
    starved = feed.get("starved_total") or 0
    backpressure = feed.get("backpressure_total") or 0
    if starved > 0 and starved >= backpressure:
        return _finding(
            "feed-starved", "host feed (device starved for windows)",
            "the prefetching feed starved at least as often as it "
            "backpressured — the device outran the host; deepen the "
            "committed-slab ring",
            [
                f"feed.starved_total={starved} vs "
                f"feed.backpressure_total={backpressure} ({art['path']})"
            ],
            env={"BENCH_FEED_DEPTH": "4"},
            flags=["cli bench (BENCH_FEED_DEPTH=4)"],
        )
    return None


def _rule_device_idle(inputs):
    art = _latest(inputs, "bench")
    evidence = []
    window = None
    if art is not None:
        roof = art["data"].get("roofline") or {}
        idle = roof.get("device_idle_frac")
        if idle is not None and idle > IDLE_FRAC_HIGH:
            evidence.append(
                f"roofline.device_idle_frac={idle} ({art['path']})"
            )
        fused = art["data"].get("fused") or {}
        if fused.get("window"):
            window = int(fused["window"])
    prof = inputs.get("profile")
    if prof and prof.get("parsed"):
        idle = (prof.get("device") or {}).get("idle_frac")
        if idle is not None and idle > IDLE_FRAC_HIGH:
            evidence.append(
                f"profile device.idle_frac={idle} ({prof['dir']})"
            )
    if not evidence:
        return None
    new_window = (window or 16) * 2
    return _finding(
        "device-idle", "per-dispatch overhead (device idles mid-window)",
        f"the device sat idle more than {int(100 * IDLE_FRAC_HIGH)}% of "
        "the capture window — dispatches are too small to amortize "
        f"launch latency; widen the fused window to {new_window} "
        "supersteps per dispatch",
        evidence,
        env={"BENCH_FUSE_WINDOW": str(new_window)},
        flags=[f"cli bench --fuse-window {new_window}"],
    )


def _rule_dispatch_overhead(inputs):
    art = _latest(inputs, "bench")
    if art is None:
        return None
    roof = art["data"].get("roofline") or {}
    if roof.get("bound_by") != "overhead":
        return None
    return _finding(
        "dispatch-overhead", "per-dispatch fixed cost",
        "the roofline verdict is `overhead` — achieved bandwidth AND "
        "flops both sit under 5% of peak, so neither roof is the "
        "constraint; batch more work per dispatch (fuse window, batch "
        "size) before touching anything bandwidth-shaped",
        [
            f"roofline.bound_by=overhead, frac_of_peak_bw="
            f"{roof.get('frac_of_peak_bw')}, frac_of_peak_flops="
            f"{roof.get('frac_of_peak_flops')} ({art['path']})"
        ],
        env={"BENCH_FUSE_WINDOW": "32"},
        flags=["cli bench --fuse-window 32"],
    )


def _rule_fused_not_paying(inputs):
    art = _latest(inputs, "bench")
    if art is None:
        return None
    fused = art["data"].get("fused") or {}
    ratio = fused.get("min_over_reference")
    if ratio is None or ratio < FUSED_RATIO_NOT_PAYING:
        return None
    window = int(fused.get("window") or 16)
    new_window = window * 2
    return _finding(
        "fused-not-paying", "fused window kernel (no gain over reference)",
        f"fused.min_over_reference={ratio} — the window kernel, its "
        "working set resident in its cluster's shared memory, is not "
        "beating the reference scan (a ratio ~1.0 can "
        "also mean a silent fallback); widen the window to "
        f"{new_window} so residency amortizes more scatter traffic",
        [f"fused.min_over_reference={ratio}, window={window} "
         f"({art['path']})"],
        env={"BENCH_FUSE_WINDOW": str(new_window)},
        flags=[f"cli bench --fuse-window {new_window}"],
    )


def _rule_tier_thrash(inputs):
    art = _latest(inputs, "bench")
    if art is None:
        return None
    tiered = art["data"].get("tiered") or {}
    hit = tiered.get("hit_rate")
    tax = tiered.get("min_over_resident")
    evidence = []
    if hit is not None and hit < TIER_HIT_RATE_LOW:
        evidence.append(f"tiered.hit_rate={hit} ({art['path']})")
    if tax is not None and tax > TIER_TAX_HIGH:
        evidence.append(f"tiered.min_over_resident={tax} ({art['path']})")
    if not evidence:
        return None
    hot = int(tiered.get("hot_rows") or 0)
    new_hot = hot * 2 if hot else 0
    action = (
        "the hot set is too small for the working set (tier thrash: "
        "promotions on the hot path)"
    )
    env = {}
    flags = []
    if new_hot:
        action += f"; double the hot set to {new_hot} rows"
        env["BENCH_HOT_ROWS"] = str(new_hot)
        flags.append(f"cli bench --hot-rows {new_hot}")
    else:
        action += "; double hot_rows"
    return _finding(
        "tier-thrash", "tiered table (hot-set thrash)", action, evidence,
        env=env, flags=flags,
    )


def _rule_queue_wait(inputs):
    art = _latest(inputs, "soak")
    if art is None:
        return None
    dominant = (
        (art["data"].get("slo") or {}).get("dominant_stage")
        or (art["data"].get("trace") or {}).get("dominant_stage")
    )
    if dominant not in ("queue_wait", "broker_transit"):
        return None
    return _finding(
        "queue-wait-dominant", "broker admission (batches wait in queue)",
        f"the soak's dominant stage is `{dominant}` — matches spend "
        "longer waiting for admission than being processed; partition "
        "the broker / add workers, or lower the admitted rate to what "
        "the dispatch plane sustains",
        [f"slo.dominant_stage={dominant} ({art['path']})"],
        flags=["cli soak --broker-partitions 2 (broker admission)"],
    )


def _rule_queue_growth(inputs):
    hist = inputs.get("history")
    if not hist:
        return None
    for name in sorted(hist.get("series") or {}):
        if not name.startswith("broker.queue_depth"):
            continue
        rows = ((hist["series"][name].get("rings") or {}).get("raw")) or []
        if len(rows) < 2:
            continue
        first, last = rows[0][1], rows[-1][1]
        if first >= 0 and last > max(first, 1) * QUEUE_GROWTH_FACTOR:
            return _finding(
                "queue-depth-growing", "broker admission (backlog growing)",
                f"`{name}` grew {first} -> {last} over the history ring "
                "— admission outpaces drain; throttle producers or add "
                "consume capacity before the backlog turns into "
                "staleness",
                [f"{name}: {first} -> {last} (history rings)"],
                flags=["cli soak --broker-partitions 2 (broker admission)"],
            )
    return None


def _rule_plan_prefix(inputs):
    art = _latest(inputs, "migrate")
    if art is None:
        return None
    mig = art["data"].get("migrate") or {}
    plan = mig.get("plan_windows")
    prefix = mig.get("prefix_windows")
    if not plan or prefix is None or prefix < plan:
        return None
    new_plan = int(plan) * 2
    return _finding(
        "plan-prefix-exhausted", "batch-size planning prefix",
        f"the backfill's batch-size planner consumed its whole "
        f"{plan}-window prefix — the chosen batch size may be keyed to "
        f"an unrepresentative head; widen the prefix to {new_plan} "
        "windows",
        [f"migrate.prefix_windows={prefix} >= plan_windows={plan} "
         f"({art['path']})"],
        env={"BENCH_MIGRATE_PLAN_WINDOWS": str(new_plan)},
    )


def _rule_bandwidth_roof(inputs):
    art = _latest(inputs, "bench")
    if art is None:
        return None
    roof = art["data"].get("roofline") or {}
    frac = roof.get("frac_of_peak_bw")
    if roof.get("bound_by") != "memory" or frac is None \
            or frac < BANDWIDTH_ROOF_FRAC:
        return None
    return _finding(
        "bandwidth-roof", "HBM bandwidth (at the roof)",
        f"the dispatch achieves {round(100 * frac, 1)}% of peak "
        "bandwidth and the verdict is memory-bound — the knobs are "
        "exhausted at this table layout; further gains need fewer bytes "
        "per match (row packing / fused writeback elision), not "
        "scheduling",
        [f"roofline.frac_of_peak_bw={frac}, bound_by=memory "
         f"({art['path']})"],
    )


RULES = (
    _rule_ingest_native,
    _rule_migrate_assign,
    _rule_feed_starved,
    _rule_device_idle,
    _rule_dispatch_overhead,
    _rule_fused_not_paying,
    _rule_tier_thrash,
    _rule_queue_wait,
    _rule_queue_growth,
    _rule_plan_prefix,
    _rule_bandwidth_roof,
)


def advise(inputs: dict) -> dict:
    """The recommendation report: every firing rule, in table order.
    Pure function of its inputs — same artifacts, same bytes."""
    findings = []
    for rule in RULES:
        f = rule(inputs)
        if f is not None:
            findings.append(f)
    env_lines: dict[str, str] = {}
    flag_lines: list[str] = []
    for f in findings:
        for k in sorted(f["env"]):
            env_lines.setdefault(k, f["env"][k])
        for fl in f["flags"]:
            if fl not in flag_lines:
                flag_lines.append(fl)
    snippet = "".join(
        f"export {k}={env_lines[k]}\n" for k in sorted(env_lines)
    ) + "".join(f"# {fl}\n" for fl in flag_lines)
    prof = inputs.get("profile")
    return {
        "artifacts": [
            {"path": a["path"], "family": a["family"], "metric": a["metric"]}
            for a in inputs["artifacts"]
        ],
        "profile": None if prof is None else {
            "dir": prof.get("dir"),
            "parsed": bool(prof.get("parsed")),
            "dominant_kernel": prof.get("dominant_kernel"),
            "device_idle_frac": (prof.get("device") or {}).get("idle_frac"),
        },
        "history": bool(inputs.get("history")),
        "findings": findings,
        "bottleneck": findings[0]["bottleneck"] if findings else None,
        "snippet": snippet,
    }


def render_report(report: dict) -> str:
    """The text render (byte-identical for identical reports)."""
    out = [
        f"tuning advisor: {len(report['findings'])} finding(s) over "
        f"{len(report['artifacts'])} artifact(s)"
        + (", history rings" if report.get("history") else "")
        + (", profile capture" if report.get("profile") else "")
    ]
    for a in report["artifacts"]:
        out.append(f"  input: {a['path']} ({a['family']}: {a['metric']})")
    prof = report.get("profile")
    if prof:
        out.append(
            f"  profile: {prof['dir']} parsed={str(prof['parsed']).lower()}"
            + (f", dominant kernel {prof['dominant_kernel']}"
               if prof.get("dominant_kernel") else "")
        )
    if not report["findings"]:
        out.append("no rule fired — telemetry reads healthy at the "
                   "current knobs")
        return "\n".join(out) + "\n"
    out.append(f"bottleneck: {report['bottleneck']}")
    for i, f in enumerate(report["findings"], 1):
        out.append(f"{i}. [{f['rule']}] {f['bottleneck']}")
        out.append(f"   {f['action']}")
        for ev in f["evidence"]:
            out.append(f"   evidence: {ev}")
        for k in sorted(f["env"]):
            out.append(f"   set: {k}={f['env'][k]}")
        for fl in f["flags"]:
            out.append(f"   via: {fl}")
    if report["snippet"]:
        out.append("env/flag snippet:")
        for line in report["snippet"].rstrip("\n").split("\n"):
            out.append(f"  {line}")
    return "\n".join(out) + "\n"
