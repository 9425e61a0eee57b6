"""Snapshot exposition: one JSON artifact, Prometheus text, summaries.

The port's own copy of ``analyzer_tpu.obs.snapshot``, with the same
:data:`SNAPSHOT_VERSION` and keys. The snapshot is the ``--metrics-out``
contract: everything the process measured — counter/gauge values,
histogram quantile summaries, and the tracer's span ring — in one JSON
object a bench artifact can embed and ``cli metrics`` can re-render.

The ``retraces`` block stays in the schema and is always empty here: the
JAX package counts a jitted entry point's compiled variants there
(``obs.retrace``), and nothing in the port is jitted — every device
function is eager PyTorch or a kernel built once — so there is nothing to
count and no counterpart module.

Prometheus text exposition follows the text format conventions (names
sanitized to ``[a-zA-Z0-9_:]``, histograms as summaries with quantile
labels) so a node exporter textfile collector or a debug scrape can lift
the same numbers without the JSON shape.
"""

from __future__ import annotations

import json
import re
import time

from analyzer_tpu_torch.obs.registry import MetricsRegistry, get_registry
from analyzer_tpu_torch.obs.tracer import Tracer, get_tracer

SNAPSHOT_VERSION = 1

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
# DOTALL: a label value carrying a newline (an exception string) must
# still parse as a label body, then escape as \n in the exposition.
_SERIES_RE = re.compile(r"^(?P<name>[^{]+)(\{(?P<labels>.*)\})?$", re.DOTALL)


def snapshot(
    registry: MetricsRegistry | None = None,
    tracer: Tracer | None = None,
    max_spans: int | None = None,
) -> dict:
    """The full JSON-ready telemetry snapshot of this process."""
    registry = registry or get_registry()
    tracer = tracer or get_tracer()
    spans = tracer.events()
    if max_spans is not None and len(spans) > max_spans:
        spans = spans[-max_spans:]
    return {
        "version": SNAPSHOT_VERSION,
        "ts": time.time(),
        "trace_epoch_wall": tracer.epoch_wall,
        **registry.snapshot(),
        "retraces": {},  # nothing is jitted (module docstring)
        "spans": spans,
        "spans_dropped": tracer.dropped,
    }


def write_snapshot(path: str, **kwargs) -> dict:
    """Writes :func:`snapshot` as JSON; returns the snapshot."""
    snap = snapshot(**kwargs)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(snap, f, indent=1, sort_keys=True)
        f.write("\n")
    return snap


def write_chrome_trace(path: str, tracer: Tracer | None = None) -> int:
    """Exports the span ring as Chrome trace-event JSONL (Perfetto-
    loadable); returns the event count."""
    return (tracer or get_tracer()).export_chrome(path)


def escape_label_value(value: str) -> str:
    """Prometheus text-format label escaping: backslash, double quote and
    newline must be escaped or the scrape line is corrupt (a player id or
    an exception string with a quote in it would break the whole page)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _split_series(key: str) -> tuple[str, str]:
    """``name{a=b,c=d}`` -> (sanitized_name, prometheus label body)."""
    m = _SERIES_RE.match(key)
    name = _NAME_RE.sub("_", (m.group("name") if m else key))
    labels = (m.group("labels") if m else None) or ""
    if labels:
        parts = []
        for pair in labels.split(","):
            k, _, v = pair.partition("=")
            parts.append(f'{_NAME_RE.sub("_", k)}="{escape_label_value(v)}"')
        labels = ",".join(parts)
    return name, labels


def _coerce(value) -> float | None:
    if value is None:
        return None
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    return float(value)


def prometheus_text(snap: dict | None = None) -> str:
    """Prometheus text-format exposition of a snapshot (or of the live
    process when ``snap`` is None). Every family leads with its
    ``# HELP`` / ``# TYPE`` pair — HELP text from the STANDARD schema
    catalog (``obs.registry.SCHEMA_HELP``), TYPE from the bucket the
    series lives in (counters as ``counter``, gauges as ``gauge``,
    histograms as ``summary``). Retrace counts (present only in a JAX
    package's snapshot) surface as
    ``jax_jit_cache_size{entrypoint="..."}``. :func:`parse_prometheus_text`
    round-trips this output."""
    from analyzer_tpu_torch.obs.registry import schema_help

    snap = snap if snap is not None else snapshot(max_spans=0)
    lines: list[str] = []
    typed: set[str] = set()

    def declare(name: str, family: str, mtype: str) -> None:
        if name in typed:
            return
        typed.add(name)
        text = schema_help(family).replace("\\", "\\\\").replace("\n", "\\n")
        lines.append(f"# HELP {name} {text}")
        lines.append(f"# TYPE {name} {mtype}")

    def emit(key: str, value, mtype: str, extra_labels: str = "") -> None:
        v = _coerce(value)
        if v is None:
            return
        name, labels = _split_series(key)
        declare(name, key.split("{", 1)[0], mtype)
        body = ",".join(x for x in (labels, extra_labels) if x)
        series = f"{name}{{{body}}}" if body else name
        lines.append(f"{series} {v:g}")

    for key, value in snap.get("counters", {}).items():
        emit(key, value, "counter")
    for key, value in snap.get("gauges", {}).items():
        emit(key, value, "gauge")
    for key, summ in snap.get("histograms", {}).items():
        name, labels = _split_series(key)
        declare(name, key.split("{", 1)[0], "summary")
        prefix = f"{{{labels}," if labels else "{"
        for q in ("p50", "p90", "p99"):
            if summ.get(q) is not None:
                lines.append(
                    f'{name}{prefix}quantile="0.{q[1:]}"}} {summ[q]:g}'
                )
        body = f"{{{labels}}}" if labels else ""
        lines.append(f"{name}_sum{body} {summ['sum']:g}")
        lines.append(f"{name}_count{body} {summ['count']:g}")
    for entry, count in snap.get("retraces", {}).items():
        emit(
            "jax.jit_cache_size", count, "gauge",
            extra_labels=f'entrypoint="{escape_label_value(entry)}"',
        )
    return "\n".join(lines) + "\n"


_LABEL_RE = re.compile(r'([a-zA-Z0-9_]+)="((?:\\.|[^"\\])*)"')
_PROM_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(\{(?P<labels>.*)\})?\s+(?P<value>\S+)$"
)
_QUANTILE_OF = {"0.5": "p50", "0.50": "p50", "0.9": "p90", "0.90": "p90",
                "0.99": "p99"}


def _unescape_label_value(value: str) -> str:
    return (
        value.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
    )


def _unsanitize_map() -> dict[str, str]:
    """sanitized exposition name -> the registry's dotted family name,
    built from the STANDARD schema catalog (the exposition's name
    sanitization is lossy — ``worker.acks_total`` and a hypothetical
    ``worker_acks_total`` collide — so the catalog is the only way
    back)."""
    from analyzer_tpu_torch.obs.registry import (
        SCHEMA_HELP,
        STANDARD_COUNTERS,
        STANDARD_GAUGES,
        STANDARD_HISTOGRAMS,
    )

    out: dict[str, str] = {}
    for name in (
        *STANDARD_COUNTERS, *STANDARD_GAUGES, *STANDARD_HISTOGRAMS,
        *SCHEMA_HELP,
    ):
        out[_NAME_RE.sub("_", name)] = name
    return out


def parse_prometheus_text(text: str) -> dict:
    """Parses a :func:`prometheus_text` exposition back into the
    snapshot shape: ``counters``/``gauges`` as ``{series_key: value}``,
    ``histograms`` as ``{series_key: {p50/p90/p99/sum/count}}``, plus
    the scraped ``help`` and ``types`` per family. Series keys are the
    registry's ``name{label=value,...}`` format with dotted names
    recovered through the STANDARD schema catalog — the exposition/
    parse pair round-trips every cataloged series (pinned by
    tests/test_obs.py). Unknown families keep their sanitized names and
    parse by their ``# TYPE`` line; lines with neither are skipped."""
    unsanitize = _unsanitize_map()
    out = {
        "counters": {}, "gauges": {}, "histograms": {},
        "help": {}, "types": {},
    }

    def family(name: str) -> str:
        return unsanitize.get(name, name)

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            kind, rest = line[2:6], line[7:]
            name, _, body = rest.partition(" ")
            if kind == "HELP":
                out["help"][family(name)] = (
                    body.replace("\\n", "\n").replace("\\\\", "\\")
                )
            else:
                out["types"][family(name)] = body.strip()
            continue
        if line.startswith("#"):
            continue
        m = _PROM_LINE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name = m.group("name")
        value = float(m.group("value"))
        labels = {
            k: _unescape_label_value(v)
            for k, v in _LABEL_RE.findall(m.group("labels") or "")
        }
        quantile = labels.pop("quantile", None)
        hist_field = None
        base = name
        if quantile is not None:
            hist_field = _QUANTILE_OF.get(quantile)
        elif name.endswith("_sum") and out["types"].get(
            family(name[:-4])
        ) == "summary":
            base, hist_field = name[:-4], "sum"
        elif name.endswith("_count") and out["types"].get(
            family(name[:-6])
        ) == "summary":
            base, hist_field = name[:-6], "count"
        fam = family(base)
        inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
        key = f"{fam}{{{inner}}}" if inner else fam
        if hist_field is not None:
            entry = out["histograms"].setdefault(key, {})
            entry[hist_field] = int(value) if hist_field == "count" else value
            continue
        mtype = out["types"].get(fam, "gauge")
        bucket = "counters" if mtype == "counter" else "gauges"
        out[bucket][key] = value
    return out


def render_summary(snap: dict) -> str:
    """A short human-facing digest of a snapshot (``cli metrics``):
    non-zero counters, set gauges, histogram p50/p99, retraces, span
    count."""
    out: list[str] = []
    counters = {
        k: v for k, v in snap.get("counters", {}).items() if v
    }
    if counters:
        out.append("counters:")
        out.extend(f"  {k} = {v:g}" for k, v in counters.items())
    gauges = {
        k: v for k, v in snap.get("gauges", {}).items() if v not in (None, 0)
    }
    if gauges:
        out.append("gauges:")
        out.extend(f"  {k} = {v}" for k, v in gauges.items())
    hists = {
        k: s for k, s in snap.get("histograms", {}).items() if s.get("count")
    }
    if hists:
        out.append("histograms:")
        for k, s in hists.items():
            out.append(
                f"  {k}: n={s['count']} mean={s['mean']:.6g}"
                f" p50={s['p50']:.6g} p99={s['p99']:.6g} max={s['max']:.6g}"
            )
    retraces = snap.get("retraces", {})
    if retraces:
        out.append("jit cache sizes (compiled variants per entrypoint):")
        out.extend(f"  {k} = {v}" for k, v in sorted(retraces.items()))
    spans = snap.get("spans", [])
    out.append(
        f"spans: {len(spans)} buffered"
        + (f" ({snap['spans_dropped']} dropped)" if snap.get("spans_dropped")
           else "")
    )
    return "\n".join(out) + "\n"
