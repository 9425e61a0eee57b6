"""Flight recorder: a bounded ring of recent events, dumped on failure.

The port's own copy of ``analyzer_tpu.obs.flight``, with the same dump
layout. The snapshot artifact answers "what did the whole run look like";
the flight recorder answers "what happened in the last seconds BEFORE the
failure". It runs always-on and nearly free — log records (via a handler
on every package logger), batch notes from the worker, and arbitrary
``note()`` breadcrumbs land in one bounded deque — and on a trigger
(dead-letter, pipeline degradation, SLO burn, SIGUSR1, obsd's
``/debug/flight``) ``dump()`` freezes everything into a timestamped
artifact directory:

  ``snapshot.json``   the full metrics snapshot (counters/gauges/
                      histograms/spans) at dump time;
  ``history.json``    the telemetry history rings (obs/history.py) —
                      the trajectory INTO the incident, not just the
                      moment of it;
  ``trace.jsonl``     the span ring as Chrome trace-event JSONL
                      (Perfetto-loadable — the failure's timeline);
  ``events.log``      the recent-events ring, one JSON object per line,
                      oldest first;
  ``context.json``    reason, wall time, pid/argv, the loaded torch
                      version (where the JAX package's records jax's),
                      the owner's config (URI-shaped values redacted),
                      the device profiler's capture info, and a
                      whitelisted environment capture.

Dumps are throttled per reason (``min_interval_s``) so a dead-letter
storm produces one artifact plus suppressed-dump breadcrumbs, not a disk
full of identical directories; operator-triggered dumps (SIGUSR1) bypass
the throttle with ``force=True``.

Artifacts land under ``base_dir`` — ``ANALYZER_TPU_FLIGHT_DIR`` or the
owner's explicit configuration (``Worker(flight_dir=...)``, ``cli worker
--flight-dir``). With NO directory configured the ring still records but
``dump()`` is a breadcrumbed no-op: library code must never scatter
artifact directories into an unsuspecting cwd.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque

from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs.registry import get_registry
from analyzer_tpu_torch.obs.snapshot import write_chrome_trace, write_snapshot

logger = get_logger(__name__)

ENV_DIR = "ANALYZER_TPU_FLIGHT_DIR"

#: Environment prefixes worth capturing in context.json — the knobs that
#: change behavior, not the whole environment (which carries secrets).
_ENV_PREFIXES = (
    "ANALYZER_TPU_", "TORCH_", "PYTORCH_", "CUDA_", "BENCH_", "PIPELINE",
    "BATCHSIZE", "CHUNKSIZE", "QUEUE", "IDLE_TIMEOUT", "TAU",
    "UNKNOWN_PLAYER_SIGMA", "DOCRUNCH", "DOSEW", "DOTELESUCK",
)
_REDACT_MARKERS = ("uri", "password", "secret", "token", "key")


def _redact(mapping: dict) -> dict:
    """URI/credential-shaped values never reach an artifact a human will
    paste into a ticket."""
    out = {}
    for k, v in mapping.items():
        if any(m in k.lower() for m in _REDACT_MARKERS) and v:
            out[k] = "<redacted>"
        else:
            out[k] = v
    return out


class _LogCapture(logging.Handler):
    """Mirrors package log records into the recorder's ring. Emission
    must never raise into the logging call site."""

    def __init__(self, recorder: "FlightRecorder") -> None:
        super().__init__(level=logging.INFO)
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._recorder.note(
                "log",
                level=record.levelname,
                logger=record.name,
                msg=record.getMessage(),
            )
        except Exception:  # noqa: BLE001 — a telemetry sink must stay silent
            pass


class FlightRecorder:
    def __init__(
        self,
        base_dir: str | None = None,
        max_events: int = 2000,
        min_interval_s: float = 30.0,
        clock=time.monotonic,
    ) -> None:
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=max_events)
        self.base_dir = base_dir or os.environ.get(ENV_DIR) or None
        self.min_interval_s = min_interval_s
        self._clock = clock
        # Throttle keyed PER REASON: a dead-letter storm's dump must not
        # suppress a later degradation dump (distinct failure, distinct
        # artifact) — one shared timestamp did exactly that.
        self._last_dump_at: dict[str, float] = {}
        self.dumps = 0
        self._handler: _LogCapture | None = None

    def configure(
        self,
        base_dir: str | None = None,
        min_interval_s: float | None = None,
    ) -> "FlightRecorder":
        """Late configuration of the process-wide recorder (the worker
        owns the directory decision, not import order)."""
        if base_dir is not None:
            self.base_dir = base_dir
        if min_interval_s is not None:
            self.min_interval_s = min_interval_s
        return self

    # -- the ring ---------------------------------------------------------
    def note(self, kind: str, **fields) -> None:
        """One breadcrumb: JSON-scalar fields only (they are serialized
        verbatim into events.log)."""
        event = {"ts": round(time.time(), 3), "kind": kind, **fields}
        with self._lock:
            self._events.append(event)

    def note_batch(self, n_ids: int, matches: int, first_id=None) -> None:
        """The worker's per-batch breadcrumb — the last-N batch sizes and
        a representative id are exactly what a dead-letter page needs."""
        self.note("batch", n_ids=n_ids, matches=matches, first_id=first_id)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    # -- log capture ------------------------------------------------------
    def capture_logs(self) -> None:
        """Attaches the ring to every package logger, present and future
        (idempotent). Package loggers do not propagate, so this goes
        through ``logging_utils.add_shared_handler`` rather than a
        root-level handler that would capture nothing."""
        if self._handler is not None:
            return
        from analyzer_tpu_torch.logging_utils import add_shared_handler

        self._handler = _LogCapture(self)
        add_shared_handler(self._handler)

    def release_logs(self) -> None:
        if self._handler is not None:
            from analyzer_tpu_torch.logging_utils import remove_shared_handler

            remove_shared_handler(self._handler)
        self._handler = None

    # -- the dump ---------------------------------------------------------
    def dump(
        self,
        reason: str,
        config: dict | None = None,
        force: bool = False,
        profile: dict | None = None,
    ) -> str | None:
        """Freezes the current telemetry + ring into an artifact
        directory; returns its path. Returns None (with a breadcrumb)
        when no base_dir is configured or a non-forced dump lands inside
        the throttle window — the window is PER REASON, so a dead-letter
        storm's artifact cannot suppress a later degradation dump.
        ``profile`` (the device profiler's capture info,
        ``obs/prof.py``) rides into context.json so the artifact names
        the torch.profiler capture directory that goes with it. Never
        raises — the callers are failure paths that must finish their
        actual job (dead-lettering, degradation bookkeeping) no matter
        what the disk does."""
        if self.base_dir is None:
            self.note("dump.skipped", reason=reason, why="no base_dir")
            return None
        now = self._clock()
        with self._lock:
            last = self._last_dump_at.get(reason)
            if (
                not force
                and last is not None
                and now - last < self.min_interval_s
            ):
                throttled = True
            else:
                throttled = False
                self._last_dump_at[reason] = now
        if throttled:
            self.note("dump.suppressed", reason=reason)
            return None
        try:
            return self._write(reason, config, profile)
        except Exception as err:  # noqa: BLE001 — failure paths come first
            self.note("dump.failed", reason=reason, error=repr(err))
            logger.exception("flight-recorder dump failed (%s)", reason)
            return None

    def _write(
        self, reason: str, config: dict | None, profile: dict | None = None
    ) -> str:
        stamp = time.strftime("%Y%m%d-%H%M%S")
        safe_reason = "".join(
            c if c.isalnum() or c in "-_" else "_" for c in reason
        )
        base = os.path.join(
            self.base_dir, f"flight-{stamp}-{safe_reason}-{os.getpid()}"
        )
        path = base
        n = 1
        while os.path.exists(path):  # two dumps in one second
            path = f"{base}.{n}"
            n += 1
        os.makedirs(path)
        write_snapshot(os.path.join(path, "snapshot.json"))
        write_chrome_trace(os.path.join(path, "trace.jsonl"))
        # The trajectory INTO the incident (obs/history.py): the
        # snapshot above is the moment, history.json is how the process
        # got there — the first thing a paged operator should plot.
        from analyzer_tpu_torch.obs.history import get_history

        with open(
            os.path.join(path, "history.json"), "w", encoding="utf-8"
        ) as f:
            json.dump(get_history().to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        with open(
            os.path.join(path, "events.log"), "w", encoding="utf-8"
        ) as f:
            for event in self.events():
                f.write(json.dumps(event) + "\n")
        context = {
            "reason": reason,
            "ts_wall": time.time(),
            "pid": os.getpid(),
            "argv": sys.argv,
            "python": sys.version.split()[0],
            "torch": getattr(sys.modules.get("torch"), "__version__", None),
            "config": _redact(config) if config else None,
            # Device-time attribution: where the torch.profiler capture
            # that pairs with this dump lives (None when no profiler is
            # armed — obs/prof.py).
            "profile": profile,
            "env": _redact({
                k: v for k, v in os.environ.items()
                if k.startswith(_ENV_PREFIXES)
            }),
        }
        with open(
            os.path.join(path, "context.json"), "w", encoding="utf-8"
        ) as f:
            json.dump(context, f, indent=1, sort_keys=True)
            f.write("\n")
        self.dumps += 1
        get_registry().counter("obs.flight_dumps_total").add(1)
        self.note("dump", reason=reason, path=path)
        logger.warning("flight recorder dumped to %s (%s)", path, reason)
        return path


_recorder_lock = threading.Lock()
_recorder: FlightRecorder | None = None


def get_flight_recorder() -> FlightRecorder:
    """The process-wide recorder (created on first use, log capture
    armed)."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
            _recorder.capture_logs()
        return _recorder


def reset_flight_recorder(**kwargs) -> FlightRecorder:
    """Replaces the process-wide recorder with a fresh one (tests)."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None:
            _recorder.release_logs()
        _recorder = FlightRecorder(**kwargs)
        _recorder.capture_logs()
        return _recorder
