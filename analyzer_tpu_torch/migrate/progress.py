"""Migration progress: the /statusz surface of a running backfill.

The port's copy of ``analyzer_tpu.migrate.progress``, unchanged in its
fields, phases and gauges.

One process-wide :class:`MigrationProgress` (``get_migration_progress``)
is updated by the engine at window boundaries and read by
``Worker.stats()`` — so ``/statusz`` on a live worker shows the
migration's phase, lineage versions, watermark, progress % and an ETA
while the backfill runs. The ETA is derived from the HISTORY RINGS'
backfill rate (``obs/history.py``: ``window_delta`` over ``migrate.steps_total``), not
from a start-to-now average — a migration throttled by the admission
controller mid-run reports the rate it is actually sustaining now.

Writers are the engine's consumer thread; readers are the stats path.
Every field write is a single reference/int store under the GIL and the
snapshot tolerates torn field SETS (it is an operator surface, not a
correctness input), so no lock is needed on the hot path.
"""

from __future__ import annotations

import threading

from analyzer_tpu_torch.obs import get_registry

#: History-ring window the ETA's backfill rate is measured over (s of
#: the worker's clock — virtual under the soak).
ETA_RATE_WINDOW_S = 60.0


class MigrationProgress:
    """Mutable progress record for (at most) one in-flight migration per
    process. ``phase`` walks idle -> decoding -> rating -> publishing ->
    cutover -> done (or failed); a new ``begin`` resets everything."""

    def __init__(self) -> None:
        self.phase = "idle"
        self.matches_decoded = 0
        self.matches_assigned = 0
        self.steps_emitted = 0
        self.steps_total: int | None = None
        self.matches_rated = 0
        self.resumed_from = 0
        self.lineage_live_version: int | None = None
        self.lineage_staging_version: int | None = None
        self.cutover_pause_ms: float | None = None
        self.assign_native: bool | None = None
        self.error: str | None = None

    # -- engine-side updates ----------------------------------------------
    def begin(self, resumed_from: int = 0) -> None:
        self.__init__()
        self.phase = "decoding"
        self.resumed_from = int(resumed_from)
        reg = get_registry()
        reg.gauge("migrate.active").set(True)
        reg.gauge("migrate.watermark_steps").set(resumed_from)
        reg.gauge("migrate.total_steps").set(0)
        if resumed_from:
            reg.counter("migrate.resumes_total").add(1)

    def note_decoded(self, n_matches: int) -> None:
        self.matches_decoded = int(n_matches)

    def note_assigned(self, n_matches: int) -> None:
        self.matches_assigned = int(n_matches)

    def note_assign_backend(self, native: bool) -> None:
        """Which first-fit route the front half took (True = the
        GIL-released native windowed loop, False = the python
        recurrence) — the /statusz mirror of ``migrate.assign_native``."""
        self.assign_native = bool(native)

    def note_dispatched(self, next_step: int, matches: int) -> None:
        self.phase = "rating"
        self.steps_emitted = int(next_step)
        self.matches_rated += int(matches)
        get_registry().gauge("migrate.watermark_steps").set(next_step)

    def set_total_steps(self, total: int) -> None:
        self.steps_total = int(total)
        get_registry().gauge("migrate.total_steps").set(total)

    def set_lineages(self, live, staging) -> None:
        self.lineage_live_version = live
        self.lineage_staging_version = staging

    def note_publishing(self) -> None:
        self.phase = "publishing"

    def note_cutover(self, pause_ms: float) -> None:
        self.phase = "cutover"
        self.cutover_pause_ms = round(float(pause_ms), 3)

    def finish(self) -> None:
        self.phase = "done"
        get_registry().gauge("migrate.active").set(False)

    def fail(self, error: str) -> None:
        self.phase = "failed"
        self.error = str(error)
        get_registry().gauge("migrate.active").set(False)

    # -- stats-side read --------------------------------------------------
    def snapshot(self, history=None, now: float | None = None) -> dict | None:
        """JSON-ready progress block (``Worker.stats()['migration']``),
        or None when no migration has run in this process. ``history``
        + ``now`` (the worker's clock) enable the ring-derived ETA."""
        if self.phase == "idle":
            return None
        total = self.steps_total
        emitted = self.steps_emitted
        pct = (
            round(100.0 * emitted / total, 2) if total else None
        )
        eta_s = None
        rate = None
        if history is not None and now is not None and total:
            got = history.window_delta(
                "migrate.steps_total", ETA_RATE_WINDOW_S, now
            )
            if got is not None:
                delta, span = got
                rate = delta / span if span > 0 else 0.0
                if rate > 0:
                    eta_s = round(max(0, total - emitted) / rate, 1)
        return {
            "phase": self.phase,
            "matches_decoded": self.matches_decoded,
            "matches_assigned": self.matches_assigned,
            "assign_native": self.assign_native,
            "matches_rated": self.matches_rated,
            "backfill_watermark_steps": emitted,
            "steps_total": total,
            "progress_pct": pct,
            "resumed_from_step": self.resumed_from,
            "backfill_steps_per_sec": round(rate, 3) if rate else None,
            "eta_s": eta_s,
            "lineage_live_version": self.lineage_live_version,
            "lineage_staging_version": self.lineage_staging_version,
            "cutover_pause_ms": self.cutover_pause_ms,
            "error": self.error,
        }


_progress_lock = threading.Lock()
_progress: MigrationProgress | None = None


def get_migration_progress() -> MigrationProgress:
    """The process-wide migration progress record (created on first use;
    the engine writes it, ``Worker.stats()`` / /statusz read it)."""
    global _progress
    with _progress_lock:
        if _progress is None:
            _progress = MigrationProgress()
        return _progress


def reset_migration_progress() -> MigrationProgress:
    """Replaces the process-wide record with a fresh one (tests)."""
    global _progress
    with _progress_lock:
        _progress = MigrationProgress()
        return _progress
