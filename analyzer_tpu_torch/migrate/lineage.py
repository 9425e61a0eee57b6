"""Dual-lineage serve protocol: a staging lineage and the atomic cutover.

A migration publishes its in-progress table where it can be watched
WITHOUT displacing the views live traffic is served from: a second,
independent view lineage. :meth:`LineageManager.begin` creates a staging
publisher of the live plane's topology (and device); the backfill
publishes throttled snapshots into it like any re-rate (its own version
sequence); :func:`cutover` swaps the migrated table in as the LIVE
lineage's next version in one atomic reference assignment
(``ViewPublisher.cutover_from`` / ``ShardedViewPublisher.cutover_from``).
Readers see a monotone version sequence, never a torn or missing view, and
the staging lineage's device table is adopted by reference (no copy at the
cutover; the pause is the lock plus the new version object, measured as
``cutover_pause_ms``).

Backfill code publishes only into staging lineages and reaches a live
lineage only through :func:`cutover`.

The port's copy of ``analyzer_tpu.migrate.lineage``.
"""

from __future__ import annotations

import time

from analyzer_tpu_torch.migrate.progress import get_migration_progress
from analyzer_tpu_torch.obs import get_registry, get_tracer


def _make_staging(live):
    """A fresh publisher of ``live``'s topology, throttle and device — the
    default staging factory."""
    from analyzer_tpu_torch.serve import ShardedViewPublisher, ViewPublisher

    if isinstance(live, ShardedViewPublisher):
        return ShardedViewPublisher(
            live.n_shards,
            min_publish_interval_s=live.min_publish_interval_s,
            devices=live._devices, device=live.device,
        )
    if isinstance(live, ViewPublisher):
        return ViewPublisher(
            min_publish_interval_s=live.min_publish_interval_s,
            device=live.device,
        )
    raise TypeError(
        f"no default staging factory for {type(live).__name__}; pass "
        "factory= explicitly"
    )


def cutover(live, staging):
    """THE cutover entry: swaps ``staging``'s latest published view in as
    ``live``'s next version atomically and returns ``(view, pause_s)``. The
    staging publisher is consumed (``cutover_from``); the pause is the wall
    time of the swap — the most a reader arriving mid-cutover could wait
    (readers never block on the writer lock: they serve the previous view
    until the swap). The swap runs in a ``migrate.cutover`` span."""
    with get_tracer().span("migrate.cutover", cat="migrate"):
        t0 = time.perf_counter()
        view = live.cutover_from(staging)
        pause_s = time.perf_counter() - t0
    get_registry().counter("migrate.cutovers_total").add(1)
    prog = get_migration_progress()
    prog.note_cutover(pause_s * 1e3)
    prog.set_lineages(view.version, None)
    return view, pause_s


class LineageManager:
    """Owns the live / staging lineage pair of one migration.

    ``live`` is the serving plane's publisher (a worker's
    ``view_publisher``; readers keep resolving it throughout);
    :meth:`begin` mints the staging lineage, :meth:`cutover` performs the
    atomic swap, :meth:`abort` drops the staging lineage without touching
    the live one (a failed backfill leaves serving as it was)."""

    def __init__(self, live, factory=None) -> None:
        self.live = live
        self._factory = factory or (lambda: _make_staging(live))
        self.staging = None
        self.cutover_pause_s: float | None = None
        self.cutovers = 0

    def begin(self):
        """Creates and returns the staging lineage. One migration at a time:
        a staging lineage already in flight is a caller bug."""
        if self.staging is not None:
            raise RuntimeError(
                "a staging lineage is already in flight; cut over or "
                "abort it before beginning another migration"
            )
        self.staging = self._factory()
        get_migration_progress().set_lineages(
            self.live.version, self.staging.version
        )
        return self.staging

    def begin_fabric(self, directory, host: int, clock=None):
        """The sharded-backfill seam for one fabric host: mints the staging
        lineage exactly like :meth:`begin`, then returns it WRAPPED in a
        :class:`~analyzer_tpu_torch.fabric.publish.FabricShardPublisher` —
        the host's re-rate publishes a staging lineage scoped to its OWNED
        shards (non-owned patches emptied), every staging version recorded
        in ``directory`` so the fleet can watch per-owner backfill progress
        before any cutover.

        ``self.staging`` stays the RAW publisher: :meth:`cutover` and
        :meth:`abort` operate on the lineage itself, not the ownership
        filter (``cutover_from`` consumes publisher internals the wrapper
        deliberately does not proxy)."""
        from analyzer_tpu_torch.fabric.publish import FabricShardPublisher

        return FabricShardPublisher(
            directory, host, self.begin(), clock=clock
        )

    def versions(self) -> dict:
        """Operator snapshot: the two lineages' current versions."""
        return {
            "live": self.live.version,
            "staging": (
                self.staging.version if self.staging is not None else None
            ),
        }

    def cutover(self):
        """Atomic traffic cutover; returns the new live view (see
        :func:`cutover`)."""
        if self.staging is None:
            raise RuntimeError("no staging lineage to cut over")
        view, pause_s = cutover(self.live, self.staging)
        self.cutover_pause_s = pause_s
        self.cutovers += 1
        self.staging = None
        return view

    def abort(self) -> None:
        """Drops the staging lineage (idempotent); live serving is
        untouched."""
        self.staging = None
