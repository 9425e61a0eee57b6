"""Zero-downtime global re-rate: the streaming backfill engine and the
dual-lineage serve cutover — the port's copy of ``analyzer_tpu.migrate``.

  * :mod:`~analyzer_tpu_torch.migrate.engine` — the streaming front half:
    columnar CSV decode windows (``io/ingest.py``) feed an incremental
    first-fit (:mod:`~analyzer_tpu_torch.migrate.assign`: the GIL-released
    native windowed loop by default, the python recurrence as fallback and
    oracle) on a front-half thread while the feed stages and the card
    rates — decode, assignment, host-to-device copies and the kernels
    overlap, so time to first dispatch is O(the planning prefix);
  * :mod:`~analyzer_tpu_torch.migrate.lineage` — the backfill publishes
    into a STAGING view lineage while the live lineage keeps serving, and
    :func:`~analyzer_tpu_torch.migrate.lineage.cutover` swaps the migrated
    table in as the live lineage's next version atomically;
  * :mod:`~analyzer_tpu_torch.migrate.progress` — the /statusz surface:
    watermark, progress %, and an ETA from the history rings' backfill
    rate (``Worker.stats()``'s ``migration`` block).
"""

from analyzer_tpu_torch.migrate.assign import (
    IncrementalAssigner,
    NativeIncrementalAssigner,
    PyIncrementalAssigner,
    assign_native_available,
)
from analyzer_tpu_torch.migrate.engine import (
    DEFAULT_PLAN_WINDOWS,
    MigrationReport,
    migration_fingerprint,
    rate_backfill,
    run_migration,
)
from analyzer_tpu_torch.migrate.lineage import LineageManager, cutover
from analyzer_tpu_torch.migrate.progress import (
    MigrationProgress,
    get_migration_progress,
    reset_migration_progress,
)

__all__ = [
    "DEFAULT_PLAN_WINDOWS",
    "IncrementalAssigner",
    "LineageManager",
    "MigrationProgress",
    "MigrationReport",
    "NativeIncrementalAssigner",
    "PyIncrementalAssigner",
    "assign_native_available",
    "cutover",
    "get_migration_progress",
    "migration_fingerprint",
    "rate_backfill",
    "reset_migration_progress",
    "run_migration",
]
