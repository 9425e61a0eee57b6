"""Per-window residency planning for the fused rating window.

Counterpart of ``analyzer_tpu.sched.residency``; for the same window the
plans are exactly equal. The fused window (:mod:`analyzer_tpu_torch.core.
fused`) keeps every player row that a window of supersteps touches in a
working set — gathered from the table once, written back once. The device
needs the rows to gather (``slot_rows``), the per-step batches re-addressed
in working-set slots (``slot_idx``), and a working set within budget; the
host knows all three, so the plan is made on the feed thread and shipped
with the slab.

  * Slots are assigned in FIRST-TOUCH order with slot 0 always the padding
    row: the kernel derives the slot mask as ``slot_idx != 0`` and leaves
    slot 0 pristine.
  * The slot count is bucketed to the next power of two (unused slots hold
    the padding row, gather it and write back the same pristine bits).
  * When a window's working set would exceed ``max_rows``, the window is
    CUT at the last step that fits and the rest becomes its own window(s)
    (a spill); the runner pads short windows with inert steps.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

#: Supersteps per fused window.
DEFAULT_WINDOW = 16

#: Working-set budget in table rows, a power of two. On an H100 the
#: working set lives in a global-memory buffer: 32768 rows x 64 B = 2 MiB,
#: which stays resident in the card's 50 MB L2 across the window's steps.
DEFAULT_MAX_ROWS = 32768

#: Env override for the fused backend: "torch" (the plain PyTorch window,
#: CPU tensors only) or "cuda" (the hand-written kernel). Unset, the
#: backend follows the table's device.
BACKEND_ENV = "ANALYZER_TPU_TORCH_FUSE_BACKEND"

BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class FuseSpec:
    """Resolved fused-window parameters, threaded through the runner.
    ``backend`` None means "follow the table's device"."""

    window: int = DEFAULT_WINDOW
    max_rows: int = DEFAULT_MAX_ROWS
    backend: str | None = None


def resolve_fuse(
    kernel: str,
    fuse_window: int | None = None,
    fuse_max_rows: int | None = None,
    fuse_backend: str | None = None,
) -> FuseSpec | None:
    """``kernel`` ("reference" | "fused") + optional overrides -> a
    :class:`FuseSpec`, or None for the reference path."""
    if kernel == "reference":
        return None
    if kernel != "fused":
        raise ValueError(
            f"unknown kernel {kernel!r}; use 'reference' or 'fused'"
        )
    backend = fuse_backend or os.environ.get(BACKEND_ENV) or None
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown fused backend {backend!r}; use {BACKENDS}")
    window = DEFAULT_WINDOW if fuse_window is None else fuse_window
    if window < 1:
        raise ValueError(f"fuse window must be >= 1, got {window}")
    max_rows = _pow2(
        DEFAULT_MAX_ROWS if fuse_max_rows is None else fuse_max_rows
    )
    return FuseSpec(window=window, max_rows=max_rows, backend=backend)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


@dataclasses.dataclass
class ResidencyPlan:
    """One fused window's row -> slot map.

    slot_rows [n_slots] int32: player row per slot; slot 0 and the unused
      bucket-padding slots hold the padding row.
    slot_idx  [n_steps, B, 2, T] int32: the window's batches in slots (real
      steps only; the feed pads to the static window).
    first_use/last_use [n_live] int32: each live slot's range of steps.
    n_live: live slots including slot 0 (the budgeted working-set size).
    writebacks_avoided: per-step scatter row-instances the window saves
      (written slots minus unique written rows).
    spilled: True when the budget cut this window short.
    """

    slot_rows: np.ndarray
    slot_idx: np.ndarray
    first_use: np.ndarray
    last_use: np.ndarray
    n_live: int
    writebacks_avoided: int
    spilled: bool

    @property
    def n_steps(self) -> int:
        return self.slot_idx.shape[0]


def plan_windows(
    player_idx: np.ndarray,
    valid: np.ndarray,
    pad_row: int,
    window: int,
    max_rows: int,
) -> list[ResidencyPlan]:
    """Splits a chunk's ``[S, B, 2, T]`` gather window into fused windows
    of at most ``window`` supersteps whose working set fits ``max_rows``
    slots. ``valid`` (``slot_mask & ratable``) feeds only the
    writebacks-avoided count: residency covers EVERY touched row, since
    non-ratable matches still gather. Each cut lands exactly on the last
    step that fits (prefix sizes come from first-touch steps)."""
    if max_rows != _pow2(max_rows):
        raise ValueError(f"max_rows must be a power of two, got {max_rows}")
    s_total = player_idx.shape[0]
    per_step = int(np.prod(player_idx.shape[1:]))
    plans: list[ResidencyPlan] = []
    s0 = 0
    while s0 < s_total:
        s1 = min(s0 + window, s_total)
        sub = player_idx[s0:s1]
        # Working-set size of every prefix: a row first touched at step f
        # is resident in any prefix reaching f.
        flat = np.concatenate(
            [np.full(1, pad_row, player_idx.dtype), sub.ravel()]
        )
        u, first = np.unique(flat, return_index=True)
        first_step = np.maximum(first - 1, 0) // per_step
        cum = np.cumsum(np.bincount(first_step, minlength=s1 - s0))
        fits = int(np.searchsorted(cum, max_rows, side="right"))
        if fits == 0:
            raise ValueError(
                f"one superstep touches {int(cum[0])} rows but the fused "
                f"working-set budget is {max_rows}; raise fuse_max_rows "
                "or shrink the batch size"
            )
        spilled = fits < (s1 - s0)
        if spilled:
            s1 = s0 + fits
            sub = player_idx[s0:s1]
        plans.append(_build_plan(sub, valid[s0:s1], pad_row, spilled))
        s0 = s1
    return plans


def _build_plan(
    sub: np.ndarray, valid: np.ndarray, pad_row: int, spilled: bool
) -> ResidencyPlan:
    per_step = int(np.prod(sub.shape[1:]))
    flat = np.concatenate([np.full(1, pad_row, sub.dtype), sub.ravel()])
    u, first, inv = np.unique(flat, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")  # first-touch order
    rank = np.empty(u.size, np.int64)
    rank[order] = np.arange(u.size)
    slots_all = rank[inv]
    # The virtual element at flat[0] makes the padding row's first touch
    # position 0 unconditionally -> slot 0 (core.fused.PAD_SLOT).
    slot_idx = slots_all[1:].reshape(sub.shape).astype(np.int32)
    n_live = int(u.size)
    n_slots = _pow2(max(n_live, 8))
    slot_rows = np.full(n_slots, pad_row, np.int32)
    slot_rows[rank] = u
    first_use = np.empty(n_live, np.int32)
    first_use[rank] = (np.maximum(first - 1, 0) // per_step).astype(np.int32)
    last_pos = np.zeros(n_live, np.int64)
    np.maximum.at(last_pos, slots_all[1:], np.arange(sub.size))
    last_use = (last_pos // per_step).astype(np.int32)
    written = sub[valid]
    writebacks_avoided = int(written.size - np.unique(written).size)
    return ResidencyPlan(
        slot_rows=slot_rows,
        slot_idx=slot_idx,
        first_use=first_use,
        last_use=last_use,
        n_live=n_live,
        writebacks_avoided=writebacks_avoided,
        spilled=spilled,
    )


def check_plan(
    plan: ResidencyPlan, player_idx: np.ndarray, pad_row: int
) -> None:
    """Validates an UNTRUSTED residency plan against its window: no two
    live rows share a slot, slot 0 is the padding row, and the slot map
    reproduces the window's player rows. Raises ValueError."""
    live = plan.slot_rows[: plan.n_live]
    uniq, counts = np.unique(live, return_counts=True)
    dup = uniq[counts > 1]
    if dup.size:
        raise ValueError(
            f"residency plan aliases player rows {dup[:16].tolist()} onto "
            "shared working-set slots: two live rows per slot means the "
            "fused chain rates one player with another's posterior"
        )
    if plan.slot_rows[0] != pad_row:
        raise ValueError(
            f"residency plan slot 0 holds row {int(plan.slot_rows[0])}, "
            f"not the padding row {pad_row}; the kernel routes every "
            "masked slot to slot 0 and would corrupt that player"
        )
    n_steps = plan.n_steps
    if player_idx.shape[0] < n_steps:
        raise ValueError(
            f"residency plan covers {n_steps} steps but the window has "
            f"{player_idx.shape[0]}"
        )
    recon = plan.slot_rows[plan.slot_idx]
    # graftlint: disable=GL025 — untrusted-entry validation syncs on purpose
    want = np.asarray(player_idx[:n_steps])
    if not np.array_equal(recon, want):
        bad = np.argwhere(recon != want)[:4]
        raise ValueError(
            "residency plan slot map disagrees with the window's player "
            f"rows at (step, slot) {bad.tolist()}; the fused gather would "
            "read the wrong players"
        )


def rate_window_checked(
    state,
    player_idx: np.ndarray,
    winner: np.ndarray,
    mode_id: np.ndarray,
    afk: np.ndarray,
    cfg,
    plan: ResidencyPlan | None = None,
    collect: bool = False,
    backend: str | None = None,
):
    """Entry point for UNTRUSTED fused windows: the window-level race
    detector and the plan check run before the window commits K steps at
    once. ``plan=None`` plans afresh. Returns (new state, ys | None)."""
    from analyzer_tpu_torch.core.fused import fused_apply_window
    from analyzer_tpu_torch.core.update import check_window_conflict_free

    player_idx = np.ascontiguousarray(player_idx, np.int32)
    # graftlint: disable=GL025 — untrusted-entry validation syncs on purpose
    ratable = (np.asarray(mode_id) >= 0) & ~np.asarray(afk)
    pad_row = state.pad_row
    check_window_conflict_free(player_idx, ratable, pad_row=pad_row)
    if plan is None:
        valid = (player_idx != pad_row) & ratable[:, :, None, None]
        plans = plan_windows(
            player_idx, valid, pad_row,
            window=player_idx.shape[0], max_rows=DEFAULT_MAX_ROWS,
        )
        if len(plans) != 1:
            raise ValueError("window exceeds the default residency budget")
        plan = plans[0]
    check_plan(plan, player_idx, pad_row)
    return fused_apply_window(
        state, plan.slot_rows, plan.slot_idx, winner, mode_id, afk,
        cfg, collect=collect, backend=backend,
    )


def window_reuse_stats(rows: np.ndarray) -> tuple[int, int]:
    """(unique_rows, row_instances) over a window's written-row list — the
    residency reuse measure. Shared with the sharded mesh feed
    (:mod:`analyzer_tpu_torch.parallel.mesh`), which applies it to its
    compacted row lists to report how much a per-shard fused window would
    save (``mesh.writebacks_avoidable_total``)."""
    # graftlint: disable=GL025 — host row lists only (mesh routing input)
    rows = np.asarray(rows).ravel()
    return int(np.unique(rows).size), int(rows.size)
