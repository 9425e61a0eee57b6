"""The history runner: packed supersteps rated chunk by chunk on the device.

Counterpart of ``analyzer_tpu.sched.runner.rate_history``, with the same
signature. Each chunk of ``steps_per_chunk`` supersteps is staged on a
producer thread (:mod:`analyzer_tpu_torch.sched.feed`) and dispatched by
the consumer loop below:

  * ``kernel="reference"`` — a Python loop over the chunk's steps, each
    one plain-PyTorch superstep (gather, ``rate_gathered``, the routed
    scatter with the padding row re-pinned);
  * ``kernel="fused"`` — the chunk's residency-planned windows, each one
    gather, one fused window (the hand-written CUDA kernel on the card,
    its plain version on a CPU table) and one writeback.

The table is updated IN PLACE on one copy of the caller's state, made at
entry (the JAX package donates its buffer chunk to chunk instead). Per-match
outputs, when collected, come back one chunk behind the dispatch, so the
device-to-host copy of chunk k-1 overlaps chunk k.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.fused import fused_window_table
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.core.update import check_seed_cfg, pack_outputs, rate_step_
from analyzer_tpu_torch.sched.feed import (
    DEFAULT_DEPTH,
    FeedStageError,
    Prefetcher,
    stage_chunk,
    stage_chunk_fused,
)
from analyzer_tpu_torch.sched.residency import resolve_fuse


@dataclasses.dataclass
class HistoryOutputs:
    """Per-match outputs in stream order (numpy, host-side): what the
    reference persists per match and participant (``rater.py:140-169``).
    Rows of matches that were not rated hold the gate outputs only;
    ``updated`` marks rows whose ratings were written."""

    quality: np.ndarray  # [N]
    shared_mu: np.ndarray  # [N, 2, T]
    shared_sigma: np.ndarray  # [N, 2, T]
    delta: np.ndarray  # [N, 2, T]
    mode_mu: np.ndarray  # [N, 2, T]
    mode_sigma: np.ndarray  # [N, 2, T]
    any_afk: np.ndarray  # [N]
    updated: np.ndarray  # [N]


def _reference_chunk_(table, pad_row, views, cfg, collect):
    """The reference runner's chunk, in place on ``table``: one
    plain-PyTorch superstep per step. Returns ``[S', B, 3 + 10T]`` or
    None."""
    pidx, winner, mode_id, afk = views
    ys = []
    for s in range(pidx.shape[0]):
        out = rate_step_(table, pad_row, pidx[s], winner[s], mode_id[s], afk[s], cfg)
        if collect:
            ys.append(pack_outputs(out))
    return torch.stack(ys) if collect else None


def _dispatch_fused_chunk(table, staged, views, cfg, collect, backend):
    """Every residency window of a staged chunk, in order, in place on
    ``table``. Returns the chunk's ``[n_windows * K, B, 3 + 10T]`` packed
    outputs when collecting — the reference chunk's layout plus inert
    padded steps, which ``staged.flat`` maps to -1."""
    ys_parts = []
    for parts in staged.windows:
        slot_rows, slot_idx, winner, mode_id, afk = (views[i] for i in parts)
        _, ys = fused_window_table(
            table, slot_rows, slot_idx, winner, mode_id, afk,
            cfg, collect, backend,
        )
        if collect:
            ys_parts.append(ys)
    if not collect:
        return None
    return ys_parts[0] if len(ys_parts) == 1 else torch.cat(ys_parts)


class _Fetch:
    """A chunk's collected outputs on their way to the host: on the card an
    asynchronous copy into pinned memory, awaited one chunk later."""

    def __init__(self, ys: torch.Tensor) -> None:
        self._event = None
        if ys.is_cuda:
            self.host = torch.empty(ys.shape, dtype=ys.dtype, pin_memory=True)
            self.host.copy_(ys, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self.host = ys

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self.host.numpy()


def rate_history(
    state: PlayerState,
    sched,
    cfg: RatingConfig,
    collect: bool = False,
    steps_per_chunk: int | None = None,
    start_step: int = 0,
    stop_after: int | None = None,
    on_chunk=None,
    view_publisher=None,
    prefetch_depth: int | None = None,
    kernel: str = "reference",
    fuse_window: int | None = None,
    fuse_max_rows: int | None = None,
    fuse_backend: str | None = None,
    hot_rows: int = 0,
    stats_out: dict | None = None,
) -> tuple[PlayerState, HistoryOutputs | None]:
    """Rates a packed history on the device of ``state.table``. Returns the
    final state (a new one; the caller's stays valid) and, when
    ``collect``, per-match outputs in stream order.

    ``kernel``: ``"reference"`` (plain PyTorch supersteps) or ``"fused"``
    (windows of ``fuse_window`` supersteps through the fused window;
    ``fuse_max_rows`` bounds the working set, overflow splits windows;
    ``fuse_backend`` "torch" | "cuda" | None, see
    :func:`analyzer_tpu_torch.core.fused.fused_window_table`). Chunk
    boundaries, hooks and results do not depend on the kernel's window
    size or on ``prefetch_depth`` (the feed ring's depth, default 2).

    ``start_step`` re-enters the schedule mid-way (with the state taken at
    that step); ``stop_after`` ends at the chunk boundary at or after that
    step; ``on_chunk(state, next_step)`` fires after each chunk is
    dispatched — the state's table is the live one, valid until the next
    chunk dispatches, so a hook copies what it keeps.

    ``stats_out`` (optional dict) receives the fused path's planner totals
    after the run: windows dispatched, spills, inert pad steps, scatter
    rows avoided, and the working-set high-water mark.

    ``view_publisher`` (the serve plane, ROADMAP A11) and ``hot_rows`` (the
    tiered table, ROADMAP A9) are not ported yet and raise
    NotImplementedError unless left at their defaults."""
    if view_publisher is not None:
        raise NotImplementedError(
            "view_publisher is not ported yet (ROADMAP A11, serve plane)"
        )
    if hot_rows != 0:
        raise NotImplementedError(
            "hot_rows (the tiered table) is not ported yet (ROADMAP A9)"
        )
    fuse = resolve_fuse(kernel, fuse_window, fuse_max_rows, fuse_backend)
    check_seed_cfg(state, cfg)
    n_steps = sched.n_steps if stop_after is None else min(stop_after, sched.n_steps)
    if steps_per_chunk is None:
        # About 8 chunks, so host staging overlaps the device; the floor
        # keeps per-chunk overhead amortized, the ceiling bounds the slabs.
        steps_per_chunk = min(8192, max(256, -(-sched.n_steps // 8)))
    state = state.clone()
    table = state.table
    device = table.device
    pin = device.type == "cuda"
    outs = [] if collect else None
    starts = list(range(start_step, n_steps, steps_per_chunk))

    def produce(put) -> None:
        for start in starts:
            stop = min(start + steps_per_chunk, n_steps)
            try:
                if fuse is not None:
                    item = stage_chunk_fused(
                        sched, start, stop, fuse, collect, pin
                    )
                else:
                    item = stage_chunk(sched, start, stop, pin)
            except Exception as e:
                raise FeedStageError(start, stop) from e
            put((start, stop, item))

    # Fused + collect: inert window-padding steps make the emitted ys rows
    # a superset of the schedule's, so the staged chunks carry their own
    # padded slot->match rows.
    fused_flat = [] if (fuse is not None and collect) else None
    totals = {"windows": 0, "spills": 0, "pad_steps": 0,
              "writebacks_avoided": 0, "working_set_rows": 0}
    pending = None  # chunk k-1's outputs, fetched after dispatching chunk k
    with Prefetcher(produce, depth=prefetch_depth or DEFAULT_DEPTH) as pf:
        for start, stop, staged in pf:
            if fuse is not None:
                views = staged.slab.to_device(device)
                ys = _dispatch_fused_chunk(
                    table, staged, views, cfg, collect, fuse.backend
                )
                if fused_flat is not None:
                    fused_flat.append(staged.flat)
                for key, val in staged.stats.items():
                    totals[key] = (max(totals[key], val)
                                   if key == "working_set_rows"
                                   else totals[key] + val)
            else:
                views = staged.to_device(device)
                ys = _reference_chunk_(table, sched.pad_row, views, cfg, collect)
            del views, staged
            if collect:
                fetch = _Fetch(ys)
                if pending is not None:
                    outs.append(pending.result())
                pending = fetch
            if on_chunk is not None:
                on_chunk(state, stop)
    if stats_out is not None and fuse is not None:
        stats_out.update(totals)
    if not collect:
        return state, None
    if pending is not None:
        outs.append(pending.result())
    if fused_flat is not None:
        flat_idx = (
            np.concatenate(fused_flat).reshape(-1)
            if fused_flat else np.empty(0, np.int32)
        )
    else:
        flat_idx = sched.match_idx[start_step:n_steps].reshape(-1)
    return state, _gather_outputs(
        outs, flat_idx, sched.n_matches, sched.team_size
    )


def _gather_outputs(
    outs: list, flat_idx: np.ndarray, n: int, team: int
) -> HistoryOutputs:
    """Unpacks the per-chunk ``[S', B, 3 + 10T]`` packed arrays and
    scatters the slots back to stream order. No chunks (resume at or past
    the end) yields all-zero outputs with ``updated`` all False."""
    t2 = 2 * team
    if not outs:
        return HistoryOutputs(
            quality=np.zeros(n, np.float32),
            shared_mu=np.zeros((n, 2, team), np.float32),
            shared_sigma=np.zeros((n, 2, team), np.float32),
            delta=np.zeros((n, 2, team), np.float32),
            mode_mu=np.zeros((n, 2, team), np.float32),
            mode_sigma=np.zeros((n, 2, team), np.float32),
            any_afk=np.zeros(n, bool),
            updated=np.zeros(n, bool),
        )
    sel = flat_idx >= 0
    dest = flat_idx[sel]
    full = np.concatenate(outs, axis=0)
    outs.clear()
    full = full.reshape(-1, full.shape[-1])  # [S*B, 3 + 5*2T]
    packed = np.zeros((n, full.shape[1]), full.dtype)
    packed[dest] = full[sel]
    del full

    def block(i):  # a view into `packed`
        return packed[:, 3 + i * t2: 3 + (i + 1) * t2].reshape(n, 2, team)

    return HistoryOutputs(
        quality=packed[:, 0],
        shared_mu=block(0),
        shared_sigma=block(1),
        delta=block(2),
        mode_mu=block(3),
        mode_sigma=block(4),
        any_afk=packed[:, 1] > 0.5,
        updated=packed[:, 2] > 0.5,
    )
