"""The fused rating window: K supersteps against a working set of rows.

Counterpart of ``analyzer_tpu.core.fused``. A window of K conflict-free
supersteps runs against a working set of the window's touched player rows:

  1. ONE gather pulls every touched row from the table into the working
     set (``ws = table[slot_rows]``, ``[n_slots, 16]``);
  2. the K steps run against the working set, each gathering its batch by
     slot index and committing posteriors back into it — on a CUDA tensor
     in the hand-written kernel (:mod:`analyzer_tpu_torch.kernels.
     fused_window`), on a CPU tensor in the plain PyTorch version below;
  3. ONE writeback puts the working set back into the table.

Slot 0 always holds the padding row (``sched.residency`` guarantees it):
the slot mask is ``slot_idx != 0``, masked and non-written slots route to
slot 0, and slot 0 is kept pristine — the fused twin of the padding row
that ``core.update.scatter_rows_`` re-pins. With the same per-step math
(``rate_gathered``), the plain window reproduces the ``reference`` runner
bit for bit on the same device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.update import pack_outputs, rate_step_

#: The working-set slot every masked / non-ratable write routes to, and
#: every padding team slot gathers from.
PAD_SLOT = 0


def _window_step_plain(ws, sidx, winner, mode_id, afk, cfg, collect):
    """One superstep against the working set ``ws`` [n_slots, 16], in place:
    every row of the step is gathered before the masked write, and slot 0
    is re-pinned (``rate_step_``). Returns the packed outputs or None."""
    out = rate_step_(ws, PAD_SLOT, sidx, winner, mode_id, afk, cfg)
    return pack_outputs(out) if collect else None


def _window_plain(ws, slot_idx, winner, mode_id, afk, cfg, collect):
    """The plain PyTorch fused window — a Python loop over the K steps, in
    place on ``ws``; the version the CUDA kernel is held against. Returns
    ``(ws, ys)`` with ``ys`` ``[K, B, 3 + 10T]`` or None."""
    ys = []
    for s in range(slot_idx.shape[0]):
        y = _window_step_plain(
            ws, slot_idx[s], winner[s], mode_id[s], afk[s], cfg, collect
        )
        if collect:
            ys.append(y)
    return ws, (torch.stack(ys) if collect else None)


def fused_window_table(
    table, slot_rows, slot_idx, winner, mode_id, afk,
    cfg: RatingConfig, collect: bool, backend: str | None = None,
    n_steps: int | None = None,
):
    """The fused window, in place on a raw table.

    table      [P+1, 16] float32   the player table
    slot_rows  [n_slots] int        slot -> player row (slot 0 and unused
                                    slots hold the padding row)
    slot_idx   [K, B, 2, T] int32   the steps' batches in slot ids
    winner/mode_id/afk [K, B] int32 (afk 0/1)

    ``backend`` None or "cuda" runs the kernel wrapper (the kernel on a
    CUDA table, its plain version on a CPU table); "torch" runs the plain
    version and is refused on a CUDA table, where the fused path is always
    the kernel. ``n_steps`` (default K) is the window's real step count;
    the steps after it are inert padding, which the kernel does not loop.
    Returns ``(table, ys)``; inert padded steps produce ys rows the caller
    drops through its slot->match map."""
    if backend == "torch" and table.is_cuda:
        raise ValueError(
            "fuse_backend='torch' runs the plain window on CPU tensors only; "
            "on a CUDA table the fused path is the CUDA kernel"
        )
    rows = slot_rows.long()
    ws = table.index_select(0, rows)  # the ONE per-window gather
    if backend == "torch":
        ws, ys = _window_plain(ws, slot_idx, winner, mode_id, afk, cfg, collect)
    else:
        from analyzer_tpu_torch.kernels.fused_window import fused_window

        ws, ys = fused_window(ws, slot_idx, winner, mode_id, afk, cfg, collect,
                              n_steps=n_steps)
    # The ONE per-window writeback. Duplicate indices (unused slots and
    # slot 0 all map to the padding row) carry bit-identical pristine pad
    # rows — unused slots are never touched and slot 0 is never written —
    # so index_copy_'s unspecified order among duplicates cannot matter.
    table.index_copy_(0, rows, ws)
    return table, ys


def fused_apply_window(
    state, slot_rows, slot_idx, winner, mode_id, afk,
    cfg: RatingConfig, collect: bool = False, backend: str | None = None,
):
    """State-level entry point (tests, one-shot use) on numpy or tensor
    inputs: the caller's state stays valid. Returns (new state, ys)."""
    dev = state.table.device

    def i32(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.int32).contiguous()
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)

    table, ys = fused_window_table(
        state.table.clone(), i32(slot_rows), i32(slot_idx), i32(winner),
        i32(mode_id), i32(afk), cfg, collect, backend,
    )
    return dataclasses.replace(state, table=table), ys
