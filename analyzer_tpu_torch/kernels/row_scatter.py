"""Wrapper of the hand-written CUDA row-scatter kernel (``csrc/row_scatter.cu``).

Two entry points to one kernel:

  * :func:`row_scatter_steps` applies S steps in order, in place,
    ``table[idx[s, r], :] = rows[s, r, :]`` with ``idx[s]`` distinct within
    a step (a later step's row wins where steps share one): one cooperative
    launch for the whole run;
  * :func:`row_scatter` is one step, the S = 1 case.

``mode="drop"`` (the JAX package's spelling, as in its
``.at[idx].set(rows, mode="drop")``) skips every entry whose index lies
outside ``[0, P)``; the sharded re-rate (:mod:`analyzer_tpu_torch.parallel.
mesh`) pads each shard's compacted row list with such entries. Without it
an out-of-range index is the caller's error (``check=True`` refuses it).

On a CUDA tensor they launch the kernel (building it with nvcc for
``sm_90a`` on first use) or raise; on a CPU tensor — and only because the
tensor lies on the CPU — they run the kernel's plain PyTorch version,
:func:`row_scatter_steps_plain` (a loop of ``index_copy_``). There is no
fallback from the card to the plain version.

:data:`launches` counts kernel launches (incremented only where the kernel
is launched, once per launch), so a run can show it went through the
kernel.

The kernel replaces ``experiments/scatter_floor.py::pallas_kernel``; the
source's header says what bounds it on an H100 and how the design answers.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from analyzer_tpu_torch.native_build import build_and_load, build_log, nvcc_path

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "row_scatter.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills into the build log
]
#: Threads per block (``kThreads`` in the source).
THREADS = 256

#: Number of kernel launches so far (set to 0 to start a count).
launches = 0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_max_blocks: dict[int, int] = {}  # device index -> resident blocks


def nvcc_command() -> list[str]:
    """The nvcc command line the kernel is built with."""
    return [nvcc_path(), *NVCC_FLAGS]


def load() -> ctypes.CDLL:
    """The kernel library, built from the source on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = build_and_load("row_scatter", nvcc_command(), [SOURCE])
            lib.row_scatter_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ]
            lib.row_scatter_launch.restype = ctypes.c_int
            lib.row_scatter_max_blocks.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ]
            lib.row_scatter_max_blocks.restype = ctypes.c_int
            _lib = lib
        return _lib


def kernel_build_log() -> str:
    """nvcc's messages (``-Xptxas -v``: registers, spills) of the build."""
    return build_log("row_scatter", nvcc_command(), [SOURCE])


def max_resident_blocks(device: torch.device) -> int:
    """The largest grid a cooperative launch of the kernel may have on
    ``device``: every block resident at once. Cached per device."""
    index = device.index or 0
    if index not in _max_blocks:
        blocks = ctypes.c_int(0)
        err = load().row_scatter_max_blocks(index, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(
                f"row_scatter occupancy query failed on {device}: CUDA error {err}"
            )
        _max_blocks[index] = blocks.value
    return _max_blocks[index]


#: The scatter modes: None (every index in range) and "drop".
MODES = (None, "drop")


def _kept(idx: torch.Tensor, n_table: int) -> torch.Tensor:
    """Drop mode's mask: the entries whose index lies in ``[0, n_table)``."""
    return (idx >= 0) & (idx < n_table)


def row_scatter_steps_plain(table: torch.Tensor, idx: torch.Tensor,
                            rows: torch.Tensor,
                            mode: str | None = None) -> torch.Tensor:
    """The plain PyTorch version: one ``index_copy_`` per step, in order,
    in place on ``table``; with ``mode="drop"`` each step masks its
    out-of-range entries first."""
    for s in range(idx.shape[0]):
        if mode == "drop":
            keep = _kept(idx[s], table.shape[0])
            table.index_copy_(0, idx[s][keep].long(), rows[s][keep])
        else:
            table.index_copy_(0, idx[s].long(), rows[s])
    return table


def row_scatter_plain(table: torch.Tensor, idx: torch.Tensor,
                      rows: torch.Tensor, mode: str | None = None) -> torch.Tensor:
    """The plain PyTorch version of one step: ``index_copy_`` in place."""
    return row_scatter_steps_plain(table, idx[None], rows[None], mode)


def _check(table, idx, rows, check: bool, mode: str | None = None) -> None:
    """``idx`` ``[S, R]`` and ``rows`` ``[S, R, W]`` against ``table``."""
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(
            f"table must be float32 [P, W], got {table.dtype} {tuple(table.shape)}"
        )
    p, w = table.shape
    if w % 4 != 0:
        raise ValueError(f"row width must be a multiple of 4 floats, got {w}")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"idx must be int32 [S, R], got {idx.dtype} {tuple(idx.shape)}")
    want = (*idx.shape, w)
    if rows.dtype != torch.float32 or tuple(rows.shape) != want:
        raise ValueError(
            f"rows must be float32 {want}, got {rows.dtype} {tuple(rows.shape)}"
        )
    for name, x in (("table", table), ("idx", idx), ("rows", rows)):
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, table on {table.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if check and idx.numel():
        if mode == "drop":
            # Only the kept entries must be distinct: the dropped ones
            # (padding) may all share one out-of-range index.
            kept = torch.where(_kept(idx, p), idx.long(), -1 - torch.arange(
                idx.shape[1], device=idx.device))
            srt = kept.sort(dim=1).values
        else:
            lo, hi = int(idx.min()), int(idx.max())
            if lo < 0 or hi >= p:
                raise ValueError(f"idx must lie in [0, {p}), got [{lo}, {hi}]")
            srt = idx.sort(dim=1).values
        if bool((srt[:, 1:] == srt[:, :-1]).any()):
            raise ValueError("idx must be distinct within a step")


def _scatter(table, idx, rows, grid_blocks, mode=None):
    """Checked ``[S, R]`` / ``[S, R, W]`` inputs: the plain version on the
    CPU, one cooperative launch on the card."""
    global launches
    if idx.numel() == 0:
        return table
    if table.device.type == "cpu":
        return row_scatter_steps_plain(table, idx, rows, mode)
    if table.device.type != "cuda":
        raise ValueError(f"row_scatter runs on cuda or cpu, not {table.device}")
    for name, x in (("table", table), ("rows", rows)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for float4 access")
    lib = load()
    s_steps, n_rows = idx.shape
    width = table.shape[1]
    cap = max_resident_blocks(table.device)
    need = -(-n_rows * (width // 4) // THREADS)
    blocks = min(need, cap) if grid_blocks is None else grid_blocks
    if not 1 <= blocks <= cap:
        raise ValueError(
            f"a cooperative launch of {blocks} blocks cannot run on "
            f"{table.device}: at most {cap} blocks of {THREADS} threads are "
            "resident at once"
        )
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.row_scatter_launch(
        table.data_ptr(), idx.data_ptr(), rows.data_ptr(), s_steps, n_rows,
        width, blocks, table.device.index or 0, stream, table.shape[0],
        int(mode == "drop"),
    )
    if err != 0:
        raise RuntimeError(f"row_scatter kernel launch failed: CUDA error {err}")
    launches += 1
    return table


def row_scatter_steps(table: torch.Tensor, idx: torch.Tensor,
                      rows: torch.Tensor, check: bool = False,
                      grid_blocks: int | None = None,
                      mode: str | None = None) -> torch.Tensor:
    """S steps in order, in place: ``table[idx[s, r], :] = rows[s, r, :]``
    for s = 0 .. S-1; returns ``table``.

    ``table`` ``[P, W]`` and ``rows`` ``[S, R, W]`` float32 with ``W % 4 ==
    0``, ``idx`` ``[S, R]`` int32, all contiguous on one device. ``idx[s]``
    must lie in ``[0, P)`` and be distinct within the step (several writes
    to one row in one step land in no defined order); ``check=True``
    verifies both, at the cost of a device sync. With ``mode="drop"`` an
    index outside ``[0, P)`` writes nothing, and ``check=True`` verifies
    distinctness among the kept entries only. On the card the run is one
    cooperative launch of ``grid_blocks`` blocks (default: enough for one
    step, at most what the card holds resident; a larger grid is
    refused)."""
    _check(table, idx, rows, check, mode)
    return _scatter(table, idx, rows, grid_blocks, mode)


def row_scatter(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                check: bool = False, mode: str | None = None) -> torch.Tensor:
    """One step, ``table[idx[r], :] = rows[r, :]`` in place; returns
    ``table``. ``idx`` ``[R]`` int32 and ``rows`` ``[R, W]``; otherwise
    as :func:`row_scatter_steps`, of which it is the S = 1 case."""
    if idx.dim() != 1:
        raise ValueError(f"idx must be int32 [R], got {idx.dtype} {tuple(idx.shape)}")
    if rows.dim() != 2:
        raise ValueError(f"rows must be float32 [R, W], got {tuple(rows.shape)}")
    return row_scatter_steps(table, idx[None], rows[None], check, mode=mode)
