"""Wrapper of the hand-written CUDA row-scatter kernel (``csrc/row_scatter.cu``).

:func:`row_scatter` writes ``rows`` into ``table`` in place,
``table[idx[r], :] = rows[r, :]``, with ``idx`` distinct within the call:
on a CUDA tensor it launches the kernel (building it with nvcc for
``sm_90a`` on first use) or raises; on a CPU tensor — and only because the
tensor lies on the CPU — it runs the kernel's plain PyTorch version,
:func:`row_scatter_plain`. There is no fallback from the card to the plain
version.

:data:`launches` counts kernel launches (incremented only where the kernel
is launched), so a run can show it went through the kernel.

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

#: Number of kernel launches so far (set to 0 to start a count).
launches = 0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


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
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.row_scatter_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def kernel_build_log() -> str:
    """nvcc's messages (``-Xptxas -v``: registers, spills) of the build."""
    return build_log("row_scatter", nvcc_command(), [SOURCE])


def row_scatter_plain(table: torch.Tensor, idx: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``index_copy_`` in place on ``table``."""
    return table.index_copy_(0, idx.long(), rows)


def _check(table, idx, rows, check: bool) -> None:
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(
            f"table must be float32 [P, W], got {table.dtype} {tuple(table.shape)}"
        )
    p, w = table.shape
    if w % 4 != 0:
        raise ValueError(f"row width must be a multiple of 4 floats, got {w}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"idx must be int32 [R], got {idx.dtype} {tuple(idx.shape)}")
    if rows.dtype != torch.float32 or tuple(rows.shape) != (idx.shape[0], w):
        raise ValueError(
            f"rows must be float32 {(idx.shape[0], w)}, got {rows.dtype} "
            f"{tuple(rows.shape)}"
        )
    for name, x in (("table", table), ("idx", idx), ("rows", rows)):
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, table on {table.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if check and idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= p:
            raise ValueError(f"idx must lie in [0, {p}), got [{lo}, {hi}]")
        if int(torch.unique(idx).numel()) != idx.numel():
            raise ValueError("idx must be distinct within a call")


def row_scatter(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                check: bool = False) -> torch.Tensor:
    """``table[idx[r], :] = rows[r, :]`` in place; returns ``table``.

    ``table`` ``[P, W]`` and ``rows`` ``[R, W]`` float32 with ``W % 4 ==
    0``, ``idx`` ``[R]`` int32, all contiguous on one device. ``idx`` must
    lie in ``[0, P)`` and be distinct (several writes to one row in one
    call land in no defined order); ``check=True`` verifies both, at the
    cost of a device sync, for tests and untrusted callers."""
    global launches
    _check(table, idx, rows, check)
    if idx.numel() == 0:
        return table
    if table.device.type == "cpu":
        return row_scatter_plain(table, idx, rows)
    if table.device.type != "cuda":
        raise ValueError(f"row_scatter runs on cuda or cpu, not {table.device}")
    for name, x in (("table", table), ("rows", rows)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for float4 access")
    lib = load()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.row_scatter_launch(
        table.data_ptr(), idx.data_ptr(), rows.data_ptr(), idx.numel(),
        table.shape[1], table.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"row_scatter kernel launch failed: CUDA error {err}")
    launches += 1
    return table
