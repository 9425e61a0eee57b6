"""Multi-process execution of the data-parallel mesh over ``torch.distributed``.

Counterpart of ``analyzer_tpu.parallel.multihost``. The JAX package joins
every host into one runtime with ``jax.distributed.initialize()``; here the
processes join one ``torch.distributed`` process group, NCCL for a mesh on
the card and gloo for a CPU mesh, and the same mesh code
(:mod:`analyzer_tpu_torch.parallel.mesh`) then spans them: each process
holds ``D / world_size`` consecutive shards, the prior assembly's
contributions meet in one ``all_reduce`` a superstep, and every process
feeds the identical deterministic schedule.

Driven end to end by ``python -m analyzer_tpu_torch.cli rate --mesh 0``
with ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID`` set (the
JAX package's knobs), the same command on every process.
"""

from __future__ import annotations

import datetime
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from analyzer_tpu_torch.device import resolve_device

#: How long a rendezvous or a collective may wait for the other processes.
TIMEOUT_S = 300.0


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> bool:
    """Joins the process group when the multi-process env/args are present.

    Returns True if distributed mode is active (already or now). No-ops
    (returns False) for single-process runs, so callers can call it first
    unconditionally. Environment fallbacks: COORDINATOR_ADDRESS
    (``host:port``), NUM_PROCESSES, PROCESS_ID. ``device`` picks the
    backend: NCCL for the card (None = the card), gloo for the CPU. A
    failed NCCL rendezvous raises; nothing falls back to gloo."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if not coordinator_address:
        return False
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", 0)) or 1
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", 0))
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        # One card per process where there are several (rank order).
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return True


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the card for NCCL,
    the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def assert_processes_agree(label: str, *arrays) -> None:
    """Verifies every process holds identical host-side inputs (SHA-1
    digests compared through the group). No-op single-process.

    The multi-process feed contract assumes each process computed the SAME
    stream/state (deterministic packing from identical files); a stale copy
    of a checkpoint on one host would otherwise feed a globally
    inconsistent sharded table and produce silently wrong ratings. Every
    process gathers every digest, so every process raises on a mismatch."""
    if process_count() == 1:
        return
    h = hashlib.sha1()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    digest = torch.from_numpy(
        np.frombuffer(h.digest(), dtype=np.uint8).astype(np.int32)
    ).to(collective_device())
    gathered = [torch.empty_like(digest) for _ in range(process_count())]
    dist.all_gather(gathered, digest)
    if any(not torch.equal(g, digest) for g in gathered):
        raise RuntimeError(
            f"{label}: host inputs differ across processes (stale checkpoint "
            "copy / divergent stream file?) — aborting before feeding an "
            "inconsistent sharded table"
        )


def process_slice(n: int) -> slice:
    """This process's contiguous shard of an ``n``-item host-side feed
    (schedule chunks, CSV rows): process i of P gets [i*n/P, (i+1)*n/P)."""
    p = process_count()
    i = process_index()
    return slice(i * n // p, (i + 1) * n // p)
