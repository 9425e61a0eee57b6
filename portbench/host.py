"""Process settings of a benchmark run, applied before torch is imported.

Every run of every cell starts the same way, so that two runs of one seed
see the same host:

  * the process is pinned to the CPUs of the card's NUMA node
    (``/sys/bus/pci/devices/<bdf>/numa_node`` and the node's ``cpulist``;
    the card's bus id comes from ``nvidia-smi``);
  * the thread pools are capped at :data:`THREADS` (OpenMP, MKL, OpenBLAS
    and torch's intra-op pool);
  * the build and kernel caches sit at fixed paths inside the checkout,
    so only the first run of a checkout builds;
  * ``USE_FLAX=0`` keeps a library from loading JAX on its own.

Nothing of the machine is changed: the run reads ``/sys`` and sets its own
affinity and environment only.
"""

from __future__ import annotations

import os
import subprocess

#: Intra-op and OpenMP threads of a run. The hot paths are the port's own
#: threads (feed, assigner, pipeline writer, front-door readers), numpy and
#: the card; four pool threads leave the rest of an 8-core host to them.
THREADS = 4

#: Cache directories, relative to the checkout's root.
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": ".portbench_cache/torch_extensions",
    "TRITON_CACHE_DIR": ".portbench_cache/triton",
}

_THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "NUMEXPR_NUM_THREADS")


def _card_bus_id() -> str | None:
    """The PCI bus id of the first card this process may use, as sysfs
    names it (``0000:1b:00.0``), or None without ``nvidia-smi``."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    index = visible if visible.isdigit() else "0"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader",
             "-i", index],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = out.stdout.strip().splitlines()
    if out.returncode != 0 or not line or ":" not in line[0] or "n/a" in line[0].lower():
        return None
    dom, _, rest = line[0].strip().lower().partition(":")
    # nvidia-smi prints an 8-digit domain; sysfs uses 4.
    return f"{dom[-4:]}:{rest}"


def _parse_cpulist(text: str) -> set[int]:
    cpus: set[int] = set()
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def numa_cpus(bus_id: str | None) -> tuple[int | None, set[int] | None]:
    """(node, cpus) of the card's NUMA node; (None, None) where the kernel
    does not say (no node, or a node of -1)."""
    if bus_id is None:
        return None, None
    try:
        with open(f"/sys/bus/pci/devices/{bus_id}/numa_node") as f:
            node = int(f.read().strip())
        if node < 0:
            return None, None
        with open(f"/sys/devices/system/node/node{node}/cpulist") as f:
            return node, _parse_cpulist(f.read())
    except (OSError, ValueError):
        return None, None


def apply(root: str) -> dict:
    """Applies the settings to this process and returns what was set, for
    the run's settings line. Call before torch is imported."""
    for var in _THREAD_VARS:
        os.environ[var] = str(THREADS)
    os.environ["USE_FLAX"] = "0"
    for var, rel in CACHE_DIRS.items():
        path = os.path.join(root, rel)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    bus = _card_bus_id()
    node, cpus = numa_cpus(bus)
    allowed = os.sched_getaffinity(0)
    pinned = sorted(cpus & allowed) if cpus else []
    if pinned:
        os.sched_setaffinity(0, pinned)
    return {
        "card_bus_id": bus,
        "numa_node": node,
        "cpus": _cpulist(pinned or sorted(allowed)),
        "pinned": bool(pinned),
        "threads": THREADS,
    }


def _cpulist(cpus: list[int]) -> str:
    """``[0, 1, 2, 5]`` -> ``"0-2,5"``."""
    out = []
    start = prev = None
    for c in cpus:
        if start is None:
            start = prev = c
        elif c == prev + 1:
            prev = c
        else:
            out.append(f"{start}-{prev}" if prev != start else str(start))
            start = prev = c
    if start is not None:
        out.append(f"{start}-{prev}" if prev != start else str(start))
    return ",".join(out)


def cap_torch_threads(torch) -> None:
    """torch's own pools, once it is imported."""
    torch.set_num_threads(THREADS)
    try:
        torch.set_num_interop_threads(THREADS)
    except RuntimeError:  # already set by an earlier parallel call
        pass


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None
