"""Device-memory telemetry: occupancy and live-buffer gauges.

The port's counterpart of ``analyzer_tpu.obs.devicemem``, with the same
series, sampled at chunk boundaries by the runners
(``sched/runner.py``) and on demand:

  ``device.hbm_bytes_in_use{device=...}``  bytes the caching allocator
                                           has handed out
                                           (``torch.cuda.memory_allocated``);
  ``device.hbm_bytes_limit{device=...}``   the card's memory
                                           (``torch.cuda.mem_get_info``);
  ``device.live_buffers{device=...}``      allocations currently live
                                           (``torch.cuda.memory_stats()``
                                           ``allocation.all.current``);
  ``device.live_buffers``                  process total.

Devices are labelled ``gpu:<n>`` as the JAX package labels a CUDA device.
Where no card is visible (the CPU tests) the numbers are reconstructed
from the live CPU tensors the garbage collector tracks — their count and
the bytes of their distinct storages, under ``cpu:0`` — and no limit is
reported, as the JAX package reconstructs them from ``jax.live_arrays()``.
That walk costs about 0.1 s in a test process, which is why the sampler
throttles itself (:func:`maybe_sample`).

``tier.host_bytes`` is sampled here too, through the probe
``sched/tier.py`` registers (:func:`set_host_tier_sampler`): the tiered
table's budget question is always "device bytes vs host bytes", and one
snapshot answers both sides.
"""

from __future__ import annotations

import gc
import threading
import time

from analyzer_tpu_torch.obs.registry import get_registry

#: Minimum seconds between throttled samples (maybe_sample).
MIN_SAMPLE_INTERVAL_S = 1.0

_lock = threading.Lock()
_last_sample_at: float | None = None

#: Host cold-tier byte probe (``sched/tier.py`` registers one when the
#: first TierManager is built).
_host_tier_sampler = None


def set_host_tier_sampler(fn) -> None:
    """Registers the callable that reports the cold tier's committed host
    bytes (every live tier manager's). One process-wide probe; None
    clears it (tests)."""
    global _host_tier_sampler
    _host_tier_sampler = fn


def _live_cpu_tensors() -> tuple[int, int]:
    """(live CPU tensors, bytes of their distinct storages), from the
    objects the garbage collector tracks."""
    import torch

    count = 0
    storages: dict = {}
    for obj in gc.get_objects():
        # type() rather than isinstance(): isinstance reads __class__, which
        # a lazy module proxy among the tracked objects may answer with a
        # deprecation warning.
        if not issubclass(type(obj), torch.Tensor):
            continue
        try:
            if obj.device.type != "cpu":
                continue
            st = obj.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
        except (RuntimeError, NotImplementedError):  # meta/sparse tensors
            continue
        count += 1
    return count, sum(storages.values())


def sample_device_memory(registry=None) -> dict:
    """Samples every visible card's memory state (or, without one, the
    CPU's live tensors) into gauges; returns ``{device_label:
    {"bytes_in_use", "bytes_limit", "live_buffers", "source"}}``."""
    import torch

    reg = registry or get_registry()
    out: dict = {}
    total = 0
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            label = f"gpu:{i}"
            in_use = int(torch.cuda.memory_allocated(i))
            count = int(
                torch.cuda.memory_stats(i).get("allocation.all.current", 0)
            )
            limit = int(torch.cuda.mem_get_info(i)[1])
            reg.gauge("device.hbm_bytes_in_use", device=label).set(in_use)
            reg.gauge("device.hbm_bytes_limit", device=label).set(limit)
            reg.gauge("device.live_buffers", device=label).set(count)
            out[label] = {
                "bytes_in_use": in_use,
                "bytes_limit": limit,
                "live_buffers": count,
                "source": "memory_stats",
            }
            total += count
    else:
        label = "cpu:0"
        count, in_use = _live_cpu_tensors()
        reg.gauge("device.hbm_bytes_in_use", device=label).set(in_use)
        reg.gauge("device.live_buffers", device=label).set(count)
        out[label] = {
            "bytes_in_use": in_use,
            "bytes_limit": None,
            "live_buffers": count,
            "source": "live_tensors",
        }
        total = count
    reg.gauge("device.live_buffers").set(total)
    if _host_tier_sampler is not None:
        try:
            tier_bytes = int(_host_tier_sampler())
        except Exception:  # noqa: BLE001 — telemetry stays off the failure path
            tier_bytes = None
        if tier_bytes is not None:
            reg.gauge("tier.host_bytes").set(tier_bytes)
            out["host"] = {"tier_bytes": tier_bytes}
    return out


def maybe_sample(min_interval_s: float = MIN_SAMPLE_INTERVAL_S) -> bool:
    """Throttled :func:`sample_device_memory` for chunk-boundary call
    sites: the first call always samples, later calls only after
    ``min_interval_s``. Returns whether a sample ran. Never raises — a
    gauge must not take down a rating loop."""
    global _last_sample_at
    now = time.monotonic()
    with _lock:
        if (
            _last_sample_at is not None
            and now - _last_sample_at < min_interval_s
        ):
            return False
        _last_sample_at = now
    try:
        sample_device_memory()
    except Exception:  # noqa: BLE001 — telemetry stays off the failure path
        return False
    return True


def reset_sampler() -> None:
    """Clears the throttle window (tests)."""
    global _last_sample_at
    with _lock:
        _last_sample_at = None
