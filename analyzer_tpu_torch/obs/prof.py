"""Device-time attribution: opt-in ``torch.profiler`` capture windows.

The port's counterpart of ``analyzer_tpu.obs.prof``. The host-side spans
(obs/tracer.py) decompose a batch into encode / pack / staging / H2D /
dispatch / commit, but "dispatch" is an enqueue from the host's point of
view. This module arms a process-wide :class:`DeviceProfiler` that
captures one ``torch.profiler`` trace (CPU + CUDA activities) around the
NEXT dispatch window after a request:

  * **operator on demand** — ``SIGUSR2`` on a worker requests a capture
    (force-bypassing the throttle);
  * **automatic on failure** — dead-letters and pipeline degradation
    request a throttled capture of the next batch;
  * **always explicit** — nothing captures unless a profile directory is
    configured (``--profile-dir`` / ``ANALYZER_TPU_PROFILE_DIR``); unarmed,
    ``request`` and ``maybe_capture`` cost one attribute read per batch.

A capture directory has the JAX package's layout —
``<dir>/plugins/profile/<run>/<host>.trace.json.gz`` (the Chrome trace
``torch.profiler`` exports, gzipped) plus ``manifest.json`` with the join
keys — so :mod:`analyzer_tpu_torch.obs.profview` reads captures of either
package. The profiler start/stop never raise into the dispatch path.

:func:`start_trace` / :func:`stop_trace` hold the process's one profiler
session (Kineto runs one at a time, as ``jax.profiler`` does); both this
module and :func:`analyzer_tpu_torch.utils.profiling.trace` go through
them.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import shutil
import socket
import tempfile
import threading
import time

from analyzer_tpu_torch.logging_utils import get_logger

logger = get_logger(__name__)

ENV_DIR = "ANALYZER_TPU_PROFILE_DIR"

MANIFEST_NAME = "manifest.json"

_session_lock = threading.Lock()
# The running (profile, log_dir) pair, or None: one session per process.
_session: tuple | None = None


def start_trace(log_dir: str) -> None:
    """Starts the process's ``torch.profiler`` session (CPU activities,
    plus CUDA where a card is visible) writing into ``log_dir``. Raises
    RuntimeError when a session is already running."""
    global _session
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _session_lock:
        if _session is not None:
            raise RuntimeError("a profiler session is already running")
        prof = profile(activities=activities)
        prof.start()
        _session = (prof, log_dir)


def stop_trace() -> str:
    """Stops the running session and writes its Chrome trace as
    ``<log_dir>/plugins/profile/<run>/<host>.trace.json.gz``; returns
    that path. Raises RuntimeError when no session is running."""
    global _session
    import torch

    with _session_lock:
        if _session is None:
            raise RuntimeError("no profiler session is running")
        prof, log_dir = _session
        _session = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # the capture ends after the device work
    prof.stop()
    run = time.strftime("%Y_%m_%d_%H_%M_%S")
    out_dir = os.path.join(log_dir, "plugins", "profile", run)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{socket.gethostname()}.trace.json.gz")
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(raw)
        with open(raw, "rb") as src, gzip.open(path, "wb") as dst:
            shutil.copyfileobj(src, dst)
    return path


def _device_identity() -> dict:
    """Best-effort (platform, device_kind) of device 0 — the capture must
    not fail because the card is unhappy."""
    try:
        import torch

        if torch.cuda.is_available():
            return {"platform": "gpu",
                    "device_kind": str(torch.cuda.get_device_name(0))}
        return {"platform": "cpu", "device_kind": ""}
    except Exception:  # noqa: BLE001 — identity is advisory
        return {"platform": None, "device_kind": None}


def _start_trace(path: str) -> None:
    """:func:`start_trace`, isolated for tests to stub."""
    start_trace(path)


def _stop_trace() -> None:
    stop_trace()


class DeviceProfiler:
    def __init__(
        self,
        profile_dir: str | None = None,
        min_interval_s: float = 60.0,
        clock=time.monotonic,
    ) -> None:
        self._lock = threading.Lock()
        self.profile_dir = profile_dir or os.environ.get(ENV_DIR) or None
        self.min_interval_s = min_interval_s
        self._clock = clock
        # Reason of the pending capture request; claimed (and cleared) by
        # the next maybe_capture window.
        self._pending: str | None = None
        # Per-reason throttle: a dead-letter storm must not starve an
        # operator's SIGUSR2 (which forces) or a later degradation capture.
        self._last_at: dict[str, float] = {}
        self.captures = 0
        self.last_capture: str | None = None
        self.last_manifest: dict | None = None

    def configure(
        self,
        profile_dir: str | None = None,
        min_interval_s: float | None = None,
    ) -> "DeviceProfiler":
        if profile_dir is not None:
            self.profile_dir = profile_dir
        if min_interval_s is not None:
            self.min_interval_s = min_interval_s
        return self

    @property
    def armed(self) -> bool:
        return self.profile_dir is not None

    def request(self, reason: str, force: bool = False) -> bool:
        """Requests a capture of the next dispatch window. Returns whether
        the request was accepted (False when unarmed or inside the
        reason's throttle window). Safe from signal handlers."""
        if not self.armed:
            return False
        now = self._clock()
        with self._lock:
            last = self._last_at.get(reason)
            if not force and last is not None and (
                now - last < self.min_interval_s
            ):
                return False
            self._last_at[reason] = now
            self._pending = reason
        logger.info("device profiler capture requested (%s)", reason)
        return True

    @contextlib.contextmanager
    def maybe_capture(self, context: dict | None = None):
        """Wraps one dispatch window: a no-op unless a request is pending,
        else the block runs under ``torch.profiler`` into a fresh
        ``profile-<ts>-<reason>-<pid>`` directory (``-<n>`` appended when
        an earlier window of the same second took that name) with a
        ``manifest.json``
        naming the reason, wall window, dispatch-window ordinal, the
        trace/batch ids in flight (the thread-bound trace id plus whatever
        the dispatch site passes in ``context``) and the device, so
        obs/profview joins capture to host trace without filename
        archaeology. Profiler errors never propagate into the dispatch
        path."""
        if self._pending is None:  # the per-batch fast path: one read
            yield
            return
        with self._lock:
            reason, self._pending = self._pending, None
        if reason is None or self.profile_dir is None:
            yield
            return
        stamp = time.strftime("%Y%m%d-%H%M%S")
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
        path = os.path.join(
            self.profile_dir, f"profile-{stamp}-{safe}-{os.getpid()}"
        )
        started = False
        manifest: dict | None = None
        try:
            # Two windows of one reason within the same second (consecutive
            # batches) would share the name: the later one gets "-2", "-3"
            # so each capture keeps its own directory and manifest.
            os.makedirs(self.profile_dir, exist_ok=True)
            base, n = path, 1
            while True:
                try:
                    os.mkdir(path)
                    break
                except FileExistsError:
                    n += 1
                    path = f"{base}-{n}"
            _start_trace(path)
            started = True
            manifest = self._manifest_start(reason, path, context)
        except Exception:  # noqa: BLE001 — attribution must not kill the batch
            logger.exception("device profiler start failed (%s)", reason)
        try:
            yield
        finally:
            if started:
                try:
                    _stop_trace()
                    self.captures += 1
                    self.last_capture = path
                    if manifest is not None:
                        self._write_manifest(path, manifest)
                    logger.info(
                        "device profiler capture (%s) written to %s",
                        reason, path,
                    )
                except Exception:  # noqa: BLE001 — ditto
                    logger.exception(
                        "device profiler stop failed (%s)", reason
                    )

    def _manifest_start(
        self, reason: str, path: str, context: dict | None
    ) -> dict:
        """The manifest fields knowable at capture start. The bound trace
        id doubles as the batch id at the dispatch sites, so it lands in
        both lists."""
        from analyzer_tpu_torch.obs.tracer import current_trace

        trace = current_trace()
        manifest = {
            "version": 1,
            "reason": reason,
            "dir": os.path.basename(path),
            # 1-based ordinal of this capture = the dispatch window it
            # wrapped, in profiler order.
            "capture_index": self.captures + 1,
            "wall_start": time.time(),
            "traces": [trace] if trace else [],
            "batches": [trace] if trace else [],
            "device": _device_identity(),
        }
        for key in ("traces", "batches"):
            extra = (context or {}).get(key) or []
            for item in extra:
                if item and item not in manifest[key]:
                    manifest[key].append(str(item))
        for key, value in sorted((context or {}).items()):
            if key not in ("traces", "batches") and key not in manifest:
                manifest[key] = value
        return manifest

    def _write_manifest(self, path: str, manifest: dict) -> None:
        manifest["wall_end"] = time.time()
        try:
            with open(
                os.path.join(path, MANIFEST_NAME), "w", encoding="utf-8"
            ) as f:
                json.dump(manifest, f, sort_keys=True, indent=2)
                f.write("\n")
            self.last_manifest = manifest
        except OSError:
            logger.exception("device profiler manifest write failed")

    def capture_info(self) -> dict | None:
        """None when unarmed, else the directory, capture count, the latest
        capture path (None until the first window actually ran) and that
        capture's manifest."""
        if not self.armed:
            return None
        return {
            "dir": self.profile_dir,
            "captures": self.captures,
            "last_capture": self.last_capture,
            "last_manifest": self.last_manifest,
        }


_profiler_lock = threading.Lock()
_profiler: DeviceProfiler | None = None


def get_device_profiler() -> DeviceProfiler:
    """The process-wide device profiler (created on first use)."""
    global _profiler
    with _profiler_lock:
        if _profiler is None:
            _profiler = DeviceProfiler()
        return _profiler


def reset_device_profiler(**kwargs) -> DeviceProfiler:
    """Replaces the process-wide profiler with a fresh one (tests)."""
    global _profiler
    with _profiler_lock:
        _profiler = DeviceProfiler(**kwargs)
        return _profiler
