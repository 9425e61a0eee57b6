"""Rating-state snapshots with a resume cursor.

The port's copy of ``analyzer_tpu.io.checkpoint``, with the same ``.npz``
layout, so a checkpoint written by either package loads in the other:
the four state arrays (``table``, ``rank_points_ranked``,
``rank_points_blitz``, ``skill_tier``), ``cursor``, ``step_cursor``, the
optional ``schedule_fingerprint``, ``format_version`` (4) and the seeding
config ``seed_cfg``.

Cursor semantics, two levels, because superstep packing is not
stream-prefix monotone (a late match between fresh players can land in an
early superstep, so "state after step s" is not "state after match m"):

  * ``cursor`` — the stream offset the current schedule was packed from;
    matches before it are fully applied. A finished run stores
    ``cursor = n_matches, step_cursor = 0``.
  * ``step_cursor`` — progress within the deterministic packed schedule of
    ``stream[cursor:]``. Resume re-packs that slice (packing is a pure
    function of the stream) and re-enters the run at this superstep.
  * ``schedule_fingerprint`` — hash of the packed schedule (the same
    scheme in both packages), checked on resume so a changed stream file
    or packing policy fails loudly instead of double-applying updates.

A save writes ``<path>.tmp`` and renames it into place, so a crash
mid-write leaves the previous snapshot intact.

Telemetry: each serialize and rename runs in a ``checkpoint.write`` span
(on the writer thread for :class:`CheckpointWriter`), and the registry
counts snapshots taken (``checkpoint.snapshots_total``), snapshots a newer
one replaced before they were written (``checkpoint.superseded_total``)
and the bytes of the files renamed into place
(``checkpoint.bytes_written_total``).
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.obs import get_registry, get_tracer

_FIELDS = ("table", "rank_points_ranked", "rank_points_blitz", "skill_tier")
_CFG_FIELDS = tuple(f.name for f in dataclasses.fields(RatingConfig))
_FORMAT_VERSION = 4


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    state: PlayerState
    cursor: int  # stream offset the schedule was packed from
    step_cursor: int = 0  # superstep progress within that schedule
    schedule_fingerprint: str | None = None


def _host_arrays(state: PlayerState) -> dict:
    """Copies of the state's arrays on the host, taken now (the runners
    update the table in place, so a view would change under the writer)."""
    return {f: getattr(state, f).detach().to("cpu", copy=True).numpy()
            for f in _FIELDS}


def _write(path: str, arrays: dict, seed_cfg, cursor: int, step_cursor: int,
           schedule_fingerprint: str | None) -> None:
    arrays = dict(arrays)
    arrays["cursor"] = np.int64(cursor)
    arrays["step_cursor"] = np.int64(step_cursor)
    if schedule_fingerprint is not None:
        arrays["schedule_fingerprint"] = np.bytes_(schedule_fingerprint.encode())
    arrays["format_version"] = np.int64(_FORMAT_VERSION)
    if seed_cfg is not None:
        arrays["seed_cfg"] = np.asarray(
            [float(getattr(seed_cfg, f)) for f in _CFG_FIELDS]
        )
    tmp = path + ".tmp"
    with get_tracer().span("checkpoint.write", cat="io",
                           step_cursor=int(step_cursor)) as args:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            nbytes = f.tell()
        os.replace(tmp, path)
        args["bytes"] = nbytes
    get_registry().counter("checkpoint.bytes_written_total").add(nbytes)


def save_checkpoint(
    path: str,
    state: PlayerState,
    cursor: int = 0,
    step_cursor: int = 0,
    schedule_fingerprint: str | None = None,
) -> None:
    """Writes state + cursors atomically (tmp file + rename)."""
    get_registry().counter("checkpoint.snapshots_total").add(1)
    _write(path, _host_arrays(state), state.seed_cfg, cursor, step_cursor,
           schedule_fingerprint)


class CheckpointWriter:
    """Asynchronous snapshots: the caller pays only the device-to-host copy
    (:meth:`save`); serializing and the atomic rename run on a writer
    thread. Latest wins: a newer snapshot replaces one not yet written,
    since only the newest matters for resume. :meth:`close` drains the
    queue and re-raises any write error."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._pending: tuple | None = None
        self._stop = False
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._loop, name="checkpoint-writer", daemon=True
        )
        self._thread.start()

    def save(
        self,
        state: PlayerState,
        cursor: int = 0,
        step_cursor: int = 0,
        schedule_fingerprint: str | None = None,
    ) -> None:
        """Copies ``state`` to the host (the only synchronous cost) and
        queues the write. Raises any error of an EARLIER write, so a
        failing disk shows before :meth:`close`."""
        if self._err is not None:
            raise self._err
        job = (_host_arrays(state), state.seed_cfg, cursor, step_cursor,
               schedule_fingerprint)
        reg = get_registry()
        reg.counter("checkpoint.snapshots_total").add(1)
        with self._lock:
            if self._pending is not None:
                reg.counter("checkpoint.superseded_total").add(1)
            self._pending = job
            self._event.set()

    def _loop(self) -> None:
        while True:
            self._event.wait()
            with self._lock:
                self._event.clear()
                job, self._pending = self._pending, None
                stop = self._stop
            if job is not None:
                try:
                    _write(self.path, *job)
                except BaseException as e:  # noqa: BLE001 — surfaced on save/close
                    self._err = e
            elif stop:
                return
            if stop:
                self._event.set()  # drain: re-check for a last pending job

    def close(self) -> None:
        """Drains pending writes, stops the thread, re-raises any error."""
        with self._lock:
            self._stop = True
            self._event.set()
        self._thread.join()
        if self._err is not None:
            raise self._err


def load_checkpoint(path: str, device=None) -> Checkpoint:
    """Reads a checkpoint of either package onto ``device`` (None: the
    card). Raises on an unknown format version. Finished-run snapshots of
    formats 2 and 3 still load; a format-3 MID-schedule snapshot is refused
    — its fingerprint scheme differs, so a resume could never match it."""
    with np.load(path) as z:
        version = int(z["format_version"])
        if version not in (2, 3, _FORMAT_VERSION):
            raise ValueError(f"checkpoint format {version} != {_FORMAT_VERSION}")
        if version == 3 and "step_cursor" in z and int(z["step_cursor"]) > 0:
            raise ValueError(
                "mid-schedule checkpoint written under the old (v3) "
                "fingerprint scheme cannot be resumed by this version; "
                "re-rate from scratch or from a finished-run checkpoint"
            )
        cfg = None
        if "seed_cfg" in z:
            cfg = RatingConfig(
                **dict(zip(_CFG_FIELDS, (float(v) for v in z["seed_cfg"])))
            )
        state = PlayerState.from_numpy(
            *(z[f] for f in _FIELDS), seed_cfg=cfg, device=device
        )
        fingerprint = None
        if "schedule_fingerprint" in z:
            fingerprint = bytes(z["schedule_fingerprint"]).decode()
        return Checkpoint(
            state=state,
            cursor=int(z["cursor"]),
            step_cursor=int(z["step_cursor"]) if "step_cursor" in z else 0,
            schedule_fingerprint=fingerprint,
        )
