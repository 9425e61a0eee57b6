"""Wire-speed columnar ingest: windowed CSV decode into reusable staging
slabs.

The port's copy of ``analyzer_tpu.io.ingest``, with the same names,
semantics and counters. The native scanner's windowed entry
(``_native_csv.parse_csv_window``) decodes match windows DIRECTLY into
fixed-shape slabs leased from the process staging arena
(:class:`analyzer_tpu_torch.sched.feed.PinnedArena`, page-locked memory
where a card is visible), so

  * steady state allocates nothing (slab reuse is the ``arena.hit_rate``
    of ``cli bench --ingest``);
  * each window is copied to the device straight off the slab it was
    decoded into (:func:`analyzer_tpu_torch.sched.feed.stage_ingest_window`,
    asynchronous from pinned memory);
  * decode of window N+1 overlaps the copy of window N when driven through
    a :class:`~analyzer_tpu_torch.sched.feed.Prefetcher` (the bench's
    pipeline).

Semantics contract: the decoded columns are BIT-IDENTICAL to the codec
path — ``decode_stream_csv`` returns exactly ``csv_codec.load_stream_csv``'s
arrays (and the JAX package's, byte for byte). A malformed row ends its
window after the valid prefix and raises :class:`IngestDecodeError` naming
the ABSOLUTE stream row and the row's byte offset (poison attribution);
bytes the grammar cannot take at all (quoted fields), or a scanner that
cannot be built, report ``available = False`` so callers fall back to the
permissive python parser, counted in ``ingest.fallbacks_total``.
"""

from __future__ import annotations

import numpy as np

from analyzer_tpu_torch.core import constants
from analyzer_tpu_torch.obs import get_registry, get_tracer

#: Rows per decode window: at the default 16-slot team axis one window's
#: player slab is 4096 * 2 * 16 * 4 B = 512 KiB — big enough to amortize
#: the per-window call, small enough that a few slabs stay cache- and
#: arena-friendly.
DEFAULT_WINDOW_ROWS = 4096

#: Team-slot axis of the decode slabs (the codec's writer never exceeds
#: it; matches csv_codec.load_stream_csv's max_team).
DEFAULT_MAX_TEAM = 16


class IngestDecodeError(ValueError):
    """A malformed row in the columnar decode, attributed to its
    ABSOLUTE stream row and the byte offset where that row starts."""

    def __init__(self, row: int, byte_offset: int) -> None:
        super().__init__(
            f"malformed CSV row {row} (byte {byte_offset}) in the "
            "columnar decode; route the stream to the python parser "
            "or repair the record"
        )
        self.row = row
        self.byte_offset = byte_offset


class DecodedWindow:
    """One decoded match window living in arena slabs.

    ``player_idx`` / ``winner`` / ``mode_id`` / ``afk`` are TRIMMED
    views of the slabs (``[:rows]``); ``slabs`` is the full fixed-shape
    tuple the H2D edge commits. ``release()`` returns the slabs to the
    arena; pass the committed device tensors so the return waits until
    their copies have completed (``stage_ingest_window`` does this)."""

    __slots__ = ("slabs", "rows", "start_row", "_arena", "_released")

    def __init__(self, slabs, rows: int, start_row: int, arena) -> None:
        self.slabs = slabs
        self.rows = rows
        self.start_row = start_row
        self._arena = arena
        self._released = False

    @property
    def player_idx(self) -> np.ndarray:
        return self.slabs[0][: self.rows]

    @property
    def winner(self) -> np.ndarray:
        return self.slabs[1][: self.rows]

    @property
    def mode_id(self) -> np.ndarray:
        return self.slabs[2][: self.rows]

    @property
    def afk(self) -> np.ndarray:
        return self.slabs[3][: self.rows]

    def release(self, device_arrays=None) -> None:
        """Returns the window's slabs to the arena (idempotent). With
        ``device_arrays`` (one per slab, from the H2D commit) each return
        waits until that slab's copy has completed."""
        if self._released:
            return
        self._released = True
        if device_arrays is None:
            for buf in self.slabs:
                self._arena.give(buf)
        else:
            for buf, dev in zip(self.slabs, device_arrays):
                self._arena.give_when_done(buf, dev)


class ColumnarDecoder:
    """Streaming columnar decoder over one CSV byte stream.

    ``available`` is False when the native scanner cannot be built or the
    bytes need the permissive python grammar (quoted fields) — callers
    fall back to ``csv_codec`` exactly like the whole-file fast path, and
    the fallback is counted in ``ingest.fallbacks_total``. Iterate
    :meth:`windows`; each yielded :class:`DecodedWindow` must be released
    (directly, or via ``stage_ingest_window``) before the arena can
    recycle its slabs.
    """

    def __init__(
        self,
        data: bytes,
        mode_names=None,
        max_team: int = DEFAULT_MAX_TEAM,
        window_rows: int = DEFAULT_WINDOW_ROWS,
        arena=None,
    ) -> None:
        from analyzer_tpu_torch.sched.feed import get_arena

        if window_rows < 1:
            raise ValueError(f"window_rows must be >= 1, got {window_rows}")
        self.data = data
        self.max_team = int(max_team)
        self.window_rows = int(window_rows)
        self.arena = arena or get_arena()
        names = list(mode_names) if mode_names is not None else list(
            constants.MODES
        )
        self._modes_blob = "\n".join(names).encode()
        self._n_modes = len(names)
        self._cursor = np.zeros(1, np.int64)
        self.rows_decoded = 0
        self.windows_decoded = 0
        reg = get_registry()
        self._c_bytes = reg.counter("ingest.bytes_decoded_total")
        self._c_rows = reg.counter("ingest.rows_decoded_total")
        self._c_windows = reg.counter("ingest.windows_total")
        self._native = None
        self.available = False
        if b'"' not in data:
            try:
                from analyzer_tpu_torch.io import _native_csv

                _native_csv.load()
                self._native = _native_csv
                self.available = True
            except ImportError:
                pass
        if not self.available:
            reg.counter("ingest.fallbacks_total").add(1)

    @property
    def bytes_consumed(self) -> int:
        return int(self._cursor[0])

    def windows(self):
        """Yields :class:`DecodedWindow`s until the stream is exhausted.
        Raises :class:`IngestDecodeError` on a malformed row (after the
        window holding the valid prefix has been yielded); raises
        RuntimeError when ``available`` is False — callers decide on
        fallback BEFORE iterating."""
        if not self.available:
            raise RuntimeError(
                "columnar decode unavailable for this stream (no native "
                "scanner, or csv-module grammar needed); fall back to "
                "csv_codec.load_stream_csv"
            )
        native = self._native
        arena = self.arena
        w, t = self.window_rows, self.max_team
        tracer = get_tracer()
        while True:
            slabs = (
                arena.take((w, 2, t), np.int32),
                arena.take((w,), np.int32),
                arena.take((w,), np.int32),
                arena.take((w,), np.uint8),
            )
            with tracer.span(
                "ingest.decode", cat="ingest", start_row=self.rows_decoded
            ):
                before = self.bytes_consumed
                try:
                    n = native.parse_csv_window(
                        self.data, self._modes_blob, self._n_modes, t,
                        self._cursor, *slabs,
                    )
                except native.WindowDecodeError as err:
                    for buf in slabs:
                        arena.give(buf)
                    raise IngestDecodeError(
                        self.rows_decoded + err.row, err.byte_offset
                    ) from err
            if n == 0:
                for buf in slabs:
                    arena.give(buf)
                return
            win = DecodedWindow(slabs, n, self.rows_decoded, arena)
            self.rows_decoded += n
            self.windows_decoded += 1
            self._c_rows.add(n)
            self._c_windows.add(1)
            self._c_bytes.add(self.bytes_consumed - before)
            yield win


def decode_stream_csv(
    data: bytes,
    mode_names=None,
    max_team: int = DEFAULT_MAX_TEAM,
    window_rows: int = DEFAULT_WINDOW_ROWS,
    arena=None,
):
    """Whole-stream decode through the windowed decoder — the parity
    surface against ``csv_codec``: returns a MatchStream bit-identical to
    ``load_stream_csv``'s (trimmed to the stream's widest team, afk as
    bool), or None when the fast path cannot take the bytes (the caller
    falls back, as with ``_native_csv.parse_stream_csv``)."""
    from analyzer_tpu_torch.sched.superstep import MatchStream

    dec = ColumnarDecoder(
        data, mode_names, max_team=max_team, window_rows=window_rows,
        arena=arena,
    )
    if not dec.available:
        return None
    parts = []
    for win in dec.windows():
        parts.append((
            win.player_idx.copy(), win.winner.copy(),
            win.mode_id.copy(), win.afk.copy(),
        ))
        win.release()
    if not parts:
        return MatchStream(
            player_idx=np.full((0, 2, 1), -1, np.int32),
            winner=np.zeros(0, np.int32),
            mode_id=np.zeros(0, np.int32),
            afk=np.zeros(0, bool),
        )
    pidx = np.concatenate([p[0] for p in parts])
    # Trim the fixed slab width to the stream's widest team — the exact
    # shape the two-pass whole-file loader probes for.
    used = np.where((pidx >= 0).any(axis=(0, 1)))[0]
    tmax = int(used[-1]) + 1 if used.size else 1
    return MatchStream(
        player_idx=np.ascontiguousarray(pidx[:, :, :tmax]),
        winner=np.concatenate([p[1] for p in parts]),
        mode_id=np.concatenate([p[2] for p in parts]),
        afk=np.concatenate([p[3] for p in parts]).astype(bool),
    )
