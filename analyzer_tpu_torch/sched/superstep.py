"""Conflict-free superstep construction (host-side, numpy).

Counterpart of ``analyzer_tpu.sched.superstep``; for the same stream it
emits byte-equal schedules and the same ``fingerprint``. A *superstep* is a
set of matches in which no player appears twice, so one gather -> update ->
scatter rates the whole set without collisions, while every player's
matches keep their chronological order across steps. The ASAP assignment

    step(match) = 1 + max(step(previous match of each of its players))

is minimal in step count for a schedule that keeps that order. Matches that
never touch rating state (unsupported modes, AFK/invalid matches,
``rater.py:83-85,90-106``) impose no dependencies and backfill free slots.

The sequential recurrences run in C++ (:mod:`analyzer_tpu_torch.sched.
_native`, built with g++ at first use); the python loops below take over
only when no g++ is installed, and :data:`python_fallbacks` counts that.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np

from analyzer_tpu_torch.core import constants
from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE
from analyzer_tpu_torch.obs import get_registry
from analyzer_tpu_torch.sched import _native

#: Calls served by the python loops because no g++ was found.
python_fallbacks = 0


@dataclasses.dataclass
class MatchStream:
    """N matches in chronological (``created_at`` ascending) order, SoA.

    player_idx ``[N, 2, T]`` int32 player rows, -1 marks an empty slot;
    winner ``[N]`` 0/1 winning-team index; mode_id ``[N]`` index into
    MODES or -1 (unsupported); afk ``[N]`` bool (any AFK or a roster count
    other than two).
    """

    player_idx: np.ndarray
    winner: np.ndarray
    mode_id: np.ndarray
    afk: np.ndarray

    def __post_init__(self) -> None:
        self.player_idx = np.ascontiguousarray(self.player_idx, dtype=np.int32)
        self.winner = np.ascontiguousarray(self.winner, dtype=np.int32)
        self.mode_id = np.ascontiguousarray(self.mode_id, dtype=np.int32)
        self.afk = np.ascontiguousarray(self.afk, dtype=bool)
        if self.player_idx.ndim != 3 or self.player_idx.shape[1] != 2:
            raise ValueError(f"player_idx must be [N, 2, T], got {self.player_idx.shape}")

    @property
    def n_matches(self) -> int:
        return self.player_idx.shape[0]

    @property
    def team_size(self) -> int:
        return self.player_idx.shape[2]

    @property
    def ratable(self) -> np.ndarray:
        return (self.mode_id >= 0) & ~self.afk

    def slice(self, start: int, stop: int) -> "MatchStream":
        return MatchStream(
            self.player_idx[start:stop],
            self.winner[start:stop],
            self.mode_id[start:stop],
            self.afk[start:stop],
        )


class _ScheduleBase:
    """Shared surface of the eager and windowed schedules: the ``[S, B]``
    per-slot scalars as attributes; they differ only in how the
    ``[S, B, 2, T]`` gather tensors are produced (``host_window``)."""

    @property
    def n_steps(self) -> int:
        return self.match_idx.shape[0]

    @property
    def batch_size(self) -> int:
        return self.match_idx.shape[1]

    @property
    def n_matches(self) -> int:
        return int((self.match_idx >= 0).sum())

    @property
    def occupancy(self) -> float:
        """Fraction of packed slots holding real matches."""
        return self.n_matches / max(self.match_idx.size, 1)

    @functools.cached_property
    def fingerprint(self) -> str:
        """Content hash of the packed schedule: "the same work in the same
        order" across processes and across the two packages (the scheme is
        the JAX package's, byte for byte). Schedules made by
        ``pack_schedule`` hash the stream's ``player_idx`` instead of the
        materialized gather tensors, which it determines; a hand-built
        PackedSchedule hashes its tensors under a distinct tag."""
        h = hashlib.sha1()
        stream = getattr(self, "stream", None)
        h.update(
            np.asarray(
                (self.n_steps, self.batch_size, self.pad_row, self.team_size),
                np.int64,
            ).tobytes()
        )
        if stream is not None:
            h.update(b"stream-v1")
            h.update(np.ascontiguousarray(stream.player_idx).tobytes())
        else:
            h.update(b"materialized-v1")
            h.update(np.ascontiguousarray(self.player_idx).tobytes())
            h.update(np.ascontiguousarray(self.slot_mask).tobytes())
        for field in (self.match_idx, self.winner, self.mode_id, self.afk):
            h.update(np.ascontiguousarray(field).tobytes())
        return h.hexdigest()


@dataclasses.dataclass
class PackedSchedule(_ScheduleBase):
    """The stream packed into ``[S, B, ...]`` static-shape superstep batches.

    ``match_idx`` ``[S, B]`` maps each slot back to its stream position (-1
    for padding); ``player_idx`` padding slots point at ``pad_row``."""

    player_idx: np.ndarray  # [S, B, 2, T] int32
    slot_mask: np.ndarray  # [S, B, 2, T] bool
    winner: np.ndarray  # [S, B] int32
    mode_id: np.ndarray  # [S, B] int32
    afk: np.ndarray  # [S, B] bool
    match_idx: np.ndarray  # [S, B] int32
    pad_row: int
    # Kept by pack_schedule so `fingerprint` digests like the windowed form;
    # None for a hand-built schedule.
    stream: "MatchStream | None" = None

    @property
    def team_size(self) -> int:
        return self.player_idx.shape[-1]

    def host_window(self, start: int, stop: int):
        sl = slice(start, stop)
        return (
            self.player_idx[sl],
            self.slot_mask[sl],
            self.winner[sl],
            self.mode_id[sl],
            self.afk[sl],
        )

    def check_compact_invariant(
        self, start: int = 0, stop: int | None = None
    ) -> None:
        """Verifies ``slot_mask == (player_idx != pad_row)`` for a HAND-BUILT
        schedule: the feed ships no mask and derives it on the device, so a
        schedule that breaks the invariant would be rated silently wrong."""
        if self.stream is not None:
            return
        sl = slice(start, self.n_steps if stop is None else stop)
        if not (
            self.slot_mask[sl] == (self.player_idx[sl] != self.pad_row)
        ).all():
            raise ValueError(
                "hand-built schedule violates the compact-feed "
                "invariant: slot_mask must equal "
                "(player_idx != pad_row) — point padding slots at "
                f"pad_row={self.pad_row}"
            )


@dataclasses.dataclass
class WindowedSchedule(_ScheduleBase):
    """A packed schedule whose ``[S, B, 2, T]`` gather tensors are built per
    window, on demand, from the slot->match map — inside the runner's feed
    thread, overlapping the device, with two windows' worth of host memory
    instead of the whole schedule."""

    stream: MatchStream
    winner: np.ndarray  # [S, B] int32
    mode_id: np.ndarray  # [S, B] int32
    afk: np.ndarray  # [S, B] bool
    match_idx: np.ndarray  # [S, B] int32
    pad_row: int
    team_size: int

    def host_window(self, start: int, stop: int):
        pidx, mask = materialize_gather_window(
            self.stream, self.match_idx[start:stop], self.pad_row, self.team_size
        )
        return (pidx, mask, self.winner[start:stop],
                self.mode_id[start:stop], self.afk[start:stop])

    def materialize(self) -> PackedSchedule:
        """The eager equivalent (identical arrays and fingerprint)."""
        pidx, mask, winner, mode_id, afk = self.host_window(0, self.n_steps)
        return PackedSchedule(
            player_idx=pidx,
            slot_mask=mask,
            winner=winner,
            mode_id=mode_id,
            afk=afk,
            match_idx=self.match_idx,
            pad_row=self.pad_row,
            stream=self.stream,
        )


def materialize_gather_window(
    stream: MatchStream, match_idx: np.ndarray, pad_row: int, team_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """The ``[W, B, 2, team_size]`` (player_idx, slot_mask) gather tensors
    for a window of the slot->match map. Padding slots (match_idx < 0) and
    empty team slots point at ``pad_row`` with a False mask; a 3-wide
    stream packed at team_size=5 pads the team axis the same way."""
    if stream.n_matches == 0:  # all-padding (inert) schedule
        shape = match_idx.shape + (2, team_size)
        return np.full(shape, pad_row, np.int32), np.zeros(shape, bool)
    t_in = stream.team_size
    shape = match_idx.shape + (2, team_size)
    pidx = np.empty(shape, np.int32)
    mask = np.zeros(shape, bool)
    if t_in < team_size:  # 3-wide stream packed at 5: inert team tail
        pidx[..., t_in:] = pad_row
    sub_p = pidx[..., :t_in]
    sub_m = mask[..., :t_in]
    rows = np.clip(match_idx, 0, None)
    if t_in == team_size:  # contiguous out — the common case
        np.take(stream.player_idx, rows, axis=0, out=sub_p)
    else:
        sub_p[...] = stream.player_idx[rows]
    np.greater_equal(sub_p, 0, out=sub_m)
    sub_m &= (match_idx >= 0)[..., None, None]
    np.copyto(sub_p, pad_row, where=~sub_m)
    return pidx, mask


def materialize_scalar_window(
    stream: MatchStream, match_idx: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (winner, mode_id, afk) per-slot scalars for a window of the
    slot->match map, with the padding values (winner 0,
    ``UNSUPPORTED_MODE_ID``, afk False) the ratable gate relies on."""
    if stream.n_matches == 0:
        return (
            np.zeros(match_idx.shape, np.int32),
            np.full(match_idx.shape, constants.UNSUPPORTED_MODE_ID, np.int32),
            np.zeros(match_idx.shape, bool),
        )
    pad = ~(match_idx >= 0)
    rows = np.clip(match_idx, 0, None)
    winner = np.empty(match_idx.shape, np.int32)
    mode_id = np.empty(match_idx.shape, np.int32)
    afk = np.empty(match_idx.shape, bool)
    np.take(stream.winner, rows, out=winner)
    np.take(stream.mode_id, rows, out=mode_id)
    np.take(stream.afk, rows, out=afk)
    np.copyto(winner, 0, where=pad)
    np.copyto(mode_id, constants.UNSUPPORTED_MODE_ID, where=pad)
    np.copyto(afk, False, where=pad)
    return winner, mode_id, afk


def _packer():
    """The native packer library, or None (counted) when g++ is missing."""
    global python_fallbacks
    lib = _native.load()
    if lib is None:
        python_fallbacks += 1
    return lib


def assign_supersteps(stream: MatchStream) -> np.ndarray:
    """ASAP superstep index per match, ``[N]`` int64; non-ratable matches
    get -1 ("no dependency — place anywhere")."""
    lib = _packer()
    if lib is None:
        return _assign_supersteps_py(stream)
    return _native.assign_supersteps(lib, stream)


def _assign_supersteps_py(stream: MatchStream) -> np.ndarray:
    n = stream.n_matches
    steps = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return steps
    n_players = int(stream.player_idx.max()) + 1
    # last_step[p] = superstep of p's most recent ratable match, -1 if none.
    last_step = np.full(max(n_players, 1), -1, dtype=np.int64)
    ratable = stream.ratable
    idx = stream.player_idx
    for i in range(n):
        if not ratable[i]:
            continue
        players = idx[i].ravel()
        players = players[players >= 0]
        s = last_step[players].max() + 1 if players.size else 0
        steps[i] = s
        last_step[players] = s
    return steps


def assign_batches(
    stream: MatchStream,
    capacity: int,
    progress: np.ndarray | None = None,
    out: np.ndarray | None = None,
    out_slot: np.ndarray | None = None,
    on_progress=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Capacity-aware first-fit batch index per match.

    Each ratable match, in stream order, goes to the EARLIEST batch that is
    strictly later than all of its players' previous batches and has free
    capacity: chronology and within-batch conflict-freedom hold by
    construction, and the narrow tail of the ASAP width histogram fills
    with later matches whose dependencies are met.

    Returns ``([N] batch id, [N] slot within batch)`` int64, -1 for
    non-ratable matches; slot order within a batch is stream order.

    For a streamed consumer on another thread (``sched.runner.
    rate_stream``): ``progress`` (``[2]`` int64) receives (matches
    processed, batch watermark) as the loop runs and ``(N, batches used)``
    at the end; ``out``/``out_slot`` are caller-allocated result buffers
    (int64, size N, C-contiguous) whose entries below ``progress[0]`` are
    final. ``on_progress`` (zero-argument callable) is called by the python
    loop at every publish; the native loop runs without the GIL and cannot
    call back, so a consumer of it polls."""
    lib = _packer()
    if lib is None:
        return _assign_batches_first_fit_py(
            stream, capacity, progress, out, out_slot, on_progress
        )
    return _native.assign_batches_first_fit(
        lib, stream, capacity, progress, out, out_slot
    )


#: Progress-publish interval of the python first-fit loop, in matches (a
#: power of two, so the check is one mask).
_PY_PROGRESS_EVERY = 2048


def _assign_batches_first_fit_py(
    stream: MatchStream,
    capacity: int,
    progress: np.ndarray | None = None,
    out: np.ndarray | None = None,
    out_slot: np.ndarray | None = None,
    on_progress=None,
) -> tuple[np.ndarray, np.ndarray]:
    n = stream.n_matches
    for name, buf, size in (("out", out, n), ("out_slot", out_slot, n),
                            ("progress", progress, 2)):
        if buf is not None:
            _native.check_out_buffer(name, buf, size)
    if out is None:
        out = np.full(n, -1, dtype=np.int64)
    else:  # the loop below writes only the ratable entries
        out.fill(-1)
    if out_slot is None:
        out_slot = np.full(n, -1, dtype=np.int64)
    else:
        out_slot.fill(-1)
    if n == 0:
        if progress is not None:
            progress[:] = (0, 0)
        return out, out_slot
    n_players = int(stream.player_idx.max()) + 1
    last = np.full(max(n_players, 1), -1, dtype=np.int64)
    fill: list[int] = []
    next_free: list[int] = []  # DSU skip pointer: first batch >= b with space

    def ensure(b: int) -> None:
        while len(fill) <= b:
            fill.append(0)
            next_free.append(len(next_free))

    def find(b: int) -> int:
        ensure(b)
        root = b
        while True:
            ensure(root)
            if next_free[root] == root:
                break
            root = next_free[root]
        while next_free[b] != root:  # path compression
            b, next_free[b] = next_free[b], root
        return root

    ratable = stream.ratable
    idx = stream.player_idx
    for i in range(n):
        if progress is not None and i and not (i & (_PY_PROGRESS_EVERY - 1)):
            # Entries [0, i) are final (the GIL orders the buffer writes
            # before this store, as the C loop's release store does).
            progress[1] = find(0)
            progress[0] = i
            if on_progress is not None:
                on_progress()
        if not ratable[i]:
            continue
        players = idx[i].ravel()
        players = players[players >= 0]
        floor_b = int(last[players].max()) + 1 if players.size else 0
        b = find(floor_b)
        out[i] = b
        out_slot[i] = fill[b]
        fill[b] += 1
        if fill[b] == capacity:
            ensure(b + 1)
            next_free[b] = b + 1
        last[players] = b
    if progress is not None:
        # Batches actually used: len(fill) may count an empty successor
        # pre-created when the last batch filled to exact capacity.
        progress[:] = (n, int(out.max()) + 1)
    return out, out_slot


# The batch-size cost model's two constants, copied from the JAX package
# only so that both packages choose the same batch size and so emit
# byte-equal schedules. They were not fitted for this card.
STEP_FIXED_COST_S = 12e-6
MATCH_SLOT_COST_S = 0.72e-6


def choose_batch_size(
    stream: MatchStream,
    batch_multiple: int = 8,
    max_batch_size: int = 4096,
    step_fixed_cost_s: float = STEP_FIXED_COST_S,
    match_slot_cost_s: float = MATCH_SLOT_COST_S,
) -> int:
    """Minimum-estimated-time batch size for ``stream``.

    For each candidate B the step count is lower-bounded from the ASAP
    width histogram, ``S(B) >= max_s (s + ceil(tail(s) / B))``, and the
    estimated time ``S * (fixed + B * slot)`` is swept over candidates."""
    steps = assign_supersteps(stream)
    ratable = steps >= 0
    n_ratable = int(ratable.sum())
    if n_ratable == 0:
        return batch_multiple
    depth = int(steps.max()) + 1
    widths = np.bincount(steps[ratable], minlength=depth)
    tail = np.cumsum(widths[::-1])[::-1].astype(np.int64)  # tail[s]

    # Candidates: powers-of-two-ish ladder up to the cap, plus mean width.
    mean_width = max(1, n_ratable // depth)
    cands = {batch_multiple, mean_width}
    b = batch_multiple
    while b < max_batch_size:
        b *= 2
        cands.add(min(b, max_batch_size))
    # Sample the tail at ~500 points — exact enough for a max over s.
    sample = np.arange(0, depth, max(1, depth // 500))
    best_b, best_t = batch_multiple, np.inf
    for cand in sorted(cands):
        cand = int(min(max(cand, 1), max_batch_size))
        if cand >= batch_multiple:
            cand = (cand // batch_multiple) * batch_multiple
        s_est = int((sample + -(-tail[sample] // cand)).max())
        t_est = s_est * (step_fixed_cost_s + cand * match_slot_cost_s)
        if t_est < best_t:
            best_b, best_t = cand, t_est
    return max(best_b, 1)


def choose_batch_size_streamed(
    stream: MatchStream, prefix: int | None = None, **kw
) -> int:
    """Batch sizing from a bounded PREFIX (``max(256k, n/8)`` matches, or
    ``prefix``): the argmin over B depends on the ASAP width distribution,
    not its length. Deterministic in ``n``."""
    n = stream.n_matches
    p = prefix or min(n, max(1 << 18, n // 8))
    if p >= n:
        return choose_batch_size(stream, **kw)
    return choose_batch_size(stream.slice(0, p), **kw)


def pack_schedule(
    stream: MatchStream,
    pad_row: int,
    batch_size: int | None = None,
    team_size: int = MAX_TEAM_SIZE,
    batch_multiple: int = 8,
    max_batch_size: int = 4096,
    windowed: bool = False,
) -> "PackedSchedule | WindowedSchedule":
    """Packs a stream into ``[S, B, ...]`` conflict-free batches by
    capacity-aware first-fit (:func:`assign_batches`); ``batch_size=None``
    sweeps the cost model (:func:`choose_batch_size`). Non-ratable matches
    backfill free slots in ascending order, then extra batches.

    ``windowed=True`` returns the lazy :class:`WindowedSchedule`, whose
    gather tensors the runner builds per window; the default eager form
    holds them all."""
    n = stream.n_matches
    t_in = stream.team_size
    if t_in > team_size:
        raise ValueError(f"stream team size {t_in} exceeds pack team size {team_size}")
    if n and int(stream.player_idx.max()) >= pad_row:
        # An index past the table would read or write the wrong player's
        # row (or fault on the card); fail loudly instead.
        raise ValueError(
            f"stream references player row {int(stream.player_idx.max())} but the "
            f"player table only has rows 0..{pad_row - 1} (pad_row={pad_row}); "
            "rebuild the state with enough players"
        )

    if batch_size is None:
        batch_size = choose_batch_size(
            stream, batch_multiple=batch_multiple, max_batch_size=max_batch_size
        )

    batches, slot_in_batch = assign_batches(stream, batch_size)

    ratable_idx = np.flatnonzero(batches >= 0)
    filler = np.flatnonzero(batches < 0)
    n_rate_batches = int(batches.max()) + 1 if ratable_idx.size else 0

    # Free slots left in those batches, to backfill with non-ratable matches.
    free = n_rate_batches * batch_size - ratable_idx.size
    extra_batches = max(0, -(-(filler.size - free) // batch_size)) if filler.size else 0
    s_total = max(n_rate_batches + extra_batches, 1)

    # One scatter builds the slot->match map; fillers take the free slots
    # in ascending order (they read and write no rating state).
    slot_to_match = np.full(s_total * batch_size, -1, dtype=np.int32)
    if ratable_idx.size:
        slot_to_match[
            batches[ratable_idx] * batch_size + slot_in_batch[ratable_idx]
        ] = ratable_idx
    if filler.size:
        free_slots = np.flatnonzero(slot_to_match < 0)
        slot_to_match[free_slots[: filler.size]] = filler
    match_idx = slot_to_match.reshape(s_total, batch_size)

    winner, mode_id, afk = materialize_scalar_window(stream, match_idx)
    ws = WindowedSchedule(
        stream=stream,
        winner=winner,
        mode_id=mode_id,
        afk=afk,
        match_idx=match_idx,
        pad_row=pad_row,
        team_size=team_size,
    )
    # Slot occupancy: pad slots cost the device the same work as real
    # ones, so the histogram shows the waste per schedule and the counter
    # the slots burned in all.
    reg = get_registry()
    reg.histogram("sched.pack_occupancy").observe(round(ws.occupancy, 4))
    reg.counter("sched.pad_slots_total").add(int(s_total * batch_size - n))
    return ws if windowed else ws.materialize()
