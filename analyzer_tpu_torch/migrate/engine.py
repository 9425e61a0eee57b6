"""The streaming backfill engine: decode -> assign -> stage -> dispatch, all
overlapped on the runners' feed ring.

``sched.runner.rate_stream`` overlaps ASSIGNMENT with the card but needs
the whole decoded stream up front: a CSV re-rate pays the columnar decode
of the whole file before the first assignment. This engine moves the
overlap one stage upstream:

  * a FRONT-HALF thread iterates :class:`analyzer_tpu_torch.io.ingest.
    ColumnarDecoder` windows — each decodes natively into arena slabs, is
    appended into preallocated stream buffers (sized once from the byte
    stream's newline count) and fed to the incremental first-fit
    (:mod:`analyzer_tpu_torch.migrate.assign`, the GIL-released native loop
    by default), which publishes its progress through the sentinel buffers
    and condition variable ``rate_stream`` uses;
  * the FEED thread (:class:`_BackfillFeed`, ``rate_stream``'s
    ``_StreamFeed`` with the fillers placed inline) scatters newly assigned
    slots into the slot->match map and stages each complete window of
    ``steps_per_chunk`` supersteps — for ``kernel="fused"`` with its
    residency plans, with ``hot_rows`` through the tier manager's staging,
    the code ``rate_stream`` runs;
  * the CONSUMER is the runners' loop (``sched.runner._consume``): it
    dispatches each staged chunk — the plain superstep, or the hand-written
    ``fused_window`` CUDA kernel on the card — publishes throttled
    snapshots into the STAGING lineage, and waits before each dispatch
    while the :class:`~analyzer_tpu_torch.service.broker.AdmissionController`
    gives a live plane's backlog the card.

Time to first dispatch is O(the planning prefix — ``plan_windows`` decode
windows — plus a chunk of assignment) instead of O(file). The emitted
schedule is a pure function of (bytes, batch size, steps_per_chunk): window
boundaries are fixed multiples of ``steps_per_chunk``, the assigner runs in
stream order, and the chosen batch size is a pure function of the
planning-prefix bytes and the knobs, which :func:`migration_fingerprint`
folds in. The final table and collected outputs equal ``rate_stream``'s
over the same decoded stream bit for bit (each match reads only its
players' prior rows, however matches are grouped), and a run resumed from
a checkpoint's ``start_step`` equals the uninterrupted run bit for bit: the
front half re-derives the schedule from the bytes and skips the windows
below the watermark.

Telemetry beyond the runners' spans (``sched/runner.py``): the front half
times each decode window (``ingest.decode``) and each assignment window
(``migrate.assign``); the feed's sleeps on the front half are
``feed.wait_assign``; on the caller's thread ``migrate.prepare`` times
the per-run set-up (its ``part``: the stream buffers sized from the
newline count, the schedule fingerprint, the feed), ``migrate.checkpoint``
each snapshot the consumer takes (the host copy a ``CheckpointWriter``
queues, and the final synchronous save, ``final=True``) and
``migrate.publish`` the final staging publish; the chunk-boundary
staging publishes are the runners' ``view.publish``, and the cutover is
``migrate.cutover`` (``migrate/lineage.py``).

The port's copy of ``analyzer_tpu.migrate.engine``: the schedule, the
batch size and the fingerprint equal the JAX package's exactly
(tests/test_torch_migrate.py). Where the JAX engine copies the state with
``jax.tree.map(jnp.copy, ...)`` and calls its runner's scan chunk, the
port clones the table once and dispatches through ``_consume``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import threading
import time

import numpy as np

from analyzer_tpu_torch.core.state import MAX_TEAM_SIZE
from analyzer_tpu_torch.core.update import check_seed_cfg
from analyzer_tpu_torch.io.ingest import DEFAULT_WINDOW_ROWS, ColumnarDecoder
from analyzer_tpu_torch.migrate.assign import (
    IncrementalAssigner,
    assign_native_available,
)
from analyzer_tpu_torch.migrate.progress import get_migration_progress
from analyzer_tpu_torch.obs import get_registry, get_tracer
from analyzer_tpu_torch.sched.residency import resolve_fuse
from analyzer_tpu_torch.sched.runner import (
    _consume,
    _flat,
    _gather_outputs,
    _StreamFeed,
    rate_stream,
)
from analyzer_tpu_torch.sched.superstep import (
    MatchStream,
    choose_batch_size_streamed,
)
from analyzer_tpu_torch.sched.tier import TierManager
from analyzer_tpu_torch.utils.ownership import thread_role

#: Decode windows in the batch-size PLANNING PREFIX (``plan_windows``): one
#: window can undershoot b on heavy-tailed ladders (a 4096-row head may miss
#: the tail's width distribution); a few windows are still an O(prefix)
#: launch cost.
DEFAULT_PLAN_WINDOWS = 4


def migration_fingerprint(
    data: bytes,
    batch_size: int,
    spc: int,
    plan_windows: int | None = None,
    window_rows: int | None = None,
) -> str:
    """Identity of one migration's emitted schedule, a pure function of
    (bytes, batch size, window size): what a mid-run checkpoint stores and
    a resume verifies, so a changed input or chunking fails loudly instead
    of double-applying. ``plan_windows`` / ``window_rows`` fold the
    planning-prefix policy in (the chosen b depends on it); the bare
    three-argument form is the policy-free content hash. sha1 over the
    same bytes and int64s as the JAX package's, so the two agree."""
    h = hashlib.sha1()
    h.update(b"migrate-v1")
    h.update(hashlib.sha256(data).digest())
    h.update(np.asarray((batch_size, spc), np.int64).tobytes())
    if plan_windows is not None or window_rows is not None:
        h.update(b"plan-v2")
        h.update(
            np.asarray((plan_windows or 0, window_rows or 0), np.int64).tobytes()
        )
    return h.hexdigest()


def _decode_fallback(data: bytes) -> MatchStream:
    """The python-codec whole-stream decode (quoted grammar, or no native
    scanner): counted, and reported as ``streamed: false``."""
    from analyzer_tpu_torch.io.csv_codec import load_stream_csv

    get_registry().counter("migrate.fallbacks_total").add(1)
    return load_stream_csv(io.StringIO(data.decode("utf-8")))


class _BackfillFeed(_StreamFeed):
    """The producer side of :func:`rate_backfill`: ``rate_stream``'s feed
    over the growing decode buffers, with the fillers already placed by the
    assigner, windows wholly below ``start_step`` skipped (resume) and
    emission ending at the first boundary at or past ``stop_after``."""

    def __init__(self, view, b, spc, team, pad_row, fuse, collect, pin,
                 poll_interval, tier, front, start_step, stop_after):
        super().__init__(view, b, spc, team, pad_row, fuse, collect, pin,
                         poll_interval, tier,
                         fillers=np.empty(0, np.int64))
        self.front = front  # the front-half thread (started by the engine)
        self.start_step = start_step
        self.stop_after = stop_after
        self.stopped = False
        self.n_final = 0

    def done(self) -> bool:
        return self._assigner_done

    def mark_done(self, err: BaseException | None) -> None:
        with self._cv:
            self._assigner_err = err
            self._assigner_done = True
            self._cv.notify_all()

    def _emit_to(self, put, e1: int) -> bool:
        """Emits steps [emitted, e1) unless the bounded run has ended;
        returns False once it has."""
        if self.stop_after is not None and self.emitted >= self.stop_after:
            self.stopped = True
            return False
        if e1 <= self.start_step:
            self.emitted = e1  # below the resume watermark: no work
        else:
            self._emit(put, e1)
        return True

    @thread_role("consumer")
    def produce(self, put) -> None:
        try:
            while True:
                done = self._assigner_done  # read BEFORE consuming progress
                self._scatter_new(int(self.progress[0]))
                advanced = False
                while self.watermark - self.emitted >= self.spc:
                    if not self._emit_to(put, self.emitted + self.spc):
                        return
                    advanced = True
                if done:
                    break
                if not advanced:
                    with self._cv:
                        if (not self._assigner_done
                                and self.done_m == int(self.progress[0])):
                            self._begin_wait()
                            self._cv.wait(self.poll_interval)
        finally:
            self._end_wait()
        self.front.join()
        if self._assigner_err is not None:
            raise RuntimeError(
                "streaming decode/assignment failed"
            ) from self._assigner_err
        n = int(self.progress[0])
        self._scatter_new(n)
        if self.done_m != n:  # after join() every entry must be visible
            raise RuntimeError(f"assignment visible up to {self.done_m} of {n}")
        s_total = max(int(self.progress[1]), 1)
        self._grow(s_total)
        while self.emitted < s_total:
            if not self._emit_to(put, min(self.emitted + self.spc, s_total)):
                return
        self.s_total = s_total
        self.n_final = n


def rate_backfill(
    state,
    data: bytes,
    cfg,
    collect: bool = False,
    batch_size: int | None = None,
    steps_per_chunk: int | None = None,
    team_size: int | None = None,
    window_rows: int = DEFAULT_WINDOW_ROWS,
    plan_windows: int | None = None,
    mode_names=None,
    arena=None,
    prefetch_depth: int | None = None,
    assign_native: bool | None = None,
    kernel: str = "reference",
    fuse_window: int | None = None,
    fuse_max_rows: int | None = None,
    fuse_backend: str | None = None,
    hot_rows: int = 0,
    staging=None,
    ids=None,
    on_chunk=None,
    start_step: int = 0,
    stop_after: int | None = None,
    expected_fingerprint: str | None = None,
    fingerprint_out: dict | None = None,
    admission=None,
    live_backlog=None,
    throttle_poll_s: float = 0.002,
    poll_interval: float = 0.002,
    stats_out: dict | None = None,
):
    """Rates a raw CSV byte stream on the device of ``state.table`` with
    decode, assignment, staging and dispatch overlapped. Returns ``(state,
    outputs)`` like the runners (a new state; the caller's stays valid).

    ``staging`` is the STAGING-lineage view publisher the backfill
    publishes throttled snapshots into, plus an unthrottled final publish
    carrying ``ids`` — never a live lineage. ``admission`` (an
    :class:`~analyzer_tpu_torch.service.broker.AdmissionController`) and
    ``live_backlog`` (a zero-argument callable: live messages waiting) gate
    every chunk's dispatch: a live backlog or a zero quota pauses the
    consumer, which backpressures the feed ring and with it the backfill's
    staging and host-to-device copies (decode runs ahead into the
    preallocated buffers). Each pause is counted in
    ``migrate.throttled_total``; each time the controller halves the window
    (its telemetry read as host pressure) in ``migrate.admission_halvings_total``
    and ``stats_out['admission_halvings']``. Give the engine its OWN
    controller: ``quota`` consumes telemetry deltas.

    ``start_step`` / ``stop_after`` / ``expected_fingerprint`` are the
    resume protocol: the front half always re-derives the full schedule
    from the bytes, windows wholly at or below ``start_step`` skip staging
    and dispatch, and the fingerprint — published into
    ``fingerprint_out['fingerprint']`` before the first dispatch — must
    equal the checkpoint's. ``stop_after`` ends the run at a window
    boundary at or after that step.

    ``plan_windows`` (default :data:`DEFAULT_PLAN_WINDOWS`) decode windows
    are consumed on the caller's thread before the batch size commits.
    ``assign_native`` forces the assigner route (True: the native loop,
    False: the python oracle, None: the router chooses).

    ``kernel`` / ``fuse_*`` / ``hot_rows`` / ``prefetch_depth`` /
    ``collect`` / ``on_chunk`` mirror :func:`~analyzer_tpu_torch.sched.
    runner.rate_stream`. On bytes the columnar decoder cannot take (quoted
    fields, or no g++ for the scanner) the engine falls back to the python
    decode and ``rate_stream`` — the same results, counted in
    ``migrate.fallbacks_total``, and resume is refused there (the streamed
    schedule is the resume contract)."""
    fuse = resolve_fuse(kernel, fuse_window, fuse_max_rows, fuse_backend)
    if hot_rows < 0:
        raise ValueError(f"hot_rows must be >= 0, got {hot_rows}")
    if start_step and collect:
        raise ValueError(
            "collect=True is not supported on a resumed run — per-match "
            "outputs below the resume watermark were produced (and "
            "discarded) by the interrupted run; collect on the full run "
            "or re-rate from scratch"
        )
    check_seed_cfg(state, cfg)
    team = team_size or MAX_TEAM_SIZE
    prog = get_migration_progress()
    prog.begin(resumed_from=start_step)
    reg = get_registry()
    tracer = get_tracer()
    t_start = time.perf_counter()

    decoder = ColumnarDecoder(
        data, mode_names, max_team=team, window_rows=window_rows, arena=arena,
    )
    if not decoder.available:
        if start_step or expected_fingerprint:
            raise ValueError(
                "cannot resume a migration on the python-codec fallback "
                "path (the streamed schedule is the resume contract); "
                "repair the stream for the columnar grammar or re-rate "
                "from scratch"
            )
        stream = _decode_fallback(data)
        stats: dict = {}
        state, outs = rate_stream(
            state, stream, cfg, collect=collect, batch_size=batch_size,
            steps_per_chunk=steps_per_chunk, view_publisher=staging,
            on_chunk=on_chunk, prefetch_depth=prefetch_depth, kernel=kernel,
            fuse_window=fuse_window, fuse_max_rows=fuse_max_rows,
            fuse_backend=fuse_backend, hot_rows=hot_rows, stats_out=stats,
        )
        if staging is not None and ids is not None:
            staging.publish_state(state, ids=ids)
        stats.update(streamed=False, matches=stream.n_matches)
        if stats_out is not None:
            stats_out.update(stats)
        prog.finish()
        return state, outs

    pad_row = state.pad_row
    tier = TierManager(state, hot_rows) if hot_rows else None
    if tier is not None and fuse is not None:
        fuse = tier.clamp_fuse(fuse)
    state = tier.hot_state() if tier is not None else state.clone()

    # One allocation per column, sized from the newline count (an upper
    # bound on rows: the header and a trailing newline only overshoot).
    with tracer.span("migrate.prepare", cat="migrate", part="buffers"):
        n_bound = data.count(b"\n") + 1
        pidx_buf = np.full((n_bound, 2, team), -1, np.int32)
        winner_buf = np.zeros(n_bound, np.int32)
        mode_buf = np.zeros(n_bound, np.int32)
        afk_buf = np.zeros(n_bound, bool)
    n_decoded = [0]

    def append(win) -> tuple[int, int]:
        lo = n_decoded[0]
        hi = lo + win.rows
        if hi > n_bound:  # the newline bound is an invariant of the grammar
            raise RuntimeError(f"decoded {hi} rows past the {n_bound}-row byte bound")
        pidx_buf[lo:hi] = win.player_idx
        winner_buf[lo:hi] = win.winner
        mode_buf[lo:hi] = win.mode_id
        afk_buf[lo:hi] = win.afk
        win.release()
        if hi > lo and int(pidx_buf[lo:hi].max()) >= pad_row:
            raise ValueError(
                f"stream references player row {int(pidx_buf[lo:hi].max())} "
                f"but the player table only has rows 0..{pad_row - 1}"
            )
        n_decoded[0] = hi
        prog.note_decoded(hi)
        return lo, hi

    # The planning prefix decodes on THIS thread: the batch-size choice is a
    # pure function of these bytes and the knobs (rate_stream sizes from
    # n/8 of a stream whose length is known; here it is not).
    k_plan = DEFAULT_PLAN_WINDOWS if plan_windows is None else int(plan_windows)
    if k_plan < 1:
        raise ValueError(f"plan_windows must be >= 1, got {plan_windows}")
    win_iter = decoder.windows()
    prefix_windows = 0
    for _ in range(k_plan):
        win = next(win_iter, None)
        if win is None:
            break
        append(win)
        prefix_windows += 1
    n0 = n_decoded[0]
    native_route = (assign_native if assign_native is not None
                    else assign_native_available())
    if n0 == 0:
        if stats_out is not None:
            stats_out.update(
                n_steps=0, batch_size=0, occupancy=0.0, matches=0,
                streamed=True, ttfd_s=None, plan_windows=k_plan,
                prefix_windows=prefix_windows, prefix_rows=0,
                assign_native=native_route, admission_halvings=0,
            )
        if tier is not None:
            state = tier.finish(state.table)
        if staging is not None:
            staging.publish_state(state, ids=ids)
        prog.finish()
        return state, (_gather_outputs([], np.empty(0, np.int32), 0, team)
                       if collect else None)
    if batch_size is None:
        b = choose_batch_size_streamed(
            MatchStream(pidx_buf[:n0], winner_buf[:n0], mode_buf[:n0],
                        afk_buf[:n0]),
            prefix=n0,
        )
    else:
        b = batch_size
    spc = steps_per_chunk or min(8192, max(256, -(-n_bound // b) // 8 or 1))
    with tracer.span("migrate.prepare", cat="migrate", part="fingerprint"):
        fingerprint = migration_fingerprint(
            data, b, spc, plan_windows=k_plan, window_rows=window_rows
        )
    if fingerprint_out is not None:
        fingerprint_out["fingerprint"] = fingerprint
    if expected_fingerprint is not None and fingerprint != expected_fingerprint:
        raise ValueError(
            "checkpoint was taken mid-migration but the derived schedule "
            "no longer matches (stream bytes, batch size, or chunking "
            "changed); re-rate from scratch or fix the input"
        )
    if start_step and start_step % spc:
        # Mid-run checkpoints are taken at window boundaries only; anything
        # else would make the first resumed window straddle the watermark.
        raise ValueError(
            f"start_step {start_step} is not a window boundary "
            f"(steps_per_chunk={spc}); resume from the checkpoint's own "
            "step cursor"
        )

    stop_flag = [False]
    view = MatchStream(pidx_buf, winner_buf, mode_buf, afk_buf)  # shares the buffers

    @thread_role("producer")
    def front() -> None:
        """The front-half thread: decode window -> append -> assign until
        the stream ends (or the run stopped). The native assigner releases
        the GIL for each window; the feed's ``poll_interval`` wait covers
        the gap where no python-side wakeup can fire."""
        err = None
        try:
            if n_decoded[0]:
                assign_window(0, n_decoded[0])
            for win in win_iter:
                if stop_flag[0]:  # a bounded run ended: stop decoding
                    win.release()
                    break
                lo, hi = append(win)
                assign_window(lo, hi)
            assigner.finish()
        except BaseException as e:  # noqa: BLE001 — re-raised on the feed thread
            err = e
        finally:
            feed.mark_done(err)

    front_thread = threading.Thread(target=front, name="migrate-front", daemon=True)
    with tracer.span("migrate.prepare", cat="migrate", part="feed"):
        feed = _BackfillFeed(
            view, b, spc, team, pad_row, fuse, collect, state.table.is_cuda,
            poll_interval, tier, front_thread, start_step, stop_after,
        )
        assigner = IncrementalAssigner(
            b, feed.out_b, feed.out_s, feed.progress, on_progress=feed._notify,
            native=assign_native,
        )
    # The front half's route is an operator signal: a gauge for scrapes,
    # the progress block for /statusz, stats for the bench line.
    reg.gauge("migrate.assign_native").set(assigner.is_native)
    prog.note_assign_backend(assigner.is_native)

    def assign_window(lo: int, hi: int) -> None:
        with tracer.span("migrate.assign", cat="migrate", start=lo):
            assigner.feed(pidx_buf, mode_buf, afk_buf, lo, hi)
        reg.counter("migrate.assign_matches_total").add(hi - lo)
        prog.note_assigned(assigner.n_assigned)

    throttled = reg.counter("migrate.throttled_total")
    halved = reg.counter("migrate.admission_halvings_total")
    ttfd = [None]
    halvings = [0]

    def admit(_start: int) -> None:
        """The dispatch-side admission gate: a live backlog (quota 0) pauses
        the consumer until the controller opens a slot; a halved window is
        the controller reading its telemetry as host pressure (counted).
        The controller never returns 0 on a drained live plane, so the
        backfill cannot starve forever."""
        if admission is not None:
            while True:
                ready = int(live_backlog()) if live_backlog is not None else 0
                # The JAX engine asks for a quota of 1, where a halving
                # (max(1, 1 // 2)) and a full window look alike; asking for
                # 2 admits on exactly the same verdicts (quota > 0) and
                # makes a halving visible as a quota of 1.
                quota = admission.quota(ready, 2)
                if quota == 1:
                    halvings[0] += 1
                    halved.add(1)
                if quota > 0:
                    break
                throttled.add(1)
                time.sleep(throttle_poll_s)
        if ttfd[0] is None:
            ttfd[0] = time.perf_counter() - t_start

    def on_dispatched(start: int, stop: int) -> None:
        reg.counter("migrate.steps_total").add(stop - start)
        reg.counter("migrate.windows_total").add(1)
        prog.note_dispatched(stop, 0)
        total = int(feed.progress[1])
        if feed.done() and total:
            prog.set_total_steps(total)

    front_thread.start()
    try:
        state, outs, fused_flat, totals = _consume(
            feed.produce, state, pad_row, cfg, fuse, collect, on_chunk,
            prefetch_depth, tier, staging, end_step=lambda: feed.emitted,
            admit=admit, on_dispatched=on_dispatched, final_publish=False,
        )
    finally:
        stop_flag[0] = True
        feed._notify()
        front_thread.join()
        assigner.close()  # releases the native handle (no-op in python)

    stopped = feed.stopped
    n_final = feed.n_final if not stopped else int(feed.progress[0])
    s_total = feed.s_total if feed.s_total is not None else feed.emitted
    if not stopped:
        reg.counter("migrate.matches_total").add(n_final)
    if s_total:
        prog.set_total_steps(s_total)
    if staging is not None and not stopped:
        prog.note_publishing()
        with tracer.span("migrate.publish", cat="migrate", start=s_total):
            staging.publish_state(state, ids=ids)
    occupancy = n_final / (s_total * b) if s_total else 0.0
    if stats_out is not None:
        stats_out.update(
            n_steps=s_total, batch_size=b, steps_per_chunk=spc,
            occupancy=occupancy, matches=n_final, streamed=True,
            stopped=stopped,
            emitted_steps=feed.emitted, ttfd_s=ttfd[0],
            fingerprint=fingerprint, window_rows=window_rows,
            plan_windows=k_plan, prefix_windows=prefix_windows,
            prefix_rows=n0, assign_native=assigner.is_native,
            admission_halvings=halvings[0],
        )
        if fuse is not None:
            stats_out.update(totals)
    if stopped:
        # A bounded run's partial state: usable through the checkpoint the
        # caller's on_chunk took at the stop boundary.
        prog.note_dispatched(feed.emitted, 0)
        return state, None
    prog.finish()
    if not collect:
        return state, None
    flat_idx = (_flat(fused_flat) if fused_flat is not None
                else feed.slot_map[: s_total * b])
    return state, _gather_outputs(outs, flat_idx, n_final, team)


@dataclasses.dataclass
class MigrationReport:
    """One migration run's outcome (:func:`run_migration`)."""

    state: object
    outputs: object
    stats: dict
    view: object = None
    cutover_pause_ms: float | None = None
    finished: bool = True


def run_migration(
    state,
    data: bytes,
    cfg,
    lineage=None,
    ids=None,
    checkpoint: str | None = None,
    resume: bool = False,
    checkpoint_every: int | None = None,
    stop_after: int | None = None,
    do_cutover: bool = True,
    device=None,
    **engine_kw,
) -> MigrationReport:
    """The orchestrated migration: checkpoint / resume around
    :func:`rate_backfill`, the staging-lineage publish and the atomic
    cutover (``cli migrate``'s core, reused by the soak and the bench).

    ``lineage`` is a :class:`~analyzer_tpu_torch.migrate.lineage.
    LineageManager` over the LIVE plane's publisher: ``begin`` runs here,
    the backfill publishes into the staging lineage, and when the run
    finished and ``do_cutover``, traffic cuts over atomically. A bounded
    (``stop_after``) or failed run never touches the live lineage; the
    checkpoint written at the stop boundary is the resume point.
    ``device`` places the state a resume loads from ``checkpoint`` (None:
    the card)."""
    from analyzer_tpu_torch.io.checkpoint import (
        CheckpointWriter,
        load_checkpoint,
        save_checkpoint,
    )

    prog = get_migration_progress()
    tracer = get_tracer()
    start_step = 0
    expected_fp = None
    if resume:
        if not checkpoint:
            raise ValueError("resume=True requires a checkpoint path")
        ck = load_checkpoint(checkpoint, device=device)
        state = ck.state
        start_step = ck.step_cursor
        expected_fp = ck.schedule_fingerprint
    staging = lineage.begin() if lineage is not None else None
    writer = (
        CheckpointWriter(checkpoint)
        if checkpoint and (checkpoint_every or stop_after is not None)
        else None
    )
    fp_holder: dict = {}
    last_saved = [start_step]

    def on_chunk(st, next_step):
        due = (checkpoint_every is not None
               and next_step - last_saved[0] >= checkpoint_every)
        at_stop = stop_after is not None and next_step >= stop_after
        if not (due or at_stop):
            return
        last_saved[0] = next_step
        with tracer.span("migrate.checkpoint", cat="migrate", step=next_step):
            writer.save(
                st, cursor=0, step_cursor=next_step,
                schedule_fingerprint=fp_holder.get("fingerprint"),
            )

    stats: dict = {}
    try:
        final_state, outputs = rate_backfill(
            state, data, cfg, staging=staging, ids=ids,
            start_step=start_step, stop_after=stop_after,
            expected_fingerprint=expected_fp, fingerprint_out=fp_holder,
            on_chunk=on_chunk if writer is not None else None,
            stats_out=stats, **engine_kw,
        )
    except BaseException as e:
        prog.fail(repr(e))
        if lineage is not None:
            lineage.abort()
        raise
    finally:
        if writer is not None:
            writer.close()
    finished = not stats.get("stopped", False)
    if checkpoint and finished:
        with tracer.span("migrate.checkpoint", cat="migrate", step=0,
                         final=True):
            save_checkpoint(
                checkpoint, final_state, cursor=stats.get("matches", 0),
                step_cursor=0,
                schedule_fingerprint=fp_holder.get("fingerprint"),
            )
    view = None
    pause_ms = None
    if lineage is not None:
        if finished and do_cutover:
            view = lineage.cutover()
            pause_ms = round((lineage.cutover_pause_s or 0.0) * 1e3, 3)
        elif not finished:
            lineage.abort()
    return MigrationReport(
        state=final_state, outputs=outputs, stats=stats, view=view,
        cutover_pause_ms=pause_ms, finished=finished,
    )
