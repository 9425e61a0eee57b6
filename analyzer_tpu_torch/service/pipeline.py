"""Pipelined service loop: overlap host work with the device round trip.

The sequential worker (``Worker.process``) is the reference's shape —
load, encode, rate, write back, commit, one batch at a time
(the reference ``worker.py:95-199``); the device round trip of each batch
(rate, then fetch the packed outputs) leaves the host idle. This engine
keeps the per-batch failure policy while hiding that round trip behind
the NEXT batch's host work (the port's copy of
``analyzer_tpu.service.pipeline``):

  * **Device-side prior chaining** breaks the fetch -> encode dependency.
    Batch N+1's priors normally come from the store, which doesn't have
    batch N's posteriors until N's outputs are fetched and committed.
    Instead, N+1 is encoded from a (stale-by-<=lag) store snapshot and its
    player table is PATCHED ON DEVICE from the final device-resident
    tables of the in-flight batches, held in a ``[lag, rows, W]`` ring:
    ONE gather + scatter applies the whole chain (``_chain_patch_``),
    keyed by player-id overlap computed on the host from the encoders'
    ``row_of`` maps. Only the 14 rating columns
    copy — seeds derive from static features the worker never writes,
    and the destination batch's are fresher. The posterior never visits
    the host on the critical path.
  * **Async D2H at dispatch**: each chunk's packed outputs are copied
    into pinned host memory with ``non_blocking=True`` the moment the
    chunk is enqueued, and a CUDA event is recorded behind the copy on the
    consumer thread's current stream (the stream that issued it). The
    ordered writer waits on that event before it reads the buffer.
  * **An ordered writer thread** applies ``write_back`` + ``commit``
    strictly in batch order (players are shared across batches — the
    last-write-wins order must match the sequential loop) on its OWN
    store handle (``SqlStore.clone``; sqlite connections are bound to
    their creating thread).
  * **Main-thread harvest**: acks, notify/crunch/sew/telesuck fan-out,
    dead-lettering and failure fallback all stay on the consumer thread —
    the broker (pika especially) is not thread-safe.

Correctness argument (the induction ``tests/test_pipeline.py`` pins):

  With commit lag ``L``, a batch's store load happens only after batch
  ``N-L`` committed (the submit gate), so its snapshot is missing at most
  the writes of batches ``N-L+1..N`` — exactly the ones patched, in
  order, from their device-resident final tables. Patching from an
  already-committed batch is idempotent (the snapshot and the device
  table agree), so no per-batch commit bookkeeping is needed on the
  chaining side. Final ratings are bit-identical to the sequential loop.

  The chain patch writes only the ``n`` real pairs. The JAX package points
  unused pair slots at the destination's padding row and lets those
  duplicate writes race, because its pad row is garbage by design; in the
  port the pad row is a pinned fixed point (``core.update.scatter_rows_``
  re-pins it) and a duplicate-index ``index_put_`` on CUDA lands an
  arbitrary value, so the padding entries are never scattered. Pipelined
  and sequential tables are equal bit for bit, pad row included.

Buffer ownership: each batch's player table belongs to its encoder and is
rated in place there (never donated, never reused by a later batch), so
the table a job keeps for the serve plane cannot be written by a later
batch; the ring is the engine's own ``[lag, rows, 16]`` tensor, written
slot by slot with ``copy_``.

Failure policy (``worker.py:110-120`` semantics preserved):

  The writer processes batches in order; the FIRST failure poisons the
  stream. The failed batch surfaces to the worker's normal failure
  handler (dead-letter + nack after rollback); every later in-flight
  batch is ABORTED — its device results are discarded (they chained off
  uncommitted state the sequential loop would never have seen) and its
  messages are reprocessed from scratch through the sequential path
  against the rolled-back store. A failed batch therefore never acks
  later batches, and an aborted batch never commits tainted state.

Semantic caveats vs the strictly sequential loop (documented, tested
where cheap):

  * The reference's out-of-table skill-tier KeyError consults "has a
    shared rating yet?" (``rater.py:57-60``); under chaining that check
    runs against the stale snapshot. A PoisonError raised during a
    pipelined encode is therefore retried ONCE from fully-drained
    committed state before the worker's poison isolation path engages.
  * Static seed features (rank_points/skill_tier) are read at load time;
    a concurrent external writer changing them can land one batch later
    than in the sequential loop — the reference has the same race across
    its competing consumers (SURVEY.md section 3.2).
"""


from __future__ import annotations

import dataclasses
import threading
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from analyzer_tpu_torch.core.state import MU_LO, SIGMA_HI, TABLE_WIDTH
from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs import get_flight_recorder, get_registry, get_tracer
from analyzer_tpu_torch.obs.tracer import bind_trace, current_trace
from analyzer_tpu_torch.sched.feed import stage_chunk
from analyzer_tpu_torch.sched.runner import _Fetch, _gather_outputs, _reference_chunk_
from analyzer_tpu_torch.service.columnar import finalize
from analyzer_tpu_torch.utils.ownership import thread_role

logger = get_logger(__name__)

# Fallback commit lag when nothing was measured (engine constructed
# without a warmup probe and without an explicit PIPELINE_LAG): the JAX
# package's default, kept so both packages resolve the same lag from the
# same configuration.
DEFAULT_LAG = 6


def choose_pipeline_lag(rtt_s: float, host_s: float) -> int:
    """Commit lag from measured costs: enough in-flight batches that the
    dispatch->fetch round trip hides entirely behind host work.

    Steady state, one batch period ~= max(host_s, device_s): the fetch
    issued at batch N's dispatch must complete before the writer needs it,
    i.e. within ``lag`` batch periods — ``lag >= rtt / host`` — plus one
    period of slack for jitter. Clamped: the floor keeps one full RTT
    overlapped even when host work dominates; the ceiling bounds the
    failure blast radius and the unacked-message window
    (``ServiceConfig.prefetch_count``)."""
    from analyzer_tpu_torch.config import PIPELINE_MAX_LAG, PIPELINE_MIN_LAG

    if host_s <= 0:
        return PIPELINE_MAX_LAG
    lag = -(-rtt_s // host_s) + 1  # ceil + jitter slack
    return int(min(PIPELINE_MAX_LAG, max(PIPELINE_MIN_LAG, lag)))


class PipelineFallback(Exception):
    """Submit could not take the batch; the worker must harvest (to apply
    the pending failure policy) and run the batch sequentially."""


def pair_index_dtype(canon_rows: int):
    """int16 halves the per-batch pair upload; row/pad indices only
    exceed it under a far-over-default BATCHSIZE."""
    return np.int16 if canon_rows <= 32000 else np.int32


def chain_buffers(lag: int, canon_rows: int, device=None):
    """(ring, pairs, pair_dtype) for a chain of depth ``lag`` over
    ``canon_rows``-row canonical tables — the ONE owner of the ring
    shape and the pair index dtype, shared by ``Worker.warmup`` and
    ``PipelineEngine``. The ring lives on ``device``; ``pairs`` is the
    host buffer :func:`chain_pairs` fills."""
    dtype = pair_index_dtype(canon_rows)
    ring = torch.zeros((lag, canon_rows, TABLE_WIDTH), dtype=torch.float32,
                       device=device)
    pairs = np.zeros((3, canon_rows), dtype)
    return ring, pairs, dtype


def ring_put_(ring: torch.Tensor, slot: int, table: torch.Tensor) -> None:
    """Writes one batch's final table into ring slot ``slot``, in place.
    Rows past the table's keep stale values: only rows named by a chain
    pair (a player of that batch) are ever read."""
    ring[slot, : table.shape[0]].copy_(table)


def _chain_patch_(dst_table: torch.Tensor, ring: torch.Tensor,
                  pairs: torch.Tensor) -> None:
    """Applies the WHOLE chain in place from ``pairs`` ``[3, n]`` (ring
    slot, ring row, destination row): one gather + one scatter of the 14
    rating columns. Only real pairs are passed, and their destinations are
    UNIQUE by construction — the host deduplicates newest-entry-wins
    (:func:`chain_pairs`), which also gives the sequential oldest-first
    patch order's final values with no ordering inside the scatter."""
    slots, srcs, dsts = pairs.long()
    dst_table[dsts, MU_LO:SIGMA_HI] = ring[slots, srcs, MU_LO:SIGMA_HI]


def chain_pairs(chain, lag: int, dst_row_of: dict, dst_pad_row: int,
                canon_rows: int, dtype) -> np.ndarray:
    """Host half of the ring patch: ``[3, canon_rows]`` (slot, src row,
    dst row) with newest-first dedup per destination — the final value
    of applying the chain oldest-first is exactly the newest in-flight
    batch's row for each overlapping player. Unused capacity points at
    the destination padding row (the JAX package's layout, byte for byte;
    :func:`n_real_pairs` counts the entries before it)."""
    pairs = np.zeros((3, canon_rows), dtype)
    pairs[2, :] = dst_pad_row
    seen: set = set()
    n = 0
    for seq_e, row_of in reversed(chain):  # newest first
        slot = seq_e % lag
        for pid, r in row_of.items():
            d = dst_row_of.get(pid)
            if d is not None and d not in seen:
                seen.add(d)
                pairs[0, n] = slot
                pairs[1, n] = r
                pairs[2, n] = d
                n += 1
    return pairs


def n_real_pairs(pairs: np.ndarray, dst_pad_row: int) -> int:
    """How many leading entries of :func:`chain_pairs`'s output are real:
    every real destination is a player row, below the padding row."""
    return int(np.count_nonzero(pairs[2] != dst_pad_row))


class _LazyFetch:
    """Future-shaped handle that materializes the packed outputs on the
    CALLING (writer) thread. Each chunk's copy into pinned memory was
    issued at dispatch; ``result()`` waits on each chunk's event and
    unpacks the bytes into stream-ordered HistoryOutputs."""

    def __init__(self, fetches, flat_idx, n, team):
        self._args = (fetches, flat_idx, n, team)

    def result(self):
        fetches, flat_idx, n, team = self._args
        return _gather_outputs(
            [f.result() for f in fetches], flat_idx, n, team
        )


class _EmptyBatch:
    """Stand-in EncodedBatch for a batch whose ids loaded no matches —
    the reference's query returns no rows and the messages fall straight
    through to the ack loop (``worker.py:122-129``)."""

    matches: list = []

    def write_back(self, outs) -> None:  # pragma: no cover — trivial
        pass


@dataclasses.dataclass
class _Job:
    seq: int
    msgs: list
    enc: object  # EncodedBatch (or _EmptyBatch)
    fetch: Future  # -> HistoryOutputs (or None for _EmptyBatch)
    status: str = "inflight"  # -> ok | failed | aborted
    error: BaseException | None = None
    # The batch's FINAL device table (serve-plane publish source), held
    # only when the worker runs a ratings view. Published at harvest —
    # strictly AFTER the writer committed — so readers never see a
    # posterior the store might still roll back. The encoder owns it; no
    # later batch writes it.
    view_table: object = None
    # Trace id of the batch (None when unbound): the writer thread
    # re-binds it so batch.fetch/batch.write_back join the batch's spans.
    trace: str | None = None


class _Writer(threading.Thread):
    """Applies write_back + commit strictly in submit order on its own
    store handle. The first failure poisons the stream: every later job
    is aborted untouched (the worker reprocesses its messages)."""

    def __init__(self, store_factory) -> None:
        super().__init__(daemon=True, name="analyzer-pipeline-writer")
        # The store handle is created ON this thread (run()): sqlite
        # connections may only be used by their creating thread.
        self._store_factory = store_factory
        self.store = None
        self.jobs: deque[_Job] = deque()
        self.done: deque[_Job] = deque()
        self.cv = threading.Condition()
        self.left_seq = -1  # highest seq that has LEFT the writer
        self.poisoned = False
        self._active = False
        self._stop_requested = False

    @thread_role("any")
    def submit(self, job: _Job) -> None:
        with self.cv:
            self.jobs.append(job)
            self.cv.notify_all()

    @thread_role("any")
    def stop(self) -> None:
        with self.cv:
            self._stop_requested = True
            self.cv.notify_all()

    @thread_role("any")
    def wait_left(self, seq: int) -> bool:
        """Blocks until every job with ``seq' <= seq`` has left the
        writer (ok OR aborted). Returns False when the stream is
        poisoned OR the writer thread is dead (jobs can never leave a
        dead writer — without the liveness check this gate would hang
        the consumer forever) — either way the caller must go through
        harvest, which aborts stranded jobs for sequential
        reprocessing."""
        with self.cv:
            while self.left_seq < seq and not self.poisoned:
                if not self.is_alive():
                    return False
                self.cv.wait(0.1)
            return not self.poisoned

    @thread_role("any")
    def wait_idle(self) -> None:
        """Blocks until the queue is empty and nothing is mid-flight.
        Used by harvest after a failure: every queued job drains to
        ``done`` as aborted before the reset. A dead writer (store
        factory failure) can't drain — its stranded jobs are aborted
        here so the worker reprocesses their messages."""
        with self.cv:
            while self.jobs or self._active:
                if not self.is_alive():
                    while self.jobs:
                        job = self.jobs.popleft()
                        job.status = "aborted"
                        self.done.append(job)
                    self._active = False
                    break
                self.cv.wait(0.1)

    @thread_role("consumer")
    def run(self) -> None:
        try:
            self.store = self._store_factory()
        except Exception:
            # A dead writer must not hang every gate wait: poison the
            # stream so submit falls back to the sequential loop.
            logger.exception("pipeline writer store unavailable")
            get_flight_recorder().note("pipeline.writer_dead",
                                       why="store factory failed")
            with self.cv:
                self.poisoned = True
                self.cv.notify_all()
            return
        while True:
            with self.cv:
                while not self.jobs and not self._stop_requested:
                    self.cv.wait()
                if not self.jobs:
                    return  # stop requested, queue drained
                job = self.jobs.popleft()
                self._active = True
                poisoned = self.poisoned
            if poisoned:
                job.status = "aborted"
            else:
                try:
                    # Two spans, not one: fetch waits on the async D2H
                    # copies, write_back+commit is store work — the split
                    # is exactly the balance the lag auto-tuner reasons
                    # about (choose_pipeline_lag). The job's batch trace
                    # re-binds here (a no-op when none was bound).
                    with bind_trace(job.trace):
                        with get_tracer().span(
                            "batch.fetch", cat="pipeline", seq=job.seq
                        ):
                            outs = job.fetch.result()
                        with get_tracer().span(
                            "batch.write_back", cat="pipeline", seq=job.seq
                        ):
                            finalize(self.store, job.enc, outs)
                    job.status = "ok"
                except BaseException as err:  # noqa: BLE001 — policy boundary
                    job.status = "failed"
                    job.error = err
                    logger.error("pipeline writer: batch %d failed: %r",
                                 job.seq, err)
                    # Breadcrumb BEFORE the worker's harvest dumps the
                    # flight artifact: the writer thread is where the
                    # failure happened, and events.log should carry its
                    # seq + error next to the fetch spans.
                    get_flight_recorder().note(
                        "pipeline.writer_failure",
                        seq=job.seq, error=repr(err),
                    )
                    rollback = getattr(self.store, "rollback", None)
                    if rollback is not None:
                        try:
                            rollback()
                        except Exception:  # pragma: no cover — best effort
                            logger.exception("writer rollback failed")
            with self.cv:
                self.done.append(job)
                self._active = False
                if job.status == "failed":
                    self.poisoned = True
                else:
                    self.left_seq = job.seq
                self.cv.notify_all()


class PipelineEngine:
    """Drives the pipelined batch flow for a :class:`Worker`.

    The worker owns the broker and the failure policy; the engine owns
    dispatch ordering, the chaining state, the fetch pool and the writer.
    ``lag`` = max batches in flight past the last known commit. ``None``
    resolves from the worker's warmup-measured dispatch->fetch RTT and
    per-batch host time (:func:`choose_pipeline_lag`), else
    :data:`DEFAULT_LAG`; production passes ``ServiceConfig.pipeline_lag``
    (default None = auto, ``PIPELINE_LAG`` pins it). 1 degrades toward
    the sequential loop.
    """

    def __init__(self, worker, lag: int | None = None):
        self.worker = worker
        if lag is None:
            lag = worker.resolved_pipeline_lag()
        self.lag = max(1, int(lag))
        get_registry().gauge("worker.pipeline_lag").set(self.lag)
        store = worker.store
        clone = getattr(store, "clone", None)
        if clone is not None:
            clone().close()  # eager validation on the consumer thread:
            # an uncloneable store (in-memory sqlite) raises HERE, where
            # the worker can fall back to the sequential loop — not
            # asynchronously on the writer.
            factory = clone
        else:
            factory = lambda: store  # noqa: E731 — shared-object stores
        self.writer = _Writer(factory)
        self.writer.start()
        # Chaining sources: (seq, row_of) of the last `lag` dispatched
        # batches, newest last. The batches' final tables live
        # DEVICE-SIDE in a [lag, canon_rows, W] ring (slot = seq % lag),
        # so the whole chain applies in one gather + scatter
        # (_chain_patch_) instead of one per entry.
        self.chain: deque = deque(maxlen=self.lag)
        self._ring = None  # lazy: created at the first ringable batch
        self.seq = 0
        # One owner for the shape knobs: the worker (warmup and schedule
        # packing read the same attributes).
        self._canon_rows = worker._canon_rows
        self._pair_dtype = pair_index_dtype(self._canon_rows)

    # -- submission -------------------------------------------------------
    def submit(self, msgs: list) -> None:
        """Dispatches one message batch into the pipeline.

        Raises :class:`PipelineFallback` when the pipeline is poisoned
        (harvest must apply the failure policy first), or lets a
        PoisonError propagate after the drained retry (the worker's
        isolation path takes over)."""
        from analyzer_tpu_torch.service.encode import PoisonError

        w = self.worker
        # Gate: the store snapshot below must include every commit up to
        # seq - lag, so at most `lag` uncommitted batches need chaining.
        # The liveness check runs even when no waiting is needed — an
        # early-lag gate passes trivially, and enqueuing to a dead
        # writer would strand the batch's messages unacked forever.
        if not self.writer.is_alive() or not self.writer.wait_left(
            self.seq - self.lag
        ):
            raise PipelineFallback("pipeline poisoned or writer dead; "
                                   "harvest first")
        ids = [m.body.decode() for m in msgs]
        try:
            enc = self._encode_fresh(ids)
        except PoisonError:
            # The stale snapshot can mis-decide the reference's
            # seed-consulted KeyError gate (module docstring); retry once
            # from fully committed state before isolating.
            self.drain()
            if not self.worker.pipeline_enabled or not self.writer.is_alive():
                # The drain's harvest disabled the pipeline (dead
                # writer): this engine is orphaned — enqueuing to it
                # would strand the batch's messages unacked forever.
                raise PipelineFallback("pipeline disabled during drain")
            enc = self._encode_fresh(ids)
        n = len(enc.matches) if enc is not None else 0
        logger.info("processing batch of %s matches (pipelined)", n)
        if not n:
            self._enqueue(msgs, _EmptyBatch(), _done_future(None))
            return
        tracer = get_tracer()
        with tracer.span("batch.pack", cat="pipeline", matches=n):
            sched = w._bucketed_schedule(enc.stream, enc.state.pad_row)

        state = enc.state
        table = state.table  # the encoder's own tensor: rated in place
        if self.chain:
            with tracer.span(
                "batch.chain", cat="pipeline", depth=len(self.chain)
            ):
                pairs = chain_pairs(
                    self.chain, self.lag, enc.row_of, state.pad_row,
                    self._canon_rows, self._pair_dtype,
                )
                n_pairs = n_real_pairs(pairs, state.pad_row)
                if n_pairs:
                    _chain_patch_(
                        table, self._ring,
                        torch.from_numpy(pairs[:, :n_pairs]).to(table.device),
                    )
        # Chunked dispatch of SERVICE_STEP_CHUNK supersteps at a time, the
        # sequential loop's chunking. Nothing here waits on the device:
        # the span measures the enqueue, and each chunk's outputs start
        # their copy into pinned memory right behind its launches, so
        # device completion lands in the writer's batch.fetch span.
        dispatch_span = tracer.span(
            "batch.dispatch", cat="pipeline", seq=self.seq, matches=n,
            steps=sched.n_steps,
        )
        chunk = w._step_chunk
        fetches = []
        pin = table.is_cuda
        with dispatch_span, w.profiler.maybe_capture(
            context={"matches": n, "steps": sched.n_steps, "seq": self.seq}
        ):
            for s0 in range(0, sched.n_steps, chunk):
                s1 = min(s0 + chunk, sched.n_steps)
                views = stage_chunk(sched, s0, s1, pin).to_device(table.device)
                ys = _reference_chunk_(
                    table, sched.pad_row, views, w.rating_config, True
                )
                fetches.append(_Fetch(ys))
        flat_idx = sched.match_idx.reshape(-1)
        fetch = _LazyFetch(
            fetches, flat_idx, sched.n_matches, sched.team_size
        )
        view_table = table if w.view_publisher is not None else None
        rows = int(table.shape[0])
        if rows <= self._canon_rows:
            if self._ring is None:
                self._ring, _, _ = chain_buffers(
                    self.lag, self._canon_rows, table.device
                )
            ring_put_(self._ring, self.seq % self.lag, table)
            self.chain.append((self.seq, enc.row_of))
            self._enqueue(msgs, enc, fetch, view_table)
        else:
            # Defensive only — canon_rows is sized for the largest batch
            # the config can produce, so an over-bucket batch means the
            # sizing contract broke. It cannot ride the fixed-shape
            # ring; enqueue, then DRAIN so no later batch needs to chain
            # off it (one sequentialized batch, correctness intact).
            self._enqueue(msgs, enc, fetch, view_table)
            self.drain()

    def _encode_fresh(self, ids: list):
        """Load + encode (``Worker._encode_batch``, either lane) with the
        read-snapshot release. The consumer connection never commits in
        pipelined mode (the writer's clone does), so on MySQL a
        REPEATABLE READ snapshot pinned at the first SELECT would make
        every later load stale beyond the chain's ``lag`` window — the
        gate invariant requires each load to see commits up to
        ``seq - lag``. Rolling back after the rows are materialized
        forces the NEXT load to open a fresh snapshot (the same move
        ``asset_urls`` / ``_dead_letter`` make; no-op on sqlite). The
        rollback runs even when encode raises (poison) — the retry path
        must reload from a fresh snapshot too."""
        try:
            with get_tracer().span(
                "batch.encode", cat="pipeline", ids=len(ids)
            ):
                return self.worker._encode_batch(ids)
        finally:
            rollback = getattr(self.worker.store, "rollback", None)
            if rollback is not None:
                rollback()

    def _enqueue(
        self, msgs: list, enc, fetch: Future, view_table=None
    ) -> None:
        self.writer.submit(_Job(
            seq=self.seq, msgs=msgs, enc=enc, fetch=fetch,
            view_table=view_table,
            # Submit runs on the consumer thread inside the batch's
            # bind (Worker.try_process); capture it for the writer.
            trace=current_trace(),
        ))
        self.seq += 1
        self._update_inflight()

    def _update_inflight(self) -> None:
        """Pipeline-depth gauge: submitted batches not yet past the
        writer (the lag the chain ring is hiding right now)."""
        with self.writer.cv:
            left = self.writer.left_seq
        get_registry().gauge("worker.pipeline_inflight").set(
            max(0, self.seq - 1 - left)
        )

    # -- completion -------------------------------------------------------
    def harvest(self) -> None:
        """Applies completed jobs in order ON THE CONSUMER THREAD: acks +
        fan-out for successes, the worker's failure policy for the first
        failure, sequential reprocessing for aborted followers."""
        w = self.worker
        if not self.writer.is_alive():
            self.writer.wait_idle()  # recover jobs stranded by a dead writer
            # A dead writer never produces a `failed` job to reset the
            # poison (or to advance left_seq at all), so without this
            # every later flush would pay PipelineFallback + sequential
            # reprocessing forever — or hang on the submit gate.
            self.chain.clear()
            w._disable_pipeline("pipeline writer died")
        jobs = self._pop_done()
        if any(j.status == "failed" for j in jobs):
            # Every not-yet-processed job drains to `done` as aborted
            # before the reset — the poison flag must outlive them.
            self.writer.wait_idle()
            jobs += self._pop_done()
        reprocess: list[_Job] = []
        for job in jobs:
            if job.status == "ok":
                w.matches_rated += len(job.enc.matches)
                w.batches_ok += 1
                with bind_trace(job.trace):
                    if job.view_table is not None:
                        # Commit is durable (the writer finished this
                        # job): publish the batch's posteriors to the
                        # read plane before acking, mirroring the
                        # sequential lane's commit -> publish -> ack
                        # order. The bind makes the view.publish
                        # instant name this batch's trace.
                        w._publish_view(job.enc, job.view_table)
                    w._ack_batch(job.msgs)
            elif job.status == "failed":
                logger.error("pipelined batch failed: %s", job.error)
                w.batches_failed += 1
                w._dead_letter(job.msgs)
                # Chain state is tainted; the writer queue is empty
                # (wait_idle above), so the stream can restart cleanly.
                self.chain.clear()
                with self.writer.cv:
                    self.writer.poisoned = False
                    self.writer.left_seq = self.seq - 1
                    self.writer.cv.notify_all()
            else:  # aborted — chained off the failed batch; redo fresh
                reprocess.append(job)
        for job in sorted(reprocess, key=lambda j: j.seq):
            w._process_batch_sequential(job.msgs)
        self._update_inflight()

    def _pop_done(self) -> list:
        with self.writer.cv:
            jobs = sorted(self.writer.done, key=lambda j: j.seq)
            self.writer.done.clear()
        return jobs

    def drain(self) -> None:
        """Blocks until every submitted batch has left the writer, then
        harvests. Afterwards the store reflects every submitted batch (or
        its failure policy has been applied).

        The chain MUST clear here: callers commit through the store after
        a drain (sequential fallback, poison isolation), and a commit the
        chain never saw breaks patch idempotence — a later submit would
        overwrite those fresher rows with the chain's older device
        tables. Post-drain, a fresh load sees everything anyway."""
        self.writer.wait_left(self.seq - 1)  # False on poison: fall through
        self.writer.wait_idle()
        self.harvest()
        self.chain.clear()

    @property
    def idle(self) -> bool:
        with self.writer.cv:
            return (not self.writer.jobs and not self.writer.done
                    and not self.writer._active)

    def close(self) -> None:
        self.drain()
        self.writer.stop()
        self.writer.join(timeout=10)


def _done_future(value) -> Future:
    f: Future = Future()
    f.set_result(value)
    return f
