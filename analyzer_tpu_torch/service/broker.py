"""Message broker edge: in-memory queues plus an optional pika adapter.

The reference talks to RabbitMQ through pika 0.10's blocking API
(``worker.py:85-92``): durable queues, bounded prefetch, per-message
ack/nack, publish with headers. This module models exactly the subset the
worker needs, with an in-memory implementation for tests/embedded use and
a pika adapter that activates only when pika is importable (it is not a
baked dependency of this framework).

Partitioned ingest: :class:`PartitionedBroker` splits a logical queue into
partitions by player shard (:func:`partition_of`) with live / backfill
priority lanes, delivering live traffic in publish order; the
:class:`AdmissionController` decides how much backfill a poll may admit
behind live traffic (and gates the migration engine's dispatches);
:class:`AmqpPartitionedBroker` maps the same layout onto physical queues
of any broker (:func:`physical_queue`; :func:`make_partitioned_pika_broker`
over RabbitMQ), and :class:`PartitionSubscription` restricts a consumer to
its owned partitions.

The port's copy of ``analyzer_tpu.service.broker``: the same delivery
order, delivery tags and admission decisions for the same calls
(tests/test_torch_broker_partitioned.py).
"""

from __future__ import annotations

import dataclasses
import itertools
import zlib
from collections import deque
from typing import Protocol

from analyzer_tpu_torch.obs import get_registry


@dataclasses.dataclass
class Message:
    body: bytes
    headers: dict | None = None
    delivery_tag: int = 0


class Broker(Protocol):
    def declare_queue(self, name: str) -> None: ...

    def publish(self, queue: str, body: bytes, headers: dict | None = None) -> None: ...

    def publish_topic(
        self, exchange: str, routing_key: str, body: bytes
    ) -> None: ...

    def get(self, queue: str, limit: int) -> list[Message]: ...

    def ack(self, delivery_tag: int) -> None: ...

    def nack(self, delivery_tag: int, requeue: bool = False) -> None: ...

    def qsize(self, queue: str) -> int:
        """Best-effort ready-message depth of ``queue`` (excluding
        in-flight/unacked deliveries). Both shipped brokers have always
        had queue-depth access — the Protocol just omitted it, so the
        soak harness and the worker's ``broker.queue_depth`` gauge had
        nothing typed to call. The number is a SNAPSHOT (on AMQP it
        costs a passive-declare round trip), for backpressure
        visibility, never for control flow."""
        ...


class InMemoryBroker:
    """Queues as deques with unacked-message redelivery semantics: ``get``
    moves messages to an in-flight map; ``nack(requeue=True)`` or
    ``requeue_unacked`` (crash simulation) returns them, ``ack`` drops them
    — the delivery contract the reference relies on for crash recovery
    (SURVEY.md section 5.3)."""

    def __init__(self) -> None:
        self.queues: dict[str, deque[Message]] = {}
        self.topics: list[tuple[str, str, bytes]] = []
        self._unacked: dict[int, tuple[str, Message]] = {}
        self._tags = itertools.count(1)

    def declare_queue(self, name: str) -> None:
        self.queues.setdefault(name, deque())

    def publish(self, queue: str, body: bytes, headers: dict | None = None) -> None:
        self.declare_queue(queue)
        self.queues[queue].append(Message(body=body, headers=dict(headers or {})))

    def publish_topic(self, exchange: str, routing_key: str, body: bytes) -> None:
        self.topics.append((exchange, routing_key, body))

    def get(self, queue: str, limit: int) -> list[Message]:
        self.declare_queue(queue)
        out = []
        q = self.queues[queue]
        while q and len(out) < limit:
            msg = q.popleft()
            msg = dataclasses.replace(msg, delivery_tag=next(self._tags))
            self._unacked[msg.delivery_tag] = (queue, msg)
            out.append(msg)
        return out

    def ack(self, delivery_tag: int) -> None:
        self._unacked.pop(delivery_tag, None)

    def nack(self, delivery_tag: int, requeue: bool = False) -> None:
        entry = self._unacked.pop(delivery_tag, None)
        if entry and requeue:
            queue, msg = entry
            self.queues[queue].appendleft(msg)

    def requeue_unacked(self) -> None:
        """Simulates a consumer crash: the broker redelivers everything."""
        for queue, msg in list(self._unacked.values()):
            self.queues[queue].appendleft(msg)
        self._unacked.clear()

    def set_prefetch(self, prefetch: int) -> None:
        """No delivery bound to adjust in memory; recorded for tests."""
        self.prefetch = int(prefetch)

    def qsize(self, queue: str) -> int:
        return len(self.queues.get(queue, ()))



#: Priority-lane names (docs/ingest.md "Lane arbitration"): live match
#: traffic always outranks backfill/replay; the admission controller
#: decides how much backfill the host has headroom for.
LANE_LIVE = "live"
LANE_BACKFILL = "backfill"
_LANES = (LANE_LIVE, LANE_BACKFILL)


def partition_of(body: bytes, headers: dict | None, partitions: int) -> int:
    """The partition routing function. Publishers that know the match's
    home shard set an ``x-partition`` header from the mesh layout
    invariant (``row % S`` of a participating player — the same function
    the serve plane routes lookups by); headerless messages hash the
    body (crc32 — stable across processes and runs, unlike ``hash()``)
    so partitioning never depends on publisher cooperation."""
    if headers and "x-partition" in headers:
        return int(headers["x-partition"]) % partitions
    return zlib.crc32(body) % partitions


class AdmissionController:
    """Decides how many backfill messages a consumer poll may admit
    (docs/ingest.md "Lane arbitration").

    Strict live priority: any ready live message zeroes the backfill
    quota. With live drained, admission is gated on HOST headroom, read
    from the telemetry the pipeline already emits: a growing
    ``feed.starved_total`` means the device is outrunning the host —
    adding backfill decode/encode work would push live latency up — and
    a burst of ``tier.promotions_total`` means the H2D lane is busy
    moving hot-set pages, the same bandwidth a backfill batch's
    transfers would contend with. Either signal halves the open window
    instead of closing it (backfill must not starve forever); quiet
    telemetry admits the full remaining window. Decisions are pure
    functions of counter deltas, so a soak's admission sequence is
    deterministic per (seed, config)."""

    def __init__(
        self,
        registry=None,
        starve_threshold: int = 1,
        promote_threshold: int = 256,
    ) -> None:
        self._registry = registry
        self.starve_threshold = int(starve_threshold)
        self.promote_threshold = int(promote_threshold)
        self._last_starved: float | None = None
        self._last_promotes: float | None = None

    def quota(self, live_ready: int, limit: int) -> int:
        """Backfill messages admissible now, given ``live_ready`` live
        messages still waiting and ``limit`` slots of consumer room."""
        if limit <= 0:
            return 0
        reg = self._registry or get_registry()
        starved = reg.counter("feed.starved_total").value
        promotes = reg.counter("tier.promotions_total").value
        d_starved = (
            0.0 if self._last_starved is None else starved - self._last_starved
        )
        d_promotes = (
            0.0 if self._last_promotes is None
            else promotes - self._last_promotes
        )
        self._last_starved = starved
        self._last_promotes = promotes
        if live_ready > 0:
            return 0
        if (
            d_starved >= self.starve_threshold
            or d_promotes >= self.promote_threshold
        ):
            return max(1, limit // 2)
        return limit


class PartitionedBroker:
    """In-memory broker partitioned by player-shard with priority lanes
    — the wire-speed ingest edge (docs/ingest.md "Partition math").

    Each logical queue is ``partitions`` x ``(live, backfill)`` physical
    deques. Publish routes by :func:`partition_of` and stamps a
    per-logical-queue sequence number; ``get`` k-way-merges partition
    heads by that sequence, so with live-only traffic the delivery
    order — and every delivery tag — is EXACTLY
    :class:`InMemoryBroker`'s for the same publish sequence. That is
    the soak bit-identity contract: partitioning changes where messages
    WAIT (per-partition depth, backpressure, dead-letter attribution),
    never what order they are consumed in. Lanes are the one sanctioned
    reordering: backfill is admitted behind live by the
    :class:`AdmissionController`.

    Dead-lettering inherits partitioning for free: the worker
    republishes a poison message to ``<queue>_failed`` with its
    original headers, so the failed queue's per-partition depths name
    WHICH shard's traffic is poisoned (``partition_depths``).

    On AMQP the same layout maps to ``<queue>.p<k>`` physical queues;
    this in-memory implementation is the contract the adapter would
    have to meet (per-partition ``message_count``, seq-merged delivery).
    """

    def __init__(
        self,
        partitions: int = 1,
        lanes: bool = False,
        admission: AdmissionController | None = None,
    ) -> None:
        if partitions < 1:
            raise ValueError(f"partitions must be >= 1, got {partitions}")
        self.partitions = int(partitions)
        self.lanes = bool(lanes)
        self.admission = admission or (AdmissionController() if lanes else None)
        # queue -> [partition][lane] -> deque[(seq, Message)]
        self.queues: dict[str, list[dict[str, deque]]] = {}
        self.topics: list[tuple[str, str, bytes]] = []
        self._seq: dict[str, itertools.count] = {}
        self._unacked: dict[int, tuple[str, int, str, int, Message]] = {}
        self._tags = itertools.count(1)
        reg = get_registry()
        reg.gauge("broker.partitions").set(self.partitions)
        self._admitted = reg.counter("broker.backfill_admitted_total")
        self._throttled = reg.counter("broker.backfill_throttled_total")

    def declare_queue(self, name: str) -> None:
        if name not in self.queues:
            self.queues[name] = [
                {lane: deque() for lane in _LANES}
                for _ in range(self.partitions)
            ]
            self._seq[name] = itertools.count()

    def publish(self, queue: str, body: bytes, headers: dict | None = None) -> None:
        self.declare_queue(queue)
        h = dict(headers or {})
        lane = h.get("x-lane", LANE_LIVE) if self.lanes else LANE_LIVE
        if lane not in _LANES:
            lane = LANE_LIVE
        p = partition_of(body, h, self.partitions)
        self.queues[queue][p][lane].append(
            (next(self._seq[queue]), Message(body=body, headers=h))
        )

    def publish_topic(self, exchange: str, routing_key: str, body: bytes) -> None:
        self.topics.append((exchange, routing_key, body))

    def _pop_merged(
        self,
        queue: str,
        lane: str,
        limit: int,
        out: list,
        partitions=None,
    ) -> None:
        """Moves up to ``limit - len(out)`` messages of ``lane`` into
        ``out`` in global sequence order (smallest head across the
        partitions first — requeued messages keep their original seq,
        so a redelivery outranks everything published after it).
        ``partitions`` restricts the merge to a subset of partition
        indices (a fabric worker's owned frontier); None means all."""
        parts = self.queues[queue]
        span = range(self.partitions) if partitions is None else partitions
        while len(out) < limit:
            best = None
            for p in span:
                q = parts[p][lane]
                if q and (best is None or q[0][0] < parts[best][lane][0][0]):
                    best = p
            if best is None:
                return
            seq, msg = parts[best][lane].popleft()
            msg = dataclasses.replace(msg, delivery_tag=next(self._tags))
            self._unacked[msg.delivery_tag] = (queue, best, lane, seq, msg)
            out.append(msg)

    def get(self, queue: str, limit: int, partitions=None) -> list[Message]:
        self.declare_queue(queue)
        out: list[Message] = []
        self._pop_merged(queue, LANE_LIVE, limit, out, partitions)
        room = limit - len(out)
        if self.lanes and room > 0:
            live_left = self.lane_size(queue, LANE_LIVE, partitions)
            quota = (
                self.admission.quota(live_left, room)
                if self.admission is not None else room
            )
            quota = min(quota, room)
            before = len(out)
            self._pop_merged(
                queue, LANE_BACKFILL, before + quota, out, partitions
            )
            admitted = len(out) - before
            if admitted:
                self._admitted.add(admitted)
            waiting = self.lane_size(queue, LANE_BACKFILL, partitions)
            if waiting and quota < room:
                self._throttled.add(min(waiting, room - quota))
        return out

    def ack(self, delivery_tag: int) -> None:
        self._unacked.pop(delivery_tag, None)

    def nack(self, delivery_tag: int, requeue: bool = False) -> None:
        entry = self._unacked.pop(delivery_tag, None)
        if entry and requeue:
            queue, p, lane, seq, msg = entry
            self.queues[queue][p][lane].appendleft((seq, msg))

    def requeue_unacked(self) -> None:
        """Simulates a consumer crash: the broker redelivers everything
        (each message back at its partition/lane head, original seq —
        the merge restores global order). Returned highest-seq-first so
        every deque stays seq-ascending head to tail."""
        entries = sorted(self._unacked.values(), key=lambda e: -e[3])
        for queue, p, lane, seq, msg in entries:
            self.queues[queue][p][lane].appendleft((seq, msg))
        self._unacked.clear()

    def set_prefetch(self, prefetch: int) -> None:
        """No delivery bound to adjust in memory; recorded for tests."""
        self.prefetch = int(prefetch)

    def lane_size(self, queue: str, lane: str, partitions=None) -> int:
        """Ready depth of one lane across every partition (or the given
        subset of partition indices)."""
        parts = self.queues.get(queue)
        if parts is None:
            return 0
        span = range(self.partitions) if partitions is None else partitions
        return sum(len(parts[p][lane]) for p in span)

    def qsize(self, queue: str, partitions=None) -> int:
        """AGGREGATE ready depth across all partitions and lanes — the
        number a single-queue broker would report, so existing
        ``broker.queue_depth`` consumers (worker gauge, soak sampler)
        keep meaning the same thing."""
        return sum(self.lane_size(queue, lane, partitions) for lane in _LANES)

    def partition_depths(self, queue: str) -> dict[int, dict[str, int]]:
        """Per-partition, per-lane ready depths — the skew surface the
        worker samples into ``broker.queue_depth{queue=,partition=,
        lane=}`` series (bounded by the registry's label-cardinality
        cap) and /statusz renders for the hot-partition runbook."""
        parts = self.queues.get(queue)
        if parts is None:
            return {}
        return {
            p: {lane: len(parts[p][lane]) for lane in _LANES}
            for p in range(self.partitions)
        }


def physical_queue(queue: str, partition: int, lane: str) -> str:
    """The partition x lane -> physical AMQP queue naming contract
    (docs/ingest.md "Partition math"): logical queue ``q`` with ``P``
    partitions and priority lanes maps onto ``q.p<k>.{live,backfill}``
    physical queues. The in-memory :class:`PartitionedBroker` documents
    the delivery semantics this layout must reproduce; the adapter that
    reproduces them over any real broker is
    :class:`AmqpPartitionedBroker`."""
    return f"{queue}.p{partition}.{lane}"


class AmqpPartitionedBroker:
    """:class:`PartitionedBroker`'s layout mapped onto PHYSICAL queues of
    an underlying broker — the backfill lane on a real AMQP server.

    ``base`` is any :class:`Broker` (the pika adapter in production; an
    :class:`InMemoryBroker` standing in for the AMQP server under test —
    the stub-backed parity suite, tests/test_torch_broker_partitioned.py). Every logical
    queue becomes ``partitions x 2`` physical queues named by
    :func:`physical_queue`; publish routes by :func:`partition_of` and
    the ``x-lane`` header and stamps a per-logical-queue ``x-seq``
    header, and ``get`` k-way-merges the partition heads by that seq —
    live lane first, backfill admitted behind it by the
    :class:`AdmissionController`, exactly the in-memory contract.

    Two honest deviations from the in-memory broker, both inherent to a
    real server: (1) the seq merge is exact over messages the server has
    DELIVERED — a partition whose smaller-seq message is still in
    network flight can be overtaken within one poll (at-least-once
    consumers already tolerate reordering at that granularity); (2)
    ``x-seq`` is stamped per publishing process — multiple publishers
    interleave by arrival, like any AMQP fan-in. Messages with no
    ``x-seq`` (a foreign publisher) merge by arrival order.

    Delivery tags are the base broker's own, so ack/nack/redelivery
    semantics — including the pika adapter's reconnect discipline —
    pass straight through.
    """

    def __init__(
        self,
        base,
        partitions: int = 1,
        lanes: bool = False,
        admission: AdmissionController | None = None,
    ) -> None:
        if partitions < 1:
            raise ValueError(f"partitions must be >= 1, got {partitions}")
        self.base = base
        self.partitions = int(partitions)
        self.lanes = bool(lanes)
        self.admission = admission or (AdmissionController() if lanes else None)
        self._declared: set[str] = set()
        self._seq: dict[str, itertools.count] = {}
        self._arrival = itertools.count(1 << 60)  # foreign-publisher order
        # (logical queue, partition, lane) -> locally buffered heads
        # (pulled from the base broker, not yet merged out).
        self._heads: dict[tuple, deque[Message]] = {}
        reg = get_registry()
        reg.gauge("broker.partitions").set(self.partitions)
        self._admitted = reg.counter("broker.backfill_admitted_total")
        self._throttled = reg.counter("broker.backfill_throttled_total")

    def _lanes_of(self) -> tuple:
        return _LANES if self.lanes else (LANE_LIVE,)

    def declare_queue(self, name: str) -> None:
        if name in self._declared:
            return
        self._declared.add(name)
        self._seq.setdefault(name, itertools.count())
        for p in range(self.partitions):
            for lane in _LANES:
                # Both lanes always exist physically: a backfill
                # publisher must never race queue creation mid-migration.
                self.base.declare_queue(physical_queue(name, p, lane))

    def publish(self, queue: str, body: bytes, headers: dict | None = None) -> None:
        self.declare_queue(queue)
        h = dict(headers or {})
        lane = h.get("x-lane", LANE_LIVE) if self.lanes else LANE_LIVE
        if lane not in _LANES:
            lane = LANE_LIVE
        p = partition_of(body, h, self.partitions)
        h["x-seq"] = next(self._seq[queue])
        self.base.publish(physical_queue(queue, p, lane), body, headers=h)

    def publish_topic(self, exchange: str, routing_key: str, body: bytes) -> None:
        self.base.publish_topic(exchange, routing_key, body)

    def _head(self, queue: str, p: int, lane: str) -> deque:
        return self._heads.setdefault((queue, p, lane), deque())

    def _pull(self, queue: str, lane: str, limit: int, partitions=None) -> None:
        """Tops up each partition's local head buffer from the base
        broker so the merge can see every partition's frontier. Each
        buffer is kept seq-sorted: a nacked-with-requeue message
        re-enters at the BASE queue's head, so a later pull can hand it
        back while larger-seq messages already sit buffered — the sort
        restores the per-partition ascending order the k-way merge
        assumes (a redelivery outranks everything published after it,
        the in-memory broker's contract). ``partitions`` restricts the
        pull to a subset of partition indices; None means all."""
        span = range(self.partitions) if partitions is None else partitions
        for p in span:
            buf = self._head(queue, p, lane)
            want = limit - len(buf)
            if want > 0:
                got = self.base.get(physical_queue(queue, p, lane), want)
                if got:
                    buf.extend(got)
                    if len(buf) > len(got) or len(got) > 1:
                        ordered = sorted(buf, key=self._seq_of)
                        buf.clear()
                        buf.extend(ordered)

    def _seq_of(self, msg: Message) -> int:
        seq = (msg.headers or {}).get("x-seq")
        if seq is None:
            # Foreign publisher: assign (and STAMP — the number must be
            # stable across repeated sorts/merges) an arrival-order seq.
            seq = next(self._arrival)
            if msg.headers is None:
                msg.headers = {}
            msg.headers["x-seq"] = seq
        return int(seq)

    def _pop_merged(
        self,
        queue: str,
        lane: str,
        limit: int,
        out: list,
        partitions=None,
    ) -> None:
        """Moves up to ``limit - len(out)`` buffered messages of ``lane``
        into ``out`` in global x-seq order (smallest head across the
        partitions first) — the in-memory broker's merge, over the
        heads the server has delivered."""
        self._pull(queue, lane, limit, partitions)
        span = range(self.partitions) if partitions is None else partitions
        while len(out) < limit:
            best = None
            best_seq = None
            for p in span:
                buf = self._heads.get((queue, p, lane))
                if not buf:
                    continue
                seq = self._seq_of(buf[0])
                if best_seq is None or seq < best_seq:
                    best, best_seq = p, seq
            if best is None:
                return
            out.append(self._heads[(queue, best, lane)].popleft())

    def get(self, queue: str, limit: int, partitions=None) -> list[Message]:
        self.declare_queue(queue)
        out: list[Message] = []
        self._pop_merged(queue, LANE_LIVE, limit, out, partitions)
        room = limit - len(out)
        if self.lanes and room > 0:
            live_left = self.lane_size(queue, LANE_LIVE, partitions)
            quota = (
                self.admission.quota(live_left, room)
                if self.admission is not None else room
            )
            quota = min(quota, room)
            before = len(out)
            self._pop_merged(
                queue, LANE_BACKFILL, before + quota, out, partitions
            )
            admitted = len(out) - before
            if admitted:
                self._admitted.add(admitted)
            waiting = self.lane_size(queue, LANE_BACKFILL, partitions)
            if waiting and quota < room:
                self._throttled.add(min(waiting, room - quota))
        return out

    def ack(self, delivery_tag: int) -> None:
        self.base.ack(delivery_tag)

    def nack(self, delivery_tag: int, requeue: bool = False) -> None:
        self.base.nack(delivery_tag, requeue=requeue)

    def requeue_unacked(self) -> None:
        """Crash simulation passthrough (stub-backed tests); a real AMQP
        base redelivers on channel death instead."""
        requeue = getattr(self.base, "requeue_unacked", None)
        if requeue is not None:
            requeue()

    def set_prefetch(self, prefetch: int) -> None:
        set_prefetch = getattr(self.base, "set_prefetch", None)
        if set_prefetch is not None:
            set_prefetch(int(prefetch))

    def lane_size(self, queue: str, lane: str, partitions=None) -> int:
        """Ready depth of one lane across every partition (or the given
        subset): the base broker's per-physical-queue depth plus locally
        buffered heads."""
        total = 0
        span = range(self.partitions) if partitions is None else partitions
        for p in span:
            total += self.base.qsize(physical_queue(queue, p, lane))
            total += len(self._heads.get((queue, p, lane), ()))
        return total

    def qsize(self, queue: str, partitions=None) -> int:
        """Aggregate ready depth across partitions and lanes — the same
        single number a one-queue broker reports (worker gauge, soak
        sampler)."""
        return sum(self.lane_size(queue, lane, partitions) for lane in _LANES)

    def partition_depths(self, queue: str) -> dict[int, dict[str, int]]:
        """Per-partition, per-lane ready depths — the /statusz skew
        surface, same shape as :meth:`PartitionedBroker.partition_depths`."""
        if queue not in self._declared:
            return {}
        return {
            p: {
                lane: (
                    self.base.qsize(physical_queue(queue, p, lane))
                    + len(self._heads.get((queue, p, lane), ()))
                )
                for lane in _LANES
            }
            for p in range(self.partitions)
        }


class PartitionSubscription:
    """A shard-owning worker's consumption window onto a partitioned
    broker (docs/fabric.md "Broker-partitioned ingest").

    In a fabric every host owns the shards ``s % n_hosts == host`` and,
    because ``partition_of == shard ownership`` (the publisher stamps
    ``x-partition`` with the match's home shard), exactly the same
    partitions. This wrapper implements the :class:`Broker` protocol
    over one broker with ``get``/depth restricted to those owned
    partition indices, so the :class:`~analyzer_tpu_torch.service.worker.
    Worker` stays partition-blind: it consumes "a broker" and the
    subscription decides which physical frontier that means.

    Publish passes through UNRESTRICTED — a dead-letter republish to
    ``<queue>_failed`` keeps the message's original ``x-partition``
    header, so poison traffic stays attributed to the owning shard even
    when the republishing host does not own it. Ack/nack/prefetch pass
    straight through (delivery tags are the wrapped broker's own).
    """

    def __init__(self, broker, partitions) -> None:
        owned = tuple(sorted({int(p) for p in partitions}))
        if not owned:
            raise ValueError("subscription needs at least one partition")
        total = int(broker.partitions)
        for p in owned:
            if not 0 <= p < total:
                raise ValueError(
                    f"partition {p} outside the broker's 0..{total - 1}"
                )
        self.broker = broker
        self.owned = owned
        self.partitions = total  # the LOGICAL layout, not the window

    def declare_queue(self, name: str) -> None:
        self.broker.declare_queue(name)

    def publish(self, queue: str, body: bytes, headers: dict | None = None) -> None:
        self.broker.publish(queue, body, headers=headers)

    def publish_topic(self, exchange: str, routing_key: str, body: bytes) -> None:
        self.broker.publish_topic(exchange, routing_key, body)

    def get(self, queue: str, limit: int) -> list[Message]:
        return self.broker.get(queue, limit, partitions=self.owned)

    def ack(self, delivery_tag: int) -> None:
        self.broker.ack(delivery_tag)

    def nack(self, delivery_tag: int, requeue: bool = False) -> None:
        self.broker.nack(delivery_tag, requeue=requeue)

    def requeue_unacked(self) -> None:
        requeue = getattr(self.broker, "requeue_unacked", None)
        if requeue is not None:
            requeue()

    def set_prefetch(self, prefetch: int) -> None:
        set_prefetch = getattr(self.broker, "set_prefetch", None)
        if set_prefetch is not None:
            set_prefetch(int(prefetch))

    def lane_size(self, queue: str, lane: str) -> int:
        return self.broker.lane_size(queue, lane, self.owned)

    def qsize(self, queue: str) -> int:
        """Ready depth of the OWNED partitions only — the worker's
        ``broker.queue_depth`` gauge then reports this host's actual
        backlog, which is what per-host burn attribution wants."""
        return self.broker.qsize(queue, self.owned)

    def partition_depths(self, queue: str) -> dict[int, dict[str, int]]:
        full = self.broker.partition_depths(queue)
        return {p: d for p, d in full.items() if p in self.owned}


def make_partitioned_pika_broker(
    uri: str,
    partitions: int = 1,
    lanes: bool = False,
    prefetch: int = 0,
    admission: AdmissionController | None = None,
):
    """The production composition: :class:`AmqpPartitionedBroker` over
    the pika adapter — ``<queue>.p<k>.{live,backfill}`` physical queues
    on a real RabbitMQ, with the in-memory broker's partition/lane
    delivery contract. Raises ImportError when pika is absent, like
    :func:`make_pika_broker`."""
    return AmqpPartitionedBroker(
        make_pika_broker(uri, prefetch=prefetch),
        partitions=partitions,
        lanes=lanes,
        admission=admission,
    )


def make_pika_broker(uri: str, prefetch: int = 0):
    """RabbitMQ adapter; raises ImportError when pika is absent.

    PUSH consumer with bounded prefetch and reconnect. The reference's
    broker edge is ``basic_qos(prefetch_count=BATCHSIZE)`` +
    ``basic_consume`` (``worker.py:91-92``): the server pushes up to
    ``prefetch`` unacked messages in one flow. The round-2 adapter
    instead issued one synchronous ``basic_get`` round-trip per message
    (500 network RTTs per batch) and never set QoS (VERDICT round-2
    missing #1). Here ``get()`` just pumps the ioloop non-blocking and
    drains a local buffer the consumer callback fills.

    Reconnect: on a connection/channel error, any operation reconnects
    once — new connection, durable queues redeclared, QoS re-applied,
    consumers re-subscribed (the reference has none of this; it dies).
    Deliveries that were buffered but unacked die with the old channel —
    the broker requeues them, preserving the same at-least-once contract
    the reference leans on. Delivery tags handed to the caller are
    SYNTHETIC (monotonic across reconnects): an ack/nack for a message
    from a dead channel is a silent no-op (the message is redelivered),
    never an ack of the wrong message on the new channel.
    """
    from analyzer_tpu_torch.logging_utils import get_logger

    import pika  # gated: not a baked dependency

    logger = get_logger(__name__)
    conn_errors = tuple(
        e
        for e in (
            getattr(pika.exceptions, name, None)
            for name in (
                "AMQPConnectionError", "AMQPChannelError", "ConnectionClosed",
                "ChannelClosed", "StreamLostError", "ChannelWrongStateError",
            )
        )
        if isinstance(e, type)
    ) or (ConnectionError,)

    class PikaBroker:
        def __init__(self, uri: str, prefetch: int) -> None:
            self._uri = uri
            self._prefetch = int(prefetch or 0)
            self._declared: list[str] = []
            self._consuming: list[str] = []
            self._consumer_tag: dict[str, object] = {}  # queue -> tag
            self._buf: dict[str, deque[Message]] = {}
            self._tags = itertools.count(1)
            self._live: dict[int, int] = {}  # synthetic -> channel tag
            self._connect()

        # -- connection lifecycle ----------------------------------------
        def _connect(self) -> None:
            self._conn = pika.BlockingConnection(pika.URLParameters(self._uri))
            self._ch = self._conn.channel()
            if self._prefetch:
                self._ch.basic_qos(prefetch_count=self._prefetch)
            for name in self._declared:
                self._ch.queue_declare(queue=name, durable=True)
            for queue in self._consuming:
                self._subscribe(queue)

        def _reconnect(self, err) -> None:
            logger.warning("pika connection lost (%s); reconnecting", err)
            # In-flight deliveries died with the channel; the broker
            # requeues them. Drop their local shadows so stale synthetic
            # tags can never ack a new-channel message.
            self._buf = {q: deque() for q in self._buf}
            self._live.clear()
            self._consumer_tag.clear()  # old channel's tags are invalid
            try:
                self._conn.close()
            except Exception:  # noqa: BLE001 — already dead is fine
                pass
            self._connect()

        def _retry(self, op):
            """Runs op; on connection loss reconnects once and re-runs.
            Only for idempotent-on-retry operations (declare, publish,
            pump) — acks go through _settle instead."""
            try:
                return op()
            except conn_errors as e:
                self._reconnect(e)
                return op()

        def _subscribe(self, queue: str) -> None:
            def on_message(_ch, method, properties, body, _q=queue):
                tag = next(self._tags)
                self._live[tag] = method.delivery_tag
                self._buf.setdefault(_q, deque()).append(
                    Message(
                        body=body,
                        headers=getattr(properties, "headers", None) or {},
                        delivery_tag=tag,
                    )
                )

            try:
                tag = self._ch.basic_consume(
                    queue=queue, on_message_callback=on_message
                )
            except TypeError:  # pika 0.10 legacy signature (the reference's pin)
                tag = self._ch.basic_consume(on_message, queue=queue)
            self._consumer_tag[queue] = tag

        # -- Broker protocol ---------------------------------------------
        def declare_queue(self, name: str) -> None:
            if name not in self._declared:
                self._declared.append(name)
            self._retry(
                lambda: self._ch.queue_declare(queue=name, durable=True)
            )

        def publish(self, queue: str, body: bytes, headers: dict | None = None) -> None:
            self._retry(
                lambda: self._ch.basic_publish(
                    "", queue, body, pika.BasicProperties(headers=headers or {})
                )
            )

        def publish_topic(self, exchange: str, routing_key: str, body: bytes) -> None:
            self._retry(
                lambda: self._ch.basic_publish(exchange, routing_key, body)
            )

        def get(self, queue: str, limit: int) -> list[Message]:
            if queue not in self._consuming:
                self._consuming.append(queue)
                try:
                    self._subscribe(queue)
                except conn_errors as e:
                    # NO retry of the op here: _connect re-subscribes
                    # everything in _consuming (including this queue) —
                    # re-running _subscribe would register a DUPLICATE
                    # consumer and silently double the per-consumer
                    # prefetch bound.
                    self._reconnect(e)
            # Pump the ioloop without blocking: the server pushes up to
            # the prefetch bound; the callback fills the buffer.
            self._retry(
                lambda: self._conn.process_data_events(time_limit=0)
            )
            buf = self._buf.setdefault(queue, deque())
            out: list[Message] = []
            while buf and len(out) < limit:
                out.append(buf.popleft())
            return out

        def _settle(self, delivery_tag: int, op) -> None:
            real = self._live.pop(delivery_tag, None)
            if real is None:
                return  # dead channel's tag: the broker redelivers it
            try:
                op(real)
            except conn_errors as e:
                # The settle is lost with the channel (at-least-once:
                # the message comes back); NEVER retry on the new
                # channel — the same numeric tag would settle a
                # different message there.
                self._reconnect(e)

        def set_prefetch(self, prefetch: int) -> None:
            """Re-bounds the per-consumer QoS window (and across
            reconnects). Used by a worker whose pipelined mode
            permanently degrades: the wide in-flight window sized for
            deferred acks would otherwise keep hogging deliveries a
            sequential consumer can't keep up with, starving healthy
            competing consumers on the same queue.

            RabbitMQ applies per-consumer (global=false) QoS at
            CONSUMER CREATION, so changing basic_qos alone would be a
            no-op for the live subscription — existing consumers are
            cancelled and re-registered under the new bound. Deliveries
            already buffered stay valid (their unacked window drains as
            the caller processes them)."""
            self._prefetch = int(prefetch or 0)

            def op():
                if self._prefetch:
                    self._ch.basic_qos(prefetch_count=self._prefetch)
                for queue, tag in list(self._consumer_tag.items()):
                    try:
                        self._ch.basic_cancel(tag)
                    except Exception:  # noqa: BLE001 — already-gone tag
                        pass
                    self._consumer_tag.pop(queue, None)
                for queue in self._consuming:
                    self._subscribe(queue)

            self._retry(op)

        def ack(self, delivery_tag: int) -> None:
            self._settle(delivery_tag, self._ch.basic_ack)

        def nack(self, delivery_tag: int, requeue: bool = False) -> None:
            self._settle(
                delivery_tag,
                lambda real: self._ch.basic_nack(real, requeue=requeue),
            )

        def qsize(self, queue: str) -> int:
            """Server-side ready depth (the passive-redeclare
            ``message_count`` snapshot) plus deliveries already pushed
            into the local buffer but not yet handed to the consumer —
            the caller-visible backlog. Older pika stubs return no
            declare result; those report the local buffer alone."""

            def op():
                res = self._ch.queue_declare(queue=queue, durable=True)
                method = getattr(res, "method", None)
                return int(getattr(method, "message_count", 0) or 0)

            return self._retry(op) + len(self._buf.get(queue, ()))

    return PikaBroker(uri, prefetch)
