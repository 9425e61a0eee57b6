"""The partitioned half of the port's broker (``analyzer_tpu_torch.service.
broker``) against the JAX package's on the same calls, exactly:
``partition_of``, the ``AdmissionController``'s decision sequence on the
same counter deltas, the in-memory ``PartitionedBroker``, the physical-queue
``AmqpPartitionedBroker`` (over each package's ``InMemoryBroker`` and over a
stub pika module injected through ``sys.modules``, as
tests/test_pika_adapter.py does), and ``PartitionSubscription``. Then the
port's Worker consuming through a partitioned broker, with the
per-partition ``broker.queue_depth{queue=,partition=,lane=}`` series."""

import sys

import numpy as np
import pytest

import analyzer_tpu.service.broker as jbroker
import analyzer_tpu_torch.service.broker as broker
from tests.test_pika_adapter import make_stub_pika


class _Counter:
    def __init__(self):
        self.value = 0.0


class _FakeRegistry:
    """The two counters the controller reads, driven by the test."""

    def __init__(self):
        self.counters = {"feed.starved_total": _Counter(),
                         "tier.promotions_total": _Counter()}

    def counter(self, name):
        return self.counters[name]


def _script(seed: int, n: int = 300):
    """A seeded call sequence: publishes (some header-routed, some on the
    backfill lane), gets with various limits, acks, nacks with and without
    requeue, and crash requeues."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        r = rng.random()
        if r < 0.55:
            headers = {}
            if rng.random() < 0.4:
                headers["x-partition"] = int(rng.integers(0, 9))
            if rng.random() < 0.3:
                headers["x-lane"] = "backfill" if rng.random() < 0.9 else "bogus"
            ops.append(("publish", f"m{i:04d}".encode(), headers or None))
        elif r < 0.85:
            ops.append(("get", int(rng.integers(1, 12)), None))
        elif r < 0.97:
            ops.append(("settle", float(rng.random()), None))
        else:
            ops.append(("crash", None, None))
    return ops


def _drive(b, ops):
    """Runs ``ops`` against broker ``b``; returns every observable."""
    seen = []
    pending = []
    for op, a, h in ops:
        if op == "publish":
            b.publish("analyze", a, headers=h)
        elif op == "get":
            got = b.get("analyze", a)
            pending += got
            seen.append(("get", [(m.body, m.delivery_tag) for m in got]))
        elif op == "settle":
            if pending:
                m = pending.pop(0)
                if a < 0.5:
                    b.ack(m.delivery_tag)
                else:
                    b.nack(m.delivery_tag, requeue=a < 0.8)
        else:
            b.requeue_unacked()
            pending.clear()
        if hasattr(b, "partition_depths"):
            seen.append(("depth", b.qsize("analyze"),
                         b.lane_size("analyze", broker.LANE_BACKFILL),
                         sorted(b.partition_depths("analyze").items())))
    return seen


def test_partition_of_equals_jax():
    rng = np.random.default_rng(5)
    for i in range(500):
        body = rng.bytes(int(rng.integers(0, 40)))
        headers = ({"x-partition": int(rng.integers(-5, 50))}
                   if i % 3 == 0 else ({"other": 1} if i % 3 == 1 else None))
        for parts in (1, 2, 4, 7):
            assert (broker.partition_of(body, headers, parts)
                    == jbroker.partition_of(body, headers, parts))


def test_physical_queue_naming_equals_jax():
    for q, p, lane in (("analyze", 2, "live"), ("analyze", 0, "backfill"),
                       ("x_failed", 11, "live")):
        assert broker.physical_queue(q, p, lane) == jbroker.physical_queue(q, p, lane)
    assert broker.physical_queue("analyze", 2, broker.LANE_LIVE) == "analyze.p2.live"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_decisions_equal_jax(seed):
    """The same counter deltas, live backlogs and limits give JAX's quota
    sequence, threshold for threshold."""
    rng = np.random.default_rng(seed)
    regs = (_FakeRegistry(), _FakeRegistry())
    kw = dict(starve_threshold=int(rng.integers(1, 3)),
              promote_threshold=int(rng.integers(1, 400)))
    port = broker.AdmissionController(registry=regs[0], **kw)
    jax_ = jbroker.AdmissionController(registry=regs[1], **kw)
    got, want = [], []
    for _ in range(400):
        d_starve = int(rng.integers(0, 3)) if rng.random() < 0.4 else 0
        d_prom = int(rng.integers(0, 600)) if rng.random() < 0.3 else 0
        for reg in regs:
            reg.counters["feed.starved_total"].value += d_starve
            reg.counters["tier.promotions_total"].value += d_prom
        live = int(rng.integers(0, 3)) if rng.random() < 0.3 else 0
        limit = int(rng.integers(-1, 9))
        got.append(port.quota(live, limit))
        want.append(jax_.quota(live, limit))
    assert got == want
    assert 0 < sum(q for q in got if q > 0)
    # Every verdict kind occurs: zero, halved and full windows.
    assert {0} < set(got) and any(0 < q < 8 for q in got)


def test_admission_defaults_read_the_process_registry():
    from analyzer_tpu_torch.obs import get_registry

    ctl = broker.AdmissionController()
    assert ctl.quota(0, 8) == 8  # the first call only sets the baseline
    get_registry().counter("feed.starved_total").add(1)
    assert ctl.quota(0, 8) == 4  # starvation halves the window
    assert ctl.quota(0, 8) == 8  # quiet telemetry opens it again
    assert ctl.quota(3, 8) == 0  # strict live priority
    assert ctl.quota(0, 0) == 0


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("partitions,lanes", [(1, False), (4, False), (3, True)])
def test_partitioned_broker_equals_jax(seed, partitions, lanes):
    ops = _script(seed)
    got = _drive(broker.PartitionedBroker(partitions, lanes), ops)
    want = _drive(jbroker.PartitionedBroker(partitions, lanes), ops)
    assert got == want


@pytest.mark.parametrize("seed", [3, 4])
def test_live_only_order_equals_a_single_queue(seed):
    """Partitioning changes where messages wait, never the delivery order or
    the tags: live-only traffic comes out as an InMemoryBroker gives it."""
    # Live publishes, gets and acks: a crash or a requeueing nack puts the
    # single queue's redeliveries in its own order.
    ops = [(op, 0.0 if op == "settle" else a, h) for op, a, h in _script(seed)
           if op != "crash" and (op != "publish" or not h or "x-lane" not in h)]
    single = _drive(broker.InMemoryBroker(), ops)
    parted = _drive(broker.PartitionedBroker(4), ops)
    assert [s for s in parted if s[0] == "get"] == [s for s in single if s[0] == "get"]


@pytest.mark.parametrize("partitions,lanes", [(1, False), (4, False), (3, True)])
def test_amqp_partitioned_over_in_memory_equals_jax(partitions, lanes):
    ops = _script(6)
    got = _drive(broker.AmqpPartitionedBroker(broker.InMemoryBroker(),
                                              partitions, lanes), ops)
    want = _drive(jbroker.AmqpPartitionedBroker(jbroker.InMemoryBroker(),
                                                partitions, lanes), ops)
    assert got == want


def test_amqp_declares_both_lanes_and_orders_live_first():
    base = broker.InMemoryBroker()
    b = broker.AmqpPartitionedBroker(base, partitions=2, lanes=True)
    b.declare_queue("analyze")
    assert sorted(base.queues) == sorted(
        broker.physical_queue("analyze", p, lane)
        for p in range(2) for lane in ("live", "backfill"))
    b.publish("analyze", b"bf0", headers={"x-lane": "backfill"})
    b.publish("analyze", b"live0")
    b.publish("analyze", b"bf1", headers={"x-lane": "backfill"})
    b.publish("analyze", b"live1")
    got = [m.body for m in b.get("analyze", 10)]
    assert got[:2] == [b"live0", b"live1"] and sorted(got[2:]) == [b"bf0", b"bf1"]


def _pika_script(make, monkeypatch, mod):
    """The partitioned AMQP composition over a fresh stub pika server."""
    monkeypatch.setitem(sys.modules, "pika", make_stub_pika())
    b = make("amqp://guest@localhost", partitions=3, lanes=True, prefetch=4,
             admission=mod.AdmissionController(registry=_FakeRegistry()))
    out = []
    for i in range(12):
        h = {"x-lane": "backfill"} if i % 4 == 3 else None
        b.publish("analyze", f"m{i}".encode(), headers=h)
    got = b.get("analyze", 5)
    out.append([(m.body, sorted((m.headers or {}).items())) for m in got])
    b.ack(got[0].delivery_tag)
    b.nack(got[1].delivery_tag, requeue=True)
    b.nack(got[2].delivery_tag, requeue=False)
    more = b.get("analyze", 20)
    out.append([m.body for m in more])
    out.append(sorted(b.partition_depths("analyze").items()))
    out.append(b.qsize("analyze"))
    return out


def test_amqp_partitioned_on_stub_pika_equals_jax(monkeypatch):
    got = _pika_script(broker.make_partitioned_pika_broker, monkeypatch, broker)
    want = _pika_script(jbroker.make_partitioned_pika_broker, monkeypatch, jbroker)
    assert got == want
    assert got[0] and got[1]


def test_partitioned_pika_without_pika_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "pika", None)
    with pytest.raises(ImportError):
        broker.make_partitioned_pika_broker("amqp://guest@localhost", partitions=2)


def test_subscription_window_equals_jax():
    ops = _script(8)
    pb, jpb = broker.PartitionedBroker(4, True), jbroker.PartitionedBroker(4, True)
    sub = broker.PartitionSubscription(pb, [3, 1])
    jsub = jbroker.PartitionSubscription(jpb, [3, 1])
    got = []
    want = []
    for op, a, h in ops:
        if op == "publish":
            pb.publish("analyze", a, headers=h)
            jpb.publish("analyze", a, headers=h)
        elif op == "get":
            got.append([(m.body, m.delivery_tag) for m in sub.get("analyze", a)])
            want.append([(m.body, m.delivery_tag) for m in jsub.get("analyze", a)])
            got.append((sub.qsize("analyze"), sub.partition_depths("analyze")))
            want.append((jsub.qsize("analyze"), jsub.partition_depths("analyze")))
    assert got == want and sub.owned == (1, 3) and sub.partitions == 4
    for bad in ([], [4]):
        with pytest.raises(ValueError):
            broker.PartitionSubscription(pb, bad)


def _mk_match(api_id, created_at):
    from analyzer_tpu_torch.fixtures import (
        fake_match, fake_participant, fake_player, fake_roster,
    )

    players = []
    for i in range(6):
        p = fake_player(skill_tier=15)
        p.api_id = f"{api_id}-p{i}"
        players.append(p)
    m = fake_match("ranked", [
        fake_roster(True, [fake_participant(player=p) for p in players[:3]]),
        fake_roster(False, [fake_participant(player=p) for p in players[3:]]),
    ], api_id=api_id)
    m.created_at = created_at
    return m


@pytest.mark.parametrize("kind", ["memory", "amqp"])
def test_worker_consumes_through_a_partitioned_broker(kind):
    from analyzer_tpu_torch.config import RatingConfig, ServiceConfig
    from analyzer_tpu_torch.obs import get_registry
    from analyzer_tpu_torch.service.store import InMemoryStore
    from analyzer_tpu_torch.service.worker import Worker

    b = (broker.PartitionedBroker(2, lanes=True) if kind == "memory"
         else broker.AmqpPartitionedBroker(broker.InMemoryBroker(), 2, lanes=True))
    store = InMemoryStore()
    worker = Worker(b, store, ServiceConfig(batch_size=4, idle_timeout=0.0),
                    RatingConfig(), pipeline=False, slo_plane=False, device="cpu")
    try:
        for i in range(4):
            store.add_match(_mk_match(f"m{i}", created_at=i))
            b.publish("analyze", f"m{i}".encode(), headers={"x-partition": i % 2})
        b.publish("analyze", b"m0", headers={"x-partition": 1, "x-lane": "backfill"})
        assert worker.poll()
        assert worker.matches_rated == 4
        gauges = get_registry().snapshot()["gauges"]
        # Sampled after the poll took the live four; the full batch left
        # no room for the backfill message.
        key = "broker.queue_depth{lane=backfill,partition=1,queue=analyze}"
        assert gauges[key] == 1
        assert gauges["broker.queue_depth{lane=live,partition=0,queue=analyze}"] == 0
        assert gauges["broker.queue_depth{queue=analyze}"] == 1
    finally:
        worker.close()
