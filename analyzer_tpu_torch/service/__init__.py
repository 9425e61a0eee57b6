"""Service shell: the reference ``worker.py`` around the port's rating path.

The port's copy of ``analyzer_tpu.service``. The reference is a RabbitMQ
consumer that loads match graphs from MySQL, rates them one at a time, and
fans results out (``worker.py:85-199``). The shell keeps its *semantics* —
micro-batching with an idle flush, whole-batch dead-lettering, per-message
ack, the notify/crunch/sew/telesuck fan-out, chronological processing —
but the rating path is the port's scheduler and superstep on the card, and
the authoritative player state is the device-resident table (the store is
a write-behind mirror, not the source of truth during a batch).

Pluggable edges: ``Broker`` (in-memory always; pika adapter when installed)
and the match store (in-memory object graphs, or ``SqlStore`` — the
reference's reflected-SQL layer on DB-API, sqlite tested end to end, MySQL
via gated drivers), and the partitioned brokers with priority lanes and
the admission controller (``service/broker.py``).
"""

from analyzer_tpu_torch.service.broker import Broker, InMemoryBroker, Message
from analyzer_tpu_torch.service.sql_store import SqlStore
from analyzer_tpu_torch.service.store import InMemoryStore
from analyzer_tpu_torch.service.worker import Worker

__all__ = [
    "Broker", "InMemoryBroker", "Message", "InMemoryStore", "SqlStore", "Worker",
]
