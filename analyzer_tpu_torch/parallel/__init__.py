"""Mesh data parallelism for the rating pipeline.

Counterpart of ``analyzer_tpu.parallel``. The reference scales out with
AMQP competing consumers racing on a shared MySQL table; the mesh keeps the
throughput model (data parallelism over matches) but makes the shared state
exact and shards the table: each shard owns an interleaved slice of the
player rows, priors are assembled from disjoint per-shard contributions
(one ``torch.distributed.all_reduce`` across processes), compute is
replicated, and each shard scatters only its own rows through the
hand-written row-scatter kernel. Conflict-freedom within a superstep (the
scheduler's invariant) makes the combine exact. Design: ``mesh.py``'s
docstring.
"""

from analyzer_tpu_torch.parallel.mesh import (
    Mesh,
    Routing,
    ShardedRun,
    build_routing,
    make_mesh,
    rate_history_sharded,
    sharded_step_fn,
)
from analyzer_tpu_torch.parallel.multihost import (
    assert_processes_agree,
    initialize_distributed,
    process_slice,
)

__all__ = [
    "Mesh",
    "Routing",
    "ShardedRun",
    "build_routing",
    "make_mesh",
    "rate_history_sharded",
    "sharded_step_fn",
    "assert_processes_agree",
    "initialize_distributed",
    "process_slice",
]
