"""ratesrv: the snapshot-consistent query-serving plane, on the card.

Counterpart of ``analyzer_tpu.serve``, its single and sharded planes. The write plane
(``sched/runner.py``) rates matches into a device-resident rating table;
this package is the READ plane that serves queries against it — player
lookups, leaderboards, tier histograms and win probability — Clipper-style
(Crankshaw et al., NSDI '17): many tiny concurrent queries coalesce into
one batch of device work per tick.

Three layers:

  * :mod:`~analyzer_tpu_torch.serve.view` — :class:`RatingsView`, an
    immutable published snapshot of the rating table + id-to-row mapping,
    double-buffered by a :class:`ViewPublisher` so the rater publishes at
    commit boundaries and readers never observe torn mid-commit state;
    the sharded plane's :class:`ShardedRatingsView` /
    :class:`ShardedViewPublisher` hold one snapshot per mesh shard under
    one version;
  * :mod:`~analyzer_tpu_torch.serve.engine` — :class:`QueryEngine`, the
    microbatching executor (pad-to-bucket requests, version-keyed
    leaderboard and count caches), and :class:`ShardedQueryEngine`, its
    routed per-shard counterpart;
  * :mod:`~analyzer_tpu_torch.serve.server` — the ``/v1/*`` HTTP endpoints
    on the shared :mod:`analyzer_tpu_torch.obs.httpd` plumbing, started via
    ``cli serve``.

``serve/oracle.py`` is the pure-Python reference every served number is
held to bit for bit; it is never imported by the serving path.

Not ported yet: the front door (ROADMAP A11c).
"""

from analyzer_tpu_torch.serve.engine import (
    QueryEngine,
    ServePlane,
    ShardedQueryEngine,
    UnknownPlayerError,
)
from analyzer_tpu_torch.serve.view import (
    RatingsView,
    ShardedRatingsView,
    ShardedViewPublisher,
    ViewPublisher,
)

__all__ = [
    "QueryEngine",
    "RatingsView",
    "ServePlane",
    "ServeServer",
    "ShardedQueryEngine",
    "ShardedRatingsView",
    "ShardedViewPublisher",
    "UnknownPlayerError",
    "ViewPublisher",
]


def __getattr__(name):
    # ServeServer pulls in the HTTP layer; keep it lazy so embedded
    # engine users (tests) don't pay for it.
    if name == "ServeServer":
        from analyzer_tpu_torch.serve.server import ServeServer

        return ServeServer
    raise AttributeError(name)
