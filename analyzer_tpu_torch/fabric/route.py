"""Cross-host query routing: the fabric's read plane.

The port's copy of ``analyzer_tpu.fabric.route``; the merges, the
tie-break and the float32 replay are JAX's, step for step.

:class:`FabricRouter` gives callers the same query surface as a
``ServePlane`` — ratings, winprob, leaderboard, tiers, percentile —
over a FLEET of shard-owning hosts:

  * **point lookups** route to the owning host (pure function of the
    id — :mod:`.topology`) over the existing ``/v1/*`` ServePlane HTTP
    surface; nothing new to operate, nothing the single-host plane
    doesn't already serve.
  * **leaderboards** merge per-host top-k candidates with THE serving
    plane's boundary-safe tie-break
    (:func:`analyzer_tpu_torch.serve.engine.merge_topk_candidates` —
    ``(-score, global_row)``), so ties spanning host boundaries land
    exactly where the single-plane engine puts them: merged responses
    are bit-identical to a single plane over the union table.
  * **tier histograms / percentiles** sum per-host INTEGER partial
    counts — exact, order-free.
  * each host's response is computed against ONE of its published
    versions (its ``ViewPublisher``'s atomic snapshot), so a reader
    never observes a torn cross-shard pair within a host; the merged
    response reports the per-host versions it combined (``versions``),
    and :meth:`FabricRouter.strip_versions` removes version keys for
    topology-invariant digests (per-host version counters depend on H;
    the rating bits do not).

A host the directory reports down LEAVES the merge — leaderboards and
tiers keep answering from the live hosts — while point lookups to it
fail loudly (the owner is the only process with the rows; a made-up
answer would be worse than an error).

:class:`FollowerPlane` is the in-process read replica: a private
``ViewPublisher`` that ADOPTS a leader lineage's published views by
reference (``ViewPublisher.adopt_view`` — the ``cutover_from``
mechanism without consuming the source) plus a ``QueryEngine`` ticking
over it, on the device the leader's tables live on. Same-process readers
scale without re-keying or copying a table.

Clock discipline: this module never reads a wall
clock — latency observation and down-host staleness take the caller's
injected ``clock``/``now``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse

import numpy as np

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.obs import get_registry
from analyzer_tpu_torch.obs.httpd import PooledHTTPClient
from analyzer_tpu_torch.serve.engine import (
    QueryEngine,
    UnknownPlayerError,
    _finish_quality,
    _finish_winprob,
    merge_topk_candidates,
)
from analyzer_tpu_torch.serve.view import ViewPublisher

from analyzer_tpu_torch.fabric.directory import FabricDirectory
from analyzer_tpu_torch.fabric.topology import row_of_id


class HttpHostClient:
    """One host's ``/v1/*`` surface as a client (an HTTP *client* — the
    listening sockets stay in serve/ + obs/). Rides one pooled keep-alive
    connection (:class:`~analyzer_tpu_torch.obs.httpd.PooledHTTPClient`) instead of a
    TCP handshake per lookup; the pool's urlopen-compatible errors keep
    the router's mark-down semantics unchanged."""

    def __init__(self, base_url: str, timeout_s: float = 30.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.pool = PooledHTTPClient(self.base_url, timeout_s=timeout_s)

    def _get(self, path: str, params: dict | None = None) -> dict:
        if params:
            path += "?" + urllib.parse.urlencode(params)
        return json.loads(self.pool.get(path).decode("utf-8"))

    def get_ratings(self, ids) -> dict:
        return self._get("/v1/ratings", {"ids": ",".join(ids)})

    def win_probability(self, team_a, team_b) -> dict:
        return self._get(
            "/v1/winprob", {"a": ",".join(team_a), "b": ",".join(team_b)}
        )

    def leaderboard(self, k: int) -> dict:
        return self._get("/v1/leaderboard", {"k": str(k)})

    def tier_histogram(self) -> dict:
        return self._get("/v1/tiers")

    def percentile(self, score: float) -> dict:
        # /v1/tiers?score folds the percentile keys into the tiers body.
        out = self._get("/v1/tiers", {"score": repr(float(score))})
        return {
            "version": out["version"],
            "score": out["score"],
            "below": out["below"],
            "rated": out["rated"],
            "percentile": out["percentile"],
        }


class EngineHostClient:
    """One host's plane called in-process (unit tests, follower
    planes) — same method surface as :class:`HttpHostClient`."""

    def __init__(self, plane) -> None:
        self.plane = plane

    def get_ratings(self, ids) -> dict:
        return self.plane.get_ratings(ids)

    def win_probability(self, team_a, team_b) -> dict:
        return self.plane.win_probability(team_a, team_b)

    def leaderboard(self, k: int) -> dict:
        return self.plane.leaderboard(k)

    def tier_histogram(self) -> dict:
        return self.plane.tier_histogram()

    def percentile(self, score: float) -> dict:
        return self.plane.percentile(score)


class HostDownError(RuntimeError):
    """The owning host for a point lookup is out of the fleet — only it
    has the rows, so the router fails loudly instead of guessing."""


class FabricRouter:
    """Fans queries across the fleet and merges bit-identically.

    ``clients`` maps host index -> a host client; hosts registered in
    the directory with a ``serve_url`` get an :class:`HttpHostClient`
    built lazily when not supplied. ``clock`` (injected) is
    used for down-host staleness (``directory.down_hosts(now)``) and
    remote-lookup latency observation; with ``clock=None`` only hosts
    explicitly marked down leave the merge and latency goes unobserved.
    """

    def __init__(
        self,
        directory: FabricDirectory,
        clients: dict[int, object] | None = None,
        cfg: RatingConfig | None = None,
        clock=None,
    ) -> None:
        self.directory = directory
        self.cfg = cfg or RatingConfig()
        self.clock = clock
        self.calls: dict[str, int] = {}
        self._clients: dict[int, object] = dict(clients or {})
        reg = get_registry()
        self._lookups = reg.counter("fabric.remote_lookups_total")
        self._errors = reg.counter("fabric.remote_errors_total")

    # -- plumbing ---------------------------------------------------------
    def client_of(self, host: int):
        c = self._clients.get(host)
        if c is None:
            entry = self.directory.entry(host)
            if entry.serve_url is None:
                raise KeyError(
                    f"host {host} has no client and no serve_url in the "
                    "directory"
                )
            c = HttpHostClient(entry.serve_url)
            self._clients[host] = c
        return c

    def _now(self):
        return self.clock() if self.clock is not None else None

    def _down(self) -> set[int]:
        now = self._now()
        if now is None:
            return {e.host for e in self.directory.hosts() if e.down}
        return set(self.directory.down_hosts(now))

    def _call(self, host: int, kind: str, fn):
        """One routed call: counts it, observes latency on the injected
        clock, converts transport failures into a down mark + error."""
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self._lookups.add(1)
        t0 = self._now()
        try:
            out = fn()
        except (OSError, urllib.error.URLError) as err:
            self._errors.add(1)
            self.directory.mark_down(host)
            raise HostDownError(
                f"host {host} failed a {kind} call: {err}"
            ) from err
        if t0 is not None:
            get_registry().histogram(
                "fabric.remote_lookup_ms", peer=str(host)
            ).observe((self.clock() - t0) * 1e3)
        return out

    @staticmethod
    def strip_versions(resp: dict) -> dict:
        """The topology-invariant body: version counters depend on the
        host count (each host runs its own monotone sequence), the
        rating bits do not — deterministic-block digests hash THIS."""
        return {
            k: v for k, v in resp.items() if k not in ("version", "versions")
        }

    def version_vector(self) -> dict[int, int]:
        return self.directory.vector()

    # -- point lookups ----------------------------------------------------
    def get_ratings(self, player_ids) -> dict:
        """Splits the ids by owning host (input order preserved in the
        merged response), one routed ``/v1/ratings`` call per owner.
        Ids outside the fabric's ``p<row>`` scheme are unknown by
        construction — no host can own them."""
        topo = self.directory.topology
        per: dict[int, list[str]] = {}
        owner: list[int | None] = []
        for pid in player_ids:
            try:
                h = topo.host_of_id(pid)
            except ValueError:
                owner.append(None)
                continue
            owner.append(h)
            per.setdefault(h, []).append(pid)
        versions: dict[str, int] = {}
        ratings_iter: dict[int, object] = {}
        unknown_of: dict[int, set] = {}
        for h, ids in sorted(per.items()):
            resp = self._call(
                h, "ratings", lambda c=self.client_of(h), i=ids: c.get_ratings(i)
            )
            versions[str(h)] = resp["version"]
            ratings_iter[h] = iter(resp["ratings"])
            unknown_of[h] = set(resp["unknown"])
        out, unknown = [], []
        for pid, h in zip(player_ids, owner):
            if h is None or pid in unknown_of[h]:
                unknown.append(pid)
            else:
                out.append(next(ratings_iter[h]))
        return {"versions": versions, "ratings": out, "unknown": unknown}

    def win_probability(self, team_a, team_b) -> dict:
        """Shard-pure matchups (every participant one host — the fabric
        matchmaker's invariant) route WHOLE to the owner: one call, one
        version. A cross-host matchup gathers each side's rows from the
        owners and replays the kernel's fixed-order float32 reduction on
        host (the sharded engine's own mechanism, one level up) — same
        bits as a single plane holding the union table."""
        owners = set()
        for pid in list(team_a) + list(team_b):
            try:
                owners.add(self.directory.topology.host_of_id(pid))
            except ValueError as err:
                raise UnknownPlayerError([pid]) from err
        if len(owners) == 1:
            h = owners.pop()
            resp = self._call(
                h, "winprob",
                lambda c=self.client_of(h): c.win_probability(team_a, team_b),
            )
            return {
                "versions": {str(h): resp["version"]},
                "p_a": resp["p_a"],
                "quality": resp["quality"],
            }
        merged = self.get_ratings(list(team_a) + list(team_b))
        if merged["unknown"]:
            raise UnknownPlayerError(merged["unknown"])
        rows = merged["ratings"]
        ra, rb = rows[: len(team_a)], rows[len(team_a):]
        one = np.float32(1.0)
        acc_n = np.float32(0.0)
        acc_s2 = np.float32(0.0)
        team_mu = [np.float32(0.0), np.float32(0.0)]
        for t, team in enumerate((ra, rb)):
            for r in team:
                if r["rated"]:
                    mu, sg = np.float32(r["mu"]), np.float32(r["sigma"])
                else:
                    mu = np.float32(r["seed_mu"])
                    sg = np.float32(r["seed_sigma"])
                acc_n = np.float32(acc_n + one)
                acc_s2 = np.float32(acc_s2 + np.float32(sg * sg))
                team_mu[t] = np.float32(team_mu[t] + mu)
        n = np.array([acc_n], np.float32)
        s2 = np.array([acc_s2], np.float32)
        mu_diff = np.array([np.float32(team_mu[0] - team_mu[1])], np.float32)
        beta2 = self.cfg.beta2
        return {
            "versions": merged["versions"],
            "p_a": float(_finish_winprob(n, s2, mu_diff, beta2)[0]),
            "quality": float(_finish_quality(n, s2, mu_diff, beta2)[0]),
        }

    # -- fleet merges -----------------------------------------------------
    def _alive(self) -> list[int]:
        down = self._down()
        hosts = [e.host for e in self.directory.hosts() if e.host not in down]
        if not hosts:
            raise HostDownError("every fabric host is down; nothing to merge")
        return hosts

    def leaderboard(self, k: int = 10) -> dict:
        """Per-host top-k + the plane's pinned ``(-score, global_row)``
        merge. Each host's list covers exactly its owned population (a
        host publishes only its owned players), so the union of per-host
        top-k always contains the global top-k — the merged response is
        bit-identical to a single plane over the whole table."""
        versions: dict[str, int] = {}
        entries = []
        for h in self._alive():
            try:
                resp = self._call(
                    h, "leaderboard",
                    lambda c=self.client_of(h): c.leaderboard(k),
                )
            except HostDownError:
                continue  # dropped mid-merge: serve from the rest
            versions[str(h)] = resp["version"]
            for row in resp["leaders"]:
                entries.append(
                    (row["conservative"], row_of_id(row["id"]), row)
                )
        leaders = []
        for rank, (_s, _r, row) in enumerate(merge_topk_candidates(entries, k)):
            leaders.append({**row, "rank": rank + 1})
        return {"versions": versions, "leaders": leaders}

    def tier_histogram(self) -> dict:
        versions: dict[str, int] = {}
        counts = None
        edges = None
        rated = 0
        for h in self._alive():
            try:
                resp = self._call(
                    h, "tiers",
                    lambda c=self.client_of(h): c.tier_histogram(),
                )
            except HostDownError:
                continue
            versions[str(h)] = resp["version"]
            if edges is None:
                edges = resp["edges"]
                counts = list(resp["counts"])
            else:
                if resp["edges"] != edges:
                    raise ValueError(
                        f"host {h} tiers on different edges; the fleet "
                        "must share one tier ladder to merge counts"
                    )
                counts = [a + b for a, b in zip(counts, resp["counts"])]
            rated += resp["rated"]
        if edges is None:
            raise HostDownError("no host answered the tiers merge")
        return {
            "versions": versions, "edges": edges, "counts": counts,
            "rated": rated,
        }

    def percentile(self, score: float) -> dict:
        versions: dict[str, int] = {}
        below = 0
        rated = 0
        value = None
        for h in self._alive():
            try:
                resp = self._call(
                    h, "percentile",
                    lambda c=self.client_of(h): c.percentile(score),
                )
            except HostDownError:
                continue
            versions[str(h)] = resp["version"]
            below += resp["below"]
            rated += resp["rated"]
            value = resp["score"]
        if value is None:
            raise HostDownError("no host answered the percentile merge")
        return {
            "versions": versions,
            "score": value,
            "below": below,
            "rated": rated,
            "percentile": (below / rated) if rated else None,
        }


class FollowerPlane:
    """An in-process read replica of one host's serve lineage.

    The follower's private ``ViewPublisher`` adopts the leader's published
    views BY REFERENCE (:meth:`ViewPublisher.adopt_view`) — zero copy,
    zero re-keying, version numbers tracking the leader's monotone
    sequence — and a standard ``QueryEngine`` microbatches over it. Both
    live on the leader's device, so the engine reads the adopted table
    where it already is. ``refresh()`` is the poll point; callers decide
    the cadence (the staleness bound is the refresh interval plus the
    leader's publish throttle)."""

    def __init__(
        self,
        leader,
        cfg: RatingConfig | None = None,
        max_batch: int = 256,
        clock=None,
    ) -> None:
        self.leader = leader
        self.publisher = ViewPublisher(
            min_publish_interval_s=0.0, device=leader.device
        )
        kw = {} if clock is None else {"clock": clock}
        self.engine = QueryEngine(
            self.publisher, cfg=cfg, max_batch=max_batch,
            device=leader.device, **kw,
        )

    def refresh(self) -> bool:
        """Adopts the leader's current view when it is new. Returns True
        when the follower advanced."""
        view = self.leader.current()
        if view is None:
            return False
        return self.publisher.adopt_view(view)

    @property
    def version(self) -> int:
        return self.publisher.version

    def start(self) -> "FollowerPlane":
        self.refresh()
        self.engine.start()
        return self

    def close(self) -> None:
        self.engine.close()
