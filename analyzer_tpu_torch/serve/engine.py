"""QueryEngine: microbatched query execution over a published view.

Counterpart of the single-plane half of ``analyzer_tpu.serve.engine``.
Every query type runs as ONE batch of device work per tick: concurrent
requests queue; the tick thread drains them, groups by kind, pads each
group to its power-of-two request bucket (floor ``QUERY_BUCKET_FLOOR``, cap
``max_batch``) and dispatches once, so each tiny query pays ~1/occupancy of
a dispatch instead of a whole one (Clipper's adaptive-batching argument,
NSDI '17). The buckets are the JAX package's, kept so that occupancy
figures and every response — padding included — are the same in both.

Bit-reproducibility split (the oracle contract, ``serve/oracle.py``): the
device functions do only IEEE-exact work — row gathers, NaN→seed selects,
comparisons, stable sorts and FIXED-ORDER float32 team reductions (explicit
add chains; eager PyTorch runs each add as its own kernel, in the written
order, and contracts nothing into an FMA) — so a pure-Python float32
oracle replays them bit for bit, and so does the JAX engine. The final
transcendentals (Phi for win probability, sqrt·exp for quality) run on the
host in float64 over the fetched per-query statistics, rounded once to
float32 — deterministic libm-on-doubles, exactly replicable by the oracle.
The device functions are plain PyTorch, as their JAX counterparts are
plain XLA code outside any hand-written kernel; none is wrapped in
``torch.compile``, which might fuse the add chains differently.

Two choices differ from the JAX functions in how, never in what:

  * **leaderboard**: ``jax.lax.top_k`` breaks ties toward the lower row,
    ``torch.topk`` promises no order, and ties are common (teammates whose
    only match is shared hold identical ratings). :func:`_leaderboard` is a
    STABLE descending sort of the whole score column cut at k: equal scores
    keep their row order, including a tie class that straddles the k-th
    place — the ``(score desc, row asc)`` key of
    :func:`merge_topk_candidates`. One sort per view version (the result
    is cached), chosen over top-k plus a repair of the boundary tie class
    because it has no case analysis to get wrong;
  * **counts**: the ``[edges, rows]`` and ``[Qb, rows]`` boolean
    intermediates that XLA fuses away would be materialised by eager
    PyTorch (half a gigabyte for 256 percentiles over two million rows).
    The counts go through a sort instead: the rated scores are sorted
    once per view version and every "how many below" is a
    ``torch.searchsorted`` — integers, so equally exact.

Consistency: a tick resolves ``ViewPublisher.current()`` ONCE and answers
every request in that tick against it, so each response is internally
consistent with exactly one published version (reported as ``version`` in
every result).

The sharded engine (:class:`ShardedQueryEngine`) serves the same responses
from a :class:`~analyzer_tpu_torch.serve.view.ShardedViewPublisher`'s
per-shard tables: routed per-shard gathers, per-shard leaderboards merged
on the host by ``(-score, global_row)``, per-shard integer counts summed.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import (
    COL_SEED_MU,
    COL_SEED_SIGMA,
    MAX_TEAM_SIZE,
    MU_LO,
    SIGMA_LO,
)
from analyzer_tpu_torch.device import resolve_device
from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs import get_registry
from analyzer_tpu_torch.serve.view import RatingsView

logger = get_logger(__name__)

#: Smallest per-tick request bucket — single queries pad to this.
QUERY_BUCKET_FLOOR = 8

#: The ratings gather ladder extends this far past ``max_batch``: one
#: ratings request legitimately carries a page of ids, not one.
RATINGS_ID_FACTOR = 8

#: Conservative-score multiplier: rank by mu - 3*sigma (the "99.7% sure
#: you are at least this good" estimate the reference's trueskill_delta
#: is a delta of, rater.py:149).
CONSERVATIVE_K = 3.0

#: Default tier edges over the conservative score, mu0/sigma0-scale
#: (mu0=1500, sigma0=1000): fresh players sit far negative, converged
#: ones land between 0 and ~2500. Operators tune via
#: ``QueryEngine(tier_edges=)``.
DEFAULT_TIER_EDGES = (
    -2000.0, -1000.0, -500.0, 0.0, 250.0, 500.0, 750.0,
    1000.0, 1250.0, 1500.0, 1750.0, 2000.0, 2500.0,
)

_KINDS = ("ratings", "winprob", "leaderboard", "tiers", "percentile")


class UnknownPlayerError(KeyError):
    """A query named player ids the addressed view has never published."""

    def __init__(self, ids) -> None:
        self.ids = tuple(ids)
        super().__init__(f"unknown player id(s): {', '.join(self.ids)}")

    def __str__(self) -> str:  # KeyError's repr-quoting is noise in HTTP bodies
        return self.args[0]


def query_bucket(n: int, cap: int) -> int:
    """Power-of-two request bucket, floor QUERY_BUCKET_FLOOR, cap
    ``cap`` (the engine's max_batch) — the ONE owner of the per-tick
    padding."""
    b = max(QUERY_BUCKET_FLOOR, 1 << max(n - 1, 0).bit_length())
    return min(b, max(cap, QUERY_BUCKET_FLOOR))


# -- device functions (one dispatch per kind per tick) --------------------


def _gather_rows(table, idx):
    """Whole-row gather for player lookups: [Qb] -> [Qb, 16]."""
    return table.index_select(0, idx)


def _team_stats(table, idx, mask, team: int):
    """Fixed-order float32 sufficient statistics for [Qb] two-team
    matchups: idx/mask are [Qb, 2, T]. Returns (n, s2_sum, mu_diff)
    where priors resolve NaN -> baked seed (rater.py:114-121) and every
    reduction is an explicit team-major, slot-minor add chain from zero —
    the order ``serve/oracle.py`` replays bit for bit (never ``.sum()``,
    whose order is the library's)."""
    rows = table[idx]  # [Qb, 2, T, 16]
    mu_raw = rows[..., MU_LO]
    sg_raw = rows[..., SIGMA_LO]
    unrated = torch.isnan(mu_raw)
    mu = torch.where(unrated, rows[..., COL_SEED_MU], mu_raw)
    sg = torch.where(unrated, rows[..., COL_SEED_SIGMA], sg_raw)
    zero = torch.zeros(idx.shape[0], dtype=mu.dtype, device=mu.device)
    one = torch.ones_like(zero)
    n = zero
    s2 = zero
    team_mu = [zero, zero]
    for t in range(2):
        for s in range(team):
            m = mask[:, t, s]
            n = n + torch.where(m, one, zero)
            s2 = s2 + torch.where(m, sg[:, t, s] * sg[:, t, s], zero)
            team_mu[t] = team_mu[t] + torch.where(m, mu[:, t, s], zero)
    return n, s2, team_mu[0] - team_mu[1]


def _conservative(mu, sg):
    """mu - 3*sigma in float32 WITHOUT a multiply: ``sg+sg`` is exact
    (power-of-two scale), so ``(sg+sg)+sg`` is the correctly-rounded
    3*sigma — and with no mul feeding the subtract there is nothing a
    fused or compiled version could contract into an FMA, whose single
    rounding would silently break the oracle's bit-for-bit replay
    (``serve/oracle.py``)."""
    return mu - ((sg + sg) + sg)


def _host_conservative(mu, sg) -> np.float32:
    """The host replay of :func:`_conservative` (same rounding order)."""
    mu = np.float32(mu)
    sg = np.float32(sg)
    return np.float32(mu - np.float32(np.float32(sg + sg) + sg))


def _scores(table):
    """(conservative score, rated mask) of the shared column."""
    mu = table[:, MU_LO]
    return _conservative(mu, table[:, SIGMA_LO]), ~torch.isnan(mu)


def _leaderboard(table, k: int):
    """Top-k rows by conservative score mu - 3*sigma (shared column),
    unrated rows excluded via -inf: ``(scores, rows)`` ordered by (score
    descending, row ascending). A stable sort keeps equal scores in row
    order, so ties — also those that straddle the k-th place — fall
    toward the lower row, as ``jax.lax.top_k`` and the oracle order
    them."""
    score, rated = _scores(table)
    score = torch.where(rated, score, torch.full_like(score, -math.inf))
    vals, idx = torch.sort(score, descending=True, stable=True)
    return vals[:k], idx[:k]


def _sorted_rated_scores(table):
    """The rated rows' scores in ascending order: the one sort behind
    every count (:func:`_count_below`, :func:`_tier_counts`)."""
    score, rated = _scores(table)
    return torch.sort(score[rated]).values


def _count_below(sorted_scores, values):
    """For each query value: how many rated rows score strictly below it
    (the percentile numerator), plus the rated total. ``searchsorted``
    from the left counts exactly the scores ``< value``; a NaN value is
    below nothing, as the comparison would say."""
    below = torch.searchsorted(sorted_scores, values.contiguous())
    below = torch.where(torch.isnan(values), torch.zeros_like(below), below)
    return below, int(sorted_scores.numel())


def _tier_counts(sorted_scores, edges):
    """(count of rated rows with score >= edge_i, rated total): the rated
    total less the scores strictly below the edge. Integer counts of
    exact float32 comparisons — free of rounding by construction."""
    below, rated = _count_below(sorted_scores, edges)
    return rated - below, rated


def merge_topk_candidates(entries, k: int | None = None) -> list:
    """THE serving plane's boundary-safe top-k merge, exported so every
    tier that stitches partial top-k lists uses one pinned key.

    ``entries`` are ``(score, global_row, payload)`` triples; the result
    is sorted by ``(-score, global_row)`` — :func:`_leaderboard`'s
    descending order with low-index tie-break on the UNSHARDED table,
    which makes ties spanning shard (and host) boundaries land exactly
    where the single-device plane puts them — truncated to ``k`` when
    given. Float negation is exact, so the key loses no bits."""
    cand = sorted(entries, key=lambda c: (-c[0], c[1]))
    return cand if k is None else cand[:k]


def _finish_winprob(n, s2, mu_diff, beta2: float):
    """Host float64 finish of P(team A wins) = Phi(mu_diff / c) from the
    kernel's float32 statistics, rounded once to float32. Pure
    double-precision libm — the oracle replays it exactly."""
    out = np.empty(len(n), np.float32)
    for i in range(len(n)):
        c2 = max(float(s2[i]) + float(n[i]) * beta2, 1e-20)
        t = float(mu_diff[i]) / math.sqrt(c2)
        out[i] = np.float32(0.5 * math.erfc(-t / math.sqrt(2.0)))
    return out


def _finish_quality(n, s2, mu_diff, beta2: float):
    """Host float64 finish of the draw-probability match quality
    (ops.trueskill.quality's closed form, no tau inflation)."""
    out = np.empty(len(n), np.float32)
    for i in range(len(n)):
        nb = float(n[i]) * beta2
        denom = max(nb + float(s2[i]), 1e-20)
        d = float(mu_diff[i])
        out[i] = np.float32(
            math.sqrt(nb / denom) * math.exp(-(d * d) / (2.0 * denom))
        )
    return out


class _Pending:
    """One queued request: resolved by the tick that executes it. The
    submit/done stamps give the client-observed latency the serve bench
    reports (queue wait + microbatch execution)."""

    __slots__ = (
        "kind", "payload", "done", "value", "error", "t_submit", "t_done",
        "audit",
    )

    def __init__(self, kind: str, payload) -> None:
        self.kind = kind
        self.payload = payload
        self.done = threading.Event()
        self.value = None
        self.error: BaseException | None = None
        self.t_submit = time.monotonic()
        self.t_done: float | None = None
        # (auditor, view) when a shadow auditor is attached — set by
        # _execute before the microbatch runs, consumed in resolve().
        self.audit = None

    def resolve(self, value) -> None:
        self.value = value
        # Shadow-audit offer BEFORE done.set(): once a caller observes the
        # response, the sampling decision has already been recorded, so a
        # drain at any quiesce point sees a deterministic count. The value
        # is already host numbers; the offer copies nothing off the device.
        if self.audit is not None:
            auditor, view = self.audit
            auditor.offer(self.kind, self.payload, value, view)
        self.t_done = time.monotonic()
        self.done.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.t_done = time.monotonic()
        self.done.set()

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit

    def result(self, timeout: float | None = 30.0):
        if not self.done.wait(timeout):
            raise TimeoutError(f"{self.kind} query not served in {timeout}s")
        if self.error is not None:
            raise self.error
        return self.value


class QueryEngine:
    """Coalesces concurrent queries into per-tick microbatches.

    ``source`` is a :class:`~analyzer_tpu_torch.serve.view.ViewPublisher`
    (or anything with ``current() -> RatingsView | None``) whose views
    live on ``device`` (None = the card). Two driving modes:

      * **threaded** (:meth:`start` — the server wiring): a
        tick thread wakes on submissions, drains the queue, and executes
        one microbatch per kind;
      * **inline** (default — tests, naive baselines): blocking helpers
        execute their own single-request microbatch; ``submit`` +
        :meth:`tick` give a test deterministic coalescing control.

    Every result dict carries ``version`` — the exactly-one published
    version it was computed against. ``auditor`` (an
    :class:`~analyzer_tpu_torch.obs.audit.ShadowAuditor`, also settable
    as the attribute, as the worker does) is offered every successfully
    resolved response at the end of its microbatch: one seeded hash and,
    for the sampled few, a bounded append; the oracle replay runs in the
    auditor's ``drain``, off the serving path.
    """

    def __init__(
        self,
        source,
        cfg: RatingConfig | None = None,
        max_batch: int = 256,
        tick_interval_s: float = 0.001,
        tier_edges=None,
        clock=time.monotonic,
        device=None,
        auditor=None,
    ) -> None:
        self.auditor = auditor
        self.device = resolve_device(device)
        self.source = source
        self.cfg = cfg or RatingConfig()
        self.max_batch = int(max_batch)
        self.tick_interval_s = tick_interval_s
        self.tier_edges = np.asarray(
            tier_edges if tier_edges is not None else DEFAULT_TIER_EDGES,
            np.float32,
        )
        self.clock = clock
        self.queries_total = 0
        self._pending: deque[_Pending] = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._stop = False
        # Version-keyed result caches (leaderboard / tiers / the sorted
        # rated scores behind every count): one entry each — a new publish
        # changes the version and naturally evicts.
        self._lb_cache: tuple[int, int, np.ndarray, np.ndarray] | None = None
        self._tier_cache: tuple[int, list] | None = None
        self._score_cache: tuple[int, torch.Tensor] | None = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "QueryEngine":
        """Starts the tick thread (idempotent)."""
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(
                target=self._tick_loop, name="analyzer-ratesrv-tick",
                daemon=True,
            )
            self._thread.start()
        return self

    def close(self) -> None:
        """Stops the tick thread; queued requests fail cleanly."""
        thread, self._thread = self._thread, None
        if thread is None:
            return
        self._stop = True
        self._wake.set()
        thread.join(timeout=5)
        with self._lock:
            stranded = list(self._pending)
            self._pending.clear()
        for req in stranded:
            req.fail(RuntimeError("query engine closed"))

    # -- request API ------------------------------------------------------
    def submit(self, kind: str, payload=None) -> _Pending:
        """Enqueues a request for the next tick (threaded mode) or for an
        explicit :meth:`tick` call, returning the pending handle."""
        if kind not in _KINDS:
            raise ValueError(f"unknown query kind {kind!r}")
        req = _Pending(kind, payload)
        with self._lock:
            self._pending.append(req)
        self._wake.set()
        return req

    def _call(self, kind: str, payload=None):
        if self._thread is not None:
            return self.submit(kind, payload).result()
        req = _Pending(kind, payload)
        self._execute([req])
        return req.result(timeout=0)

    def get_ratings(self, player_ids) -> dict:
        """Rating lookup: shared + per-mode (mu, sigma) for each id."""
        return self._call("ratings", tuple(player_ids))

    def win_probability(self, team_a, team_b) -> dict:
        """P(team_a beats team_b) + match quality for one matchup."""
        return self._call("winprob", (tuple(team_a), tuple(team_b)))

    def leaderboard(self, k: int = 10) -> dict:
        """Top-k rated players by conservative estimate mu - 3*sigma."""
        return self._call("leaderboard", int(k))

    def tier_histogram(self) -> dict:
        """Rated-player counts per conservative-score tier band."""
        return self._call("tiers")

    def percentile(self, score: float) -> dict:
        """Fraction of rated players strictly below ``score``."""
        return self._call("percentile", float(score))

    # -- execution --------------------------------------------------------
    def tick(self) -> int:
        """Drains and executes up to ``max_batch`` queued requests per
        kind; returns how many requests were served. Tests drive this
        directly for deterministic coalescing."""
        with self._lock:
            reqs = list(self._pending)
            self._pending.clear()
        if not reqs:
            return 0
        overflow = self._execute(reqs)
        if overflow:
            with self._lock:
                self._pending.extendleft(reversed(overflow))
            self._wake.set()
        return len(reqs) - len(overflow)

    def _tick_loop(self) -> None:
        while not self._stop:
            self._wake.wait(timeout=0.2)
            self._wake.clear()
            if self._stop:
                return
            try:
                served = self.tick()
            except Exception:  # noqa: BLE001 — a tick crash must not
                # silently kill the serving thread; per-request errors
                # were already routed, so log and keep ticking.
                logger.exception("serve tick failed")
                continue
            if served and self.tick_interval_s:
                # A short lag window lets the next burst of concurrent
                # requests pile up into one microbatch instead of each
                # opening its own tick (Clipper's batching delay).
                time.sleep(self.tick_interval_s)

    def warmup(self, view: RatingsView | None = None) -> int:
        """Runs every device function once against the current view at the
        smallest request bucket, so no production query pays the first
        call's one-time costs (CUDA context, allocator pools, the
        per-version sorts). The JAX package walks its whole shape ladder
        here because every shape compiles; nothing compiles here, so one
        call per function is all there is to warm. Returns the number of
        device functions run."""
        view = view or self._current_view()
        qb = QUERY_BUCKET_FLOOR
        t = MAX_TEAM_SIZE
        self._ratings_rows(view, np.full(qb, view.pad_row, np.int32))
        self._team_stats_host(
            view, np.full((qb, 2, t), view.pad_row, np.int32),
            np.zeros((qb, 2, t), bool),
        )
        self._percentile_counts(view, np.zeros(qb, np.float32))
        self._tier_ge(view)
        _leaderboard(view.table, min(qb, view.table.shape[0]))
        self._sync()
        return 5

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """A tick's padded host array on the engine's device."""
        return torch.from_numpy(arr).to(self.device)

    def _current_view(self) -> RatingsView:
        src = self.source
        view = src.current() if hasattr(src, "current") else src()
        if view is None:
            raise RuntimeError(
                "no ratings view published yet (serve.view readiness)"
            )
        return view

    def _execute(self, reqs: list) -> list:
        """Runs one microbatch per kind against ONE view snapshot.
        Returns requests deferred to the next tick (per-kind max_batch
        overflow). Request-level failures (unknown ids, bad payloads)
        resolve that request's error without touching its batchmates."""
        try:
            view = self._current_view()
        except Exception as err:  # noqa: BLE001 — no view / dead source:
            # every request fails cleanly rather than hanging forever.
            for req in reqs:
                req.fail(err)
            return []
        reg = get_registry()
        reg.gauge("serve.view_age_seconds").set(round(view.age_s, 3))
        by_kind: dict[str, list] = {}
        overflow: list = []
        id_cap = self.max_batch * RATINGS_ID_FACTOR
        ids_in_batch = 0
        for req in reqs:
            group = by_kind.setdefault(req.kind, [])
            if req.kind == "ratings":
                # Ratings coalesce by TOTAL id count (one request can
                # carry a page of ids); the gather bucket ladder caps it.
                n_ids = max(len(req.payload), 1)
                if len(group) >= self.max_batch or (
                    group and ids_in_batch + n_ids > id_cap
                ):
                    overflow.append(req)
                else:
                    group.append(req)
                    ids_in_batch += n_ids
            elif len(group) >= self.max_batch:
                overflow.append(req)
            else:
                group.append(req)
        for kind, group in by_kind.items():
            reg.counter("serve.queries_total").add(len(group))
            reg.counter("serve.queries_total", kind=kind).add(len(group))
            self.queries_total += len(group)
            if self.auditor is not None:
                for req in group:
                    req.audit = (self.auditor, view)
            try:
                getattr(self, "_run_" + kind)(view, group)
            except Exception as err:  # noqa: BLE001 — a kernel-level
                # failure answers the whole microbatch; the engine and
                # its other kinds keep serving.
                logger.exception("serve microbatch %s failed", kind)
                for req in group:
                    if not req.done.is_set():
                        req.fail(err)
        return overflow

    @staticmethod
    def _resolve_or_fail(view: RatingsView, ids, req: _Pending):
        rows = []
        missing = []
        for pid in ids:
            row = view.resolve(pid)
            if row is None:
                missing.append(pid)
            else:
                rows.append(row)
        if missing:
            req.fail(UnknownPlayerError(missing))
            return None
        return rows

    def _observe_occupancy(self, kind: str, filled: int, bucket: int) -> None:
        get_registry().histogram(
            "serve.microbatch_occupancy", kind=kind
        ).observe(filled / bucket if bucket else 0.0)

    # -- per-kind microbatches -------------------------------------------
    def _ratings_gather(self, view, flat: list) -> np.ndarray:
        """ONE padded whole-row gather for the tick's coalesced ids."""
        qb = query_bucket(
            max(len(flat), 1), self.max_batch * RATINGS_ID_FACTOR
        )
        if len(flat) > qb:
            raise ValueError(
                f"{len(flat)} ids in one ratings microbatch exceeds the "
                f"engine cap {qb}; split the request"
            )
        idx = np.full(qb, view.pad_row, np.int32)
        if flat:
            idx[: len(flat)] = flat
        self._observe_occupancy("ratings", len(flat), qb)
        return self._ratings_rows(view, idx)

    def _ratings_rows(self, view, idx: np.ndarray) -> np.ndarray:
        return _gather_rows(view.table, self._dev(idx).long()).cpu().numpy()

    def _run_ratings(self, view, group: list) -> None:
        """All requests' ids coalesce into ONE padded gather."""
        flat: list[int] = []
        spans: list = []  # (req, start, ids, unknown)
        for req in group:
            ids = req.payload
            start = len(flat)
            known = []
            unknown = []
            for pid in ids:
                row = view.resolve(pid)
                if row is None:
                    unknown.append(pid)
                else:
                    known.append((pid, row))
                    flat.append(row)
            spans.append((req, start, known, unknown))
        rows = self._ratings_gather(view, flat)
        for req, start, known, unknown in spans:
            out = []
            for j, (pid, _row) in enumerate(known):
                r = rows[start + j]
                mu, sg = float(r[MU_LO]), float(r[SIGMA_LO])
                rated = not math.isnan(mu)
                out.append({
                    "id": pid,
                    "rated": rated,
                    "mu": mu if rated else None,
                    "sigma": sg if rated else None,
                    "conservative": (
                        float(_host_conservative(r[MU_LO], r[SIGMA_LO]))
                        if rated else None
                    ),
                    "seed_mu": float(r[COL_SEED_MU]),
                    "seed_sigma": float(r[COL_SEED_SIGMA]),
                })
            req.resolve({
                "version": view.version, "ratings": out, "unknown": unknown,
            })

    def _winprob_stats(self, view, live: list):
        """(n, s2, mu_diff) float32 arrays (length >= len(live)) for the
        tick's matchups — one ``_team_stats`` dispatch."""
        t = MAX_TEAM_SIZE
        q = len(live)
        qb = query_bucket(q, self.max_batch)
        idx = np.full((qb, 2, t), view.pad_row, np.int32)
        mask = np.zeros((qb, 2, t), bool)
        for i, (_req, rows_a, rows_b) in enumerate(live):
            idx[i, 0, : len(rows_a)] = rows_a
            idx[i, 1, : len(rows_b)] = rows_b
            mask[i, 0, : len(rows_a)] = True
            mask[i, 1, : len(rows_b)] = True
        self._observe_occupancy("winprob", q, qb)
        return self._team_stats_host(view, idx, mask)

    def _team_stats_host(self, view, idx: np.ndarray, mask: np.ndarray):
        return tuple(
            x.cpu().numpy() for x in _team_stats(
                view.table, self._dev(idx).long(), self._dev(mask),
                idx.shape[-1],
            )
        )

    def _run_winprob(self, view, group: list) -> None:
        """[Q, 2, T] matchups -> one _team_stats dispatch + host finish."""
        t = MAX_TEAM_SIZE
        live: list = []
        for req in group:
            a, b = req.payload
            if not (1 <= len(a) <= t and 1 <= len(b) <= t):
                req.fail(ValueError(
                    f"teams must have 1..{t} players (got {len(a)} vs "
                    f"{len(b)})"
                ))
                continue
            rows_a = self._resolve_or_fail(view, a, req)
            if rows_a is None:
                continue
            rows_b = self._resolve_or_fail(view, b, req)
            if rows_b is None:
                continue
            live.append((req, rows_a, rows_b))
        if not live:
            return
        q = len(live)
        n, s2, mu_diff = self._winprob_stats(view, live)
        beta2 = self.cfg.beta2
        p = _finish_winprob(n[:q], s2[:q], mu_diff[:q], beta2)
        quality = _finish_quality(n[:q], s2[:q], mu_diff[:q], beta2)
        for i, (req, _ra, _rb) in enumerate(live):
            req.resolve({
                "version": view.version,
                "p_a": float(p[i]),
                "quality": float(quality[i]),
            })

    def _leaderboard_rows(self, view, k: int):
        """(scores, rows) for the top-k_bucket, version-keyed cache."""
        rows_total = view.table.shape[0]
        kb = min(query_bucket(k, rows_total), rows_total)
        cached = self._lb_cache
        if cached is not None and cached[0] == view.version and cached[1] >= kb:
            get_registry().counter("serve.leaderboard_cache_hits_total").add(1)
            return cached[2], cached[3]
        vals, idx = _leaderboard(view.table, kb)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        self._lb_cache = (view.version, kb, vals, idx)
        return vals, idx

    def _leader_rows(self, view, rows_idx: list) -> np.ndarray:
        """``[len(rows_idx), 16]`` float32 response rows for the winning
        rows: one device gather of just those rows (the JAX engine slices
        its cached host mirror; fetching the whole table per version
        would move far more than the k rows a response formats)."""
        if not rows_idx:
            return np.empty((0, view.table.shape[1]), np.float32)
        return self._ratings_rows(view, np.asarray(rows_idx, np.int64))

    def _run_leaderboard(self, view, group: list) -> None:
        kmax = max(req.payload for req in group)
        self._observe_occupancy("leaderboard", len(group), len(group))
        vals, idx = self._leaderboard_rows(view, kmax)
        cut = 0
        while cut < min(kmax, len(vals)) and math.isfinite(vals[cut]):
            cut += 1  # the -inf tail = fewer than k rated players
        rows_host = self._leader_rows(view, [int(r) for r in idx[:cut]])
        for req in group:
            k = req.payload
            leaders = []
            for rank in range(min(k, cut)):
                row = int(idx[rank])
                leaders.append({
                    "rank": rank + 1,
                    "id": view.id_of(row),
                    "mu": float(rows_host[rank, MU_LO]),
                    "sigma": float(rows_host[rank, SIGMA_LO]),
                    "conservative": float(vals[rank]),
                })
            req.resolve({"version": view.version, "leaders": leaders})

    def _tier_ge(self, view) -> tuple[list, int]:
        """(>= edge counts, rated total), as Python ints."""
        ge, rated = _tier_counts(
            self._sorted_scores(view), self._dev(self.tier_edges)
        )
        return [int(x) for x in ge.cpu().numpy()], int(rated)

    def _sorted_scores(self, view) -> torch.Tensor:
        """The view's rated scores, ascending — sorted once per version."""
        cached = self._score_cache
        if cached is None or cached[0] != view.version:
            cached = (view.version, _sorted_rated_scores(view.table))
            self._score_cache = cached
        return cached[1]

    def _run_tiers(self, view, group: list) -> None:
        self._observe_occupancy("tiers", len(group), len(group))
        cached = self._tier_cache
        if cached is not None and cached[0] == view.version:
            get_registry().counter("serve.tier_cache_hits_total").add(1)
            value = cached[1]
        else:
            ge, rated = self._tier_ge(view)
            counts = [rated - ge[0]]
            counts += [ge[i] - ge[i + 1] for i in range(len(ge) - 1)]
            counts.append(ge[-1])
            value = {
                "edges": [float(e) for e in self.tier_edges],
                "counts": counts,
                "rated": rated,
            }
            self._tier_cache = (view.version, value)
        for req in group:
            req.resolve({"version": view.version, **value})

    def _percentile_counts(self, view, vals: np.ndarray):
        """(below counts, rated total) for the padded query values."""
        below, rated = _count_below(self._sorted_scores(view), self._dev(vals))
        return below.cpu().numpy(), int(rated)

    def _run_percentile(self, view, group: list) -> None:
        q = len(group)
        qb = query_bucket(q, self.max_batch)
        vals = np.zeros(qb, np.float32)
        for i, req in enumerate(group):
            vals[i] = req.payload
        self._observe_occupancy("percentile", q, qb)
        below, rated = self._percentile_counts(view, vals)
        for i, req in enumerate(group):
            req.resolve({
                "version": view.version,
                "score": float(np.float32(req.payload)),
                "below": int(below[i]),
                "rated": rated,
                "percentile": (int(below[i]) / rated) if rated else None,
            })

    # -- naive baseline ---------------------------------------------------
    def query_now(self, kind: str, payload=None):
        """The NAIVE one-query-per-dispatch path: executes a single
        request immediately on the calling thread with no coalescing —
        the baseline a microbatched engine is measured against. Same
        device functions, same buckets, one dispatch per call."""
        req = _Pending(kind, payload)
        self._execute([req])
        return req.result(timeout=0)

    def stats(self) -> dict:
        """The serve keys a co-hosting service re-exports."""
        src = self.source
        view = src.current() if hasattr(src, "current") else src()
        return {
            "view_version": None if view is None else view.version,
            "view_age_s": (
                None if view is None else round(view.age_s, 3)
            ),
            "queries_total": self.queries_total,
        }


@runtime_checkable
class ServePlane(Protocol):
    """The topology-blind serving surface: everything above the engine
    — ``serve/server.py``'s ``/v1/*`` routes, ``cli serve`` — programs
    against THIS, so the single-device :class:`QueryEngine` and the
    :class:`ShardedQueryEngine` interchange without a caller edit."""

    max_batch: int

    def start(self): ...

    def close(self) -> None: ...

    def warmup(self, view=None) -> int: ...

    def get_ratings(self, player_ids) -> dict: ...

    def win_probability(self, team_a, team_b) -> dict: ...

    def leaderboard(self, k: int = 10) -> dict: ...

    def tier_histogram(self) -> dict: ...

    def percentile(self, score: float) -> dict: ...

    def stats(self) -> dict: ...




class ShardedQueryEngine(QueryEngine):
    """The sharded plane's engine: point lookups route by player-id ->
    shard (the mesh's interleaved layout, ``serve/view.py:shard_of_row``)
    and coalesce into PER-SHARD microbatches on the same power-of-two
    buckets; leaderboards run per-shard top-k (the stable sort of
    :func:`_leaderboard`) + a host merge of the S·k candidates; tier
    histograms and percentiles sum per-shard partial counts on the host
    (exact integers). ``source`` is a
    :class:`~analyzer_tpu_torch.serve.view.ShardedViewPublisher`; each
    shard's work runs on the device its table lives on.

    Bit-identity contract: every response equals the single-device
    :class:`QueryEngine`'s and the pure-Python oracle's, bit for bit —
    gathers move identical float32 rows, the winprob reduction replays
    :func:`_team_stats`' pinned float32 order on the host, the leaderboard
    merge key ``(-score, global_row)`` reproduces the stable sort's
    tie order on the unsharded table, and count sums are integer-exact.

    ``all_gather_topk=True`` replaces the S per-shard sorts with ONE sort
    over the stacked ``[S, A+1]`` score tensor where all shards share a
    device (per device, concatenated in shard order, where they do not):
    the same candidates, the same merge — one dispatch instead of S."""

    def __init__(
        self,
        source,
        cfg: RatingConfig | None = None,
        max_batch: int = 256,
        tick_interval_s: float = 0.001,
        tier_edges=None,
        clock=time.monotonic,
        all_gather_topk: bool = False,
        device=None,
        auditor=None,
    ) -> None:
        super().__init__(
            source,
            cfg=cfg,
            max_batch=max_batch,
            tick_interval_s=tick_interval_s,
            tier_edges=tier_edges,
            clock=clock,
            device=device,
            auditor=auditor,
        )
        self.all_gather_topk = bool(all_gather_topk)
        # Winprob flattens up to max_batch * 2T ids through the routed
        # gather: the gather bucket covers whichever coalescing cap is
        # larger.
        self._gather_cap = self.max_batch * max(
            RATINGS_ID_FACTOR, 2 * MAX_TEAM_SIZE
        )
        self._shard_scores: tuple[int, list] | None = None

    # -- routed gathers ---------------------------------------------------
    def _sharded_gather(self, view, flat: list) -> np.ndarray:
        """Whole-row gather for GLOBAL rows ``flat``, routed by owner shard:
        one padded gather per shard that owns any of the tick's rows,
        results scattered back into request order on the host — never a
        whole-table transfer."""
        if len(flat) > self._gather_cap:
            raise ValueError(
                f"{len(flat)} ids in one routed microbatch exceeds the "
                f"engine cap {self._gather_cap}; split the request"
            )
        n_shards = view.n_shards
        out = np.empty((len(flat), view.shards[0].table.shape[1]), np.float32)
        per: list[list] = [[] for _ in range(n_shards)]
        for pos, row in enumerate(flat):
            per[row % n_shards].append((pos, row // n_shards))
        reg = get_registry()
        for d, pairs in enumerate(per):
            if not pairs:
                continue
            shard = view.shards[d]
            qb = query_bucket(len(pairs), self._gather_cap)
            idx = np.full(qb, shard.pad_row, np.int64)
            idx[: len(pairs)] = [loc for _pos, loc in pairs]
            reg.counter("serve.shard.queries_total", shard=str(d)).add(
                len(pairs)
            )
            rows = _gather_rows(
                shard.table, torch.from_numpy(idx).to(shard.table.device)
            ).cpu().numpy()
            out[[pos for pos, _loc in pairs]] = rows[: len(pairs)]
        return out

    def _ratings_gather(self, view, flat: list) -> np.ndarray:
        qb = query_bucket(
            max(len(flat), 1), self.max_batch * RATINGS_ID_FACTOR
        )
        if len(flat) > qb:
            raise ValueError(
                f"{len(flat)} ids in one ratings microbatch exceeds the "
                f"engine cap {qb}; split the request"
            )
        self._observe_occupancy("ratings", len(flat), qb)
        return self._sharded_gather(view, flat)

    def _winprob_stats(self, view, live: list):
        """Routed row gathers + :func:`_team_stats`' fixed-order float32
        team reduction replayed on the host: every add and multiply below
        is a correctly-rounded ``np.float32`` primitive in the same
        team-major slot-minor order from zero, so the statistics — and the
        float64 finish downstream — carry the single plane's bits."""
        q = len(live)
        qb = query_bucket(q, self.max_batch)
        self._observe_occupancy("winprob", q, qb)
        flat: list[int] = []
        for _req, rows_a, rows_b in live:
            flat.extend(rows_a)
            flat.extend(rows_b)
        rows = self._sharded_gather(view, flat)
        one = np.float32(1.0)
        n = np.zeros(q, np.float32)
        s2 = np.zeros(q, np.float32)
        mu_diff = np.zeros(q, np.float32)
        pos = 0
        for i, (_req, rows_a, rows_b) in enumerate(live):
            acc_n = np.float32(0.0)
            acc_s2 = np.float32(0.0)
            team_mu = [np.float32(0.0), np.float32(0.0)]
            for t, team_rows in enumerate((rows_a, rows_b)):
                for _row in team_rows:
                    r = rows[pos]
                    pos += 1
                    mu = np.float32(r[MU_LO])
                    sg = np.float32(r[SIGMA_LO])
                    if math.isnan(float(mu)):
                        mu = np.float32(r[COL_SEED_MU])
                        sg = np.float32(r[COL_SEED_SIGMA])
                    acc_n = np.float32(acc_n + one)
                    acc_s2 = np.float32(acc_s2 + np.float32(sg * sg))
                    team_mu[t] = np.float32(team_mu[t] + mu)
            n[i] = acc_n
            s2[i] = acc_s2
            mu_diff[i] = np.float32(team_mu[0] - team_mu[1])
        return n, s2, mu_diff

    # -- distributed top-k ------------------------------------------------
    def _shard_topk(self, view, kb: int):
        """(vals, local_idx) ``[S, kb]``: a stable descending sort per
        shard, or one sort per device over the stacked score columns
        (``all_gather_topk``)."""
        reg = get_registry()
        n_shards = view.n_shards
        vals = np.empty((n_shards, kb), np.float32)
        idx = np.empty((n_shards, kb), np.int64)
        if self.all_gather_topk:
            by_device: dict = {}
            for d, shard in enumerate(view.shards):
                by_device.setdefault(shard.table.device, []).append(d)
            for shards in by_device.values():
                scores = []
                for d in shards:
                    score, rated = _scores(view.shards[d].table)
                    scores.append(torch.where(
                        rated, score, torch.full_like(score, -math.inf)))
                v, i = torch.sort(torch.stack(scores), dim=1,
                                  descending=True, stable=True)
                vals[shards] = v[:, :kb].cpu().numpy()
                idx[shards] = i[:, :kb].cpu().numpy()
            for d in range(n_shards):
                reg.counter("serve.shard.queries_total", shard=str(d)).add(1)
            return vals, idx
        for d, shard in enumerate(view.shards):
            v, i = _leaderboard(shard.table, kb)
            vals[d] = v.cpu().numpy()
            idx[d] = i.cpu().numpy()
            reg.counter("serve.shard.queries_total", shard=str(d)).add(1)
        return vals, idx

    def _leaderboard_rows(self, view, k: int):
        """Per-shard top-k_bucket + host merge of the S·k candidates. The
        merge key ``(-score, global_row)`` with global row ``local*S + d``
        reproduces the single plane's descending order and low-row
        tie-break on the unsharded table — ties that span shard boundaries
        included."""
        rows_local = view.shards[0].table.shape[0]
        kb = min(query_bucket(k, rows_local), rows_local)
        cached = self._lb_cache
        if cached is not None and cached[0] == view.version and cached[1] >= kb:
            get_registry().counter("serve.leaderboard_cache_hits_total").add(1)
            kb, vals_s, idx_s = cached[1], cached[2], cached[3]
        else:
            vals_s, idx_s = self._shard_topk(view, kb)
            self._lb_cache = (view.version, kb, vals_s, idx_s)
        n_shards = view.n_shards
        reg = get_registry()
        reg.counter("serve.shard.merges_total").add(1)
        reg.counter("serve.shard.merge_candidates_total").add(n_shards * kb)
        entries = []
        for d in range(n_shards):
            for j in range(kb):
                v = float(vals_s[d, j])
                if not math.isfinite(v):
                    break  # the shard's rated rows ran out (-inf tail)
                entries.append((v, int(idx_s[d, j]) * n_shards + d, vals_s[d, j]))
        merged = merge_topk_candidates(entries)
        vals = np.array([c[2] for c in merged], np.float32)
        idx = np.array([c[1] for c in merged], np.int64)
        return vals, idx

    def _leader_rows(self, view, rows_idx: list) -> np.ndarray:
        """Routed per-shard gathers for the winning rows (chunked to the
        gather cap): the bits a host-table slice would carry, without a
        cross-shard table reassembly on the serving path."""
        width = view.shards[0].table.shape[1]
        out = np.empty((len(rows_idx), width), np.float32)
        for lo in range(0, len(rows_idx), self._gather_cap):
            chunk = list(rows_idx[lo: lo + self._gather_cap])
            out[lo: lo + len(chunk)] = self._sharded_gather(view, chunk)
        return out

    # -- per-shard partial counts ----------------------------------------
    def _sorted_shard_scores(self, view) -> list:
        """Each shard's rated scores, ascending — sorted once per version."""
        cached = self._shard_scores
        if cached is None or cached[0] != view.version:
            cached = (view.version, [
                _sorted_rated_scores(shard.table) for shard in view.shards
            ])
            self._shard_scores = cached
        return cached[1]

    def _tier_ge(self, view) -> tuple[list, int]:
        reg = get_registry()
        ge = np.zeros(len(self.tier_edges), np.int64)
        rated = 0
        for d, scores in enumerate(self._sorted_shard_scores(view)):
            edges = torch.from_numpy(self.tier_edges).to(scores.device)
            g, r = _tier_counts(scores, edges)
            ge += g.cpu().numpy().astype(np.int64)
            rated += int(r)
            reg.counter("serve.shard.queries_total", shard=str(d)).add(1)
        return [int(x) for x in ge], rated

    def _percentile_counts(self, view, vals: np.ndarray):
        below = np.zeros(len(vals), np.int64)
        rated = 0
        for scores in self._sorted_shard_scores(view):
            b, r = _count_below(scores, torch.from_numpy(vals).to(scores.device))
            below += b.cpu().numpy().astype(np.int64)
            rated += int(r)
        return below, rated

    # -- lifecycle --------------------------------------------------------
    def warmup(self, view=None) -> int:
        """Runs every device function once against every shard of the
        current view (on each shard's device) at the smallest request
        bucket, so no production query pays a first call's one-time costs.
        Returns the number of device functions run."""
        view = view or self._current_view()
        qb = QUERY_BUCKET_FLOOR
        calls = 0
        for shard in view.shards:
            pad = torch.full((qb,), shard.pad_row, dtype=torch.long,
                             device=shard.table.device)
            _gather_rows(shard.table, pad)
            _leaderboard(shard.table, min(qb, shard.table.shape[0]))
            calls += 2
        self._tier_ge(view)
        self._percentile_counts(view, np.zeros(qb, np.float32))
        calls += 2 * view.n_shards
        if self.all_gather_topk:
            self._shard_topk(view, min(qb, view.shards[0].table.shape[0]))
            calls += 1
        for shard in view.shards:
            if shard.table.is_cuda:
                torch.cuda.synchronize(shard.table.device)
        get_registry().gauge("serve.shards").set(view.n_shards)
        return calls
