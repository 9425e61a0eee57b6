"""Continuous shadow audit: replay a sample of LIVE served queries
through the bit-exact oracle.

The port's own copy of ``analyzer_tpu.obs.audit``, with the same sampling
and the same replay. The serving plane's numerical contract — every served
number equals the pure-Python float32 oracle bit for bit
(``serve/oracle.py``) — is a test-time property by itself. On the card it
also rests on how the kernels were compiled and on the driver, so the
auditor makes it a MONITORED invariant while the plane serves:

  * the query engine offers every successfully served response to the
    auditor at resolution time (one hash + one bounded-deque append —
    nothing on the serving path waits for a replay, and nothing is
    copied off the device: the response is already host values, and the
    entry keeps a reference to the view it was computed against);
  * the auditor keeps a DETERMINISTIC sample: a seeded BLAKE2 hash of
    the query key (kind + payload) selects 1-in-``sample_denom``
    queries, so the sampled set is a pure function of (seed, traffic) —
    identical across runs and whether anything drains it, and equal to
    the JAX package's for the same seed and keys;
  * ``drain()`` — called OFF the hot path (the worker's poll-loop SLO
    tick, explicit in tests) — replays each sampled response against the
    served view's host table (``view.host_table()``, one device-to-host
    copy per view version) through :mod:`analyzer_tpu_torch.serve.oracle`
    and compares BIT FOR BIT;
  * a divergence counts ``audit.mismatches_total`` (the zero-tolerance
    objective ``zero-audit-mismatches`` in :mod:`obs.slo` — the
    watchdog flips /readyz and captures evidence), drops a flight-
    recorder breadcrumb naming the query, and keeps a bounded
    mismatch list for the artifact/operator.

A pending entry pins its view — the version's device table — until it is
drained; :data:`MAX_PENDING` bounds the entries, and entries of one
version share one table.
"""

from __future__ import annotations

import hashlib
import math
import threading
from collections import deque

from analyzer_tpu_torch.logging_utils import get_logger
from analyzer_tpu_torch.obs.registry import get_registry

logger = get_logger(__name__)

#: Default sampling: 1 in N served queries replays through the oracle.
DEFAULT_SAMPLE_DENOM = 8

#: Bounded replay queue — each entry pins its view until drained, so
#: the cap bounds both memory and view retention.
MAX_PENDING = 256

#: Bounded mismatch evidence list (full counts ride the counters).
MAX_MISMATCHES = 64


def query_key(kind: str, payload) -> str:
    """The canonical sampling key for one query. ``repr`` of the
    engine's payload tuples is deterministic (strings/ints/tuples)."""
    return f"{kind}:{payload!r}"


def sampled(key: str, seed: int, denom: int) -> bool:
    """The deterministic sampling decision: a seeded BLAKE2 of the
    query key, 1-in-``denom``. Pure function of (seed, key) — no RNG
    state, no clock, no ordering dependence."""
    if denom <= 1:
        return True
    h = hashlib.blake2s(
        key.encode(), salt=str(seed).encode()[:8]
    ).digest()
    return int.from_bytes(h[:8], "big") % denom == 0


class ShadowAuditor:
    """The audit pipeline: ``offer`` on the serving path (cheap,
    sampled), ``drain`` off it (oracle replay + bit compare)."""

    def __init__(
        self,
        cfg=None,
        tier_edges=None,
        seed: int = 0,
        sample_denom: int = DEFAULT_SAMPLE_DENOM,
        max_pending: int = MAX_PENDING,
    ) -> None:
        from analyzer_tpu_torch.config import RatingConfig

        self.cfg = cfg or RatingConfig()
        self.tier_edges = tier_edges
        self.seed = int(seed)
        self.sample_denom = max(1, int(sample_denom))
        self._lock = threading.Lock()
        self._pending: deque = deque(maxlen=max_pending)
        self.offered = 0
        self.sampled = 0
        self.checked = 0
        self.mismatch_count = 0
        self.dropped = 0
        self.mismatches: list[dict] = []

    # -- serving-path half -------------------------------------------------
    def offer(self, kind: str, payload, response, view) -> bool:
        """Called by the engine at response resolution: one hash, one
        append when sampled. Returns whether the query was sampled.
        Never raises into the serving path."""
        try:
            self.offered += 1
            key = query_key(kind, payload)
            if not sampled(key, self.seed, self.sample_denom):
                return False
            with self._lock:
                if len(self._pending) == self._pending.maxlen:
                    self.dropped += 1
                self._pending.append((kind, payload, response, view))
            self.sampled += 1
            get_registry().counter("audit.sampled_total").add(1)
            get_registry().gauge("audit.backlog").set(len(self._pending))
            return True
        except Exception:  # noqa: BLE001 — the audit must never cost a query
            logger.exception("shadow-audit offer failed")
            return False

    # -- off-hot-path half -------------------------------------------------
    def drain(self, limit: int | None = None) -> int:
        """Replays up to ``limit`` pending samples through the oracle
        (None = everything queued). Returns how many were checked."""
        checked = 0
        while limit is None or checked < limit:
            with self._lock:
                if not self._pending:
                    break
                kind, payload, response, view = self._pending.popleft()
            self._check(kind, payload, response, view)
            checked += 1
        if checked:
            reg = get_registry()
            reg.counter("audit.checked_total").add(checked)
            reg.gauge("audit.backlog").set(len(self._pending))
        return checked

    @property
    def backlog(self) -> int:
        with self._lock:
            return len(self._pending)

    def stats(self) -> dict:
        """The artifact's ``audit`` block / operator summary."""
        return {
            "enabled": True,
            "sample_denom": self.sample_denom,
            "offered": self.offered,
            "sampled": self.sampled,
            "checked": self.checked,
            "mismatches": self.mismatch_count,
            "dropped": self.dropped,
            "backlog": self.backlog,
        }

    # -- the oracle replay -------------------------------------------------
    def _check(self, kind: str, payload, response, view) -> None:
        try:
            expected = self._replay(kind, payload, view)
        except Exception as err:  # noqa: BLE001 — a replay crash is an
            # audit failure, not a serving failure; surface it as a
            # mismatch so it cannot rot silently.
            expected = f"<replay error: {err!r}>"
        self.checked += 1
        if expected == response:
            return
        self.mismatch_count += 1
        get_registry().counter("audit.mismatches_total").add(1)
        record = {
            "kind": kind,
            "key": query_key(kind, payload),
            "version": getattr(view, "version", None),
            "served": response,
            "oracle": expected,
        }
        if len(self.mismatches) < MAX_MISMATCHES:
            self.mismatches.append(record)
        logger.error(
            "SHADOW AUDIT MISMATCH: %s v%s served %r, oracle says %r",
            record["key"], record["version"], response, expected,
        )
        from analyzer_tpu_torch.obs.flight import get_flight_recorder

        get_flight_recorder().note(
            "audit.mismatch", query_kind=kind, key=record["key"],
            version=record["version"],
        )

    def _replay(self, kind: str, payload, view) -> dict:
        """Reconstructs the response the engine SHOULD have served,
        from the view's host table through the pure-Python oracle —
        every float the engine emitted retraced in the same float32
        order (serve/oracle.py's parity contract)."""
        from analyzer_tpu_torch.core.state import (
            COL_SEED_MU,
            COL_SEED_SIGMA,
            MU_LO,
            SIGMA_LO,
        )
        from analyzer_tpu_torch.serve import oracle

        table = view.host_table()
        version = view.version
        if kind == "ratings":
            out = []
            unknown = []
            for pid in payload:
                row = view.resolve(pid)
                if row is None:
                    unknown.append(pid)
                    continue
                mu = float(table[row, MU_LO])
                rated = not math.isnan(mu)
                out.append({
                    "id": pid,
                    "rated": rated,
                    "mu": mu if rated else None,
                    "sigma": float(table[row, SIGMA_LO]) if rated else None,
                    "conservative": (
                        float(oracle.conservative_score(table, row))
                        if rated else None
                    ),
                    "seed_mu": float(table[row, COL_SEED_MU]),
                    "seed_sigma": float(table[row, COL_SEED_SIGMA]),
                })
            return {"version": version, "ratings": out, "unknown": unknown}
        if kind == "winprob":
            team_a, team_b = payload
            rows_a = [view.resolve(p) for p in team_a]
            rows_b = [view.resolve(p) for p in team_b]
            beta2 = self.cfg.beta2
            return {
                "version": version,
                "p_a": float(
                    oracle.win_probability(table, rows_a, rows_b, beta2)
                ),
                "quality": float(
                    oracle.quality(table, rows_a, rows_b, beta2)
                ),
            }
        if kind == "leaderboard":
            k = payload
            leaders = []
            for rank, (row, score) in enumerate(
                oracle.leaderboard(table, view.n_players, k)
            ):
                leaders.append({
                    "rank": rank + 1,
                    "id": view.id_of(row),
                    "mu": float(table[row, MU_LO]),
                    "sigma": float(table[row, SIGMA_LO]),
                    "conservative": float(score),
                })
            return {"version": version, "leaders": leaders}
        if kind == "tiers":
            edges = self.tier_edges
            if edges is None:
                from analyzer_tpu_torch.serve.engine import DEFAULT_TIER_EDGES

                edges = DEFAULT_TIER_EDGES
            counts, rated = oracle.tier_histogram(
                table, view.n_players, edges
            )
            return {
                "version": version,
                "edges": [float(e) for e in edges],
                "counts": counts,
                "rated": rated,
            }
        if kind == "percentile":
            below, rated = oracle.percentile(
                table, view.n_players, payload
            )
            import numpy as np

            return {
                "version": version,
                "score": float(np.float32(payload)),
                "below": below,
                "rated": rated,
                "percentile": (below / rated) if rated else None,
            }
        raise ValueError(f"unknown audited query kind {kind!r}")
