"""Rating-quality observability: the online calibration ledger.

The port's copy of ``analyzer_tpu.obs.quality`` (numpy + the port's
registry). The ledger scores every rated match's **pre-update** predicted
win probability — the serve plane's Phi link
(:func:`analyzer_tpu_torch.serve.oracle.win_probability`, the
sigma-inclusive form the read plane serves) over the batch's prior
ratings — against the realized outcome, and accumulates:

  * binned reliability counts (``quality.bin_count{bin=}`` /
    ``quality.bin_p_sum{bin=}`` / ``quality.bin_y_sum{bin=}``) plus
    streaming Brier score and log-loss, mirrored into ``quality.*``
    registry COUNTERS (counters sum, so a windowed ECE is exact from
    counter deltas);
  * population-drift telemetry: a mu-distribution PSI against a pinned
    reference window, and sigma convergence by games-played cohort;
  * a bounded prefix of (logit, outcome) pairs for temperature fitting
    (``cli quality --fit-temperature`` via models/calibration.py).

Clock-injected and deterministic: every timestamp is passed in by the
caller, and every bin edge and threshold lives in the ONE table below
(:data:`QUALITY_TABLE`).

Consumers: the worker's sequential commit site and its SLO tick's
population-drift snapshot (service/worker.py), obsd's ``/qualityz``
(obs/server.py), the calibration objective (obs/slo.py), ``cli quality``,
the soak artifact's ``quality`` block (loadgen/driver.py) and
:func:`score_table` — the staging-vs-live replay judge of ``cli migrate``
and the soak's migration block.
"""

from __future__ import annotations

import math
import threading

import numpy as np

#: The module's ONE table of bin edges and thresholds (equal to the JAX
#: package's: a pasted magic number elsewhere would silently fork the
#: calibration verdict every consumer is judged against).
QUALITY_TABLE = {
    # Reliability diagram: equal-width bins over predicted P(A wins).
    "bins": 10,
    # Probability clamp for log-loss and retained logits (matches the
    # spirit of models/calibration.py's own nll epsilon).
    "prob_eps": 1e-6,
    # Retained (logit, outcome) prefix for temperature fitting.
    "retain_max": 4096,
    # Population-drift PSI: histogram bins over the pinned reference's
    # mu range, smoothing epsilon, and the classic 0.25 alert floor.
    "psi_bins": 10,
    "psi_eps": 1e-4,
    "psi_alert": 0.25,
    # ECE alert floor — the calibration-floor objective's default
    # threshold (obs/slo.py STANDARD_OBJECTIVES reads the same number).
    "ece_alert": 0.25,
    # Minimum scored matches before any verdict (volume guard — low
    # enough that the default smoke soak's window is judged).
    "min_matches": 128,
    # Games-played cohort edges for sigma-convergence telemetry:
    # cohorts are [0, e0), [e0, e1), [e1, e2), [e2, inf).
    "cohort_edges": (5, 10, 20),
}


def _logit(p: float) -> float:
    eps = QUALITY_TABLE["prob_eps"]
    p = min(max(p, eps), 1.0 - eps)
    return math.log(p / (1.0 - p))


def ece_from_bins(p_sum, y_sum, total: float) -> float | None:
    """Expected calibration error from binned sums: the count-weighted
    mean |mean_p - mean_y| gap, which reduces to
    ``sum_b |p_sum_b - y_sum_b| / total``. This identity is what lets
    the live objective compute an EXACT windowed ECE from history-ring
    counter deltas (obs/slo.py ``calibration`` kind) — no extra state,
    and the same formula federates across hosts because counters sum."""
    if total <= 0:
        return None
    gap = 0.0
    for ps, ys in zip(p_sum, y_sum):
        gap += abs(float(ps) - float(ys))
    return gap / float(total)


class CalibrationLedger:
    """Streaming reliability/drift accounting for one worker.

    Single-writer (the worker's consume thread scores batches), multi-
    reader (``/qualityz`` and ``stats()`` snapshot under the lock).
    ``mirror=False`` (the replay judge) skips registry side effects so
    :func:`score_table` stays a pure function of its inputs.
    """

    def __init__(self, cfg, mirror: bool = True) -> None:
        self.cfg = cfg
        self._beta2 = float(cfg.beta2)
        self._mirror = mirror
        self._lock = threading.Lock()
        bins = int(QUALITY_TABLE["bins"])
        self._bins = bins
        self._bin_count = np.zeros(bins, dtype=np.int64)
        self._bin_p_sum = np.zeros(bins, dtype=np.float64)
        self._bin_y_sum = np.zeros(bins, dtype=np.float64)
        self._n = 0
        self._brier_sum = 0.0
        self._logloss_sum = 0.0
        # Bounded first-N retention for temperature fitting: the prefix
        # is deterministic per stream (no sampling RNG to seed).
        self._z: list[float] = []
        self._y: list[float] = []
        # The ledger's own games-played counts (rows -> rated matches
        # scored), feeding the sigma-convergence cohorts.
        self._games: dict[int, int] = {}
        # Population drift: reference histogram pinned at the first
        # observed window; latest snapshot kept for reporting.
        self._ref_edges: np.ndarray | None = None
        self._ref_frac: np.ndarray | None = None
        self._drift: dict | None = None

    # -- scoring ----------------------------------------------------------
    def score_batch(
        self, table, player_idx, winner, mode_id, afk, pad_row: int
    ) -> int:
        """Scores one committed batch against its PRE-update priors.

        ``table`` is a host ``[R, 16]`` prior snapshot (full table or a
        compact row gather — ``player_idx`` must index it), the stream
        arrays are host views of the batch's MatchStream. Only ratable
        matches (supported mode, no AFK) score — the same gate the
        rating kernel applies. Returns the number scored."""
        from analyzer_tpu_torch.serve.oracle import win_probability

        table = np.asarray(table)
        player_idx = np.asarray(player_idx)
        winner = np.asarray(winner)
        mode_id = np.asarray(mode_id)
        afk = np.asarray(afk)
        n_scored = 0
        bins = self._bins
        d_count = np.zeros(bins, dtype=np.int64)
        d_p = np.zeros(bins, dtype=np.float64)
        d_y = np.zeros(bins, dtype=np.float64)
        d_brier = 0.0
        d_logloss = 0.0
        eps = QUALITY_TABLE["prob_eps"]
        retain_max = int(QUALITY_TABLE["retain_max"])
        pairs: list[tuple[float, float]] = []
        games: list[int] = []
        for b in range(player_idx.shape[0]):
            if int(mode_id[b]) < 0 or bool(afk[b]):
                continue
            # Empty slots are -1 in a raw MatchStream and pad_row in a
            # packed schedule — both drop from the team reduction.
            rows_a = [
                int(r) for r in player_idx[b, 0]
                if int(r) >= 0 and int(r) != pad_row
            ]
            rows_b = [
                int(r) for r in player_idx[b, 1]
                if int(r) >= 0 and int(r) != pad_row
            ]
            if not rows_a or not rows_b:
                continue
            p = float(win_probability(table, rows_a, rows_b, self._beta2))
            y = 1.0 if int(winner[b]) == 0 else 0.0
            k = min(int(p * bins), bins - 1)
            d_count[k] += 1
            d_p[k] += p
            d_y[k] += y
            d_brier += (p - y) * (p - y)
            pc = min(max(p, eps), 1.0 - eps)
            d_logloss += -(y * math.log(pc) + (1.0 - y) * math.log(1.0 - pc))
            pairs.append((_logit(p), y))
            games.extend(rows_a)
            games.extend(rows_b)
            n_scored += 1
        if not n_scored:
            return 0
        with self._lock:
            self._bin_count += d_count
            self._bin_p_sum += d_p
            self._bin_y_sum += d_y
            self._n += n_scored
            self._brier_sum += d_brier
            self._logloss_sum += d_logloss
            for z, y in pairs:
                if len(self._z) >= retain_max:
                    break
                self._z.append(z)
                self._y.append(y)
            for row in games:
                self._games[row] = self._games.get(row, 0) + 1
        if self._mirror:
            self._mirror_scores(d_count, d_p, d_y, d_brier, d_logloss)
        return n_scored

    def _mirror_scores(self, d_count, d_p, d_y, d_brier, d_logloss) -> None:
        """Pushes one batch's deltas into the ``quality.*`` registry
        series. Counters only for the accumulating state (they sum —
        fleet merge + ring deltas stay exact); the derived running
        means ride as gauges for human scrape pages."""
        from analyzer_tpu_torch.obs.registry import get_registry

        reg = get_registry()
        reg.counter("quality.matches_scored_total").add(float(d_count.sum()))
        reg.counter("quality.brier_sum").add(d_brier)
        reg.counter("quality.logloss_sum").add(d_logloss)
        for k in range(self._bins):
            if not d_count[k]:
                continue
            reg.counter("quality.bin_count", bin=k).add(float(d_count[k]))
            reg.counter("quality.bin_p_sum", bin=k).add(float(d_p[k]))
            reg.counter("quality.bin_y_sum", bin=k).add(float(d_y[k]))
        with self._lock:
            n = self._n
            brier = self._brier_sum / n if n else None
            ece = ece_from_bins(self._bin_p_sum, self._bin_y_sum, n)
        reg.gauge("quality.brier").set(
            round(brier, 6) if brier is not None else None
        )
        reg.gauge("quality.ece").set(
            round(ece, 6) if ece is not None else None
        )

    # -- population drift -------------------------------------------------
    def observe_population(self, table, now: float | None = None) -> None:
        """One drift snapshot over a committed HOST table (the served
        view's ``host_table()``): pins the reference mu histogram on the
        first call with enough rated rows, then tracks PSI against it,
        plus per-cohort mean sigma (cohorts from the ledger's own
        games-played counts). ``now`` comes from the CALLER's clock
        (this module never owns one)."""
        from analyzer_tpu_torch.core.state import MU_LO, SIGMA_LO

        table = np.asarray(table)
        mu = np.asarray(table[:, MU_LO], dtype=np.float64)
        sigma = np.asarray(table[:, SIGMA_LO], dtype=np.float64)
        rated = ~np.isnan(mu)
        n_rated = int(rated.sum())
        psi_bins = int(QUALITY_TABLE["psi_bins"])
        eps = float(QUALITY_TABLE["psi_eps"])
        with self._lock:
            if self._ref_edges is None:
                if n_rated < psi_bins:
                    return
                lo = float(mu[rated].min())
                hi = float(mu[rated].max())
                if hi <= lo:
                    hi = lo + 1.0
                self._ref_edges = np.linspace(lo, hi, psi_bins + 1)
                self._ref_frac = self._mu_fractions(mu[rated], eps)
                psi = 0.0
            else:
                if not n_rated:
                    return
                cur = self._mu_fractions(mu[rated], eps)
                psi = float(
                    np.sum((cur - self._ref_frac) * np.log(cur / self._ref_frac))
                )
            cohorts = self._sigma_cohorts(sigma, rated)
            self._drift = {
                "t": round(float(now), 6) if now is not None else None,
                "rated_rows": n_rated,
                "psi_mu": round(psi, 6),
                "psi_alert": psi >= float(QUALITY_TABLE["psi_alert"]),
                "sigma_by_cohort": cohorts,
            }
        if self._mirror:
            from analyzer_tpu_torch.obs.registry import get_registry

            get_registry().gauge("quality.psi_mu").set(round(psi, 6))

    def _mu_fractions(self, mu_rated: np.ndarray, eps: float) -> np.ndarray:
        """Smoothed per-bin fractions of rated mu over the PINNED
        reference edges (outer rows clip into the edge bins, so a
        drifting population registers instead of escaping the range)."""
        edges = self._ref_edges
        idx = np.clip(
            np.searchsorted(edges, mu_rated, side="right") - 1,
            0, len(edges) - 2,
        )
        counts = np.bincount(idx, minlength=len(edges) - 1).astype(np.float64)
        frac = counts / counts.sum()
        frac = frac + eps
        return frac / frac.sum()

    def _sigma_cohorts(self, sigma: np.ndarray, rated: np.ndarray) -> dict:
        """Mean sigma by games-played cohort — converging populations
        show monotonically falling sigma with games played; a flat
        profile means the system stopped learning."""
        edges = QUALITY_TABLE["cohort_edges"]
        names = ["0-%d" % (edges[0] - 1)]
        names += [
            "%d-%d" % (edges[i], edges[i + 1] - 1)
            for i in range(len(edges) - 1)
        ]
        names.append("%d+" % edges[-1])
        sums = [0.0] * len(names)
        counts = [0] * len(names)
        for row, games in self._games.items():
            if row >= len(sigma) or not rated[row]:
                continue
            k = 0
            for i, e in enumerate(edges):
                if games >= e:
                    k = i + 1
            sums[k] += float(sigma[row])
            counts[k] += 1
        return {
            name: (round(sums[i] / counts[i], 4) if counts[i] else None)
            for i, name in enumerate(names)
        }

    # -- reporting --------------------------------------------------------
    def retained(self) -> tuple[np.ndarray, np.ndarray]:
        """The retained (logit, outcome) prefix for temperature fitting
        (models/calibration.py fit_temperature's inputs)."""
        with self._lock:
            return (
                np.asarray(self._z, dtype=np.float64),
                np.asarray(self._y, dtype=np.float64),
            )

    def worst_bin(self) -> dict | None:
        """The reliability bin with the largest |mean_p - mean_y| gap —
        what the SLO-burn log names when calibration-floor burns."""
        with self._lock:
            worst = None
            for k in range(self._bins):
                c = int(self._bin_count[k])
                if not c:
                    continue
                mean_p = float(self._bin_p_sum[k]) / c
                mean_y = float(self._bin_y_sum[k]) / c
                gap = abs(mean_p - mean_y)
                if worst is None or gap > worst["gap"]:
                    worst = {
                        "bin": k,
                        "lo": round(k / self._bins, 2),
                        "hi": round((k + 1) / self._bins, 2),
                        "count": c,
                        "mean_p": round(mean_p, 4),
                        "mean_y": round(mean_y, 4),
                        "gap": round(gap, 4),
                    }
            return worst

    def stats(self) -> dict:
        """The compact ``Worker.stats()['quality']`` block."""
        with self._lock:
            n = self._n
            return {
                "matches_scored": n,
                "brier": round(self._brier_sum / n, 6) if n else None,
                "ece": (
                    round(
                        ece_from_bins(self._bin_p_sum, self._bin_y_sum, n), 6
                    )
                    if n else None
                ),
                "psi_mu": (
                    self._drift["psi_mu"] if self._drift is not None else None
                ),
            }

    def summary(self) -> dict:
        """The full report: reliability table, streaming scores, drift
        snapshot, retention. Deterministic for a deterministic input
        stream (the soak artifact's ``quality`` block is this dict,
        byte-identical per (seed, config))."""
        with self._lock:
            n = self._n
            bins = []
            for k in range(self._bins):
                c = int(self._bin_count[k])
                bins.append({
                    "lo": round(k / self._bins, 2),
                    "hi": round((k + 1) / self._bins, 2),
                    "count": c,
                    "mean_p": (
                        round(float(self._bin_p_sum[k]) / c, 4) if c else None
                    ),
                    "mean_y": (
                        round(float(self._bin_y_sum[k]) / c, 4) if c else None
                    ),
                })
            ece = ece_from_bins(self._bin_p_sum, self._bin_y_sum, n)
            out = {
                "matches_scored": n,
                "brier": round(self._brier_sum / n, 6) if n else None,
                "logloss": round(self._logloss_sum / n, 6) if n else None,
                "ece": round(ece, 6) if ece is not None else None,
                "min_matches": int(QUALITY_TABLE["min_matches"]),
                "bins": bins,
                "retained": len(self._z),
                "drift": self._drift,
            }
        out["worst_bin"] = self.worst_bin()
        return out


def score_table(table, stream, cfg) -> dict:
    """The replay judge: scores EVERY ratable match of ``stream``
    against ONE frozen host ``table`` — how well would this table have
    predicted this window? Used by ``cli migrate`` (and the soak's
    migration block) to compare the staging lineage's post-backfill
    table against the pre-migration live table over the same replay
    window: the dual-lineage engine as a counterfactual what-if judge.

    Hindsight caveat: the table already saw these matches (the backfill
    rated them), so this measures FIT over the window, not forward
    prediction — apples-to-apples between the two lineages because both
    score the identical stream with the identical link."""
    table = np.asarray(table)
    ledger = CalibrationLedger(cfg, mirror=False)
    pad_row = table.shape[0] - 1
    player_idx = np.asarray(stream.player_idx)
    # Rows beyond the frozen table (a stream wider than the lineage)
    # clip into the pad row, dropping out of the team reduction like
    # any padding slot — the gather stays in bounds either way.
    player_idx = np.where(player_idx >= pad_row, pad_row, player_idx)
    ledger.score_batch(
        table,
        player_idx,
        np.asarray(stream.winner),
        np.asarray(stream.mode_id),
        np.asarray(stream.afk),
        pad_row=pad_row,
    )
    summary = ledger.summary()
    del summary["drift"]
    return summary


_LEDGER: CalibrationLedger | None = None


def set_quality_ledger(ledger: CalibrationLedger | None) -> None:
    """Registers the process's live ledger (the worker's) so the
    ``/qualityz`` route and ``cli quality`` can reach it."""
    global _LEDGER
    _LEDGER = ledger


def get_quality_ledger() -> CalibrationLedger | None:
    return _LEDGER


def reset_quality_ledger() -> None:
    set_quality_ledger(None)


def render_quality(summary: dict) -> str:
    """Human rendering of a quality summary: the reliability table,
    the streaming scores, and the drift verdict (``cli quality``)."""
    lines = []
    n = summary.get("matches_scored", 0)
    lines.append(
        "quality: %s matches scored, brier=%s logloss=%s ece=%s"
        % (n, summary.get("brier"), summary.get("logloss"),
           summary.get("ece"))
    )
    lines.append("  bin        count  mean_p  mean_y")
    for b in summary.get("bins", []):
        lines.append(
            "  [%.1f,%.1f) %6d  %6s  %6s"
            % (b["lo"], b["hi"], b["count"],
               "-" if b["mean_p"] is None else "%.3f" % b["mean_p"],
               "-" if b["mean_y"] is None else "%.3f" % b["mean_y"])
        )
    wb = summary.get("worst_bin")
    if wb is not None:
        lines.append(
            "  worst bin [%s,%s): gap=%s over %s matches"
            % (wb["lo"], wb["hi"], wb["gap"], wb["count"])
        )
    drift = summary.get("drift")
    if drift is not None:
        verdict = "DRIFTING" if drift.get("psi_alert") else "stable"
        lines.append(
            "drift: %s — psi_mu=%s over %s rated rows"
            % (verdict, drift.get("psi_mu"), drift.get("rated_rows"))
        )
        lines.append(
            "  sigma by games-played cohort: %s"
            % (drift.get("sigma_by_cohort"),)
        )
    else:
        lines.append("drift: no snapshot yet")
    if "temperature" in summary:
        t = summary["temperature"]
        lines.append(
            "temperature: T=%s (nll %s -> %s over %s retained)"
            % (t["t"], t["nll_before"], t["nll_after"], t["n"])
        )
    return "\n".join(lines) + "\n"
