"""Matchmaking from the SERVED ratings: the soak loop's closed half.

The matchmaker never peeks at the rating table, the store, or the
latent skills — every number it decides on comes back through the same
read plane production matchmaking would use:

  * **queue ordering** — candidates sampled by the activity distribution
    (reusing :class:`analyzer_tpu_torch.io.synthetic.AliasSampler`) are ranked
    by the *conservative* rating (``mu - 3*sigma``) the current
    published view serves; unrated players fall back to their served
    seed estimate, exactly like a ladder seeding fresh accounts.
  * **team balance** — candidate splits of the ranked queue are scored
    through the QueryEngine's winprob/quality path and the
    highest-quality split wins, so as ratings drift the matchmaker's
    pairings drift with them — the feedback loop the soak exists to
    exercise.

Requests ride a :class:`ServeClient`: in-process against a
:class:`~analyzer_tpu_torch.serve.engine.QueryEngine`, or HTTP against a
live ``/v1/*`` endpoint. Ratings lookups go out in FIXED-SIZE pages
(padded by repeating ids), so the serve plane sees one shape.

Determinism: one seeded generator, a fixed draw discipline (sampler
draws + the mode draw are the only consumers), and stable sorts keyed
(score, id).

The port's copy of ``analyzer_tpu.loadgen.matchmaker``: reading the same
served ratings, it forms the JAX package's matches exactly.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.parse

import numpy as np

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.io.synthetic import AliasSampler, SyntheticPlayers
from analyzer_tpu_torch.obs.httpd import PooledHTTPClient

#: Fixed ratings-lookup page: every conservative-rating fetch pads to
#: this many ids so the serve gather ladder compiles exactly one shape.
RATINGS_PAGE = 64

#: 3v3 / 5v5 ratable modes the soak publishes (constants.MODES names).
MODE_3V3 = "ranked"
MODE_5V5 = "5v5_ranked"


@dataclasses.dataclass(frozen=True)
class FormedMatch:
    """One matchmade pairing, pre-outcome. Rows index the synthetic
    population; ids are the api ids the store/serve plane use."""

    mode: str
    team_a_rows: tuple[int, ...]
    team_b_rows: tuple[int, ...]
    team_a_ids: tuple[str, ...]
    team_b_ids: tuple[str, ...]
    p_a: float  # the SERVED winprob estimate for the chosen split
    quality: float  # the served match quality for the chosen split
    split: str  # which candidate split won ("snake" / "pairs")


class EngineServeClient:
    """ServeClient over an in-process QueryEngine (threaded or inline).
    Counts requests per kind so the driver can fold matchmaker traffic
    into the soak's served-query accounting."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.calls: dict[str, int] = {}

    def _count(self, kind: str) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1

    def get_ratings(self, ids) -> dict:
        self._count("ratings")
        return self.engine.get_ratings(ids)

    def win_probability(self, team_a, team_b) -> dict:
        self._count("winprob")
        return self.engine.win_probability(team_a, team_b)

    def leaderboard(self, k: int) -> dict:
        self._count("leaderboard")
        return self.engine.leaderboard(k)

    def tiers(self) -> dict:
        self._count("tiers")
        return self.engine.tier_histogram()


class HttpServeClient:
    """ServeClient over a live ``/v1/*`` endpoint (an HTTP *client*; the
    listening sockets stay in obs/ and serve/). Rides one pooled keep-alive
    connection (:class:`~analyzer_tpu_torch.obs.httpd.PooledHTTPClient`),
    so a query pays no TCP handshake."""

    def __init__(self, base_url: str, timeout: float = 30.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.calls: dict[str, int] = {}
        self.pool = PooledHTTPClient(self.base_url, timeout_s=timeout)

    def _get(self, kind: str, path: str, params: dict | None = None) -> dict:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        if params:
            path += "?" + urllib.parse.urlencode(params)
        return json.loads(self.pool.get(path).decode("utf-8"))

    def get_ratings(self, ids) -> dict:
        return self._get("ratings", "/v1/ratings", {"ids": ",".join(ids)})

    def win_probability(self, team_a, team_b) -> dict:
        return self._get(
            "winprob", "/v1/winprob",
            {"a": ",".join(team_a), "b": ",".join(team_b)},
        )

    def leaderboard(self, k: int) -> dict:
        return self._get("leaderboard", "/v1/leaderboard", {"k": str(k)})

    def tiers(self) -> dict:
        return self._get("tiers", "/v1/tiers")


def player_id(row: int) -> str:
    """The soak population's api-id scheme (store + serve + artifact)."""
    return f"p{row:06d}"


def _snake_split(order: list) -> tuple[list, list]:
    """1st,4th,5th,8th,... vs 2nd,3rd,6th,7th,... — the classic draft
    that balances a strictly ranked queue."""
    a, b = [], []
    for i, x in enumerate(order):
        (a if i % 4 in (0, 3) else b).append(x)
    return a, b


def _pairs_split(order: list) -> tuple[list, list]:
    """Even vs odd ranks — the adjacent-pairs alternative."""
    return order[0::2], order[1::2]


class Matchmaker:
    """Forms ratable two-team matches from the served ratings.

    ``client`` is a ServeClient; ``seed`` fixes the formation stream
    (candidate draws + mode draws). Activity weights are the same
    Zipf shape :func:`analyzer_tpu_torch.io.synthetic.synthetic_stream` uses,
    shuffled by this seed so "who is a grinder" varies per soak.
    """

    def __init__(
        self,
        players: SyntheticPlayers,
        client,
        seed: int = 0,
        cfg: RatingConfig | None = None,
        activity_concentration: float = 1.2,
        team5_frac: float = 0.3,
        ratings_page: int = RATINGS_PAGE,
    ) -> None:
        p = players.n_players
        if p < 2 * 5:
            raise ValueError(f"need at least 10 players to matchmake, got {p}")
        self.players = players
        self.client = client
        self.cfg = cfg or RatingConfig()
        self.team5_frac = float(team5_frac)
        self.ratings_page = int(ratings_page)
        self.rng = np.random.default_rng(
            np.random.SeedSequence(entropy=seed, spawn_key=(0,))
        )
        ranks = np.arange(1, p + 1, dtype=np.float64)
        weights = 1.0 / ranks**activity_concentration
        self.rng.shuffle(weights)
        self.sampler = AliasSampler(weights / weights.sum())
        # Fresh accounts the view has never seen rank at the seedless
        # floor — deterministic, and strictly below any served seed.
        self._fallback_conservative = float(
            self.cfg.mu0 - 3.0 * self.cfg.sigma0
        )

    # -- candidate sampling ----------------------------------------------
    def sample_rows(self, k: int, rng=None) -> list[int]:
        """``k`` DISTINCT player rows by activity weight, in draw order
        (the redraw loop preserves first-draw precedence). ``rng``
        defaults to the formation stream; the driver's query workload
        passes its own stream so read traffic never perturbs
        formation draws."""
        rng = self.rng if rng is None else rng
        out: dict[int, None] = {}
        while len(out) < k:
            for c in self.sampler.draw(rng, (k,)).tolist():
                if len(out) == k:
                    break
                out.setdefault(int(c), None)
        return list(out)

    # -- served-rating lookups -------------------------------------------
    def conservative_of(self, ids: list[str]) -> dict[str, float]:
        """Served conservative rating per id, via fixed-size ratings
        pages (padding repeats ids — lookups are idempotent). Unrated
        players use their served seed estimate; ids the view has never
        published fall back to the seedless floor."""
        out: dict[str, float] = {}
        uniq = list(dict.fromkeys(ids))
        page = self.ratings_page
        for lo in range(0, len(uniq), page):
            chunk = uniq[lo : lo + page]
            padded = chunk + [chunk[0]] * (page - len(chunk))
            resp = self.client.get_ratings(padded)
            for r in resp["ratings"]:
                if r["id"] in out:
                    continue
                if r["rated"]:
                    out[r["id"]] = float(r["conservative"])
                else:
                    out[r["id"]] = float(
                        r["seed_mu"] - 3.0 * r["seed_sigma"]
                    )
            for pid in resp.get("unknown", ()):
                out.setdefault(pid, self._fallback_conservative)
        return out

    # -- formation ---------------------------------------------------------
    def form(self, n: int) -> list[FormedMatch]:
        """Forms ``n`` matches. One conservative-rating sweep covers the
        whole call's candidates; each match then scores its candidate
        splits through the served winprob path and keeps the
        highest-quality one (ties: first candidate wins — "snake")."""
        if n <= 0:
            return []
        plans = []
        for _ in range(n):
            five = self.rng.random() < self.team5_frac
            mode, t = (MODE_5V5, 5) if five else (MODE_3V3, 3)
            rows = self.sample_rows(2 * t)
            plans.append((mode, rows))
        all_ids = [player_id(r) for _, rows in plans for r in rows]
        score = self.conservative_of(all_ids)
        out = []
        for mode, rows in plans:
            # Rank the queue best-first; ties break on the id so the
            # order is total and machine-independent.
            order = sorted(
                rows, key=lambda r: (-score[player_id(r)], player_id(r))
            )
            best = None
            for name, split in (
                ("snake", _snake_split(order)),
                ("pairs", _pairs_split(order)),
            ):
                a_ids = tuple(player_id(r) for r in split[0])
                b_ids = tuple(player_id(r) for r in split[1])
                resp = self.client.win_probability(a_ids, b_ids)
                cand = FormedMatch(
                    mode=mode,
                    team_a_rows=tuple(split[0]),
                    team_b_rows=tuple(split[1]),
                    team_a_ids=a_ids,
                    team_b_ids=b_ids,
                    p_a=float(resp["p_a"]),
                    quality=float(resp["quality"]),
                    split=name,
                )
                if best is None or cand.quality > best.quality:
                    best = cand
            out.append(best)
        return out
