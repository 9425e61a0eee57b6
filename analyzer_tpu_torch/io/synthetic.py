"""Synthetic match-history generation for tests and benchmarks.

The port's own copy of ``analyzer_tpu.io.synthetic`` (numpy only): for the
same arguments and seed it produces byte-equal streams and populations.
Streams have the reference's real-world shape: heavy-tailed player
activity, a mix of 3v3 and 5v5 modes, occasional AFK/invalid matches, and
seed features (rank points / skill tiers) as the reference's fallback
paths expect (``rater.py:42-62``). Outcomes are sampled from latent skills.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from analyzer_tpu_torch.core import constants
from analyzer_tpu_torch.sched.superstep import MatchStream

# 3v3 modes per MODES order: casual, ranked, blitz, br are 3v3; 5v5_* are 5.
_MODE_TEAM_SIZE = np.array([3, 3, 3, 3, 5, 5], dtype=np.int32)


class AliasSampler:
    """Walker alias method over a fixed weight vector: O(P) build, O(1)
    per draw.

    ``rng.choice(p=weights)`` costs a ~20-probe binary search per draw
    (log2 of the population); the alias table replaces that with two
    table reads per draw. Build is the standard Vose two-stack pairing;
    exactness: every draw is distributed exactly per ``weights``.

    Public API:

      * ``AliasSampler(weights)`` — ``weights`` is a 1-D positive float
        array; it is normalized internally (callers need not sum to 1).
      * ``draw(rng, size)`` — samples indices ``[0, len(weights))`` with
        probability proportional to ``weights``, shaped ``size``, using
        exactly two ``rng`` streams (cell + keep) per call, so a given
        ``rng`` state yields a deterministic draw sequence.
    """

    def __init__(self, weights: np.ndarray) -> None:
        p = weights.shape[0]
        scaled = weights * (p / weights.sum())
        self.alias = np.arange(p, dtype=np.int64)
        self.prob = scaled.copy()
        prob, alias = self.prob, self.alias
        # Bulk-pairing Vose: each round pairs m smalls with m distinct
        # larges elementwise (a different processing order than the
        # classic one-at-a-time stacks, but the same invariant: a paired
        # small cell is finalized, the large keeps its residual). Queues
        # are flat ring buffers so a round is pure numpy with no
        # reslicing copies; every cell is enqueued at most twice, so the
        # build is O(P) with a handful of vector ops per round.
        # Capacity: qs sees each cell at most twice (initial + one
        # large-turned-small); ql sees initial larges plus one re-enqueue
        # per pairing, and pairings = finalized smalls <= 2p.
        qs = np.empty(2 * p + 1, np.int64)
        ql = np.empty(3 * p + 1, np.int64)
        init_s = np.flatnonzero(scaled < 1.0)
        init_l = np.flatnonzero(scaled >= 1.0)
        qs[: init_s.size] = init_s
        ql[: init_l.size] = init_l
        sh, st = 0, init_s.size  # small queue head/tail
        lh, lt = 0, init_l.size  # large queue head/tail
        while sh < st and lh < lt:
            m = min(st - sh, lt - lh)
            s = qs[sh : sh + m]
            l = ql[lh : lh + m]
            sh += m
            lh += m
            alias[s] = l
            prob[l] -= 1.0 - prob[s]
            lp = prob[l]
            new_small = l[lp < 1.0]
            new_large = l[lp >= 1.0]
            qs[st : st + new_small.size] = new_small
            st += new_small.size
            ql[lt : lt + new_large.size] = new_large
            lt += new_large.size
        # Numerical leftovers on either queue have prob ~= 1.
        prob[qs[sh:st]] = 1.0
        prob[ql[lh:lt]] = 1.0

    def draw(self, rng: np.random.Generator, size) -> np.ndarray:
        n = int(np.prod(size))
        cell = rng.integers(0, self.prob.shape[0], size=n)
        keep = rng.random(n) < self.prob[cell]
        return np.where(keep, cell, self.alias[cell]).reshape(size)


# Hidden player archetypes (playstyle / preferred-role buckets): the
# composition channel. Small on purpose — 8 archetypes give 36 unordered
# teammate pairs, enough for a learnable synergy structure while every
# pair is seen often even in a 10k-match test stream.
N_ARCHETYPES = 8


@dataclasses.dataclass
class SyntheticPlayers:
    """Latent skills + observable seed features for a synthetic population."""

    latent_skill: np.ndarray  # [P] float64, the "true" skill driving outcomes
    rank_points_ranked: np.ndarray  # [P] float64, NaN = missing
    rank_points_blitz: np.ndarray  # [P] float64, NaN = missing
    skill_tier: np.ndarray  # [P] int32 in [-1, 29]
    # [P] int32 in [0, N_ARCHETYPES): the player's playstyle bucket — a
    # PRE-MATCH observable (like a draft pick), orthogonal to skill. Only
    # influences outcomes when synthetic_stream's synergy_strength > 0.
    archetype: np.ndarray = None

    @property
    def n_players(self) -> int:
        return self.latent_skill.shape[0]


def synthetic_players(n_players: int, seed: int = 0) -> SyntheticPlayers:
    rng = np.random.default_rng(seed)
    latent = rng.normal(1500.0, 400.0, n_players)
    # ~40% of players have rank points (fallback 1); the rest seed from tier.
    has_ranked = rng.random(n_players) < 0.35
    has_blitz = rng.random(n_players) < 0.15
    rp_ranked = np.where(has_ranked, np.clip(latent + rng.normal(0, 150, n_players), 1, None), np.nan)
    rp_blitz = np.where(has_blitz, np.clip(latent + rng.normal(0, 200, n_players), 1, None), np.nan)
    # Skill tier loosely tracks latent skill, clipped to the table range.
    tier = np.clip(((latent - 600.0) / 85.0).astype(np.int32), -1, 29)
    return SyntheticPlayers(
        latent_skill=latent,
        rank_points_ranked=rp_ranked,
        rank_points_blitz=rp_blitz,
        skill_tier=tier.astype(np.int32),
        # Drawn LAST so adding the archetype channel left every earlier
        # draw (and thus every historical stream/test fixture) unchanged.
        archetype=rng.integers(0, N_ARCHETYPES, n_players).astype(np.int32),
    )


def synergy_matrix(seed: int = 0) -> np.ndarray:
    """The hidden symmetric archetype-pair synergy matrix ``[A, A]``.

    Entries ~ N(0, 1); S[a, b] is the bonus (in units later scaled to
    skill points) each unordered {a, b} teammate pair contributes to its
    team's effective strength. Deterministic per stream seed — the
    generator and a test oracle can both reconstruct it; the learned
    heads never see it (they must recover it from outcomes)."""
    rng = np.random.default_rng(seed + 101)
    s = rng.normal(0.0, 1.0, (N_ARCHETYPES, N_ARCHETYPES))
    return (s + s.T) / np.sqrt(2.0)


def _team_synergy(
    archetype: np.ndarray, player_idx: np.ndarray, seed: int,
    chunk: int = 1_000_000,
) -> np.ndarray:
    """Mean unordered-teammate-pair synergy per team, ``[N, 2]`` float64.

    Chunked over matches: the [n, 2, T, T] pairwise gather at 10M
    matches would otherwise materialize ~4 GB at once."""
    s = synergy_matrix(seed)
    n, _, t = player_idx.shape
    out = np.zeros((n, 2), np.float64)
    off_diag = ~np.eye(t, dtype=bool)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        idx = player_idx[lo:hi]
        mask = idx >= 0
        a = np.where(mask, archetype[np.clip(idx, 0, None)], 0)
        pair_mask = (mask[:, :, :, None] & mask[:, :, None, :]) & off_diag
        pair_s = s[a[:, :, :, None], a[:, :, None, :]]
        # Each unordered pair appears twice in the [T, T] grid.
        tot = (pair_s * pair_mask).sum((-1, -2)) / 2.0
        n_pairs = pair_mask.sum((-1, -2)) / 2.0
        out[lo:hi] = tot / np.maximum(n_pairs, 1.0)
    return out


def synthetic_stream(
    n_matches: int,
    players: SyntheticPlayers,
    seed: int = 0,
    afk_rate: float = 0.02,
    unsupported_rate: float = 0.005,
    activity_concentration: float = 1.2,
    max_activity_share: float | None = None,
    synergy_strength: float = 0.0,
) -> MatchStream:
    """Samples a chronologically ordered stream of two-team matches.

    Player selection is Zipf-flavored (``activity_concentration`` > 1 skews
    toward a hot head of active players, deepening the superstep dependency
    chain like real ladder traffic would). Winners are sampled from the
    latent-skill gap through a logistic link.

    ``synergy_strength`` > 0 adds a COMPOSITION-dependent term to the
    outcome draw: each team's effective strength gains
    ``synergy_strength * 400`` skill points per unit of mean
    archetype-pair synergy (:func:`synergy_matrix`). This is signal the
    per-player rating system CANNOT represent (it is a property of the
    team composition, not of any player), so the closed-form rating
    baseline stops being Bayes-optimal and a learned head with
    composition features has real headroom — the round-4 verdict's
    missing test bed. 0 (default) keeps the historical generator
    exactly (outcomes purely from latent skill).

    ``max_activity_share`` caps any single player's expected share of match
    slots. Unbounded Zipf gives the top player ~1/H(P, s) of ALL slots
    (~1.6% at P=300k, s=0.8) — i.e. one player "playing" 11% of a 2M-match
    history, which no human can (and which pins the superstep schedule at
    the depth of that player's match chain). A real multi-year ladder's
    hardest grinder plays a few thousand matches of tens of millions; pass
    e.g. ``1e-4`` (top player in ~0.08% of matches at ~8 slots/match) for
    that physically plausible profile. ``None`` keeps the raw Zipf weights.
    """
    rng = np.random.default_rng(seed)
    p = players.n_players
    n = n_matches

    # Heavy-tailed activity weights.
    ranks = np.arange(1, p + 1, dtype=np.float64)
    weights = 1.0 / ranks**activity_concentration
    if max_activity_share is not None:
        # Clip-and-renormalize until stable: clipping raises everyone
        # else's share, which can push new players over the cap. A cap
        # below 1/P is infeasible (uniform is the floor); the loop then
        # just converges toward uniform weights.
        cap = max(max_activity_share, 1.0 / p)
        for _ in range(64):
            clipped = np.minimum(weights, cap * weights.sum())
            if np.array_equal(clipped, weights):
                break
            weights = clipped
    rng.shuffle(weights)
    weights /= weights.sum()

    mode_id = rng.integers(0, constants.N_MODES, n).astype(np.int32)
    unsupported = rng.random(n) < unsupported_rate
    mode_id[unsupported] = constants.UNSUPPORTED_MODE_ID
    team_size = np.where(mode_id >= 0, _MODE_TEAM_SIZE[np.clip(mode_id, 0, None)], 3)

    t_max = int(team_size.max()) if n else 3
    player_idx = np.full((n, 2, t_max), -1, dtype=np.int32)
    afk = rng.random(n) < afk_rate

    # Sample 2*team_size distinct players per match, fully vectorized:
    # draw with replacement, then iteratively redraw only the rows that
    # still contain duplicates (converges in a few rounds).
    k_max = 2 * t_max
    sampler = AliasSampler(weights)
    flat = sampler.draw(rng, (n, k_max))
    need = np.arange(n)
    for _ in range(64):
        rows = flat[need]
        srt = np.sort(rows, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        need = need[dup]
        if need.size == 0:
            break
        flat[need] = sampler.draw(rng, (need.size, k_max))
    else:
        # Pathological weights: fix the stragglers exactly, one by one.
        for i in need:
            uniq = np.unique(flat[i])
            while uniq.size < k_max:
                extra = sampler.draw(rng, (k_max - uniq.size,))
                uniq = np.unique(np.concatenate([uniq, extra]))
            flat[i] = rng.permutation(uniq[:k_max])

    cols = np.arange(t_max)[None, :]
    ts_col = team_size[:, None]
    team0 = np.where(cols < ts_col, flat[:, :t_max], -1).astype(np.int32)
    team1 = np.where(cols < ts_col, flat[:, t_max : 2 * t_max], -1).astype(np.int32)
    player_idx[:, 0] = team0
    player_idx[:, 1] = team1

    # Outcome from latent skills: P(team0 wins) = logistic(gap / scale).
    skill = players.latent_skill
    masked = player_idx >= 0
    team_skill = np.where(masked, skill[np.clip(player_idx, 0, None)], 0.0).sum(axis=2)
    gap = team_skill[:, 0] - team_skill[:, 1]
    if synergy_strength > 0.0:
        syn = _team_synergy(players.archetype, player_idx, seed)
        gap = gap + synergy_strength * 400.0 * (syn[:, 0] - syn[:, 1])
    p_win = 1.0 / (1.0 + np.exp(-gap / (400.0 * np.maximum(team_size, 1))))
    winner = (rng.random(n) >= p_win).astype(np.int32)  # 0 if team0 wins

    return MatchStream(player_idx=player_idx, winner=winner, mode_id=mode_id, afk=afk)
