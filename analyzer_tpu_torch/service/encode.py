"""Object graph <-> tensor codec for the service path.

The worker loads the reference's duck-typed match graphs (match -> rosters
-> participants -> player / participant_items) and rates them through the
vectorized scheduler + kernel, not the one-match object API. This module
packs a list of loaded match objects into a MatchStream + PlayerState and
scatters the HistoryOutputs back onto the objects with exactly the writes
``rater.py:140-169`` performs (quality, shared mu/sigma + delta snapshots,
mode mu/sigma, any_afk), preserving the gating rules for AFK/unsupported
matches (``rater.py:83-106``).

The port's copy of ``analyzer_tpu.service.encode``. Everything here is host
numpy; the one device step is the finished player table, which
``EncodedBatch`` builds on the device it is given (``device=None`` = the
card), with the seed columns baked on the host first.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core import constants
from analyzer_tpu_torch.core.seeding import trueskill_seed_host
from analyzer_tpu_torch.device import resolve_device
from analyzer_tpu_torch.core.state import (
    COL_SEED_MU,
    COL_SEED_SIGMA,
    MAX_TEAM_SIZE,
    MU_LO,
    SIGMA_LO,
    TABLE_WIDTH,
    PlayerState,
)
from analyzer_tpu_torch.sched.superstep import MatchStream


# Hoisted (col index, "<col>_mu", "<col>_sigma") triples: the encode loop
# reads 14 rating attributes per player, and building the attribute names
# with f-strings inside the loop cost ~40k string formats per 500-match
# batch on the consumer thread.
_RATING_ATTRS = tuple(
    (c, f"{col}_mu", f"{col}_sigma")
    for c, col in enumerate(constants.RATING_COLUMNS)
)


def row_bucket(n_players: int) -> int:
    """Power-of-two player-row bucket (floor 64) — the SINGLE owner of
    the service path's state-table sizing, shared by ``EncodedBatch``,
    ``ColumnarBatch``, ``Worker`` (the chain ring's canonical rows) and the
    serve plane's staging table. Nothing compiles per shape in the port;
    the bucket keeps the tables the same shapes as the JAX package's, so
    both packages' dumps and served views line up row for row."""
    return max(64, 1 << max(n_players - 1, 0).bit_length())


class PoisonError(Exception):
    """Base for encode failures attributable to SPECIFIC matches.

    ``api_ids`` names the offending match(es), so the worker can
    dead-letter exactly those messages and rate the rest — one corrupt
    record costs one message, not the whole 500-message batch. This
    dominates both the reference's whole-batch policy
    (``worker.py:110-120``) and round 2's strict divergence (which
    dead-lettered all 500). Unattributable failures (store errors,
    bugs) still fail the whole batch.
    """

    def __init__(self, api_ids, message):
        super().__init__(message)
        self.api_ids = tuple(api_ids)


class PoisonMatchError(PoisonError, ValueError):
    """A structurally malformed match (winner flags, team size)."""


class PoisonTierError(PoisonError, KeyError):
    """The reference's out-of-table skill-tier KeyError
    (``rater.py:60``), attributed to every ratable match that would
    consult the bad seed — a KeyError subclass so the reference's
    exception-type contract holds (tests/test_rater_parity.py)."""


class EncodedBatch:
    """A batch of match objects packed for the tensor path, with the maps
    needed to write results back.

    ``bucket_rows=True`` pads the player table to the next power-of-two
    row count (floor 64), as the JAX package does to keep its compiled
    shapes few. Ghost rows are NaN-rated, never referenced by any match
    slot, and cost only bytes. ``device`` is where the player table lives
    (None = the card; asking for it without one raises before anything is
    encoded)."""

    def __init__(self, matches, cfg: RatingConfig, bucket_rows: bool = False,
                 device=None):
        device = resolve_device(device)
        self.matches = list(matches)
        self.cfg = cfg

        # Player rows: one per distinct player object (by api_id).
        self.row_of: dict[str, int] = {}
        self.player_at: list[object] = []
        for m in self.matches:
            for part in getattr(m, "participants", []):
                player = part.player[0]
                if player.api_id not in self.row_of:
                    self.row_of[player.api_id] = len(self.player_at)
                    self.player_at.append(player)
        p = len(self.player_at)
        self.n_players = p
        alloc = row_bucket(p) if bucket_rows else p

        # State table from object attributes (NaN for SQL NULL / None).
        table = np.full((alloc + 1, TABLE_WIDTH), np.nan, np.float32)
        rr = np.full((alloc + 1,), np.nan, np.float32)
        rb = np.full((alloc + 1,), np.nan, np.float32)
        ti = np.zeros((alloc + 1,), np.int32)
        bad_tier: dict[int, object] = {}  # row -> out-of-table tier value
        for r, player in enumerate(self.player_at):
            # __dict__.get is ~2x getattr, but it is only CORRECT where
            # the instance dict is the whole truth — exactly
            # SimpleNamespace (SqlStore's loaded graphs). Any other type
            # may serve attributes through properties, class defaults,
            # __getattr__ or ORM descriptors (which a bare __dict__ probe
            # would silently read as None = unrated), so everything else
            # keeps the duck-typed getattr path.
            if type(player) is SimpleNamespace:
                d = player.__dict__
                get, get_req = d.get, d.__getitem__
            else:
                def get(name, _p=player):
                    return getattr(_p, name, None)

                def get_req(name, _p=player):
                    return getattr(_p, name)
            for c, mu_col, sg_col in _RATING_ATTRS:
                mu = get(mu_col)
                if mu is not None:
                    table[r, MU_LO + c] = float(mu)
                    # get_req raises on a missing sigma (KeyError /
                    # AttributeError by path) — a mu without its sigma is
                    # malformed data, same contract as before.
                    table[r, SIGMA_LO + c] = float(get_req(sg_col))
            if player.rank_points_ranked is not None:
                rr[r] = float(player.rank_points_ranked)
            if player.rank_points_blitz is not None:
                rb[r] = float(player.rank_points_blitz)
            tier = player.skill_tier
            if tier is not None:
                if not (constants.MIN_SKILL_TIER <= tier <= constants.MAX_SKILL_TIER):
                    # The reference KeyErrors on out-of-table tiers, but
                    # only when get_trueskill_seed actually consults the
                    # table — i.e. the player has no shared rating and no
                    # nonzero rank points AND appears in a ratable match
                    # (rater.py:44-60,115-119). Record now, decide after
                    # the match tensors are built; meanwhile clamp like
                    # the tensor path so the (unused) baked seed is sane.
                    bad_tier[r] = tier
                    ti[r] = int(
                        min(max(tier, constants.MIN_SKILL_TIER), constants.MAX_SKILL_TIER)
                    )
                else:
                    ti[r] = int(tier)
        seed_mu, seed_sigma = trueskill_seed_host(rr, rb, ti, cfg)
        table[:, COL_SEED_MU] = seed_mu
        table[:, COL_SEED_SIGMA] = seed_sigma
        self.state = PlayerState.from_numpy(
            table, rr, rb, ti, seed_cfg=cfg, device=device
        )

        # Match tensors. Structural problems are COLLECTED across the
        # whole batch and raised as ONE PoisonMatchError naming every
        # offender — a worker isolating them then retries once, not once
        # per bad match (which would re-load and re-encode the remaining
        # batch per incident, quadratic in the worst case).
        n = len(self.matches)
        idx = np.full((n, 2, MAX_TEAM_SIZE), -1, np.int32)
        winner = np.zeros((n,), np.int32)
        mode = np.full((n,), constants.UNSUPPORTED_MODE_ID, np.int32)
        afk = np.zeros((n,), bool)
        poison: dict[str, str] = {}  # api_id -> reason
        # slot -> participant object, for the per-participant write-back
        self.slot_part: list[list[list[object]]] = []
        for i, m in enumerate(self.matches):
            mode[i] = constants.MODE_TO_ID.get(m.game_mode, constants.UNSUPPORTED_MODE_ID)
            rosters = list(m.rosters)
            parts_grid: list[list[object]] = [[], []]
            bad = len(rosters) != 2
            if not bad:
                wins = [bool(r.winner) for r in rosters]
                if wins[0] == wins[1]:
                    poison[m.api_id] = (
                        f"rosters must have exactly one winner, got winner "
                        f"flags {wins}"
                    )
                    self.slot_part.append(parts_grid)
                    continue  # tensors stay inert; the raise below gates use
                winner[i] = 0 if wins[0] else 1
                oversize = False
                for t, roster in enumerate(rosters):
                    plist = list(roster.participants)
                    if len(plist) > MAX_TEAM_SIZE:
                        poison[m.api_id] = (
                            f"team of {len(plist)} exceeds max team size "
                            f"{MAX_TEAM_SIZE}"
                        )
                        oversize = True
                        break
                    for s, part in enumerate(plist):
                        idx[i, t, s] = self.row_of[part.player[0].api_id]
                    parts_grid[t] = plist
                if oversize:
                    idx[i] = -1
                    self.slot_part.append([[], []])
                    continue
            anyafk = bad or any(
                p.went_afk == 1 for p in getattr(m, "participants", [])
            )
            afk[i] = anyafk
            self.slot_part.append(parts_grid)
            # write_back needs participant_items[0] for every participant
            # of a supported-mode match (gate path: any_afk on
            # m.participants; rated path: mode mu/sigma on the slotted
            # ones — rater.py:96-106,163-169). The reference IndexErrors
            # here and dead-letters the whole batch; naming the match now
            # lets the worker isolate it instead.
            if m.api_id not in poison and mode[i] != constants.UNSUPPORTED_MODE_ID:
                for part in (
                    list(getattr(m, "participants", []))
                    + [p for t in parts_grid for p in t]
                ):
                    if not getattr(part, "participant_items", None):
                        poison[m.api_id] = (
                            f"participant {part.api_id!r} has no "
                            "participant_items row (write-back target, "
                            "rater.py:104,169)"
                        )
                        break
        if poison:
            raise PoisonMatchError(
                tuple(poison),
                "; ".join(f"match {k}: {v}" for k, v in poison.items()),
            )

        self.stream = MatchStream(
            player_idx=idx, winner=winner, mode_id=mode, afk=afk
        )

        if bad_tier:
            # Reference-faithful KeyError gating (rater.py:44-60,115-119):
            # an out-of-table tier only raises when the tier table would
            # actually be consulted — the player is in at least one RATABLE
            # match (AFK/unsupported matches return before seeding), has no
            # shared rating, and has no nonzero rank points (0/None are
            # "missing", the fallback-1 contract).
            ratable = (mode >= 0) & ~afk
            used = np.unique(idx[ratable])
            used = used[used >= 0]
            hit_any = np.zeros(n, bool)
            reasons: list[str] = []
            for r in used:
                r = int(r)
                if r not in bad_tier:
                    continue
                no_shared = np.isnan(table[r, MU_LO])
                no_points = (np.isnan(rr[r]) or rr[r] == 0) and (
                    np.isnan(rb[r]) or rb[r] == 0
                )
                if no_shared and no_points:
                    # Every ratable match with this player consults the
                    # same bad seed — isolating fewer would just fail
                    # again on the next retry; all offenders are
                    # collected into ONE raise for the same reason the
                    # structural pass above collects.
                    hit_any |= ratable & (idx == r).any(axis=(1, 2))
                    reasons.append(
                        f"player {self.player_at[r].api_id}: skill_tier "
                        f"{bad_tier[r]} outside [{constants.MIN_SKILL_TIER}, "
                        f"{constants.MAX_SKILL_TIER}] and the seed would be "
                        "consulted (no shared rating, no rank points)"
                    )
            if reasons:
                raise PoisonTierError(
                    tuple(self.matches[i].api_id for i in np.flatnonzero(hit_any)),
                    "; ".join(reasons),
                )

    def write_back(self, outs) -> None:
        """Applies HistoryOutputs (stream order) to the object graph with
        the reference's write set. Caller guarantees outs covers
        ``self.matches`` 1:1."""
        for i, m in enumerate(self.matches):
            mode_id = int(self.stream.mode_id[i])
            if mode_id == constants.UNSUPPORTED_MODE_ID:
                continue  # rater.py:83-85 — untouched
            col = constants.RATING_COLUMNS[mode_id + 1]
            if not outs.updated[i]:
                # AFK/invalid gate: quality=0, any_afk=True everywhere,
                # no rating writes (rater.py:102-106).
                m.trueskill_quality = 0
                for part in m.participants:
                    part.participant_items[0].any_afk = True
                continue
            m.trueskill_quality = float(outs.quality[i])
            for t in range(2):
                for s, part in enumerate(self.slot_part[i][t]):
                    player = part.player[0]
                    sh_mu = float(outs.shared_mu[i, t, s])
                    sh_sg = float(outs.shared_sigma[i, t, s])
                    part.trueskill_mu = sh_mu
                    part.trueskill_sigma = sh_sg
                    part.trueskill_delta = float(outs.delta[i, t, s])
                    player.trueskill_mu = sh_mu
                    player.trueskill_sigma = sh_sg
                    q_mu = float(outs.mode_mu[i, t, s])
                    q_sg = float(outs.mode_sigma[i, t, s])
                    setattr(player, f"{col}_mu", q_mu)
                    setattr(player, f"{col}_sigma", q_sg)
                    items = part.participant_items[0]
                    items.any_afk = False
                    setattr(items, f"{col}_mu", q_mu)
                    setattr(items, f"{col}_sigma", q_sg)
