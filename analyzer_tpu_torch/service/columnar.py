"""Columnar service lane: batch encode + write-back without object graphs.

The object lane (``SqlStore.load_batch`` -> ``EncodedBatch`` ->
``write_back`` -> ``commit``) round-trips every batch through ~11k
SimpleNamespace objects and ~100k dynamic attribute accesses. On the
1-core reference host every one of those python operations serializes
with everything else (the pipelined writer thread shares the GIL), and
profiling (round 5) put the object build + write-back at over half of the
service loop's per-batch host time. This lane keeps the SQL queries and
the SEMANTICS — gating rules, poison attribution, the reference's write
set (``rater.py:83-106,140-169``) — and replaces the object plumbing with
numpy over the raw rows (``SqlStore.load_batch_raw``).

Semantics parity is the contract, pinned by differential tests
(``tests/test_columnar.py``): for any batch, the final DATABASE STATE
after this lane equals the object lane's, and every poison/gate decision
(PoisonMatchError / PoisonTierError api_id sets, AFK gating, unsupported
skips) is identical. One DELIBERATE divergence, document-level: the
write plan updates only TOUCHED rows/columns, where the object lane
rewrites every loaded column with its (possibly just-loaded) value.
Final values agree whenever loads see current state — always, for the
sequential loop — but under pipelining the object lane's rewrite of a
stale snapshot value could regress a player row committed by an
in-flight predecessor batch (its chain patch fixes device priors, not
loaded python attributes). Touched-only writes are also what the
reference's ORM flush does: automap never UPDATEs unmodified attributes.

This lane is also the SEMANTICS CONTRACT for the wire-speed columnar
ingest decoder (``io/ingest.py``, docs/ingest.md): the decoder's
windowed output is bit-identical to the codec path's arrays, so every
gate this module applies downstream — AFK/validity, unsupported-mode
skips, the poison attribution above, the write set — is identical
whichever path the bytes arrived through (pinned by the differential
tests in ``tests/test_ingest.py``).

The port's copy of ``analyzer_tpu.service.columnar``: host numpy
throughout, with the finished player table built on the device the batch
is given (``device=None`` = the card). The wire-speed ingest decoder it
names is not ported yet (ROADMAP A10b).
"""

from __future__ import annotations

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
from analyzer_tpu_torch.service.encode import (
    PoisonMatchError,
    PoisonTierError,
    row_bucket,
)


def _first_occurrence_rank(values: np.ndarray):
    """(rank_of_each, n_unique): ranks unique values by FIRST appearance
    order (the object lane's dict-insertion numbering)."""
    _, first_idx, inv = np.unique(values, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(order.size, np.int64)
    rank[order] = np.arange(order.size)
    return rank[inv], order.size


def _index_of(haystack: np.ndarray, needles: np.ndarray):
    """Position of each needle in ``haystack`` (unique values), ok mask
    for misses."""
    if haystack.size == 0 or needles.size == 0:
        return (np.zeros(needles.shape, np.int64),
                np.zeros(needles.shape, bool))
    order = np.argsort(haystack, kind="stable")
    sh = haystack[order]
    pos = np.searchsorted(sh, needles)
    pos = np.minimum(pos, sh.size - 1)
    got = order[pos]
    return got, sh[pos] == needles


def _cumcount(keys: np.ndarray) -> np.ndarray:
    """Occurrence index within each key group, arrival-order stable."""
    if keys.size == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    first = np.r_[True, sk[1:] != sk[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(sk.size), 0))
    out = np.empty(sk.size, np.int64)
    out[order] = np.arange(sk.size) - start
    return out


def _float_col(col) -> np.ndarray:
    """column (object numbers/None, or an already-typed array) ->
    float64 with NaN for NULL."""
    col = np.asarray(col)
    if col.dtype != object:
        return col.astype(np.float64)
    out = np.empty(col.shape[0], np.float64)
    mask = np.array([v is None for v in col], bool)
    out[mask] = np.nan
    if (~mask).any():
        out[~mask] = col[~mask].astype(np.float64)
    return out


def _as_str(arr: np.ndarray) -> np.ndarray:
    """S-dtype (native scanner) -> unicode; object/U passes through."""
    if arr.dtype.kind == "S":
        return np.char.decode(arr, "utf-8")
    return arr


def _bool_col(col) -> np.ndarray:
    col = np.asarray(col)
    if col.dtype == object:
        return np.array([bool(v) for v in col], bool)
    return col != 0


def _normalize(raw: dict) -> dict:
    """Row-bundle form (``load_batch_raw`` / ``synthetic_raw_batch``) ->
    the array form ``load_batch_native`` produces, so the encoder has
    ONE data layout. Native S-dtype id columns stay S (joins run on
    fixed-width bytes); the encoder decodes only outward-facing ids."""
    if "match" in raw:
        return raw
    def cols(rows, names):
        if not rows:
            return {n: np.empty(0, object) for n in names}
        t = list(zip(*rows))
        return {n: np.array(t[i], object) for i, n in enumerate(names)}

    return {
        "match": cols(raw["match_rows"], ["api_id", "game_mode", "created_at"]),
        "roster": cols(raw["roster_rows"], ["api_id", "match_api_id", "winner"]),
        "participant": cols(
            raw["part_rows"],
            ["api_id", "match_api_id", "roster_api_id", "player_api_id",
             "skill_tier", "went_afk"],
        ),
        "player": cols(raw["player_rows"], raw["player_cols"]),
        "player_cols": raw["player_cols"],
        "items": cols(raw["items_rows"], raw["items_cols"]),
        "schema_rating_cols": raw["schema_rating_cols"],
        "schema_columns": raw["schema_columns"],
    }


class ColumnarBatch:
    """Array-lane counterpart of :class:`EncodedBatch`, built from
    ``SqlStore.load_batch_raw`` rows. Exposes the same downstream
    surface: ``state``, ``stream``, ``row_of``, ``matches`` (api_ids —
    ``len`` and truthiness match the object lane's list of match
    objects), plus :meth:`write_plan` replacing write_back + commit.
    ``device`` is where the player table lives (None = the card; asking
    for it without one raises before anything is encoded)."""

    def __init__(self, raw: dict, cfg: RatingConfig, bucket_rows: bool = False,
                 device=None):
        device = resolve_device(device)
        self.cfg = cfg
        raw = _normalize(raw)
        mid = np.asarray(raw["match"]["api_id"])
        n = int(mid.shape[0])
        self.api_ids: list[str] = list(_as_str(mid))
        self.matches = self.api_ids  # len()/truthiness parity with EncodedBatch
        self.n_matches = n
        self._schema_rating = raw["schema_rating_cols"]
        self._schema_cols = raw["schema_columns"]

        gm = np.asarray(raw["match"]["game_mode"])
        mode = np.full(n, constants.UNSUPPORTED_MODE_ID, np.int32)
        for name, mval in constants.MODE_TO_ID.items():
            key = name.encode() if gm.dtype.kind == "S" else name
            mode[gm == key] = mval

        # -- rosters: arrival order defines team 0/1 ----------------------
        r_id = np.asarray(raw["roster"]["api_id"])
        r_mid = np.asarray(raw["roster"]["match_api_id"])
        r_win = _bool_col(raw["roster"]["winner"])
        r_match, ok = _index_of(mid, r_mid)
        if not ok.all():  # the object lane's by_match[...] KeyError
            raise KeyError(r_mid[~ok][0])
        r_team = _cumcount(r_match)
        roster_count = np.bincount(r_match, minlength=n)
        bad = roster_count != 2  # rater.py:91-93 validity gate

        poison: dict[str, str] = {}
        wflag = np.zeros((n, 2), bool)
        in_team = r_team < 2
        wflag[r_match[in_team], r_team[in_team]] = r_win[in_team]
        tie = ~bad & (wflag[:, 0] == wflag[:, 1])
        for i in np.flatnonzero(tie):
            # Message format matches EncodedBatch (a python bool list).
            flags = [bool(wflag[i, 0]), bool(wflag[i, 1])]
            poison[self.api_ids[i]] = (
                f"rosters must have exactly one winner, got winner "
                f"flags {flags}"
            )
        # The object lane leaves winner at its zero default for bad/tie
        # matches (they never reach the assignment).
        winner = np.where(~bad & ~tie & ~wflag[:, 0], 1, 0).astype(np.int32)

        # -- participants -------------------------------------------------
        p_id = np.asarray(raw["participant"]["api_id"])
        k = int(p_id.shape[0])
        p_id_str = _as_str(p_id)
        p_mid = np.asarray(raw["participant"]["match_api_id"])
        p_rid = np.asarray(raw["participant"]["roster_api_id"])
        p_pid = np.asarray(raw["participant"]["player_api_id"])
        p_afk = raw["participant"]["went_afk"]
        p_match, ok = _index_of(mid, p_mid)
        if not ok.all():
            raise KeyError(_as_str(p_mid[~ok])[0])

        # -- players: encode rows by first appearance in (match, arrival)
        # order — the object lane's dict-insertion numbering over
        # `for m in matches: for part in m.participants`.
        enc_order = np.argsort(p_match, kind="stable")
        player_cols = raw["player_cols"]
        pl = raw["player"]
        pl_id = np.asarray(pl["api_id"])
        pl_id_str = _as_str(pl_id)
        # part player -> player-table row; a dangling player id raises
        # KeyError like the object lane's players[player_api_id].
        p_prow, ok = _index_of(pl_id, p_pid)
        if not ok.all():
            raise KeyError(_as_str(p_pid[~ok])[0])
        row_of_part = np.empty(k, np.int64)
        ranks, p_count = _first_occurrence_rank(p_prow[enc_order])
        row_of_part[enc_order] = ranks
        self.n_players = p = p_count
        # player-table arrival row -> encode row
        arrival_to_enc = np.full(pl_id.size, -1, np.int64)
        arrival_to_enc[p_prow[enc_order]] = ranks  # last write wins; all equal per row
        self.row_of = {
            pid: int(arrival_to_enc[j])
            for j, pid in enumerate(pl_id_str)
            if arrival_to_enc[j] >= 0
        }
        self._player_ids_by_row = np.empty(p, object)
        for j, pid in enumerate(pl_id_str):
            if arrival_to_enc[j] >= 0:
                self._player_ids_by_row[arrival_to_enc[j]] = pid

        alloc = row_bucket(p) if bucket_rows else p

        # -- state table from player columns ------------------------------
        table = np.full((alloc + 1, TABLE_WIDTH), np.nan, np.float32)
        rr = np.full((alloc + 1,), np.nan, np.float32)
        rb = np.full((alloc + 1,), np.nan, np.float32)
        ti = np.zeros((alloc + 1,), np.int32)
        col_at = {c: j for j, c in enumerate(player_cols)}
        enc_of = arrival_to_enc  # alias
        present = enc_of >= 0
        rows_enc = enc_of[present]
        from analyzer_tpu_torch.service.encode import _RATING_ATTRS

        for c, mu_col, sg_col in _RATING_ATTRS:
            if mu_col not in col_at:
                continue
            mu = _float_col(pl[mu_col])
            has_mu = ~np.isnan(mu)
            if has_mu.any():
                if sg_col in col_at:
                    sg = _float_col(pl[sg_col])
                else:
                    sg = np.full(mu.shape, np.nan)
                if (has_mu & np.isnan(sg)).any():
                    # The object lane's float(None) on a mu without its
                    # sigma — malformed data, unattributable.
                    raise TypeError(
                        f"player "
                        f"{pl_id_str[has_mu & np.isnan(sg)][0]!r} has "
                        f"{mu_col} but a NULL/absent {sg_col}"
                    )
                sel = present & has_mu
                table[enc_of[sel], MU_LO + c] = mu[sel].astype(np.float32)
                # Sigma only ever lands next to its mu — the object lane
                # never writes sigma without mu (rows with NULL mu stay
                # NaN in both columns even when sigma has a value).
                table[enc_of[sel], SIGMA_LO + c] = sg[sel].astype(np.float32)
        if "rank_points_ranked" in col_at:
            rr[rows_enc] = _float_col(
                pl["rank_points_ranked"]
            )[present].astype(np.float32)
        if "rank_points_blitz" in col_at:
            rb[rows_enc] = _float_col(
                pl["rank_points_blitz"]
            )[present].astype(np.float32)
        bad_tier: dict[int, object] = {}
        if "skill_tier" in col_at:
            tier_raw = np.asarray(pl["skill_tier"])
            tier_f = _float_col(tier_raw)
            obj_form = tier_raw.dtype == object
            for j in np.flatnonzero(present & ~np.isnan(tier_f)):
                tv = tier_f[j]
                r = int(enc_of[j])
                if not (constants.MIN_SKILL_TIER <= tv <= constants.MAX_SKILL_TIER):
                    # Keep the raw value for the poison message (the
                    # object lane formats what the DB held).
                    bad_tier[r] = (
                        tier_raw[j] if obj_form
                        else (int(tv) if float(tv).is_integer() else tv)
                    )
                    ti[r] = int(min(max(tv, constants.MIN_SKILL_TIER),
                                    constants.MAX_SKILL_TIER))
                else:
                    ti[r] = int(tv)
        seed_mu, seed_sigma = trueskill_seed_host(rr, rb, ti, cfg)
        table[:, COL_SEED_MU] = seed_mu
        table[:, COL_SEED_SIGMA] = seed_sigma
        self.state = PlayerState.from_numpy(
            table, rr, rb, ti, seed_cfg=cfg, device=device
        )

        # -- slotting: participant arrival order within its ROSTER --------
        p_ros, ros_ok = _index_of(r_id, p_rid)
        slot = _cumcount(np.where(ros_ok, p_ros, -1))
        # slot team/match come from the ROSTER's attachment (the object
        # lane slots through roster.participants).
        s_match = np.where(ros_ok, r_match[np.clip(p_ros, 0, None)], -1)
        s_team = np.where(ros_ok, r_team[np.clip(p_ros, 0, None)], -1)
        slottable = (
            ros_ok
            & (s_match >= 0)
            & ~bad[np.clip(s_match, 0, None)]
            & (s_team < 2)
        )
        # Oversize team -> poison that roster's match, void its slots
        # (EncodedBatch: idx[i] = -1 and the raise below gates any use).
        over = slottable & (slot >= MAX_TEAM_SIZE)
        for j in np.flatnonzero(over):
            i = int(s_match[j])
            api = self.api_ids[i]
            if api not in poison:
                team_len = int(
                    (slottable & (s_match == i) & (s_team == s_team[j])).sum()
                )
                poison[api] = (
                    f"team of {team_len} exceeds max team size "
                    f"{MAX_TEAM_SIZE}"
                )
        over_match = np.zeros(n, bool)
        over_match[s_match[over]] = True
        tie_or_over = tie | over_match
        slottable &= ~tie_or_over[np.clip(s_match, 0, None)]

        idx = np.full((n, 2, MAX_TEAM_SIZE), -1, np.int32)
        sj = np.flatnonzero(slottable)
        idx[s_match[sj], s_team[sj], slot[sj]] = row_of_part[sj]

        # -- AFK / validity gate ------------------------------------------
        afk = np.zeros(n, bool)
        p_afk_arr = np.asarray(p_afk)
        if p_afk_arr.dtype == object:
            went = np.array([v == 1 for v in p_afk_arr], bool)
        else:
            went = p_afk_arr == 1
        afk[p_match[went]] = True
        afk |= bad

        # -- items: first row per participant -----------------------------
        it_id = np.asarray(raw["items"]["api_id"])
        it_pid = np.asarray(raw["items"]["participant_api_id"])
        # first arrival per participant = the object lane's
        # participant_items[0]
        it_part, it_ok = _index_of(p_id, it_pid)
        first_seen: dict[int, int] = {}
        for j in np.flatnonzero(it_ok):
            tgt = int(it_part[j])
            if tgt not in first_seen:
                first_seen[tgt] = j
        has_items = np.zeros(k, bool)
        item0_of_part = np.full(k, -1, np.int64)
        for tgt, j in first_seen.items():
            has_items[tgt] = True
            item0_of_part[tgt] = j
        # Missing-items poison for supported-mode matches (write-back
        # target check, rater.py:104,169) — first offender per match,
        # iterating parts in the object lane's m.participants order.
        supported = mode != constants.UNSUPPORTED_MODE_ID
        need = supported[p_match] & ~has_items
        for j in enc_order[need[enc_order]]:
            api = self.api_ids[int(p_match[j])]
            if api in poison:
                continue
            poison[api] = (
                f"participant {str(p_id_str[j])!r} has no "
                "participant_items row (write-back target, "
                "rater.py:104,169)"
            )
        if poison:
            raise PoisonMatchError(
                tuple(poison),
                "; ".join(f"match {a}: {m}" for a, m in poison.items()),
            )

        self.stream = MatchStream(
            player_idx=idx, winner=winner, mode_id=mode, afk=afk
        )

        # -- reference-faithful out-of-table tier gate --------------------
        if bad_tier:
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
                    hit_any |= ratable & (idx == r).any(axis=(1, 2))
                    reasons.append(
                        f"player {self._player_ids_by_row[r]}: skill_tier "
                        f"{bad_tier[r]} outside [{constants.MIN_SKILL_TIER}, "
                        f"{constants.MAX_SKILL_TIER}] and the seed would be "
                        "consulted (no shared rating, no rank points)"
                    )
            if reasons:
                raise PoisonTierError(
                    tuple(self.api_ids[i] for i in np.flatnonzero(hit_any)),
                    "; ".join(reasons),
                )

        # -- write-plan precomputation ------------------------------------
        self._p_api = p_id_str
        self._p_match = p_match
        self._row_of_part = row_of_part
        self._slottable = slottable
        self._s_team = s_team
        self._slot = slot
        it_id_str = _as_str(it_id)
        self._item0_api = np.array(
            [it_id_str[item0_of_part[j]] if item0_of_part[j] >= 0 else None
             for j in range(k)],
            dtype=object,
        )

    # -- write-back ------------------------------------------------------
    def write_plan(self, outs) -> list:
        """The reference's write set (``rater.py:140-169``) as
        ``[(table, cols, key, rows), ...]`` for
        :meth:`SqlStore.commit_columnar`, touched rows/columns only. See
        the module docstring for the value-parity argument."""
        n = self.n_matches
        mode = np.asarray(self.stream.mode_id)
        updated = np.asarray(outs.updated, bool)
        supported = mode != constants.UNSUPPORTED_MODE_ID
        rated = supported & updated
        gated = supported & ~updated

        plan: list = []
        sc = self._schema_cols

        # match.trueskill_quality: posterior | int 0 (gate) | NULL
        # (unsupported — the object lane loads quality as None and
        # rewrites it).
        if "trueskill_quality" in sc["match"]:
            q = np.asarray(outs.quality, np.float64)
            rows = []
            for i in range(n):
                if rated[i]:
                    rows.append((float(q[i]), self.api_ids[i]))
                elif gated[i]:
                    rows.append((0, self.api_ids[i]))
                else:
                    rows.append((None, self.api_ids[i]))
            plan.append(("match", ["trueskill_quality"], "api_id", rows))

        # participants: slotted parts of rated matches get posteriors;
        # every other part of a batch match gets NULLs (the object lane
        # writes their loaded Nones).
        sl = self._slottable & rated[self._p_match]
        i_ = self._p_match[sl]
        t_ = self._s_team[sl]
        s_ = self._slot[sl]
        sh_mu = np.asarray(outs.shared_mu, np.float64)[i_, t_, s_]
        sh_sg = np.asarray(outs.shared_sigma, np.float64)[i_, t_, s_]
        dl = np.asarray(outs.delta, np.float64)[i_, t_, s_]
        part_cols = [
            c for c in ("trueskill_mu", "trueskill_sigma", "trueskill_delta")
            if c in sc["participant"]
        ]
        if part_cols == ["trueskill_mu", "trueskill_sigma", "trueskill_delta"]:
            rows = [
                (float(m), float(s), float(d), a)
                for m, s, d, a in zip(sh_mu, sh_sg, dl, self._p_api[sl])
            ]
            rows += [(None, None, None, a) for a in self._p_api[~sl]]
            plan.append(("participant", part_cols, "api_id", rows))
        elif part_cols:  # partial schema: positional subsets
            vals = {
                "trueskill_mu": sh_mu, "trueskill_sigma": sh_sg,
                "trueskill_delta": dl,
            }
            picked = [vals[c] for c in part_cols]
            rows = [
                tuple(float(v[j]) for v in picked) + (a,)
                for j, a in enumerate(self._p_api[sl])
            ]
            rows += [
                (None,) * len(part_cols) + (a,) for a in self._p_api[~sl]
            ]
            plan.append(("participant", part_cols, "api_id", rows))

        # players: per encode row, the LAST slotted-rated appearance sets
        # shared mu/sigma; the last appearance per mode sets that mode's
        # pair. Grouped by touched-column bitmask -> one executemany per
        # distinct column set.
        mode_col_idx = mode[i_] + 1  # RATING_COLUMNS position per write
        q_mu = np.asarray(outs.mode_mu, np.float64)[i_, t_, s_]
        q_sg = np.asarray(outs.mode_sigma, np.float64)[i_, t_, s_]
        prow = self._row_of_part[sl]
        pl_schema = set(self._schema_rating["player"])
        if prow.size:
            p = self.n_players
            # last overall appearance per row (writes ran in (i, t, s)
            # order in the object lane; arrays here are already in part
            # arrival order — re-sort by the write key to be exact)
            wkey = (i_ * 2 + t_) * MAX_TEAM_SIZE + s_
            order = np.argsort(wkey, kind="stable")

            def last_per(key_arr, order):
                rev = order[::-1]
                uniq, first_rev = np.unique(key_arr[rev], return_index=True)
                return uniq, rev[first_rev]

            rows_touched, last_j = last_per(prow, order)
            shared_mu_f = np.full(p, np.nan)
            shared_sg_f = np.full(p, np.nan)
            shared_mu_f[rows_touched] = sh_mu[last_j]
            shared_sg_f[rows_touched] = sh_sg[last_j]
            # per (row, mode col)
            mkey = prow * (constants.N_MODES + 1) + mode_col_idx
            mk_u, mk_j = last_per(mkey, order)
            col_touched = np.zeros((p, constants.N_MODES + 1), bool)
            mode_val_mu = np.full((p, constants.N_MODES + 1), np.nan)
            mode_val_sg = np.full((p, constants.N_MODES + 1), np.nan)
            rws = mk_u // (constants.N_MODES + 1)
            cls = mk_u % (constants.N_MODES + 1)
            col_touched[rws, cls] = True
            mode_val_mu[rws, cls] = q_mu[mk_j]
            mode_val_sg[rws, cls] = q_sg[mk_j]

            # bitmask per row: bit 0 = shared, bit c = mode col c
            bitmask = np.zeros(p, np.int64)
            bitmask[rows_touched] |= 1
            for c in range(1, constants.N_MODES + 1):
                bitmask[col_touched[:, c]] |= 1 << c
            for bm in np.unique(bitmask):
                if bm == 0:
                    continue
                rws_g = np.flatnonzero(bitmask == bm)
                cols: list[str] = []
                vals: list[np.ndarray] = []
                if bm & 1:
                    for cn, arr in (("trueskill_mu", shared_mu_f),
                                    ("trueskill_sigma", shared_sg_f)):
                        if cn in pl_schema:
                            cols.append(cn)
                            vals.append(arr[rws_g])
                for c in range(1, constants.N_MODES + 1):
                    if bm & (1 << c):
                        base = constants.RATING_COLUMNS[c]
                        for cn, arr in ((f"{base}_mu", mode_val_mu[:, c]),
                                        (f"{base}_sigma", mode_val_sg[:, c])):
                            if cn in pl_schema:
                                cols.append(cn)
                                vals.append(arr[rws_g])
                if not cols:
                    continue
                ids_g = self._player_ids_by_row[rws_g]
                rows = [
                    tuple(float(v[j]) for v in vals) + (ids_g[j],)
                    for j in range(rws_g.size)
                ]
                plan.append(("player", cols, "api_id", rows))

        # participant_items: rated slotted -> any_afk False + the match's
        # mode pair (grouped per mode column); gated matches -> any_afk
        # True on every part's first item (unsupported: untouched).
        it_schema = set(self._schema_rating["participant_items"])
        has_afk_col = "any_afk" in sc["participant_items"]
        item_api = self._item0_api
        for c in range(1, constants.N_MODES + 1):
            base = constants.RATING_COLUMNS[c]
            selc = sl & (mode[self._p_match] + 1 == c)
            if not selc.any():
                continue
            jj = np.flatnonzero(selc)
            cols = []
            if has_afk_col:
                cols.append("any_afk")
            pair = [cn for cn in (f"{base}_mu", f"{base}_sigma")
                    if cn in it_schema]
            cols += pair
            if not cols:
                continue
            i2 = self._p_match[jj]
            t2 = self._s_team[jj]
            s2 = self._slot[jj]
            qm = np.asarray(outs.mode_mu, np.float64)[i2, t2, s2]
            qs = np.asarray(outs.mode_sigma, np.float64)[i2, t2, s2]
            rows = []
            for x, j in enumerate(jj):
                vals: tuple = ()
                if has_afk_col:
                    vals += (False,)
                if f"{base}_mu" in it_schema:
                    vals += (float(qm[x]),)
                if f"{base}_sigma" in it_schema:
                    vals += (float(qs[x]),)
                rows.append(vals + (item_api[j],))
            plan.append(("participant_items", cols, "api_id", rows))
        if has_afk_col:
            gsel = gated[self._p_match]
            rows = [(True, item_api[j]) for j in np.flatnonzero(gsel)]
            if rows:
                plan.append(("participant_items", ["any_afk"], "api_id", rows))
        return plan


def finalize(store, enc, outs) -> None:
    """Applies a batch's outputs through whichever lane ``enc`` is:
    columnar (write_plan -> commit_columnar) or object graph
    (write_back -> commit). The single seam the worker and the pipelined
    writer share, so the two loops cannot disagree on lane selection."""
    plan_fn = getattr(enc, "write_plan", None)
    commit_columnar = getattr(store, "commit_columnar", None)
    if plan_fn is not None and commit_columnar is not None and outs is not None:
        commit_columnar(plan_fn(outs))
        return
    if outs is not None:
        enc.write_back(outs)
    commit = getattr(store, "commit", None)
    if commit is not None and enc.matches:
        commit(enc.matches)
