"""The worker's database: a frozen copy of the port's reference-schema
sqlite fixture (``io/dbgen.py`` with ``experiments/service_bench.py``'s
``items=True``), built in one transaction.

Schema, id scheme and row contents are dbgen's: match ``m{i:09d}`` in
stream order with ascending ``created_at``, rosters ``m...r{team}``,
participants ``m...t{team}s{slot}`` (a match's AFK flag on its first
participant), one ``participant_items`` row per participant, players
``p{row:08d}`` with their skill tier and rank points (NULL = missing).
The foreign-key indexes are created after the bulk inserts.

A store in service holds the matches it already rated as well as its
backlog: :func:`build` writes the first ``rated_matches`` matches as rated
(a quality, the participants' and their items' rating columns) and the
players' ratings as given, so the tables and the file have the rows and
widths of a rated history.
"""

from __future__ import annotations

import json
import os
import sqlite3

import numpy as np

MODES = ("casual", "ranked", "blitz", "br", "5v5_casual", "5v5_ranked")
UNSUPPORTED_MODE = "aral"
#: The quality a rated match of the history carries (a REAL of the width
#: the worker writes; nothing reads it back).
RATED_QUALITY = 0.5

SCHEMA = """
CREATE TABLE match (
    api_id TEXT PRIMARY KEY, game_mode TEXT, created_at INTEGER,
    trueskill_quality REAL
);
CREATE TABLE asset (id INTEGER PRIMARY KEY, match_api_id TEXT, url TEXT);
CREATE TABLE roster (
    api_id TEXT PRIMARY KEY, match_api_id TEXT, winner INTEGER
);
CREATE TABLE participant (
    api_id TEXT PRIMARY KEY, match_api_id TEXT, roster_api_id TEXT,
    player_api_id TEXT, skill_tier INTEGER, went_afk INTEGER,
    trueskill_mu REAL, trueskill_sigma REAL, trueskill_delta REAL
);
CREATE TABLE participant_stats (
    api_id TEXT PRIMARY KEY, participant_api_id TEXT, kills INTEGER
);
CREATE TABLE participant_items (
    api_id TEXT PRIMARY KEY, participant_api_id TEXT, any_afk INTEGER,
    trueskill_casual_mu REAL, trueskill_casual_sigma REAL,
    trueskill_ranked_mu REAL, trueskill_ranked_sigma REAL,
    trueskill_blitz_mu REAL, trueskill_blitz_sigma REAL,
    trueskill_br_mu REAL, trueskill_br_sigma REAL
);
CREATE TABLE player (
    api_id TEXT PRIMARY KEY, skill_tier INTEGER,
    rank_points_ranked REAL, rank_points_blitz REAL,
    trueskill_mu REAL, trueskill_sigma REAL,
    trueskill_casual_mu REAL, trueskill_casual_sigma REAL,
    trueskill_ranked_mu REAL, trueskill_ranked_sigma REAL,
    trueskill_blitz_mu REAL, trueskill_blitz_sigma REAL,
    trueskill_br_mu REAL, trueskill_br_sigma REAL,
    trueskill_5v5_casual_mu REAL, trueskill_5v5_casual_sigma REAL,
    trueskill_5v5_ranked_mu REAL, trueskill_5v5_ranked_sigma REAL
);
"""

INDEXES = """
CREATE INDEX idx_roster_match ON roster(match_api_id);
CREATE INDEX idx_part_match ON participant(match_api_id);
CREATE INDEX idx_part_roster ON participant(roster_api_id);
CREATE INDEX idx_items_part ON participant_items(participant_api_id);
CREATE INDEX idx_asset_match ON asset(match_api_id);
"""

#: The player table's rating columns in the reference table's column order
#: (shared, then the six modes; mu then sigma).
RATING_COLUMNS = ("trueskill",) + tuple(f"trueskill_{m}" for m in MODES)


def match_id(i: int) -> str:
    return f"m{i:09d}"


def player_id(row: int) -> str:
    return f"p{row:08d}"


# Numbers go into the database as JSON integers packed into bit fields
# (sqlite unpacks a JSON integer far faster than an array): a rating as a
# multiple of 1/RATING_SCALE offset by RATING_OFFSET in 31 bits, a rank
# point as a multiple of 1/POINT_SCALE in 19 bits; 0 is NULL. The
# divisions by powers of two are exact, so the database holds exactly
# what :func:`stored_ratings` and :func:`stored_points` return.
RATING_SCALE, RATING_OFFSET, RATING_BITS = 4096.0, 1 << 30, 31
POINT_SCALE, POINT_BITS = 64.0, 19


def _keys(x, scale, offset, bits) -> np.ndarray:
    x = np.asarray(x, np.float64)
    k = np.rint(np.nan_to_num(x) * scale) + offset
    if np.any(~np.isnan(x) & ((k <= 0) | (k >= 2**bits))):
        raise ValueError("a number outside its bit field")
    return np.where(np.isnan(x), 0, k).astype(np.int64)


def _held(keys, scale, offset) -> np.ndarray:
    return np.where(keys == 0, np.nan, (keys - offset) / scale)


def stored_ratings(ratings: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(the keys :func:`build` writes, the float32 values the database then
    holds) of ``[n, 14]`` ratings, NaN = NULL."""
    keys = _keys(ratings, RATING_SCALE, RATING_OFFSET, RATING_BITS)
    return keys, _held(keys, RATING_SCALE, RATING_OFFSET).astype(np.float32)


def stored_points(points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(keys, the float64 values the database then holds) of rank points,
    NaN = NULL."""
    keys = _keys(points, POINT_SCALE, 0, POINT_BITS)
    return keys, _held(keys, POINT_SCALE, 0)


def build(path: str, stream: dict, players: dict, rated_matches: int = 0,
          ratings: np.ndarray | None = None) -> None:
    """Writes the stream (host arrays, ``gen.make_stream``'s layout) and
    the players' features (host arrays) to a fresh database at ``path``:
    the rows go in as JSON arrays that sqlite unpacks itself
    (``json_each``), in dbgen's row order.

    The players' rank points are stored as :func:`stored_points` gives
    them. ``ratings`` (``[n_players, 14]``, :data:`RATING_COLUMNS`' mu then
    sigma, NaN = NULL) fills the player table's rating columns, stored as
    :func:`stored_ratings` gives them. The first ``rated_matches`` matches
    are written as rated: a quality, each participant's rating and its
    items' per-mode ratings from its player's row of ``ratings``."""
    if os.path.exists(path):
        os.unlink(path)
    idx = np.asarray(stream["player_idx"])
    mm, tt, ss = np.nonzero(idx >= 0)
    prow = idx[mm, tt, ss]
    tiers = np.asarray(players["skill_tier"], np.int64)
    first = np.ones(len(mm), bool)
    first[1:] = np.diff(mm) != 0
    afk = np.asarray(stream["afk"], bool)[mm] & first

    mode_case = " ".join(f"WHEN {i} THEN '{m}'" for i, m in enumerate(MODES))
    rated = int(rated_matches)
    conn = sqlite3.connect(path)
    try:
        conn.executescript(SCHEMA)
        conn.execute("PRAGMA journal_mode=OFF")
        conn.execute("PRAGMA synchronous=OFF")
        conn.execute("PRAGMA cache_size=-2000000")
        conn.execute("BEGIN")
        n = len(RATING_COLUMNS)
        rated_cols = ", ".join(f"c{i} REAL" for i in range(2 * n))
        conn.execute(f"CREATE TEMP TABLE r (row INTEGER PRIMARY KEY, {rated_cols})")
        if ratings is not None:
            # A rated player's row and seven keys, each a column's mu (low
            # bits) and sigma (high bits).
            keys = stored_ratings(ratings)[0]
            rows_rated = np.flatnonzero(keys.any(1))
            pairs = keys[rows_rated, :n] | (keys[rows_rated, n:] << RATING_BITS)
            conn.execute("CREATE TEMP TABLE rp (row INTEGER PRIMARY KEY, "
                         + ", ".join(f"p{i} INTEGER" for i in range(n)) + ")")
            conn.execute(
                "INSERT INTO rp SELECT json_extract(value, '$[0]'), "
                + ", ".join(f"json_extract(value, '$[{i + 1}]')" for i in range(n))
                + " FROM json_each(?)",
                (json.dumps(np.column_stack((rows_rated, pairs)).tolist()),),
            )
            mask = (1 << RATING_BITS) - 1

            def rating(field: str) -> str:
                return f"(NULLIF({field}, 0) - {RATING_OFFSET}) / {RATING_SCALE}"
            conn.execute(
                "INSERT INTO r SELECT row, "
                + ", ".join(rating(f"p{i} & {mask}") for i in range(n)) + ", "
                + ", ".join(rating(f"p{i} >> {RATING_BITS}") for i in range(n))
                + " FROM rp"
            )
        pmask = (1 << POINT_BITS) - 1
        packed_players = json.dumps(
            ((tiers + 1)
             | (stored_points(players["rank_points_ranked"])[0] << 5)
             | (stored_points(players["rank_points_blitz"])[0] << (5 + POINT_BITS))
             ).tolist())
        conn.execute(
            "INSERT INTO player (api_id, skill_tier, rank_points_ranked,"
            " rank_points_blitz, "
            + ", ".join(f"{c}_mu" for c in RATING_COLUMNS) + ", "
            + ", ".join(f"{c}_sigma" for c in RATING_COLUMNS)
            + ") SELECT printf('p%08d', key), (value & 31) - 1,"
            f" NULLIF((value >> 5) & {pmask}, 0) / {POINT_SCALE},"
            f" NULLIF((value >> {5 + POINT_BITS}) & {pmask}, 0) / {POINT_SCALE}, "
            + ", ".join(f"r.c{i}" for i in range(2 * n))
            + " FROM json_each(?) LEFT JOIN r ON r.row = key ORDER BY key",
            (packed_players,),
        )
        conn.execute(
            "INSERT INTO match (api_id, game_mode, created_at, trueskill_quality)"
            f" SELECT printf('m%09d', key), CASE value {mode_case} ELSE"
            f" '{UNSUPPORTED_MODE}' END, 1000000 + key, CASE WHEN key < {rated}"
            f" AND value >= 0 THEN {RATED_QUALITY} END FROM json_each(?)"
            " ORDER BY key",
            (json.dumps(np.asarray(stream["mode_id"]).tolist()),),
        )
        conn.execute(
            "INSERT INTO roster (api_id, match_api_id, winner) SELECT"
            " printf('m%09dr%d', m.key, t.t), printf('m%09d', m.key),"
            " m.value = t.t FROM json_each(?) AS m,"
            " (SELECT 0 AS t UNION ALL SELECT 1) AS t ORDER BY m.key, t.t",
            (json.dumps(np.asarray(stream["winner"]).tolist()),),
        )
        # One integer a participant (a JSON integer is far cheaper for
        # sqlite to unpack than an array): match, team, slot, player row,
        # AFK flag and skill tier + 1, in bit fields.
        if len(tiers) > 1 << 20:
            raise ValueError("player rows take 20 bits")
        packed = json.dumps(((mm.astype(np.int64) << 30) | (tt.astype(np.int64) << 29)
                             | (ss.astype(np.int64) << 26) | (prow.astype(np.int64) << 6)
                             | (afk.astype(np.int64) << 5)
                             | (tiers[prow] + 1)).tolist())
        fields = ("SELECT key AS k, value >> 30 AS m, (value >> 29) & 1 AS t,"
                  " (value >> 26) & 7 AS s, (value >> 6) & 1048575 AS pr,"
                  " (value >> 5) & 1 AS afk, (value & 31) - 1 AS tier"
                  " FROM json_each(?)")
        conn.execute(
            "INSERT INTO participant (api_id, match_api_id, roster_api_id,"
            " player_api_id, skill_tier, went_afk, trueskill_mu,"
            " trueskill_sigma, trueskill_delta) SELECT"
            " printf('m%09dt%ds%d', j.m, j.t, j.s), printf('m%09d', j.m),"
            " printf('m%09dr%d', j.m, j.t), printf('p%08d', j.pr), j.tier, j.afk,"
            " r.c0, r.c7, CASE WHEN r.row IS NOT NULL THEN 0.0 END"
            f" FROM ({fields}) AS j LEFT JOIN r ON j.m < {rated} AND r.row = j.pr"
            " ORDER BY j.k",
            (packed,),
        )
        # The items carry the four 3v3 modes' ratings (columns 1-4).
        conn.execute(
            "INSERT INTO participant_items (api_id, participant_api_id, "
            + ", ".join(f"{c}_mu, {c}_sigma" for c in RATING_COLUMNS[1:5])
            + ") SELECT p.api_id || '-items', p.api_id, "
            + ", ".join(f"r.c{i}, r.c{i + n}" for i in range(1, 5))
            + f" FROM participant AS p LEFT JOIN r ON p.match_api_id < '{match_id(rated)}'"
            " AND r.row = CAST(substr(p.player_api_id, 2) AS INTEGER)"
            " ORDER BY p.rowid"
        )
        conn.executescript(INDEXES)
        conn.commit()
    finally:
        conn.close()


def read_ratings(path: str, n_players: int) -> np.ndarray:
    """``[n_players, 14]`` float64 of the player table's rating columns
    (mu of shared + six modes, then their sigmas), NaN for NULL, by row
    (players are inserted in row order)."""
    cols = [f"{c}_mu" for c in RATING_COLUMNS] + [f"{c}_sigma" for c in RATING_COLUMNS]
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        got = conn.execute(
            f"SELECT {', '.join(cols)} FROM player ORDER BY rowid").fetchall()
    finally:
        conn.close()
    out = np.array(got, dtype=np.float64)
    if out.shape != (n_players, len(cols)):
        raise ValueError(f"player table holds {out.shape}, want {n_players} rows")
    return out
