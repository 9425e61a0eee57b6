"""Write a match history into a reference-schema sqlite database.

The reference's real data source is a MySQL schema of match / roster /
participant / participant_items / player rows keyed by TEXT api_ids
(``worker.py:50-83``). This generator materializes any
:class:`~analyzer_tpu_torch.sched.superstep.MatchStream` (synthetic or
otherwise) in that shape, so the whole DB lane — service worker,
``rate --db``, ``elo/train --db``, the ingest benchmarks — can be
exercised end to end without production data:

    python -m analyzer_tpu_torch.cli synth --matches 10000 --players 2000 --out h.db
    python -m analyzer_tpu_torch.cli rate --db sqlite:///h.db --db-write

Deterministic id scheme (also relied on by the fixture builders):
match ``m{i:09d}`` in stream order with ascending ``created_at``,
rosters ``m...r{team}``, participants ``m...t{team}s{slot}``, players
``p{row:08d}``.

The port's copy of ``analyzer_tpu.io.dbgen``: the same stream and players
give a database whose ``iterdump()`` equals the JAX package's.
"""

from __future__ import annotations

import os
import sqlite3

import numpy as np

from analyzer_tpu_torch.core import constants

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

# FK indexes: any real deployment has them; without them every selectin
# IN-list load in the service path is a full table scan (measured 81
# scans per 500-match batch). Created AFTER the bulk inserts — live
# indexes would be maintained row-by-row through millions of
# executemany rows.
INDEXES = """
CREATE INDEX idx_roster_match ON roster(match_api_id);
CREATE INDEX idx_part_match ON participant(match_api_id);
CREATE INDEX idx_part_roster ON participant(roster_api_id);
CREATE INDEX idx_items_part ON participant_items(participant_api_id);
CREATE INDEX idx_asset_match ON asset(match_api_id);
"""


def write_history_db(
    path: str, stream, players, items: bool = True,
) -> None:
    """Writes ``stream`` (+ the player features of ``players``, an
    :class:`~analyzer_tpu_torch.io.synthetic.SyntheticPlayers`-shaped object)
    to a fresh sqlite database at ``path``. ``items=False`` skips the
    one-per-participant participant_items rows (the columnar ingest
    never reads them; the SERVICE lane requires them — rater.py:104)."""
    n_matches = stream.n_matches
    n_players = players.n_players
    # Overwrite like the .csv/.npz writers do — executescript against a
    # leftover file would raise "table match already exists".
    if os.path.exists(path):
        os.unlink(path)
    conn = sqlite3.connect(path)
    conn.executescript(SCHEMA)
    conn.execute("PRAGMA journal_mode=OFF")
    conn.execute("PRAGMA synchronous=OFF")

    def null_if_nan(x: float):
        return None if np.isnan(x) else float(x)

    # The rows are built column-wise (one list per column, zipped into
    # executemany) rather than by a per-slot Python generator: the same
    # rows in the same order, several times faster at a million matches.
    tiers = [int(t) for t in np.asarray(players.skill_tier)[:n_players]]
    pids = [f"p{i:08d}" for i in range(n_players)]
    conn.executemany(
        "INSERT INTO player (api_id, skill_tier, rank_points_ranked,"
        " rank_points_blitz) VALUES (?, ?, ?, ?)",
        zip(
            pids, tiers,
            [null_if_nan(x) for x in players.rank_points_ranked[:n_players]],
            [null_if_nan(x) for x in players.rank_points_blitz[:n_players]],
        ),
    )
    mode_names = {i: name for name, i in constants.MODE_TO_ID.items()}
    mids = [f"m{m:09d}" for m in range(n_matches)]
    modes = [mode_names.get(int(x), "aral")  # unsupported mode name
             for x in np.asarray(stream.mode_id)[:n_matches]]
    conn.executemany(
        "INSERT INTO match (api_id, game_mode, created_at) VALUES (?, ?, ?)",
        zip(mids, modes, range(1_000_000, 1_000_000 + n_matches)),
    )
    winner = np.asarray(stream.winner)[:n_matches]
    rid = [[f"{mid}r{t}" for mid in mids] for t in range(2)]
    win = [[1 if w == t else 0 for w in winner.tolist()] for t in range(2)]
    conn.executemany(
        "INSERT INTO roster (api_id, match_api_id, winner) VALUES (?, ?, ?)",
        (
            (rid[t][m], mids[m], win[t][m])
            for m in range(n_matches) for t in range(2)
        ),
    )
    # Every filled slot in (match, team, slot) order; a match's AFK flag
    # lands on its first participant.
    idx = np.asarray(stream.player_idx)[:n_matches]
    mm, tt, ss = (a.tolist() for a in np.nonzero(idx >= 0))
    prow = idx[idx >= 0].tolist()
    first = np.ones(len(mm), bool)
    if len(mm) > 1:
        first[1:] = np.diff(np.asarray(mm)) != 0
    afk = (np.asarray(stream.afk)[:n_matches][np.asarray(mm, np.int64)]
           & first).astype(np.int64).tolist() if mm else []
    part_ids = [f"{mids[m]}t{t}s{x}" for m, t, x in zip(mm, tt, ss)]
    conn.executemany(
        "INSERT INTO participant (api_id, match_api_id, roster_api_id,"
        " player_api_id, skill_tier, went_afk) VALUES (?, ?, ?, ?, ?, ?)",
        zip(
            part_ids, [mids[m] for m in mm],
            [rid[t][m] for m, t in zip(mm, tt)],
            [pids[r] for r in prow], [tiers[r] for r in prow], afk,
        ),
    )
    if items:
        conn.executemany(
            "INSERT INTO participant_items (api_id, participant_api_id)"
            " VALUES (?, ?)",
            ((f"{pid}-items", pid) for pid in part_ids),
        )
    conn.executescript(INDEXES)
    conn.commit()
    conn.close()
