"""Match-stream files: CSV text and npz binary.

The port's copy of ``analyzer_tpu.io.csv_codec``; a file written by either
package reads into equal arrays in the other. One CSV row per match:
``match_id,mode,winner,afk,team0,team1`` where the team columns are
``;``-separated player ids. Mode is the reference's game-mode string
(``rater.py:70-82``); unknown strings map to ``UNSUPPORTED_MODE_ID`` and are
carried through (the reference logs and skips them, ``rater.py:83-85``).
Rows must already be in chronological order, as the reference's
``ORDER BY created_at ASC`` (``worker.py:176``). The npz form holds the
four stream arrays under their own names and loads in seconds where a
10M-match CSV takes minutes.
"""

from __future__ import annotations

import csv

import numpy as np

from analyzer_tpu_torch.core import constants
from analyzer_tpu_torch.sched.superstep import MatchStream

HEADER = ("match_id", "mode", "winner", "afk", "team0", "team1")


def save_stream_csv(path: str, stream: MatchStream) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(HEADER)
        for i in range(stream.n_matches):
            mode = (
                constants.MODES[stream.mode_id[i]]
                if stream.mode_id[i] >= 0
                else "unsupported"
            )
            teams = []
            for team in range(2):
                ids = stream.player_idx[i, team]
                teams.append(";".join(str(x) for x in ids[ids >= 0]))
            w.writerow([i, mode, int(stream.winner[i]), int(stream.afk[i])] + teams)


def save_stream_npz(
    path: str, stream: MatchStream, archetype: np.ndarray | None = None
) -> None:
    """The binary stream format (``np.savez``: a path without ``.npz``
    gets the suffix appended). ``archetype`` (``[P]`` int32 playstyle
    buckets) rides along as the JAX package's archetype block."""
    arrays = dict(
        player_idx=stream.player_idx,
        winner=stream.winner,
        mode_id=stream.mode_id,
        afk=stream.afk,
    )
    if archetype is not None:
        arrays["archetype"] = np.asarray(archetype, np.int32)
    np.savez(path, **arrays)


def load_stream_npz(path: str) -> MatchStream:
    """Reads the four stream arrays; other arrays in the file (the JAX
    package's optional telemetry and archetype blocks) are left alone."""
    with np.load(path) as z:
        return MatchStream(
            player_idx=z["player_idx"],
            winner=z["winner"],
            mode_id=z["mode_id"],
            afk=z["afk"],
        )


def save_stream(
    path: str, stream: MatchStream, archetype: np.ndarray | None = None
) -> None:
    """Extension-dispatched save: ``.npz`` binary (with the optional
    archetype block), anything else CSV."""
    if path.endswith(".npz"):
        save_stream_npz(path, stream, archetype)
    else:
        save_stream_csv(path, stream)


def load_stream(path: str) -> MatchStream:
    """Extension-dispatched load: ``.npz`` binary, anything else CSV."""
    if path.endswith(".npz"):
        return load_stream_npz(path)
    return load_stream_csv(path)


def load_stream_csv(path_or_file) -> MatchStream:
    """Parses a CSV stream from a path or an open text file."""
    if isinstance(path_or_file, str):
        with open(path_or_file, newline="") as f:
            return _parse(f)
    return _parse(path_or_file)


def _parse(f) -> MatchStream:
    rows = list(csv.reader(f))
    if rows and tuple(rows[0]) == HEADER:
        rows = rows[1:]
    n = len(rows)
    teams = [[r[4].split(";") if r[4] else [], r[5].split(";") if r[5] else []]
             for r in rows]
    t_max = max((max(len(t[0]), len(t[1])) for t in teams), default=1)
    player_idx = np.full((n, 2, t_max), -1, dtype=np.int32)
    winner = np.zeros(n, dtype=np.int32)
    mode_id = np.zeros(n, dtype=np.int32)
    afk = np.zeros(n, dtype=bool)
    for i, r in enumerate(rows):
        mode_id[i] = constants.MODE_TO_ID.get(r[1], constants.UNSUPPORTED_MODE_ID)
        winner[i] = int(r[2])
        afk[i] = bool(int(r[3]))
        for team in range(2):
            ids = teams[i][team]
            player_idx[i, team, : len(ids)] = [int(x) for x in ids]
    return MatchStream(player_idx=player_idx, winner=winner, mode_id=mode_id, afk=afk)
