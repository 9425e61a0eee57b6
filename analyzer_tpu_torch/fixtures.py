"""Duck-typed fake ORM object factories.

The reference's tests hand-build plain classes mirroring only the
attributes ``rate_match`` touches (``worker_test.py:6-63``) — no DB, no
broker, no mocks. These factories keep that strategy (SURVEY.md section 4
calls it the single most important design fact to preserve) but cover the
full 7-column rating schema, including the 5v5 pairs the reference's
fixtures omit.

They live in the package (not under ``tests/``) because production code
uses them too: the worker's warmup cost probe encodes a synthetic
batch-size object graph to measure per-batch host time
(``service/worker.py``). One definition keeps the probe and the parity
tests from drifting when the encoded attribute set changes.

The port's copy of ``analyzer_tpu.fixtures``.
"""

from __future__ import annotations

from types import SimpleNamespace

from analyzer_tpu_torch.core.constants import RATING_COLUMNS


def fake_player(skill_tier=None, rank_points_ranked=None, rank_points_blitz=None,
                **ratings):
    attrs = {"api_id": "", "skill_tier": skill_tier,
             "rank_points_ranked": rank_points_ranked,
             "rank_points_blitz": rank_points_blitz}
    for col in RATING_COLUMNS:
        attrs[f"{col}_mu"] = None
        attrs[f"{col}_sigma"] = None
    attrs.update(ratings)
    return SimpleNamespace(**attrs)


def fake_items(**ratings):
    attrs = {"api_id": "", "any_afk": False}
    for col in RATING_COLUMNS[1:]:
        attrs[f"{col}_mu"] = None
        attrs[f"{col}_sigma"] = None
    attrs.update(ratings)
    return SimpleNamespace(**attrs)


def fake_participant(player=None, items=None, skill_tier=0, went_afk=False):
    return SimpleNamespace(
        api_id="",
        skill_tier=skill_tier,
        went_afk=went_afk,
        trueskill_mu=None,
        trueskill_sigma=None,
        trueskill_delta=None,
        participant_items=[items if items is not None else fake_items()],
        player=[player if player is not None else fake_player()],
    )


def fake_roster(winner, participants):
    return SimpleNamespace(api_id="", winner=winner, participants=participants)


def fake_match(game_mode, rosters, api_id=""):
    return SimpleNamespace(
        api_id=api_id,
        game_mode=game_mode,
        rosters=rosters,
        participants=[p for r in rosters for p in r.participants],
        trueskill_quality=None,
        created_at=0,
    )


def synthetic_raw_batch(n: int, team_size: int = 3,
                        game_mode: str = "ranked") -> dict:
    """``n`` well-formed two-team matches as a ``load_batch_raw``-shaped
    raw row bundle (the columnar lane's input) — the warmup cost probe's
    counterpart of :func:`synthetic_batch` for stores that will run the
    columnar lane in production. Fresh tier-15 players, full 7-pair
    rating schema, one items row per participant."""
    pl_rating = [f"{c}_{x}" for c in RATING_COLUMNS for x in ("mu", "sigma")]
    it_rating = [
        f"{c}_{x}" for c in RATING_COLUMNS[1:] for x in ("mu", "sigma")
    ]
    match_rows, roster_rows, part_rows = [], [], []
    player_rows, items_rows = [], []
    for m in range(n):
        mid = f"warm_m{m}"
        match_rows.append((mid, game_mode, m))
        for t in range(2):
            rid = f"{mid}-r{t}"
            roster_rows.append((rid, mid, int(t == 0)))
            for s in range(team_size):
                pid = f"warm_{m}_{t}_{s}"
                paid = f"{mid}-{t}-{s}"
                part_rows.append((paid, mid, rid, pid, 15, 0))
                player_rows.append(
                    (pid, None, None, 15) + (None,) * len(pl_rating)
                )
                items_rows.append(
                    (paid + "-it", paid, 0) + (None,) * len(it_rating)
                )
    player_cols = [
        "api_id", "rank_points_ranked", "rank_points_blitz", "skill_tier",
    ] + pl_rating
    items_cols = ["api_id", "participant_api_id", "any_afk"] + it_rating
    return {
        "match_rows": match_rows,
        "roster_rows": roster_rows,
        "part_rows": part_rows,
        "player_cols": player_cols,
        "player_rows": player_rows,
        "items_cols": items_cols,
        "items_rows": items_rows,
        "schema_rating_cols": {
            "player": pl_rating, "participant_items": it_rating,
        },
        "schema_columns": {
            "match": {"api_id", "game_mode", "created_at",
                      "trueskill_quality"},
            "participant": {"api_id", "trueskill_mu", "trueskill_sigma",
                            "trueskill_delta"},
            "player": set(player_cols),
            "participant_items": set(items_cols),
        },
    }


def synthetic_batch(n: int, team_size: int = 3, game_mode: str = "ranked",
                    id_prefix: str = "warm") -> list:
    """``n`` well-formed two-team matches of fresh tier-15 players, every
    player distinct — the worker's warmup probe input (never touches a
    store)."""
    matches = []
    for m in range(n):
        rosters = []
        for t in range(2):
            parts = [
                fake_participant(
                    player=fake_player(skill_tier=15),
                    skill_tier=15,
                )
                for _ in range(team_size)
            ]
            for s, part in enumerate(parts):
                part.player[0].api_id = f"{id_prefix}_{m}_{t}_{s}"
            rosters.append(fake_roster(winner=int(t == 0), participants=parts))
        match = fake_match(game_mode, rosters, api_id=f"{id_prefix}_m{m}")
        match.created_at = m
        matches.append(match)
    return matches
