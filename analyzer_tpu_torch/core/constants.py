"""Domain constants: game modes and the skill-tier -> points table.

Copied value for value from ``analyzer_tpu.core.constants`` (the port
keeps its own copy and imports nothing of the JAX package):

  * mode -> rating-column mapping, ``rater.py:70-85`` — six supported
    modes; anything else is unratable and must leave the match untouched;
  * the ``vst_points`` skill-tier table, ``rater.py:14-27``: tiers -1..29,
    tier 30 raises KeyError in the reference and is clamped by the tensor
    path.
"""

from __future__ import annotations

import numpy as np

# Order is load-bearing: mode_id is the index into this tuple, and column 1+i
# of the player-state table is mode i (column 0 is the shared rating).
MODES: tuple[str, ...] = (
    "casual",
    "ranked",
    "blitz",
    "br",
    "5v5_casual",
    "5v5_ranked",
)
MODE_TO_ID: dict[str, int] = {m: i for i, m in enumerate(MODES)}
N_MODES = len(MODES)
# Rating-state columns: 0 = shared "trueskill", 1..6 = "trueskill_<mode>".
N_RATING_COLS = 1 + N_MODES
SHARED_COL = 0

RATING_COLUMNS: tuple[str, ...] = ("trueskill",) + tuple(
    f"trueskill_{m}" for m in MODES
)

UNSUPPORTED_MODE_ID = -1

MIN_SKILL_TIER = -1
MAX_SKILL_TIER = 29


def _build_vst_points() -> dict[int, float]:
    """The tier-points table by the reference's own recurrence
    (``rater.py:14-27``): tiers -1,0 -> 1; then segment widths 109+1/11
    (tiers 1-11), 50 (12-15), 66+2/3 (16-24), 133+1/3 (25-27), 200
    (28-29), each tier placed at the segment midpoint (c + 0.5)."""
    pts: dict[int, float] = {-1: 1.0, 0: 1.0}
    for c in range(1, 12):
        pts[c] = (109 + 1 / 11) * (c + 0.5)
    for c in range(1, 5):
        pts[11 + c] = pts[11] + 50 * (c + 0.5)
    for c in range(1, 10):
        pts[15 + c] = pts[15] + (66 + 2 / 3) * (c + 0.5)
    for c in range(1, 4):
        pts[24 + c] = pts[24] + (133 + 1 / 3) * (c + 0.5)
    for c in range(1, 3):
        pts[27 + c] = pts[27] + 200 * (c + 0.5)
    return pts


VST_POINTS: dict[int, float] = _build_vst_points()

# Dense lookup for the tensor path: VST_TABLE[tier + 1] == VST_POINTS[tier].
VST_TABLE: np.ndarray = np.array(
    [VST_POINTS[t] for t in range(MIN_SKILL_TIER, MAX_SKILL_TIER + 1)],
    dtype=np.float64,
)
