"""Peaks of the card and the bytes of the rating step.

The peak is NVIDIA's data sheet for one H100 SXM at its 700 W limit; a
card set below it runs slower, so every share is reported beside the
card's power limit. The rating step does a few hundred flops a player
slot against its 133 bytes, a few flops a byte, where the card's 67
TFLOP/s of float32 over 3.35 TB/s is 20: bytes bound it, and only the
bytes are counted.
"""

from __future__ import annotations

#: Bytes per second of HBM3 on one H100 SXM.
HBM_BYTES_PER_S = 3.35e12

#: One player row of the rating table: 16 float32.
ROW_BYTES = 16 * 4
#: Per player slot of a rated match: its row read once and written once,
#: its int32 row index and its one-byte mask.
SLOT_BYTES = 2 * ROW_BYTES + 4 + 1
#: Per match: winner, mode and AFK flag as int32.
MATCH_BYTES = 3 * 4


def rating_step_bytes(rated_slots: int, matches: int) -> int:
    """The least bytes any implementation of the rating step moves for
    ``matches`` matches whose ratable ones fill ``rated_slots`` player
    slots: what is read and written once, whatever is read again."""
    return rated_slots * SLOT_BYTES + matches * MATCH_BYTES


def least_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
