"""The rating step's share of its roofline, in percent: the least time
the window's rated matches need at the card's HBM bandwidth (each player
row read once and written once, each slot's index and mask, each match's
scalars: ``portbench/roofline.py``), over the device time of every
operation in the window (the profiler's busy intervals). Bytes bound the
step; the power limit is logged beside it."""

from portbench import roofline


def read(win):
    if win.busy_s <= 0:
        return None
    nbytes = roofline.rating_step_bytes(win.raw["rated_slots"], win.raw["matches"])
    return 100.0 * roofline.least_seconds(nbytes) / win.busy_s
