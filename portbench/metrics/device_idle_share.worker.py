"""Share of the traced window in which no operation ran on the card, in
percent (the profiler's device intervals, merged)."""


def read(win):
    if win.busy_s <= 0 or win.window_s <= 0:
        return None
    return 100.0 * (win.window_s - win.busy_s) / win.window_s
