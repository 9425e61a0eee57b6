"""Share of the window in which the re-rate's consumer waited on an empty
feed, in percent: the union of the ``feed.starved`` spans
(``sched/feed.DeviceFeed.get``, opened only when it blocks) clipped to the
window. The program that times this wait also splits its staging
(``feed.gather``); where the window holds that split and no wait, the
share is 0, and where it holds neither, nothing."""

from portbench.trace import merge


def read(win):
    if win.window_s <= 0 or not any(sp["name"] in ("feed.starved", "feed.gather")
                                    for sp in win.spans):
        return None
    waits = merge([(max(sp["t0"], win.t0), min(sp["t1"], win.t1))
                   for sp in win.spans if sp["name"] == "feed.starved"])
    return 100.0 * sum(e - s for s, e in waits) / win.window_s
