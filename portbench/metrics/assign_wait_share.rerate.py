"""Share of the window in which the stream feed waited on the assigner
thread, in percent: the union of the ``feed.wait_assign`` spans
(``runner._StreamFeed``: from the feed's first sleep on the assigner to
its next window) clipped to the window. The program that times this wait
also splits its staging (``feed.gather``); where the window holds that
split and no wait, the share is 0, and where it holds neither, nothing."""

from portbench.trace import merge


def read(win):
    if win.window_s <= 0 or not any(sp["name"] in ("feed.wait_assign", "feed.gather")
                                    for sp in win.spans):
        return None
    waits = merge([(max(sp["t0"], win.t0), min(sp["t1"], win.t1))
                   for sp in win.spans if sp["name"] == "feed.wait_assign"])
    return 100.0 * sum(e - s for s, e in waits) / win.window_s
