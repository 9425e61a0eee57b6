"""Milliseconds of the window arrays per superstep rated: the feed
thread's ``feed.gather`` spans (``runner._StreamFeed._stage``: the filler
backfill, ``materialize_gather_window`` and ``materialize_scalar_window``)
clipped to the window, over the supersteps of the window's ``rate_stream``
calls. Nothing where the program emits no such span."""


def read(win):
    steps = win.raw.get("steps", 0)
    if not steps or not any(sp["name"] == "feed.gather" for sp in win.spans):
        return None
    return 1e3 * win.span_seconds("feed.gather") / steps
