"""Milliseconds of the slab pack per superstep rated: the feed thread's
``feed.pack`` spans (``sched/feed.stage_fused_windows``: each window's
parts, then ``Slab.finish`` with its ``pin_memory()`` copy) clipped to the
window, over the supersteps of the window's ``rate_stream`` calls. Nothing
where the program emits no such span."""


def read(win):
    steps = win.raw.get("steps", 0)
    if not steps or not any(sp["name"] == "feed.pack" for sp in win.spans):
        return None
    return 1e3 * win.span_seconds("feed.pack") / steps
