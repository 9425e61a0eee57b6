"""Milliseconds of the residency plan per superstep rated: the feed
thread's ``feed.plan`` spans (``sched/feed.stage_fused_windows``: the
ratable masks and ``sched/residency.plan_windows``) clipped to the window,
over the supersteps of the window's ``rate_stream`` calls. Nothing where
the program emits no such span."""


def read(win):
    steps = win.raw.get("steps", 0)
    if not steps or not any(sp["name"] == "feed.plan" for sp in win.spans):
        return None
    return 1e3 * win.span_seconds("feed.plan") / steps
