"""Milliseconds of the consumer's dispatch per superstep rated: the
``feed.transfer`` (the chunk's copy to the card) and ``batch.compute``
(its launches) spans of ``sched/runner._consume`` in the window, over the
supersteps of the window's ``rate_stream`` calls."""


def read(win):
    steps = win.raw.get("steps", 0)
    if not steps or not win.spans:
        return None
    return 1e3 * win.span_seconds("feed.transfer", "batch.compute") / steps
