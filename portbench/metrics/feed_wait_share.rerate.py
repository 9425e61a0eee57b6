"""Share of the window in which the re-rate's consumer waited on the
producer's staging, in percent: the time the feed thread spent in
``feed.materialize`` (``runner._StreamFeed``, ``sched/feed.py``,
``sched/residency.py``) while the consumer (``sched/runner._consume``) was
in neither its ``feed.transfer`` nor its ``batch.compute`` span."""

from portbench.trace import merge


def _clipped(win, *names):
    return merge([(max(sp["t0"], win.t0), min(sp["t1"], win.t1))
                  for sp in win.spans
                  if sp["name"] in names and sp["t1"] > win.t0 and sp["t0"] < win.t1])


def read(win):
    if win.window_s <= 0 or not win.spans:
        return None
    staging = _clipped(win, "feed.materialize")
    busy = _clipped(win, "feed.transfer", "batch.compute")
    overlap, j = 0.0, 0
    for s0, s1 in staging:
        while j < len(busy) and busy[j][1] <= s0:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < s1:
            overlap += min(s1, busy[k][1]) - max(s0, busy[k][0])
            k += 1
    wait = sum(s1 - s0 for s0, s1 in staging) - overlap
    return 100.0 * wait / win.window_s
