"""Share of the window the migration's lineage takes on the consumer's
thread, in percent: the union of the staging publishes at chunk
boundaries (``view.publish``, ``sched/runner._consume``), the final
staging publish (``migrate.publish``, ``migrate/engine.rate_backfill``)
and the cutover (``migrate.cutover``, ``migrate/lineage.cutover``),
clipped to the window. Nothing where the program emits no cutover span."""

from portbench.trace import merge

NAMES = ("view.publish", "migrate.publish", "migrate.cutover")


def read(win):
    if win.window_s <= 0 or not any(sp["name"] == "migrate.cutover"
                                    for sp in win.spans):
        return None
    spans = merge([(max(sp["t0"], win.t0), min(sp["t1"], win.t1))
                   for sp in win.spans
                   if sp["name"] in NAMES and sp["t1"] > win.t0 and sp["t0"] < win.t1])
    return 100.0 * sum(e - s for s, e in spans) / win.window_s
