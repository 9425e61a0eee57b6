"""Milliseconds the consumer spends on a checkpoint snapshot: the
``migrate.checkpoint`` spans (``migrate/engine.run_migration``: the host
copy each ``CheckpointWriter.save`` queues every ``checkpoint_every``
supersteps, and the finished run's synchronous save before the cutover)
inside the window, over their number, one a snapshot taken. The writer
thread's serialize and rename (``checkpoint.write``) is not the
consumer's; its seconds are under the window's ``raw``. Nothing where the
program emits no such span."""


def read(win):
    snaps = [sp for sp in win.spans if sp["name"] == "migrate.checkpoint"
             and sp["t0"] >= win.t0 and sp["t1"] <= win.t1]
    if not snaps:
        return None
    return 1e3 * sum(sp["t1"] - sp["t0"] for sp in snaps) / len(snaps)
