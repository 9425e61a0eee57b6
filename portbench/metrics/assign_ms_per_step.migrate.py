"""Milliseconds of the incremental first-fit per superstep rated: the
front-half thread's ``migrate.assign`` spans (``migrate/engine.py``: one a
decode window, the native loop of ``migrate/assign.py`` and
``sched/csrc/packer.cc``) clipped to the window, over the supersteps of the
window's migrations. Nothing where the program emits no such span."""


def read(win):
    steps = win.raw.get("steps", 0)
    if not steps or not any(sp["name"] == "migrate.assign" for sp in win.spans):
        return None
    return 1e3 * win.span_seconds("migrate.assign") / steps
