"""Milliseconds of the native CSV decode per superstep rated: the
``ingest.decode`` spans (``io/ingest.ColumnarDecoder.windows``: one a
4096-row window, on the migration's front-half thread and, for the
planning prefix, its caller's) clipped to the window, over the supersteps
of the window's migrations. Nothing where the program emits no such
span."""


def read(win):
    steps = win.raw.get("steps", 0)
    if not steps or not any(sp["name"] == "ingest.decode" for sp in win.spans):
        return None
    return 1e3 * win.span_seconds("ingest.decode") / steps
