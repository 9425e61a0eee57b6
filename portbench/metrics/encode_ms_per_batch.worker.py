"""Milliseconds of load and encode per batch flushed in the window: the
worker's ``batch.encode`` spans (``service/worker.py``; the store's
batch load runs inside them) over the batches flushed."""


def read(win):
    batches = win.raw.get("batches", 0)
    if not batches or not win.spans:
        return None
    return 1e3 * win.span_seconds("batch.encode") / batches
