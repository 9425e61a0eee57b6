"""Milliseconds of write-back and commit per batch flushed in the window:
the pipeline writer's ``batch.write_back`` spans (``service/pipeline.py``)
over the batches flushed."""


def read(win):
    batches = win.raw.get("batches", 0)
    if not batches or not win.spans:
        return None
    return 1e3 * win.span_seconds("batch.write_back") / batches
