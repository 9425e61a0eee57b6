"""The metric arithmetic: rates over the whole window, span sums clipped
to the window, device busy time as a union, the roofline's bytes."""

import os

import pytest

from _tiny import ROOT
from portbench import roofline, run, trace


def reader(name):
    return run.load_module(os.path.join(ROOT, "portbench", "metrics", name + ".py"),
                           "t_" + name.replace(".", "_"))


def window(**raw):
    ops = [("k1", 1.0, 1.5), ("k2", 1.25, 2.0), ("k1", 3.0, 3.5), ("early", 0.0, 0.5)]
    spans = [
        {"name": "batch.compute", "t0": 0.5, "t1": 2.0, "tid": 1, "args": {}},
        {"name": "feed.transfer", "t0": 2.0, "t1": 2.6, "tid": 1, "args": {}},
        {"name": "feed.materialize", "t0": 2.6, "t1": 6.0, "tid": 2, "args": {}},
    ]
    return run.Window(1.0, 5.0, raw, ops, spans)


def test_busy_is_a_union_clipped_to_the_window():
    w = window()
    assert w.busy_s == pytest.approx(1.0 + 0.5)
    assert reader("device_idle_share.rerate").read(w) == pytest.approx(100 * 2.5 / 4)


def test_span_sums_are_clipped():
    w = window(steps=10)
    assert w.span_seconds("batch.compute", "feed.transfer") == pytest.approx(1.6)
    assert reader("feed_wait_share.rerate").read(w) == pytest.approx(100 * 2.4 / 4)
    assert reader("dispatch_ms_per_step.rerate").read(w) == pytest.approx(160.0)


def test_feed_wait_is_staging_while_the_consumer_is_idle():
    spans = [
        {"name": "batch.compute", "t0": 1.0, "t1": 2.0, "tid": 1, "args": {}},
        {"name": "feed.transfer", "t0": 3.0, "t1": 3.5, "tid": 1, "args": {}},
        # staging under the consumer's compute does not count; the two
        # overlapping producer spans count once
        {"name": "feed.materialize", "t0": 1.5, "t1": 2.5, "tid": 2, "args": {}},
        {"name": "feed.materialize", "t0": 2.25, "t1": 3.25, "tid": 3, "args": {}},
    ]
    w = run.Window(0.0, 4.0, {}, [], spans)
    # staging 1.5-3.25 less compute to 2.0 and transfer from 3.0
    assert reader("feed_wait_share.rerate").read(w) == pytest.approx(100 * 1.0 / 4)
    # consumer idle (0-1, 2-3, 3.5-4) with nothing staged: no wait
    w = run.Window(0.0, 4.0, {}, [], spans[:2])
    assert reader("feed_wait_share.rerate").read(w) == 0.0


def test_roofline_counts_each_byte_once():
    assert roofline.SLOT_BYTES == 2 * 64 + 4 + 1
    nbytes = roofline.rating_step_bytes(rated_slots=600, matches=100)
    assert nbytes == 600 * 133 + 100 * 12
    w = window(rated_slots=600, matches=100)
    share = reader("rating_step_roofline.rerate").read(w)
    assert share == pytest.approx(100 * nbytes / roofline.HBM_BYTES_PER_S / 1.5)


def test_readers_return_nothing_without_data():
    empty = run.Window(0.0, 1.0, {})
    for name in ("device_idle_share.rerate", "feed_wait_share.rerate",
                 "dispatch_ms_per_step.rerate", "rating_step_roofline.rerate",
                 "encode_ms_per_batch.worker", "commit_ms_per_batch.worker"):
        assert reader(name).read(empty) is None


def test_idle_gaps_named_by_open_spans():
    w = window()
    gaps = dict(trace.idle_gaps(w.ops, w.spans, w.t0, w.t1))
    assert gaps == pytest.approx({"feed.transfer": 1.0, "feed.materialize": 1.5})
    assert sum(gaps.values()) == pytest.approx(w.window_s - w.busy_s)
    top = trace.device_op_totals(w.ops, w.t0, w.t1)
    assert top[0][0] == "k1" and top[0][1] == pytest.approx(1.0)
