"""The migration cell, ``backfill10m.migrate_fused``, at its tiny size on the
CPU: a broken rating step, export, snapshot or decode turns ``correct``
false; the CSV writer imports nothing of the program; the migration's
readers on a synthetic span list, and a traced run reporting each of them."""

import os

import pytest

from _tiny import ROOT, SECONDS, TINY, spec_for
from portbench import run
from test_portbench_faults import _patch_rating, _run
from test_portbench_imports import PKG, _top_imports

MIGRATION = "backfill10m.migrate_fused"


def reader(name):
    return run.load_module(os.path.join(ROOT, "portbench", "metrics", name + ".py"),
                           "t_" + name.replace(".", "_"))


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_rating_is_not_correct(monkeypatch, fault):
    _patch_rating(monkeypatch, fault)
    out = _run(MIGRATION)
    assert out["correct"] is False, out["checks"]


def test_export_imports_nothing_of_the_program():
    assert "analyzer_tpu_torch" not in set(_top_imports(os.path.join(PKG, "export.py")))


def _ratable_line(data: bytes, after: int) -> int:
    """The index of the first line past ``after`` that holds a ratable
    match of the export (a supported mode, no AFK)."""
    lines = data.split(b"\n")
    for k in range(after, len(lines)):
        f = lines[k].split(b",")
        if len(f) == 6 and f[1] != b"unsupported" and f[3] == b"0":
            return k
    raise AssertionError("no ratable row")


def _patch_migration(monkeypatch, fault):
    """Breaks the migration's export, its snapshots or its decode."""
    import numpy as np

    from analyzer_tpu_torch.io import _native_csv, checkpoint
    from portbench import export

    real_csv, real_write = export.stream_csv, checkpoint._write

    def edited(arrays, device, lo=0, hi=None, **kw):
        lines = real_csv(arrays, device, lo, hi, **kw).split(b"\n")
        k = _ratable_line(b"\n".join(lines), 3)  # not a spot-checked row
        if fault == "row_dropped":
            del lines[k]
        else:  # team0 and team1 swapped in one row
            f = lines[k].split(b",")
            lines[k] = b",".join(f[:4] + [f[5], f[4]])
        return b"\n".join(lines)

    def altered(path, arrays, *args, **kw):
        real_write(path, arrays, *args, **kw)
        with np.load(path) as z:
            saved = dict(z)
        saved["table"].view(np.uint32)[0, 0] ^= 1  # one bit of one rating
        with open(path, "wb") as f:
            np.savez(f, **saved)

    def watermark_altered(path, arrays, seed_cfg, cursor, step_cursor, *args):
        if step_cursor:  # a mid-run watermark, not the finished run's save
            table = arrays["table"].copy()
            rated = np.flatnonzero(np.isfinite(table))[0]  # NaN: not yet rated
            table.reshape(-1).view(np.uint32)[rated] ^= 1 << 22  # mantissa top bit
            arrays = dict(arrays, table=table)
        real_write(path, arrays, seed_cfg, cursor, step_cursor, *args)

    def no_scanner():
        raise ImportError("the native scanner is not built")

    if fault in ("row_dropped", "teams_swapped"):
        monkeypatch.setattr(export, "stream_csv", edited)
    elif fault == "checkpoint_altered":
        monkeypatch.setattr(checkpoint, "_write", altered)
    elif fault == "watermark_altered":
        monkeypatch.setattr(checkpoint, "_write", watermark_altered)
    elif fault == "intermediate_saves_skipped":
        monkeypatch.setattr(checkpoint.CheckpointWriter, "save",
                            lambda self, *a, **kw: None)
    else:
        monkeypatch.setattr(_native_csv, "load", no_scanner)


#: The check each fault has to fail, where one alone reads it.
CAUGHT_BY = {"watermark_altered": "resume_mismatches",
             "intermediate_saves_skipped": "snapshots_missing"}


@pytest.mark.parametrize("fault", ["row_dropped", "teams_swapped",
                                   "checkpoint_altered", "python_fallback",
                                   "watermark_altered", "intermediate_saves_skipped"])
def test_broken_migration_is_not_correct(monkeypatch, fault):
    _patch_migration(monkeypatch, fault)
    out = _run(MIGRATION)
    assert out["correct"] is False, out["checks"]
    if fault in CAUGHT_BY:
        check = out["checks"][CAUGHT_BY[fault]]
        assert check["value"] > check["limit"], out["checks"]


def _span(name, t0, t1, tid=1):
    return {"name": name, "t0": t0, "t1": t1, "tid": tid, "args": {}}


MIGRATION_SPANS = [
    _span("migrate.prepare", 0.5, 1.5),
    _span("ingest.decode", 1.0, 1.25, 3),
    _span("migrate.assign", 1.25, 1.75, 3),
    _span("ingest.decode", 1.75, 2.0, 3),
    _span("feed.wait_assign", 1.5, 2.5, 2),
    _span("feed.gather", 2.5, 3.0, 2),
    _span("feed.starved", 1.5, 3.5),
    _span("feed.starved", 3.0, 4.0),  # overlaps the first: counted once
    _span("batch.compute", 4.0, 5.0),
    _span("migrate.checkpoint", 5.0, 5.25),
    _span("view.publish", 5.25, 6.0),
    _span("checkpoint.write", 5.25, 7.0, 4),
    _span("migrate.checkpoint", 8.0, 8.75),
    _span("migrate.publish", 8.75, 9.0),
    _span("migrate.cutover", 9.0, 9.5),
    _span("migrate.checkpoint", 9.75, 10.5),  # past the window's end
]


def test_migration_readers_on_a_span_list():
    w = run.Window(1.0, 9.5, {"steps": 50}, [], MIGRATION_SPANS)
    assert reader("decode_ms_per_step.migrate").read(w) == pytest.approx(1e3 * 0.5 / 50)
    assert reader("assign_ms_per_step.migrate").read(w) == pytest.approx(1e3 * 0.5 / 50)
    assert reader("assign_wait_share.rerate").read(w) == pytest.approx(100 * 1.0 / 8.5)
    assert reader("starved_share.rerate").read(w) == pytest.approx(100 * 2.5 / 8.5)
    # the two snapshots inside the window, 0.25 and 0.75 s
    assert reader("checkpoint_ms_per_snapshot.migrate").read(w) == pytest.approx(500.0)
    # chunk-boundary publish, final publish and cutover
    assert reader("lineage_share.migrate").read(w) == pytest.approx(100 * 1.5 / 8.5)


def test_migration_readers_clip_to_the_window():
    # the spans that overlap the window, as trace.program_spans keeps them
    spans = [sp for sp in MIGRATION_SPANS if sp["t1"] > 1.125 and sp["t0"] < 1.875]
    w = run.Window(1.125, 1.875, {"steps": 10}, [], spans)
    assert reader("decode_ms_per_step.migrate").read(w) == pytest.approx(1e3 * 0.25 / 10)
    assert reader("assign_ms_per_step.migrate").read(w) == pytest.approx(1e3 * 0.5 / 10)
    assert reader("assign_wait_share.rerate").read(w) == pytest.approx(100 * 0.375 / 0.75)
    assert reader("checkpoint_ms_per_snapshot.migrate").read(w) is None
    assert reader("lineage_share.migrate").read(w) is None  # no cutover in it


def test_a_traced_migration_reports_every_program_span_metric():
    """The migration's window gives every span reader on its list, those it
    shares with the stream cell among them, something to read."""
    spec = spec_for(MIGRATION)
    out = run.run_cell(MIGRATION, 2**31 + 43, SECONDS, True, device="cpu",
                       overrides=TINY[MIGRATION], t_start=0.0, spec=spec)
    assert out["correct"], out["checks"]
    want = {m["name"] for m in run.metrics_for(spec, MIGRATION, "per_layer")
            if m["source"] == "program_span"}
    assert {"plan_ms_per_step.rerate", "starved_share.rerate",
            "assign_wait_share.rerate", "checkpoint_ms_per_snapshot.migrate"} <= want
    assert want <= set(out["metrics"])


def test_migration_readers_without_the_new_spans():
    """A program that emits none of the spans the migration's readers read
    (the parent of the change that added them) gets nothing from them, and
    the readers of older spans keep reading."""
    old = [sp for sp in MIGRATION_SPANS
           if sp["name"] not in ("migrate.checkpoint", "migrate.publish",
                                 "migrate.cutover", "migrate.prepare",
                                 "checkpoint.write")]
    w = run.Window(1.0, 9.5, {"steps": 50}, [], old)
    assert reader("checkpoint_ms_per_snapshot.migrate").read(w) is None
    assert reader("lineage_share.migrate").read(w) is None
    assert reader("starved_share.rerate").read(w) == pytest.approx(100 * 2.5 / 8.5)
    empty = run.Window(0.0, 1.0, {})
    for name in ("decode_ms_per_step.migrate", "assign_ms_per_step.migrate",
                 "checkpoint_ms_per_snapshot.migrate", "lineage_share.migrate"):
        assert reader(name).read(empty) is None, name
