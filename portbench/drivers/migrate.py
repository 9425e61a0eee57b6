"""Traffic driver ``migrate``: the zero-downtime global re-rate as ``cli
migrate`` runs it, ``run_migration`` over the CSV export of the history.

Configuration keys: the history's (``players``, ``matches``,
``activity_concentration``, ``max_activity_share``, ``afk_rate``,
``unsupported_rate``, ``structure_seed``: ``gen.make_stream``) and the
operator's command: ``kernel`` (``--kernel``), ``checkpoint_every``
(``--checkpoint-every``), and ``window_rows``, ``plan_windows`` and
``batch_size`` (null: the engine's defaults, as without those flags).

Traffic keys: ``warmup_matches`` (one migration of the export of the
history's last matches, on a throwaway table and live lineage, before the
window).

Set-up makes the history on the device from the seed and writes it once
as the CSV export (``portbench/export.py``), whose bytes stay in host
memory as ``cli migrate`` reads its file; every player starts from the
unknown-player seed. A live ``ViewPublisher`` is primed with that
pre-migration table as ``--from-checkpoint`` primes it (saved, loaded
back, published), under one ``LineageManager``. The checkpoint is one file
under the run's own ``TMPDIR``.

One unit of the window is one whole migration of the export from a fresh
unknown-seeded table: decode, assignment, staging and dispatch, the
snapshots every ``checkpoint_every`` supersteps, the staging publishes,
the final save and the cutover. The window closes at the first whole
migration past ``--seconds``; ``rerate_matches_per_s`` is the matches
migrated over the window, from bytes in memory to the cut-over table. The
traffic is closed-loop: a backfill has no arrival rate. After each
migration this traffic driver drains the program's span ring (bounded, and a
10M-match migration emits a few thousand spans) into its own list, which
the traced run's readers read.

``correct``: the limits in :data:`LIMITS`, each beside its reason. Two
of them read what the window does not: the snapshots each migration took
against its cadence, and, after the window, one migration stopped at a
watermark and resumed from that snapshot.
"""

from __future__ import annotations

import csv
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import export, gen, plain

#: Limits of the comparison (readings in PERF.md).
LIMITS = {
    # The first migration's table against the plain reference rating the
    # generator's arrays (not the program's decode of the export) from the
    # same start: no rating may be NULL on one side only.
    "null_mismatches": 0,
    # ... and the largest relative gap of a rating. The reference repeats
    # the stated float32 arithmetic op for op (the stream cell reads 0.0);
    # 1e-4 leaves room for a reordered sum, and the reference in bfloat16
    # misses it by decades.
    "max_rel_err": 1e-4,
    # Every migration re-rates the same bytes from the same start, and the
    # schedule is a pure function of the bytes: each later migration's table
    # equals the first's bit for bit, so one reference replay checks them
    # all, however many migrations the window holds.
    "tables_differ": 0,
    # Isolation and atomic cutover: after each migration the live lineage
    # advanced exactly once (no staging publish reached it) and serves the
    # migrated table bit for bit.
    "live_mismatches": 0,
    # Durability: the last snapshot on disk, loaded back, is the final
    # table bit for bit, with the finished run's cursors.
    "checkpoint_mismatches": 0,
    # Durability, the cadence: each migration took one snapshot at every
    # chunk boundary at least ``checkpoint_every`` supersteps past the last
    # one, and the final save; a snapshot fewer leaves a killed run more
    # work to redo than the operator asked for, one more is not this
    # command either. Read from the program's ``checkpoint.snapshots_total``
    # and the run's ``steps_per_chunk``.
    "snapshots_missing": 0,
    # Durability, the resume: after the window, a migration stopped at its
    # middle watermark (as a kill leaves it) and resumed from that snapshot
    # with ``resume=True`` ends on the first migration's table bit for bit,
    # and the snapshot's step cursor is that watermark.
    "resume_mismatches": 0,
    # A migration that fell back to the python codec (quoted grammar, or no
    # native scanner) is not this deployment: its schedule cannot resume.
    "fallbacks": 0,
    # The export itself: every 1000th row, parsed by Python's csv module,
    # equals the arrays, and the export has one line a match after its
    # header.
    "csv_mismatches": 0,
}

#: Rows between two rows of the export's spot check.
SPOT_EVERY = 1000

#: Registry counters the window reads when it closes.
COUNTERS = ("migrate.fallbacks_total", "ingest.fallbacks_total",
            "checkpoint.snapshots_total", "checkpoint.superseded_total",
            "checkpoint.bytes_written_total")


class _Drained:
    """The program's spans of the window: those drained from the tracer's
    ring after each migration, then what the ring still holds."""

    def __init__(self, tracer, drained: list) -> None:
        self.epoch_perf = tracer.epoch_perf
        self._events = drained + tracer.events()

    def events(self) -> list:
        return self._events


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def watermarks(n_steps: int, steps_per_chunk: int, every: int) -> list[int]:
    """The step cursors of a migration's cadence snapshots: the chunk
    boundaries (multiples of ``steps_per_chunk``, then ``n_steps``) at
    which ``every`` or more supersteps have passed since the last one."""
    marks, last = [], 0
    for step in [*range(steps_per_chunk, n_steps, steps_per_chunk), n_steps]:
        if step - last >= every:
            marks.append(step)
            last = step
    return marks


class Cell:
    def __init__(self, config, traffic, seed, device, log):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.log = seed, device, log
        self.setup_split = {}
        self.migrations = []
        self.tmp = None
        self._drained = []
        self._dropped = 0

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        c, dev = self.config, self.device
        t = time.perf_counter()
        players = gen.make_players(c["players"], self.seed, dev)
        s = gen.make_stream(
            c["matches"], players["latent"], self.seed,
            c["activity_concentration"], c["max_activity_share"],
            c["afk_rate"], c["unsupported_rate"], c["structure_seed"],
        )
        del players
        self.arrays = s
        self.setup_split["generate_s"] = time.perf_counter() - t

        t = time.perf_counter()
        n, w = c["matches"], self.traffic["warmup_matches"]
        self.data = export.stream_csv(s, dev)
        warm_data = export.stream_csv(s, dev, lo=max(0, n - w))
        self.setup_split["export_s"] = time.perf_counter() - t

        t = time.perf_counter()
        from analyzer_tpu_torch.config import RatingConfig
        from analyzer_tpu_torch.core.state import PlayerState
        from analyzer_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
        from analyzer_tpu_torch.migrate import LineageManager, run_migration
        from analyzer_tpu_torch.obs import (
            get_registry,
            get_tracer,
            reset_registry,
            reset_tracer,
        )
        from analyzer_tpu_torch.obs.registry import STANDARD_COUNTERS
        from analyzer_tpu_torch.serve import ViewPublisher

        self._get_tracer, self._reset_tracer = get_tracer, reset_tracer
        self._get_registry, self._reset_registry = get_registry, reset_registry
        # A program older than the snapshot counter cannot show its cadence.
        self.counts_snapshots = "checkpoint.snapshots_total" in STANDARD_COUNTERS
        self._state_create = PlayerState.create
        self._load_checkpoint = load_checkpoint
        self._publisher = ViewPublisher
        self.run_migration = run_migration
        self.cfg = RatingConfig()
        self.state0 = PlayerState.create(c["players"], cfg=self.cfg, device=dev)
        self.engine_kw = {"kernel": c["kernel"]}
        for key in ("window_rows", "plan_windows", "batch_size"):
            if c.get(key) is not None:
                self.engine_kw[key] = c[key]
        self.tmp = tempfile.mkdtemp(prefix="portbench_migrate_")
        self.ckpt = os.path.join(self.tmp, "mig.npz")
        self.prior = os.path.join(self.tmp, "prior.npz")
        save_checkpoint(self.prior, self.state0)
        self.live = self._primed_live()
        self.lineage = LineageManager(self.live)
        self.setup_split["state_s"] = time.perf_counter() - t

        t = time.perf_counter()
        warm = self._migrate(warm_data, LineageManager(self._primed_live()),
                             os.path.join(self.tmp, "warm.npz"))
        stats = warm.stats
        del warm, warm_data
        self._sync()
        self.setup_split["warmup_s"] = time.perf_counter() - t
        self.log(f"[choice] kernel={c['kernel']} B={stats['batch_size']} "
                 f"steps={stats['n_steps']} occupancy={stats['occupancy']:.4f} "
                 f"windows={stats.get('windows')} spills={stats.get('spills')} "
                 f"streamed={stats.get('streamed')} "
                 f"assign_native={stats.get('assign_native')} "
                 f"checkpoint_every={c['checkpoint_every']} export={len(self.data)} "
                 f"bytes (warm-up migration over {min(n, w)} matches)")

    def _primed_live(self):
        """A live lineage serving the pre-migration table, primed as ``cli
        migrate --from-checkpoint`` primes it."""
        live = self._publisher(device=self.device)
        live.publish_state(self._load_checkpoint(self.prior, device=self.device).state)
        return live

    def _migrate(self, data: bytes, lineage, path: str, **kw):
        return self.run_migration(
            self.state0, data, self.cfg, lineage=lineage, checkpoint=path,
            checkpoint_every=self.config["checkpoint_every"],
            device=self.device, **self.engine_kw, **kw,
        )

    def _snapshots(self) -> float:
        return self._get_registry().counter("checkpoint.snapshots_total").value

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_obs(self) -> None:
        self._reset_tracer()
        self._reset_registry()
        self._drained, self._dropped = [], 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def _drain(self) -> None:
        """Moves the tracer's events into this cell's list (between two
        migrations, when no thread of the program is emitting)."""
        tracer = self._get_tracer()
        self._drained.extend(tracer.events())
        self._dropped += tracer.dropped
        tracer.clear()

    def tracer(self):
        return _Drained(self._get_tracer(), self._drained)

    # -- the window -------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        walls = []
        self._sync()
        t0 = time.perf_counter()
        while True:
            tm = time.perf_counter()
            v0, k0 = self.live.version, self._snapshots()
            rep = self._migrate(self.data, self.lineage, self.ckpt)
            self._sync()
            walls.append(round(time.perf_counter() - tm, 3))
            self.migrations.append({
                "table": rep.state.table, "view": rep.view,
                "current": self.live.current(), "v0": v0, "v1": self.live.version,
                "stats": rep.stats, "pause_ms": rep.cutover_pause_ms,
                "snapshots": self._snapshots() - k0,
            })
            del rep
            self._drain()
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        reg = self._get_registry()
        self.counters = {name: reg.counter(name).value for name in COUNTERS}
        a = self.arrays
        ok = (a["mode_id"] >= 0) & ~a["afk"]
        slots = int((a["player_idx"][ok] >= 0).sum())
        stats = [m["stats"] for m in self.migrations]
        matches = sum(st["matches"] for st in stats)
        steps = sum(st["n_steps"] for st in stats)
        epoch = self._get_tracer().epoch_perf
        span_s: dict = {}
        for ev in self._drained:
            if ev.get("ph") == "X" and t0 <= epoch + ev["ts"] * 1e-6 <= t1:
                span_s[ev["name"]] = span_s.get(ev["name"], 0.0) + ev["dur"] * 1e-6
        write_s = span_s.get("checkpoint.write", 0.0)
        self.log(f"[window] {len(walls)} migrations, {matches} matches, {steps} "
                 f"supersteps in {t1 - t0:.3f} s; walls {walls}; ttfd "
                 f"{[round(st['ttfd_s'], 3) for st in stats if st.get('ttfd_s')]}; "
                 f"cutover pause ms {[m['pause_ms'] for m in self.migrations]}; "
                 f"counters {self.counters}; span seconds "
                 f"{ {k: round(v, 3) for k, v in sorted(span_s.items())} }; "
                 f"spans drained {len(self._drained)}, dropped {self._dropped}")
        return {
            "t0": t0, "t1": t1, "attempted": matches, "failed": 0,
            "metrics": {"rerate_matches_per_s": matches / (t1 - t0)},
            "raw": {"matches": matches, "steps": steps,
                    "rated_slots": slots * len(stats),
                    "snapshots": self.counters["checkpoint.snapshots_total"],
                    "checkpoint_write_s": write_s},
        }

    # -- the check ------------------------------------------------------------
    def reference_table(self, dtype=torch.float32) -> np.ndarray:
        """The plain reference over the generator's arrays, on the device."""
        a = self.arrays
        start = plain.initial_table(self.config["players"])
        return plain.rate_history(start, a["player_idx"], a["winner"],
                                  a["mode_id"], a["afk"], self.device,
                                  dtype=dtype)

    def _spot_check(self) -> int:
        """Rows of the export that disagree with the arrays: every
        :data:`SPOT_EVERY`-th row parsed by Python's csv module, the header,
        and the difference between its line count and one a match."""
        a, data = self.arrays, self.data
        n = a["winner"].shape[0]
        ends = np.flatnonzero(np.frombuffer(data, np.uint8) == ord("\n"))
        bad = abs(ends.size - (n + 1))
        bad += ends.size == 0 or data[:ends[0] + 1] != export.HEADER
        modes = {name: i for i, name in enumerate(export.MODE_NAMES)}
        for i in range(0, min(n, ends.size - 1), SPOT_EVERY):
            row = next(csv.reader([data[ends[i] + 1:ends[i + 1]].decode()]))
            want_teams = [a["player_idx"][i, t][a["player_idx"][i, t] >= 0].tolist()
                          for t in (0, 1)]
            try:
                got = (int(row[0]), modes.get(row[1], -1), int(row[2]),
                       int(row[3]),
                       [[int(x) for x in team.split(";") if x] for team in row[4:6]])
            except (IndexError, ValueError):
                bad += 1
                continue
            want = (i, int(a["mode_id"][i]), int(a["winner"][i]),
                    int(a["afk"][i]), want_teams)
            bad += got != want or len(row) != 6
        return int(bad)

    def _cadence_misses(self, migs) -> int:
        """Snapshots each migration took, against one at each of its
        :func:`watermarks` and the final save (summed differences)."""
        if not self.counts_snapshots:
            self.log("[check] the program counts no snapshots: cadence not read")
            return 0
        every, misses = self.config["checkpoint_every"], 0
        for m in migs:
            st = m["stats"]
            if not st.get("steps_per_chunk"):
                misses += 1
                continue
            want = len(watermarks(st["n_steps"], st["steps_per_chunk"], every)) + 1
            misses += abs(m["snapshots"] - want)
        return int(misses)

    def _resume_misses(self, stats: dict, table: np.ndarray) -> int:
        """Stops a fresh migration at the first one's middle cadence
        watermark (``stop_after``: the snapshot a run killed there leaves),
        resumes it from that snapshot with ``resume=True``, and counts the
        resumed table's entries that differ from ``table``, plus one for a
        snapshot cursor off the watermark; a resume that raises counts every
        entry. A program that does not report its ``steps_per_chunk`` is
        stopped at its middle superstep, and its snapshot has to lie at the
        chunk boundary at or past it."""
        n_steps, spc = stats["n_steps"], stats.get("steps_per_chunk")
        marks = [w for w in watermarks(n_steps, spc, self.config["checkpoint_every"])
                 if w < n_steps] if spc else []
        stop = marks[len(marks) // 2] if marks else max(1, n_steps // 2)
        path = os.path.join(self.tmp, "killed.npz")
        self.state0 = self._state_create(self.config["players"], cfg=self.cfg,
                                         device=self.device)
        try:
            part = self._migrate(self.data, None, path, stop_after=stop)
            if part.finished:
                raise RuntimeError(f"the run stopped at {stop} finished")
            del part
            step = self._load_checkpoint(path, device="cpu").step_cursor
            rep = self._migrate(self.data, None, path, resume=True)
            got = rep.state.table.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — a resume that fails is counted
            self.log(f"[check] resume from the watermark at step {stop} failed: {e!r}")
            return int(table.size)
        finally:
            self.state0 = None
        misses = (int((got.view(np.uint32) != table.view(np.uint32)).sum())
                  if got.shape == table.shape else int(table.size))
        at_mark = step == stop if marks else stop <= step < n_steps
        misses += not at_mark
        self.log(f"[check] stopped at step {stop} of {n_steps}, snapshot at {step}, "
                 f"resumed: {misses} entries differ")
        return int(misses)

    def check(self) -> list[dict]:
        self.state0 = None
        n_players = self.config["players"]
        migs = self.migrations
        first, last = migs[0], migs[-1]
        t = time.perf_counter()
        tables_differ = sum(not _same_bits(m["table"], first["table"])
                            for m in migs[1:])
        live_mismatches = sum(
            m["view"] is None or m["current"] is not m["view"]
            or m["v1"] != m["v0"] + 1
            or not _same_bits(m["view"].table[:n_players], m["table"][:n_players])
            for m in migs)
        final = last["table"].cpu().numpy()
        ck = self._load_checkpoint(self.ckpt, device="cpu")
        saved = ck.state.table.numpy()
        checkpoint_mismatches = (
            int((saved.view(np.uint32) != final.view(np.uint32)).sum())
            if saved.shape == final.shape else saved.size)
        checkpoint_mismatches += (ck.step_cursor != 0) + (ck.cursor != last["stats"]["matches"])
        fallbacks = (self.counters["migrate.fallbacks_total"]
                     + self.counters["ingest.fallbacks_total"]
                     + sum(not m["stats"].get("streamed") for m in migs))
        csv_mismatches = self._spot_check()
        snapshots_missing = self._cadence_misses(migs)
        first_table, first_stats = first["table"].cpu().numpy(), first["stats"]
        self.migrations = []
        del first, last, migs
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t_bits = time.perf_counter() - t
        t = time.perf_counter()
        resume_mismatches = self._resume_misses(first_stats, first_table)
        t_resume = time.perf_counter() - t
        t = time.perf_counter()
        self.ref = self.reference_table()
        got = plain.compare_tables(first_table[:-1], self.ref[:-1])
        self.log(f"[check] bit comparisons, checkpoint load and spot check in "
                 f"{t_bits:.3f} s; stop and resume in {t_resume:.3f} s; reference "
                 f"over {self.arrays['winner'].shape[0]} matches in "
                 f"{time.perf_counter() - t:.3f} s; {got['entries']} ratings compared")
        got.update(tables_differ=int(tables_differ),
                   live_mismatches=int(live_mismatches),
                   checkpoint_mismatches=int(checkpoint_mismatches),
                   snapshots_missing=snapshots_missing,
                   resume_mismatches=resume_mismatches,
                   fallbacks=int(fallbacks), csv_mismatches=csv_mismatches)
        return [{"name": k, "value": got[k], "limit": LIMITS[k],
                 "ok": got[k] <= LIMITS[k]} for k in LIMITS]

    def control(self) -> dict:
        """The control's readings: the reference in bfloat16 put in the
        program's place (after :meth:`check`)."""
        return plain.compare_tables(
            self.reference_table(torch.bfloat16)[:-1], self.ref[:-1])

    def close(self) -> None:
        self.state0 = None
        self.migrations = []
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None
