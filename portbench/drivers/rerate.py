"""Traffic driver ``rerate``: the full-history re-rate as ``cli rate``
runs it, ``rate_stream`` over the match history.

Traffic keys: ``kernel`` (``rate_stream``'s ``kernel``), ``segment_matches``
(the matches of one ``rate_stream`` call: the window rates the history in
stream order, a segment a call, each call starting from the table the last
one left, until ``--seconds`` have passed; past the history's end it starts
again at its beginning), ``warmup_matches`` (one call over the history's
last matches, on a throwaway copy of the table, before the window).

Configuration keys: ``players``, ``matches``, ``activity_concentration``,
``max_activity_share``, ``afk_rate``, ``unsupported_rate``,
``structure_seed`` (the history's shape, the same for every seed:
``gen.make_stream``); every player
starts from the unknown-player seed, as ``cli rate`` starts a stream file.

``correct``: the table after the window's matches against the plain
reference (``portbench/plain.py``) rating the same matches in the same
order from the same start: no rating differs in being NULL, and the
largest relative gap of a rating is under its limit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import gen, plain

#: Limits of the comparison (readings in PERF.md).
LIMITS = {"null_mismatches": 0, "max_rel_err": 1e-4}


class Cell:
    def __init__(self, config, traffic, seed, device, log):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.log = seed, device, log
        self.setup_split = {}
        self.final_table = None
        self.ranges = []

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
        from analyzer_tpu_torch.config import RatingConfig
        from analyzer_tpu_torch.core.state import PlayerState
        from analyzer_tpu_torch.obs import get_tracer, reset_registry, reset_tracer
        from analyzer_tpu_torch.sched import rate_stream
        from analyzer_tpu_torch.sched.superstep import MatchStream

        self._get_tracer, self._reset_tracer = get_tracer, reset_tracer
        self._reset_registry = reset_registry
        self.rate_stream = rate_stream
        self.stream = MatchStream(player_idx=s["player_idx"], winner=s["winner"],
                                  mode_id=s["mode_id"], afk=s["afk"])
        self.cfg = RatingConfig()
        self.state0 = PlayerState.create(c["players"], cfg=self.cfg, device=dev)
        self.setup_split["state_s"] = time.perf_counter() - t

        t = time.perf_counter()
        n, w = self.stream.n_matches, self.traffic["warmup_matches"]
        stats: dict = {}
        warm, _ = self.rate_stream(
            self.state0, self.stream.slice(max(0, n - w), n), self.cfg,
            kernel=self.traffic["kernel"], stats_out=stats,
        )
        del warm
        self._sync()
        self.setup_split["warmup_s"] = time.perf_counter() - t
        spc = min(8192, max(256, -(-stats["n_steps"] // 8)))
        self.log(f"[choice] kernel={self.traffic['kernel']} B={stats['batch_size']} "
                 f"steps={stats['n_steps']} steps_per_chunk~{spc} "
                 f"occupancy={stats['occupancy']:.4f} "
                 f"windows={stats.get('windows')} spills={stats.get('spills')} "
                 f"(warm-up call over {min(n, w)} matches)")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_obs(self) -> None:
        self._reset_tracer()
        self._reset_registry()

    def tracer(self):
        return self._get_tracer()

    # -- the window -------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        n, seg = self.stream.n_matches, self.traffic["segment_matches"]
        state, pos, steps, rated = self.state0, 0, 0, 0
        stats: dict = {}
        calls = []
        self._sync()
        t0 = time.perf_counter()
        while True:
            tc = time.perf_counter()
            hi = min(n, pos + seg)
            state, _ = self.rate_stream(
                state, self.stream.slice(pos, hi), self.cfg,
                kernel=self.traffic["kernel"], stats_out=stats,
            )
            self._sync()
            calls.append(round(time.perf_counter() - tc, 3))
            self.ranges.append((pos, hi))
            steps += stats["n_steps"]
            rated += hi - pos
            pos = 0 if hi >= n else hi
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        self.final_table = state.table.cpu().numpy()
        del state
        slots = 0
        for lo, hi in self.ranges:
            ok = (self.arrays["mode_id"][lo:hi] >= 0) & ~self.arrays["afk"][lo:hi]
            slots += int((self.arrays["player_idx"][lo:hi][ok] >= 0).sum())
        self.log(f"[window] {len(self.ranges)} rate_stream calls, {rated} matches, "
                 f"{steps} supersteps in {t1 - t0:.3f} s; calls {calls}")
        return {
            "t0": t0, "t1": t1, "attempted": rated, "failed": 0,
            "metrics": {"rerate_matches_per_s": rated / (t1 - t0)},
            "raw": {"matches": rated, "steps": steps, "rated_slots": slots,
                    "calls": len(self.ranges)},
        }

    # -- the check ------------------------------------------------------------
    def reference_table(self, dtype=torch.float32) -> np.ndarray:
        """The plain reference over the window's matches, on the device."""
        a = self.arrays
        cat = {k: np.concatenate([a[k][lo:hi] for lo, hi in self.ranges])
               for k in ("player_idx", "winner", "mode_id", "afk")}
        start = plain.initial_table(self.config["players"])
        return plain.rate_history(start, cat["player_idx"], cat["winner"],
                                  cat["mode_id"], cat["afk"], self.device,
                                  dtype=dtype)

    def check(self) -> list[dict]:
        self.state0 = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        self.ref = self.reference_table()
        got = plain.compare_tables(self.final_table[:-1], self.ref[:-1])
        self.log(f"[check] reference over {sum(h - l for l, h in self.ranges)} "
                 f"matches in {time.perf_counter() - t:.3f} s; "
                 f"{got['entries']} ratings compared")
        return [{"name": k, "value": got[k], "limit": LIMITS[k],
                 "ok": got[k] <= LIMITS[k]} for k in LIMITS]

    def control(self) -> dict:
        """The control's readings: the reference in bfloat16 put in the
        program's place (after :meth:`check`)."""
        return plain.compare_tables(
            self.reference_table(torch.bfloat16)[:-1], self.ref[:-1])

    def close(self) -> None:
        self.state0 = None
