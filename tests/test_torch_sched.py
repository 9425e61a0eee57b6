"""The port's host-side pipeline against the JAX package, byte for byte:
synthetic streams, ``pack_schedule`` (eager and windowed) and its
``fingerprint``, the assigners and batch sizing, and residency plans; the
native packer and the native residency planner against the python loops.
Then the port's own staging spans
(``sched/feed.py``): one ``feed.gather`` / ``feed.plan`` / ``feed.pack``
nested in each chunk's ``feed.materialize``, and at most one span a chunk
for each of the feed's three waits."""

import threading

import numpy as np
import pytest

import analyzer_tpu.sched as jsched
from analyzer_tpu.io import synthetic as jsynth
from analyzer_tpu.sched import residency as jres
from analyzer_tpu_torch.io import synthetic
from analyzer_tpu_torch.sched import _native, residency, superstep

STREAM_CASES = [
    dict(n_matches=300, n_players=60, seed=11),
    dict(n_matches=2000, n_players=400, seed=5, activity_concentration=0.8,
         max_activity_share=1e-2),
    dict(n_matches=500, n_players=90, seed=7, afk_rate=0.3, unsupported_rate=0.2),
    dict(n_matches=400, n_players=80, seed=2, synergy_strength=0.5),
]


def _streams(case):
    kw = dict(case)
    n, p, seed = kw.pop("n_matches"), kw.pop("n_players"), kw.pop("seed")
    tp = synthetic.synthetic_players(p, seed=seed)
    jp = jsynth.synthetic_players(p, seed=seed)
    return (tp, synthetic.synthetic_stream(n, tp, seed=seed, **kw),
            jp, jsynth.synthetic_stream(n, jp, seed=seed, **kw))


@pytest.mark.parametrize("case", STREAM_CASES, ids=lambda c: f"seed{c['seed']}")
def test_synthetic_byte_equal(case):
    tp, ts, jp, js = _streams(case)
    for f in ("latent_skill", "rank_points_ranked", "rank_points_blitz",
              "skill_tier", "archetype"):
        a, b = getattr(tp, f), getattr(jp, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for f in ("player_idx", "winner", "mode_id", "afk"):
        a, b = getattr(ts, f), getattr(js, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


SCHED_FIELDS = ("match_idx", "winner", "mode_id", "afk")


@pytest.mark.parametrize("case", STREAM_CASES, ids=lambda c: f"seed{c['seed']}")
@pytest.mark.parametrize("batch_size", [None, 8])
def test_pack_schedule_byte_equal(case, batch_size):
    tp, ts, _jp, js = _streams(case)
    pad = tp.n_players
    for windowed in (False, True):
        a = superstep.pack_schedule(ts, pad_row=pad, batch_size=batch_size,
                                    windowed=windowed)
        b = jsched.pack_schedule(js, pad_row=pad, batch_size=batch_size,
                                 windowed=windowed)
        assert type(a).__name__ == type(b).__name__
        for f in SCHED_FIELDS:
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
        assert a.fingerprint == b.fingerprint
        assert (a.n_steps, a.batch_size, a.occupancy) == (b.n_steps, b.batch_size, b.occupancy)
        if not windowed:
            assert a.player_idx.tobytes() == b.player_idx.tobytes()
            assert a.slot_mask.tobytes() == b.slot_mask.tobytes()
        w0, w1 = 1, min(5, a.n_steps)
        for x, y in zip(a.host_window(w0, w1), b.host_window(w0, w1)):
            assert x.tobytes() == y.tobytes()


def test_hand_built_schedule_fingerprint_and_invariant():
    tp, ts, _jp, js = _streams(STREAM_CASES[0])
    a = superstep.pack_schedule(ts, pad_row=60, batch_size=8)
    b = jsched.pack_schedule(js, pad_row=60, batch_size=8)
    ha = superstep.PackedSchedule(a.player_idx, a.slot_mask, a.winner, a.mode_id,
                                  a.afk, a.match_idx, a.pad_row)
    hb = jsched.PackedSchedule(b.player_idx, b.slot_mask, b.winner, b.mode_id,
                               b.afk, b.match_idx, b.pad_row)
    assert ha.fingerprint == hb.fingerprint != a.fingerprint
    ha.check_compact_invariant()
    ha.slot_mask = ha.slot_mask.copy()
    ha.slot_mask[0, 0, 0, 0] = ~ha.slot_mask[0, 0, 0, 0]
    with pytest.raises(ValueError, match="compact-feed"):
        ha.check_compact_invariant()


def test_team_size_padding_byte_equal():
    # a 3-wide stream packed at team size 5
    _tp, ts, _jp, js = _streams(STREAM_CASES[0])
    ts3 = superstep.MatchStream(ts.player_idx[:, :, :3], ts.winner, ts.mode_id, ts.afk)
    js3 = jsched.MatchStream(js.player_idx[:, :, :3], js.winner, js.mode_id, js.afk)
    a = superstep.pack_schedule(ts3, pad_row=60, batch_size=8)
    b = jsched.pack_schedule(js3, pad_row=60, batch_size=8)
    assert a.player_idx.tobytes() == b.player_idx.tobytes()
    assert a.fingerprint == b.fingerprint


@pytest.mark.parametrize("case", STREAM_CASES, ids=lambda c: f"seed{c['seed']}")
def test_assigners_and_batch_size_equal(case):
    _tp, ts, _jp, js = _streams(case)
    np.testing.assert_array_equal(
        superstep.assign_supersteps(ts), jsched.assign_supersteps(js)
    )
    for cap in (1, 8, 64):
        for x, y in zip(superstep.assign_batches(ts, cap),
                        jsched.assign_batches(js, cap)):
            np.testing.assert_array_equal(x, y)
    assert superstep.choose_batch_size(ts) == jsched.choose_batch_size(js)
    assert (superstep.choose_batch_size_streamed(ts, prefix=97)
            == jsched.choose_batch_size_streamed(js, prefix=97))


@pytest.mark.parametrize("case", STREAM_CASES, ids=lambda c: f"seed{c['seed']}")
def test_native_equals_python(case):
    _tp, ts, _jp, _js = _streams(case)
    lib = _native.load()
    assert lib is not None, "g++ is expected on this machine"
    np.testing.assert_array_equal(
        _native.assign_supersteps(lib, ts), superstep._assign_supersteps_py(ts)
    )
    for cap in (1, 8, 64):
        for x, y in zip(_native.assign_batches_first_fit(lib, ts, cap),
                        superstep._assign_batches_first_fit_py(ts, cap)):
            np.testing.assert_array_equal(x, y)


def test_python_fallback_is_counted(monkeypatch):
    _tp, ts, _jp, _js = _streams(STREAM_CASES[0])
    want = superstep.pack_schedule(ts, pad_row=60, batch_size=8)
    before = superstep.python_fallbacks
    monkeypatch.setattr(_native, "load", lambda: None)
    got = superstep.pack_schedule(ts, pad_row=60)
    assert superstep.python_fallbacks == before + 2  # sizing + first-fit
    assert got.batch_size == superstep.choose_batch_size(ts)
    got8 = superstep.pack_schedule(ts, pad_row=60, batch_size=8)
    assert got8.fingerprint == want.fingerprint


def test_empty_stream_and_bad_rows():
    empty = superstep.MatchStream(np.empty((0, 2, 3), np.int32), np.empty(0),
                                  np.empty(0), np.empty(0, bool))
    s = superstep.pack_schedule(empty, pad_row=5, batch_size=4)
    j = jsched.pack_schedule(jsched.MatchStream(empty.player_idx, empty.winner,
                                                empty.mode_id, empty.afk),
                             pad_row=5, batch_size=4)
    assert s.fingerprint == j.fingerprint and s.n_steps == 1
    _tp, ts, _jp, _js = _streams(STREAM_CASES[0])
    with pytest.raises(ValueError, match="player row"):
        superstep.pack_schedule(ts, pad_row=10)


PLAN_CASES = [(1, 32768), (4, 32768), (16, 32768), (4, 128), (16, 128)]


def _route(monkeypatch, route):
    """``numpy`` forces the numpy planner, as a machine without g++ has it;
    ``native`` asserts the one-pass native planner is there."""
    if route == "numpy":
        monkeypatch.setattr(_native, "load", lambda: None)
    else:
        assert _native.load() is not None, "the native route needs g++"


def _assert_plans_equal(a, b, pidx, pad_row):
    """Port plans ``a`` equal JAX's ``b`` field for field and dtype for
    dtype, and each passes the untrusted-plan check on its steps."""
    assert len(a) == len(b)
    s0 = 0
    for x, y in zip(a, b):
        for f in ("slot_rows", "slot_idx", "first_use", "last_use"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f), err_msg=f)
            assert getattr(x, f).dtype == getattr(y, f).dtype
        assert (x.n_live, x.writebacks_avoided, x.spilled) == (
            y.n_live, y.writebacks_avoided, y.spilled)
        assert type(x.n_live) is int and type(x.writebacks_avoided) is int
        residency.check_plan(x, pidx[s0:], pad_row)
        s0 += x.n_steps
    assert s0 == pidx.shape[0]


def _check_residency_plans_equal(window, max_rows):
    _tp, ts, _jp, _js = _streams(STREAM_CASES[1])
    sch = superstep.pack_schedule(ts, pad_row=400, batch_size=16)
    pidx, _m, winner, mode_id, afk = sch.host_window(0, min(40, sch.n_steps))
    valid = (pidx != 400) & ((mode_id >= 0) & ~afk)[:, :, None, None]
    a = residency.plan_windows(pidx, valid, 400, window, max_rows)
    b = jres.plan_windows(pidx, valid, 400, window, max_rows)
    if max_rows < 1024:
        assert any(p.spilled for p in a)
    _assert_plans_equal(a, b, pidx, 400)


@pytest.mark.parametrize("window,max_rows", PLAN_CASES)
def test_residency_plans_equal(window, max_rows):
    _check_residency_plans_equal(window, max_rows)


@pytest.mark.parametrize("window,max_rows", PLAN_CASES)
def test_residency_plans_equal_numpy_route(monkeypatch, window, max_rows):
    _route(monkeypatch, "numpy")
    _check_residency_plans_equal(window, max_rows)


def _random_chunk(seed):
    """A seeded chunk with rows repeated within and across steps, pad-only
    steps and random written-slot masks (not conflict-free: the planner
    does not need it)."""
    rng = np.random.default_rng(seed)
    s, b, t = (int(rng.integers(1, 30)), int(rng.integers(1, 6)),
               int(rng.integers(1, 4)))
    pad = int(rng.integers(1, 120))
    pidx = rng.integers(0, pad + 1, size=(s, b, 2, t), dtype=np.int32)
    pidx[rng.random(s) < 0.2] = pad
    pidx[rng.random(pidx.shape) < 0.2] = pad
    valid = (pidx != pad) & (rng.random((s, b, 1, 1)) < 0.8)
    return pidx, valid, pad


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("seed", range(6))
def test_residency_random_plans_equal(monkeypatch, route, seed):
    """Seeded chunks x windows 1, 3, 16 x budgets from 8 rows up, through
    one scratch table: JAX's plans, or JAX's error word for word."""
    _route(monkeypatch, route)
    pidx, valid, pad = _random_chunk(seed)
    scratch = residency.PlanScratch()
    planned = 0
    for window in (1, 3, 16):
        for max_rows in (8, 16, 64, 1024):
            try:
                want = jres.plan_windows(pidx, valid, pad, window, max_rows)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    residency.plan_windows(pidx, valid, pad, window, max_rows,
                                           scratch=scratch)
                assert str(got.value) == str(e)
                continue
            got = residency.plan_windows(pidx, valid, pad, window, max_rows,
                                         scratch=scratch)
            _assert_plans_equal(got, want, pidx, pad)
            planned += 1
    assert planned and scratch.native is (route == "native")


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_residency_cut_edges(monkeypatch, route):
    """A step that lands exactly on ``max_rows`` fits (``side="right"``),
    the next new row cuts the window; pad-only steps, an empty chunk, the
    generation tags' wrap, and the errors with their messages."""
    _route(monkeypatch, route)
    pad = 50
    pidx = np.full((6, 2, 2, 2), pad, np.int32)
    pidx[0].flat[:7] = np.arange(7)  # 7 rows + the padding row: 8, the budget
    pidx[1].flat[:7] = np.arange(7)[::-1]  # nothing new: still fits
    pidx[2].flat[0] = 7  # one more row: over the budget, opens a window
    # step 3 is pad-only
    pidx[4].flat[:3] = (7, 8, 9)
    pidx[5].flat[:2] = (0, 9)
    valid = pidx != pad
    scratch = residency.PlanScratch()
    scratch.fit(pad + 1)
    scratch.generation[0] = 2**32 - 2  # the tags run out in this chunk
    got = residency.plan_windows(pidx, valid, pad, 16, 8, scratch=scratch)
    _assert_plans_equal(got, jres.plan_windows(pidx, valid, pad, 16, 8),
                        pidx, pad)
    assert [(p.n_steps, p.n_live, p.spilled) for p in got] == [
        (2, 8, True), (4, 5, False)]
    again = residency.plan_windows(pidx, valid, pad, 1, 8, scratch=scratch)
    _assert_plans_equal(again, jres.plan_windows(pidx, valid, pad, 1, 8),
                        pidx, pad)
    assert [p.n_live for p in again] == [8, 8, 2, 1, 4, 3]
    empty = np.empty((0, 2, 2, 2), np.int32)
    assert residency.plan_windows(empty, empty != pad, pad, 16, 8) == []
    with pytest.raises(ValueError, match="one superstep touches 8 rows but "
                       "the fused working-set budget is 4"):
        residency.plan_windows(pidx, valid, pad, 16, 4)
    with pytest.raises(ValueError, match="power of two, got 12"):
        residency.plan_windows(pidx, valid, pad, 16, 12)
    for row in (-1, pad + 1):
        bad = pidx.copy()
        bad[4, 1, 0, 1] = row
        with pytest.raises(ValueError, match=f"player row {row} outside"):
            residency.plan_windows(bad, valid, pad, 16, 8, scratch=scratch)
    # a fault leaves the scratch usable
    after = residency.plan_windows(pidx, valid, pad, 16, 8, scratch=scratch)
    _assert_plans_equal(after, got, pidx, pad)


def test_residency_python_fallback_is_counted(monkeypatch):
    pidx, valid, pad = _random_chunk(3)
    want = residency.plan_windows(pidx, valid, pad, 3, 1024)
    before = residency.python_fallbacks
    monkeypatch.setattr(_native, "load", lambda: None)
    scratch = residency.PlanScratch()
    got = residency.plan_windows(pidx, valid, pad, 3, 1024, scratch=scratch)
    assert residency.python_fallbacks == before + 1
    assert scratch.native is False
    _assert_plans_equal(got, want, pidx, pad)


def test_residency_planning_on_two_threads():
    """The feed and a second runner plan on two threads at once, each with
    its own scratch: every plan equals the serial one."""
    chunks = [_random_chunk(seed) for seed in (1, 2)]
    serial = [residency.plan_windows(p, v, pad, 3, 32) for p, v, pad in chunks]
    errors, out = [], [[], []]
    go = threading.Barrier(2)

    def plan(k):
        try:
            pidx, valid, pad = chunks[k]
            scratch = residency.PlanScratch()
            go.wait()
            for _ in range(200):
                out[k].append(residency.plan_windows(pidx, valid, pad, 3, 32,
                                                     scratch=scratch))
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=plan, args=(k,)) for k in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    for k, (pidx, _v, pad) in enumerate(chunks):
        assert len(out[k]) == 200
        for plans in out[k]:
            _assert_plans_equal(plans, serial[k], pidx, pad)


def test_residency_plan_checks():
    _tp, ts, _jp, _js = _streams(STREAM_CASES[0])
    sch = superstep.pack_schedule(ts, pad_row=60, batch_size=8)
    pidx, _m, winner, mode_id, afk = sch.host_window(0, 4)
    valid = pidx != 60
    plan = residency.plan_windows(pidx, valid, 60, 4, 32768)[0]
    residency.check_plan(plan, pidx, 60)
    bad = residency.ResidencyPlan(**{**plan.__dict__, "slot_rows": plan.slot_rows.copy()})
    bad.slot_rows[2] = bad.slot_rows[1]
    with pytest.raises(ValueError, match="aliases"):
        residency.check_plan(bad, pidx, 60)
    bad.slot_rows = plan.slot_rows.copy()
    bad.slot_rows[0] = 3
    with pytest.raises(ValueError, match="slot 0"):
        residency.check_plan(bad, pidx, 60)
    with pytest.raises(ValueError, match="one superstep touches"):
        residency.plan_windows(pidx, valid, 60, 4, 8)
    with pytest.raises(ValueError, match="power of two"):
        residency.plan_windows(pidx, valid, 60, 4, 100)


def test_resolve_fuse():
    assert residency.resolve_fuse("reference") is None
    spec = residency.resolve_fuse("fused", 4, 100, "torch")
    assert (spec.window, spec.max_rows, spec.backend) == (4, 128, "torch")
    assert residency.resolve_fuse("fused").backend is None
    with pytest.raises(ValueError):
        residency.resolve_fuse("fused", fuse_backend="pallas")
    with pytest.raises(ValueError):
        residency.resolve_fuse("bogus")
    with pytest.raises(ValueError):
        residency.resolve_fuse("fused", fuse_window=0)


# -- the staging spans: feed.materialize split, and the feed's waits --------

SPAN_CASE = dict(n_matches=500, n_players=90, seed=7, afk_rate=0.3,
                 unsupported_rate=0.2)
WAITS = ("feed.wait_assign", "feed.starved", "feed.backpressure")


def _fused_run(runner, monkeypatch=None, assign_delay=0.0):
    """A small fused re-rate on the CPU (torch backend, batches of 4;
    windows of 8 steps and a 64-row budget, so some windows spill) under a
    fresh tracer and registry. Returns (final table, stats, stream, the
    complete span events, tracer)."""
    import time

    from analyzer_tpu_torch import obs
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.sched import rate_history, rate_stream, runner as run_mod

    tp, ts, _jp, _js = _streams(SPAN_CASE)
    state = PlayerState.create(tp.n_players, tp.rank_points_ranked,
                               tp.rank_points_blitz, tp.skill_tier,
                               device="cpu")
    if assign_delay:
        real = run_mod.assign_batches

        def slow(*a, **kw):
            time.sleep(assign_delay)
            return real(*a, **kw)

        monkeypatch.setattr(run_mod, "assign_batches", slow)
    kw = dict(kernel="fused", fuse_window=8, fuse_max_rows=64,
              fuse_backend="torch", steps_per_chunk=12)
    obs.reset_registry()
    tracer = obs.reset_tracer()
    stats = {}
    if runner == "stream":
        out, _ = rate_stream(state, ts, RatingConfig(), batch_size=4,
                             stats_out=stats, **kw)
    else:
        sched = superstep.pack_schedule(ts, pad_row=state.pad_row, batch_size=4)
        out, _ = rate_history(state, sched, RatingConfig(), stats_out=stats, **kw)
        stats["n_steps"] = sched.n_steps
    evs = [e for e in tracer.events() if e["ph"] == "X"]
    return out.table.numpy(), stats, ts, evs, tracer


@pytest.mark.parametrize("runner", ["stream", "history"])
def test_staging_spans_nest_in_materialize(runner):
    table, stats, ts, evs, tracer = _fused_run(runner)
    mats = [e for e in evs if e["name"] == "feed.materialize"]
    assert len(mats) == len({m["args"]["start"] for m in mats}) > 2
    subs = {n: [e for e in evs if e["name"] == n]
            for n in ("feed.gather", "feed.plan", "feed.pack")}
    for m in mats:
        for name, spans in subs.items():
            mine = [e for e in spans if e["args"]["start"] == m["args"]["start"]]
            assert len(mine) == 1, (name, m["args"])
            (e,) = mine
            assert e["tid"] == m["tid"]
            assert m["ts"] <= e["ts"] and e["ts"] + e["dur"] <= m["ts"] + m["dur"] + 0.2
    assert all(len(s) == len(mats) for s in subs.values())
    for key in ("windows", "spills"):
        assert sum(e["args"][key] for e in subs["feed.plan"]) == stats[key]
    assert stats["spills"] > 0
    for name in ("feed.gather", "feed.plan"):
        assert sum(e["args"]["steps"] for e in subs[name]) == stats["n_steps"]
    assert all(e["args"]["bytes"] > 0 and e["args"]["pinned"] is False
               for e in subs["feed.pack"])
    fillers = sum(e["args"]["fillers"] for e in subs["feed.gather"])
    # the stream feed places every non-ratable match; a packed schedule
    # already holds them
    assert fillers == (int((~ts.ratable).sum()) if runner == "stream" else 0)
    assert tracer.dropped == 0


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_plan_span_names_its_planner(monkeypatch, route):
    """Every ``feed.plan`` span of a traced fused ``rate_stream`` says which
    planner ran; the forced numpy planner gives the same table."""
    _route(monkeypatch, route)
    table, stats, _ts, evs, _tr = _fused_run("stream")
    plans = [e for e in evs if e["name"] == "feed.plan"]
    assert plans and stats["spills"] > 0
    assert all(e["args"]["native"] is (route == "native") for e in plans)
    monkeypatch.undo()
    ref, _stats, _ts, _evs, _tr = _fused_run("stream")
    assert np.array_equal(table, ref, equal_nan=True)


def test_staging_spans_leave_the_table_unchanged():
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.sched import rate_history

    table, _stats, ts, _evs, _tr = _fused_run("stream")
    tp = _streams(SPAN_CASE)[0]
    state = PlayerState.create(tp.n_players, tp.rank_points_ranked,
                               tp.rank_points_blitz, tp.skill_tier,
                               device="cpu")
    sched = superstep.pack_schedule(ts, pad_row=state.pad_row, batch_size=4)
    ref, _ = rate_history(state, sched, RatingConfig())
    assert np.array_equal(table, ref.table.numpy(), equal_nan=True)


def test_waits_are_one_span_per_chunk_at_most(monkeypatch):
    """A slow assigner start: the feed waits on it in ONE
    ``feed.wait_assign`` span (not one a 2 ms wake), at least as long as
    the delay; every wait span names at most one of each kind a chunk."""
    delay = 0.08
    _table, _stats, _ts, evs, tracer = _fused_run(
        "stream", monkeypatch, assign_delay=delay)
    chunks = {e["args"]["start"] for e in evs if e["name"] == "feed.materialize"}
    for name in WAITS:
        spans = [e for e in evs if e["name"] == name]
        starts = [e["args"].get("start") for e in spans]
        keyed = [s for s in starts if s is not None]
        assert len(keyed) == len(set(keyed)) and set(keyed) <= chunks, name
        # the ring's wait for its close names no chunk: one at most
        assert starts.count(None) <= (1 if name == "feed.starved" else 0), name
    (first,) = [e for e in evs if e["name"] == "feed.wait_assign"
                and e["args"]["start"] == 0]
    assert first["dur"] >= 0.9 * delay * 1e6
    assert tracer.dropped == 0


@pytest.mark.parametrize("slow_side", ["consumer", "producer"])
def test_prefetcher_wait_spans_match_their_counters(slow_side):
    """A sleeping consumer makes the producer wait on a full ring (one
    ``feed.backpressure`` a wait, as long as the sleep); a sleeping
    producer makes the consumer wait on an empty one (``feed.starved``)."""
    import time

    from analyzer_tpu_torch import obs
    from analyzer_tpu_torch.sched.feed import Prefetcher

    nap = 0.05
    reg = obs.reset_registry()
    tracer = obs.reset_tracer()

    def producer(put):
        for start in range(3):
            if slow_side == "producer":
                time.sleep(nap)
            put((start, start + 1, None))

    got = []
    with Prefetcher(producer, depth=1) as pf:
        for item in pf:
            got.append(item[0])
            if slow_side == "consumer":
                time.sleep(nap)
    assert got == [0, 1, 2]
    name, counter = (("feed.backpressure", "feed.backpressure_total")
                     if slow_side == "consumer"
                     else ("feed.starved", "feed.starved_total"))
    spans = [e for e in tracer.events() if e["name"] == name]
    assert len(spans) == reg.counter(counter).value >= 1
    keyed = [e for e in spans if "start" in e["args"]]
    assert keyed and max(e["dur"] for e in keyed) >= 0.5 * nap * 1e6
    me = threading.get_ident() % 1_000_000
    assert all((e["tid"] == me) == (slow_side == "producer") for e in spans)
