"""The plain references on the CPU: the level schedule is the sequential
re-rate, the rating reference agrees with the program at a tiny size, and the control (the reference in bfloat16) fails the limits
the cells hold the program to."""

import numpy as np
import pytest
import torch

from _tiny import SECONDS, TINY, spec_for
from portbench import control, gen, plain


def tiny_history(seed=11, players=2000, matches=12000):
    p = gen.make_players(players, seed, "cpu")
    s = gen.make_stream(matches, p["latent"], seed, 0.8, 1e-3, chunk=5000)
    return p, s


def test_generator_is_seeded():
    a, b = tiny_history(5)[1], tiny_history(5)[1]
    c = tiny_history(6)[1]
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["player_idx"], c["player_idx"])
    idx = a["player_idx"]
    for row in idx[:500].reshape(500, -1):
        live = row[row >= 0]
        assert len(set(live.tolist())) == live.size  # distinct players
    assert set(np.unique(a["mode_id"])) <= set(range(-1, 6))


def test_levels_equal_the_sequential_rerate():
    _, s = tiny_history()
    start = plain.initial_table(2000)
    args = (s["player_idx"], s["winner"], s["mode_id"], s["afk"], "cpu")
    blocked = plain.rate_history(start, *args, block=4096)
    sequential = plain.rate_history(start, *args, block=1)
    assert np.array_equal(blocked, sequential, equal_nan=True)


@pytest.mark.parametrize("kernel", ["reference", "fused"])
def test_reference_equals_the_program(kernel):
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.core.state import PlayerState
    from analyzer_tpu_torch.sched import rate_stream
    from analyzer_tpu_torch.sched.superstep import MatchStream

    p, s = tiny_history()
    state = PlayerState.create(2000, cfg=RatingConfig(), device="cpu")
    got, _ = rate_stream(state, MatchStream(**s), RatingConfig(), kernel=kernel)
    ref = plain.rate_history(plain.initial_table(2000), s["player_idx"],
                             s["winner"], s["mode_id"], s["afk"], "cpu")
    cmp = plain.compare_tables(got.table.numpy()[:-1], ref[:-1])
    assert cmp["null_mismatches"] == 0 and cmp["max_rel_err"] == 0.0


def test_seed_columns_equal_the_programs():
    from analyzer_tpu_torch.config import RatingConfig
    from analyzer_tpu_torch.core.state import PlayerState

    p = {k: v.numpy() for k, v in gen.make_players(5000, 3, "cpu").items()}
    want = PlayerState.create(5000, p["rank_points_ranked"], p["rank_points_blitz"],
                              p["skill_tier"], cfg=RatingConfig(), device="cpu")
    got = plain.initial_table(5000, p["rank_points_ranked"],
                              p["rank_points_blitz"], p["skill_tier"])
    assert np.array_equal(got, want.table.numpy(), equal_nan=True)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_fails_the_cells_limits(workload):
    got = control.control_cell(workload, 2**31 + 7, SECONDS, "cpu", TINY[workload],
                               spec=spec_for(workload))
    assert all(v <= got["limits"][k] for k, v in got["program"].items())
    low = got["control"]
    assert any(low[k] > got["limits"][k] for k in low if k in got["limits"])
