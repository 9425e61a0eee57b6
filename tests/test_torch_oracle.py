"""The port's 50-digit oracle (``analyzer_tpu_torch.ops.oracle``) against
the JAX package's copy, and the port's float32 numerics against its own
oracle with the bounds of tests/test_oracle.py (relative mu < 1e-5, sigma
< 1e-4, quality < 1e-5).

The two oracles are the same mpmath code at the same precision, so their
values must be EQUAL as mpf numbers (all 50 digits), not merely close.
The last class runs ``chip_smoke.py``'s ``[oracle]`` check on the CPU: the
plain fused window (what the CUDA kernel is held to on the card) over the
first windows of a real schedule, a seeded sample of its first-step
matches held to the oracle.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from analyzer_tpu.ops import oracle as joracle
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.io.synthetic import synthetic_players, synthetic_stream
from analyzer_tpu_torch.ops import oracle, trueskill as ts
from analyzer_tpu_torch.sched import pack_schedule
from analyzer_tpu_torch.sched.feed import stage_chunk_fused
from analyzer_tpu_torch.sched.residency import resolve_fuse

CFG = RatingConfig()
BOUND_MU, BOUND_SIGMA, BOUND_Q = 1e-5, 1e-4, 1e-5

MATCHUPS = [
    # (name, mu, sigma, winner) — tests/test_oracle.py's matchups
    ("fresh 3v3", [[2000.0] * 3, [2000.0] * 3], [[500.0] * 3, [500.0] * 3], 0),
    ("veterans", [[1800.0, 2100.0, 1500.0], [1900.0, 2000.0, 1700.0]],
     [[60.0, 45.0, 80.0], [55.0, 70.0, 65.0]], 1),
    ("upset", [[900.0] * 3, [2800.0] * 3], [[200.0] * 3, [150.0] * 3], 0),
    ("5v5 mixed", [[1500.0, 2000.0, 1200.0, 1710.0, 1303.0]] * 2,
     [[333.3, 90.0, 400.0, 120.0, 250.0]] * 2, 1),
    ("asymmetric sigma", [[1500.0] * 3, [1500.0] * 3],
     [[1000.0, 10.0, 333.0], [500.0, 500.0, 500.0]], 0),
]


def _random_matchups(n=40, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sizes = rng.integers(1, 6, 2)
        mu = [[float(x) for x in rng.normal(1500, 500, k).astype(np.float32)]
              for k in sizes]
        sigma = [[float(x) for x in rng.uniform(20, 900, k).astype(np.float32)]
                 for k in sizes]
        out.append((f"random{i}", mu, sigma, int(rng.integers(0, 2))))
    return out


class TestOracleEqualsJax:
    def test_precision_is_the_references(self):
        assert oracle.mp.mp.dps == joracle.mp.mp.dps == 50

    @pytest.mark.parametrize("t", [-40.0, -12.5, -10.0, -3.3, -1e-3, 0.0,
                                   1e-3, 0.7, 2.5, 5.0, 9.9, 30.0])
    def test_v_and_w_equal_at_50_digits(self, t):
        assert oracle.v_win(t) == joracle.v_win(t)
        assert oracle.w_win(t) == joracle.w_win(t)

    @pytest.mark.parametrize(
        "name,mu,sigma,winner", MATCHUPS + _random_matchups(),
        ids=lambda x: x if isinstance(x, str) else None,
    )
    def test_update_and_quality_equal_at_50_digits(self, name, mu, sigma, winner):
        got = oracle.two_team_update(mu, sigma, winner, CFG.beta, CFG.tau)
        want = joracle.two_team_update(mu, sigma, winner, CFG.beta, CFG.tau)
        assert got == want, name
        assert oracle.quality(mu, sigma, CFG.beta) == joracle.quality(
            mu, sigma, CFG.beta
        )


def _port_update(mu, sigma, winner):
    t = max(len(mu[0]), len(mu[1]))
    mu_a = np.zeros((1, 2, t), np.float32)
    sg_a = np.ones((1, 2, t), np.float32)
    mask = np.zeros((1, 2, t), bool)
    for ti in range(2):
        for si, m in enumerate(mu[ti]):
            mu_a[0, ti, si] = m
            sg_a[0, ti, si] = sigma[ti][si]
            mask[0, ti, si] = True
    args = (torch.from_numpy(mu_a), torch.from_numpy(sg_a), torch.from_numpy(mask))
    nm, ns = ts.two_team_update(
        *args, torch.tensor([winner], dtype=torch.int32), CFG
    )
    q = float(ts.quality(*args, CFG)[0])
    return nm[0].numpy(), ns[0].numpy(), q


class TestPortOpsAgainstOwnOracle:
    @pytest.mark.parametrize(
        "name,mu,sigma,winner", MATCHUPS + _random_matchups(),
        ids=lambda x: x if isinstance(x, str) else None,
    )
    def test_update_within_bounds(self, name, mu, sigma, winner):
        nm, ns, q = _port_update(mu, sigma, winner)
        om, os_ = oracle.two_team_update(mu, sigma, winner, CFG.beta, CFG.tau)
        oq = float(oracle.quality(mu, sigma, CFG.beta))
        for ti in range(2):
            for si in range(len(mu[ti])):
                rm = abs(float(nm[ti, si]) - float(om[ti][si])) / abs(float(om[ti][si]))
                rs = abs(float(ns[ti, si]) - float(os_[ti][si])) / abs(float(os_[ti][si]))
                assert rm < BOUND_MU, (name, ti, si, rm)
                assert rs < BOUND_SIGMA, (name, ti, si, rs)
        assert abs(q - oq) / max(oq, 1e-12) < BOUND_Q, (name, q, oq)


class TestFusedWindowSampleAgainstOracle:
    """chip_smoke.py's [oracle] phase on the CPU's plain window, at a small
    schedule (the card runs it at bench size through the CUDA kernel)."""

    def test_first_step_sample_within_bounds(self):
        n = 6000
        players = synthetic_players(n // 3, seed=42)
        stream = synthetic_stream(n, players, seed=42,
                                  activity_concentration=0.8,
                                  max_activity_share=1e-4)
        state = PlayerState.create(
            n // 3, players.rank_points_ranked, players.rank_points_blitz,
            players.skill_tier, cfg=CFG, device="cpu",
        )
        sched = pack_schedule(stream, pad_row=state.pad_row, windowed=True)
        chunk = stage_chunk_fused(sched, 0, min(128, sched.n_steps),
                                  resolve_fuse("fused"), True, False)
        views = chunk.slab.to_device(torch.device("cpu"))
        samples = chip_smoke.oracle_window_samples(
            state.table.clone(), chunk, views, CFG, 4
        )
        assert len(samples) >= 32
        pick = np.random.default_rng(42).choice(len(samples), 32, replace=False)
        worst = chip_smoke.oracle_errors([samples[i] for i in pick], CFG)
        assert worst["mu"] < BOUND_MU, worst
        assert worst["sigma"] < BOUND_SIGMA, worst
        assert worst["quality"] < BOUND_Q, worst
        # priors after the first window are no longer all seeds: the sample
        # holds rated players too
        assert any(not np.isnan(pre[s[s > 0], 0]).all()
                   for pre, s, *_ in samples)
