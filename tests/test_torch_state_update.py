"""The port's state and superstep (``analyzer_tpu_torch.core``) against the
JAX package: seed columns bit-equal, the state carried across bit for bit,
one ``rate_and_apply`` step equal on gates and NaN pattern and within a
stated tolerance on floats, and the first-ever 3v3 winner constant that
the JAX package's object API and tensor path both give (2052.41)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.core.state import MatchBatch as JaxMatchBatch
from analyzer_tpu.core.state import PlayerState as JaxPlayerState
from analyzer_tpu.core.update import rate_and_apply_jit
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core import constants
from analyzer_tpu_torch.core.state import MatchBatch, PlayerState
from analyzer_tpu_torch.core.update import (
    check_conflict_free,
    check_window_conflict_free,
    rate_and_apply,
    rate_and_apply_checked,
)

CFG = RatingConfig()
JCFG = JaxRatingConfig()
CPU = "cpu"


def _features(p=200, seed=0):
    rng = np.random.default_rng(seed)
    rr = np.where(rng.random(p) < 0.4, rng.uniform(1, 3000, p), np.nan)
    rb = np.where(rng.random(p) < 0.2, rng.uniform(1, 3000, p), np.nan)
    rr[:5] = 0.0  # 0 means "missing" like NaN
    rb[5:10] = 0.0
    tiers = rng.integers(-1, 30, p).astype(np.int32)
    tiers[10:12] = [-5, 40]  # clamped by the tensor path
    return rr, rb, tiers


@pytest.mark.parametrize("usigma", [500.0, 350.0])
def test_seed_columns_bit_equal(usigma):
    rr, rb, tiers = _features()
    jcfg = dataclasses.replace(JCFG, unknown_player_sigma=usigma)
    cfg = dataclasses.replace(CFG, unknown_player_sigma=usigma)
    want = JaxPlayerState.create(200, rr, rb, tiers, cfg=jcfg)
    got = PlayerState.create(200, rr, rb, tiers, cfg=cfg, device=CPU)
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    np.testing.assert_array_equal(
        got.rank_points_ranked.numpy(), np.asarray(want.rank_points_ranked)
    )
    np.testing.assert_array_equal(got.skill_tier.numpy(), np.asarray(want.skill_tier))
    assert got.pad_row == want.pad_row == 200


def test_constants_equal():
    from analyzer_tpu.core import constants as jc

    assert constants.MODES == jc.MODES
    assert constants.MODE_TO_ID == jc.MODE_TO_ID
    assert constants.N_RATING_COLS == jc.N_RATING_COLS
    assert constants.UNSUPPORTED_MODE_ID == jc.UNSUPPORTED_MODE_ID
    assert (constants.MIN_SKILL_TIER, constants.MAX_SKILL_TIER) == (
        jc.MIN_SKILL_TIER, jc.MAX_SKILL_TIER)
    np.testing.assert_array_equal(constants.VST_TABLE, jc.VST_TABLE)


def test_config_copy_matches():
    env = {"UNKNOWN_PLAYER_SIGMA": "321", "TAU": ""}
    a, b = RatingConfig.from_env(env), JaxRatingConfig.from_env(env)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(ValueError):
        RatingConfig(draw_probability=0.1)


def test_from_numpy_round_trip():
    rr, rb, tiers = _features(seed=3)
    j = JaxPlayerState.create(200, rr, rb, tiers).set_rating(7, 2, 1812.5, 77.25)
    got = PlayerState.from_numpy(
        np.asarray(j.table), np.asarray(j.rank_points_ranked),
        np.asarray(j.rank_points_blitz), np.asarray(j.skill_tier),
        seed_cfg=CFG, device=CPU,
    )
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(j.table))
    assert float(got.mu[7, 2]) == 1812.5 and float(got.sigma[7, 2]) == 77.25
    with pytest.raises(ValueError, match="table"):
        PlayerState.from_numpy(np.zeros((3, 15)), *([np.zeros(3)] * 3), device=CPU)


def _step_inputs(seed=0, b=48, p=120):
    """A conflict-free batch with fillers (AFK / unsupported) that share
    players with ratable matches, over a partly rated table."""
    rng = np.random.default_rng(seed)
    pad = p
    idx = np.full((b, 2, 5), pad, np.int32)
    perm = rng.permutation(p)
    n_ratable = 10
    for i in range(n_ratable):
        t = 3 if i % 2 else 5
        idx[i, :, :t] = perm[i * 10: i * 10 + 2 * t].reshape(2, t)
    for i in range(n_ratable, b - 4):  # fillers reuse ratable players
        idx[i, :, :3] = rng.choice(perm[:100], 6, replace=False).reshape(2, 3)
    mask = idx != pad
    winner = rng.integers(0, 2, b).astype(np.int32)
    mode = rng.integers(0, 6, b).astype(np.int32)
    afk = np.zeros(b, bool)
    mode[n_ratable:n_ratable + 10] = -1
    afk[n_ratable + 10:] = True
    mode[b - 4:] = -1  # batch padding: all slots on the pad row
    afk[b - 4:] = False
    return idx, mask, winner, mode, afk


def _rated_state(pkg_state, rows, seed=1):
    rng = np.random.default_rng(seed)
    st = pkg_state
    for r in rows:
        for col in rng.choice(7, 2, replace=False):
            st = st.set_rating(int(r), int(col), float(rng.normal(1700, 300)),
                               float(rng.uniform(40, 400)))
    return st


def test_one_step_matches_rate_and_apply_jit():
    rr, rb, tiers = _features(p=120, seed=4)
    rows = np.arange(0, 120, 3)
    jstate = _rated_state(JaxPlayerState.create(120, rr, rb, tiers), rows)
    state = PlayerState.from_numpy(
        np.asarray(jstate.table), np.asarray(jstate.rank_points_ranked),
        np.asarray(jstate.rank_points_blitz), np.asarray(jstate.skill_tier),
        seed_cfg=CFG, device=CPU,
    )
    idx, mask, winner, mode, afk = _step_inputs()
    jbatch = JaxMatchBatch(
        jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(winner),
        jnp.asarray(mode), jnp.asarray(afk),
    )
    batch = MatchBatch(*(torch.from_numpy(x) for x in (idx, mask, winner, mode, afk)))
    check_conflict_free(batch)
    jnew, jout = rate_and_apply_jit(jstate, jbatch, JCFG)
    new, out = rate_and_apply(state, batch, CFG)

    for gate in ("updated", "any_afk", "write_quality"):
        np.testing.assert_array_equal(
            getattr(out, gate).numpy(), np.asarray(getattr(jout, gate)), err_msg=gate
        )
    a, b = new.table.numpy(), np.asarray(jnew.table)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    # Transcendental ulps and sum order (tests/test_torch_ops.py); one
    # step: measured below 1e-6 relative on mu/sigma (rating scale 1e3).
    np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-3)
    for field in ("shared_mu", "shared_sigma", "mode_mu", "mode_sigma", "delta"):
        np.testing.assert_allclose(
            getattr(out, field).numpy(), np.asarray(getattr(jout, field)),
            rtol=2e-6, atol=2e-3, err_msg=field,  # delta cancels: ulps of ~2e3
        )
    np.testing.assert_allclose(out.quality.numpy(), np.asarray(jout.quality), rtol=2e-6, atol=1e-7)
    # The caller's state is untouched; the pad row is a fixed point.
    assert np.array_equal(state.table.numpy(), np.asarray(jstate.table), equal_nan=True)
    assert np.array_equal(a[-1], state.table.numpy()[-1], equal_nan=True)


def test_first_ever_3v3_winner_constant():
    """Fresh tier-15 players, first-ever 3v3: the winner's shared mu is
    2052.41 (f32, default config), as in the JAX package."""
    state = PlayerState.create(6, skill_tier=np.full(6, 15), device=CPU)
    idx = np.array([[[0, 1, 2, 6, 6], [3, 4, 5, 6, 6]]], np.int32)
    batch = MatchBatch(
        torch.from_numpy(idx), torch.from_numpy(idx != 6),
        torch.tensor([0], dtype=torch.int32), torch.tensor([1], dtype=torch.int32),
        torch.tensor([False]),
    )
    new, out = rate_and_apply(state, batch, CFG)
    assert round(float(new.mu[0, 0]), 2) == 2052.41
    assert float(new.mu[3, 0]) < float(new.mu[0, 0])
    assert round(float(out.shared_mu[0, 0, 0]), 2) == 2052.41
    assert 0.0 < float(out.quality[0]) < 1.0
    assert float(out.delta[0, 0, 0]) == 0.0  # first-ever rating: no delta


def test_seed_cfg_mismatch_is_refused():
    state = PlayerState.create(4, device=CPU)
    idx = torch.full((1, 2, 5), 4, dtype=torch.int32)
    batch = MatchBatch(idx, idx != 4, torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="UNKNOWN_PLAYER_SIGMA"):
        rate_and_apply(state, batch, RatingConfig(unknown_player_sigma=100.0))


def test_conflict_checks():
    idx = np.full((2, 2, 5), 9, np.int32)
    idx[0, 0, 0] = idx[1, 1, 0] = 3
    t = torch.from_numpy(idx)
    batch = MatchBatch(t, t != 9, torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="conflict-free"):
        check_conflict_free(batch)
    with pytest.raises(ValueError, match="conflict-free"):
        rate_and_apply_checked(PlayerState.create(9, device=CPU), batch, CFG)
    # the same player in an AFK match is no conflict
    batch.afk = torch.tensor([False, True])
    check_conflict_free(batch)
    with pytest.raises(ValueError, match="window step 0"):
        check_window_conflict_free(idx[None], np.ones((1, 2), bool), pad_row=9)
    with pytest.raises(TypeError):
        check_window_conflict_free(idx[None], np.ones((1, 2), bool))
