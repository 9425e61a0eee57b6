"""The port's TrueSkill numerics (``analyzer_tpu_torch.ops``) against the
JAX package's on the same seeded inputs, against the 50-digit mpmath
oracle with the bounds of tests/test_oracle.py, and against the dense
matrix form of match quality.

Why float results get a tolerance against JAX: both sides run float32
with the same formulas, but (1) ``erf``/``erfc``/``exp``/``log`` come from
different implementations (XLA's CPU kernels vs PyTorch's), which differ in
the last ulps; (2) JAX's team sums are XLA reductions in an unspecified
order, the port's are explicit add chains; (3) the port's ``sqrt`` is the
correctly rounded one (via float64), JAX's CPU one too. v(t) amplifies
(1): it is exp(log phi - log Phi), a difference of two values of size
t^2/2, so one ulp of those (at t = -23: 3e-5 of 270) becomes ~3e-5
relative in v; w(t) = v(v + t) cancels near t = -10 and magnifies it again.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import log_ndtr as jax_log_ndtr

from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.ops import normal as jax_normal
from analyzer_tpu.ops import oracle
from analyzer_tpu.ops import trueskill as jax_ts
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.ops import normal, trueskill as ts

CFG = RatingConfig()
JCFG = JaxRatingConfig()


def _t_grid():
    rng = np.random.default_rng(3)
    return np.concatenate([
        rng.uniform(-30.0, 15.0, 20000),
        np.linspace(-10.5, -9.5, 401),  # the lower segment, t <= -10 included
        np.linspace(4.5, 5.5, 401),  # the upper segment, t > 5 included
        np.asarray([-10.0, 5.0, 0.0, -1e-3, 1e-3, 40.0, -60.0]),
    ]).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


class TestNormalAgainstJax:
    def test_log_ndtr(self):
        t = _t_grid()
        want = np.asarray(jax_log_ndtr(jnp.asarray(t)), np.float64)
        got = normal.log_ndtr(_t(t)).numpy().astype(np.float64)
        # erf/erfc/log ulps: relative 2e-6 where |log Phi| is large, and
        # absolute 2e-7 where it is tiny (t > 3: log Phi ~ -Phi(-t)).
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-7)

    def test_v_win(self):
        t = _t_grid()
        want = np.asarray(jax_normal.v_win(jnp.asarray(t)), np.float64)
        got = normal.v_win(_t(t)).numpy().astype(np.float64)
        # v = exp(log phi - log Phi): ulps of the two ~t^2/2 terms.
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)

    def test_w_win(self):
        t = _t_grid()
        want = np.asarray(jax_normal.w_win(jnp.asarray(t)), np.float64)
        got = normal.w_win(_t(t)).numpy().astype(np.float64)
        # v*(v + t) cancels as t falls (v + t ~ -1/t): w inherits v's
        # few-ulp difference magnified ~t^2 — measured 2e-6 absolute for
        # t > -2 and 4e-4 on (-10, -2], the band where the oracle bound
        # itself is 5e-4. The series tail (t <= -10) has no transcendental.
        direct = t > -10.0
        tight = t > -2.0
        np.testing.assert_allclose(got[tight], want[tight], rtol=1e-5, atol=5e-6)
        np.testing.assert_allclose(got[direct], want[direct], atol=1e-3)
        np.testing.assert_array_equal(got[~direct], want[~direct])

    def test_ndtr(self):
        t = _t_grid()
        from jax.scipy.special import ndtr

        want = np.asarray(ndtr(jnp.asarray(t)), np.float64)
        got = normal.ndtr(_t(t)).numpy().astype(np.float64)
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12)


def _batch(b=4000, t=5, seed=1):
    rng = np.random.default_rng(seed)
    mu = rng.normal(1500, 400, (b, 2, t)).astype(np.float32)
    sigma = rng.uniform(30, 600, (b, 2, t)).astype(np.float32)
    mask = rng.random((b, 2, t)) < 0.8
    mask[:, :, 0] = True  # every team has a player
    winner = rng.integers(0, 2, b).astype(np.int32)
    # a few huge upsets push t below -10
    mu[:20, 0] = 200.0
    mu[:20, 1] = 9000.0
    sigma[:20] = 40.0
    winner[:20] = 0
    return mu, sigma, mask, winner


class TestTrueSkillAgainstJax:
    def test_two_team_update(self):
        mu, sigma, mask, winner = _batch()
        want = jax_ts.two_team_update(
            jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(mask),
            jnp.asarray(winner), JCFG,
        )
        got = ts.two_team_update(_t(mu), _t(sigma), _t(mask), _t(winner), CFG)
        # sum order and transcendental ulps (module docstring); measured
        # ~1.4e-6 on mu, ~1.5e-7 on sigma.
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=5e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
        # masked slots pass through bit for bit on both sides
        np.testing.assert_array_equal(got[0].numpy()[~mask], mu[~mask])
        np.testing.assert_array_equal(got[1].numpy()[~mask], sigma[~mask])

    def test_quality_and_win_probability(self):
        mu, sigma, mask, _ = _batch(seed=2)
        args_j = (jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(mask), JCFG)
        args_t = (_t(mu), _t(sigma), _t(mask), CFG)
        np.testing.assert_allclose(
            ts.quality(*args_t).numpy(), np.asarray(jax_ts.quality(*args_j)),
            rtol=2e-6, atol=1e-30,
        )
        np.testing.assert_allclose(
            ts.win_probability(*args_t).numpy(),
            np.asarray(jax_ts.win_probability(*args_j)), atol=1e-6,
        )

    def test_sqrt_is_correctly_rounded(self):
        x = np.random.default_rng(5).uniform(1, 1e8, 100000).astype(np.float32)
        np.testing.assert_array_equal(ts.sqrt_rn(_t(x)).numpy(), np.sqrt(x))


class TestOracleBounds:
    """The bounds of tests/test_oracle.py, held by the port on its own."""

    def test_v_w_accuracy_over_range(self):
        t = np.concatenate(
            [np.linspace(-30, 10, 401), np.asarray([-1e-3, 0.0, 1e-3])]
        )
        t32 = _t(t.astype(np.float32))
        v32 = normal.v_win(t32).numpy().astype(np.float64)
        w32 = normal.w_win(t32).numpy().astype(np.float64)
        for i, ti in enumerate(t):
            vo = float(oracle.v_win(ti))
            wo = float(oracle.w_win(ti))
            bound_v = 2e-5 if ti > -8 else 5e-5
            assert abs(v32[i] - vo) / max(vo, 1e-30) < bound_v, (ti, v32[i], vo)
            if ti > -2:
                bound_w = 2e-5 * wo + 1e-7
            elif ti > -10:
                bound_w = 5e-4
            else:
                bound_w = 1e-4
            assert abs(w32[i] - wo) < bound_w, (ti, w32[i], wo)

    def test_naive_form_would_fail(self):
        t = torch.tensor([-15.0, -20.0])
        naive = torch.exp(normal.log_pdf(t)) / normal.cdf(t)
        assert not torch.isfinite(naive).all()
        assert torch.isfinite(normal.v_win(t)).all()

    MATCHUPS = [
        ("fresh 3v3", [[2000.0] * 3, [2000.0] * 3], [[500.0] * 3, [500.0] * 3], 0),
        ("veterans", [[1800.0, 2100.0, 1500.0], [1900.0, 2000.0, 1700.0]],
         [[60.0, 45.0, 80.0], [55.0, 70.0, 65.0]], 1),
        ("upset", [[900.0] * 3, [2800.0] * 3], [[200.0] * 3, [150.0] * 3], 0),
        ("5v5 mixed", [[1500.0, 2000.0, 1200.0, 1710.0, 1303.0]] * 2,
         [[333.3, 90.0, 400.0, 120.0, 250.0]] * 2, 1),
        ("asymmetric sigma", [[1500.0] * 3, [1500.0] * 3],
         [[1000.0, 10.0, 333.0], [500.0, 500.0, 500.0]], 0),
    ]

    @pytest.mark.parametrize("name,mu,sigma,winner", MATCHUPS)
    def test_update_vs_oracle(self, name, mu, sigma, winner):
        t = max(len(mu[0]), len(mu[1]))
        mu_a = np.zeros((1, 2, t), np.float32)
        sg_a = np.ones((1, 2, t), np.float32)
        mask = np.zeros((1, 2, t), bool)
        for ti in range(2):
            for si, m in enumerate(mu[ti]):
                mu_a[0, ti, si] = m
                sg_a[0, ti, si] = sigma[ti][si]
                mask[0, ti, si] = True
        nm, ns = ts.two_team_update(
            _t(mu_a), _t(sg_a), _t(mask), torch.tensor([winner], dtype=torch.int32), CFG
        )
        q = float(ts.quality(_t(mu_a), _t(sg_a), _t(mask), CFG)[0])
        om, os_ = oracle.two_team_update(mu, sigma, winner, CFG.beta, CFG.tau)
        oq = float(oracle.quality(mu, sigma, CFG.beta))
        for ti in range(2):
            for si in range(len(mu[ti])):
                rm = abs(float(nm[0, ti, si]) - float(om[ti][si])) / abs(float(om[ti][si]))
                rs = abs(float(ns[0, ti, si]) - float(os_[ti][si])) / abs(float(os_[ti][si]))
                assert rm < 1e-5, (name, ti, si, rm)
                assert rs < 1e-4, (name, ti, si, rs)
        assert abs(q - oq) / max(oq, 1e-12) < 1e-5, (name, q, oq)


class TestQualityDense:
    @staticmethod
    def _matrix_quality(team_mus, team_sigmas, beta):
        """General TrueSkill quality by dense linear algebra (the formula
        the trueskill library implements with its own matrix type)."""
        flat_mu = np.concatenate([np.asarray(t, np.float64) for t in team_mus])
        n0, n1 = len(team_mus[0]), len(team_mus[1])
        a = np.concatenate([np.ones(n0), -np.ones(n1)])[None, :]
        s = np.diag(
            np.concatenate([np.asarray(t, np.float64) ** 2 for t in team_sigmas])
        )
        b2ata = beta**2 * (a @ a.T)
        mid = b2ata + a @ s @ a.T
        e = np.exp(-0.5 * flat_mu @ a.T @ np.linalg.inv(mid) @ a @ flat_mu)
        return float(e * np.sqrt(np.linalg.det(b2ata) / np.linalg.det(mid)))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_matrix_formula(self, seed):
        rng = np.random.default_rng(seed)
        mu = rng.normal(1500, 300, (1, 2, 3)).astype(np.float32)
        sigma = rng.uniform(50, 600, (1, 2, 3)).astype(np.float32)
        mask = np.ones((1, 2, 3), bool)
        q = float(ts.quality(_t(mu), _t(sigma), _t(mask), CFG)[0])
        q_ref = self._matrix_quality(
            list(mu[0].astype(np.float64)), list(sigma[0].astype(np.float64)),
            CFG.beta,
        )
        assert q == pytest.approx(q_ref, rel=1e-5)


class TestProperties:
    def test_directions_shrinkage_and_masked_slots(self):
        mu = torch.full((1, 2, 3), 1500.0)
        sigma = torch.full((1, 2, 3), 300.0)
        mask = torch.tensor([[[True, True, False], [True, True, True]]])
        nm, ns = ts.two_team_update(mu, sigma, mask, torch.tensor([0]), CFG)
        assert (nm[0, 0, :2] > 1500).all() and (nm[0, 1] < 1500).all()
        assert (ns[mask] < 300).all()
        assert nm[0, 0, 2] == 1500.0 and ns[0, 0, 2] == 300.0

    def test_complement_symmetry(self):
        mu, sigma, mask, _ = _batch(b=50, seed=4)
        p = ts.win_probability(_t(mu), _t(sigma), _t(mask), CFG)
        p_sw = ts.win_probability(
            _t(mu[:, ::-1].copy()), _t(sigma[:, ::-1].copy()),
            _t(mask[:, ::-1].copy()), CFG,
        )
        np.testing.assert_allclose((p + p_sw).numpy(), 1.0, atol=1e-6)

    def test_huge_upset_stays_finite(self):
        mu = torch.tensor([[[9000.0] * 3, [100.0] * 3]])
        sigma = torch.full((1, 2, 3), 50.0)
        mask = torch.ones((1, 2, 3), dtype=torch.bool)
        nm, ns = ts.two_team_update(mu, sigma, mask, torch.tensor([1]), CFG)
        assert torch.isfinite(nm).all() and torch.isfinite(ns).all()
        assert (ns > 0).all() and float(nm[0, 1, 0]) > 100.0
