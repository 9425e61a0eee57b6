"""The port's model zoo (``analyzer_tpu_torch.models``) against the JAX
package's ``analyzer_tpu.models`` on the same numpy inputs, and every
assertion of ``tests/test_models.py`` held on the port.

Exact (tolerance 0): ``synthetic_telemetry``, ``telemetry_features``,
``composition_features``, ``fit_temperature`` / ``apply_temperature``
(numpy copies); the ``ratable`` mask, the mode one-hot and the NaN
pattern of the features; one Adam step against optax's, run op by op,
on the same gradients (``models/training.py`` writes optax's order out).

Within a stated tolerance, and why:

* Elo (``ELO_ATOL`` on ratings, ``EXP_ATOL`` on predictions): XLA's f32
  ``pow(10, x)`` and team reductions against PyTorch's differ in the last
  ulp; each step adds K * (a difference of predictions) to the ratings,
  so those ulps accumulate over a player's matches. Measured over the
  3,000-match fixture: 4.9e-4 on ratings of ~1,500 (4 ulps), 9e-7 on
  predictions.
* Features (``FEAT_RTOL``/``FEAT_ATOL``): each step's features come from
  a state that both packages have rated with the float tolerance of
  ``tests/test_torch_stream.py`` (rtol 2e-6, atol 2e-3 on the table; see
  ``tests/test_torch_ops.py`` for why); win probability and quality add
  the ops' own ulps. Measured: 2.6e-6 at most.
* Trained weights and losses (``W_RTOL``/``W_ATOL``): the same Adam
  steps from the same start, but gradients are reductions whose order
  differs (autograd's against XLA's) and XLA's CPU fusion rounds a few of
  the optimizer's operations under ``jit`` differently, so the weights
  drift by ulps a step. Measured after 60 epochs of 6 batches: 2.8e-7 on
  the logistic head. The MLP's weights are held after 20 epochs (at most
  1.7e-6 over seeds 0-5) and its loss after 60 (within 2.2e-6 relative):
  past that a ReLU unit's pre-activation can cross zero on one side
  only and the two trajectories part (from seed 3, by 5.5e-3 on w1
  after 60 epochs), as any two float32 trainings with different
  reduction orders may.

The MLP's initial weights come from the JAX package (``init_mlp`` with
threefry) and cross over through ``model_from_numpy``; the port's own
``init_mlp`` draws from a ``torch.Generator`` and does not reproduce
JAX's stream (ROADMAP Queue C). ``TestMeshTraining`` holds data-parallel
training to single-device training (``MESH_ATOL``; against JAX's mesh
training in tests/test_torch_parallel.py). Sizes are ``tests/test_models.py``'s; the
features pass is computed once per package in module fixtures.
``TestSynergy.test_head_beats_rating_baseline_iff_synergy_on`` runs two
6,000-step features passes on the CPU (~25 s each), so it lives in
``tests/test_torch_models_synergy.py``, where it runs beside this file.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp
from analyzer_tpu import models as jmodels
from analyzer_tpu.config import RatingConfig as JaxRatingConfig
from analyzer_tpu.core.state import PlayerState as JaxPlayerState
from analyzer_tpu.io import synthetic as jsynth
from analyzer_tpu.models import features as jfeatures
from analyzer_tpu.models import mlp as jmlp
from analyzer_tpu.models.training import train_minibatch as jax_train_minibatch
from analyzer_tpu.sched import MatchStream as JaxMatchStream
from analyzer_tpu.sched import pack_schedule as jax_pack_schedule
from analyzer_tpu_torch import models
from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.io import synthetic
from analyzer_tpu_torch.models import (
    N_FEATURES,
    EloConfig,
    LogisticModel,
    elo_history,
    history_features,
    model_from_numpy,
    train_logistic,
    train_mlp,
)
from analyzer_tpu_torch.models import calibration, features, logistic, mlp, training
from analyzer_tpu_torch.sched import pack_schedule

CFG = RatingConfig()
JCFG = JaxRatingConfig()
CPU = "cpu"
#: Data-parallel training against single-device training: the same Adam
#: steps on gradients summed in another order (each shard's masked mean,
#: weighted by its share of the minibatch, then summed), so float32
#: rounding of the reduction is all that may differ.
MESH_ATOL = 1e-5
ELO_ATOL, EXP_ATOL = 2e-3, 1e-5
FEAT_RTOL, FEAT_ATOL = 1e-5, 1e-5
W_RTOL, W_ATOL = 1e-4, 1e-5


def _jax_stream(stream):
    return JaxMatchStream(stream.player_idx, stream.winner, stream.mode_id,
                          stream.afk)


def _states(players, n):
    seeds = dict(
        rank_points_ranked=players.rank_points_ranked,
        rank_points_blitz=players.rank_points_blitz,
        skill_tier=players.skill_tier,
    )
    return (PlayerState.create(n, device=CPU, **seeds),
            JaxPlayerState.create(n, **seeds))


@pytest.fixture(scope="module")
def history():
    """tests/test_models.py's fixture, through both packages."""
    players = synthetic.synthetic_players(300, seed=21)
    stream = synthetic.synthetic_stream(
        3000, players, seed=21, afk_rate=0.0, unsupported_rate=0.0
    )
    state, jstate = _states(players, 300)
    sched = pack_schedule(stream, pad_row=state.pad_row)
    jsched = jax_pack_schedule(_jax_stream(stream), pad_row=jstate.pad_row)
    return players, stream, state, sched, jstate, jsched


@pytest.fixture(scope="module")
def feats(history):
    """Both packages' features pass over the fixture, computed once."""
    _players, _stream, state, sched, jstate, jsched = history
    table0 = state.table.clone()
    port = history_features(state, sched, CFG, device=CPU)
    assert torch.equal(state.table.isnan(), table0.isnan())
    assert torch.equal(state.table.nan_to_num(), table0.nan_to_num())
    return port, jmodels.history_features(jstate, jsched, JCFG)


@pytest.fixture(scope="module")
def elo(history):
    _players, _stream, _state, sched, _jstate, jsched = history
    return elo_history(sched, 300, device=CPU), jmodels.elo_history(jsched, 300)


class TestCopies:
    @pytest.mark.parametrize("kw", [
        dict(), dict(afk_rate=0.2, unsupported_rate=0.1),
    ], ids=["plain", "gated"])
    def test_synthetic_telemetry_equals_jax(self, kw):
        players = synthetic.synthetic_players(120, seed=9)
        stream = synthetic.synthetic_stream(700, players, seed=9, **kw)
        jplayers = jsynth.synthetic_players(120, seed=9)
        jstream = jsynth.synthetic_stream(700, jplayers, seed=9, **kw)
        for seed in (0, 9):
            got = synthetic.synthetic_telemetry(stream, players, seed=seed)
            want = jsynth.synthetic_telemetry(jstream, jplayers, seed=seed)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
        assert synthetic.TELEMETRY_STATS == jsynth.TELEMETRY_STATS
        assert synthetic.N_ITEM_BUILDS == jsynth.N_ITEM_BUILDS

    def test_telemetry_and_composition_features_equal_jax(self, history):
        players, stream, *_ = history
        tel = synthetic.synthetic_telemetry(stream, players, seed=21)
        got = features.telemetry_features(tel, stream.player_idx)
        want = jfeatures.telemetry_features(tel, stream.player_idx)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        got = features.composition_features(players.archetype, stream.player_idx)
        want = jfeatures.composition_features(players.archetype, stream.player_idx)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert (models.N_FEATURES, models.N_TELEMETRY_FEATURES) == (
            jmodels.N_FEATURES, jmodels.N_TELEMETRY_FEATURES)
        with pytest.raises(ValueError, match="telemetry must be"):
            features.telemetry_features(tel[..., :5], stream.player_idx)
        with pytest.raises(ValueError, match="archetype must be"):
            features.composition_features(players.archetype[:, None],
                                          stream.player_idx)

    def test_calibration_equals_jax(self):
        from analyzer_tpu.models import calibration as jcal

        rng = np.random.default_rng(7)
        z = rng.normal(0, 3.0, 5000)
        y = (rng.random(5000) < 1 / (1 + np.exp(-z / 2))).astype(np.float32)
        t = calibration.fit_temperature(z, y)
        assert t == jcal.fit_temperature(z, y)
        assert calibration.fit_temperature(z[:0], y[:0]) == 1.0
        assert np.array_equal(calibration.apply_temperature(z, t),
                              jcal.apply_temperature(z, t))

    def test_public_names_equal_jax(self):
        assert set(jmodels.__all__) <= set(models.__all__)
        assert set(models.__all__) - set(jmodels.__all__) == {"model_from_numpy"}


class TestEloParity:
    def test_ratings_and_predictions_within_tolerance(self, elo):
        (r, e), (jr, je) = elo
        assert r.dtype == np.float32 and r.shape == jr.shape
        np.testing.assert_allclose(r, jr, rtol=0, atol=ELO_ATOL)
        np.testing.assert_allclose(e, je, rtol=0, atol=EXP_ATOL)

    def test_windowed_and_packed_schedules_agree_bit_for_bit(self, history, elo):
        _players, stream, state, _sched, _js, _jsched = history
        win = pack_schedule(stream, pad_row=state.pad_row, windowed=True)
        r, e = elo_history(win, 300, device=CPU, steps_per_chunk=97)
        assert np.array_equal(r, elo[0][0]) and np.array_equal(e, elo[0][1])

    def test_pad_row_rules(self, history):
        _players, stream, *_ = history
        small = pack_schedule(stream, pad_row=300)
        with pytest.raises(ValueError, match="pad_row=300 < n_players=301"):
            elo_history(small, 301, device=CPU)
        # A larger schedule pad row is fine: masks derive from it, writes
        # park at the Elo table's own pad row (as in the JAX package).
        big = pack_schedule(stream, pad_row=400)
        jbig = jax_pack_schedule(_jax_stream(stream), pad_row=400)
        r, e = elo_history(big, 300, device=CPU)
        jr, je = jmodels.elo_history(jbig, 300)
        np.testing.assert_allclose(r, jr, rtol=0, atol=ELO_ATOL)
        np.testing.assert_allclose(e, je, rtol=0, atol=EXP_ATOL)

    def test_config_and_table(self):
        assert models.EloConfig() == EloConfig(1500.0, 32.0, 400.0)
        t = models.elo.create_elo_table(4, device=CPU)
        assert t.dtype == torch.float32 and t.tolist() == [1500.0] * 5

    def test_no_card_is_refused(self, history):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible: device=None runs on it")
        with pytest.raises(RuntimeError, match="CUDA"):
            elo_history(history[3], 300)


class TestFeaturesParity:
    def test_history_features_within_tolerance(self, feats):
        (f, rat, _), (jf, jrat, _) = feats
        assert f.dtype == np.float32 and f.shape == jf.shape
        np.testing.assert_array_equal(rat, jrat)
        np.testing.assert_array_equal(np.isnan(f), np.isnan(jf))
        np.testing.assert_array_equal(f[:, 4:], jf[:, 4:])  # mode one-hot
        np.testing.assert_allclose(f[:, :4], jf[:, :4], rtol=FEAT_RTOL,
                                   atol=FEAT_ATOL)

    def test_final_state_within_tolerance(self, feats):
        (_, _, final), (_, _, jfinal) = feats
        got, want = final.table.numpy(), np.asarray(jfinal.table)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-3)

    def test_match_features_on_one_batch(self):
        rng = np.random.default_rng(4)
        state, jstate = _states(jsynth.synthetic_players(40, seed=4), 40)
        table = state.table.numpy().copy()
        rated = rng.random(41) < 0.6
        table[rated, 0] = rng.uniform(500, 2500, rated.sum())
        table[rated, 7] = rng.uniform(50, 900, rated.sum())
        state = PlayerState.from_numpy(
            table, state.rank_points_ranked.numpy(),
            state.rank_points_blitz.numpy(), state.skill_tier.numpy(),
            device=CPU,
        )
        jstate = jstate.__class__(**{**vars(jstate), "table": jnp.asarray(table)})
        idx = rng.permutation(40)[:30].reshape(3, 2, 5).astype(np.int32)
        mask = np.ones((3, 2, 5), bool)
        mask[0, :, 3:] = False
        idx[~mask] = 40
        mode = np.array([0, 3, -1], np.int32)
        got = features.match_features(state, torch.from_numpy(idx),
                                      torch.from_numpy(mask),
                                      torch.from_numpy(mode), CFG).numpy()
        want = np.asarray(jfeatures.match_features(
            jstate, jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(mode), JCFG))
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:])
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=FEAT_RTOL,
                                   atol=1e-7)

    def test_schedule_of_another_table_is_refused(self, history):
        _players, stream, state, *_ = history
        other = pack_schedule(stream, pad_row=400)
        with pytest.raises(ValueError, match="pad_row=400"):
            history_features(state, other, CFG, device=CPU)


class TestAdamParity:
    def test_steps_equal_optax_op_by_op(self):
        """optax.adam's update and apply_updates, run eagerly, against
        ``adam_step_`` on the same gradients: bit for bit, five steps."""
        rng = np.random.default_rng(0)
        w0 = rng.normal(size=(64,)).astype(np.float32)
        b0 = np.float32(0.3)
        opt = optax.adam(0.05)
        jp = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
        jst = opt.init(jp)
        params = [torch.tensor(w0), torch.tensor(b0)]
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        bc1, bc2 = training.bias_corrections(5, CPU)
        for step in range(5):
            scale = (1e-3, 1.0, 10.0, 0.5, 3.0)[step]
            gw = (rng.normal(size=(64,)) * scale).astype(np.float32)
            gb = np.float32(rng.normal() * scale)
            upd, jst = opt.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)}, jst)
            jp = optax.apply_updates(jp, upd)
            training.adam_step_(params, [torch.tensor(gw), torch.tensor(gb)],
                                mu, nu, bc1[step], bc2[step], 0.05)
            assert np.array_equal(params[0].numpy(), np.asarray(jp["w"])), step
            assert np.array_equal(params[1].numpy(), np.asarray(jp["b"])), step

    def test_bias_correction_equals_optax(self):
        from optax import tree as otree

        bc1, bc2 = training.bias_corrections(3000, CPU)
        for t in (1, 2, 3, 10, 100, 999, 3000):
            one = jnp.ones((), jnp.float32)
            for got, b in ((bc1, 0.9), (bc2, 0.999)):
                want = np.asarray(otree.bias_correction(one, b, jnp.int32(t)))
                assert np.float32(1.0) / got[t - 1].numpy() == want, (t, b)


class TestTrainingParity:
    def test_logistic_equals_jax_within_tolerance(self, feats, history):
        (_, _, _), (jf, jrat, _) = feats
        y = (history[1].winner == 0).astype(np.float32)
        x = jf[jrat]
        model, nll = train_logistic(x, y[jrat], epochs=60, batch_size=512,
                                    device=CPU)
        jmodel, jnll = jmodels.train_logistic(x, y[jrat], epochs=60, batch_size=512)
        assert nll == pytest.approx(jnll, rel=W_RTOL)
        np.testing.assert_allclose(model.w.detach().numpy(), np.asarray(jmodel.w),
                                   rtol=W_RTOL, atol=W_ATOL)
        np.testing.assert_allclose(model.b.detach().numpy(), np.asarray(jmodel.b),
                                   rtol=W_RTOL, atol=W_ATOL)
        np.testing.assert_allclose(
            model.logits(x[:64]).detach().numpy(),
            np.asarray(jmodel.logits(jnp.asarray(x[:64]))), rtol=W_RTOL, atol=1e-4)

    def test_mlp_from_jax_init_equals_jax_within_tolerance(self, feats, history):
        seed = 3  # the seed whose 60-epoch weights part (module docstring)
        (_, _, _), (jf, jrat, _) = feats
        y = (history[1].winner == 0).astype(np.float32)
        x = jf[jrat]
        init = jmodels.init_mlp(x.shape[1], 32, seed=seed)
        arrays = {k: np.asarray(v) for k, v in vars(init).items()}
        for epochs in (20, 60):
            model, nll = training.train_minibatch(
                model_from_numpy("mlp", arrays, device=CPU), mlp._nll, x,
                y[jrat], epochs, 512, 1e-3, seed, device=CPU,
            )
            jmodel, jnll = jax_train_minibatch(init, jmlp._nll, x, y[jrat],
                                               epochs, 512, 1e-3, seed)
            assert nll == pytest.approx(jnll, rel=1e-5), epochs
            if epochs == 20:
                for k in ("w1", "b1", "w2", "b2", "w3", "b3"):
                    np.testing.assert_allclose(
                        getattr(model, k).detach().numpy(),
                        np.asarray(getattr(jmodel, k)),
                        rtol=W_RTOL, atol=W_ATOL, err_msg=k)

    def test_losses_equal_jax_on_the_same_model(self, feats, history):
        (_, _, _), (jf, jrat, _) = feats
        y = (history[1].winner == 0).astype(np.float32)
        x, yy = jf[jrat][:300], y[jrat][:300]
        m = np.ones(300, np.float32)
        m[-20:] = 0.0
        init = jmodels.init_mlp(x.shape[1], 16, seed=1)
        port = model_from_numpy("mlp", {k: np.asarray(v) for k, v in vars(init).items()},
                                device=CPU)
        got = mlp._nll(port, torch.tensor(x), torch.tensor(yy), torch.tensor(m))
        want = jmlp._nll(init, jnp.asarray(x), jnp.asarray(yy), jnp.asarray(m))
        assert got.detach().item() == pytest.approx(float(want), rel=1e-6)
        lw = jmodels.LogisticModel(w=jnp.asarray(np.linspace(-1, 1, x.shape[1],
                                                             dtype=np.float32)),
                                   b=jnp.asarray(np.float32(0.1)))
        lport = model_from_numpy("logistic", {"w": np.asarray(lw.w), "b": np.asarray(lw.b)},
                                 device=CPU)
        from analyzer_tpu.models import logistic as jlogistic

        got = logistic._nll(lport, torch.tensor(x), torch.tensor(yy), torch.tensor(m))
        want = jlogistic._nll(lw, jnp.asarray(x), jnp.asarray(yy), jnp.asarray(m))
        assert got.detach().item() == pytest.approx(float(want), rel=1e-6)

    def test_model_from_numpy_and_init(self):
        init = jmodels.init_mlp(10, 8, seed=0)
        arrays = {k: np.asarray(v) for k, v in vars(init).items()}
        arrays.update(model="mlp", temperature=1.5)
        m = model_from_numpy("mlp", arrays, device=CPU)
        assert [n for n, _ in m.named_parameters()] == list(vars(init))
        for k, v in vars(init).items():
            p = getattr(m, k)
            assert p.dtype == torch.float32 and np.array_equal(p.detach().numpy(),
                                                               np.asarray(v))
        with pytest.raises(ValueError, match="unknown model kind"):
            model_from_numpy("svm", arrays, device=CPU)
        a = models.init_mlp(10, 64, seed=5, device=CPU)
        b = models.init_mlp(10, 64, seed=5, device=CPU)
        c = models.init_mlp(10, 64, seed=6, device=CPU)
        assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
        assert not torch.equal(a.w1, c.w1)
        shapes = {k: tuple(getattr(a, k).shape) for k in arrays if k.startswith(("w", "b"))}
        assert shapes == {"w1": (10, 64), "b1": (64,), "w2": (64, 64), "b2": (64,),
                          "w3": (64, 1), "b3": (1,)}
        # He-normal scales, as JAX's: sqrt(2/F) and sqrt(2/H)
        assert a.w1.std().item() == pytest.approx((2 / 10) ** 0.5, rel=0.15)
        assert a.w2.std().item() == pytest.approx((2 / 64) ** 0.5, rel=0.1)
        assert not a.b1.any() and not a.b3.any()


class TestMeshTraining:
    def test_mesh_is_refused_naming_a14(self, feats, history):
        """``mesh=`` is ported: data-parallel training over 2 and 4 shards
        equals single-device training up to float32 reduction order (the
        JAX package's promise), held at ``MESH_ATOL``; the batch rounds up
        to a multiple of the shard count."""
        from analyzer_tpu_torch.parallel import make_mesh

        (f, rat, _), _ = feats
        y = (history[1].winner == 0).astype(np.float32)
        for fn in (train_logistic, train_mlp):
            # 511 rounds up to 512 on both meshes: the single-device run
            # at 512 makes the same minibatches.
            base, base_nll = fn(f[rat], y[rat], epochs=2, batch_size=512,
                                device=CPU)
            for d in (2, 4):
                got, nll = fn(f[rat], y[rat], epochs=2, batch_size=511,
                              mesh=make_mesh(d, device=CPU), device=CPU)
                assert nll == pytest.approx(base_nll, abs=MESH_ATOL)
                for (name, p), (_, q) in zip(got.named_parameters(),
                                             base.named_parameters()):
                    np.testing.assert_allclose(
                        p.detach().numpy(), q.detach().numpy(),
                        rtol=0, atol=MESH_ATOL, err_msg=name)


# -- tests/test_models.py, held on the port --------------------------------


class TestElo:
    def test_ratings_track_latent_skill(self, history, elo):
        players, stream, *_ = history
        ratings, _ = elo[0]
        played = np.zeros(300, bool)
        played[stream.player_idx[stream.player_idx >= 0]] = True
        corr = np.corrcoef(ratings[played], players.latent_skill[played])[0, 1]
        assert corr > 0.4, corr

    def test_predictions_beat_chance(self, history, elo):
        _players, stream, *_ = history
        _, expected = elo[0]
        half = stream.n_matches // 2
        sel = stream.ratable & (np.arange(stream.n_matches) >= half)
        acc = ((expected[sel] > 0.5) == (stream.winner[sel] == 0)).mean()
        assert acc > 0.55, acc

    def test_conservation(self, elo):
        ratings, _ = elo[0]
        total = ratings.sum()
        assert abs(total - 300 * 1500.0) < 1.0, total


class TestFeaturesAndHeads:
    def test_feature_shapes_and_sanity(self, history, feats):
        _players, stream, *_ = history
        f, ratable, _ = feats[0]
        assert f.shape == (stream.n_matches, N_FEATURES)
        assert np.isfinite(f).all()
        np.testing.assert_array_equal(ratable, stream.ratable)
        assert (f[:, 2] >= 0).all() and (f[:, 2] <= 1).all()
        sel = stream.mode_id >= 0
        assert np.allclose(f[sel, 4:].sum(1), 1.0)

    def test_sigma_feature_scale_mode_independent(self):
        state = PlayerState.create(10, skill_tier=np.full(10, 15, np.int32),
                                   device=CPU)
        idx3 = np.full((1, 2, 5), 10, np.int32)
        idx3[0, :, :3] = np.arange(6).reshape(2, 3)
        mask3 = np.array([[[1, 1, 1, 0, 0]] * 2], dtype=bool)
        idx5 = np.arange(10, dtype=np.int32).reshape(1, 2, 5)
        f3 = features.match_features(state, torch.from_numpy(idx3),
                                     torch.from_numpy(mask3),
                                     torch.tensor([1]), CFG)
        f5 = features.match_features(state, torch.from_numpy(idx5),
                                     torch.ones((1, 2, 5), dtype=torch.bool),
                                     torch.tensor([4]), CFG)
        np.testing.assert_allclose(f3[0, 1].item(), f5[0, 1].item(), rtol=1e-6)

    def test_ratable_mask_filters_gated_matches(self):
        players = synthetic.synthetic_players(100, seed=5)
        stream = synthetic.synthetic_stream(
            400, players, seed=5, afk_rate=0.2, unsupported_rate=0.1
        )
        state = PlayerState.create(100, skill_tier=players.skill_tier, device=CPU)
        sched = pack_schedule(stream, pad_row=state.pad_row)
        f, ratable, _ = history_features(state, sched, CFG, device=CPU)
        np.testing.assert_array_equal(ratable, stream.ratable)
        assert ratable.sum() < stream.n_matches
        jstate = JaxPlayerState.create(100, skill_tier=players.skill_tier)
        jf, jrat, _ = jmodels.history_features(
            jstate, jax_pack_schedule(_jax_stream(stream), pad_row=100), JCFG)
        np.testing.assert_array_equal(ratable, jrat)
        np.testing.assert_array_equal(f[:, 4:], jf[:, 4:])
        np.testing.assert_allclose(f[:, :4], jf[:, :4], rtol=FEAT_RTOL,
                                   atol=FEAT_ATOL)

    @pytest.mark.parametrize("head", ["logistic", "mlp"])
    def test_head_learns(self, history, feats, head):
        _players, stream, *_ = history
        f, ratable, _ = feats[0]
        y = (stream.winner == 0).astype(np.float32)
        if head == "logistic":
            model, nll = train_logistic(f[ratable], y[ratable], epochs=60,
                                        batch_size=512, device=CPU)
        else:
            model, nll = train_mlp(f[ratable], y[ratable], epochs=60,
                                   batch_size=512, hidden=32, device=CPU)
        assert np.isfinite(nll) and nll < 0.69, nll  # beats uninformed ln2
        p = model.predict(f[ratable]).detach().numpy()
        acc = ((p > 0.5) == (y[ratable] > 0.5)).mean()
        assert acc > 0.6, acc


class TestSynergy:
    def test_synergy_zero_is_backward_identical(self):
        players = synthetic.synthetic_players(200, seed=3)
        a = synthetic.synthetic_stream(800, players, seed=3)
        b = synthetic.synthetic_stream(800, players, seed=3, synergy_strength=0.0)
        for f in ("player_idx", "winner", "mode_id", "afk"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))

    def test_composition_features_represent_pair_synergy_exactly(self):
        players = synthetic.synthetic_players(100, seed=5)
        stream = synthetic.synthetic_stream(500, players, seed=5,
                                            synergy_strength=1.0)
        s = synthetic.synergy_matrix(5)
        f = features.composition_features(players.archetype, stream.player_idx)
        iu, ju = np.triu_indices(synthetic.N_ARCHETYPES)
        lin = f @ s[iu, ju]
        syn = synthetic._team_synergy(players.archetype, stream.player_idx, 5)
        cnt = (stream.player_idx >= 0).sum(axis=2)
        n_pairs = cnt * (cnt - 1) // 2
        expect = syn[:, 0] * n_pairs[:, 0] - syn[:, 1] * n_pairs[:, 1]
        np.testing.assert_allclose(lin, expect, rtol=1e-5, atol=1e-6)


class TestTelemetryHead:
    def test_telemetry_features_shape_and_masking(self, history):
        players, stream, *_ = history
        tel = synthetic.synthetic_telemetry(stream, players, seed=21)
        assert tel.shape == stream.player_idx.shape + (len(synthetic.TELEMETRY_STATS),)
        assert (tel[stream.player_idx < 0] == 0).all()
        f = models.telemetry_features(tel, stream.player_idx)
        assert models.N_TELEMETRY_FEATURES == 18
        assert f.shape == (stream.n_matches, models.N_TELEMETRY_FEATURES)
        assert np.isfinite(f).all()

    def test_telemetry_mlp_beats_rating_only(self, history, feats):
        players, stream, *_ = history
        f, ratable, _ = feats[0]
        tel = synthetic.synthetic_telemetry(stream, players, seed=21)
        tf = np.concatenate([f, models.telemetry_features(tel, stream.player_idx)],
                            axis=1)
        y = (stream.winner == 0).astype(np.float32)
        _, nll_rating = train_mlp(f[ratable], y[ratable], epochs=40,
                                  batch_size=512, hidden=32, device=CPU)
        model, nll_tel = train_mlp(tf[ratable], y[ratable], epochs=40,
                                   batch_size=512, hidden=32, device=CPU)
        assert nll_tel < nll_rating - 0.05, (nll_tel, nll_rating)
        p = model.predict(tf[ratable]).detach().numpy()
        acc = ((p > 0.5) == (y[ratable] > 0.5)).mean()
        assert acc > 0.8, acc


class TestCalibration:
    def test_temperature_fixes_overconfidence(self):
        rng = np.random.default_rng(3)
        n = 20000
        z_true = rng.normal(0, 1.2, n)
        y = (rng.random(n) < 1 / (1 + np.exp(-z_true))).astype(np.float32)
        logits = 4.0 * z_true
        t = models.fit_temperature(logits, y)
        assert 3.0 < t < 5.5, t

        def ece(p):
            idx = np.clip((p * 10).astype(int), 0, 9)
            return sum(
                abs(p[idx == b].mean() - y[idx == b].mean()) * (idx == b).mean()
                for b in range(10) if (idx == b).any()
            )

        raw = 1 / (1 + np.exp(-logits))
        cal = models.apply_temperature(logits, t)
        assert ece(cal) < ece(raw) / 3
        assert ((cal > 0.5) == (raw > 0.5)).all()

    def test_identity_when_already_calibrated(self):
        rng = np.random.default_rng(4)
        z = rng.normal(0, 1.5, 30000)
        y = (rng.random(30000) < 1 / (1 + np.exp(-z))).astype(np.float32)
        assert models.fit_temperature(z, y) == pytest.approx(1.0, abs=0.15)


def test_logistic_model_is_a_module_with_jax_names():
    m = LogisticModel(torch.zeros(3), torch.zeros(()))
    assert isinstance(m, torch.nn.Module)
    assert [n for n, _ in m.named_parameters()] == ["w", "b"]
    assert m.predict(np.ones((2, 3), np.float32)).tolist() == [0.5, 0.5]
