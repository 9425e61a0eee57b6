"""``tests/test_models.py::TestSynergy::test_head_beats_rating_baseline_iff_synergy_on``
held on the port: its two 6,000-match histories through the port's
features pass (6,000 steps each on the CPU, ~25 s apiece) and logistic
head. It sits apart from ``tests/test_torch_models.py`` (which holds the
rest of ``tests/test_models.py``) only so the two files run side by side.
The margins are the JAX test's bounds on the port's own numbers.
"""

import numpy as np

from analyzer_tpu_torch.config import RatingConfig
from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.io import synthetic
from analyzer_tpu_torch.models import features, history_features, train_logistic
from analyzer_tpu_torch.sched import pack_schedule

CFG = RatingConfig()
CPU = "cpu"


def _state(players, n):
    return PlayerState.create(
        n, rank_points_ranked=players.rank_points_ranked,
        rank_points_blitz=players.rank_points_blitz,
        skill_tier=players.skill_tier, device=CPU,
    )


class TestSynergy:
    def test_head_beats_rating_baseline_iff_synergy_on(self):
        def margin(strength):
            players = synthetic.synthetic_players(400, seed=11)
            stream = synthetic.synthetic_stream(
                6000, players, seed=11, afk_rate=0.0,
                unsupported_rate=0.0, synergy_strength=strength,
            )
            state = _state(players, 400)
            sched = pack_schedule(stream, pad_row=state.pad_row, windowed=True)
            f, ratable, _ = history_features(state, sched, CFG, device=CPU)
            x = np.concatenate(
                [f, features.composition_features(players.archetype,
                                                  stream.player_idx)], axis=1)
            y = (stream.winner == 0).astype(np.float32)
            rows = np.flatnonzero(ratable)
            cut = int(rows.size * 0.8)
            tr, ev = rows[:cut], rows[cut:]
            eps = 1e-7

            def ll(p, yy):
                return float(
                    -np.mean(yy * np.log(p + eps) + (1 - yy) * np.log(1 - p + eps))
                )

            model, _ = train_logistic(x[tr], y[tr], epochs=60, seed=0, device=CPU)
            p = 1.0 / (1.0 + np.exp(-model.logits(x[ev]).detach().numpy()))
            return ll(f[ev, 2].astype(np.float64), y[ev]) - ll(p, y[ev])

        assert margin(2.0) > 0.008  # head beats the baseline
        assert margin(0.0) > -0.008  # control: at worst a tie


