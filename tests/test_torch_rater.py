"""The port's object API (``analyzer_tpu_torch.rater``) against the
reference parity contract and against ``analyzer_tpu.rater``.

The assertions of ``tests/test_rater_parity.py`` (``worker_test.py:66-189``:
same fixtures, including the one Participant object aliased three times per
roster) hold against the port. The same object graphs then go through both
packages: gates, write-back order and which attributes are written are
exact; the floats agree within the tolerances ``tests/test_torch_ops.py``
states for the closed-form ops, because ``_rate_arrays`` is those ops on
``[1, 2, T]`` tensors: rtol 5e-6 on mu, 1e-6 on sigma, 2e-6 on quality (the
two libraries' erf/exp/log and their sum orders differ in the last bits).
``trueskill_delta`` is a difference of two conservative estimates, so it
takes the absolute error its four terms allow.
"""

import copy
import zlib

import numpy as np
import pytest

from analyzer_tpu import rater as jax_rater
from analyzer_tpu_torch import rater
from analyzer_tpu_torch.config import RatingConfig
from tests.fakes import fake_items, fake_match, fake_participant, fake_player, fake_roster

MU_RTOL, SIGMA_RTOL, QUALITY_RTOL = 5e-6, 1e-6, 2e-6


def rate(match, **kw):
    return rater.rate_match(match, device="cpu", **kw)


class TestSeedParity:
    def test_seed_from_skill_tier(self):
        mu, sigma = rater.get_trueskill_seed(fake_player(skill_tier=15))
        assert 1300 < mu - sigma < 1700

    def test_seed_from_rank_points(self):
        combos = [(2500, None), (2500, 100), (100, 2500), (None, 2500)]
        for ranked, blitz in combos:
            mu, sigma = rater.get_trueskill_seed(
                fake_player(skill_tier=0, rank_points_ranked=ranked,
                            rank_points_blitz=blitz)
            )
            assert mu - sigma == 2500, (ranked, blitz)

    def test_seed_zero_points_is_missing(self):
        mu, sigma = rater.get_trueskill_seed(
            fake_player(skill_tier=15, rank_points_ranked=0, rank_points_blitz=0)
        )
        assert 1300 < mu - sigma < 1700

    def test_seed_unknown_tier_raises(self):
        with pytest.raises(KeyError):
            rater.get_trueskill_seed(fake_player(skill_tier=30))

    @pytest.mark.parametrize("tier", range(-1, 30))
    def test_seed_equals_reference_exactly(self, tier):
        for ranked, blitz in [(None, None), (0, 0), (1234.5, None), (10, 2200)]:
            player = fake_player(skill_tier=tier, rank_points_ranked=ranked,
                                 rank_points_blitz=blitz)
            assert rater.get_trueskill_seed(player) == jax_rater.get_trueskill_seed(player)
        cfg = RatingConfig(unknown_player_sigma=321.0)
        from analyzer_tpu.config import RatingConfig as JaxConfig

        assert rater.get_trueskill_seed(fake_player(skill_tier=tier), cfg) == (
            jax_rater.get_trueskill_seed(
                fake_player(skill_tier=tier), JaxConfig(unknown_player_sigma=321.0)))


def _match(mode="ranked", **pkw):
    def participant():
        return fake_participant(player=fake_player(**pkw), items=fake_items())

    # [participant()] * 3: one object aliased three times, exactly like the
    # reference fixtures (worker_test.py:130-131).
    winners = fake_roster(True, [participant()] * 3)
    losers = fake_roster(False, [participant()] * 3)
    return fake_match(mode, [winners, losers])


class TestRateMatchParity:
    def test_rate_match(self):
        match = _match(skill_tier=15)
        rate(match)
        winner = match.rosters[0].participants[0].player[0]
        loser = match.rosters[1].participants[0].player[0]
        assert winner.trueskill_mu is not None
        assert winner.trueskill_ranked_mu is not None
        assert winner.trueskill_ranked_sigma < winner.trueskill_ranked_mu
        assert 500 < winner.trueskill_ranked_mu < 2500
        assert winner.trueskill_casual_mu is None
        assert winner.trueskill_mu > loser.trueskill_mu
        assert winner.trueskill_ranked_mu > loser.trueskill_ranked_mu

    def test_rate_match_returning(self):
        match = _match(trueskill_mu=2000, trueskill_sigma=100)
        rate(match)
        winner = match.rosters[0].participants[0].player[0]
        assert 1800 < winner.trueskill_ranked_mu < 2200

    def test_rate_match_afk(self):
        def participant():
            return fake_participant(player=fake_player(), went_afk=True)

        match = fake_match(
            "ranked",
            [fake_roster(True, [participant()] * 3),
             fake_roster(False, [participant()] * 3)],
        )
        rate(match)
        assert match.rosters[0].participants[0].player[0].trueskill_mu is None
        assert match.rosters[0].participants[0].participant_items[0].any_afk is True
        assert match.trueskill_quality == 0

    def test_unsupported_mode_untouched(self):
        match = _match(mode="aral", skill_tier=15)
        rate(match)
        assert match.rosters[0].participants[0].player[0].trueskill_mu is None
        assert match.trueskill_quality is None

    def test_invalid_roster_count(self):
        def participant():
            return fake_participant(player=fake_player(skill_tier=15))

        match = fake_match("ranked", [fake_roster(True, [participant()] * 3)])
        rate(match)
        assert match.trueskill_quality == 0
        assert match.rosters[0].participants[0].participant_items[0].any_afk is True
        assert match.rosters[0].participants[0].player[0].trueskill_mu is None

    def test_quality_and_delta(self):
        match = _match(skill_tier=15)
        rate(match)
        assert 0 < match.trueskill_quality < 1
        assert match.rosters[0].participants[0].trueskill_delta == 0

        def participant():
            return fake_participant(
                player=fake_player(trueskill_mu=2000, trueskill_sigma=100)
            )

        match3 = fake_match(
            "ranked",
            [fake_roster(True, [participant() for _ in range(3)]),
             fake_roster(False, [participant() for _ in range(3)])],
        )
        rate(match3)
        assert match3.rosters[0].participants[0].trueskill_delta > 0

    def test_five_v_five(self):
        def participant():
            return fake_participant(player=fake_player(skill_tier=10))

        match = fake_match(
            "5v5_ranked",
            [fake_roster(True, [participant() for _ in range(5)]),
             fake_roster(False, [participant() for _ in range(5)])],
        )
        rate(match)
        w = match.rosters[0].participants[0].player[0]
        l = match.rosters[1].participants[0].player[0]
        assert w.trueskill_5v5_ranked_mu > l.trueskill_5v5_ranked_mu
        assert w.trueskill_ranked_mu is None  # only the played mode is written

    def test_first_three_v_three_constant(self):
        """Fresh tier-15 players under the default config: the winner's
        shared mu is 2052.41 in float32, the constant the tensor path and
        the service path are cross-checked with."""
        def participant():
            return fake_participant(player=fake_player(skill_tier=15))

        match = fake_match(
            "ranked",
            [fake_roster(True, [participant() for _ in range(3)]),
             fake_roster(False, [participant() for _ in range(3)])],
        )
        rate(match, cfg=RatingConfig())
        assert round(match.rosters[0].participants[0].player[0].trueskill_mu, 2) == 2052.41

    def test_inconsistent_winner_flags_raise(self):
        for flags in ((True, True), (False, False)):
            def participant():
                return fake_participant(player=fake_player(skill_tier=15))

            match = fake_match(
                "ranked",
                [fake_roster(f, [participant() for _ in range(3)]) for f in flags],
            )
            with pytest.raises(ValueError, match="inconsistent winner flags"):
                rate(match)
            assert match.rosters[0].participants[0].player[0].trueskill_mu is None

    def test_unknown_tier_raises_before_any_write(self):
        match = _match(skill_tier=30)
        with pytest.raises(KeyError):
            rate(match)
        assert match.trueskill_quality is None

    def test_device_none_means_the_card(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible: nothing to refuse")
        with pytest.raises(RuntimeError, match="CUDA"):
            rater.rate_match(_match(skill_tier=15))

    def test_valid_matchup_is_logged(self):
        import logging

        seen = []
        handler = logging.Handler()
        handler.emit = lambda record: seen.append(record.getMessage())
        rater.logger.addHandler(handler)
        try:
            rate(_match(skill_tier=15))
        finally:
            rater.logger.removeHandler(handler)
        assert any(m.startswith("got a valid matchup") for m in seen)


_ATTRS = ("trueskill_mu", "trueskill_sigma", "trueskill_ranked_mu",
          "trueskill_ranked_sigma", "trueskill_casual_mu", "trueskill_5v5_ranked_mu",
          "trueskill_5v5_ranked_sigma", "trueskill_blitz_mu")


def _snapshot(match):
    """Every value rate_match may write, in traversal order."""
    out = [("quality", getattr(match, "trueskill_quality", None))]
    for ti, roster in enumerate(match.rosters):
        for si, p in enumerate(roster.participants):
            for name in ("trueskill_delta", "trueskill_mu", "trueskill_sigma"):
                out.append((f"p{ti}{si}.{name}", getattr(p, name, None)))
            for name in _ATTRS:
                out.append((f"player{ti}{si}.{name}", getattr(p.player[0], name, None)))
            items = p.participant_items[0]
            for name in ("any_afk", "trueskill_ranked_mu", "trueskill_ranked_sigma",
                         "trueskill_5v5_ranked_mu", "trueskill_blitz_mu"):
                out.append((f"items{ti}{si}.{name}", getattr(items, name, None)))
    return out


def _scenario(name, rng):
    def fresh(**kw):
        return fake_participant(player=fake_player(**kw), items=fake_items())

    def rated():
        kw = dict(trueskill_mu=float(rng.normal(1500, 400)),
                  trueskill_sigma=float(rng.uniform(60, 400)))
        if rng.random() < 0.5:
            kw["trueskill_ranked_mu"] = float(rng.normal(1500, 400))
            kw["trueskill_ranked_sigma"] = float(rng.uniform(60, 400))
        return fresh(**kw)

    if name == "aliased-fresh":
        return _match(skill_tier=15)
    if name == "aliased-returning":
        return _match(trueskill_mu=2000, trueskill_sigma=100)
    if name == "distinct-rated-3v3":
        return fake_match("ranked", [fake_roster(False, [rated() for _ in range(3)]),
                                     fake_roster(True, [rated() for _ in range(3)])])
    if name == "mixed-5v5":
        return fake_match("5v5_ranked", [
            fake_roster(True, [rated(), fresh(skill_tier=3), rated(),
                               fresh(rank_points_ranked=1800), rated()]),
            fake_roster(False, [fresh(skill_tier=29), rated(), rated(),
                                fresh(rank_points_blitz=900, skill_tier=4), rated()])])
    if name == "uneven-2v3-blitz":
        return fake_match("blitz", [fake_roster(True, [rated(), rated()]),
                                    fake_roster(False, [rated(), rated(), rated()])])
    if name == "upset":
        hi = dict(trueskill_mu=9000.0, trueskill_sigma=50.0)
        lo = dict(trueskill_mu=100.0, trueskill_sigma=50.0)
        return fake_match("ranked", [fake_roster(False, [fresh(**hi) for _ in range(3)]),
                                     fake_roster(True, [fresh(**lo) for _ in range(3)])])
    if name == "afk":
        m = fake_match("ranked", [fake_roster(True, [rated() for _ in range(3)]),
                                  fake_roster(False, [rated() for _ in range(3)])])
        m.rosters[1].participants[1].went_afk = 1
        return m
    if name == "unsupported":
        return _match(mode="aral", skill_tier=15)
    raise AssertionError(name)


@pytest.mark.parametrize("name", [
    "aliased-fresh", "aliased-returning", "distinct-rated-3v3", "mixed-5v5",
    "uneven-2v3-blitz", "upset", "afk", "unsupported",
])
def test_rate_match_equals_the_jax_package(name):
    match = _scenario(name, np.random.default_rng(zlib.crc32(name.encode())))
    theirs = copy.deepcopy(match)
    cfg = RatingConfig()
    rate(match, cfg=cfg)
    from analyzer_tpu.config import RatingConfig as JaxConfig

    jax_rater.rate_match(theirs, JaxConfig())
    got, want = _snapshot(match), _snapshot(theirs)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_k, w) in zip(got, want):
        if w is None or isinstance(w, bool) or isinstance(g, bool):
            assert g == w and type(g) is type(w), key  # gates: exact
        elif w == 0:
            assert g == 0, key  # quality=0 on AFK, delta=0 for fresh players
        elif key == "quality":
            assert g == pytest.approx(w, rel=QUALITY_RTOL, abs=1e-30), key
        elif key.endswith("trueskill_delta"):
            # (mu' - sigma') - (mu - sigma): the posterior terms carry the
            # relative errors above, at the size of this match's ratings
            scale = max(abs(v) for k, v in want
                        if v is not None and k.endswith(("_mu", "_sigma")))
            assert g == pytest.approx(w, abs=(MU_RTOL + SIGMA_RTOL) * scale), key
        elif key.endswith("sigma"):
            assert g == pytest.approx(w, rel=SIGMA_RTOL, abs=0), key
        else:
            assert g == pytest.approx(w, rel=MU_RTOL, abs=0), key
