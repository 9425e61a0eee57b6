"""A whole run of each cell at a tiny size on the CPU (the harness's look
for a card skipped), once sound and once with the timed path broken
underneath: ``correct`` has to come out true, then false for each fault
the cell can have."""

import pytest
import torch

from _tiny import SECONDS, TINY, spec_for
from portbench import run

RATING_CELLS = ["history10m.stream_fused", "history10m.stream_reference",
                "live1m.worker_backlog"]


def _run(workload):
    return run.run_cell(workload, 2**32 + 5, SECONDS, False, device="cpu",
                        overrides=TINY[workload], t_start=0.0,
                        spec=spec_for(workload))


def _patch_rating(monkeypatch, fault):
    """Breaks the rating step where every runner and the worker reach it
    (``core.update.rate_gathered``, ``ops.trueskill.two_team_update``)."""
    from analyzer_tpu_torch.core import update
    from analyzer_tpu_torch.ops import trueskill

    real_gathered, real_update = update.rate_gathered, trueskill.two_team_update

    def gathered(rows, batch, cfg):
        out = real_gathered(rows, batch, cfg)
        if fault == "unchanged":  # the step returns its state unchanged
            out.new_rows = rows.clone()
        elif fault == "half":  # half of the batch left out
            keep = torch.arange(out.updated.shape[0]) % 2 == 0
            out.updated = out.updated & keep.to(out.updated.device)
        return out

    def altered(mu, sigma, mask, winner, cfg):
        new_mu, new_sigma = real_update(mu, sigma, mask, winner, cfg)
        return new_mu + 0.5 * mask.to(new_mu.dtype), new_sigma

    monkeypatch.setattr(update, "rate_gathered", gathered)
    if fault == "altered":  # an answer altered where it is produced
        monkeypatch.setattr(trueskill, "two_team_update", altered)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", RATING_CELLS)
def test_broken_rating_is_not_correct(monkeypatch, workload, fault):
    _patch_rating(monkeypatch, fault)
    out = _run(workload)
    assert out["correct"] is False, out["checks"]
