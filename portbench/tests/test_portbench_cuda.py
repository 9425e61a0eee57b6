"""On the card: each cell's whole run at a reduced size, sound and with a
fault. Run there with

    python -m pytest -m cuda portbench/tests/test_portbench_cuda.py

Skipped, with a reason, where no card is present (decided inside the
test)."""

import pytest

from _tiny import TINY, spec_for
from portbench import control, run


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_on_the_card(workload):
    _need_card()
    out = run.run_cell(workload, 2**31 + 99, 2.0, True, device="cuda",
                       overrides=TINY[workload], t_start=0.0, spec=spec_for(workload))
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_on_the_card(workload):
    _need_card()
    got = control.control_cell(workload, 2**31 + 98, 1.0, "cuda", TINY[workload],
                               spec=spec_for(workload))
    assert all(v <= got["limits"][k] for k, v in got["program"].items())
    assert any(v > got["limits"][k] for k, v in got["control"].items()
               if k in got["limits"])
