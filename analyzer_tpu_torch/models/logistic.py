"""Logistic win-probability head (BASELINE.json config 3).

Counterpart of ``analyzer_tpu.models.logistic``: one sigmoid over the
match features, trained with the JAX package's Adam harness
(``models/training.py``) over static-shape minibatches. The label is
"team 0 won"; the model calibrates the TrueSkill-derived features against
observed outcomes (how much rating gap actually predicts a win per mode).
"""

from __future__ import annotations

import numpy as np
import torch

from analyzer_tpu_torch.models.training import train_minibatch


class LogisticModel(torch.nn.Module):
    """``w [F]``, ``b []`` float32 — the JAX dataclass's names and shapes."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor) -> None:
        super().__init__()
        self.w = torch.nn.Parameter(w)
        self.b = torch.nn.Parameter(b)

    def logits(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.w.dtype, device=self.w.device)
        return x @ self.w + self.b

    def predict(self, x) -> torch.Tensor:
        """P(team 0 wins), ``[B]`` for ``x [B, F]``."""
        return torch.sigmoid(self.logits(x))


def _nll(model: LogisticModel, x, y, mask):
    p = torch.clamp(model.predict(x), 1e-7, 1 - 1e-7)
    ll = y * torch.log(p) + (1 - y) * torch.log1p(-p)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def train_logistic(
    features: np.ndarray,
    team0_won: np.ndarray,
    epochs: int = 30,
    batch_size: int = 4096,
    lr: float = 0.05,
    seed: int = 0,
    mesh=None,
    device=None,
) -> tuple[LogisticModel, float]:
    """Trains on ``[N, F]`` features on ``device`` (None = the card);
    returns (model, final mean NLL). ``mesh`` waits for ROADMAP A14."""
    f = features.shape[1]
    model = LogisticModel(
        w=torch.zeros((f,), dtype=torch.float32),
        b=torch.zeros((), dtype=torch.float32),
    )
    return train_minibatch(
        model, _nll, features, team0_won, epochs, batch_size, lr, seed,
        mesh=mesh, device=device,
    )
