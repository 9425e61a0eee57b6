"""MLP match-outcome predictor (BASELINE.json config 4).

Counterpart of ``analyzer_tpu.models.mlp``: two ReLU layers over the match
features (extensible to full telemetry — items, gold, KDA — by widening
the feature vector), trained with the same harness as the logistic head
so the two are drop-in comparable on log-loss. The weights keep JAX's
``[in, out]`` layout (``x @ w1 + b1``), not ``nn.Linear``'s ``[out, in]``,
so a model carries across the packages unchanged. The matrix products are
plain ``torch.matmul``; TF32 stays off (``torch.backends.cuda.matmul.
allow_tf32`` False, float32 matmul precision "highest"), so the card
trains in full float32 as the CPU does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from analyzer_tpu_torch.models.training import train_minibatch

_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


class MLPModel(torch.nn.Module):
    """``w1 [F,H]``, ``b1 [H]``, ``w2 [H,H]``, ``b2 [H]``, ``w3 [H,1]``,
    ``b3 [1]`` float32 — the JAX dataclass's names, shapes and order."""

    def __init__(self, w1, b1, w2, b2, w3, b3) -> None:
        super().__init__()
        for name, t in zip(_NAMES, (w1, b1, w2, b2, w3, b3)):
            setattr(self, name, torch.nn.Parameter(t))

    def logits(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.w1.dtype, device=self.w1.device)
        h = torch.relu(x @ self.w1 + self.b1)
        h = torch.relu(h @ self.w2 + self.b2)
        return (h @ self.w3 + self.b3)[..., 0]

    def predict(self, x) -> torch.Tensor:
        """P(team 0 wins), ``[B]``."""
        return torch.sigmoid(self.logits(x))


def init_mlp(
    n_features: int, hidden: int = 64, *, seed: int, device=None
) -> MLPModel:
    """He-normal weights (JAX's scales: ``sqrt(2/F)`` for w1, ``sqrt(2/H)``
    for w2 and w3), zero biases, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` — so the card and the CPU
    start from the same weights — then moved to ``device`` (None = the
    card). ``jax.random``'s threefry stream is not reproduced, so these
    initial weights differ from the JAX package's for the same seed
    (``model_from_numpy`` carries JAX's across)."""
    from analyzer_tpu_torch.device import resolve_device

    # ``seed`` is required at the mint site: a defaulted seed would hand
    # every caller that omits it the same weight stream.
    gen = torch.Generator().manual_seed(seed)
    s1 = (2.0 / n_features) ** 0.5
    s2 = (2.0 / hidden) ** 0.5
    f32 = torch.float32
    model = MLPModel(
        w1=torch.randn((n_features, hidden), generator=gen, dtype=f32) * s1,
        b1=torch.zeros((hidden,), dtype=f32),
        w2=torch.randn((hidden, hidden), generator=gen, dtype=f32) * s2,
        b2=torch.zeros((hidden,), dtype=f32),
        w3=torch.randn((hidden, 1), generator=gen, dtype=f32) * s2,
        b3=torch.zeros((1,), dtype=f32),
    )
    return model.to(resolve_device(device))


def _nll(model: MLPModel, x, y, mask):
    """Masked mean of optax's ``sigmoid_binary_cross_entropy`` in its
    ``log_sigmoid`` form."""
    z = model.logits(x)
    bce = -y * F.logsigmoid(z) - (1.0 - y) * F.logsigmoid(-z)
    ll = -bce
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def train_mlp(
    features: np.ndarray,
    team0_won: np.ndarray,
    hidden: int = 64,
    epochs: int = 30,
    batch_size: int = 4096,
    lr: float = 1e-3,
    seed: int = 0,
    mesh=None,
    device=None,
) -> tuple[MLPModel, float]:
    """Trains on ``[N, F]`` features on ``device`` (None = the card);
    returns (model, final mean NLL). ``mesh`` trains data-parallel over its shards
    (models.training)."""
    model = init_mlp(features.shape[1], hidden, seed=seed, device="cpu")
    return train_minibatch(
        model, _nll, features, team0_won, epochs, batch_size, lr, seed,
        mesh=mesh, device=device,
    )
