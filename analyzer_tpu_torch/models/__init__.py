"""Rating and win-probability model zoo (BASELINE.json configs 1, 3, 4).

Counterpart of ``analyzer_tpu.models``: an Elo pairwise rater over the
TrueSkill schedule, leak-free rating features, and a logistic and an MLP
win-probability head trained with the JAX package's Adam harness, plus
post-hoc temperature calibration. The heads are ``nn.Module``s whose
parameters carry the JAX package's names and shapes;
:func:`model_from_numpy` builds one from a dict of arrays with those keys
(``{k: np.asarray(v) for k, v in vars(jax_model).items()}``, or either
package's ``cli train --out`` file).
"""

from analyzer_tpu_torch.models.elo import EloConfig, elo_history, elo_rate_batch
from analyzer_tpu_torch.models.features import (
    N_FEATURES,
    N_TELEMETRY_FEATURES,
    history_features,
    match_features,
    telemetry_features,
)
from analyzer_tpu_torch.models.calibration import apply_temperature, fit_temperature
from analyzer_tpu_torch.models.logistic import LogisticModel, train_logistic
from analyzer_tpu_torch.models.mlp import MLPModel, init_mlp, train_mlp

#: Parameter names per model kind, in the JAX dataclasses' field order.
MODEL_KEYS = {
    "logistic": ("w", "b"),
    "mlp": ("w1", "b1", "w2", "b2", "w3", "b3"),
}


def model_from_numpy(kind: str, arrays, device=None):
    """The port's ``kind`` model (``"logistic"`` or ``"mlp"``) holding
    exactly ``arrays[k]`` (float32) for each of its parameter names, on
    ``device`` (None = the card). Other keys (``model``, ``temperature``
    in a ``cli train --out`` file) are ignored."""
    import numpy as np
    import torch

    from analyzer_tpu_torch.device import resolve_device

    if kind not in MODEL_KEYS:
        raise ValueError(f"unknown model kind {kind!r}; one of {sorted(MODEL_KEYS)}")
    dev = resolve_device(device)
    params = {
        k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(dev)
        for k in MODEL_KEYS[kind]
    }
    cls = LogisticModel if kind == "logistic" else MLPModel
    return cls(**params)


__all__ = [
    "EloConfig",
    "elo_history",
    "elo_rate_batch",
    "match_features",
    "history_features",
    "N_FEATURES",
    "N_TELEMETRY_FEATURES",
    "telemetry_features",
    "apply_temperature",
    "fit_temperature",
    "LogisticModel",
    "train_logistic",
    "MLPModel",
    "init_mlp",
    "train_mlp",
    "model_from_numpy",
]
