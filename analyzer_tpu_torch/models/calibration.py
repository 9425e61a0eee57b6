"""Post-hoc temperature scaling for the sigmoid win-probability heads.

A single scalar T rescales the head's logits (``sigmoid(z / T)``) to
minimize NLL — the standard one-parameter calibration that fixes the
over/under-confidence an under-trained or over-trained head exhibits
without touching its ranking (accuracy and AUC are invariant under a
positive temperature; log-loss and calibration error improve). Fit T on
rows the head did NOT train on (the CLI reserves the chronological tail
of its train split): an overfit head's logits on its own training rows
look calibrated precisely when its eval logits are not.

The port's own copy of ``analyzer_tpu.models.calibration`` (numpy only):
the same temperature and probabilities, bit for bit.
"""

from __future__ import annotations

import math

import numpy as np


def fit_temperature(
    logits: np.ndarray,
    labels: np.ndarray,
    lo: float = 0.05,
    hi: float = 20.0,
    iters: int = 60,
) -> float:
    """Golden-section search for the NLL-minimizing temperature in
    ``[lo, hi]`` (log-domain; the NLL is smooth and unimodal in T).
    Deterministic, dependency-free, ~60 evaluations."""
    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels, np.float64)
    if logits.size == 0:
        return 1.0

    def nll(t: float) -> float:
        z = np.clip(logits / t, -30.0, 30.0)
        p = 1.0 / (1.0 + np.exp(-z))
        eps = 1e-12
        return float(
            -np.mean(
                labels * np.log(p + eps) + (1.0 - labels) * np.log(1.0 - p + eps)
            )
        )

    a, b = math.log(lo), math.log(hi)
    gr = (math.sqrt(5.0) - 1.0) / 2.0
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = nll(math.exp(c)), nll(math.exp(d))
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = nll(math.exp(c))
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = nll(math.exp(d))
    return math.exp((a + b) / 2.0)


def apply_temperature(logits: np.ndarray, temperature: float) -> np.ndarray:
    """``sigmoid(logits / T)`` as float64 probabilities."""
    z = np.clip(np.asarray(logits, np.float64) / temperature, -30.0, 30.0)
    return 1.0 / (1.0 + np.exp(-z))
