"""Numerically stable standard-normal helpers for rating updates (float32).

Counterpart of ``analyzer_tpu.ops.normal``. v(t) = phi(t)/Phi(t) is taken
in log space, ``exp(log_pdf(t) - log_ndtr(t))``, so it stays finite where
Phi(t) underflows in float32, and w(t) = v(v + t) is clamped into [0, 1]
with the asymptotic Mills-ratio tail below t = -10.

``log_ndtr`` is NOT ``torch.special.log_ndtr``: that one differs from
``jax.scipy.special.log_ndtr`` in float32. This module writes JAX's float32
formula out of ``erf``, ``erfc`` and ``log`` with the same branches
(segments at -10 and 5; ``-ndtr(-x)`` above 5; ``log(ndtr(max(x, -10)))``
between; the 3-term asymptotic series below -10) and ``ndtr`` through
``erf``/``erfc`` exactly as ``jax.scipy.special.ndtr`` does. The CUDA
kernel carries the same formula with ``erff``/``erfcf``/``logf``
(``kernels/csrc/rate_match.cuh``). Every branch is evaluated and selected
with ``torch.where`` on clamped inputs, as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch

# float32 values of the constants JAX uses, held as Python floats that are
# exactly representable in float32 (so the scalar casts inside torch ops
# are exact).
_LOG_SQRT_2PI = float(np.float32(0.9189385332046727))  # log(sqrt(2*pi))
_HALF_SQRT_2 = float(np.float32(0.5) * np.sqrt(np.float32(2.0)))
_LOWER = -10.0  # JAX's float32 lower segment
_UPPER = 5.0  # JAX's float32 upper segment


def log_pdf(t: torch.Tensor) -> torch.Tensor:
    return -0.5 * t * t - _LOG_SQRT_2PI


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """Phi(x) as ``jax.scipy.special.ndtr``: 1 + erf(w) near 0, else
    2 - erfc(|w|) (w > 0) or erfc(|w|), with w = x / sqrt(2)."""
    w = x * _HALF_SQRT_2
    z = w.abs()
    y = torch.where(
        z < _HALF_SQRT_2,
        1.0 + torch.erf(w),
        torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)),
    )
    return 0.5 * y


def _log_ndtr_lower(x: torch.Tensor) -> torch.Tensor:
    """The asymptotic series for log Phi(x), x << -1 (series order 3)."""
    x2 = x * x
    log_scale = -0.5 * x2 - torch.log(-x) - _LOG_SQRT_2PI
    odd = 1.0 / x2
    x4 = x2 * x2
    even = 3.0 / x4
    odd = odd + 15.0 / (x4 * x2)
    return log_scale + torch.log(1.0 + even - odd)


def log_ndtr(x: torch.Tensor) -> torch.Tensor:
    """log Phi(x) by JAX's float32 formula (segments at -10 and 5)."""
    return torch.where(
        x > _UPPER,
        -ndtr(-x),
        torch.where(
            x > _LOWER,
            torch.log(ndtr(torch.clamp(x, min=_LOWER))),
            _log_ndtr_lower(torch.clamp(x, max=_LOWER)),
        ),
    )


def cdf(t: torch.Tensor) -> torch.Tensor:
    return ndtr(t)


def v_win(t: torch.Tensor) -> torch.Tensor:
    """phi(t)/Phi(t), stable for arbitrarily negative t."""
    return torch.exp(log_pdf(t) - log_ndtr(t))


def w_win(t: torch.Tensor, v: torch.Tensor | None = None) -> torch.Tensor:
    """w(t) = v(t) * (v(t) + t), the variance-shrink factor, in [0, 1].

    Direct form clamped into [0, 1] for t > -10; the asymptotic series
    w = 1 - 1/t^2 + 6/t^4 at t <= -10, where the direct form cancels."""
    if v is None:
        v = v_win(t)
    direct = torch.clamp(v * (v + t), 0.0, 1.0)
    # Guard the unselected lane: 1/t^2 at t=0 would be Inf.
    tg = torch.where(t <= _LOWER, t, torch.full_like(t, _LOWER))
    t2 = tg * tg
    tail = 1.0 - 1.0 / t2 + 6.0 / (t2 * t2)
    return torch.where(t <= _LOWER, tail, direct)
