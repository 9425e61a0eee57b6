"""Shared minibatch training harness for the win-probability heads.

Counterpart of ``analyzer_tpu.models.training``: one implementation of
the pad-to-static-shape, permute, and epoch/step loop, parameterized by
model and loss, so the logistic and MLP heads are drop-in comparable
(same batching, same masking, same optimizer step).

The optimizer is the JAX package's ``optax.adam(lr)`` at optax 0.2.6's
defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), written out in optax's
order — ``scale_by_adam`` (moments, then ``bias_correction`` at the
incremented count, then ``m / (sqrt(v + eps_root) + eps)``), then
``scale_by_learning_rate`` (``* -lr``), then ``apply_updates`` — on
float32 tensors, gradients from ``torch.autograd``. ``torch.optim.Adam``
rounds differently (it folds the bias corrections into one step size) and
is not used. Under ``jit`` XLA's CPU fusion rounds a few of these
operations differently again; optax run op by op equals this step bit for
bit (``tests/test_torch_models.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from analyzer_tpu_torch.device import resolve_device

#: optax.adam's defaults (optax 0.2.6, ``optax/_src/alias.py``).
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0

A14 = "ROADMAP A14, parallel"


def bias_corrections(n_steps: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``1 - b**t`` for t = 1..n_steps, float32, as optax's
    ``tree.bias_correction`` takes it: ``decay ** count`` with a Python
    float decay and an int32 count promotes to float32, so the power is a
    float32 ``pow``. Computed once on the CPU (so the card's run uses the
    same values) and moved to ``device`` as ``[n_steps]`` tensors: each
    step divides by a device element, never by a host scalar (CUDA turns
    a division by a CPU scalar into a multiply by its reciprocal)."""
    t = torch.arange(1, n_steps + 1, dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)
    bc1 = one - torch.pow(torch.tensor(B1, dtype=torch.float32), t)
    bc2 = one - torch.pow(torch.tensor(B2, dtype=torch.float32), t)
    return bc1.to(device), bc2.to(device)


@torch.no_grad()
def adam_step_(params, grads, mu, nu, bc1, bc2, lr: float) -> None:
    """One ``optax.adam(lr)`` step, in place on ``params``/``mu``/``nu``.
    ``bc1``/``bc2`` are this step's bias corrections (0-d tensors on the
    parameters' device)."""
    for p, g, m, v in zip(params, grads, mu, nu):
        m.copy_((1 - B1) * g + B1 * m)  # optax.tree.update_moment, order 1
        v.copy_((1 - B2) * (g * g) + B2 * v)  # update_moment_per_elem_norm
        m_hat = m / bc1
        v_hat = v / bc2
        upd = m_hat / (torch.sqrt(v_hat + EPS_ROOT) + EPS)
        p.copy_(p + (-lr) * upd)  # scale_by_learning_rate, apply_updates


def train_minibatch(
    model: torch.nn.Module,
    loss_fn,
    features: np.ndarray,
    labels: np.ndarray,
    epochs: int,
    batch_size: int,
    lr: float,
    seed: int,
    mesh=None,
    device=None,
):
    """Adam over epochs of minibatches. ``loss_fn(model, x, y, mask)`` must
    be a masked mean so the static-shape padding rows contribute nothing.
    One permutation (``np.random.default_rng(seed)``) of the padded rows
    makes the batches, and every epoch visits them in that order. Each
    step's loss is taken before its update. Returns (trained model, the
    mean of the last epoch's batch losses). ``model`` is moved to
    ``device`` (None = the card) and trained in place.

    ``mesh`` (data-parallel training) waits for ROADMAP A14."""
    if mesh is not None:
        raise NotImplementedError(
            f"data-parallel training (mesh=) is not ported yet ({A14}); "
            "train on one device (mesh=None)"
        )
    dev = resolve_device(device)
    n, f = features.shape
    n_batches = max(1, -(-n // batch_size))
    padded = n_batches * batch_size
    x = np.zeros((padded, f), np.float32)
    y = np.zeros((padded,), np.float32)
    m = np.zeros((padded,), np.float32)
    x[:n] = features
    y[:n] = labels
    m[:n] = 1.0

    rng = np.random.default_rng(seed)
    perm = rng.permutation(padded)
    xb = torch.from_numpy(x[perm].reshape(n_batches, batch_size, f)).to(dev)
    yb = torch.from_numpy(y[perm].reshape(n_batches, batch_size)).to(dev)
    mb = torch.from_numpy(m[perm].reshape(n_batches, batch_size)).to(dev)

    model = model.to(dev)
    params = list(model.parameters())
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    bc1, bc2 = bias_corrections(epochs * n_batches, dev)
    losses = torch.zeros((max(epochs, 1), n_batches), dtype=torch.float32,
                         device=dev)
    step = 0
    for e in range(epochs):
        for b in range(n_batches):
            loss = loss_fn(model, xb[b], yb[b], mb[b])
            grads = torch.autograd.grad(loss, params)
            adam_step_(params, grads, mu, nu, bc1[step], bc2[step], lr)
            losses[e, b] = loss.detach()
            step += 1
    return model, float(losses[-1].mean())
