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

    ``mesh`` (a :class:`~analyzer_tpu_torch.parallel.mesh.Mesh` of D
    shards) trains DATA-PARALLEL, as the JAX package's GSPMD partition
    does: the batch size is rounded up to a multiple of D and every
    minibatch splits into D equal slices; each process takes the gradient
    of its shards' slices (each slice's masked mean weighted by its share
    of the minibatch's real rows, so the slices sum to the minibatch's
    masked mean), sums its shards in shard order, and one
    ``all_reduce(SUM)`` adds the processes' sums — the psum GSPMD inserts.
    Every process then applies the same Adam step to its replica. The
    result equals single-device training up to float32 reduction order,
    the JAX package's promise too."""
    if mesh is not None:
        n_dev = mesh.n_shards
        batch_size = -(-batch_size // n_dev) * n_dev
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
            if mesh is None:
                loss = loss_fn(model, xb[b], yb[b], mb[b])
                grads = torch.autograd.grad(loss, params)
            else:
                loss, grads = _sharded_grad(
                    model, loss_fn, params, xb[b], yb[b], mb[b], mesh
                )
            adam_step_(params, grads, mu, nu, bc1[step], bc2[step], lr)
            losses[e, b] = loss.detach()
            step += 1
    return model, float(losses[-1].mean())


def _sharded_grad(model, loss_fn, params, x, y, m, mesh):
    """(loss, grads) of one minibatch, data-parallel over ``mesh``: this
    process's shards' weighted slice gradients summed in shard order, then
    summed across processes in one ``all_reduce``."""
    shard = x.shape[0] // mesh.n_shards
    total = torch.clamp(m.sum(), min=1.0)
    loss = None
    grads = None
    for d in mesh.local_shards:
        sl = slice(d * shard, (d + 1) * shard)
        weight = m[sl].sum() / total  # the slice's share of the real rows
        part = loss_fn(model, x[sl], y[sl], m[sl]) * weight
        g = torch.autograd.grad(part, params)
        if grads is None:
            loss, grads = part.detach(), [gi.detach() for gi in g]
        else:
            loss = loss + part.detach()
            grads = [a + gi for a, gi in zip(grads, g)]
    if mesh.distributed:
        flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
        mesh.all_reduce_(flat)
        loss = flat[0]
        out, off = [], 1
        for g in grads:
            out.append(flat[off: off + g.numel()].view_as(g))
            off += g.numel()
        grads = out
    return loss, grads
