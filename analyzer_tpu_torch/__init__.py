"""PyTorch + CUDA port of ``analyzer_tpu`` for one NVIDIA Hopper card.

The JAX package ``analyzer_tpu`` stays the reference; this package mirrors
its module layout (``core``, ``ops``, ``io``, ``sched``, ``serve``,
``obs``, ``rater``, ``cli``) so each function has an obvious counterpart,
and writes the JAX package's TPU kernels (the fused rating window, the
scatter floor's row scatter) by hand in CUDA C++ for ``sm_90a``
(``kernels/``). It imports neither ``jax`` nor anything under
``analyzer_tpu``: what it needs from the jax-free modules there
(``config``, ``native_build``, ``logging_utils``, the ``obs`` registry,
tracer and HTTP plumbing) it keeps as its own copies.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do); see :func:`analyzer_tpu_torch.device.
resolve_device`.
"""
