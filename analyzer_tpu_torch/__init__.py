"""PyTorch + CUDA port of ``analyzer_tpu`` for one NVIDIA Hopper card.

The JAX package ``analyzer_tpu`` stays the reference; this package mirrors
its module layout (``core``, ``ops``, ``io``, ``sched``) so each function
has an obvious counterpart, and writes the JAX package's one TPU kernel
(the fused rating window) by hand in CUDA C++ for ``sm_90a``
(``kernels/``). It imports neither ``jax`` nor anything under
``analyzer_tpu``: what it needs from the jax-free modules there
(``config``, ``native_build``) it keeps as its own copies.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do); see :func:`analyzer_tpu_torch.device.
resolve_device`.
"""
