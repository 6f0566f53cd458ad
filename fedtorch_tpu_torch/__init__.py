"""fedtorch_tpu_torch — the PyTorch/CUDA port of ``fedtorch_tpu``.

The JAX package stays the reference; this package runs the same
federated round on an NVIDIA H100 with PyTorch for the plain tensor
code and hand-written Hopper kernels where the JAX package had Pallas
kernels (``ops/cuda``, sources under ``csrc/``). It imports nothing of
``fedtorch_tpu`` and never JAX: what it needs of the JAX package's
jax-free modules (``config``) it keeps as its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without that request they raise.
"""
