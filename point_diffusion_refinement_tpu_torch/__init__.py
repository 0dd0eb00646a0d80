"""Point Diffusion-Refinement in PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

A port of the JAX package ``point_diffusion_refinement_tpu``, which stays the
reference.  The module layout mirrors it (``config``, ``models``,
``diffusion``, ``sample``, ``ops``, ``utils``) so each counterpart is easy to
find.  Tensors are channels-last (B, M, K, C) at every public function, like
the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise.  Every neighbourhood op has a
CUDA kernel under ``csrc/`` (built with ``nvcc`` at first use) and a plain
PyTorch version beside it, which runs only for tensors on the CPU.
"""

__version__ = "0.1.0"
