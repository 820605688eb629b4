"""PyTorch/CUDA port of the HAS-GPU serving stack.

The JAX package ``repro`` stays the reference; this package imports
nothing of it (and never ``jax``). Sub-packages mirror ``repro``'s
layout. Kernels are hand-written CUDA for Hopper (``kernels/csrc``),
compiled with ``nvcc`` at first use; on CPU tensors every kernel wrapper
runs its plain PyTorch version instead.
"""
