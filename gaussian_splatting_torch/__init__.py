"""PyTorch/CUDA port of the 3D Gaussian Splatting renderer.

The JAX/Pallas package ``gaussian_splatting_tpu`` is the reference; modules
here carry the name of their JAX counterpart.  Plain tensor code is PyTorch,
and every Pallas kernel on the ported path is a hand-written CUDA kernel for
Hopper (``csrc/``, built at first use by ``_build``).  A kernel wrapper runs
its plain PyTorch version on a CPU tensor and launches the kernel on a CUDA
tensor.

This package imports torch and numpy, never jax.
"""
