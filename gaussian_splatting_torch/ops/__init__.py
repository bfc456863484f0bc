"""Rasterizer kernels (CUDA on the card, plain PyTorch on the CPU) and the
dense compositing oracle."""
