"""Attention ops of the PyTorch port: plain PyTorch functions and the
wrappers of the hand-written CUDA kernels in ``csrc/``."""
