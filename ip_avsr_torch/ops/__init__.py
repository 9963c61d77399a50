"""Tensor ops of the port: plain PyTorch functions, with the hand-written
CUDA kernels and their wrappers under ``kernels/``."""
