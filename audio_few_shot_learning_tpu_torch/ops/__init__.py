"""Ops with hand-written CUDA kernels and their plain PyTorch versions."""
