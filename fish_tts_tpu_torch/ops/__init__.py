"""Ops: plain PyTorch building blocks and the wrappers of the CUDA kernels."""
