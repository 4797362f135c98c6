"""Operators: attention dispatch and the hand-written CUDA kernels."""
