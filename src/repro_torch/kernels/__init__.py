"""Kernels of the port: plain versions and hand-written CUDA kernels."""
