"""Shared-grid BLS and its CUDA kernels."""
