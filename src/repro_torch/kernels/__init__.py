"""Kernels: CUDA sources in ``csrc/``, their wrappers and plain versions."""
