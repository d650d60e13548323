"""Kernels with their plain versions, and the nvcc build that makes the kernels."""
