"""Tensor ops of the port: the fused norm kernels and resizing."""
