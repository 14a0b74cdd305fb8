"""Tensor ops of the port: the fused norm kernels, the reflect pad,
resizing, attention masks and the distance transform."""
