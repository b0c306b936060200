"""Kernels of the port: a plain PyTorch version beside each one."""
