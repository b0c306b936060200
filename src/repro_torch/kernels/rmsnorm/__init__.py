"""Fused residual-add + RMSNorm: plain version, CUDA kernel, dispatch."""
