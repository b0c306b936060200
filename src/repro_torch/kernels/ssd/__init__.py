"""Mamba-2 SSD intra-chunk block: plain version, CUDA kernel, dispatch."""
