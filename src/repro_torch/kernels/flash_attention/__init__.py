"""Causal / non-causal GQA attention: plain version, CUDA kernel,
dispatch."""
