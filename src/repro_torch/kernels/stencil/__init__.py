"""The 4th-order wave-equation stencil: plain version, CUDA kernel,
build and dispatch."""
