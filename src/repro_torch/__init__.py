"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper.

The FWI forward engine, its elastic session and orchestrator run on one
H100, with the k-step stencil block as a hand-written CUDA kernel
(``kernels/stencil/csrc/wave_block.cu``).  The JAX package stays the
reference each module is tested against.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
