"""Dispatch of the SSD intra-chunk block by the device of the tensors.

CPU tensors take the plain version (``ref.py``); CUDA tensors take the
Hopper kernel (``kernel.py::ssd_chunk_cuda``), or the call raises.
Nothing falls back from one to the other.  The JAX package's TPU knobs
(``use_pallas``, ``interpret``) have no meaning on Hopper and are not
taken.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.kernel import ssd_chunk_cuda
from repro_torch.kernels.ssd.ref import ssd_chunk_ref

__all__ = ["ssd_chunk"]


def ssd_chunk(xdt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              csum: torch.Tensor):
    """xdt (BC,H,Q,P), b/c (BC,H,Q,N), csum (BC,H,Q) f32 ->
    (y_intra (BC,H,Q,P) in xdt's dtype, state (BC,H,N,P) f32)."""
    if xdt.device.type == "cpu":
        return ssd_chunk_ref(xdt, b, c, csum)
    if xdt.device.type == "cuda":
        return ssd_chunk_cuda(xdt, b, c, csum)
    raise ValueError(f"ssd_chunk: no kernel for device {xdt.device}")
