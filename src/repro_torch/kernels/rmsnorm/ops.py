"""Dispatch of the fused residual-add + RMSNorm by the device of the
tensors.

CPU tensors take the plain version (``ref.py``); CUDA tensors take the
Hopper kernel (``kernel.py::rmsnorm_residual_cuda``), or the call
raises.  Nothing falls back from one to the other.  The JAX package's
TPU knobs (``bn``, ``use_pallas``, ``interpret``) have no meaning on
Hopper and are not taken.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_residual_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_residual_ref

__all__ = ["rmsnorm_residual"]


def rmsnorm_residual(x: torch.Tensor, res: torch.Tensor,
                     scale: torch.Tensor, eps: float = 1e-5):
    """(normed(x + res), x + res) over the last axis; x and res (N, d),
    scale (d,).  Both outputs in x's dtype."""
    if x.device.type == "cpu":
        return rmsnorm_residual_ref(x, res, scale, eps)
    if x.device.type == "cuda":
        return rmsnorm_residual_cuda(x, res, scale.to(torch.float32), eps)
    raise ValueError(f"rmsnorm_residual: no kernel for device {x.device}")
