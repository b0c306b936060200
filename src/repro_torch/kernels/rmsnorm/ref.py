"""Plain PyTorch version of the fused residual-add + RMSNorm.

A copy of the JAX package's ``kernels/rmsnorm/ref.py``: the sum and the
norm in f32, both outputs in x's dtype.
"""
from __future__ import annotations

import torch


def rmsnorm_residual_ref(x: torch.Tensor, res: torch.Tensor,
                         scale: torch.Tensor, eps: float = 1e-5):
    """Returns (normed(x+res), x+res) — one fused read of x/res."""
    h = x.to(torch.float32) + res.to(torch.float32)
    ms = torch.mean(torch.square(h), dim=-1, keepdim=True)
    normed = h * torch.rsqrt(ms + eps) * scale.to(torch.float32)
    return normed.to(x.dtype), h.to(x.dtype)
