"""Plain PyTorch version of the fused residual-add + RMSNorm.

A copy of the JAX package's ``kernels/rmsnorm/ref.py``: the sum and the
norm in f32 (in f64 for f64 inputs, so ``torch.autograd.gradcheck`` can
hold a backward built on it), both outputs in x's dtype.
"""
from __future__ import annotations

import torch


def rmsnorm_residual_ref(x: torch.Tensor, res: torch.Tensor,
                         scale: torch.Tensor, eps: float = 1e-5):
    """Returns (normed(x+res), x+res) — one fused read of x/res."""
    acc = torch.promote_types(x.dtype, torch.float32)
    h = x.to(acc) + res.to(acc)
    ms = torch.mean(torch.square(h), dim=-1, keepdim=True)
    normed = h * torch.rsqrt(ms + eps) * scale.to(acc)
    return normed.to(x.dtype), h.to(x.dtype)
