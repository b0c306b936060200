"""Dispatch of attention by the device of the tensors.

CPU tensors take the plain version (``ref.py``); CUDA tensors take the
Hopper kernel (``kernel.py::flash_attention_cuda``), or the call
raises.  Nothing falls back from one to the other.  The JAX package's
TPU knobs (``bq``, ``bk``, ``use_pallas``, ``interpret``) have no
meaning on Hopper and are not taken.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """softmax(q·kᵀ·D^-½)·v with kv head ``h // (H/KH)``; q (B, H, S, D),
    k and v (B, KH, S, D).  Returns (B, H, S, D) in q's dtype."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal)
    raise ValueError(f"attention: no kernel for device {q.device}")
