"""Dispatch of attention by the device of the tensors.

A DTensor (the sharded train step) takes ``kernels/local.py``: the same
dispatch on its local shards through ``local_map``.  CPU tensors take
the plain version (``ref.py``) under plain autograd; CUDA tensors take
the Hopper kernel through its registered op
(``kernel.py::flash_attention_op``, a fake CUDA tensor its fake
implementation), or the call raises.  Nothing falls back from one to the
other.  Where grad is enabled and an input requires it, the kernel runs
inside ``FlashAttention``, whose backward is the plain version's
(``kernels/autograd.py``).  The JAX package's TPU knobs (``bq``, ``bk``,
``use_pallas``, ``interpret``) have no meaning on Hopper and are not
taken.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.autograd import needs_graph, plain_backward
from repro_torch.kernels.local import attention_local, is_dtensor
from repro_torch.kernels.flash_attention.kernel import flash_attention_op
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["FlashAttention", "attention"]


def _kernel(q, k, v, causal, softcap=0.0):
    return flash_attention_op(q, k, v, causal, softcap)


class FlashAttention(torch.autograd.Function):
    """``impl(q, k, v, causal)`` forward (the kernel on the card, with
    the cap ``softcap`` bound; the plain version in a test), the plain
    version's backward at the same cap."""

    @staticmethod
    def forward(ctx, q, k, v, causal, impl, softcap=0.0):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.softcap = causal, softcap
        return impl(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        grads = plain_backward("flash_attention", attention_ref,
                               ctx.saved_tensors, ctx.needs_input_grad[:3],
                               (g,), causal=ctx.causal, softcap=ctx.softcap)
        return (*grads, None, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, softcap: float = 0.0) -> torch.Tensor:
    """softmax(q·kᵀ·D^-½)·v with kv head ``h // (H/KH)``; q (B, H, Sq, D),
    k (B, KH, Sk, D) and v (B, KH, Sk, Dv), Dv = D or not (MLA's 192 /
    128), Sk = Sq or not (cross-attention, which is not causal: a causal
    call with Sk ≠ Sq raises).  A ``softcap`` above 0 caps the scaled
    scores to ``softcap·tanh(s/softcap)`` before the mask.  Returns (B,
    H, Sq, Dv) in q's dtype."""
    if is_dtensor(q):
        return attention_local(attention, q, k, v, causal, softcap)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, softcap=softcap)
    if q.device.type == "cuda":
        if needs_graph(q, k, v):
            return FlashAttention.apply(
                q, k, v, causal, functools.partial(_kernel, softcap=softcap),
                softcap)
        return _kernel(q, k, v, causal, softcap)
    raise ValueError(f"attention: no kernel for device {q.device}")
