"""Plain PyTorch version of GQA attention, causal or not (full softmax).

A copy of the JAX package's ``kernels/flash_attention/ref.py``: scores
in f32 (f64 for f64 inputs) scaled by q's head dim D^-½, probabilities
cast to q's dtype before the product with v.  v's head dim may differ
from q's and k's (MLA: 192 for q·k, 128 for v), and the keys' length
from the queries' (cross-attention, not causal), as in the JAX model's
``chunked_attention``; the output takes v's head dim and q's length.
A causal call with Sk ≠ Sq raises, as the kernel's wrapper does.
A ``softcap`` above 0 caps each scaled score to ``cap·tanh(s/cap)``
before the mask, in the order of the JAX model's ``chunked_attention``
(``models/attention.py``): scale, cap, mask, softmax.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,   # (B, H, Sq, D)
    k: torch.Tensor,   # (B, KH, Sk, D)
    v: torch.Tensor,   # (B, KH, Sk, Dv)
    *,
    causal: bool = True,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, H, S, D = q.shape
    KH = k.shape[1]
    if causal and k.shape[2] != S:
        raise ValueError(f"causal attention needs as many keys as queries, "
                         f"got Sq={S}, Sk={k.shape[2]}")
    rep = H // KH
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * (D ** -0.5)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.exp(s - torch.amax(s, -1, keepdim=True))
    p = p / torch.sum(p, -1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)
