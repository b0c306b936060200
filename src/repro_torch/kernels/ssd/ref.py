"""Plain PyTorch version of the SSD intra-chunk computation.

A copy of the JAX package's ``kernels/ssd/ref.py``, op for op.  Per
(batch·chunk, head): given xdt (Q,P), B (Q,N), C (Q,N) and the inclusive
cumulative decay csum (Q,):
    y_intra[q] = Σ_{t<=q} exp(csum_q - csum_t) · (C_q·B_t) · xdt_t
    state      = Σ_t exp(csum_Q - csum_t) · B_t ⊗ xdt_t      (N, P)
which is the attention-form dual of the selective-scan recurrence
(arXiv:2405.21060 §5) restricted to one chunk.  ``C·Bᵀ`` is taken in
f32, ``(C·Bᵀ)∘L`` is rounded to xdt's dtype before its product with
xdt, and the state is f32 (f64 for f64 inputs).  The mask is applied
before the exponential (``exp(-inf) = 0``, the same values as the JAX
package's ``where(mask, exp(diff), 0)``), so the positions above the
diagonal, where ``diff`` can exceed f32's range, give no ``inf·0`` in a
backward through this function.
"""
from __future__ import annotations

import torch


def ssd_chunk_ref(xdt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  csum: torch.Tensor):
    """xdt (..., Q, P); b/c (..., Q, N); csum (..., Q) f32.

    Returns (y_intra (..., Q, P) in xdt's dtype, state (..., N, P) f32)."""
    acc = torch.promote_types(xdt.dtype, torch.float32)
    cb = torch.einsum("...qn,...tn->...qt", c.to(acc), b.to(acc))
    diff = csum[..., :, None] - csum[..., None, :]          # (..., Q, Q)
    Q = xdt.shape[-2]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xdt.device))
    decay = torch.exp(torch.where(mask, diff, -torch.inf))
    y = torch.einsum("...qt,...tp->...qp", (cb * decay).to(xdt.dtype), xdt)
    to_end = torch.exp(csum[..., -1:] - csum)               # (..., Q)
    state = torch.einsum(
        "...tn,...tp->...np",
        (b * to_end[..., None]).to(acc),
        xdt.to(acc),
    )
    return y, state
