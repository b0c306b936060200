"""Dispatch of the SSD intra-chunk block by the device of the tensors.

A DTensor (the sharded train step) takes ``kernels/local.py``: the same
dispatch on its local shards through ``local_map``.  CPU tensors take
the plain version (``ref.py``) under plain autograd; CUDA tensors take
the Hopper kernel through its registered op
(``kernel.py::ssd_chunk_op``, a fake CUDA tensor its fake
implementation), or the call raises.  Nothing falls back from one to the
other.  Where grad is enabled and an input requires it, the kernel runs
inside ``SSDChunk``, whose backward is the plain version's
(``kernels/autograd.py``).  The JAX package's TPU knobs (``use_pallas``,
``interpret``) have no meaning on Hopper and are not taken.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import needs_graph, plain_backward
from repro_torch.kernels.local import is_dtensor, ssd_local
from repro_torch.kernels.ssd.kernel import ssd_chunk_op
from repro_torch.kernels.ssd.ref import ssd_chunk_ref

__all__ = ["SSDChunk", "ssd_chunk"]


class SSDChunk(torch.autograd.Function):
    """``impl(xdt, b, c, csum)`` forward (the kernel on the card; the
    plain version in a test), the plain version's backward.  b and c may
    be stride-0 views over the heads; their gradients come back dense
    and the view's backward sums them over the heads."""

    @staticmethod
    def forward(ctx, xdt, b, c, csum, impl):
        ctx.save_for_backward(xdt, b, c, csum)
        return impl(xdt, b, c, csum)

    @staticmethod
    def backward(ctx, g_y, g_state):
        grads = plain_backward("ssd_chunk", ssd_chunk_ref, ctx.saved_tensors,
                               ctx.needs_input_grad[:4], (g_y, g_state))
        return (*grads, None)


def ssd_chunk(xdt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              csum: torch.Tensor):
    """xdt (BC,H,Q,P), b/c (BC,H,Q,N), csum (BC,H,Q) f32 ->
    (y_intra (BC,H,Q,P) in xdt's dtype, state (BC,H,N,P) f32)."""
    if is_dtensor(xdt):
        return ssd_local(ssd_chunk, xdt, b, c, csum)
    if xdt.device.type == "cpu":
        return ssd_chunk_ref(xdt, b, c, csum)
    if xdt.device.type == "cuda":
        if needs_graph(xdt, b, c, csum):
            return SSDChunk.apply(xdt, b, c, csum, ssd_chunk_op)
        return ssd_chunk_op(xdt, b, c, csum)
    raise ValueError(f"ssd_chunk: no kernel for device {xdt.device}")
