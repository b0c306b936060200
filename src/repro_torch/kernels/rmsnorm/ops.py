"""Dispatch of the fused residual-add + RMSNorm by the device of the
tensors.

A DTensor (the sharded train step) takes ``kernels/local.py``: the same
dispatch on its local shards through ``local_map``.  CPU tensors take
the plain version (``ref.py``) under plain autograd; CUDA tensors take
the Hopper kernel through its registered op
(``kernel.py::rmsnorm_residual_op``, a fake CUDA tensor its fake
implementation), or the call raises.  Nothing falls back from one to the
other.  Where grad is enabled and an input requires it, the kernel runs
inside ``RMSNormResidual``, whose backward is the plain version's
(``kernels/autograd.py``).  The JAX package's TPU knobs (``bn``,
``use_pallas``, ``interpret``) have no meaning on Hopper and are not
taken.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import needs_graph, plain_backward
from repro_torch.kernels.local import is_dtensor, rmsnorm_local
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_residual_op
from repro_torch.kernels.rmsnorm.ref import rmsnorm_residual_ref

__all__ = ["RMSNormResidual", "rmsnorm_residual"]


def _kernel(x, res, scale, eps):
    return rmsnorm_residual_op(x, res, scale.to(torch.float32), eps)


class RMSNormResidual(torch.autograd.Function):
    """``impl(x, res, scale, eps)`` forward (the kernel on the card; the
    plain version in a test), the plain version's backward."""

    @staticmethod
    def forward(ctx, x, res, scale, eps, impl):
        ctx.save_for_backward(x, res, scale)
        ctx.eps = eps
        return impl(x, res, scale, eps)

    @staticmethod
    def backward(ctx, g_out, g_h):
        grads = plain_backward("rmsnorm_residual", rmsnorm_residual_ref,
                               ctx.saved_tensors, ctx.needs_input_grad[:3],
                               (g_out, g_h), eps=ctx.eps)
        return (*grads, None, None)


def rmsnorm_residual(x: torch.Tensor, res: torch.Tensor,
                     scale: torch.Tensor, eps: float = 1e-5):
    """(normed(x + res), x + res) over the last axis; x and res (N, d),
    on a DTensor (..., d), scale (d,).  Both outputs in x's dtype."""
    if is_dtensor(x):
        return rmsnorm_local(rmsnorm_residual, x, res, scale, eps)
    if x.device.type == "cpu":
        return rmsnorm_residual_ref(x, res, scale, eps)
    if x.device.type == "cuda":
        if needs_graph(x, res, scale):
            return RMSNormResidual.apply(x, res, scale, eps, _kernel)
        return _kernel(x, res, scale, eps)
    raise ValueError(f"rmsnorm_residual: no kernel for device {x.device}")
