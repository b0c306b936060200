"""Autograd for the LM kernels: the forward on the kernel, the backward
through the plain version.

The JAX package has no backward kernel: its training differentiates
plain ``jnp`` code and never calls the Pallas kernels.  The port's
training forward runs the Hopper kernels (``ops.py`` of ``rmsnorm``,
``flash_attention`` and ``ssd``), each inside a
``torch.autograd.Function`` whose backward recomputes the same function
through its plain version (``ref.py``) under ``torch.enable_grad()``
and returns ``torch.autograd.grad`` of it: the torch ops XLA's autodiff
would have run.  The recompute runs inside a profiler range named
``<kernel>_plain_backward``.

A kernel's ctypes wrapper returns tensors with no ``grad_fn``; so that
no path drops the graph silently, each wrapper calls
``check_no_grad`` and raises when grad is enabled and an input requires
it.  ``needs_graph`` is the dispatch's test for going through the
Function instead.
"""
from __future__ import annotations

import torch


def needs_graph(*tensors: torch.Tensor) -> bool:
    """True when grad is enabled and an input requires it."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where the kernel's output would drop an autograd graph."""
    if needs_graph(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad and the kernel's output has no "
            f"grad_fn; call it through its ops.py dispatch, whose "
            f"autograd.Function gives the backward")


def plain_backward(name: str, ref, inputs, needs, grad_outputs, **kw):
    """Gradients of ``ref(*inputs, **kw)`` against ``grad_outputs``, for
    the inputs whose ``needs`` is true (``None`` for the others)."""
    with torch.profiler.record_function(f"{name}_plain_backward"), \
            torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        outs = ref(*leaves, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [t for t, n in zip(leaves, needs) if n]
        # an output no needed input reaches (the residual sum of two
        # inputs that need no grad) takes no part
        used = [(o, g) for o, g in zip(outs, grad_outputs)
                if o.requires_grad and g is not None]
        grads = iter(torch.autograd.grad(
            [o for o, _ in used], wrt, [g for _, g in used],
            allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)
