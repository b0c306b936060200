"""Python wrapper of the Hopper fused residual-add + RMSNorm kernel
(``csrc/rmsnorm_residual.cu``).

``rmsnorm_residual_cuda`` replaces the JAX package's
``rmsnorm_residual_pallas`` (``kernels/rmsnorm/kernel.py:29``): one CTA
per row, f32 sum and norm, both outputs in x's dtype.  It is bound by
memory; its least traffic is ``rmsnorm_bytes(N, d, itemsize)``.

The wrapper checks what the kernel takes and raises on anything else
(an input that requires grad included: ``kernels/autograd.py``),
allocates the outputs, launches on PyTorch's current stream without
synchronising, raises if the launch is refused, and counts launches in
its ``launches`` attribute.  ``rmsnorm_residual_op`` is the same
launch as the registered op ``repro_torch::rmsnorm_residual``, with a
fake implementation that allocates only the outputs (``check_args``
first) and ``rmsnorm_flops`` as its FLOP formula.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.autograd import check_no_grad
from repro_torch.kernels.build import MAX_SMEM_BYTES

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = build.load("rmsnorm_residual")
    lib.rmsnorm_residual_launch.argtypes = (
        [_VOIDP] * 5 + [_INT, _INT, ctypes.c_float, _INT, _VOIDP])
    lib.rmsnorm_residual_launch.restype = _INT
    lib.rmsnorm_residual_error_string.argtypes = [_INT]
    lib.rmsnorm_residual_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_bytes(n: int, d: int, itemsize: int) -> int:
    """Least HBM traffic of one call: read x and res, write out and h,
    read the f32 scale."""
    return 4 * n * d * itemsize + 4 * d


def rmsnorm_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one CTA: the row's f32 copy of h
    (``rmsnorm_smem_bytes`` in the source, which the library's
    ``rmsnorm_smem_query`` returns)."""
    return 4 * d


def rmsnorm_flops(n: int, d: int) -> int:
    """f32 operations of one call: the add, the square and its sum, and
    two multiplies per element."""
    return 5 * n * d


def check_args(x: torch.Tensor, res: torch.Tensor,
               scale: torch.Tensor) -> None:
    """Raise unless the kernel takes (x, res, scale): CUDA tensors of the
    shapes, dtypes and layout it reads.  The registered op's fake
    implementation checks the same."""
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_residual_cuda needs CUDA tensors, "
                         f"got {x.device}")
    if x.ndim != 2:
        raise ValueError(f"x must be (N, d), got {tuple(x.shape)}")
    n, d = x.shape
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes "
                        f"{sorted(map(str, DTYPE_CODES))}")
    for name, t, dtype, shape in (("res", res, x.dtype, (n, d)),
                                  ("scale", scale, torch.float32, (d,))):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name, t in (("x", x), ("res", res), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rmsnorm_smem_bytes(d) > MAX_SMEM_BYTES:
        raise ValueError(f"d={d} needs {rmsnorm_smem_bytes(d)} B of shared "
                         f"memory per CTA, more than {MAX_SMEM_BYTES}")


def rmsnorm_residual_cuda(
    x: torch.Tensor,        # (N, d) f32 or bf16, CUDA
    res: torch.Tensor,      # (N, d) same dtype
    scale: torch.Tensor,    # (d,) f32
    eps: float = 1e-5,
):
    """(normed(x + res), x + res) on the card, both (N, d) in x's
    dtype."""
    check_no_grad("rmsnorm_residual_cuda", x, res, scale)
    check_args(x, res, scale)
    n, d = x.shape
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    if n == 0 or d == 0:
        return out, h
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_residual_launch(
            x.data_ptr(), res.data_ptr(), scale.data_ptr(), out.data_ptr(),
            h.data_ptr(), n, d, float(eps), DTYPE_CODES[x.dtype], stream)
    if err != 0:
        msg = lib.rmsnorm_residual_error_string(err).decode()
        raise RuntimeError(f"rmsnorm_residual launch failed: {msg} ({err})")
    rmsnorm_residual_cuda.launches += 1
    return out, h


rmsnorm_residual_cuda.launches = 0


# ---------------------------------------------------------------------------
# The kernel as a registered op
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::rmsnorm_residual", mutates_args=(),
                         device_types="cuda")
def rmsnorm_residual_op(x: torch.Tensor, res: torch.Tensor,
                        scale: torch.Tensor,
                        eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``rmsnorm_residual_cuda`` through PyTorch's dispatcher, so that a
    dispatch mode, the profiler and a fake tensor see it: the ctypes
    launch alone is invisible to them.  The dispatch (``ops.py``) calls
    this on CUDA tensors."""
    return rmsnorm_residual_cuda(x, res, scale, eps)


@rmsnorm_residual_op.register_fake
def _fake(x, res, scale, eps):
    check_args(x, res, scale)
    return torch.empty_like(x), torch.empty_like(x)


@register_flop_formula(torch.ops.repro_torch.rmsnorm_residual)
def _flops(x_shape, res_shape, scale_shape, eps, *args, **kwargs) -> int:
    return rmsnorm_flops(*x_shape)
