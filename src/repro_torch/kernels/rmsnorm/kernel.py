"""Python wrapper of the Hopper fused residual-add + RMSNorm kernel
(``csrc/rmsnorm_residual.cu``).

``rmsnorm_residual_cuda`` replaces the JAX package's
``rmsnorm_residual_pallas`` (``kernels/rmsnorm/kernel.py:29``): f32 sum
and norm, both outputs in x's dtype, in one pass with the row held in
registers (``DESIGN``).  It is bound by memory; its least traffic is
``rmsnorm_bytes(N, d, itemsize)``.  ``launch_shape`` picks the launch
from the width: 16-byte accesses where d is a multiple of 8 (bf16) or 4
(f32) and every pointer is 16-byte aligned, else the same kernel with
one-element accesses (the scalar path).  Every path takes any d up to
``MAX_D`` = 16384; ``check_args`` refuses a wider row.

The wrapper checks what the kernel takes and raises on anything else
(an input that requires grad included: ``kernels/autograd.py``),
allocates the outputs, launches on PyTorch's current stream without
synchronising, raises if the launch is refused, counts launches in its
``launches`` attribute and keeps the last launch's shape in
``last_launch``.  ``rmsnorm_residual_op`` is the same launch as the
registered op ``repro_torch::rmsnorm_residual``, with a fake
implementation that allocates only the outputs (``check_args`` first)
and ``rmsnorm_flops`` as its FLOP formula.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.autograd import check_no_grad

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's design in one line
DESIGN = ("one pass, the row in registers: every load (x, res, the f32 "
          "scale) issued first as 16-byte accesses, h stored at once, "
          "h² summed by warp shuffles and a word of shared memory a "
          "warp, out from the same registers; threads a row, rows a CTA "
          "and accesses a thread chosen by the width (launch_shape)")

#: the widest row on every path: 512 threads × 32 elements (the scalar
#: path's most, and the f32 path's 8 accesses of 4)
MAX_D = 16384
#: threads a CTA may hold: the kernel's ``__launch_bounds__`` (``MAX_THREADS``
#: in the source), which leaves each thread 128 registers
MAX_THREADS = 512
#: the threads a CTA of several narrow rows aims at
CTA_THREADS = 256
#: streaming multiprocessors of the H100 SXM: a call of fewer rows than
#: this (decode) takes one row a CTA; the count only steers the shape
SMS = 132
#: accesses a thread holds, by path: the kernel's instantiations (16-byte
#: accesses, 8 in f32 only, then one-element ones); a thread takes
#: ``TARGET_NV`` (16-byte) or ``TARGET_SCALAR`` before a row takes more
#: threads
VECTOR_NV = (1, 2, 4, 8)
SCALAR_NV = (1, 2, 4, 8, 16, 32)
TARGET_NV = 4
TARGET_SCALAR = 8

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = build.load("rmsnorm_residual")
    lib.rmsnorm_residual_launch.argtypes = (
        [_VOIDP] * 5 + [_INT, _INT, ctypes.c_float] + [_INT] * 5 + [_VOIDP])
    lib.rmsnorm_residual_launch.restype = _INT
    lib.rmsnorm_residual_error_string.argtypes = [_INT]
    lib.rmsnorm_residual_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_bytes(n: int, d: int, itemsize: int) -> int:
    """Least HBM traffic of one call: read x and res, write out and h,
    read the f32 scale."""
    return 4 * n * d * itemsize + 4 * d


def rmsnorm_smem_bytes(rows: int, warps: int) -> int:
    """Dynamic shared memory of one CTA: an f32 sum for each warp of each
    of its rows (``rmsnorm_smem_bytes`` in the source, which the
    library's ``rmsnorm_smem_query`` returns)."""
    return rows * warps * 4


def rmsnorm_flops(n: int, d: int) -> int:
    """f32 operations of one call: the add, the square and its sum, and
    two multiplies per element."""
    return 5 * n * d


def launch_shape(n: int, d: int, dtype, aligned: bool):
    """The kernel's launch for ``n`` rows of ``d``, or None where it has
    none (d > ``MAX_D``).

    ``vec`` elements an access: 16 bytes where ``aligned`` (every
    pointer 16-byte aligned) and ``vec`` divides d, else 1.  A row takes
    ``nv`` accesses on each of ``tpr`` threads (whole warps) of one CTA:
    the fewest threads that hold the row at ``TARGET_NV`` accesses a
    thread (``TARGET_SCALAR`` scalar), fewer accesses where one warp
    holds it, more where ``MAX_THREADS`` would not.  These depend on d,
    the dtype and the path alone, so a row's sum is taken in one order
    whatever the number of rows: a decode step normalises a row as the
    prefill did.  A CTA takes ``rows`` rows, up to ``CTA_THREADS``
    threads but no more than ``n // SMS``.
    ``smem_bytes`` is its dynamic shared memory (``tools/rmsnorm_bench.py
    --sweep`` times the alternatives)."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    vec = 16 // itemsize
    if not aligned or d % vec != 0:
        vec = 1
    nvec = d // vec
    choices = VECTOR_NV if vec > 1 else SCALAR_NV
    target = TARGET_NV if vec > 1 else TARGET_SCALAR
    for nv in choices:
        tpr = 32 * -(-nvec // (32 * nv))
        if tpr <= MAX_THREADS and (nv >= target or tpr == 32):
            rows = max(1, min(CTA_THREADS // tpr, n // SMS))
            warps = tpr // 32
            return {"vec": vec, "nv": nv, "tpr": tpr, "warps": warps,
                    "rows": rows, "grid": -(-n // rows),
                    "smem_bytes": rmsnorm_smem_bytes(rows, warps)}
    return None


def shape_for(x, res, scale, out, h):
    """``launch_shape`` of a call on these tensors as they lie in
    memory: the 16-byte path only where all five pointers are 16-byte
    aligned."""
    n, d = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, res, scale, out, h))
    return launch_shape(n, d, x.dtype, aligned)


def instantiation(dtype, shape: dict) -> str:
    """The kernel instantiation a launch shape runs, as the source names
    it: ``rmsnorm_residual_kernel<T, VEC, NV>``."""
    t = "__nv_bfloat16" if dtype == torch.bfloat16 else "float"
    return f"rmsnorm_residual_kernel<{t}, {shape['vec']}, {shape['nv']}>"


def check_args(x: torch.Tensor, res: torch.Tensor,
               scale: torch.Tensor) -> None:
    """Raise unless the kernel takes (x, res, scale): CUDA tensors of the
    shapes, dtypes and layout it reads, rows of at most ``MAX_D``.  The
    registered op's fake implementation checks the same."""
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
    if d > MAX_D:
        raise ValueError(f"d={d}: the kernel holds a row in registers, "
                         f"at most {MAX_D} columns")


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
    shape = shape_for(x, res, scale, out, h)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_residual_launch(
            x.data_ptr(), res.data_ptr(), scale.data_ptr(), out.data_ptr(),
            h.data_ptr(), n, d, float(eps), DTYPE_CODES[x.dtype], shape["vec"],
            shape["nv"], shape["tpr"], shape["rows"], stream)
    if err != 0:
        msg = lib.rmsnorm_residual_error_string(err).decode()
        raise RuntimeError(f"rmsnorm_residual launch failed: {msg} ({err})")
    rmsnorm_residual_cuda.launches += 1
    rmsnorm_residual_cuda.last_launch = shape
    return out, h


rmsnorm_residual_cuda.launches = 0
rmsnorm_residual_cuda.last_launch = None


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
