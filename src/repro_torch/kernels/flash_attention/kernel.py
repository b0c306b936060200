"""Python wrapper of the Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

``flash_attention_cuda`` replaces the JAX package's ``flash_attention``
(``kernels/flash_attention/kernel.py:86``): one CTA per (b, h, 64-row
query tile), an online softmax in f32 over 64-row key tiles, tiles
above the diagonal skipped, any query and key lengths Sq, Sk ≥ 1 (the
TPU kernel takes one S): Sq ≠ Sk is cross-attention, decoder queries
against encoder frames (``models/attention.py::apply_cross_attn``), and
is not causal — a causal call with Sq ≠ Sk raises.  q·k and v head
dims (D, Dv) are one of ``HEAD_DIM_PAIRS``: D = Dv ∈ {32, 64, 128}, or
(192, 128), multi-head latent attention's prefill (``models/mla.py``).
A ``softcap`` above 0 caps every scaled score to ``cap·tanh(s/cap)``
before the mask (the config's ``attn_logit_softcap``; 0, the default,
leaves the scores as they are).  bf16 runs on
Hopper's ``wgmma`` tensor-core products fed by a TMA ring of swizzled
K/V tiles (``flash_smem_bytes``), f32 on the CUDA cores
(``flash_simt_smem_bytes``); the library's ``flash_smem_query`` returns
either size as its launch requests it.
``attention_flops`` and ``attention_bytes`` give its least work and
traffic.

The wrapper checks what the kernel takes and raises on anything else
(an input that requires grad included: ``kernels/autograd.py``),
allocates the output, launches on PyTorch's current stream without
synchronising, raises if the launch is refused, and counts launches in
its ``launches`` attribute (``flash_attention_op`` is the same launch
as the registered op ``repro_torch::flash_attention``, its fake
implementation allocating only the output, its FLOP formula
``attention_flops``).  Inputs may carry any strides with a
contiguous last axis, so the model's (B, S, H, D) projections go in as
transposed views (the cross-attention's k and v too, from the (B, F,
KH, D) cache), and v may be a strided slice of a wider product (MLA's
``wkv_b`` output); the output is (B, H, Sq, Dv) laid out as (B, Sq, H,
Dv) in memory, so the model's transpose back is free.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.autograd import check_no_grad

HEAD_DIMS = (32, 64, 128)
#: the (q·k, v) head dims the kernel takes: equal ones, and MLA's
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
#: the bf16 kernel's design in one word: ``ring+mma.sync`` or ``wgmma``
DESIGN = "wgmma"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [_VOIDP] * 4 + [_INT] * 7 + [_LL] * 12
        + [ctypes.c_float, _INT, ctypes.c_float, _INT, _VOIDP])
    lib.flash_attention_launch.restype = _INT
    lib.flash_attention_error_string.argtypes = [_INT]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def attention_flops(b: int, h: int, s: int, d: int, causal: bool,
                    dv: int | None = None, sk: int | None = None) -> int:
    """Multiply-adds ×2 of q·kᵀ (over d) and p·v (over dv, default d)
    over the (query, key) pairs the mask keeps: S(S+1)/2 per head when
    causal, Sq·Sk otherwise (``s`` queries, ``sk`` keys, default s).
    Products only: a soft-cap's tanh, like the softmax's exp, is not
    counted, so the count is the same with a cap or without."""
    dv = d if dv is None else dv
    sk = s if sk is None else sk
    pairs = s * (s + 1) // 2 if causal else s * sk
    return 2 * b * h * (d + dv) * pairs


#: the bf16 kernel's K/V ring depth and tile rows (``csrc`` STAGES, BK)
STAGES = 2
TILE_ROWS = 64
#: row stride in floats of the f32 kernel's transposed tiles (``LDT``)
SIMT_LDT = TILE_ROWS + 4


def flash_smem_bytes(d: int, dv: int | None = None) -> int:
    """Dynamic shared memory of one bf16 CTA: 1024 bytes of alignment
    slack, the Q tile and ``STAGES`` K tiles, each 64 rows of d bf16
    values, and ``STAGES`` V tiles of dv (default d) (``fa_smem_bytes``
    in the source)."""
    dv = d if dv is None else dv
    return 1024 + ((1 + STAGES) * d + STAGES * dv) * TILE_ROWS * 2


def flash_simt_smem_bytes(d: int, dv: int | None = None) -> int:
    """Dynamic shared memory of one f32 CTA: Q transposed (d rows of
    ``SIMT_LDT`` floats), one buffer that holds K transposed or V (64
    rows of dv, default d), whichever is larger, and P transposed
    (``simt_smem_bytes`` in the source)."""
    dv = d if dv is None else dv
    return 4 * (d * SIMT_LDT + max(d * SIMT_LDT, TILE_ROWS * dv)
                + TILE_ROWS * SIMT_LDT)


def attention_bytes(b: int, h: int, kh: int, s: int, d: int,
                    itemsize: int, dv: int | None = None,
                    sk: int | None = None) -> int:
    """Least HBM traffic: read q (``s`` rows of d), k (``sk`` rows,
    default s, of d), v (sk rows of dv, default d) and write o (s rows
    of dv) once."""
    dv = d if dv is None else dv
    sk = s if sk is None else sk
    return itemsize * b * (s * h * (d + dv) + sk * kh * (d + dv))


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, softcap: float = 0.0) -> None:
    """Raise unless the kernel takes (q, k, v, causal, softcap): CUDA
    tensors of the shapes, dtypes and head dims it runs, each contiguous
    along its last axis, and a cap that is finite and not negative.  The
    registered op's fake implementation checks the same; the wrapper
    checks the alignment of the data beside."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, "
                         f"got {q.device}")
    if not (math.isfinite(softcap) and softcap >= 0):
        raise ValueError(f"softcap must be finite and >= 0, got {softcap}")
    if q.ndim != 4:
        raise ValueError(f"q must be (B, H, Sq, D), got {tuple(q.shape)}")
    B, H, S, D = q.shape
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes "
                        f"{sorted(map(str, DTYPE_CODES))}")
    if k.ndim != 4 or k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"k must be (B, KH, Sk, D) with H % KH == 0, got "
                         f"{tuple(k.shape)} for H={H}")
    if v.ndim != 4:
        raise ValueError(f"v must be (B, KH, Sk, Dv), got {tuple(v.shape)}")
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if causal and Sk != S:
        raise ValueError(f"causal attention needs as many keys as queries, "
                         f"got Sq={S}, Sk={Sk}")
    if Sk == 0 and S > 0:
        raise ValueError("no keys to attend to (Sk = 0)")
    if (D, Dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims (q·k {D}, v {Dv}) not supported; the "
                         f"kernel takes {HEAD_DIM_PAIRS}")
    for name, t, dt in (("k", k, D), ("v", v, Dv)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {q.dtype}")
        if tuple(t.shape) != (B, KH, Sk, dt):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, KH, Sk, dt)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along its last axis")


def flash_attention_cuda(
    q: torch.Tensor,   # (B, H, Sq, D) f32 or bf16, CUDA
    k: torch.Tensor,   # (B, KH, Sk, D) same dtype
    v: torch.Tensor,   # (B, KH, Sk, Dv)
    *,
    causal: bool = True,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Attention on the card, scores scaled by D^-½ and, with a
    ``softcap`` above 0, capped to ``softcap·tanh(s/softcap)``; returns
    (B, H, Sq, Dv) in q's dtype.  ``causal`` needs Sk == Sq."""
    check_no_grad("flash_attention_cuda", q, k, v)
    check_args(q, k, v, causal, softcap)
    B, H, S, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        # the f32 kernel moves floats; the bf16 kernel's TMA tensor maps
        # need a 16-byte-aligned base and byte strides in 16s
        align = 16 if t.dtype == torch.bfloat16 else 4
        if t.data_ptr() % align or any(st * t.element_size() % align
                                       for st in t.stride()[:3]):
            raise ValueError(f"{name} must be {align}-byte aligned with "
                             f"byte strides that are multiples of {align}")
    out = torch.empty((B, S, H, Dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B == 0 or S == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KH, S, Sk, D, Dv, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], D ** -0.5, int(causal),
            float(softcap), DTYPE_CODES[q.dtype], stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


# ---------------------------------------------------------------------------
# The kernel as a registered op
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, softcap: float = 0.0) -> torch.Tensor:
    """``flash_attention_cuda`` through PyTorch's dispatcher, so that a
    dispatch mode, the profiler and a fake tensor see it: the ctypes
    launch alone is invisible to them.  The dispatch (``ops.py``) calls
    this on CUDA tensors."""
    return flash_attention_cuda(q, k, v, causal=causal, softcap=softcap)


@flash_attention_op.register_fake
def _fake(q, k, v, causal, softcap=0.0):
    check_args(q, k, v, causal, softcap)
    B, H, S, _ = q.shape
    return q.new_empty((B, S, H, v.shape[-1])).transpose(1, 2)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    """``attention_flops`` of the call: the two products only, with a
    soft-cap or without (its tanh is not a product)."""
    B, H, S, D = q_shape
    return attention_flops(B, H, S, D, causal, dv=v_shape[-1],
                           sk=k_shape[2])
