"""Python wrapper of the Hopper SSD intra-chunk kernel
(``csrc/ssd_chunk.cu``).

``ssd_chunk_cuda`` replaces the JAX package's ``ssd_chunk_pallas``
(``kernels/ssd/kernel.py:51``): per (chunk, head) the intra-chunk
``y = ((C·Bᵀ)∘L)·xdt`` and the chunk-end state ``Bᵀ·diag(to_end)·xdt``,
in one launch whose CTAs take 64 rows of q (y) or of n (state) for a
block of heads (``launch_rule``).  bf16 runs on the tensor cores
(``wgmma``, fed by TMA), f32 on the CUDA cores.  It is
bound by memory; ``ssd_bytes`` and ``ssd_flops`` give its least traffic
and work.

The wrapper checks what the kernel takes and raises on anything else (an
input that requires grad included: ``kernels/autograd.py``), allocates
the outputs, launches on PyTorch's current stream without synchronising,
raises if the launch is refused, and counts launches in its ``launches``
attribute (``ssd_chunk_op`` is the same launch as the registered op
``repro_torch::ssd_chunk``, its fake implementation allocating only the
outputs, its FLOP formula ``ssd_flops``).  Inputs may carry any strides
with a contiguous last axis (in bf16 16-byte aligned, strides a multiple
of 8): the model's (B, nc, Q, H, ·) activations go in as (B·nc, H, Q, ·)
views, and B and C of one group as a stride-0 head axis.  y is (BC, H, Q,
P) laid out as (BC, Q, H, P) in memory, so the model's transpose back is
free; the state is contiguous f32.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.autograd import check_no_grad

HEAD_DIMS = (16, 32, 64, 128)
#: the largest d_state whose f32 tiles fit one CTA's shared memory
MAX_STATE = 256
#: the kernel's grid.y and grid.z (heads, chunks) limit
MAX_GRID_YZ = 65535
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: rows of q, n and t a CTA's tiles take
TILE = 64
#: the bf16 kernel's xdt tiles are at least this many columns wide: P =
#: 16 is padded to 32 by TMA's zero fill
MIN_TILE_P = 32
#: the bf16 kernel's TMA ring depth and the bf16 parts of the state's
#: split (``csrc`` STAGES, SPLIT), its bytes of a 64-row, 128-byte
#: column block (``BLK``) and threads of a warpgroup (``WG``)
STAGES = 2
SPLIT = 3
BLOCK_BYTES = 64 * 128
WARPGROUP = 128
#: row stride in floats of the f32 kernel's tiles (``LDT``)
SIMT_LDT = TILE + 4
#: the bf16 kernel's design, as chip_smoke.py reports it
DESIGN = ("wgmma + TMA ring: two heads of a group a y CTA, a warpgroup "
          "each, S = C·Bᵀ once for both (halves swapped through shared "
          "memory); a 2-stage TMA ring of B_t and xdt_t on mbarriers; "
          "y += rnd(S∘L)·xdt with A from registers, stored by TMA; a "
          "state CTA one head and two n blocks, to_end·xdt split once "
          "into three bf16 parts, B_tᵀ (ldmatrix.trans) · parts")

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong


def signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C signatures of ``ssd_chunk.cu``'s entries."""
    args = [_VOIDP] * 6 + [_INT] * 5 + [_LL] * 15 + [_INT] * 3
    lib.ssd_chunk_launch.argtypes = args + [_VOIDP]
    lib.ssd_chunk_launch.restype = _INT
    lib.ssd_chunk_launch_role.argtypes = args + [_INT, _VOIDP]
    lib.ssd_chunk_launch_role.restype = _INT
    lib.ssd_chunk_error_string.argtypes = [_INT]
    lib.ssd_chunk_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    return signatures(build.load("ssd_chunk"))


def c_args(xdt, b, c, csum, y, state, launch: dict) -> tuple:
    """The arguments of ``ssd_chunk_launch`` up to the stream."""
    BC, H, Q, P = xdt.shape
    return (xdt.data_ptr(), b.data_ptr(), c.data_ptr(), csum.data_ptr(),
            y.data_ptr(), state.data_ptr(), BC, H, Q, b.shape[-1], P,
            *xdt.stride()[:3], *b.stride()[:3], *c.stride()[:3],
            *csum.stride(), *y.stride()[:3], DTYPE_CODES[xdt.dtype],
            launch["heads_per_group"], launch["heads_per_cta"])


def heads_per_group(b: torch.Tensor, c: torch.Tensor) -> int:
    """H when B and C are one group seen by every head (a stride-0 head
    axis, as ``models/mamba2.py::_heads`` hands over G = 1), else 1: a
    copy per head, ``repeat_interleave``'s included, is taken as one
    group per head."""
    H = b.shape[1]
    return H if H > 1 and b.stride(1) == 0 and c.stride(1) == 0 else 1


def launch_rule(BC: int, H: int, Q: int, N: int, P: int, dtype,
                hpg: int) -> dict:
    """The kernel's launch for a (BC, H, Q, N, P) call whose heads share
    B and C in groups of ``hpg``.

    A y CTA takes 64 rows of q for ``heads_per_cta`` heads of one
    group, one warpgroup a head: in bf16 two where heads share B and C
    (the last block of an odd H holds one head and a warpgroup that
    stores nothing), so C·Bᵀ and the staging of B and C are done once
    for them; otherwise one.  A state CTA takes one head of the block
    and ``heads_per_cta`` n blocks of 64 rows, one a warpgroup, so the
    split of to_end·xdt is done once for them: ``n_tiles`` state CTAs a
    head block.  grid = (y tiles then state tiles, head blocks,
    chunks): the CTAs of one chunk are launched together and share its
    B, C and xdt in L2.  ``smem_bytes`` is the dynamic shared memory a
    CTA of that launch requests (``wg_smem_bytes`` at P padded to
    ``MIN_TILE_P`` in bf16, ``simt_smem_bytes`` in f32; the library's
    ``ssd_smem_query`` returns it)."""
    hb = 2 if dtype == torch.bfloat16 and hpg > 1 else 1
    q_tiles = -(-Q // TILE)
    n_tiles = hb * -(-N // (TILE * hb))
    head_blocks = -(-H // hb)
    if dtype == torch.bfloat16:
        smem = wg_smem_bytes(N, max(P, MIN_TILE_P), hb)
    else:
        smem = simt_smem_bytes(N, P)
    return {"heads_per_group": hpg, "heads_per_cta": hb,
            "q_tiles": q_tiles, "n_tiles": n_tiles,
            "head_blocks": head_blocks,
            "grid": (q_tiles + n_tiles, head_blocks, BC),
            "smem_bytes": smem}


def wg_smem_bytes(n: int, pt: int, hb: int) -> int:
    """Dynamic shared memory of one bf16 CTA at d_state ``n``, xdt tiles
    of ``pt`` columns and ``hb`` warpgroups: 1024 bytes of alignment
    slack and the larger of the y role's (C_q, a ring of B_t and the
    heads' xdt_t, the S exchange between two warpgroups) and the state
    role's (a ring of B_t's n blocks and the head's xdt_t, the split's
    parts) (``wg_smem_bytes`` in the source)."""
    ncb = -(-n // 64)
    xt = 64 * pt * 2
    xch = hb * 16 * WARPGROUP * 4 if hb > 1 else 0
    y = ncb * BLOCK_BYTES + STAGES * (ncb * BLOCK_BYTES + hb * xt) + xch
    st = STAGES * (hb * BLOCK_BYTES + xt) + SPLIT * xt
    return 1024 + max(y, st)


def simt_smem_bytes(n: int, p: int) -> int:
    """Dynamic shared memory of one f32 CTA: the larger of the y role's
    C and B transposed (n rows of ``SIMT_LDT`` floats each), P
    transposed, the xdt tile and the cs of q and t, and the state
    role's B·to_end, the xdt tile and to_end (``simt_smem_bytes`` in
    the source)."""
    y = 4 * (2 * n * SIMT_LDT + TILE * SIMT_LDT + TILE * p + 2 * TILE)
    st = 4 * (TILE * SIMT_LDT + TILE * p + TILE)
    return max(y, st)


def ssd_bytes(bc: int, h: int, q: int, n: int, p: int, itemsize: int,
              groups: int) -> int:
    """Least HBM traffic of one call: read xdt, B and C once per group
    and the f32 csum; write y and the f32 state."""
    return (2 * bc * h * q * p * itemsize + 2 * bc * groups * q * n * itemsize
            + 4 * bc * h * q + 4 * bc * h * n * p)


def ssd_flops(bc: int, h: int, q: int, n: int, p: int) -> int:
    """Multiply-adds ×2 over the (q, t) pairs the causal mask keeps, for
    C·Bᵀ and (C·Bᵀ∘L)·xdt, plus the state's Q·N·P."""
    pairs = q * (q + 1) // 2
    return 2 * bc * h * (pairs * (n + p) + q * n * p)


def check_args(xdt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               csum: torch.Tensor) -> None:
    """Raise unless the kernel takes (xdt, b, c, csum): CUDA tensors of
    the shapes, dtypes and sizes it runs, xdt, b and c contiguous along
    their last axis.  The registered op's fake implementation checks
    the same; the wrapper checks the alignment of the data beside."""
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk_cuda needs CUDA tensors, got "
                         f"{xdt.device}")
    if xdt.ndim != 4:
        raise ValueError(f"xdt must be (BC, H, Q, P), got "
                         f"{tuple(xdt.shape)}")
    BC, H, Q, P = xdt.shape
    if xdt.dtype not in DTYPE_CODES:
        raise TypeError(f"xdt has dtype {xdt.dtype}; the kernel takes "
                        f"{sorted(map(str, DTYPE_CODES))}")
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P} not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    if b.ndim != 4:
        raise ValueError(f"b must be (BC, H, Q, N), got {tuple(b.shape)}")
    N = b.shape[-1]
    if N <= 0 or N % 16 or N > MAX_STATE:
        raise ValueError(f"d_state {N} not supported; the kernel takes "
                         f"multiples of 16 up to {MAX_STATE}")
    if BC > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"BC={BC}, H={H}: the grid takes at most "
                         f"{MAX_GRID_YZ} of each")
    for name, t, dtype, shape in (
            ("b", b, xdt.dtype, (BC, H, Q, N)),
            ("c", c, xdt.dtype, (BC, H, Q, N)),
            ("csum", csum, torch.float32, (BC, H, Q))):
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{xdt.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    for name, t in (("xdt", xdt), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along its last axis")


def ssd_chunk_cuda(
    xdt: torch.Tensor,    # (BC, H, Q, P) f32 or bf16, CUDA
    b: torch.Tensor,      # (BC, H, Q, N) same dtype
    c: torch.Tensor,      # (BC, H, Q, N) same dtype
    csum: torch.Tensor,   # (BC, H, Q) f32
):
    """(y_intra (BC, H, Q, P) in xdt's dtype, state (BC, H, N, P) f32)
    on the card."""
    check_no_grad("ssd_chunk_cuda", xdt, b, c, csum)
    check_args(xdt, b, c, csum)
    BC, H, Q, P = xdt.shape
    N = b.shape[-1]
    for name, t in (("xdt", xdt), ("b", b), ("c", c)):
        # the bf16 kernel's TMA maps need 16-byte aligned bases and
        # strides
        if xdt.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             f"a multiple of 8 in bf16")
    y = torch.empty((BC, Q, H, P), dtype=xdt.dtype,
                    device=xdt.device).transpose(1, 2)
    state = torch.empty((BC, H, N, P), dtype=torch.float32,
                        device=xdt.device)
    if BC == 0 or H == 0 or Q == 0:
        return y, state.zero_()
    launch = launch_rule(BC, H, Q, N, P, xdt.dtype, heads_per_group(b, c))
    lib = _lib()
    stream = torch.cuda.current_stream(xdt.device).cuda_stream
    with torch.cuda.device(xdt.device):
        err = lib.ssd_chunk_launch(
            *c_args(xdt, b, c, csum, y, state, launch), stream)
    if err != 0:
        msg = lib.ssd_chunk_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk launch failed: {msg} ({err})")
    ssd_chunk_cuda.launches += 1
    ssd_chunk_cuda.last_launch = launch
    return y, state


ssd_chunk_cuda.launches = 0
#: the ``launch_rule`` dict of the last launch made
ssd_chunk_cuda.last_launch = None


# ---------------------------------------------------------------------------
# The kernel as a registered op
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::ssd_chunk", mutates_args=(),
                         device_types="cuda")
def ssd_chunk_op(xdt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 csum: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunk_cuda`` through PyTorch's dispatcher, so that a
    dispatch mode, the profiler and a fake tensor see it: the ctypes
    launch alone is invisible to them.  The dispatch (``ops.py``) calls
    this on CUDA tensors."""
    return ssd_chunk_cuda(xdt, b, c, csum)


@ssd_chunk_op.register_fake
def _fake(xdt, b, c, csum):
    check_args(xdt, b, c, csum)
    BC, H, Q, P = xdt.shape
    y = xdt.new_empty((BC, Q, H, P)).transpose(1, 2)
    return y, xdt.new_empty((BC, H, b.shape[-1], P), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ssd_chunk)
def _flops(xdt_shape, b_shape, c_shape, csum_shape, *args, **kwargs) -> int:
    BC, H, Q, P = xdt_shape
    return ssd_flops(BC, H, Q, b_shape[-1], P)
