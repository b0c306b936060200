"""Python wrappers of the Hopper stencil kernels (``csrc/*.cu``).

``wave_block_shots_cuda`` (``csrc/wave_block.cu``) advances a shot
batch k fused leapfrog steps in one launch.  It replaces the JAX
package's four k-step Pallas kernels (``kernels/stencil/kernel.py``:
``wave_block_shots_pallas``, ``wave_block_shots_stream_pallas`` and, as
the S=1 batch, ``wave_block_pallas`` and ``wave_block_stream_pallas``).
Its least traffic per block is ``block_bytes(S, NZ, NX, k)``.

``wave_step_cuda`` (``csrc/wave_step.cu``) advances a shot batch one
step with no source and no receiver.  It replaces ``wave_step_pallas``
(``kernel.py:157``), which the JAX package vmaps over shots.  Its least
traffic per step is ``step_bytes(S, NZ, NX)``.  Both kernels are bound
by memory.  The step kernel streams: each thread walks a strip of rows
of V adjacent columns with no shared memory, and ``step_launch``
derives V, the strip's rows and the CTA's threads from the tile, the
shape and the tensors' alignment.

Each wrapper checks what its kernel takes and raises on anything else,
allocates the outputs, launches on PyTorch's current stream without
synchronising, raises if the launch is refused, and counts launches in
its ``launches`` attribute.  The owned tile of one CTA, ``tile=(TZ,
TX)``, is a launch argument (``kernels/stencil/tune.py`` sweeps it).
For the block kernel the wrapper also picks, by rules tested on the
CPU, the launch shape (``launch_shape``: rows per thread and CTAs per
SM) and how many CTAs per tile the shots are spread over
(``shot_groups``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import MAX_SMEM_BYTES

HALO = 2
#: the block kernel's launch shapes in the order the wrapper prefers
#: them: (rows per thread, CTAs per SM, most threads of one CTA).  Two
#: CTAs per SM where the window is small enough, the longer strips
#: first: the order measured fastest on the H100 (``PERF.md`` §6)
LAUNCHES = ((8, 2, 256), (4, 2, 512), (4, 1, 768), (8, 1, 576))
#: f32 buffers of one block-kernel CTA in shared memory
WINDOWS = 2
#: block-kernel CTAs per SM that ``shot_groups`` aims the grid at
CTAS_PER_SM = 4
#: owned output tile of one step-kernel CTA (rows, columns): the
#: fastest at 600² and within 2 % of the fastest at 4096² on the H100
#: (``tools/step_bench.py --variants``, ``PERF.md`` §6)
TILE_Z = 16
TILE_X = 128
#: rows of the strip one step-kernel thread walks, longest first: 4
#: was the fastest at 600² and 4096², 2 only on narrow fields
STEP_ROWS = (4, 2)
#: columns a step-kernel thread may own, most first (``step_vector``)
STEP_VECTORS = (4, 2, 1)
#: step-kernel threads per SM that ``step_launch`` aims the grid at: at
#: nz=600 strips of 4 rows lead from 384 columns up, 2 rows below
STEP_THREADS_PER_SM = 384
#: owned output tile of one block-kernel CTA (rows, columns)
BLOCK_TILE = (32, 64)

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The block kernel's library, built at first use, with its C
    signatures."""
    lib = build.load("wave_block")
    lib.wave_block_shots_launch.argtypes = (
        [_VOIDP] * 5 + [_INT] + [_VOIDP] * 5 + [_INT] * 10 + [_VOIDP]
    )
    lib.wave_block_shots_launch.restype = _INT
    lib.wave_block_error_string.argtypes = [_INT]
    lib.wave_block_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _step_lib() -> ctypes.CDLL:
    """The step kernel's library, built at first use, with its C
    signatures."""
    lib = build.load("wave_step")
    lib.wave_step_shots_launch.argtypes = [_VOIDP] * 6 + [_INT] * 7 + [_VOIDP]
    lib.wave_step_shots_launch.restype = _INT
    lib.wave_step_error_string.argtypes = [_INT]
    lib.wave_step_error_string.restype = ctypes.c_char_p
    return lib


def window(k: int, tz: int = BLOCK_TILE[0], tx: int = BLOCK_TILE[1]
           ) -> tuple[int, int]:
    """The (rows, columns) of one block-kernel CTA's window: its owned
    tile widened by the trapezoid's reach, k·HALO, on every side."""
    return tz + 2 * k * HALO, tx + 2 * k * HALO


def smem_bytes(k: int, tz: int = BLOCK_TILE[0], tx: int = BLOCK_TILE[1]
               ) -> int:
    """Dynamic shared memory of one block-kernel CTA: ``WINDOWS`` f32
    buffers, each the window's rows rounded up to whole strips of the
    launch's rows per thread, with HALO zero rows above and below
    (``block_smem_bytes`` in the source, which the library's
    ``wave_block_smem_bytes`` returns)."""
    wz, wx = window(k, tz, tx)
    rows = (launch_shape(k, tz, tx) or (8,))[0]
    return WINDOWS * (-(-wz // rows) * rows + 2 * HALO) * wx * 4


def block_threads(k: int, tz: int, tx: int, rows: int) -> int:
    """Threads of one block-kernel CTA: one per pair of window columns
    and strip of ``rows`` rows."""
    wz, wx = window(k, tz, tx)
    return wx // 2 * -(-wz // rows)


def launch_shape(k: int, tz: int = BLOCK_TILE[0], tx: int = BLOCK_TILE[1]
                 ) -> tuple[int, int] | None:
    """(rows per thread, CTAs per SM) of the first of ``LAUNCHES`` whose
    thread limit the CTA fits, or None where none does (the tile is not
    launched)."""
    for rows, ctas, limit in LAUNCHES:
        if block_threads(k, tz, tx, rows) <= limit:
            return rows, ctas
    return None


def shot_groups(ns: int, tiles: int, sms: int) -> int:
    """CTAs per tile that the shots are spread over (grid z).  Each CTA
    takes ``ceil(ns·tiles / (CTAS_PER_SM·sms))`` shots, at least one, so
    a grid of few tiles (600² and smaller) still fills the card; the
    CTAs of one tile then re-read its model windows from L2."""
    per_cta = max(1, -(-ns * tiles // (CTAS_PER_SM * sms)))
    return -(-ns // per_cta)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def step_vector(nx: int, addresses=()) -> int:
    """Columns per step-kernel thread: 4, 2 or 1, the most for which NX
    and every tensor's address allow one aligned 16-, 8- or 4-byte
    access per row."""
    for vec in STEP_VECTORS[:-1]:
        if nx % vec == 0 and all(a % (4 * vec) == 0 for a in addresses):
            return vec
    return 1


def step_shapes(tile, vec: int) -> list[tuple[int, int]]:
    """(rows per thread, threads) of every strip length in ``STEP_ROWS``
    with which a (tz, tx) tile launches at ``vec`` columns a thread,
    longest strip first: tx/vec lanes across (8, 16 or a multiple of
    32: a shuffle segment), tz/rows strips down, a whole number of warps
    and at most 1024/vec threads (the kernel's launch bounds)."""
    tz, tx = tile
    if tx % vec:
        return []
    lanes = tx // vec
    if lanes not in (8, 16) and lanes % 32:
        return []
    out = []
    for rows in STEP_ROWS:
        threads = lanes * (tz // rows)
        if tz % rows == 0 and threads % 32 == 0 \
                and 0 < threads <= 1024 // vec:
            out.append((rows, threads))
    return out


def step_tile_launches(tile) -> bool:
    """Whether a (tz, tx) tile launches at every column count in
    ``STEP_VECTORS``, so whatever NX and the tensors' alignment give.
    The wrapper takes no other tile, and the tuner offers no other."""
    return all(step_shapes(tile, vec) for vec in STEP_VECTORS)


def step_launch(ns: int, nz: int, nx: int, tile, vec: int, sms: int
                ) -> dict | None:
    """The step kernel's launch for an (ns, nz, nx) batch: ``vec``
    columns a thread, the longest strip whose grid still has
    ``STEP_THREADS_PER_SM`` threads on each of ``sms`` SMs (else the
    shortest that launches), one shot per CTA (the shot is the fastest
    block index).  None if the tile cannot launch at ``vec``."""
    shapes = step_shapes(tile, vec)
    if not shapes:
        return None
    tz, tx = tile
    tiles = -(-nz // tz) * -(-nx // tx)
    rows, threads = next(
        (s for s in shapes
         if ns * tiles * s[1] >= STEP_THREADS_PER_SM * sms),
        shapes[-1])
    return {"vec": vec, "rows": rows, "threads": threads,
            "blocks": tiles * ns}


def block_bytes(ns: int, nz: int, nx: int, k: int) -> int:
    """Least HBM traffic of one block: read p, p_prev, v2dt2, sponge
    once, write p_k, prevd_k and the (S, k, NX) traces."""
    return 4 * ((4 * ns + 2) * nz * nx + ns * k * nx)


def block_flops(ns: int, nz: int, nx: int, k: int) -> int:
    """f32 operations of one block: 17 per cell and step."""
    return 17 * ns * k * nz * nx


def step_bytes(ns: int, nz: int, nx: int) -> int:
    """Least HBM traffic of one step: read p and p_prev per shot and
    v2dt2, sponge once, write p_next and p_damped per shot."""
    return 4 * (4 * ns + 2) * nz * nx


def step_flops(ns: int, nz: int, nx: int) -> int:
    """f32 operations of one step: 17 per cell."""
    return 17 * ns * nz * nx


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tile(tile, smem: int) -> tuple[int, int]:
    # lint: disable=host-sync -- the tile is the caller's host tuple of
    # ints (a launch argument), never a tensor: int() copies nothing
    tz, tx = (int(v) for v in tile)
    if tz < 1 or tx < 1:
        raise ValueError(f"tile {tile} must be positive")
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"tile {tile} needs {smem} B of shared memory "
                         f"per CTA, more than {MAX_SMEM_BYTES}")
    return tz, tx


def wave_block_shots_cuda(
    p: torch.Tensor,         # (S, NZ, NX) f32, CUDA
    p_prev: torch.Tensor,    # (S, NZ, NX) f32, already sponge-damped
    v2dt2: torch.Tensor,     # (NZ, NX) f32, shared by all shots
    sponge: torch.Tensor,    # (NZ, NX) f32
    src_vals: torch.Tensor,  # (k,) shared or (S, k) per-shot f32
    src_z: torch.Tensor,     # (S,) int32 source rows
    src_x: torch.Tensor,     # (S,) int32 source columns
    *,
    receiver_row: int,
    tile: tuple[int, int] = BLOCK_TILE,
):
    """k fused timesteps on the card; k is ``src_vals.shape[-1]``.
    Returns (p_k, p_prev_damped_k, traces (S, k, NX)).  Sources outside
    the field inject nothing."""
    if p.device.type != "cuda":
        raise ValueError(f"wave_block_shots_cuda needs CUDA tensors, "
                         f"got {p.device}")
    if p.ndim != 3:
        raise ValueError(f"p must be (S, NZ, NX), got {tuple(p.shape)}")
    ns, nz, nx = p.shape
    dev = p.device
    f32 = torch.float32
    if src_vals.ndim not in (1, 2):
        raise ValueError("src_vals must be (k,) or (S, k)")
    k = src_vals.shape[-1]
    if src_vals.ndim == 1:
        src_vals = src_vals.expand(ns, k)
    if src_vals.stride(-1) != 1 and k > 1:
        raise ValueError("src_vals must be contiguous along k")
    _check("p", p, f32, (ns, nz, nx), dev)
    _check("p_prev", p_prev, f32, (ns, nz, nx), dev)
    _check("v2dt2", v2dt2, f32, (nz, nx), dev)
    _check("sponge", sponge, f32, (nz, nx), dev)
    if src_vals.device != dev or src_vals.dtype != f32 \
            or tuple(src_vals.shape) != (ns, k):
        raise ValueError(f"src_vals must be f32 (k,) or ({ns}, k) on {dev}")
    _check("src_z", src_z, torch.int32, (ns,), dev)
    _check("src_x", src_x, torch.int32, (ns,), dev)
    if k < 1:
        raise ValueError("k must be at least 1")
    if not 0 <= receiver_row < nz:
        raise ValueError(f"receiver_row {receiver_row} outside [0, {nz})")
    tz, tx = _check_tile(tile, smem_bytes(k, *tile))
    if tx % 2:
        raise ValueError(f"tile {tile} needs an even column count")
    shape = launch_shape(k, tz, tx)
    if shape is None:
        raise ValueError(f"tile {tile} at k={k} needs more threads per CTA "
                         f"than the kernel takes")
    tiles = -(-nz // tz) * -(-nx // tx)
    groups = shot_groups(ns, tiles, _sm_count(dev.index or 0))
    p_out = torch.empty_like(p)
    pp_out = torch.empty_like(p)
    traces = torch.empty((ns, k, nx), dtype=f32, device=dev)
    if ns == 0 or nz == 0 or nx == 0:
        return p_out, pp_out, traces
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.wave_block_shots_launch(
            p.data_ptr(), p_prev.data_ptr(), v2dt2.data_ptr(),
            sponge.data_ptr(), src_vals.data_ptr(), src_vals.stride(0),
            src_z.data_ptr(), src_x.data_ptr(),
            p_out.data_ptr(), pp_out.data_ptr(), traces.data_ptr(),
            ns, nz, nx, k, int(receiver_row), tz, tx, *shape, groups,
            stream,
        )
    if err != 0:
        msg = lib.wave_block_error_string(err).decode()
        raise RuntimeError(f"wave_block_shots launch failed: {msg} ({err})")
    wave_block_shots_cuda.launches += 1
    return p_out, pp_out, traces


wave_block_shots_cuda.launches = 0


def wave_step_cuda(
    p: torch.Tensor,         # (S, NZ, NX) f32, CUDA
    p_prev: torch.Tensor,    # (S, NZ, NX) f32
    v2dt2: torch.Tensor,     # (NZ, NX) f32, shared by all shots
    sponge: torch.Tensor,    # (NZ, NX) f32
    *,
    tile: tuple[int, int] = (TILE_Z, TILE_X),
):
    """One timestep on the card, no source and no receiver.  Returns
    (p_next, p_damped), both (S, NZ, NX) and sponge-damped."""
    if p.device.type != "cuda":
        raise ValueError(f"wave_step_cuda needs CUDA tensors, got {p.device}")
    if p.ndim != 3:
        raise ValueError(f"p must be (S, NZ, NX), got {tuple(p.shape)}")
    ns, nz, nx = p.shape
    dev = p.device
    f32 = torch.float32
    _check("p", p, f32, (ns, nz, nx), dev)
    _check("p_prev", p_prev, f32, (ns, nz, nx), dev)
    _check("v2dt2", v2dt2, f32, (nz, nx), dev)
    _check("sponge", sponge, f32, (nz, nx), dev)
    tile = tuple(int(v) for v in tile)
    if not step_tile_launches(tile):
        raise ValueError(f"tile {tile} does not launch at every column "
                         f"count a thread (kernel.step_shapes)")
    p_next = torch.empty_like(p)
    p_damped = torch.empty_like(p)
    tensors = (p, p_prev, v2dt2, sponge, p_next, p_damped)
    vec = step_vector(nx, [t.data_ptr() for t in tensors])
    launch = step_launch(ns, nz, nx, tile, vec, _sm_count(dev.index or 0))
    if ns and nz and nx:
        _launch_step(tensors, tile, launch)
    return p_next, p_damped


wave_step_cuda.launches = 0
#: the ``step_launch`` dict of the last launch made
wave_step_cuda.last_launch = None


def _launch_step(tensors, tile, launch: dict) -> None:
    """Launch the step kernel on (p, p_prev, v2dt2, sponge, p_next,
    p_damped) as ``launch`` says; raises if the launch is refused.
    Records ``launch`` in ``wave_step_cuda.last_launch``."""
    p = tensors[0]
    ns, nz, nx = p.shape
    lib = _step_lib()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        err = lib.wave_step_shots_launch(
            *(t.data_ptr() for t in tensors), ns, nz, nx, *tile,
            launch["vec"], launch["rows"], stream,
        )
    if err != 0:
        msg = lib.wave_step_error_string(err).decode()
        raise RuntimeError(f"wave_step_shots launch failed: {msg} ({err})")
    wave_step_cuda.launches += 1
    wave_step_cuda.last_launch = dict(launch, tile=tuple(tile))
