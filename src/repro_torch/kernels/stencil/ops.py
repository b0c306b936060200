"""Dispatch of the wave step and the k-step wave block by the device of
the tensors.

``wave_step`` and ``wave_block`` take the JAX package's argument order
(``kernels/stencil/ops.py``).  CPU tensors go to the plain versions
(``ref.py``); CUDA tensors go to the Hopper kernels
(``kernel.py::wave_step_cuda``, ``kernel.py::wave_block_shots_cuda``),
or the call raises.  Nothing falls back from one to the other.

2-D ``(NZ, NX)`` fields run as the S=1 batch of the same kernel.  The
JAX package's TPU knobs (``stream``, ``vmem_budget``, ``shot_tile``,
``bz``, ``use_pallas``, ``interpret``) have no meaning on Hopper — one
tiled kernel serves every field size — and are not taken.
``wave_block``'s ``tile`` picks the block kernel's CTA tile on CUDA
(the session's tuned tile); the plain version has no tiles, so passing
one with CPU tensors raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.stencil.kernel import (
    BLOCK_TILE,
    HALO,
    wave_block_shots_cuda,
    wave_step_cuda,
)
from repro_torch.kernels.stencil.ref import (
    wave_block_ref,
    wave_block_shots_ref,
    wave_step_ref,
)

__all__ = ["wave_step", "wave_block", "pick_bz_block", "pick_k"]


def pick_bz_block(nz: int, k: int, cap: int = 128) -> int:
    """Strip height of the JAX package's k-step kernel: the largest
    divisor of nz ≤ cap (8-aligned first) whose trapezoid window
    ``bz + 2·k·HALO`` fits the field, else nz.  Kept only so ``pick_k``
    picks the same k as the JAX package."""
    pad = 2 * k * HALO
    aligned = [b for b in range(8, cap + 1, 8)
               if nz % b == 0 and b + pad <= nz]
    if aligned:
        return max(aligned)
    ok = [b for b in range(2, cap + 1) if nz % b == 0 and b + pad <= nz]
    if ok:
        return max(ok)
    return nz


def pick_k(nz: int, cap: int = 8) -> int:
    """Fused-block length: the largest power of two ≤ cap whose
    trapezoid still admits a multi-strip tiling of nz (the JAX
    package's heuristic, so both packages run the same blocks)."""
    k = cap
    while k > 1 and pick_bz_block(nz, k) == nz and nz > 2 * k * HALO:
        k //= 2
    return max(k, 1)


def _as_index(v, ns: int, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.int32)
    return t.reshape(-1).expand(ns).to(device).contiguous()


def _device_of(p) -> str:
    """``"cpu"`` or ``"cuda"`` for the dispatch; raises on any other
    device."""
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stencil kernel for device {p.device}")
    return p.device.type


def wave_step(p, p_prev, v2dt2, sponge):
    """One timestep with no source and no receiver; returns
    (p_next, p_damped), both sponge-damped, shaped like ``p``: 2-D
    ``(NZ, NX)`` or a 3-D ``(S, NZ, NX)`` batch over shared model
    fields."""
    if p.ndim not in (2, 3):
        raise ValueError(f"p must be (NZ, NX) or (S, NZ, NX), "
                         f"got {tuple(p.shape)}")
    if _device_of(p) == "cpu":
        return wave_step_ref(p, p_prev, v2dt2, sponge)
    if p.ndim == 2:
        pn, pd = wave_step_cuda(p[None], p_prev[None], v2dt2, sponge)
        return pn[0], pd[0]
    return wave_step_cuda(p, p_prev, v2dt2, sponge)


def wave_block(p, p_prev, v2dt2, sponge, src_vals, src_z, src_x, *,
               receiver_row: int = 0,
               tile: tuple[int, int] | None = None):
    """k fused timesteps (k = ``src_vals.shape[-1]``); returns
    (p_k, p_prev_damped_k, traces).

    ``p_prev`` is the already sponge-damped previous field, and the
    second output is the damped p_{k-1}.  3-D ``(S, NZ, NX)`` fields
    take ``(S,)`` source positions and ``(k,)`` or ``(S, k)``
    amplitudes, and return traces ``(S, k, NX)``; 2-D fields take
    scalar positions and return ``(k, NX)``."""
    nz = p.shape[-2]
    if not 0 <= receiver_row < nz:
        raise ValueError(f"receiver_row {receiver_row} outside [0, {nz})")
    if _device_of(p) == "cpu":
        if tile is not None:
            raise ValueError("tile applies to the CUDA kernel; the plain "
                             "version on the CPU has no tiles")
        if p.ndim == 2:
            return wave_block_ref(
                p, p_prev, v2dt2, sponge, src_vals, src_z, src_x,
                receiver_row=receiver_row,
            )
        return wave_block_shots_ref(
            p, p_prev, v2dt2, sponge, src_vals, src_z, src_x,
            receiver_row=receiver_row,
        )
    tile = tile or BLOCK_TILE
    if p.ndim == 2:
        pk, ppk, tr = wave_block_shots_cuda(
            p[None], p_prev[None], v2dt2, sponge, src_vals,
            _as_index(src_z, 1, p.device), _as_index(src_x, 1, p.device),
            receiver_row=receiver_row, tile=tile,
        )
        return pk[0], ppk[0], tr[0]
    ns = p.shape[0]
    return wave_block_shots_cuda(
        p, p_prev, v2dt2, sponge, src_vals,
        _as_index(src_z, ns, p.device), _as_index(src_x, ns, p.device),
        receiver_row=receiver_row, tile=tile,
    )
