"""Plain PyTorch versions of the wave-equation stencil — the oracle the
CUDA kernel is held to.

2-D acoustic wave equation, 2nd-order in time, 4th-order in space:

    p_next = (2·p − p_prev + (v·dt/dx)²·∇²p) · sponge

with the 4th-order central Laplacian ``[-1/12, 4/3, -5/2, 4/3, -1/12]``
per axis and a zero halo at the physical boundary.

Every function here repeats the JAX reference (``repro`` package,
``kernels/stencil/ref.py``) op for op in the SAME accumulation order:
the centre term ``2·C0·p``, then ``lap + C1·(((p[z-1] + p[z+1]) +
p[x-1]) + p[x+1])``, then the same ring with C2 at distance 2.  Each
op is one IEEE f32 rounding, so on the CPU these functions are bitwise
equal to their JAX twins, and on the card bitwise equal to the CUDA
kernel built with ``--fmad=false`` (``kernels/stencil/kernel.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

C0 = -5.0 / 2.0
C1 = 4.0 / 3.0
C2 = -1.0 / 12.0

_PAD = 2     # stencil reach per axis


def laplacian_of_padded(padded: torch.Tensor, nz: int, nx: int
                        ) -> torch.Tensor:
    """Laplacian of the (..., NZ, NX) field held inside a zero-padded
    (..., NZ+4, NX+4) tensor: nine slices, fixed accumulation order."""

    def sh(dz: int, dx: int) -> torch.Tensor:
        return padded[..., _PAD - dz: _PAD - dz + nz,
                      _PAD - dx: _PAD - dx + nx]

    lap = 2.0 * C0 * sh(0, 0)
    for d in (1, 2):
        c = C1 if d == 1 else C2
        lap = lap + c * (sh(d, 0) + sh(-d, 0) + sh(0, d) + sh(0, -d))
    return lap


def laplacian(p: torch.Tensor, inv_h2: float = 1.0) -> torch.Tensor:
    """Zero-halo Laplacian of a (..., NZ, NX) field (one pad, nine
    slices); bitwise equal to ``laplacian_of_padded`` of the pad."""
    nz, nx = p.shape[-2], p.shape[-1]
    return laplacian_of_padded(F.pad(p, (_PAD,) * 4), nz, nx) * inv_h2


def wave_step_ref(p, p_prev, v2dt2, sponge):
    """One timestep.  Returns (p_next, p_damped), both sponge-damped."""
    lap = laplacian(p)
    p_next = (2.0 * p - p_prev + v2dt2 * lap) * sponge
    return p_next, p * sponge


def wave_block_shots_ref(
    p: torch.Tensor,         # (S, NZ, NX) shot batch, current pressure
    p_prev: torch.Tensor,    # (S, NZ, NX) previous, already sponge-damped
    v2dt2: torch.Tensor,     # (NZ, NX) shared model field
    sponge: torch.Tensor,    # (NZ, NX) shared model field
    src_vals: torch.Tensor,  # (k,) shared or (S, k) per-shot amplitudes
    src_z,                   # (S,) int per-shot source rows
    src_x,                   # (S,) int per-shot source columns
    *,
    receiver_row: int = 0,
):
    """k fused timesteps for a shot batch; k is ``src_vals.shape[-1]``.

    Per inner step j: ``pn = (2·cur − prevd + v2dt2·lap(cur))·sponge``,
    then ``pn[s, src_z[s], src_x[s]] += src_vals[s, j]``, the receiver
    row ``pn[:, receiver_row, :]`` is captured, and the carry becomes
    ``(pn, cur·sponge)``.  Returns (p_k, p_prev_damped_k,
    traces (S, k, NX))."""
    ns, nz, nx = p.shape
    k = src_vals.shape[-1]
    sv = src_vals.to(p.dtype)
    if sv.ndim == 1:
        sv = sv.expand(ns, k)
    # lint: disable=host-sync -- the plain version, which the dispatch
    # (ops.py) runs on CPU tensors only: no copy to a card
    zi = torch.as_tensor(src_z, dtype=torch.long, device=p.device)
    # lint: disable=host-sync -- the plain version runs on CPU tensors
    xi = torch.as_tensor(src_x, dtype=torch.long, device=p.device)
    zi, xi = zi.expand(ns), xi.expand(ns)
    sidx = torch.arange(ns, device=p.device)
    cur, prevd = p, p_prev
    traces = []
    for j in range(k):
        lap = laplacian_of_padded(F.pad(cur, (_PAD,) * 4), nz, nx)
        pn = (2.0 * cur - prevd + v2dt2 * lap) * sponge
        pn = pn.index_put((sidx, zi, xi), sv[:, j], accumulate=True)
        traces.append(pn[:, receiver_row, :])
        prevd = cur * sponge
        cur = pn
    return cur, prevd, torch.stack(traces, dim=1)


def wave_block_ref(
    p: torch.Tensor,         # (NZ, NX) current pressure
    p_prev: torch.Tensor,    # (NZ, NX) previous, already sponge-damped
    v2dt2: torch.Tensor,     # (NZ, NX)
    sponge: torch.Tensor,    # (NZ, NX)
    src_vals: torch.Tensor,  # (k,) source amplitude per inner step
    src_z: int,
    src_x: int,
    *,
    receiver_row: int = 0,
):
    """Single-shot ``wave_block_shots_ref``: the S=1 batch, squeezed.
    Returns (p_k, p_prev_damped_k, traces (k, NX))."""
    pk, ppk, tr = wave_block_shots_ref(
        p[None], p_prev[None], v2dt2, sponge, src_vals,
        [int(src_z)], [int(src_x)], receiver_row=receiver_row,
    )
    return pk[0], ppk[0], tr[0]
