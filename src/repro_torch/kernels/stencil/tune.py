"""Tile sweeps of the Hopper stencil kernels — the counterparts of the
JAX package's TPU strip tuners (``kernels/stencil/kernel.py``).

* ``autotune_step_tile(nz, nx, ns)`` times ``wave_step_cuda`` over CTA
  tiles and returns the fastest (the counterpart of ``autotune_bz``).
* ``autotune_block(nz, nx, ns)`` times ``wave_block_shots_cuda`` over
  (tile, k) at the caller's own shot count and returns the fastest
  ``(tile, k)`` per step (the counterpart of ``autotune_bz_k``).  The
  session runs that same shot-batched kernel, so it tunes the kernel
  that will run.

Block-kernel candidates whose shared memory exceeds ``MAX_SMEM_BYTES``,
or whose window needs more threads than the kernel takes, are skipped;
step-kernel tiles are kept where they launch at every column count a
thread may get (``step_tile_launches``).
Each candidate is timed on the device by ``device_time_ms``.  The
sweeps are memoized per (shape, shot count, candidates, card name), so
a session rebuilt after a resize reuses the choice.  They time the card and raise on any other device:
the plain version has no tiles.
"""
from __future__ import annotations

import functools
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.stencil.kernel import (
    MAX_SMEM_BYTES,
    launch_shape,
    smem_bytes,
    step_tile_launches,
    wave_block_shots_cuda,
    wave_step_cuda,
)

#: CTA tiles (rows, columns) the sweeps try
STEP_TILES = ((4, 256), (8, 128), (8, 256), (8, 512), (16, 64), (16, 128),
              (16, 256), (32, 64), (32, 128), (64, 64))
BLOCK_TILES = ((16, 32), (16, 64), (32, 32), (32, 64), (32, 128),
               (64, 32), (64, 64))
BLOCK_KS = (1, 2, 4, 8)


def step_candidates(tiles=STEP_TILES) -> list[tuple[int, int]]:
    """The step-kernel tiles that launch at 4, 2 and 1 columns a thread
    (whatever NX and the tensors' alignment give)."""
    return [tuple(t) for t in tiles if step_tile_launches(t)]


def block_candidates(tiles=BLOCK_TILES, ks=BLOCK_KS
                     ) -> list[tuple[tuple[int, int], int]]:
    """The (tile, k) pairs of the block kernel that fit one CTA: its
    shared memory and its thread limit (``launch_shape``)."""
    return [(tuple(t), k) for k in ks for t in tiles
            if smem_bytes(k, *t) <= MAX_SMEM_BYTES
            and launch_shape(k, *t) is not None]


def _card(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the tile sweeps time the CUDA kernels; got "
                         f"device {dev} (the plain version has no tiles)")
    return dev


def device_time_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call.

    A small kernel runs for less time than Python takes to issue it, so
    events around calls issued one by one would time the host.  The
    timed calls are therefore queued behind a sleep kernel that outlasts
    the host time they took to issue in a first untimed pass (at most
    2 GHz, twice over): the device then runs them without gaps."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 10_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _fields(nz: int, nx: int, ns: int, dev: torch.device):
    """Seeded p and p_prev (two tensors, so the kernel reads as many
    bytes as on the engine's path) and constant model fields."""
    g = torch.Generator(device=dev).manual_seed(0)
    p = torch.randn((ns, nz, nx), generator=g, device=dev)
    pp = torch.randn((ns, nz, nx), generator=g, device=dev)
    v = torch.full((nz, nx), 0.1, device=dev)
    s = torch.ones((nz, nx), device=dev)
    return p, pp, v, s


@functools.lru_cache(maxsize=None)
def _sweep_step(nz, nx, ns, tiles, reps, card, dev):
    p, pp, v, s = _fields(nz, nx, ns, dev)
    return {t: device_time_ms(
                lambda t=t: wave_step_cuda(p, pp, v, s, tile=t), reps)
            for t in step_candidates(tiles)}


@functools.lru_cache(maxsize=None)
def _sweep_block(nz, nx, ns, tiles, ks, reps, card, dev):
    p, pp, v, s = _fields(nz, nx, ns, dev)
    sz = torch.full((ns,), nz // 2, dtype=torch.int32, device=dev)
    sx = (torch.arange(ns, device=dev) % nx).to(torch.int32)
    out = {}
    for t, k in block_candidates(tiles, ks):
        srcv = torch.zeros((k,), device=dev)
        ms = device_time_ms(lambda t=t, srcv=srcv: wave_block_shots_cuda(
            p, pp, v, s, srcv, sz, sx, receiver_row=0, tile=t), reps)
        out[(t, k)] = ms / k                       # per step
    return out


def sweep_step_tile(nz: int, nx: int, ns: int, *, tiles=STEP_TILES,
                    reps: int = 5, device="cuda"
                    ) -> dict[tuple[int, int], float]:
    """{tile: ms per step} of ``wave_step_cuda`` on an (ns, nz, nx)
    batch, for every tile that fits."""
    dev = _card(device)
    return dict(_sweep_step(nz, nx, ns, tuple(map(tuple, tiles)), reps,
                            torch.cuda.get_device_name(dev), dev))


def sweep_block(nz: int, nx: int, ns: int, *, tiles=BLOCK_TILES,
                ks=BLOCK_KS, reps: int = 3, device="cuda"
                ) -> dict[tuple[tuple[int, int], int], float]:
    """{(tile, k): ms per step} of ``wave_block_shots_cuda`` on an
    (ns, nz, nx) batch, for every pair that fits."""
    dev = _card(device)
    return dict(_sweep_block(nz, nx, ns, tuple(map(tuple, tiles)),
                             tuple(ks), reps,
                             torch.cuda.get_device_name(dev), dev))


def autotune_step_tile(nz: int, nx: int, ns: int, **kw) -> tuple[int, int]:
    """The fastest step-kernel tile for an (ns, nz, nx) batch."""
    times = sweep_step_tile(nz, nx, ns, **kw)
    return min(times, key=times.get)


def autotune_block(nz: int, nx: int, ns: int, **kw
                   ) -> tuple[tuple[int, int], int]:
    """The fastest (tile, k) per step of the block kernel for an
    (ns, nz, nx) batch."""
    times = sweep_block(nz, nx, ns, **kw)
    return min(times, key=times.get)
