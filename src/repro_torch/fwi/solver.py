"""FWI forward modeling on PyTorch — the paper's target application.

2-D acoustic wave propagation over a layered velocity model with a salt
body, Ricker-wavelet point sources (one per shot) and receiver traces
sampled near the surface.  The counterpart of the JAX package's
``fwi/solver.py``: the model fields are built in numpy exactly as there
(so they are bitwise equal), then moved to the device.

Two engines, both Python loops where the JAX package has a
``lax.scan``:

* ``make_scan_runner`` advances the shot batch one step at a time, one
  ``kernels.stencil.ops.wave_step`` per step, with the source injected
  after the kernel (``make_step_fn`` is its single step).  It is the
  step-at-a-time oracle, and the engine the calibration sweep times
  (``fwi/calibrate.py``).
* ``make_block_runner`` advances it through k-step fused blocks, one
  ``kernels.stencil.ops.wave_block`` per block, with a tail block of
  ``steps % k`` steps.  It is what ``run_forward`` and a one-stripe
  session use.
* ``make_shot_parallel_runner`` splits the shot axis over shards, each
  a block runner on its own shots (an uneven split pads with copies of
  shot 0); ``fwi/domain.py`` splits the x-axis instead.

On CUDA tensors every step or block is one launch of a Hopper kernel;
on CPU tensors it is the plain version.  Both do the same arithmetic in
the same order, so the two engines are bitwise equal.  The factories
are memoized on their full argument set, the device included.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.stencil.ops import pick_k, wave_block, wave_step


@dataclasses.dataclass(frozen=True)
class FWIConfig:
    nz: int = 600                 # paper Table 2: 600 x 600 grid
    nx: int = 600
    dt: float = 5e-4              # s
    dx: float = 5.0               # m
    timesteps: int = 600
    n_shots: int = 4              # paper Table 2: 4 shots
    sponge_width: int = 32
    sponge_strength: float = 0.0125
    source_freq: float = 12.0     # Hz Ricker
    receiver_depth: int = 2

    def shot_positions(self) -> np.ndarray:
        xs = np.linspace(self.nx * 0.2, self.nx * 0.8, self.n_shots)
        return np.stack(
            [np.full(self.n_shots, 4.0), xs], axis=1
        ).astype(np.int32)


def _velocity_np(cfg: FWIConfig) -> np.ndarray:
    z = np.arange(cfg.nz)[:, None]
    x = np.arange(cfg.nx)[None, :]
    v = 1500.0 + 2.2 * z                       # depth gradient, m/s
    for depth, dv in ((cfg.nz // 3, 400.0), (cfg.nz // 2, 500.0)):
        v = v + dv * (z > depth)
    # salt dome: high-velocity ellipse
    cz, cx = int(cfg.nz * 0.62), int(cfg.nx * 0.5)
    dome = ((z - cz) / (0.18 * cfg.nz)) ** 2 + (
        (x - cx) / (0.25 * cfg.nx)
    ) ** 2 < 1.0
    return np.where(dome, 4500.0, v).astype(np.float32)


def _sponge_np(cfg: FWIConfig) -> np.ndarray:
    w = cfg.sponge_width
    z = np.arange(cfg.nz)[:, None] + np.zeros((1, cfg.nx))
    x = np.arange(cfg.nx)[None, :] + np.zeros((cfg.nz, 1))
    dist = np.minimum.reduce([
        z, cfg.nz - 1 - z, x, cfg.nx - 1 - x,
        np.full((cfg.nz, cfg.nx), float(w)),
    ])
    taper = np.exp(-(cfg.sponge_strength * (w - dist)) ** 2)
    return np.where(dist >= w, 1.0, taper).astype(np.float32)


def _ricker_np(cfg: FWIConfig) -> np.ndarray:
    t = np.arange(cfg.timesteps) * cfg.dt
    t0 = 1.2 / cfg.source_freq
    a = (np.pi * cfg.source_freq * (t - t0)) ** 2
    return ((1 - 2 * a) * np.exp(-a) * 1e3).astype(np.float32)


def velocity_model(cfg: FWIConfig, device="cuda") -> torch.Tensor:
    """Layered model with a salt dome (paper Fig. 3 bottom), (NZ, NX)."""
    return torch.from_numpy(_velocity_np(cfg)).to(resolve_device(device))


def sponge_taper(cfg: FWIConfig, device="cuda") -> torch.Tensor:
    return torch.from_numpy(_sponge_np(cfg)).to(resolve_device(device))


def ricker(cfg: FWIConfig, device="cuda") -> torch.Tensor:
    return torch.from_numpy(_ricker_np(cfg)).to(resolve_device(device))


@dataclasses.dataclass(frozen=True)
class ModelFields:
    """Everything a block needs besides the wavefields, on one device."""

    v2dt2: torch.Tensor      # (NZ, NX) (v·dt/dx)²
    sponge: torch.Tensor     # (NZ, NX)
    amps: torch.Tensor       # (T,) source amplitude per step: ricker·dt²
    src_z: torch.Tensor      # (S,) int32
    src_x: torch.Tensor      # (S,) int32


@functools.lru_cache(maxsize=16)
def model_fields(cfg: FWIConfig, device: torch.device) -> ModelFields:
    """The model fields of ``cfg`` on ``device``, memoized so a session
    rebuilt after a resize reuses them.  Computed on the CPU in the JAX
    package's op order, then moved, so every device sees the same
    bits."""
    v = torch.from_numpy(_velocity_np(cfg))
    v2dt2 = (v * cfg.dt / cfg.dx) ** 2
    amps = torch.from_numpy(_ricker_np(cfg)) * (cfg.dt ** 2)
    pos = torch.from_numpy(cfg.shot_positions())
    return ModelFields(
        v2dt2=v2dt2.to(device),
        sponge=torch.from_numpy(_sponge_np(cfg)).to(device),
        amps=amps.to(device),
        src_z=pos[:, 0].contiguous().to(device),
        src_x=pos[:, 1].contiguous().to(device),
    )


@dataclasses.dataclass
class ShotState:
    """Propagation state for a batch of shots — the checkpointable unit
    (paper Fig.1 step 2 saves exactly this)."""

    p: torch.Tensor        # (S, NZ, NX)
    p_prev: torch.Tensor
    t: int

    @staticmethod
    def init(cfg: FWIConfig, device="cuda") -> "ShotState":
        dev = resolve_device(device)
        shape = (cfg.n_shots, cfg.nz, cfg.nx)
        return ShotState(
            p=torch.zeros(shape, dtype=torch.float32, device=dev),
            p_prev=torch.zeros(shape, dtype=torch.float32, device=dev),
            t=0,
        )


def _block_amps(mf: ModelFields, t0: int, kk: int,
                timesteps: int) -> torch.Tensor:
    """(kk,) source amplitudes of steps t0..t0+kk-1, clamped to the last
    step as the JAX package's ``jnp.clip`` does."""
    if t0 + kk <= timesteps:
        return mf.amps[t0: t0 + kk]
    idx = np.clip(np.arange(t0, t0 + kk), 0, timesteps - 1)
    # lint: disable=host-sync -- only a block that runs past the last
    # timestep takes this branch: k indices, once a run
    return mf.amps[torch.from_numpy(idx).to(mf.amps.device)]


@functools.lru_cache(maxsize=32)
def _raw_step_fn(cfg: FWIConfig, device: torch.device):
    """step(p, p_prev, t) -> (p_next, p_damped, trace (S, NX)) advancing
    all shots one timestep: one ``wave_step`` on the batch, then the
    source ``amps[clip(t, 0, T-1)]`` added at each shot's position (the
    JAX package's ``.at[].add``).  ``trace`` is a view of ``p_next``'s
    receiver row.

    The add is an accumulating ``put_`` on the flat index of each
    shot's source cell: one rounding, as in the block kernel.  On the
    card ``index_put_(accumulate=True)`` would cost ~30 launches per
    step (its index range check runs as reductions and asserts on the
    device); ``put_`` checks inside its one kernel."""
    mf = model_fields(cfg, device)
    shots = torch.arange(cfg.n_shots, device=device)
    flat = (shots * cfg.nz + mf.src_z.long()) * cfg.nx + mf.src_x.long()

    def step(p, p_prev, t: int):
        p_next, p_damped = wave_step(p, p_prev, mf.v2dt2, mf.sponge)
        amp = mf.amps[min(max(int(t), 0), cfg.timesteps - 1)]
        p_next.view(-1).put_(flat, amp.expand(cfg.n_shots),
                             accumulate=True)
        return p_next, p_damped, p_next[:, cfg.receiver_depth, :]

    return step


@functools.lru_cache(maxsize=32)
def make_step_fn(cfg: FWIConfig, *, device="cuda"):
    """step(p, p_prev, t) -> (p_next, p_damped, trace (S, NX)): one
    timestep of the whole shot batch; the trace is its own tensor."""
    raw = _raw_step_fn(cfg, resolve_device(device))

    def step(p, p_prev, t: int):
        p_next, p_damped, trace = raw(p, p_prev, t)
        return p_next, p_damped, trace.clone()

    return step


@functools.lru_cache(maxsize=32)
def make_scan_runner(cfg: FWIConfig, *, collect_traces: bool = False,
                     device="cuda"):
    """Step-at-a-time multi-step propagator: one ``wave_step`` launch
    per step.

    run(p, p_prev, t0, steps) -> (p, p_prev)                   [default]
                             -> (p, p_prev, traces (S, steps, NX)) [collect]

    The JAX package's ``unroll`` has no meaning for a Python loop and
    is not taken."""
    step = _raw_step_fn(cfg, resolve_device(device))

    def run(p, p_prev, t0: int, steps: int):
        traces = (p.new_empty((p.shape[0], steps, cfg.nx))
                  if collect_traces else None)
        for i in range(steps):
            p, p_prev, tr = step(p, p_prev, t0 + i)
            if collect_traces:
                traces[:, i] = tr
        if collect_traces:
            return p, p_prev, traces
        return p, p_prev

    return run


def _block_loop(cfg: FWIConfig, k: int, tile, collect_traces: bool,
                dev: torch.device):
    """run(p, p_prev, src_z, src_x, t0, steps): the k-step block loop
    (with its tail block) for any shot batch and source positions."""
    mf = model_fields(cfg, dev)

    def block(p, p_prev, src_z, src_x, t0, kk):
        return wave_block(
            p, p_prev, mf.v2dt2, mf.sponge,
            _block_amps(mf, t0, kk, cfg.timesteps), src_z, src_x,
            receiver_row=cfg.receiver_depth, tile=tile,
        )

    def run(p, p_prev, src_z, src_x, t0: int, steps: int):
        nblocks, tail = divmod(steps, k)
        traces = []
        for b in range(nblocks):
            p, p_prev, tr = block(p, p_prev, src_z, src_x, t0 + b * k, k)
            traces.append(tr)
        if tail:
            p, p_prev, tr = block(p, p_prev, src_z, src_x,
                                  t0 + nblocks * k, tail)
            traces.append(tr)
        if not collect_traces:
            return p, p_prev
        if not traces:
            return p, p_prev, p.new_zeros((p.shape[0], 0, cfg.nx))
        return p, p_prev, torch.cat(traces, dim=1)

    return run


@functools.lru_cache(maxsize=32)
def make_block_runner(cfg: FWIConfig, *, k: int | None = None,
                      collect_traces: bool = True, tile=None,
                      device="cuda"):
    """Fused multi-step propagator over k-step blocks.

    run(p, p_prev, t0, steps) -> (p, p_prev, traces (S, steps, NX)),
    or (p, p_prev) with ``collect_traces=False``.  A step count that is
    not a multiple of k ends with a tail block of ``steps % k`` steps.
    ``run.k`` is the block length; ``tile`` the kernel's CTA tile (CUDA
    only; default ``kernel.BLOCK_TILE``)."""
    dev = resolve_device(device)
    if k is None:
        k = pick_k(cfg.nz)
    mf = model_fields(cfg, dev)
    loop = _block_loop(cfg, k, tile, collect_traces, dev)

    def run(p, p_prev, t0: int, steps: int):
        return loop(p, p_prev, mf.src_z, mf.src_x, t0, steps)

    run.k = k
    return run


def make_shot_parallel_runner(cfg: FWIConfig, n_devices: int, *,
                              k: int | None = None,
                              collect_traces: bool = True, tile=None,
                              devices=None):
    """Block runner with the SHOT axis split over ``n_devices`` shards:
    the paper's first-level task-parallel split (shots are independent),
    with no communication.  ``devices``: one device for every shard
    (default the card, where all shards then run in turn) or one per
    shard.  Returns (run, place): run(p, p_prev, t0, steps) as
    ``make_block_runner``; ``place`` pads the (S, NZ, NX) fields.

    An uneven split (``n_shots % n_devices != 0``) pads the batch to
    the next multiple by repeating shot 0 (its source position too);
    the padded shots propagate as throwaway copies and every output is
    sliced back to ``n_shots``.  ``place`` and ``run`` take padded or
    unpadded fields.  Each shot's arithmetic does not depend on its
    batch, so the result is bitwise equal to ``make_block_runner``'s.
    Memoized on the resolved devices, so a list of them is taken too."""
    if devices is None or isinstance(devices, (str, torch.device)):
        devs = (resolve_device("cuda" if devices is None else devices),) \
            * n_devices
    else:
        devs = tuple(resolve_device(d) for d in devices)[:n_devices]
        if len(devs) < n_devices:
            raise ValueError(f"{n_devices} shards on {len(devs)} devices")
    return _shot_parallel_runner(cfg, devs, pick_k(cfg.nz) if k is None
                                 else k, collect_traces, tile)


@functools.lru_cache(maxsize=16)
def _shot_parallel_runner(cfg: FWIConfig, devs: tuple, k: int,
                          collect_traces: bool, tile):
    n_devices = len(devs)
    pad = (-cfg.n_shots) % n_devices
    per = (cfg.n_shots + pad) // n_devices
    pos = cfg.shot_positions()
    if pad:
        pos = np.concatenate([pos, np.repeat(pos[:1], pad, axis=0)])
    shards = []
    for i, dev in enumerate(devs):
        sl = pos[i * per: (i + 1) * per]
        shards.append((
            dev,
            torch.from_numpy(np.ascontiguousarray(sl[:, 0])).to(dev),
            torch.from_numpy(np.ascontiguousarray(sl[:, 1])).to(dev),
            _block_loop(cfg, k, tile, collect_traces, dev),
        ))

    def _pad_shots(f):
        if pad and f.shape[0] == cfg.n_shots:
            f = torch.cat([f, f[:1].expand(pad, *f.shape[1:])])
        return f

    def run(p, p_prev, t0: int, steps: int):
        p, p_prev = _pad_shots(p), _pad_shots(p_prev)
        outs = [loop(p[i * per: (i + 1) * per].to(dev),
                     p_prev[i * per: (i + 1) * per].to(dev),
                     sz, sx, t0, steps)
                for i, (dev, sz, sx, loop) in enumerate(shards)]
        home = devs[0]
        return tuple(
            torch.cat([o[j].to(home) for o in outs])[: cfg.n_shots]
            for j in range(len(outs[0])))

    def place(state_fields):
        if isinstance(state_fields, torch.Tensor):
            return _pad_shots(state_fields).to(devs[0])
        return tuple(_pad_shots(f).to(devs[0]) for f in state_fields)

    run.k = k
    return run, place


def run_forward(cfg: FWIConfig, *, state: ShotState | None = None,
                steps: int | None = None, k: int | None = None,
                device="cuda"):
    """Propagate ``steps`` timesteps (default: to completion) through the
    fused block runner.  Returns (state, traces (S, T, NX) for the steps
    actually run)."""
    dev = resolve_device(device)
    st = state or ShotState.init(cfg, dev)
    steps = steps if steps is not None else cfg.timesteps - st.t
    if steps <= 0:
        return st, torch.zeros((cfg.n_shots, 0, cfg.nx), device=dev)
    run = make_block_runner(cfg, k=k, collect_traces=True, device=dev)
    p, pp, traces = run(st.p.to(dev), st.p_prev.to(dev), st.t, steps)
    return ShotState(p=p, p_prev=pp, t=st.t + steps), traces
