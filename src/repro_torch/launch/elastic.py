"""The rank side of an elastic training run: the functions a
``launch/world.py::World`` runs on each rank (``world.call(fn, ...)``).

A run moves from one world to another through a checkpoint: ``setup``
builds the train rules, the state's placements and the step on the
rank's mesh (``launch/train.py::build_session`` with a constant-rate
optimizer), ``init`` places the first state, ``step`` takes one step of
the synthetic pipeline's batches and returns its loss, ``save`` writes a
``CheckpointManager`` generation (gathered on every rank, written by
rank 0) and ``restore`` puts a generation onto this world's placements
(``restore(..., shardings=)``), whatever world wrote it.  Every function
enters the same collectives on every rank, or the world hangs until its
timeout.  Rank 0's return value reaches the controller.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import RunConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.launch.serve import KERNELS
from repro_torch.launch.train import build_session, gathered
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import map_specs, tree_leaves, tree_map
from repro_torch.optim import constant, make_optimizer
from repro_torch.runtime import train_step as ts
from repro_torch.sharding.rules import distribute_params, mesh_shape


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """What every world of a run trains: the model, the run's knobs, the
    batches' shape and the rate of the run's optimizer, held constant
    (picklable, so it crosses to the ranks)."""

    cfg: ModelConfig
    run: RunConfig
    shape: ShapeConfig
    lr: float = 1e-3

    def make_optimizer(self):
        return make_optimizer(self.run.optimizer or self.cfg.optimizer,
                              constant(self.lr))


@dataclasses.dataclass
class _Session:
    spec: TrainSpec
    opt: object
    sch: dict
    shardings: dict
    step_fn: object
    rules: object
    pipeline: SyntheticLMPipeline
    state: dict | None = None


def _sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _session(ctx) -> _Session:
    return ctx.objs["train"]


def setup(ctx, spec: TrainSpec) -> dict:
    """Build the session on the rank's mesh; its mesh and seconds."""
    t0 = time.monotonic()
    opt, sch, shardings, step_fn, rules = build_session(
        spec.cfg, spec.run, ctx.mesh, 0, opt=spec.make_optimizer())
    ctx.objs["train"] = _Session(
        spec, opt, sch, shardings, step_fn, rules,
        SyntheticLMPipeline(spec.cfg, spec.shape, device=ctx.device))
    return {"mesh": mesh_shape(ctx.mesh), "seconds": time.monotonic() - t0}


def init(ctx, seed: int = 0, params=None) -> dict:
    """The step-0 state at its placements: parameters from a seeded
    ``torch.Generator`` on the rank's device, or ``params`` (a nested
    dict of numpy arrays in the JAX package's layout,
    ``models/convert.py::params_from_numpy``)."""
    s = _session(ctx)
    t0 = time.monotonic()
    if params is None:
        gen = torch.Generator(device=ctx.device).manual_seed(seed)
        p = ts.init_state(s.sch, gen, ctx.device)
    else:
        p = params_from_numpy(s.spec.cfg, params, ctx.device, train=True)
    s.state = distribute_params(ts.new_state(p, s.opt), s.shardings)
    _sync(ctx)
    return {"seconds": time.monotonic() - t0}


def zero_counts(ctx) -> None:
    """Every kernel's launch count set to 0 on the rank."""
    for fn in KERNELS.values():
        fn.launches = 0


def counts(ctx) -> dict:
    """Every kernel's launch count on the rank."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def step(ctx, i: int) -> dict:
    """One step on the pipeline's batch ``i``: its loss (a collective:
    every rank makes it whole) and host seconds."""
    s = _session(ctx)
    batch = ts.distribute_batch(s.pipeline.batch_at(i), s.rules)
    _sync(ctx)
    t0 = time.monotonic()
    s.state, metrics = s.step_fn(s.state, batch)
    loss = float(metrics["loss"])
    _sync(ctx)
    return {"loss": loss, "host_s": time.monotonic() - t0}


def save(ctx, directory: str, step_: int) -> dict:
    """A generation of the state at ``step_`` in ``directory`` (with the
    pipeline's position, ``data_step``); its seconds and bytes."""
    s = _session(ctx)
    _sync(ctx)
    t0 = time.monotonic()
    full = gathered(s.state)
    CheckpointManager(directory, async_save=False).save(
        step_, full, extra={"data_step": step_})
    del full
    seconds = time.monotonic() - t0
    d = Path(directory) / f"step_{step_:08d}"
    return {"seconds": seconds,
            "bytes": sum(f.stat().st_size for f in d.iterdir())}


def restore(ctx, directory: str, step_: int) -> dict:
    """The generation at ``step_`` of ``directory`` onto this world's
    placements; its seconds and the pipeline's position."""
    s = _session(ctx)
    s.state = None
    t0 = time.monotonic()
    s.state, extra = CheckpointManager(directory, async_save=False).restore(
        s.sch, step=step_, shardings=s.shardings)
    _sync(ctx)
    return {"seconds": time.monotonic() - t0,
            "data_step": int(extra["data_step"])}


def leaf_names(sch) -> list[str]:
    """The state's leaves' paths, in ``tree_leaves`` order."""
    return tree_leaves(map_specs(lambda path, _: "/".join(path), sch))


#: bytes of a leaf copied to the host at a time for its CRC
_CRC_CHUNK = 1 << 26


def _crc(t: torch.Tensor) -> int:
    """CRC-32 of a leaf's bytes.  A device leaf is copied to the host a
    chunk at a time through a pinned buffer (a pageable copy runs at a
    fraction of the link's rate); several leaves go side by side, their
    copies overlapping the sums."""
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if not flat.is_cuda:
        return zlib.crc32(flat.numpy())
    buf = torch.empty(min(_CRC_CHUNK, flat.numel()), dtype=torch.uint8,
                      pin_memory=True)
    crc = 0
    for i in range(0, flat.numel(), _CRC_CHUNK):
        n = min(_CRC_CHUNK, flat.numel() - i)
        buf[:n].copy_(flat[i:i + n])
        crc = zlib.crc32(buf[:n].numpy(), crc)
    return crc


def state_crcs(ctx) -> dict | None:
    """CRC-32 of every leaf's bytes, by leaf path (rank 0; the gather is
    a collective)."""
    s = _session(ctx)
    full = gathered(s.state)
    if ctx.rank != 0:
        return None
    names = leaf_names(s.sch)
    with ThreadPoolExecutor(8) as pool:      # zlib lets go of the GIL
        return dict(zip(names, pool.map(_crc, tree_leaves(full))))


def state_numpy(ctx) -> dict | None:
    """The state gathered whole, as numpy arrays (rank 0)."""
    full = gathered(_session(ctx).state)
    if ctx.rank != 0:
        return None
    return tree_map(lambda t: t.detach().cpu().numpy(), full)


def placed(ctx) -> bool:
    """Whether every leaf of the state is a DTensor at its placements."""
    s = _session(ctx)
    return all(tuple(t.placements) == sh.placements
               and t.device_mesh == sh.mesh
               for t, sh in zip(tree_leaves(s.state),
                                tree_leaves(s.shardings)))


def memory(ctx, reset: bool = False) -> dict:
    """The rank's CUDA memory: allocated and peak bytes (zeros on the
    CPU); ``reset`` restarts the peak."""
    if ctx.device.type != "cuda":
        return {"allocated_bytes": 0, "peak_bytes": 0}
    out = {"allocated_bytes": torch.cuda.memory_allocated(ctx.device),
           "peak_bytes": torch.cuda.max_memory_allocated(ctx.device)}
    if reset:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    return out
