"""Mesh builders over ``torch.distributed``'s device mesh.

The JAX package's ``launch/mesh.py``.  ``make_mesh`` and
``make_host_mesh`` build a ``DeviceMesh`` with named axes
(``init_device_mesh``) over the ranks of the default process group;
``make_production_mesh`` is the (16, 16) ("data", "model") pod or the
(2, 16, 16) ("pod", "data", "model") pair of pods and raises unless the
world has exactly that many ranks.  ``AbstractMesh``
(``sharding/rules.py``) holds those shapes without ranks, for resolving
rules.

``make_mesh`` in a fake world (the dry run's fake process group of 256
or 512 ranks) builds a ``cuda`` mesh without a card: its tensors are
fake.  ``make_host_mesh`` needs a process group.  Where none is initialised
it starts a one-rank group itself — NCCL on the card, gloo on the CPU —
unless the environment names a bigger world (``WORLD_SIZE``), which the
launcher must then initialise.  On the card's machine (one H100) the
host mesh is (1, 1): every placement is ``Replicate()``.  Asked for
``cuda`` where there is no card, it raises; it never gives a CPU mesh
in its place.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def _n(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def ensure_process_group(device="cuda") -> None:
    """Start a one-rank group (NCCL for ``cuda``, gloo for ``cpu``) when
    none is initialised; a group already running is left as it is."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != 1:
        raise RuntimeError(f"WORLD_SIZE={world}: initialise the process "
                           f"group before building a mesh")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def fake_world() -> bool:
    """True where the default group is a fake one (backend ``"fake"``,
    the dry run's, ``launch/dryrun.py``): its ranks hold fake tensors."""
    return dist.is_initialized() and dist.get_backend() == "fake"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device="cuda") -> DeviceMesh:
    """A mesh of ``shape`` with axis names ``axes`` over the first
    ``prod(shape)`` ranks (all of them: a device mesh spans the world).
    In a fake world the mesh is on ``device`` whether or not there is a
    card: its tensors hold no data."""
    if fake_world():
        dev = torch.device(device)
    else:
        dev = resolve_device(device)
        ensure_process_group(dev)
    if _n(shape) != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {_n(shape)} ranks, the "
                         f"world has {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """Single-pod (16,16) ("data","model") or 2-pod (2,16,16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized() or dist.get_world_size() != _n(shape):
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"the production mesh {shape} needs a world of "
                           f"{_n(shape)} ranks, have {have}")
    return make_mesh(shape, axes, device)


def make_host_mesh(model: int | None = None, device="cuda") -> DeviceMesh:
    """(ranks / model, model) ("data", "model") over every rank (CPU
    tests, demos, the one card)."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    n = dist.get_world_size()
    model = model or 1
    if n % model:
        model = 1
    return make_mesh((n // model, model), ("data", "model"), dev)


def chips(mesh) -> int:
    return mesh.size()


def legal_slice_shapes(max_chips: int = 512):
    """Legal slice chip counts (the planner rounds c_n up to these)."""
    out = []
    c = 1
    while c <= max_chips:
        out.append(c)
        c *= 2
    return out
