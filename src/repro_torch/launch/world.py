"""A world of ranks that a controller drives: the torch counterpart of
``jax.make_mesh(shape, axes, devices=jax.devices()[:n])``.

JAX puts every device in one process, so a JAX program re-meshes by
building a new mesh over more of them.  A DTensor mesh spans the ranks
of a process group, and a group's size is fixed when it starts: a
resize here tears the world down and starts a new one of the new size
(what torchrun's elastic agent does between restarts).

``World(mesh_shape, axes, device)`` starts ``prod(mesh_shape)`` rank
processes (the ``spawn`` start method: ``fork`` cannot carry a CUDA
context), which meet at a ``dist.FileStore`` in a fresh temporary
directory (a store left by a killed world hangs the next one that meets
at it), each start its process group (gloo on the CPU, NCCL on CUDA,
rank r on ``cuda:r``) and build the named mesh with
``launch/mesh.py::make_mesh``.  ``call(fn, *args)`` runs a module-level
function ``fn(ctx, *args)`` on every rank, ``ctx`` the rank's
``RankContext``, and returns rank 0's result.  A rank that raises or
dies makes ``call`` raise ``RankError`` with its traceback, and the
other ranks are killed; a call that outlasts its timeout does the same.
``close()`` destroys the group on every rank, joins the processes and
removes the store.

A CUDA world needs a card for each rank: asked for more, it raises and
names the count.  It never shrinks the mesh and never falls back to the
CPU.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import shutil
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh


#: seconds a world's ranks have to start, and to leave on ``close``
START_TIMEOUT_S = 300.0
CLOSE_TIMEOUT_S = 60.0


class RankError(RuntimeError):
    """A rank raised, died, or did not answer in time."""


@dataclasses.dataclass
class RankContext:
    """What a rank function gets: the rank, the world's size, its mesh
    and device, and ``objs``, the rank's own objects kept from call to
    call."""

    rank: int
    world_size: int
    mesh: Any
    device: torch.device
    objs: dict = dataclasses.field(default_factory=dict)


def _rank_main(rank, world, store, shape, axes, device_type, timeout_s,
               conn):
    """A rank's process: start the group and the mesh, then run the
    controller's calls until it sends ``None`` (or goes away)."""
    try:
        if device_type == "cuda":
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
        else:
            # the ranks share the host's cores
            torch.set_num_threads(1)
            dev = torch.device("cpu")
        t0 = time.monotonic()
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.FileStore(store, world), rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        t1 = time.monotonic()
        ctx = RankContext(rank, world, make_mesh(shape, axes, dev), dev)
        conn.send(("ok", {"group_s": t1 - t0,
                          "mesh_s": time.monotonic() - t1}))
    except Exception:                                    # noqa: BLE001
        conn.send(("error", traceback.format_exc()))
        return
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:                 # the controller went away
                break
            if msg is None:
                break
            fn, args = msg
            try:
                out = fn(ctx, *args)
                conn.send(("ok", out if rank == 0 else None))
            except Exception:                            # noqa: BLE001
                conn.send(("error", traceback.format_exc()))
    finally:
        ctx.objs.clear()
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """``prod(mesh_shape)`` ranks on a mesh of ``mesh_shape`` with axis
    names ``axes``, on ``device``'s type (module docstring).

    ``timeout_s`` bounds every call and the collectives inside it
    (``START_TIMEOUT_S`` the start: a spawned rank imports torch anew).
    ``start_s`` is the start's seconds, and ``start_info`` rank 0's
    seconds in it to start the group (``group_s``) and to build the mesh
    (``mesh_s``)."""

    def __init__(self, mesh_shape, axes, device="cuda", *,
                 timeout_s: float = 600.0):
        dev = resolve_device(device)
        self.mesh_shape = tuple(int(s) for s in mesh_shape)
        self.axes = tuple(axes)
        self.size = math.prod(self.mesh_shape)
        self.timeout_s = timeout_s
        if len(self.axes) != len(self.mesh_shape):
            raise ValueError(f"mesh {self.mesh_shape} has "
                             f"{len(self.mesh_shape)} axes, got {self.axes}")
        if dev.type == "cuda" and self.size > torch.cuda.device_count():
            raise RuntimeError(
                f"a CUDA world of {self.size} ranks needs {self.size} "
                f"cards, this machine has {torch.cuda.device_count()}")
        t0 = time.monotonic()
        self._dir = Path(tempfile.mkdtemp(prefix="world-"))
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        try:
            for r in range(self.size):
                parent, child = ctx.Pipe()
                p = ctx.Process(
                    target=_rank_main, daemon=True,
                    args=(r, self.size, str(self._dir / "store"),
                          self.mesh_shape, self.axes, dev.type, timeout_s,
                          child))
                p.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(p)
            self.start_info = self._collect(START_TIMEOUT_S, "start")[0]
            self.start_s = time.monotonic() - t0
        except BaseException:
            self.close()
            raise

    @property
    def alive(self) -> bool:
        return bool(self._procs)

    def call(self, fn: Callable, *args) -> Any:
        """``fn(ctx, *args)`` on every rank; rank 0's result.  ``fn`` must
        be importable by name (a module's top level) and its arguments
        picklable."""
        if not self.alive:
            raise RankError("the world is closed")
        what = getattr(fn, "__qualname__", repr(fn))
        for r, conn in enumerate(self._conns):
            try:
                conn.send((fn, args))
            except OSError:                  # a broken pipe: rank r is gone
                self._exited(r, what)
        return self._collect(self.timeout_s, what)[0]

    def _collect(self, timeout_s: float, what: str) -> list:
        """Every rank's answer, or ``RankError`` (the world killed)."""
        deadline = time.monotonic() + timeout_s
        out: list = [None] * self.size
        pending = set(range(self.size))
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"{what}: ranks {sorted(pending)} did not answer "
                           f"within {timeout_s:.0f} s")
            waits = {}
            for r in pending:
                waits[self._conns[r]] = r
                waits[self._procs[r].sentinel] = r
            for ready in wait(list(waits), timeout=left):
                r = waits[ready]
                if r not in pending:
                    continue
                conn = self._conns[r]
                if not conn.poll():
                    if self._procs[r].is_alive():
                        continue
                    self._exited(r, what)
                try:
                    status, val = conn.recv()
                except (EOFError, OSError):
                    self._exited(r, what)
                if status == "error":
                    self._fail(f"{what}: rank {r} raised:\n{val}")
                out[r] = val
                pending.discard(r)
        return out

    def _exited(self, r: int, what: str):
        self._procs[r].join(1)
        self._fail(f"{what}: rank {r} exited with code "
                   f"{self._procs[r].exitcode} without an answer")

    def _fail(self, msg: str):
        self._kill()
        raise RankError(msg)

    def _kill(self):
        """Kill the ranks still running, close the pipes, remove the
        store."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(10)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        shutil.rmtree(self._dir, ignore_errors=True)

    def close(self):
        """Destroy the group on every rank and join the processes (those
        that outlast ``CLOSE_TIMEOUT_S`` are killed); remove the store."""
        if not self.alive:
            shutil.rmtree(self._dir, ignore_errors=True)
            return
        for conn in self._conns:
            try:
                conn.send(None)
            except OSError:                  # that rank is gone already
                pass
        deadline = time.monotonic() + CLOSE_TIMEOUT_S
        for p in self._procs:
            p.join(max(deadline - time.monotonic(), 0.1))
        self._kill()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
