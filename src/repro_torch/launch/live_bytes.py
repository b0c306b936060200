"""Live bytes of one rank over a run: the port's count of a step's peak
memory.

The JAX package reads a step's peak from XLA's memory analysis of the
compiled program (argument + output + temp − alias).  An eager step has
no compiled program, so ``LiveBytesMode``, a ``TorchDispatchMode``,
counts the storages that are alive on this rank while it is entered,
by the CUDA caching allocator's rules:

* A storage is counted once.  Its key is the storage itself, held by a
  weak reference, so the views of a tensor share it.  Its count starts
  when an op first returns it and ends when it is freed (the weak
  reference's callback).  ``resize_`` changes its count to the new size:
  the op's (``Tensor.resize_``) is read from the op's output, the
  storage's own (``UntypedStorage.resize_``, which no dispatch sees) is
  followed while the mode is entered.
* An in-place op and a view return a storage that is counted already
  and add nothing; so the donated update's writes into the old state
  (``optim/inplace.py``) add nothing.
* Only the ops that run on this rank's local tensors count.  For a
  ``DTensor`` the mode returns ``NotImplemented`` and DTensor's dispatch
  runs the local ops, as ``op_cost.OpCostMode`` does; what DTensor's
  sharding propagation runs on fake tensors of the global shapes counts
  nothing (``op_cost._Propagation``, shared with ``OpCostMode``).
* A functional collective's ``wait_tensor`` on a fake tensor returns
  its input, as it does in eager mode (its fake implementation makes a
  new tensor).
* A CUDA storage counts its bytes rounded up to ``CUDA_BLOCK``, the
  caching allocator's smallest block; any other storage counts its
  bytes.
* ``track`` counts tensors made before the run (the step's arguments,
  a ``DTensor`` by its local shard) from the start.
* ``peak`` is the largest live total over the run.

What no dispatch sees is not counted: an op's own scratch on the card
(a library's workspace, a sort's temporaries) and the allocator's
slack (a cached block larger than the request it serves).
"""
from __future__ import annotations

import functools
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.op_cost import _Propagation, _tensors, on_shards

#: bytes of the CUDA caching allocator's smallest block: every request
#: is rounded up to a multiple of it
CUDA_BLOCK = 512


def storage_bytes(nbytes: int, device: torch.device) -> int:
    """Bytes a storage of ``nbytes`` holds on ``device``."""
    if device.type == "cuda":
        return -(-nbytes // CUDA_BLOCK) * CUDA_BLOCK
    return nbytes


class LiveBytesMode(TorchDispatchMode):
    """The live bytes of one rank while entered, and their peak (module
    docstring)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        # storage key -> [weak reference, bytes, device of its tensors]
        self._storages: dict[int, list] = {}
        self._resize = None

    def track(self, *tensors) -> None:
        """Count ``tensors`` (a ``DTensor`` by its local shard) from now
        on."""
        for t in tensors:
            self._add(t.to_local() if isinstance(t, DTensor) else t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        entry = self._storages.get(key)
        if entry is None:
            nb = storage_bytes(st.nbytes(), t.device)
            self._storages[key] = [
                weakref.ref(st, functools.partial(self._free, key)), nb,
                t.device]
            self.live += nb
        else:
            self._resized(st)
        self.peak = max(self.peak, self.live)

    def _resized(self, st: torch.UntypedStorage) -> None:
        entry = self._storages.get(st._cdata)
        if entry is not None:
            nb = storage_bytes(st.nbytes(), entry[2])
            self.live += nb - entry[1]
            entry[1] = nb
            self.peak = max(self.peak, self.live)

    def _free(self, key: int, _ref) -> None:
        self.live -= self._storages.pop(key)[1]

    def __enter__(self):
        _Propagation.enter()
        orig = torch.UntypedStorage.resize_

        @functools.wraps(orig)
        def resize_(st, size):
            out = orig(st, size)
            self._resized(st)
            return out

        self._resize = orig
        torch.UntypedStorage.resize_ = resize_
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            torch.UntypedStorage.resize_ = self._resize
            _Propagation.exit()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not on_shards(types):
            return NotImplemented
        if func is torch.ops._c10d_functional.wait_tensor.default \
                and isinstance(args[0], torch._subclasses.FakeTensor):
            return args[0]
        out = func(*args, **(kwargs or {}))
        if not _Propagation.depth:
            for t in _tensors(out):
                self._add(t)
        return out
