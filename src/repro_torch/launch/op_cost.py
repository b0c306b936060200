"""Per-rank cost of eager PyTorch code: the port's counterpart of the
JAX package's ``launch/hlo_cost.py``.

XLA HLO has no torch form: an eager step is not compiled into a module
whose text could be parsed.  So the cost is tallied as the step runs,
op by op, by a ``TorchDispatchMode`` (``OpCostMode``) that sees every
op one rank runs on its local shards.  What replaces what:

* ``HloCostModel`` (parse the module, recurse into fusions, multiply
  ``while`` trip counts, ``_dot_flops``) -> ``OpCostMode``.  Eager runs
  each trip of a loop, so nothing is multiplied and ``while_trips`` is
  empty.  FLOPs are ``torch.utils.flop_counter``'s formulas (matrix
  products, convolutions, attention) plus the registered kernels' own
  (``repro_torch::flash_attention``, ``::rmsnorm_residual`` and
  ``::ssd_chunk``, whose formulas are ``attention_flops``,
  ``rmsnorm_flops`` and ``ssd_flops``).  HBM bytes are each op's inputs
  and outputs, views excluded: in eager every op is a launch, so this
  is the launch-boundary traffic that ``hlo_cost`` models at fusion
  boundaries.  A gather reads the rows it takes, not its whole table; a
  stride-0 axis is read once; a registered kernel is charged its
  ``*_bytes`` formula.
* ``_group_info`` (replica groups against the pod size) -> the
  collective's process group: a group over the mesh's ``"pod"`` dim, or
  the whole world of a mesh that has one, is cross-pod (DCI).
* ``_collective_wire_bytes`` -> copied as it is, applied to the
  ``_c10d_functional`` ops DTensor issues (and the ``c10d`` ops of
  ``torch.distributed``'s own calls), each named by its HLO opcode.
* ``entry_boundary_bytes`` (launch-boundary bytes of a compiled stencil
  module) -> ``kernels/stencil/kernel.py::block_bytes``, the block
  kernel's least traffic, which the stencil bounds already use; no HLO
  parser is written.
* ``shot_batch_strip_bytes`` -> copied as it is.
* ``xla_cost_analysis`` -> none: there is no compiled module.

A ``DTensor`` op is not counted itself: the mode hands it on to
DTensor's dispatch (``NotImplemented``), and counts the local ops and
the collectives that dispatch runs.  DTensor's first sight of an op runs
it once on fake tensors of the global shapes to learn its output's shape
(``ShardingPropagator._propagate_tensor_meta_non_cached``); no rank runs
that, and the mode does not count it.  So a sharded product counts this
rank's shard, and work that every rank repeats (a replicated attention
where the heads do not divide the "model" axis) counts whole on each.

``input_read_bytes`` is the bytes read from tensors the mode did not
make (the parameters, the cache, the inputs), each region of a storage
once: the least traffic of a step that fused everything.
"""
from __future__ import annotations

import collections
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

#: ops that move no data: allocations are counted by their first
#: writer, metadata ops by nothing
_FREE = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.detach.default,
    aten.alias.default, aten.lift_fresh.default, aten._unsafe_view.default,
    aten._local_scalar_dense.default, aten.sym_size.int,
    aten.sym_stride.int, aten.sym_numel.default,
    aten.sym_storage_offset.default, aten.is_same_size.default,
    aten.set_.source_Storage_storage_offset,
}
#: ops whose first input is a table read only at the rows they take:
#: charged the output's bytes for it
_GATHERS = {
    aten.embedding.default, aten.index.Tensor, aten.index_select.default,
    aten.gather.default,
}
#: ops that write their first input without reading it
_WRITE_ONLY = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.zero_.default}

#: functional collective -> (HLO opcode, index of the group name)
_COLL_FUNCTIONAL = {
    "all_gather_into_tensor": ("all-gather", 2),
    "all_gather_into_tensor_coalesced": ("all-gather", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 3),
    "all_reduce": ("all-reduce", 2),
    "all_reduce_": ("all-reduce", 2),
    "all_reduce_coalesced": ("all-reduce", 2),
    "all_to_all_single": ("all-to-all", 3),
    "broadcast": ("collective-broadcast", 2),
}
#: ``torch.distributed`` ops -> (HLO opcode, index of the process group,
#: index of the tensors whose bytes are the output)
_COLL_C10D = {
    "allreduce_": ("all-reduce", 1, 0),
    "_allgather_base_": ("all-gather", 2, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 2, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 2, 0),
    "alltoall_base_": ("all-to-all", 2, 0),
    "broadcast_": ("collective-broadcast", 1, 0),
    "send": ("collective-permute", 1, 0),
}


def _collective_wire_bytes(opcode: str, out_bytes: int, gsize: int) -> float:
    g = max(gsize, 1)
    base = opcode.replace("-start", "")
    if base == "all-gather":
        return out_bytes * (g - 1) / g
    if base == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if base == "reduce-scatter":
        return out_bytes * (g - 1)
    if base == "all-to-all":
        return out_bytes * (g - 1) / g
    if base == "collective-permute":
        return float(out_bytes)
    return float(out_bytes)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s elements, a stride-0 axis counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def kernel_bytes() -> dict:
    """``{op: bytes(args)}`` of the registered LM kernels: each one's
    least-traffic formula from its ``kernel.py``."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.ssd import kernel as sk

    def flash(q, k, v, causal, softcap=0.0):
        B, H, S, D = q.shape
        return fk.attention_bytes(B, H, k.shape[1], S, D, q.element_size(),
                                  dv=v.shape[-1], sk=k.shape[2])

    def norm(x, res, scale, eps):
        return rk.rmsnorm_bytes(*x.shape, x.element_size())

    def ssd(xdt, b, c, csum):
        BC, H, Q, P = xdt.shape
        groups = H // sk.heads_per_group(b, c)
        return sk.ssd_bytes(BC, H, Q, b.shape[-1], P, xdt.element_size(),
                            groups)

    return {torch.ops.repro_torch.flash_attention.default: flash,
            torch.ops.repro_torch.rmsnorm_residual.default: norm,
            torch.ops.repro_torch.ssd_chunk.default: ssd}


def _group_of(arg):
    """A process group from a functional collective's name or a c10d
    op's boxed group."""
    if isinstance(arg, str):
        return dist.distributed_c10d._resolve_process_group(arg)
    return dist.ProcessGroup.unbox(arg)


def on_shards(types) -> bool:
    """Whether an op's tensor types are all plain or fake tensors: a
    ``DTensor``'s op is handed on to DTensor's dispatch instead
    (``NotImplemented``), which runs the rank's local ops."""
    return all(t is torch.Tensor
               or issubclass(t, torch._subclasses.FakeTensor)
               for t in types)


class _Propagation:
    """While any ``OpCostMode`` or ``live_bytes.LiveBytesMode`` is
    entered, DTensor's shape propagation runs with ``depth`` raised, so
    the modes pass its ops through."""

    depth = 0
    entered = 0
    saved = None

    @classmethod
    def enter(cls):
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator,
        )

        cls.entered += 1
        if cls.entered > 1:
            return
        name = "_propagate_tensor_meta_non_cached"
        orig = ShardingPropagator.__dict__.get(name)
        if orig is None:
            return

        def propagate(*args, **kwargs):
            cls.depth += 1
            try:
                return orig(*args, **kwargs)
            finally:
                cls.depth -= 1

        cls.saved = (ShardingPropagator, name, orig)
        setattr(ShardingPropagator, name, propagate)

    @classmethod
    def exit(cls):
        cls.entered -= 1
        if cls.entered == 0 and cls.saved is not None:
            owner, name, orig = cls.saved
            setattr(owner, name, orig)
            cls.saved = None


class OpCostMode(TorchDispatchMode):
    """Tallies one rank's FLOPs, HBM bytes and collective bytes while it
    is entered (module docstring).  ``mesh``: the device mesh whose
    ``"pod"`` dim marks the cross-pod groups (none: no group crosses)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes = 0.0
        self.coll_dci_bytes = 0.0
        self.coll_count = 0.0
        self.coll_by_type: dict[str, float] = collections.defaultdict(float)
        self.bytes_by_op: dict[str, float] = collections.defaultdict(float)
        self.flops_by_op: dict[str, float] = collections.defaultdict(float)
        self.ops = 0
        self.warnings: set[str] = set()
        self._made: set[int] = set()
        self._read: dict[int, dict[int, int]] = {}
        self._kernel_bytes = kernel_bytes()
        self._dci_groups: set[str] = set()
        if mesh is not None and "pod" in (mesh.mesh_dim_names or ()):
            self._dci_groups.add(mesh.get_group("pod").group_name)
            if mesh.ndim > 1:
                self._dci_groups.add(dist.group.WORLD.group_name)

    def __enter__(self):
        _Propagation.enter()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _Propagation.exit()

    # -- the tally ---------------------------------------------------------

    def _storage(self, t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _note_read(self, t: torch.Tensor, nbytes: int) -> None:
        """A read of ``nbytes`` from ``t``'s storage at its offset (a
        layer's slice of a stacked weight is a region of its own)."""
        key = self._storage(t)
        if key not in self._made:
            regions = self._read.setdefault(key, {})
            off = t.storage_offset()
            regions[off] = max(regions.get(off, 0), nbytes)

    def _op_bytes(self, func, args, kwargs, out) -> float:
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func in self._kernel_bytes:
            for t in ins:
                self._note_read(t, tensor_bytes(t))
            return float(self._kernel_bytes[func](*args, **kwargs))
        total = 0
        for i, t in enumerate(ins):
            if func in _WRITE_ONLY and i == 0:
                continue
            nb = tensor_bytes(t)
            if func in _GATHERS and i == 0 and outs:
                nb = min(nb, tensor_bytes(outs[0]))
            self._note_read(t, nb)
            total += nb
        return float(total + sum(tensor_bytes(t) for t in outs))

    def _collective(self, name: str, args, out) -> None:
        if name in _COLL_FUNCTIONAL:
            opcode, gi = _COLL_FUNCTIONAL[name]
            outs = _tensors(out)
        else:
            opcode, gi, ti = _COLL_C10D[name]
            outs = _tensors(args[ti])
        group = _group_of(args[gi])
        gsize = group.size()
        nbytes = sum(t.numel() * t.element_size() for t in outs)
        wire = _collective_wire_bytes(opcode, nbytes, gsize)
        self.coll_bytes += wire
        self.coll_count += 1
        self.coll_by_type[opcode] += wire
        if group.group_name in self._dci_groups:
            self.coll_dci_bytes += wire

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not on_shards(types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _Propagation.depth:
            return out
        self.ops += 1
        ns = func.namespace
        name = func._overloadpacket.__name__
        outs = _tensors(out)
        if ns == "_c10d_functional" and name in _COLL_FUNCTIONAL \
                or ns == "c10d" and name in _COLL_C10D:
            self._collective(name, args, out)
        elif ns in ("_c10d_functional", "c10d") or not outs \
                or func in _FREE or func.is_view:
            pass
        else:
            nb = self._op_bytes(func, args, kwargs, out)
            self.hbm_bytes += nb
            self.bytes_by_op[name] += nb
            fl = flop_registry.get(func._overloadpacket)
            if fl is not None:
                f = float(fl(*args, **kwargs, out_val=out))
                self.flops += f
                self.flops_by_op[name] += f
        # an output in a storage no input holds (not a view, not in
        # place) is the mode's own
        held = {self._storage(t) for t in _tensors((args, kwargs))}
        for t in outs:
            key = self._storage(t)
            if key not in held:
                self._made.add(key)
        return out

    # -- results -----------------------------------------------------------

    @property
    def input_read_bytes(self) -> float:
        return float(sum(sum(r.values()) for r in self._read.values()))

    def result(self) -> dict[str, Any]:
        """``hlo_cost.analyze``'s keys, and the port's extras."""
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.coll_bytes,
            "collective_dci_bytes": self.coll_dci_bytes,
            "collective_by_type": {k: float(v)
                                   for k, v in self.coll_by_type.items()},
            "collective_count": self.coll_count,
            "while_trips": [],
            "warnings": sorted(self.warnings)[:10],
            "input_read_bytes": self.input_read_bytes,
            "ops": self.ops,
            "flops_by_op": dict(self.flops_by_op),
            "bytes_by_op": dict(self.bytes_by_op),
        }


def analyze(fn: Callable, *args, mesh=None, **kwargs) -> tuple[Any, dict]:
    """``(fn(*args, **kwargs), cost)``: the call run once under an
    ``OpCostMode`` over ``mesh``; ``cost`` has ``hlo_cost.analyze``'s
    keys."""
    with OpCostMode(mesh) as mode:
        out = fn(*args, **kwargs)
    return out, mode.result()


def shot_batch_strip_bytes(nz: int, nx: int, s: int, k: int = 1,
                           dtype_bytes: int = 4) -> dict:
    """Analytic per-strip-sweep HBM traffic of the shot-batched stencil
    engine vs the vmapped per-shot path (DESIGN.md §17).

    One k-step sweep over the grid reads the two wavefields and writes
    both outputs PER SHOT, but the two read-only model fields
    (``v2dt2``, ``sponge``) are shared: the vmapped per-shot engine
    re-streams them once per shot (``4·S`` array reads), the batched
    engine charges them once (``2·S + 2`` reads).  Writes are ``2·S``
    either way.  Returns the array counts, the byte totals, and
    ``traffic_ratio`` = vmapped/batched bytes — the model's upper bound
    on the batched speedup of a purely memory-bound sweep (≈ 4/3 at
    S=4, → 3/2 as S → ∞)."""
    field = nz * nx * dtype_bytes
    vm_reads, bt_reads = 4 * s, 2 * s + 2
    writes = 2 * s
    vm = (vm_reads + writes) * field
    bt = (bt_reads + writes) * field
    return {
        "field_bytes": field,
        "vmapped_read_arrays": vm_reads,
        "batched_read_arrays": bt_reads,
        "write_arrays": writes,
        "vmapped_bytes": vm,
        "batched_bytes": bt,
        "traffic_ratio": vm / bt,
        "launches_vmapped": s,          # grid passes per block
        "launches_batched": 1,
        "k": k,
        "s": s,
    }
