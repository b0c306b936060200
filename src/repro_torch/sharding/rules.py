"""Logical-axis placement rules with divisibility fallback, over a
``torch.distributed`` device mesh.

The placement half of the JAX package's ``sharding/rules.py``.  Every
parameter and activation dimension carries a *logical* axis name
("batch", "heads", "mlp", ...).  A rule table maps each name to an
ordered list of candidate mesh axes; the first candidate whose size
divides the dimension (and is not already taken by another dimension of
the same tensor) wins, otherwise the dimension is replicated.  The
tables, the preference order, the exclusivity, the ZeRO-1 extra split
and the trailing-``None`` trim are the JAX package's, so a spec here
equals ``tuple()`` of the JAX ``PartitionSpec`` for the same mesh
sizes, and one model definition serves the (16, 16) pod, the
(2, 16, 16) two-pod mesh, the one-card (1, 1) mesh and the CPU's gloo
ranks.

A spec becomes DTensor placements, one per mesh dimension:
``Shard(i)`` where the spec puts tensor dimension ``i`` over that mesh
axis, else ``Replicate()``.  An entry over several axes, such as
``("pod", "data")``, shards one dimension over each of them in the
mesh's order, pod-major as in JAX.  ``Sharding`` (mesh, spec,
placements) is the port's ``NamedSharding``.  ``AbstractMesh`` holds
ordered axis names and sizes and no devices, so rules resolve at
production sizes on any machine.

``shard(x, *axes)`` is the port's ``with_sharding_constraint``: a no-op
outside an ``axis_rules`` context or on a plain tensor, a
``redistribute`` to the rule's placements on a DTensor.

Rules with ``manual`` axes are the JAX package's manual-axis branch of
``shard`` (``compat.mesh_and_manual``: inside a ``shard_map`` region
manual over "pod", a constraint drops the manual axes from its spec).
A spec still resolves on the whole mesh's sizes, then loses its manual
axes; its placements are on the region's mesh, the sub-mesh of the
other axes (``mesh["data", "model"]``), where each pod's DTensors live,
the same on every pod or each pod's own slice.  ``into_region`` and
``out_of_region`` carry a DTensor between the two meshes without
moving data; the compressed cross-pod step
(``runtime/train_step.py``) runs its pod's work in such a region.

The parameter schema (``ParamSpec`` and its inits) lives in
``models/params.py``; the helpers here map over those schemas.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Sequence

import torch
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.params import map_specs, tree_zip

# ---------------------------------------------------------------------------
# Rule tables (the JAX package's, entry for entry)
# ---------------------------------------------------------------------------

# Training rules.  Order within each entry = preference order.  A tuple
# entry like ("pod", "data") means "shard over the product of these axes"
# (all must exist in the mesh; divisibility checked on the product).
#
# "embed" is the *parameter* d_model axis: sharded over "data" for
# training (FSDP weight sharding), replicated for serving.  "d_model" is
# the *activation* embedding axis: always replicated on "model"
# (Megatron-style TP).
TRAIN_RULES: dict[str, tuple[Any, ...]] = {
    # activations / data
    "batch": (("pod", "data"), ("data",), ("pod",)),
    "seq": (),
    "seq_res": (),
    "kv_seq": (("model",),),
    "kv_seq_long": (("data", "model"), ("model",),),
    "d_model": (),
    # parameters
    "embed": (("data",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),      # falls back to replicate when kv<model
    "mlp": (("model",),),
    "vocab": (("model",),),
    "experts": (("model",),),
    "experts_ep": (("data",), ("model",)),
    "ep_embed": (("model",),),
    "expert_cap": (),
    "layers": (),
    "ssm_inner": (("model",),),
    "ssm_heads": (("model",),),
    "ssm_state": (),
    "conv_w": (),
    "kv_lora": (),
    "q_lora": (),
    "rope": (),
    "head_dim": (),
    "frames": (),
    # optimizer-state extra sharding (ZeRO-1)
    "zero1": (("data",),),
}

# Serving rules: weights resident (no FSDP gather); giant MoE expert
# banks spread over (pod, data) with TP on the expert hidden dim.
SERVE_RULES: dict[str, tuple[Any, ...]] = {
    **TRAIN_RULES,
    "embed": (),
    "experts": (("pod", "data"), ("data",), ("model",)),
}

DEFAULT_RULES = TRAIN_RULES


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of
    names, or None (replicated); trailing Nones trimmed.  A plain tuple,
    so it compares equal to ``tuple(jax.sharding.PartitionSpec(...))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Ordered mesh axis names and sizes, no devices."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.axis_sizes} vs names "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` in the mesh's order, for a ``DeviceMesh``
    with ``mesh_dim_names`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the device mesh needs mesh_dim_names")
    return dict(zip(names, mesh.shape))


def _entry_axes(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def spec_placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh axis,
    ``Shard(i)`` where entry ``i`` names it, else ``Replicate()``.  An
    entry over several axes must name them in the mesh's order (the
    left axis splits first, as in JAX)."""
    names = list(mesh_shape(mesh))
    out: list = [Replicate()] * len(names)
    for i, part in enumerate(spec):
        axes = _entry_axes(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {part!r} is not in the mesh's axis "
                             f"order {tuple(names)}")
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The port's ``NamedSharding``: a spec bound to a mesh, with its
    DTensor placements."""

    mesh: Any
    spec: PartitionSpec
    placements: tuple


def make_rules(mesh, phase: str = "train",
               flat_dp: bool = False) -> "AxisRules":
    """flat_dp: treat "model" as a second data axis — for archs whose
    head count does not divide the model axis (whisper: 20 heads vs 16),
    where tensor parallelism would otherwise replicate the attention
    compute on every model rank."""
    table = dict(TRAIN_RULES if phase == "train" else SERVE_RULES)
    if flat_dp:
        table["batch"] = (
            ("pod", "data", "model"), ("pod", "data"), ("data", "model"),
            ("data",),
        )
        table["heads"] = ()
        table["kv_heads"] = ()
        table["mlp"] = ()
        table["ssm_inner"] = ()
        table["ssm_heads"] = ()
    return AxisRules(mesh, table)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """A rule table bound to a mesh (a ``DeviceMesh`` with
    ``mesh_dim_names``, or an ``AbstractMesh``)."""

    mesh: Any
    rules: dict[str, tuple[Any, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES)
    )
    #: mesh axes the caller runs manually, one region each (module
    #: docstring): dropped from every spec
    manual: tuple[str, ...] = ()

    @functools.cached_property
    def region_mesh(self):
        """The mesh the placements are on: ``mesh`` without its manual
        axes."""
        if not self.manual:
            return self.mesh
        keep = tuple(a for a in mesh_shape(self.mesh)
                     if a not in self.manual)
        if isinstance(self.mesh, AbstractMesh):
            shape = mesh_shape(self.mesh)
            return AbstractMesh(tuple(shape[a] for a in keep), keep)
        return self.mesh[keep]

    def _drop_manual(self, parts: list) -> PartitionSpec:
        out = []
        for part in parts:
            axes = tuple(a for a in _entry_axes(part)
                         if a not in self.manual)
            out.append(None if not axes else
                       axes[0] if len(axes) == 1 else axes)
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    def mesh_axis_size(self, axes: Sequence[str]) -> int:
        shape = mesh_shape(self.mesh)
        n = 1
        for a in axes:
            n *= shape.get(a, 1)
        return n

    def resolve_dim(self, logical: str | None, size: int, taken: set[str]):
        """Pick mesh axes for one dim, honoring divisibility +
        exclusivity."""
        if logical is None:
            return None
        shape = mesh_shape(self.mesh)
        for cand in self.rules.get(logical, ()):
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a in taken for a in axes):
                continue
            if any(a not in shape for a in axes):
                continue
            n = self.mesh_axis_size(axes)
            if n > 1 and size % n == 0:
                taken.update(axes)
                return axes if len(axes) > 1 else axes[0]
        return None

    def spec(self, logical_axes: Sequence[str | None],
             shape: Sequence[int]) -> PartitionSpec:
        if len(logical_axes) != len(shape):
            raise ValueError(
                f"logical axes {logical_axes} rank != shape {shape} rank"
            )
        taken: set[str] = set()
        parts = [self.resolve_dim(name, dim, taken)
                 for name, dim in zip(logical_axes, shape)]
        return self._drop_manual(parts)

    def zero1_spec(self, logical_axes: Sequence[str | None],
                   shape: Sequence[int]) -> PartitionSpec:
        """Param spec + an extra 'data' split on the largest
        still-unsharded divisible dim (ZeRO-1 optimizer-state
        sharding)."""
        base = self.spec(logical_axes, shape)
        parts = list(base) + [None] * (len(shape) - len(base))
        taken = {a for p in parts for a in _entry_axes(p)}
        mshape = mesh_shape(self.mesh)
        if "data" in taken or "data" not in mshape:
            return base
        dsize = mshape["data"]
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if parts[i] is None and shape[i] % dsize == 0 \
                    and shape[i] >= dsize:
                parts[i] = "data"
                break
        return self._drop_manual(parts)

    def placements(self, logical_axes, shape) -> tuple:
        return spec_placements(self.region_mesh,
                               self.spec(logical_axes, shape))

    def sharding(self, logical_axes, shape) -> Sharding:
        spec = self.spec(logical_axes, shape)
        mesh = self.region_mesh
        return Sharding(mesh, spec, spec_placements(mesh, spec))

    def zero1_sharding(self, logical_axes, shape) -> Sharding:
        spec = self.zero1_spec(logical_axes, shape)
        mesh = self.region_mesh
        return Sharding(mesh, spec, spec_placements(mesh, spec))


# ---------------------------------------------------------------------------
# Thread-local rule context (used by model code for activation placement)
# ---------------------------------------------------------------------------

_CTX = threading.local()


@contextlib.contextmanager
def axis_rules(rules: AxisRules | None):
    prev = getattr(_CTX, "rules", None)
    _CTX.rules = rules
    try:
        yield
    finally:
        _CTX.rules = prev


def current_rules() -> AxisRules | None:
    return getattr(_CTX, "rules", None)


@contextlib.contextmanager
def _implicit_replication_as(on: bool):
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = on
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def placement_context():
    """A context manager factory that re-enters the rules and DTensor's
    implicit replication in force at this call, on any thread: for work
    that runs later elsewhere (a checkpointed layer's recompute runs in
    the backward, for CUDA tensors on the autograd engine's own thread,
    where neither is set)."""
    rules = current_rules()
    implicit = DTensor._op_dispatcher._allow_implicit_replication

    @contextlib.contextmanager
    def enter():
        with axis_rules(rules), _implicit_replication_as(implicit):
            yield

    return enter


def shard(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """Place an activation by the current rules: a no-op outside an
    ``axis_rules`` context or on a plain tensor; a DTensor is
    redistributed to the rule's placements (gradients flow back through
    the inverse redistribution)."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    want = rules.placements(logical_axes, x.shape)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def place(x: torch.Tensor, placements: Sequence, mesh=None) -> DTensor:
    """x redistributed to ``placements`` (a no-op where it is there); a
    plain tensor, the same on every rank, is taken as replicated on
    ``mesh``."""
    placements = tuple(placements)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def into_region(x: DTensor, rules: AxisRules) -> DTensor:
    """A DTensor on ``rules.mesh`` as one on ``rules.region_mesh``, its
    local shard as it is: over each manual axis it must be
    ``Replicate()`` (the same on every pod) or shard a tensor dim ahead
    of the other mesh axes that shard it (each pod's slice, as the
    rules' pod-major entries place a batch)."""
    names = list(mesh_shape(rules.mesh))
    for a, p in zip(names, x.placements):
        if a in rules.manual and not isinstance(p, (Replicate, Shard)):
            raise ValueError(f"{p} over the manual axis {a!r}")
    pl = tuple(p for a, p in zip(names, x.placements)
               if a not in rules.manual)
    return DTensor.from_local(x.to_local(), rules.region_mesh, pl,
                              run_check=False)


def out_of_region(x: DTensor, rules: AxisRules) -> DTensor:
    """A DTensor on ``rules.region_mesh`` as one on ``rules.mesh``,
    ``Replicate()`` over the manual axes, its local shard as it is."""
    it = iter(x.placements)
    pl = tuple(Replicate() if a in rules.manual else next(it)
               for a in mesh_shape(rules.mesh))
    return DTensor.from_local(x.to_local(), rules.mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def shard_count(x: torch.Tensor, dim: int) -> int:
    """The number of shards tensor dim ``dim`` of x is cut into: the
    product of the mesh dims that shard it (1 on a plain tensor)."""
    if not isinstance(x, DTensor):
        return 1
    n = 1
    for j, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim:
            n *= x.device_mesh.size(j)
    return n


def replicate_dims(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """x with its shards of tensor dims ``dims`` gathered (``Replicate()``
    there), for an op that has no DTensor strategy over them; a plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    drop = {d % x.ndim for d in dims}
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim % x.ndim in drop
                 else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def local_shape_and_offset(shape: Sequence[int], mesh,
                           placements: Sequence) -> tuple[list, list]:
    """This rank's shard of a tensor of global ``shape`` at
    ``placements`` on ``mesh``: (local shape, global offset), as
    ``torch.distributed.tensor``'s ``compute_local_shape_and_global_offset``
    gives them (``torch.chunk``'s split, mesh dims in order), computed in
    Python: no tensor op, so a fake tensor mode sees nothing to run."""
    size, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for j, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        d, m = p.dim % len(shape), mesh.size(j)
        chunk = -(-size[d] // m)
        lo = min(coord[j] * chunk, size[d])
        off[d] += lo
        size[d] = min(chunk, size[d] - lo)
    # an empty shard's offset is the dim's global size, as torch's
    return size, [o if s else g for o, s, g in zip(off, size, shape)]


def write_along(dst: torch.Tensor, src: torch.Tensor, start: int,
                dim: int) -> None:
    """``dst`` over ``[start, start + n)`` of tensor dim ``dim`` set to
    ``src`` (n = ``src.shape[dim]``), in place: the JAX package's
    ``dynamic_update_slice_in_dim``.  On a DTensor ``dst`` each rank
    writes only the part of the range its own shard holds, from ``src``
    placed as ``dst`` on every other dim and replicated along ``dim``;
    a rank whose shard the range misses writes nothing."""
    n = src.shape[dim]
    if not isinstance(dst, DTensor):
        dst.narrow(dim, start, n).copy_(src)
        return
    d = dim % dst.ndim
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim % dst.ndim == d
                 else p for p in dst.placements)
    src = place(src.to(dst.dtype), want, dst.device_mesh)
    shape, offset = local_shape_and_offset(
        dst.shape, dst.device_mesh, dst.placements)
    lo = offset[d]
    a, b = max(start, lo), min(start + n, lo + shape[d])
    if a < b:
        dst.to_local().narrow(d, a - lo, b - a).copy_(
            src.to_local().narrow(d, a - start, b - a))


def local_along(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn(x)`` for an ``fn`` that works along tensor dim ``dim`` alone
    (a scan, say), run on each rank's shard through ``local_map``: for
    an op whose DTensor strategy, or its backward's, is missing.  A
    DTensor sharded along ``dim`` is gathered there first, a partial sum
    reduced; a plain tensor goes straight to ``fn``."""
    if not isinstance(x, DTensor):
        return fn(x)
    d = dim % x.ndim
    want = tuple(p if isinstance(p, Shard) and p.dim % x.ndim != d
                 else Replicate() for p in x.placements)
    if want != tuple(x.placements):
        x = x.redistribute(x.device_mesh, want)
    return local_map(fn, out_placements=list(want), in_placements=(want,),
                     in_grad_placements=(want,),
                     device_mesh=x.device_mesh)(x)


def contract(fn, x: torch.Tensor, w: torch.Tensor, k: int = 1):
    """``fn(x, w)``, a product of x (..., K1..Kk) and w (K1..Kk, O...)
    over x's last k dims and w's first k, giving (..., O...).  A plain x
    goes to ``fn`` as it is.  A DTensor x runs ``fn`` on local shards
    through ``local_map``, so that the views ``fn`` takes (a matmul
    folds x's rows into one dim) see no sharded dim: torch refuses a
    view that merges two sharded dims (a batch and a sequence) or splits
    one across a head.  Each mesh dim keeps one sharding of the product:

    * x's row shard (batch, sequence), the weight gathered there;
    * the weight's shard of an output dim (tensor parallelism), x
      gathered there (its sequence, as Megatron-SP gathers it);
    * a shard of a contracted dim in x or the weight (the other sliced
      to match), the product a partial sum there.

    Where x's rows and the weight are both sharded, a shard of x's first
    dim (the batch) stays and the weight is gathered (FSDP); any other
    row shard is gathered (the sequence).  Gradients: a replicated
    operand's is a partial sum where the other splits the work."""
    if not isinstance(x, DTensor):
        return fn(x, w)
    mesh = x.device_mesh
    xr = x.ndim - k
    xp, wp, op, xg, wg = [], [], [], [], []
    for j in range(mesh.ndim):
        a = x.placements[j]
        b = w.placements[j] if isinstance(w, DTensor) else Replicate()
        ax = a.dim % x.ndim if isinstance(a, Shard) else None
        bw = b.dim % w.ndim if isinstance(b, Shard) else None
        if ax is not None and bw is not None and not (
                ax >= xr and bw == ax - xr):
            if ax == 0:
                bw = None                  # the batch stays: w gathered
            else:
                ax = None                  # x gives way
        if ax is not None and ax < xr:                   # x's rows
            row = Shard(ax)
            xp.append(row), wp.append(Replicate()), op.append(row)
            xg.append(row), wg.append(Partial())
        elif bw is not None and bw >= k:                 # w's outputs
            col = Shard(bw)
            xp.append(Replicate()), wp.append(col)
            op.append(Shard(xr + bw - k)), xg.append(Partial())
            wg.append(col)
        elif ax is not None or bw is not None:           # contracted
            c = ax - xr if ax is not None else bw
            xp.append(Shard(xr + c)), wp.append(Shard(c))
            op.append(Partial()), xg.append(Shard(xr + c))
            wg.append(Shard(c))
        else:
            for t in (xp, wp, op, xg, wg):
                t.append(Replicate())
    return local_map(fn, out_placements=op, in_placements=(xp, wp),
                     in_grad_placements=(tuple(xg), tuple(wg)),
                     device_mesh=mesh)(place(x, xp), place(w, wp, mesh))


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of two operands.  On DTensors one
    ``local_map`` region: each mesh dim that shards an index of either
    operand (a's first) shards that index in both operands and in the
    output; an operand without the index is replicated there and its
    gradient partial, an output without it (a contracted index) is a
    partial sum.  Mesh dims that shard neither are replicated."""
    if not isinstance(a, DTensor):
        return torch.einsum(eq, a, b)
    (sa, sb), so = eq.split("->")[0].split(","), eq.split("->")[1]
    mesh = a.device_mesh
    index = []
    for j in range(mesh.ndim):
        found = None
        for t, sub in ((a, sa), (b, sb)):
            pl = t.placements[j] if isinstance(t, DTensor) else None
            if found is None and isinstance(pl, Shard):
                found = sub[pl.dim % t.ndim]
        index.append(found)

    def placements(sub, missing):
        return tuple(Replicate() if i is None else Shard(sub.index(i))
                     if i in sub else missing for i in index)

    pa, pb = placements(sa, Replicate()), placements(sb, Replicate())
    return local_map(
        functools.partial(torch.einsum, eq),
        out_placements=list(placements(so, Partial())),
        in_placements=(pa, pb),
        in_grad_placements=(placements(sa, Partial()),
                            placements(sb, Partial())),
        device_mesh=mesh)(place(a, pa), place(b, pb, mesh))


def view_rows(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)`` where x's first dim and the result's hold the
    same rows in the same order (a batch flattened with its sequence,
    or back).  On a DTensor each rank reshapes its own rows through
    ``local_map``: x placed with its first dim sharded where it is
    already (when that count divides both first dims; else gathered)
    and every other dim gathered, the result sharded the same.  A view
    of the DTensor would merge or split the sharded dim with the next,
    which torch refuses, forward or backward, once another mesh dim
    shards either."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    p = tuple(q if isinstance(q, Shard) and q.dim % x.ndim == 0
              else Replicate() for q in x.placements)
    n = 1
    for j, q in enumerate(p):
        if q != Replicate():
            n *= x.device_mesh.size(j)
    if x.shape[0] % n or shape[0] % n:
        p = (Replicate(),) * len(p)
    rest = tuple(shape[1:])
    return local_map(lambda t: t.reshape(-1, *rest), out_placements=list(p),
                     in_placements=(p,), in_grad_placements=(p,),
                     device_mesh=x.device_mesh)(place(x, p))


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D w, on local shards where x is a DTensor
    (``contract``)."""
    return contract(torch.matmul, x, w)


# ---------------------------------------------------------------------------
# Schema-wide helpers
# ---------------------------------------------------------------------------


def param_pspecs(schema, rules: AxisRules):
    return map_specs(lambda _, s: rules.spec(s.axes, s.shape), schema)


def param_shardings(schema, rules: AxisRules):
    return map_specs(lambda _, s: rules.sharding(s.axes, s.shape), schema)


def zero1_pspecs(schema, rules: AxisRules):
    return map_specs(lambda _, s: rules.zero1_spec(s.axes, s.shape), schema)


def zero1_shardings(schema, rules: AxisRules):
    return map_specs(lambda _, s: rules.zero1_sharding(s.axes, s.shape),
                     schema)


def zeros_placed(schema, rules: AxisRules | None, device):
    """Zeros of every leaf of ``schema``: DTensors at the rules'
    placements where the rules are bound to a device mesh, plain tensors
    on ``device`` otherwise."""
    if rules is None or isinstance(rules.mesh, AbstractMesh):
        return map_specs(lambda _, s: torch.zeros(
            s.shape, dtype=s.dtype, device=device), schema)
    return map_specs(lambda _, s: dtensor_zeros(
        s.shape, dtype=s.dtype, device_mesh=rules.region_mesh,
        placements=rules.placements(s.axes, s.shape)), schema)


def distribute_params(tree, shardings):
    """A tree of full tensors, built the same way on every rank, as
    DTensors placed by ``shardings`` (a tree of ``Sharding``s of the same
    structure).  On a mesh of one rank each DTensor's local tensor is
    the leaf itself, as ``distribute_tensor`` gives it for a
    ``Replicate()`` placement (a ``Shard`` would copy even over a mesh
    dim of one rank): placing a state never holds it twice."""
    def one(t, s):
        if s.mesh.size() == 1:
            return DTensor.from_local(t.detach(), s.mesh, s.placements,
                                      run_check=False, shape=t.shape,
                                      stride=t.stride())
        return distribute_tensor(t, s.mesh, s.placements)

    return tree_zip(one, tree, shardings)
