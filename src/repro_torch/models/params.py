"""Parameter schemas: declare once, materialize on a device.

The parameter-schema half of the JAX package's ``sharding/rules.py``.
A schema is a nested dict whose leaves are ``ParamSpec``s; parameters
are the same nested dict with tensors at the leaves, so a JAX parameter
pytree and the port's have one layout (``models/convert.py``).  Each
leaf is drawn with the JAX package's rule: a fan-in normal over axis -2
of the unstacked shape (the last axis for a vector), ones for scales,
zeros for caches, and a fixed-std normal for the embeddings.  The two
Mamba-2 inits the JAX schema gives as callables are kinds here too:
``a_log`` is ``log(1..H)`` (deterministic, equal to JAX's), ``dt_bias``
the inverse softplus of a log-uniform draw in ``[dt_min, dt_max]``.
Values come from an explicit ``torch.Generator`` on an explicit device;
the random ones do not equal JAX's draws.

The placement half (``AxisRules``, ``shard``, ``param_shardings``) is
``sharding/rules.py``: it resolves each spec's axis names to DTensor
placements on a device mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

#: init kinds
FAN_IN, ZEROS, ONES, NORMAL = "fan_in", "zeros", "ones", "normal"
A_LOG, DT_BIAS = "a_log", "dt_bias"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Metadata-only description of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.float32
    init: str = FAN_IN
    std: float = 0.0          # NORMAL only
    dt_range: tuple[float, float] = (0.0, 0.0)   # DT_BIAS only: (min, max)
    stacked: int = 0          # leading stacked-layer axes (fan-in skips them)
    pinned: bool = False      # dtype fixed whatever the config's (the router)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


def param(shape, axes, dtype=torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, FAN_IN)


def zeros_param(shape, axes, dtype=torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, ZEROS)


def scale_param(shape, axes, dtype=torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, ONES)


def normal_param(shape, axes, std, dtype=torch.float32, *,
                 pinned=False) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, NORMAL, float(std),
                     pinned=pinned)


def a_log_param(shape, axes, dtype=torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, A_LOG)


def dt_bias_param(shape, axes, dt_min, dt_max,
                  dtype=torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, DT_BIAS,
                     dt_range=(float(dt_min), float(dt_max)))


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def map_specs(fn: Callable[[tuple[str, ...], ParamSpec], Any], schema,
              path: tuple[str, ...] = ()):
    """``fn(path, spec)`` at every leaf of a schema, keys in sorted
    order (the order ``jax.tree`` flattens a dict in)."""
    if is_spec(schema):
        return fn(path, schema)
    return {k: map_specs(fn, schema[k], path + (k,)) for k in sorted(schema)}


def tree_leaves(tree) -> list:
    """Leaves of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_zip(fn, tree, *rest):
    """``fn(leaf, *others)`` at every leaf of ``tree``; each tree of
    ``rest`` has ``tree``'s dict structure down to its leaves and may
    hold anything there (an optimizer's moment dict, say)."""
    if isinstance(tree, dict):
        return {k: tree_zip(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    out = _fill(tree, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _fill(tree, it):
    if isinstance(tree, dict):
        return {k: _fill(tree[k], it) for k in sorted(tree)}
    return next(it)


def stack_schema(schema, n: int, axis_name: str | None = "layers"):
    """Add a leading stacked-layers dim to every spec in a schema."""
    return map_specs(lambda _, s: dataclasses.replace(
        s, shape=(n,) + s.shape, axes=(axis_name,) + s.axes,
        stacked=s.stacked + 1), schema)


def fan_in_std(spec: ParamSpec) -> float:
    inner = spec.shape[spec.stacked:]
    fan_in = inner[-2] if len(inner) >= 2 else inner[-1]
    return 1.0 / (fan_in ** 0.5)


def init_leaf(spec: ParamSpec, gen: torch.Generator,
              device) -> torch.Tensor:
    """One parameter: drawn in f32 from ``gen``, cast to its dtype."""
    if spec.init == ZEROS:
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == ONES:
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == A_LOG:
        # log(1..H) along the last axis, the same for every stacked layer
        h = torch.arange(1, spec.shape[-1] + 1, dtype=torch.float32,
                         device=device)
        return torch.log(h).to(spec.dtype).expand(spec.shape).contiguous()
    if spec.init == DT_BIAS:
        # dt = exp(u·(log dt_max − log dt_min) + log dt_min), u ~ U[0, 1);
        # the bias is softplus⁻¹(dt) = dt + log(−expm1(−dt))
        lo, hi = (torch.log(torch.tensor(v, dtype=torch.float32))
                  for v in spec.dt_range)
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32,
                       device=device)
        dt = torch.exp(u * (hi - lo).to(device) + lo.to(device))
        return (dt + torch.log(-torch.expm1(-dt))).to(spec.dtype)
    std = fan_in_std(spec) if spec.init == FAN_IN else spec.std
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(spec.dtype)


def init_params(schema, gen: torch.Generator, device):
    """Materialize parameter values from a schema on ``device``."""
    return map_specs(lambda _, s: init_leaf(s, gen, device), schema)


def zeros_like_schema(schema, device):
    return map_specs(lambda _, s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=device), schema)


def count_params(schema) -> int:
    return sum(s.size for s in tree_leaves(schema))
