"""AdamW with optional int8-quantized moments ("8-bit Adam"), the JAX
package's ``optim/adamw.py`` on torch tensors.

The state is a nested dict laid out as the JAX package's (``m``, ``v``,
``count`` and, for bf16 leaves, the f32 ``master``), so a checkpoint of
either package restores in the other.  Updates are functional: new
tensors, the old state untouched.  The ZeRO-1 placements are
``runtime/train_step.py``'s.

int8 moments use blockwise (last-dim blocks of ``QBLOCK``) quantization:
absmax for the first moment, an affine code of log(v) for the second
(v spans many orders of magnitude within a block).  q keeps the
parameter's shape; only the scales carry the block structure.  Weight
decay applies to every leaf, as in the JAX package.

On DTensors (the sharded train step, ``runtime/train_step.py``) the
update is elementwise at the state's placements and moves no data: a
leaf whose operands share one placement runs on their local shards (the
same ops, without DTensor's dispatch: its sharding propagation, paid at
the first sight of each op and shape, took ~0.1 s an op on a 3-D mesh
of CPU ranks under torch 2.13); the
int8 codes are the one exception: a block runs along the last dim and
may straddle the shards of a sharded last dim (Yi-6B's 11008-wide MLP
is 86 blocks, which 16 "model" ranks do not split), so ``_whole_blocks``
gathers that dim before a leaf is quantised or dequantised.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.params import (
    ParamSpec,
    map_specs,
    tree_leaves,
    tree_map,
    tree_zip,
    zeros_param,
)
from repro_torch.optim.schedule import constant
from repro_torch.sharding.rules import replicate_dims

QBLOCK = 128
_VLOG_FLOOR = 1e-24


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], tuple[Any, Any]]
    state_schema: Callable[[Any], Any]   # ParamSpec tree for checkpoints


def _one_placement(*xs) -> bool:
    """Whether ``xs`` are DTensors of one shape on one mesh at the same
    placements, none of them partial: an elementwise op of them is then
    the op of their local shards."""
    if not all(isinstance(x, DTensor) for x in xs):
        return False
    first = xs[0]
    if any(p.is_partial() for p in first.placements):
        return False
    return all(x.shape == first.shape and x.device_mesh == first.device_mesh
               and x.placements == first.placements for x in xs[1:])


def _replicated_local(x):
    """A replicated scalar's local value (a plain tensor as it is)."""
    if isinstance(x, DTensor):
        if not all(p.is_replicate() for p in x.placements):
            raise ValueError(f"a scalar of the update is at {x.placements}")
        return x.to_local()
    return x


def _quantizable(shape, size) -> bool:
    return len(shape) > 0 and size >= QBLOCK and shape[-1] % QBLOCK == 0


def _blocks(shape) -> tuple:
    return tuple(shape[:-1]) + (shape[-1] // QBLOCK, QBLOCK)


def _whole_blocks(x: torch.Tensor) -> torch.Tensor:
    """x with its last dim whole on every rank (an all-gather where a
    DTensor shards it; a plain tensor as it is)."""
    return replicate_dims(x, -1)


def _q8(x: torch.Tensor):
    """Blockwise signed linear int8 quantization (for the 1st moment)."""
    if not _quantizable(x.shape, x.numel()):
        return x.to(torch.float32), None
    xb = _whole_blocks(x).reshape(_blocks(x.shape))
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0
    q = torch.round(xb / torch.clamp(scale, min=1e-20)).to(torch.int8)
    return q.reshape(x.shape), scale.to(torch.float32)


def _dq8(q, scale, shape):
    if scale is None:
        return q
    return (_whole_blocks(q).reshape(_blocks(shape)).to(torch.float32)
            * scale).reshape(shape)


def _q8log(x: torch.Tensor):
    """Blockwise log-space 8-bit quantization (for the 2nd moment)."""
    if not _quantizable(x.shape, x.numel()):
        return x.to(torch.float32), None, None
    xl = torch.log(_whole_blocks(x).reshape(_blocks(x.shape)) + _VLOG_FLOOR)
    lo = torch.amin(xl, dim=-1, keepdim=True)
    hi = torch.amax(xl, dim=-1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.round((xl - lo) / span * 255.0 - 128.0).to(torch.int8)
    return q.reshape(x.shape), lo.to(torch.float32), span.to(torch.float32)


def _dq8log(q, lo, span, shape):
    if lo is None:
        return q
    xl = (_whole_blocks(q).reshape(_blocks(shape)).to(torch.float32)
          + 128.0) / 255.0 \
        * span + lo
    return (torch.exp(xl) - _VLOG_FLOOR).reshape(shape)


def make_adamw(
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    lr_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    int8: bool = False,
    master_fp32: bool = True,
) -> Optimizer:
    lr_fn = lr_fn or constant(1e-4)

    def moment_init(p, log: bool = False):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if int8:
            if log:
                q, lo, span = _q8log(z)
                if lo is not None:
                    return {"q": q, "lo": lo, "span": span}
                return {"q": q}
            q, s = _q8(z)
            return {"q": q, "scale": s} if s is not None else {"q": q}
        return z

    def init(params):
        state = {
            "m": tree_map(moment_init, params),
            "v": tree_map(lambda p: moment_init(p, log=True), params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device),
        }
        if master_fp32 and any(
            t.dtype == torch.bfloat16 for t in tree_leaves(params)
        ):
            state["master"] = tree_map(lambda p: p.to(torch.float32), params)
        return state

    def _get_moment(st, shape):
        if isinstance(st, dict):
            if "lo" in st:
                return _dq8log(st["q"], st["lo"], st["span"], shape)
            return _dq8(st["q"], st.get("scale"), shape)
        return st

    def _set_moment(old, val):
        if isinstance(old, dict):
            if "lo" in old:
                q, lo, span = _q8log(val)
                return {"q": q, "lo": lo, "span": span}
            q, s = _q8(val)
            return {"q": q, "scale": s} if s is not None else {"q": q}
        return val

    def update(grads, state, params, step):
        count = state["count"] + 1
        lr = lr_fn(step)
        c1 = 1.0 - b1 ** count.to(torch.float32)
        c2 = 1.0 - b2 ** count.to(torch.float32)
        masters = state.get("master", params)

        def step_math(p, g, m_st, v_st, master, c1, c2, lr):
            g = g.to(torch.float32)
            m = b1 * _get_moment(m_st, g.shape) + (1 - b1) * g
            v = b2 * _get_moment(v_st, g.shape) + (1 - b2) * torch.square(g)
            mh, vh = m / c1, v / c2
            base = master.to(torch.float32)
            new = base - lr * (mh / (torch.sqrt(vh) + eps)
                               + weight_decay * base)
            return (new.to(p.dtype), _set_moment(m_st, m),
                    _set_moment(v_st, v), new)

        def leaf(p, g, m_st, v_st, master):
            if int8 or not _one_placement(p, g, m_st, v_st, master):
                return step_math(p, g, m_st, v_st, master, c1, c2, lr)
            # every operand at one placement: the same elementwise math
            # on the local shards, without DTensor's dispatch
            out = step_math(*(x.to_local() for x in (p, g, m_st, v_st,
                                                     master)),
                            *(_replicated_local(x) for x in (c1, c2, lr)))
            return tuple(DTensor.from_local(
                o, p.device_mesh, p.placements, run_check=False,
                shape=p.shape, stride=p.stride()) for o in out)

        out = tree_zip(leaf, params, grads, state["m"], state["v"], masters)
        new_state = {
            "m": tree_map(lambda r: r[1], out),
            "v": tree_map(lambda r: r[2], out),
            "count": count,
        }
        if "master" in state:
            new_state["master"] = tree_map(lambda r: r[3], out)
        return tree_map(lambda r: r[0], out), new_state

    def state_schema(param_schema):
        """The layout ``init`` gives.  (The JAX package's
        ``state_schema`` gives a bare spec for the int8 moments of a leaf
        too small to quantise, where its ``init`` gives ``{"q": f32}``;
        this follows the state, so a checkpoint of either restores.)"""
        def moment_spec(ps: ParamSpec, log: bool = False):
            if int8 and not _quantizable(ps.shape, ps.size):
                return {"q": zeros_param(ps.shape, ps.axes, torch.float32)}
            if int8:
                sshape = ps.shape[:-1] + (ps.shape[-1] // QBLOCK, 1)
                saxes = ps.axes[:-1] + (None, None)
                out = {"q": zeros_param(ps.shape, ps.axes, torch.int8)}
                if log:
                    out["lo"] = zeros_param(sshape, saxes, torch.float32)
                    out["span"] = zeros_param(sshape, saxes, torch.float32)
                else:
                    out["scale"] = zeros_param(sshape, saxes, torch.float32)
                return out
            return zeros_param(ps.shape, ps.axes, torch.float32)

        sch = {
            "m": map_specs(lambda _, ps: moment_spec(ps), param_schema),
            "v": map_specs(lambda _, ps: moment_spec(ps, log=True),
                           param_schema),
            "count": zeros_param((), (), torch.int32),
        }
        if master_fp32 and any(
            s.dtype == torch.bfloat16 for s in tree_leaves(param_schema)
        ):
            sch["master"] = map_specs(
                lambda _, ps: dataclasses.replace(ps, dtype=torch.float32),
                param_schema)
        return sch

    return Optimizer(init=init, update=update, state_schema=state_schema)

