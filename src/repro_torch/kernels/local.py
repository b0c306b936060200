"""The LM kernels on DTensors: local shards through ``local_map``.

A DTensor reports the device of its local shard, so without a branch
of its own it would reach a kernel's ctypes wrapper, which reads
``data_ptr()`` of a tensor that is not a plain one.  Each wrapper in
``flash_attention/ops.py``, ``rmsnorm/ops.py`` and ``ssd/ops.py`` takes
a DTensor here instead: its inputs are redistributed to the placements
the kernel is parallel over, and the same wrapper runs on the local
shards through ``torch.distributed.tensor.experimental.local_map`` —
the Hopper kernel on the card (inside its ``autograd.Function`` when
grad is needed, so training keeps the kernels), the plain version on
the CPU's gloo ranks.

The placements each kernel is parallel over:

* flash attention, q (B, H, Sq, D): batch and heads (``Shard(0)``,
  ``Shard(1)``); a sharded sequence or head dim, or a partial sum, is
  made ``Replicate()``.  k and v follow q's batch placement; their
  heads are sharded with q's only where each rank's q heads use exactly
  its own kv heads (``KH`` divisible by the heads' mesh size), else
  they are replicated there and each rank slices the kv heads its q
  heads use (``_kv_for_heads``);
* ``rmsnorm_residual``, x and res (..., d): every dim but ``d`` (the
  batch and sequence of the model's (B, S, d), each rank's rows
  flattened on its own shard); ``d`` replicated, the scale replicated;
* ``ssd_chunk``, (BC, H, Q, ·): batch·chunks and heads.

An input replicated over a mesh axis that splits the work (the norm's
scale over the row shards, kv heads sliced per rank) gets its gradient
as ``Partial()`` there: each rank holds its share of the sum.
``LOCAL_MAP_CALLS`` counts the branch's calls per kernel.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.sharding.rules import place

#: calls of each wrapper's DTensor branch
LOCAL_MAP_CALLS = {"flash_attention": 0, "rmsnorm_residual": 0,
                   "ssd_chunk": 0}


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _shard_dim(p, ndim: int):
    return p.dim % ndim if isinstance(p, Shard) else None


def keep_shards(x: DTensor, dims: Sequence[int]) -> tuple:
    """x's placements with ``Shard(d)`` kept for ``d`` in ``dims``; any
    other placement (a shard of another dim, a partial sum) becomes
    ``Replicate()``."""
    out = []
    for p in x.placements:
        d = _shard_dim(p, x.ndim)
        out.append(Shard(d) if d in dims else Replicate())
    return tuple(out)


def split_grads(placements: Sequence, split_by: Sequence) -> tuple:
    """The gradient placements of an input replicated where ``split_by``
    shards the work: ``Partial()`` on those mesh axes."""
    return tuple(Partial() if isinstance(p, Replicate)
                 and isinstance(s, Shard) else p
                 for p, s in zip(placements, split_by))


def run_local(name: str, fn: Callable, mesh, args, in_placements,
              out_placements, in_grad_placements):
    """``fn`` on the local shards of ``args`` (already at
    ``in_placements``) through ``local_map``; counts the call."""
    LOCAL_MAP_CALLS[name] += 1
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements,
                     device_mesh=mesh)(*args)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _heads_offset(x: DTensor, dim: int) -> int:
    """The first global index along ``dim`` of this rank's shard."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    off, n = 0, x.shape[dim]
    for j, p in enumerate(x.placements):
        if _shard_dim(p, x.ndim) == dim:
            m = mesh.size(j)
            n //= m
            off += coord[j] * n
    return off


def _kv_for_heads(k: torch.Tensor, h0: int, hl: int, rep: int):
    """k's kv heads for global q heads ``h0 .. h0+hl-1`` (kv head
    ``h // rep``): a slice of whole groups where the kernel's own
    mapping ``i // (hl / nk)`` picks them, else the heads gathered one
    per q head."""
    idx = [(h0 + i) // rep for i in range(hl)]
    k0, nk = idx[0], idx[-1] - idx[0] + 1
    if hl % nk == 0 and all(j == k0 + i // (hl // nk)
                            for i, j in enumerate(idx)):
        return k[:, k0:k0 + nk]
    return k[:, idx]


def attention_local(attn: Callable, q: DTensor, k, v, causal: bool,
                    softcap: float = 0.0):
    """``attn`` (the plain-tensor wrapper) on local shards: q (B, H, Sq,
    D) over batch and heads, k and v (B, KH, Sk, ·) over batch and,
    where the groups line up, heads; each shard capped by ``softcap``."""
    mesh = q.device_mesh
    H, KH = q.shape[1], k.shape[1]
    qp = keep_shards(q, (0, 1))
    heads_m = 1
    for j, p in enumerate(qp):
        if p == Shard(1):
            heads_m *= mesh.size(j)
    aligned = KH % heads_m == 0
    kp = tuple(p if p == Shard(0) or (p == Shard(1) and aligned)
               else Replicate() for p in qp)
    q = place(q, qp)
    k, v = place(k, kp, mesh), place(v, kp, mesh)
    kv_grad = split_grads(kp, qp)
    h0 = _heads_offset(q, 1)
    rep = H // KH

    def fn(ql, kl, vl):
        if not aligned:
            hl = ql.shape[1]
            kl, vl = (_kv_for_heads(t, h0, hl, rep) for t in (kl, vl))
        return attn(ql, kl, vl, causal=causal, softcap=softcap)

    # one output: its placements as a list (a tuple lists outputs)
    return run_local("flash_attention", fn, mesh, (q, k, v),
                     (qp, kp, kp), list(qp), (qp, kv_grad, kv_grad))


# ---------------------------------------------------------------------------
# rmsnorm_residual and ssd_chunk
# ---------------------------------------------------------------------------


def rmsnorm_local(norm: Callable, x: DTensor, res, scale, eps: float):
    """``norm`` on row shards: x and res (..., d) over every dim but d,
    d and the scale replicated.  Each rank flattens its own rows: a
    flatten of the DTensor would merge two sharded dims (a batch and a
    sequence both sharded), which torch refuses."""
    mesh = x.device_mesh
    xp = keep_shards(x, range(x.ndim - 1))
    rep = (Replicate(),) * mesh.ndim
    x, res, scale = (place(x, xp), place(res, xp, mesh),
                     place(scale, rep, mesh))

    def fn(xl, rl, sl):
        shape, d = xl.shape, xl.shape[-1]
        h, s = norm(xl.reshape(-1, d).contiguous(),
                    rl.reshape(-1, d).contiguous(), sl, eps)
        return h.reshape(shape), s.reshape(shape)

    return run_local("rmsnorm_residual", fn, mesh, (x, res, scale),
                     (xp, xp, rep), (xp, xp),
                     (xp, xp, split_grads(rep, xp)))


def ssd_local(ssd: Callable, xdt: DTensor, b, c, csum):
    """``ssd`` on (batch·chunk, head) shards of xdt, b, c (BC, H, Q, ·)
    and csum (BC, H, Q)."""
    mesh = xdt.device_mesh
    p = keep_shards(xdt, (0, 1))
    args = tuple(place(t, p, mesh) for t in (xdt, b, c, csum))
    return run_local("ssd_chunk", ssd, mesh, args, (p,) * 4, (p, p),
                     (p,) * 4)
