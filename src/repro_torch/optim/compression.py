"""Cross-pod gradient compression and the two-level reduction.

The JAX package's ``optim/compression.py``.  The paper's constraint is
the slow link between the two environments (cluster <-> cloud
Ethernet; on a pod mesh the inter-pod link against the links inside a
pod).  Gradients are reduced inside a pod by the placements
(``sharding/rules.py``), then cross the "pod" axis in int8 (blockwise
absmax), which cuts the bytes on that link 4× against f32 and 2×
against bf16: the wire carries int8 payloads and f32 scales, never
dequantised values (a sum of dequantised values over the group would
put f32 on the link).

``cross_pod_reduce(grads, group, method)`` takes a tree of tensors
(plain, or DTensors whose local shards are reduced) and the process
group of one rank's pod peers (``mesh.get_group("pod")``):

* ``"none"``: a sum over the group (``all_reduce``);
* ``"int8"``: every leaf quantised once (``_q8``); for hop 1 .. P−1 each
  rank sends its own payload to the peer ``hop`` ahead in the group and
  receives the one ``hop`` behind (one ``batch_isend_irecv`` a hop, all
  leaves packed into one int8 and one f32 message: each leaf's n int8
  values, its last block's zero padding left off, and one scale a
  block, ``compressed_bytes(n)``), dequantises and adds, in the JAX
  package's order.  A rank's own leaf enters exact and
  its peers' quantised, so the pods' sums differ by at most the
  quantisation error, as the JAX package's do.

A DTensor's blocks of ``CBLOCK`` values are cut from its rank's local
shard, flattened; the JAX package cuts them from each leaf flattened
whole, so the two quantise alike where a pod holds a leaf on one rank
(or replicated) and by other blocks, to the same bound, where a pod
shards it.  ``SENT`` counts the bytes each exchange sends, by dtype.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.params import tree_leaves, tree_unflatten

CBLOCK = 256

#: bytes sent by the int8 exchange, by dtype name
SENT = {"int8": 0, "float32": 0}


def _q8(x: torch.Tensor):
    """Blockwise int8 quantisation: (q (nb, CBLOCK) int8, scale (nb, 1)
    in x's dtype, n) over x flattened and zero-padded to whole blocks."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % CBLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, CBLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-20))
    # XLA's float -> int conversion saturates; torch's wraps (a bf16
    # quotient can round up to 127.5, and then to 128)
    return q.clamp(-128, 127).to(torch.int8), scale, n


def _dq8(q: torch.Tensor, scale: torch.Tensor, n: int, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)[:n]
    return flat.reshape(shape)


def compressed_bytes(n_params: int) -> tuple[int, int]:
    """(wire bytes with int8, wire bytes with fp32) per pod-hop."""
    blocks = (n_params + CBLOCK - 1) // CBLOCK
    return n_params + 4 * blocks, 4 * n_params


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def _like(x: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` in ``x``'s form: a DTensor at x's placements, or as it
    is."""
    if not isinstance(x, DTensor):
        return local
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _send_recv(payloads, group, hop: int) -> list[torch.Tensor]:
    """Each of ``payloads`` sent to the group rank ``hop`` ahead; the
    same shapes received from the one ``hop`` behind."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (i + hop) % n)
    src = dist.get_global_rank(group, (i - hop) % n)
    recv = [torch.empty_like(t) for t in payloads]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in payloads]
    ops += [dist.P2POp(dist.irecv, t, src, group) for t in recv]
    reqs = dist.batch_isend_irecv(ops)
    for req in reqs:
        req.wait()
    for t in payloads:
        SENT[str(t.dtype).removeprefix("torch.")] += t.numel() * \
            t.element_size()
    return recv


def cross_pod_reduce(grads, group, method: str = "int8"):
    """All-reduce a tree of gradients over ``group`` (one rank's pod
    peers).  ``"none"``: the exact sum; ``"int8"``: the quantised
    exchange (module docstring).  Leaves keep their dtype and form."""
    leaves = tree_leaves(grads)
    if method == "none":
        out = []
        for g in leaves:
            t = _local(g).clone()
            dist.all_reduce(t, group=group)
            out.append(_like(g, t))
        return tree_unflatten(grads, out)
    if method != "int8":
        raise ValueError(f"unknown gradient compression {method!r}")
    npods = dist.get_world_size(group)
    locs = [_local(g) for g in leaves]
    acc = [t.to(torch.float32) for t in locs]
    quant = [_q8(t.to(torch.float32)) for t in locs]
    sizes = [n for _, _, n in quant]
    rows = [s.shape[0] for _, s, _ in quant]
    if quant and npods > 1:
        q_all = torch.cat([q.reshape(-1)[:n] for q, _, n in quant])
        s_all = torch.cat([s for _, s, _ in quant]).contiguous()
        for hop in range(1, npods):
            q_r, s_r = _send_recv((q_all, s_all), group, hop)
            for j, (qj, sj) in enumerate(zip(q_r.split(sizes),
                                             s_r.split(rows))):
                qj = torch.nn.functional.pad(qj, (0, (-qj.shape[0]) % CBLOCK))
                acc[j] = acc[j] + _dq8(qj.reshape(-1, CBLOCK), sj, sizes[j],
                                       locs[j].shape)
    out = [_like(g, a.to(t.dtype)) for g, t, a in zip(leaves, locs, acc)]
    return tree_unflatten(grads, out)
