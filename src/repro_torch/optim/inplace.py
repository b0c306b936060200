"""The optimizers' in-place updates: the port's ``donate_argnums=(0,)``.

The JAX package jits its train steps with the state donated, so XLA
writes the new parameters and moments into the old buffers, fuses the
update and frees each gradient once it is used.  ``update_`` of
``optim/adamw.py`` and ``optim/adafactor.py`` do the same in eager
PyTorch: one leaf at a time, each new value written into the old tensor
(``data_ptr()`` unchanged), each gradient leaf dropped from the caller's
tree once it is used, and a large leaf cut into row chunks so that the
temporaries of one chunk stay bounded.  The new values are bitwise the
plain ``update``'s.

A DTensor whose placements cut nothing (a one-rank mesh) is updated
through its local tensor, without DTensor's dispatch; so is a leaf whose
operands share one placement where the math is elementwise.  Elsewhere
the leaf is computed as the plain update computes it and copied into the
old leaf.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.sharding.rules import place


def leaf_paths(tree, prefix: tuple = ()) -> list[tuple]:
    """The key paths of ``tree``'s leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in leaf_paths(tree[k],
                                                             prefix + (k,))]
    return [prefix]


def at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def take_(tree, path: tuple):
    """The leaf at ``path``, left as ``None`` in ``tree``: the tree no
    longer keeps it alive."""
    parent = at(tree, path[:-1])
    leaf = parent[path[-1]]
    parent[path[-1]] = None
    return leaf


def _cuts_nothing(placements, mesh) -> bool:
    """Whether every Shard or Partial of ``placements`` lies on a mesh dim
    of one rank (a property of the placements, so every rank decides
    alike)."""
    return all(p.is_replicate() or mesh.size(i) == 1
               for i, p in enumerate(placements))


def _whole(x) -> bool:
    """Whether ``x`` is whole on every rank: a plain tensor, or a DTensor
    whose placements cut nothing."""
    return not isinstance(x, DTensor) or _cuts_nothing(x.placements,
                                                       x.device_mesh)


def whole_on_rank(*xs) -> bool:
    """Whether each tensor of ``xs`` (moment dicts opened) is whole on
    the rank, so the update may run on local tensors."""
    return all(_whole(t) for x in xs for t in _tensors(x))


def _tensors(x) -> list:
    return list(x.values()) if isinstance(x, dict) else [x]


def local(x):
    """A DTensor's local tensor (sharing its storage); a plain tensor, or
    a dict of them, as it is."""
    if isinstance(x, dict):
        return {k: local(v) for k, v in x.items()}
    return x.to_local() if isinstance(x, DTensor) else x


def write_(old, new) -> None:
    """``new``'s values into ``old`` (a tensor or a moment dict); a
    DTensor's at its own placements, through its local tensor."""
    if isinstance(old, dict):
        for k in old:
            write_(old[k], new[k])
        return
    if new is old:
        return
    if isinstance(old, DTensor):
        new = place(new, old.placements, old.device_mesh)
        old.to_local().copy_(new.to_local())
    else:
        old.copy_(new)


def bump_(step: torch.Tensor) -> None:
    """A replicated step counter advanced by one, in place."""
    local(step).add_(1)


def rows_view(x, lead: tuple, rows: int):
    """``x`` (or each tensor of a moment dict) seen as rows of the
    leaf's leading dims ``lead`` flattened: ``(rows, *rest)``, sharing
    storage."""
    if isinstance(x, dict):
        return {k: rows_view(v, lead, rows) for k, v in x.items()}
    return x.view((rows,) + tuple(x.shape[len(lead):]))


def row_slice(x, lo: int, hi: int):
    if isinstance(x, dict):
        return {k: v[lo:hi] for k, v in x.items()}
    return x[lo:hi]


def contiguous(*xs) -> bool:
    return all(t.is_contiguous() for x in xs for t in _tensors(x))


def each_leaf_(params, grads, shardings, fn: Callable) -> None:
    """``fn(path, p, g)`` for every leaf of ``params`` in turn, ``g`` the
    gradient taken out of ``grads`` (``take_``).  With ``shardings``
    (the update's placements, ZeRO-1's) a leaf not whole on the rank has
    its gradient and parameter placed there first, and the updated
    parameter placed back into the old one; each is freed before the
    next leaf."""
    for path in leaf_paths(params):
        p, g = at(params, path), take_(grads, path)
        s = at(shardings, path) if shardings is not None else None
        if s is None or (whole_on_rank(p, g)
                         and _cuts_nothing(s.placements, s.mesh)):
            fn(path, p, g)
            del g
            continue
        g = place(g, s.placements, s.mesh)
        pu = place(p, s.placements, s.mesh)
        fn(path, pu, g)
        del g
        write_(p, pu)
        del pu
