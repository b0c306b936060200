"""Carry a JAX parameter pytree across to the port.

``params_from_numpy(cfg, tree, device)`` takes the JAX package's
parameters as numpy arrays — ``jax.tree.map(np.asarray,
init_params(M.schema(cfg), key))``, layers stacked on a leading axis
under ``b0`` — and returns the port's parameter dict, leaf for leaf, so
both packages compute the same logits.  Each leaf is checked against
the port's schema (keys, shape) and stored in the schema's dtype:
serving's ``schema`` keeps matrices and embeddings in the compute dtype,
which the JAX package keeps in the parameter dtype and casts at every
use to the same values; with ``train=True`` the tree goes into
``train_schema``, every leaf in the parameter dtype as in the JAX
package, so training starts from the same f32 master leaves.  A MoE
layer's leaves come across the same way: the router in f32 under both
schemas (its spec is pinned), the experts in the compute or the
parameter dtype, as the schema says; so do an MLA layer's (``wq_a``,
``q_norm``, ``wq_b`` or ``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b``,
``wo``), DeepSeek-V3's ``mtp`` subtree, whisper's ``encoder`` subtree,
its decoder layers' ``norm_x`` and ``cross`` projections and every
layernorm's ``bias``, all of which ``schema`` declares.
The other direction needs no code: the port's leaves as numpy arrays
are the JAX pytree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.params import map_specs


def _leaf(tree, path):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            raise KeyError(f"parameter {'/'.join(path)} missing")
        tree = tree[key]
    return tree


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def params_from_numpy(cfg: ModelConfig, tree, device, *, train=False):
    sch = M.train_schema(cfg) if train else M.schema(cfg)
    n_spec = 0

    def take(path, spec):
        nonlocal n_spec
        n_spec += 1
        a = np.asarray(_leaf(tree, path))
        if tuple(a.shape) != spec.shape:
            raise ValueError(f"parameter {'/'.join(path)} has shape "
                             f"{tuple(a.shape)}, schema says {spec.shape}")
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
        return t.to(device=device, dtype=spec.dtype)

    out = map_specs(take, sch)
    if _count_leaves(tree) != n_spec:
        raise ValueError(f"tree has {_count_leaves(tree)} leaves, the "
                         f"schema {n_spec}")
    return out
