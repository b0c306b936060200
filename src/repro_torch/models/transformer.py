"""Decoder stack: attention, multi-head latent attention (MLA) and
Mamba-2 layers, each with a dense MLP, a mixture-of-experts MLP or
none, in any pattern of the config's blocks, and with
cross-attention to an encoder's output between the mixer and the MLP
where the config has it (whisper's decoder).

The JAX package's ``models/transformer.py``, with a Python loop over the
stacked layers in place of ``lax.scan`` / ``fori_loop``.  Parameters
keep the JAX layout: each block's layer params are stacked on a
leading axis, and layer ``i`` is the view ``a[i]`` of every leaf.

The residual → norm seams are fused.  Where the JAX layer computes
``x = x + y; h = apply_norm(norm, x)``, the port makes one
``rmsnorm_residual(x, y, scale)`` call (the Hopper kernel on the card)
that returns ``(h, x)``; a layernorm config (whisper) computes the same
pair in plain torch ops, as the JAX package computes layernorm outside
any Pallas kernel.  A layer therefore returns its last output (the
MLP's, or the mixer's in a layer without an MLP) un-added, and the next
layer's ``norm1`` adds it; the last layer's is added by the model's
``final_norm``.  Layer 0's ``norm1`` calls the kernel with a zero
residual: ``x + 0`` is ``x`` exactly, so that norm equals
``apply_norm``, and every norm of the path runs on the one kernel —
``Σ(1 + [cross] + [mlp ≠ none]) + 1`` launches per pass — for one
extra read of a zero tensor.  A layer with an MLP, attention or Mamba,
takes its ``norm2`` seam the same way, and a cross-attention layer its
``norm_x`` seam before the cross-attention.

A MoE layer's aux terms (``lb_loss + z_loss``) are carried out of each
layer and block in the order the JAX package sums them, one running
sum over the layers; a dense layer adds nothing.  Decode drops them, as
the JAX package does.  The cross-attention's k and v come from the
encoder's output in prefill (stored in the layer's cross cache) and from
that cache in decode.

Training runs the same layers with no cache, each repeat unit of a
block under ``remat_wrap`` (the JAX package's ``jax.checkpoint`` of its
scan body): ``full`` recomputes the unit in the backward, ``dots``
keeps the outputs of its 2-D matrix products and recomputes the rest.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.kernels.rmsnorm.ops import rmsnorm_residual
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    mlp_schema,
    norm_schema,
)
from repro_torch.models.params import stack_schema, tree_map
from repro_torch.sharding.rules import placement_context, shard


#: the (mixer, mlp) layer kinds the port serves
LAYER_KINDS = tuple((mixer, mlp) for mixer in ("attn", "mla", "mamba")
                    for mlp in ("none", "dense", "moe"))

#: each mixer's schema
_MIXER_SCHEMAS = {"attn": attn.attn_schema, "mla": mla_mod.mla_schema,
                  "mamba": mamba2.mamba_schema}


def _served(mixer: str, mlp: str) -> None:
    if (mixer, mlp) not in LAYER_KINDS:
        raise NotImplementedError(
            f"layer ({mixer!r}, {mlp!r}): the port serves {LAYER_KINDS} "
            f"layers only")


#: the 2-D products "dots" saves: ``dots_with_no_batch_dims_saveable``
#: (the attention's batched products are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(cfg: ModelConfig, fn, override: str | None = None):
    """``fn`` under the remat mode ``override`` (default ``cfg.remat``):
    ``none`` as it is, ``full`` checkpointed (nothing saved), ``dots``
    checkpointed saving the 2-D matrix products' outputs.  A
    checkpointed ``fn`` is recomputed under the placement rules and
    implicit replication of its call (``placement_context``): the
    recompute runs in the backward, for CUDA tensors on the autograd
    engine's own thread, where the thread-local rules are not set, and
    without them a MoE layer would take another path than it took in the
    forward."""
    mode = override if override is not None else cfg.remat
    if mode == "none":
        return fn
    kw = {"use_reentrant": False}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    elif mode != "full":
        raise ValueError(f"remat {mode!r}: expected none, dots or full")

    def wrapped(*args):
        enter = placement_context()

        def under_context(*a):
            with enter():
                return fn(*a)

        return checkpoint(under_context, *args, **kw)

    return wrapped


def fused_norm(cfg: ModelConfig, p, x: torch.Tensor, res: torch.Tensor):
    """``(apply_norm(x + res), x + res)`` over the last axis.  RMSNorm:
    one fused call, the sum kept in f32 for the norm and returned in x's
    dtype.  Layernorm: the sum in x's dtype, then ``apply_norm``, in
    plain torch ops (no kernel: the JAX package has none for it)."""
    if cfg.norm == "layernorm":
        s = x + res.to(x.dtype)
        return apply_norm(cfg, p, s), s
    if isinstance(x, DTensor):
        # rows flattened per shard: a sharded batch and sequence may not merge
        return rmsnorm_residual(x, res.to(x.dtype), p["scale"], cfg.norm_eps)
    shape, d = x.shape, x.shape[-1]
    h, s = rmsnorm_residual(x.reshape(-1, d).contiguous(),
                            res.to(x.dtype).reshape(-1, d).contiguous(),
                            p["scale"], cfg.norm_eps)
    return h.reshape(shape), s.reshape(shape)


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------


def layer_schema(cfg: ModelConfig, mixer: str, mlp: str,
                 cross: bool = False):
    _served(mixer, mlp)
    s = {"norm1": norm_schema(cfg), "mixer": _MIXER_SCHEMAS[mixer](cfg)}
    if cross:
        s["norm_x"] = norm_schema(cfg)
        s["cross"] = attn.attn_schema(cfg)
    if mlp == "dense":
        s["norm2"] = norm_schema(cfg)
        s["mlp"] = mlp_schema(cfg)
    elif mlp == "moe":
        s["norm2"] = norm_schema(cfg)
        s["mlp"] = moe_mod.moe_schema(cfg)
    return s


def layer_cache_schema(cfg: ModelConfig, mixer: str, batch: int,
                       max_seq: int, cross: bool = False):
    if mixer == "mamba":
        c = {"mixer": mamba2.mamba_cache_schema(cfg, batch)}
    elif mixer == "mla":
        c = {"mixer": mla_mod.mla_cache_schema(cfg, batch, max_seq)}
    elif mixer == "attn":
        c = {"mixer": attn.attn_cache_schema(cfg, batch, max_seq)}
    else:
        raise NotImplementedError(
            f"mixer {mixer!r}: the port has attn, mla and mamba only")
    if cross:
        c["cross"] = attn.cross_cache_schema(cfg, batch)
    return c


def apply_layer_full(
    cfg: ModelConfig, p, x, res, mixer: str, mlp: str, *,
    rope_cs, causal=True, cache=None, enc_out=None,
):
    """Prefill / training layer.  ``x`` (B,S,d) is the residual stream
    before the previous layer's last output ``res`` is added.  Returns
    ``(x, y, aux)``: the stream after this layer's last residual but one
    (before the MLP's; the mixer's, or ``res`` in a layer without an
    MLP), this layer's last output (the MLP's; else the
    cross-attention's or the mixer's), which the next fused norm adds,
    and its aux term (``lb_loss + z_loss`` of a MoE layer, else 0.0).  A
    cross-attention layer projects ``enc_out`` (B, F, d) to its k and v
    and, given a cache, stores them in ``cache["cross"]``."""
    _served(mixer, mlp)
    h, x = fused_norm(cfg, p["norm1"], x, res)
    c = None if cache is None else cache["mixer"]
    if mixer == "mamba":
        y = mamba2.apply_mamba_full(cfg, p["mixer"], h, cache=c)
    elif mixer == "mla":
        y = mla_mod.apply_mla_full(cfg, p["mixer"], h, rope_cs=rope_cs,
                                   causal=causal, cache=c)
    else:
        y = attn.apply_attn_full(cfg, p["mixer"], h, rope_cs=rope_cs,
                                 causal=causal, cache=c)
    if "cross" in p:
        hx, x = fused_norm(cfg, p["norm_x"], x, y)
        kv = attn.cross_kv(cfg, p["cross"], enc_out)
        if cache is not None:
            for name in ("k", "v"):
                cache["cross"][name].copy_(kv[name])
            kv = cache["cross"]
        y = attn.apply_cross_attn(cfg, p["cross"], hx, kv)
    aux = 0.0
    if mlp != "none":
        h2, x = fused_norm(cfg, p["norm2"], x, y)
        if mlp == "moe":
            y, moe_aux = moe_mod.apply_moe(cfg, p["mlp"], h2)
            aux = moe_aux["lb_loss"] + moe_aux["z_loss"]
        else:
            y = apply_mlp(cfg, p["mlp"], h2)
    # the JAX layer's x + y, held as its two terms
    return (shard(x, "batch", "seq_res", "d_model"),
            shard(y, "batch", "seq_res", "d_model"), aux)


def apply_layer_decode(
    cfg: ModelConfig, p, x, res, cache, pos: int, mixer: str, mlp: str, *,
    rope_cs,
):
    """Decode layer.  x and res (B,d), as in ``apply_layer_full``, no aux
    term; the layer's cache is updated in place."""
    _served(mixer, mlp)
    h, x = fused_norm(cfg, p["norm1"], x, res)
    if mixer == "mamba":
        y = mamba2.apply_mamba_decode(cfg, p["mixer"], h, cache["mixer"])
    elif mixer == "mla":
        y = mla_mod.apply_mla_decode(cfg, p["mixer"], h, cache["mixer"],
                                     pos, rope_cs=rope_cs)
    else:
        y = attn.apply_attn_decode(cfg, p["mixer"], h, cache["mixer"], pos,
                                   rope_cs=rope_cs)
    if "cross" in p:
        hx, x = fused_norm(cfg, p["norm_x"], x, y)
        y = attn.apply_cross_attn(cfg, p["cross"], hx, cache["cross"])
    if mlp == "none":
        return x, y
    h2, x = fused_norm(cfg, p["norm2"], x, y)
    if mlp == "moe":
        y2, _ = moe_mod.apply_moe(cfg, p["mlp"], h2[:, None])
        return x, y2[:, 0]
    return x, apply_mlp(cfg, p["mlp"], h2)


# ---------------------------------------------------------------------------
# Block groups (a loop over stacked layers)
# ---------------------------------------------------------------------------


def block_schema(cfg: ModelConfig, bdef: BlockDef, cross: bool = False):
    unit = {
        f"l{i}": layer_schema(cfg, mixer, mlp, cross=cross)
        for i, (mixer, mlp) in enumerate(bdef.pattern)
    }
    return stack_schema(unit, bdef.repeat)


def block_cache_schema(cfg: ModelConfig, bdef: BlockDef, batch: int,
                       max_seq: int, cross: bool = False):
    unit = {
        f"l{i}": layer_cache_schema(cfg, mixer, batch, max_seq, cross)
        for i, (mixer, _) in enumerate(bdef.pattern)
    }
    return stack_schema(unit, bdef.repeat)


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree as views: one ``unbind`` per
    leaf, so a backward stacks the layers' gradients once."""
    leaves = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t, r=r: t[r], leaves) for r in range(n)]


def apply_block_full(
    cfg: ModelConfig, bdef: BlockDef, params, x, res, aux=0.0, *,
    rope_cs, causal=True, cache=None, remat: str | None = "none",
    enc_out=None,
):
    """x, res (B,S,d) -> (x, res, aux) after the block's layers, ``aux``
    the running sum of the layers' aux terms; ``cache`` (stacked) is
    filled in place; ``enc_out`` is the encoder's output that
    cross-attention layers attend to.  Each repeat unit runs under
    ``remat_wrap(cfg, ·, remat)``: serving passes ``"none"`` and a
    cache, training its remat mode and no cache."""

    def unit(lp, x, res, aux, lc):
        for i, (mixer, mlp) in enumerate(bdef.pattern):
            x, res, a = apply_layer_full(
                cfg, lp[f"l{i}"], x, res, mixer, mlp, rope_cs=rope_cs,
                causal=causal, cache=None if lc is None else lc[f"l{i}"],
                enc_out=enc_out,
            )
            aux = aux + a
        return x, res, aux

    body = remat_wrap(cfg, unit, remat)
    layers = _unstack(params, bdef.repeat)
    for r in range(bdef.repeat):
        x, res, aux = body(layers[r], x, res, aux,
                           None if cache is None else _layer(cache, r))
    return x, res, aux


def apply_block_decode(
    cfg: ModelConfig, bdef: BlockDef, params, x, res, cache, pos: int, *,
    rope_cs,
):
    """x, res (B,d) -> (x, res); the stacked cache is updated in place
    (the JAX package's fori_loop carry, without the copy)."""
    for r in range(bdef.repeat):
        lp, lc = _layer(params, r), _layer(cache, r)
        for i, (mixer, mlp) in enumerate(bdef.pattern):
            x, res = apply_layer_decode(
                cfg, lp[f"l{i}"], x, res, lc[f"l{i}"], pos, mixer, mlp,
                rope_cs=rope_cs,
            )
    return x, res
