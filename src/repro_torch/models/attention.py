"""GQA attention: the flash kernel in prefill, a cached decode step,
and whisper's cross-attention.

The JAX package's ``models/attention.py``:

* prefill: q, k and v are projected in the model's (B, S, H, D) layout
  and handed to the attention kernel as (B, H, S, D) views
  (``kernels/flash_attention/ops.py``: the Hopper flash kernel on the
  card, the plain version on the CPU) where the JAX package calls its
  XLA ``chunked_attention``.  Both compute exact softmax attention.
* decode: one new token against the cache, a composition of torch ops
  that mirrors the JAX package's — q·Kᵀ over the whole cache in f32,
  the ``pos`` mask, softmax, probs·V.  The JAX package computes decode
  attention outside any Pallas kernel too (its kernel needs Sq == Sk).
* cross-attention (whisper's decoder): k and v are projected once from
  the encoder's output into the cross cache (``cross_kv``, B × frames
  × KH × D); the decoder's queries attend to all of them, not causally
  — in prefill through the flash kernel with Sq = the prompt and Sk =
  the frames, in decode as a composition of torch ops (f32 scores,
  softmax, probabilities cast to the compute dtype before the product
  with v, as the JAX package's ``chunked_attention`` computes them).

Each weight is cast to the compute dtype at its use, as in the JAX
package.  The cache is written in place (``sharding/rules.py::
write_along``, the JAX package's ``dynamic_update_slice_in_dim``, whose
buffer it donates for the same effect): prefill its first S positions,
decode position ``pos``; on a DTensor cache whose sequence dim is
sharded, only the rank that holds a position writes it.
A logit soft-cap (``attn_logit_softcap > 0``) caps every scaled score to
``cap·tanh(s/cap)`` before the mask, as the JAX package's ``_softcap``:
in the flash kernel (prefill, training, cross-attention's prefill) and
in both decode compositions.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.layers import apply_rope
from repro_torch.models.params import param, zeros_param
from repro_torch.sharding.rules import (
    contract,
    replicate_dims,
    shard,
    shard_count,
    write_along,
)

NEG_INF = -1e30


def attn_schema(cfg: ModelConfig):
    d, H, KH, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": param((d, H, Dh), ("embed", "heads", "head_dim"), cfg.cdtype),
        "wk": param((d, KH, Dh), ("embed", "kv_heads", "head_dim"),
                    cfg.cdtype),
        "wv": param((d, KH, Dh), ("embed", "kv_heads", "head_dim"),
                    cfg.cdtype),
        "wo": param((H, Dh, d), ("heads", "head_dim", "embed"), cfg.cdtype),
    }


def seq_axis(batch: int) -> str:
    """The cache's sequence axis: a batch under 8 (the batch-1
    long-context cells) shards it over "data" and "model", as the JAX
    package's ``cache_schema`` rules."""
    return "kv_seq_long" if batch < 8 else "kv_seq"


def attn_cache_schema(cfg: ModelConfig, batch: int, max_seq: int):
    KH, Dh = cfg.num_kv_heads, cfg.head_dim
    axes = ("batch", seq_axis(batch), "kv_heads", "head_dim")
    return {
        "k": zeros_param((batch, max_seq, KH, Dh), axes, cfg.cdtype),
        "v": zeros_param((batch, max_seq, KH, Dh), axes, cfg.cdtype),
    }


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap·tanh(scores/cap)`` for a cap above 0, else the scores."""
    if cap > 0:
        return cap * torch.tanh(scores / cap)
    return scores


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, heads, Dh) -> (..., heads, Dh).  On DTensors
    on local shards, the weight kept 3-D as the JAX package contracts
    it: a view of the product would split its last dim into heads where
    DTensor's matmul shards it across a head (kv heads that the rules
    replicate), which torch refuses."""
    def fn(xl, wl):
        d, nh, dh = wl.shape
        return (xl @ wl.reshape(d, nh * dh)).unflatten(-1, (nh, dh))

    return contract(fn, x, w)


def _out(ctx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ctx (..., H, Dh) @ wo (H, Dh, d) -> (..., d); on DTensors on
    local shards (each rank merges its own heads with Dh)."""
    def fn(cl, wl):
        nh, dh, d = wl.shape
        return cl.flatten(-2) @ wl.reshape(nh * dh, d)

    return contract(fn, ctx, w, 2)


def apply_attn_full(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,              # (B, S, d)
    *,
    rope_cs=None,                 # (cos, sin) broadcastable to (B?,S,1,D/2)
    causal: bool = True,
    cache=None,                   # {"k","v"}: (B, Smax, KH, Dh) to fill
):
    """Prefill attention over a full sequence.  When ``cache`` is given,
    this layer's k and v are written to its first S positions."""
    dt = cfg.cdtype
    x = x.to(dt)
    q = _project(x, p["wq"].to(dt))
    kk = _project(x, p["wk"].to(dt))
    vv = _project(x, p["wv"].to(dt))
    q = shard(q, "batch", None, "heads", None)
    if rope_cs is not None:
        cos, sin = rope_cs
        q = apply_rope(q, cos, sin)
        kk = apply_rope(kk, cos, sin)
    out = _attend(q, kk, vv, causal, cfg.attn_logit_softcap)
    y = shard(_out(out, p["wo"].to(dt)), "batch", None, "d_model")
    if cache is not None:
        B, S = x.shape[:2]
        seq = seq_axis(B)
        write_along(cache["k"], shard(kk, "batch", seq, "kv_heads", None),
                    0, 1)
        write_along(cache["v"], shard(vv, "batch", seq, "kv_heads", None),
                    0, 1)
    return y


def _attend(q, k, v, causal: bool, softcap: float):
    """The attention kernel on the model's (B, S, heads, D) tensors, as
    (B, heads, S, D) views, the scores capped by ``softcap``; under
    rules, k and v are placed on their kv heads (the JAX package repeats
    them to H and places them on "heads": the kernel's DTensor branch
    gives each rank the kv heads its q heads use) and the output on
    "heads"."""
    k = shard(k.transpose(1, 2), "batch", "kv_heads", None, None)
    v = shard(v.transpose(1, 2), "batch", "kv_heads", None, None)
    out = attention(q.transpose(1, 2), k, v, causal=causal,
                    softcap=softcap)
    return shard(out, "batch", "heads", None, None).transpose(1, 2)


def _kv_groups(q: torch.Tensor, KH: int) -> torch.Tensor:
    """q (B, H, Dh) as (B, KH, H/KH, Dh), the query heads of each kv
    head together.  A DTensor whose head shards cut a kv head's group
    (KH not divisible by the heads' shard count, as 4 heads over 2 kv
    heads on a 4-way "model" axis) is gathered over its heads first;
    GSPMD reshards the JAX package's reshape the same way."""
    B, H, Dh = q.shape
    if KH % shard_count(q, 1):
        q = replicate_dims(q, 1)
    return q.reshape(B, KH, H // KH, Dh)


def apply_attn_decode(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,              # (B, d) single new token
    cache,                        # {"k","v"}: (B, Smax, KH, Dh), updated
    pos: int,                     # current position
    *,
    rope_cs=None,                 # cos/sin for the single position
):
    dt = cfg.cdtype
    B = x.shape[0]
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = x.to(dt)
    q = _project(x, p["wq"].to(dt))               # (B, H, Dh)
    k_new = _project(x, p["wk"].to(dt))
    v_new = _project(x, p["wv"].to(dt))
    if rope_cs is not None:
        cos, sin = rope_cs                            # (1, 1, D/2)
        q = apply_rope(q[:, None], cos, sin)[:, 0]
        k_new = apply_rope(k_new[:, None], cos, sin)[:, 0]
    k, v = cache["k"], cache["v"]
    write_along(k, k_new[:, None], pos, 1)
    write_along(v, v_new[:, None], pos, 1)
    k = shard(k, "batch", seq_axis(B), "kv_heads", None)
    v = shard(v, "batch", seq_axis(B), "kv_heads", None)
    Smax = k.shape[1]
    # factored GQA decode: q (B, KH, rep, Dh) against the whole cache
    qf = _kv_groups(q, KH)
    scores = torch.einsum(
        "bgrd,bsgd->bgrs", qf.to(torch.float32), k.to(torch.float32)
    ) * (Dh ** -0.5)
    scores = _softcap(scores, cfg.attn_logit_softcap)
    valid = torch.arange(Smax, device=x.device) <= pos
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bgrs,bsgd->bgrd", probs, v).reshape(B, H, Dh)
    return _out(ctx, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_cache_schema(cfg: ModelConfig, batch: int):
    KH, Dh, F = cfg.num_kv_heads, cfg.head_dim, cfg.encoder_frames
    axes = ("batch", "frames", "kv_heads", "head_dim")
    return {
        "k": zeros_param((batch, F, KH, Dh), axes, cfg.cdtype),
        "v": zeros_param((batch, F, KH, Dh), axes, cfg.cdtype),
    }


def cross_kv(cfg: ModelConfig, p, enc_out: torch.Tensor):
    """The cross cache of one layer: enc_out (B, F, d) projected by the
    layer's wk and wv to (B, F, KH, Dh) each."""
    dt = cfg.cdtype
    e = enc_out.to(dt)
    return {"k": _project(e, p["wk"].to(dt)),
            "v": _project(e, p["wv"].to(dt))}


def apply_cross_attn(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,              # (B, S, d) or (B, d)
    kv,                           # cross cache {"k","v"} (B, F, KH, Dh)
):
    dt = cfg.cdtype
    x = x.to(dt)
    q = _project(x, p["wq"].to(dt))
    k, v = kv["k"], kv["v"]
    if x.ndim == 3:                               # prefill: the kernel
        q = shard(q, "batch", None, "heads", None)
        return _out(_attend(q, k, v, False, cfg.attn_logit_softcap),
                    p["wo"].to(dt))
    B, H, Dh = q.shape                            # decode: one query
    KH = k.shape[2]
    qf = _kv_groups(q, KH)
    scores = torch.einsum(
        "bgrd,bfgd->bgrf", qf.to(torch.float32), k.to(torch.float32)
    ) * (Dh ** -0.5)
    scores = _softcap(scores, cfg.attn_logit_softcap)
    probs = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bgrf,bfgd->bgrd", probs, v).reshape(B, H, Dh)
    return _out(ctx, p["wo"].to(dt))
