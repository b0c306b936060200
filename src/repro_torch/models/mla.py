"""Multi-head latent attention (MLA, DeepSeek-V2/V3).

The JAX package's ``models/mla.py``, op for op:

* prefill (``apply_mla_full``) takes the expanded form: q through the
  low-rank ``wq_a`` → ``q_norm`` → ``wq_b`` (or one ``wq``), k and v
  expanded from the normed 512-wide latent ``ckv`` by ``wkv_b``, the
  shared 64-wide rope head ``k_pe`` broadcast over the heads.  q·k runs
  over 128 + 64 = 192 columns and v is 128 wide; they go to the flash
  kernel (``kernels/flash_attention/ops.py``, its (192, 128) pair on the
  card) where the JAX package calls its XLA ``chunked_attention``, with
  v the strided half of the ``wkv_b`` product, as the model computes it.
  The call goes through ``models/attention.py``'s ``attention``, the
  GQA layers' entry, so one hook there sees every flash call.
* decode (``apply_mla_decode``) takes the absorbed form against the
  latent cache: ``q_nope·W_uk`` into the latent, scores over ``ckv`` and
  ``kpe`` in f32, the softmax, ``ctx·W_uv``, a composition of torch ops,
  as the JAX package computes it outside any Pallas kernel.

``q_norm`` and ``kv_norm`` are the plain ``layers.rms_norm`` in both
packages, not the fused residual kernel.  The cache holds ``ckv`` (after
``kv_norm``) and ``kpe`` (after RoPE), (B, Smax, 512) and (B, Smax, 64)
at DeepSeek's widths; prefill writes its first S positions in place and
decode position ``pos`` (``write_along``), as ``models/attention.py``
does with k and v.
Matrices are declared in the compute dtype, the norm scales in the
parameter dtype (``models/model.py``), and each weight is cast to the
compute dtype at its use.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.attention import NEG_INF, _out, _project
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.params import param, scale_param, zeros_param
from repro_torch.sharding.rules import mm, shard, write_along


def mla_schema(cfg: ModelConfig):
    m = cfg.mla
    if m is None:
        raise ValueError(f"{cfg.name}: an mla layer needs cfg.mla")
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    cd = cfg.cdtype
    s = {}
    if m.q_lora_rank:
        s["wq_a"] = param((d, m.q_lora_rank), ("embed", "q_lora"), cd)
        s["q_norm"] = scale_param((m.q_lora_rank,), ("q_lora",), cfg.pdtype)
        s["wq_b"] = param((m.q_lora_rank, H, qk),
                          ("q_lora", "heads", "head_dim"), cd)
    else:
        s["wq"] = param((d, H, qk), ("embed", "heads", "head_dim"), cd)
    s["wkv_a"] = param((d, m.kv_lora_rank + m.qk_rope_head_dim),
                       ("embed", "kv_lora"), cd)
    s["kv_norm"] = scale_param((m.kv_lora_rank,), ("kv_lora",), cfg.pdtype)
    s["wkv_b"] = param((m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim),
                       ("kv_lora", "heads", "head_dim"), cd)
    s["wo"] = param((H, m.v_head_dim, d), ("heads", "head_dim", "embed"), cd)
    return s


def mla_cache_schema(cfg: ModelConfig, batch: int, max_seq: int):
    m = cfg.mla
    seq = attn.seq_axis(batch)
    return {
        "ckv": zeros_param((batch, max_seq, m.kv_lora_rank),
                           ("batch", seq, "kv_lora"), cfg.cdtype),
        "kpe": zeros_param((batch, max_seq, m.qk_rope_head_dim),
                           ("batch", seq, "rope"), cfg.cdtype),
    }


def _project_q(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x (..., d) -> q (..., H, nope + rope)."""
    dt = cfg.cdtype
    if cfg.mla.q_lora_rank:
        qa = rms_norm(mm(x, p["wq_a"].to(dt)), p["q_norm"], cfg.norm_eps)
        return _project(qa, p["wq_b"].to(dt))
    return _project(x, p["wq"].to(dt))


def _latent(cfg: ModelConfig, p, x: torch.Tensor):
    """x (..., d) -> (ckv (..., R) after ``kv_norm``, k_pe (..., rope)
    before RoPE)."""
    R = cfg.mla.kv_lora_rank
    kv_a = mm(x, p["wkv_a"].to(cfg.cdtype))
    return rms_norm(kv_a[..., :R], p["kv_norm"], cfg.norm_eps), kv_a[..., R:]


def apply_mla_full(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,              # (B, S, d)
    *,
    rope_cs,                      # (cos, sin) for positions (S,)
    causal: bool = True,
    cache=None,                   # {"ckv", "kpe"}: (B, Smax, ·) to fill
):
    """Prefill / training MLA over a full sequence, the expanded form.
    When ``cache`` is given, this layer's ``ckv`` and ``kpe`` are written
    to its first S positions."""
    dt = cfg.cdtype
    m = cfg.mla
    nope, H = m.qk_nope_head_dim, cfg.num_heads
    x = x.to(dt)
    q = _project_q(cfg, p, x)                            # (B,S,H,nope+rope)
    ckv, k_pe = _latent(cfg, p, x)                       # (B,S,R), (B,S,rope)
    cos, sin = rope_cs
    q_pe = apply_rope(q[..., nope:], cos, sin)
    k_pe = apply_rope(k_pe[:, :, None], cos, sin)[:, :, 0]
    kv = _project(ckv, p["wkv_b"].to(dt))                # (B,S,H,nope+v)
    q_full = torch.cat([q[..., :nope], q_pe], dim=-1)
    k_full = torch.cat([kv[..., :nope],
                        k_pe[:, :, None].expand(-1, -1, H, -1)], dim=-1)
    # k has H heads (KH = H): it is placed on "heads" with q
    q_full = shard(q_full, "batch", None, "heads", None)
    k_full = shard(k_full, "batch", None, "heads", None)
    out = attn.attention(q_full.transpose(1, 2), k_full.transpose(1, 2),
                         kv[..., nope:].transpose(1, 2),
                         causal=causal).transpose(1, 2)  # (B,S,H,v)
    y = shard(_out(out, p["wo"].to(dt)), "batch", None, "d_model")
    if cache is not None:
        B, S = x.shape[:2]
        seq = attn.seq_axis(B)
        write_along(cache["ckv"], shard(ckv, "batch", seq, None), 0, 1)
        write_along(cache["kpe"], shard(k_pe, "batch", seq, None), 0, 1)
    return y


def apply_mla_decode(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,              # (B, d) single new token
    cache,                        # {"ckv": (B,Smax,R), "kpe": (B,Smax,rope)}
    pos: int,
    *,
    rope_cs,                      # cos/sin for the single position
):
    """One decode step, the absorbed form; the cache is updated in
    place."""
    dt = cfg.cdtype
    m = cfg.mla
    nope = m.qk_nope_head_dim
    x = x.to(dt)
    q = _project_q(cfg, p, x)                            # (B,H,nope+rope)
    cos, sin = rope_cs
    q_pe = apply_rope(q[:, None, :, nope:], cos, sin)[:, 0]
    ckv_new, kpe_new = _latent(cfg, p, x)
    kpe_new = apply_rope(kpe_new[:, None], cos, sin)[:, 0]
    ckv, kpe = cache["ckv"], cache["kpe"]
    write_along(ckv, ckv_new[:, None], pos, 1)
    write_along(kpe, kpe_new[:, None], pos, 1)
    seq = attn.seq_axis(x.shape[0])
    ckv = shard(ckv, "batch", seq, None)
    kpe = shard(kpe, "batch", seq, None)
    # absorbed attention in latent space
    w_uk = p["wkv_b"][..., :nope].to(dt)                 # (R,H,nope)
    w_uv = p["wkv_b"][..., nope:].to(dt)                 # (R,H,v)
    q_lat = torch.einsum("bhn,rhn->bhr", q[..., :nope], w_uk)
    f32 = torch.float32
    scores = (torch.einsum("bhr,bsr->bhs", q_lat.to(f32), ckv.to(f32))
              + torch.einsum("bhk,bsk->bhs", q_pe.to(f32), kpe.to(f32))) \
        * ((nope + m.qk_rope_head_dim) ** -0.5)
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    scores = torch.where(valid[None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)
    ctx_lat = torch.einsum("bhs,bsr->bhr", probs, ckv)   # (B,H,R)
    ctx = torch.einsum("bhr,rhv->bhv", ctx_lat, w_uv)    # (B,H,v)
    return _out(ctx, p["wo"].to(dt))
