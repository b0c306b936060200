"""Public model API of the port: schema, training loss, prefill and
decode for every architecture the JAX package registers — the dense GQA
decoders, the Mamba-2 (SSD) stack, the hybrid of attention, Mamba-2 and
mixture-of-experts layers (Jamba), DeepSeek's multi-head latent
attention over mixture-of-experts layers, with V3's
multi-token-prediction (MTP) head in the training loss, Qwen2-VL's
backbone (patch-embedding inputs, M-RoPE positions) and whisper's
encoder-decoder (frame embeddings, sinusoidal positions, layernorm,
cross-attention).

The JAX package's ``models/model.py``, as plain functions on a parameter
dict laid out as the JAX pytree.  prefill and the training forward run
the flash-attention kernel once per attention or MLA layer (and once
per encoder layer and per cross-attention layer), the SSD chunk kernel
once per mamba layer and, under RMSNorm, the fused residual-norm kernel
at every seam (``launches_per_pass``); a decode step runs the norm
kernel as often, and attention (MLA's absorbed form and the
cross-attention too) and the O(1) state update as torch ops.  Layernorm
has no kernel, as in the JAX package.  Serving never runs the MTP head,
as in the JAX package.

Serving's ``schema`` declares matrices and embeddings in the compute
dtype, norm scales in the parameter dtype.  ``train_schema`` is the JAX
package's: every leaf in the parameter dtype (the f32 master leaves
AdamW updates) but a pinned one, the MoE router, which is f32 in both
schemas as in the JAX package.  Every use casts its weight to the
compute dtype (``w.astype(dt)`` in the JAX package), a no-op on
serving's leaves, so the values the matmuls see are the same under both
schemas.

Inputs beside the tokens, as the JAX package takes them: ``embeds``
(B, S, d) in place of the token embeddings (``input_mode="embeds"``),
``positions`` (B, 3, S) in prefill and (B, 3) in decode for M-RoPE, and
``enc_embeds`` (B, frames, d) for the encoder.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec
from repro_torch.models.layers import (
    embed_schema,
    embed_tokens,
    mrope_cos_sin,
    norm_schema,
    rope_cos_sin,
    sinusoidal_positions,
    unembed,
)
from repro_torch.models.params import (
    count_params,
    map_specs,
    param,
    tree_leaves,
)
from repro_torch.models.transformer import (
    apply_block_decode,
    apply_block_full,
    apply_layer_full,
    block_cache_schema,
    block_schema,
    fused_norm,
    layer_schema,
)
from repro_torch.sharding.rules import (
    current_rules,
    mm,
    replicate_dims,
    shard,
    zeros_placed,
)


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------


def _mtp_mixer(cfg: ModelConfig) -> str:
    return "mla" if cfg.mla is not None else "attn"


def schema(cfg: ModelConfig):
    s: dict[str, Any] = dict(embed_schema(cfg))
    for i, bdef in enumerate(cfg.blocks):
        s[f"b{i}"] = block_schema(cfg, bdef, cross=cfg.cross_attention)
    s["final_norm"] = norm_schema(cfg)
    if cfg.encoder_layers:
        s["encoder"] = encdec.encoder_schema(cfg)
    if cfg.mtp:
        s["mtp"] = {
            "norm_h": norm_schema(cfg),
            "norm_e": norm_schema(cfg),
            "proj": param((2 * cfg.d_model, cfg.d_model), (None, "d_model"),
                          cfg.cdtype),
            "layer": layer_schema(cfg, _mtp_mixer(cfg), "dense"),
            "final_norm": norm_schema(cfg),
        }
    return s


def train_schema(cfg: ModelConfig):
    """The JAX package's ``schema``: serving's shapes and inits, every
    leaf in ``cfg.pdtype`` but the pinned ones (the MoE router's f32)."""
    return map_specs(lambda _, s: s if s.pinned else dataclasses.replace(
        s, dtype=cfg.pdtype), schema(cfg))


def cache_schema(cfg: ModelConfig, batch: int, max_seq: int):
    """Each layer's decode cache (``max_seq`` positions) and, with
    cross-attention, its cross cache (``encoder_frames`` positions)."""
    return {
        f"b{i}": block_cache_schema(cfg, bdef, batch, max_seq,
                                    cross=cfg.cross_attention)
        for i, bdef in enumerate(cfg.blocks)
    }


def param_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameter counts: a MoE layer's active count has
    ``top_k`` of its experts (the JAX package's rule)."""
    total = count_params(schema(cfg))
    active = total
    if cfg.moe is not None:
        m = cfg.moe
        n_moe_layers = sum(
            b.repeat * sum(1 for _, mlp in b.pattern if mlp == "moe")
            for b in cfg.blocks
        )
        per_expert = 3 * cfg.d_model * m.d_ff
        active -= n_moe_layers * per_expert * (m.num_experts - m.top_k)
    return total, active


def _layer_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    return [kind for b in cfg.blocks for _ in range(b.repeat)
            for kind in b.pattern]


def launches_per_pass(cfg: ModelConfig, phase: str,
                      remat: str = "none") -> dict[str, int]:
    """Kernel launches of one prefill, one decode step or one training
    forward and backward of a (micro)batch, counted from the layer
    pattern, for the kernels the config's layers run: under RMSNorm the
    fused residual-norm at every seam (``norm1``, ``norm_x`` where the
    layer has cross-attention, ``norm2`` where it has an MLP, dense or
    MoE, whatever its mixer, and the final norm; the encoder's layers
    and final norm in prefill and training) in every phase, under
    layernorm none (no kernel); in prefill and training, flash attention
    once per attention or MLA layer, once per cross-attention layer and
    once per encoder layer, and the SSD chunk kernel once per mamba
    layer (decode runs neither).  In training the backward runs the
    plain versions, and under a ``remat`` other than ``none`` it
    recomputes each layer's forward, kernels included: every layer's
    launches twice, the final norm's once; the encoder's layers follow
    the config's remat, as the JAX package's encoder does.  Training
    with the MTP head adds its layer (one flash, two norms; never
    rematerialised, as in the JAX package) and its three norms
    (``norm_h``, ``norm_e``, ``final_norm``)."""
    if phase not in ("prefill", "decode", "train"):
        raise ValueError(f"phase {phase!r}")
    kinds = _layer_kinds(cfg)
    rep = 2 if phase == "train" and remat != "none" else 1
    enc = cfg.encoder_layers if phase != "decode" else 0
    enc_rep = 2 if phase == "train" and cfg.remat != "none" else 1
    cross = int(cfg.cross_attention)
    out = {}
    mtp = phase == "train" and cfg.mtp
    n_attn = sum(mixer in ("attn", "mla") for mixer, _ in kinds)
    n_mamba = sum(mixer == "mamba" for mixer, _ in kinds)
    if n_attn:
        out["flash_attention"] = rep * n_attn * (1 + cross) + mtp \
            + enc_rep * enc if phase != "decode" else 0
    norms = rep * sum(1 + cross + (mlp != "none") for _, mlp in kinds) \
        + 1 + 5 * mtp + (enc_rep * 2 * enc + 1 if enc else 0)
    out["rmsnorm_residual"] = norms if cfg.norm == "rmsnorm" else 0
    if n_mamba:
        out["ssd_chunk"] = rep * n_mamba if phase != "decode" else 0
    return out


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _rope_dim(cfg: ModelConfig) -> int:
    """The rotated width: MLA's rope head, else the head dim."""
    if cfg.mla is not None:
        return cfg.mla.qk_rope_head_dim
    return cfg.head_dim


def _mrope_positions(cfg: ModelConfig, positions):
    if positions is None:
        raise ValueError(f"{cfg.name}: M-RoPE needs the inputs' "
                         f"'positions'")
    return positions


def rope_full(cfg: ModelConfig, S: int, device, positions=None):
    """cos/sin for a full sequence, shaped to broadcast with (B,S,H,D);
    M-RoPE takes ``positions`` (B, 3, S), plain RoPE an (S,)
    ``positions`` where one is given (``arange(S)`` otherwise), as the
    JAX package does."""
    if cfg.rope_type == "none":
        return None
    if cfg.rope_type == "mrope":
        cos, sin = mrope_cos_sin(_mrope_positions(cfg, positions),
                                 _rope_dim(cfg), cfg.rope_theta,
                                 cfg.mrope_sections)         # (B,S,D2)
        return cos[:, :, None, :], sin[:, :, None, :]
    pos = torch.arange(S, device=device) if positions is None else positions
    cos, sin = rope_cos_sin(pos, _rope_dim(cfg), cfg.rope_theta)  # (S,D2)
    return cos[None, :, None, :], sin[None, :, None, :]


def rope_decode(cfg: ModelConfig, pos: int, device, positions=None):
    """cos/sin for one position; M-RoPE takes ``positions`` (B, 3)."""
    if cfg.rope_type == "none":
        return None
    if cfg.rope_type == "mrope":
        cos, sin = mrope_cos_sin(_mrope_positions(cfg, positions)[:, :, None],
                                 _rope_dim(cfg), cfg.rope_theta,
                                 cfg.mrope_sections)         # (B,1,D2)
        return cos[:, :, None, :], sin[:, :, None, :]        # (B,1,1,D2)
    # arange, not tensor([pos]): a host-to-device copy would wait for the
    # card at every step
    cos, sin = rope_cos_sin(torch.arange(pos, pos + 1, device=device),
                            _rope_dim(cfg), cfg.rope_theta)  # (1,D2)
    return cos[None], sin[None]                              # (1,1,D2)


def _inputs_to_x(cfg: ModelConfig, params, inputs, S: int):
    """The stream's first value: the inputs' ``embeds`` (embeds mode) or
    the token embeddings, plus the sinusoidal table's first S rows where
    the config has absolute positions."""
    if cfg.input_mode == "embeds" and "embeds" in inputs:
        x = inputs["embeds"].to(cfg.cdtype)
    else:
        x = embed_tokens(cfg, params, inputs["tokens"])
    if cfg.pos_embed == "sinusoidal":
        x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(cfg.cdtype)
    return shard(x, "batch", "seq_res", "d_model")


def _encode(cfg: ModelConfig, params, inputs, remat="none"):
    """The encoder's output for the inputs' ``enc_embeds``, or None for a
    config without cross-attention."""
    if not cfg.cross_attention:
        return None
    return encdec.apply_encoder(cfg, params["encoder"],
                                inputs["enc_embeds"], remat=remat)


def backbone_full(cfg: ModelConfig, params, x, *, rope_cs,
                  remat: str | None = None, enc_out=None):
    """The training forward of every block, no cache: x (B,S,d) ->
    (x, res, aux), the stream, the last layer's output, which the final
    fused norm adds, and the sum of the MoE layers' aux terms (0.0
    without MoE); cross-attention layers attend to ``enc_out``."""
    res = torch.zeros_like(x)
    aux = 0.0
    for i, bdef in enumerate(cfg.blocks):
        x, res, aux = apply_block_full(
            cfg, bdef, params[f"b{i}"], x, res, aux, rope_cs=rope_cs,
            causal=True, remat=remat, enc_out=enc_out,
        )
    return x, res, aux


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def chunked_xent(cfg: ModelConfig, params, h: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor,
                 loss_chunk: int = 512):
    """Memory-bounded cross-entropy: a loop over sequence chunks, so the
    (B, chunk, V) f32 logits are the largest ever held, never (B, S, V).
    Returns (sum_nll, sum_mask)."""
    B, S, _ = h.shape

    def piece(h_c, lab_c, m_c):
        logits = unembed(cfg, params, h_c)                   # (B,c,V) f32
        logits = shard(logits, "batch", None, "vocab")
        lse = torch.logsumexp(logits, dim=-1)
        # the label's logit is gathered from the whole vocab row: a
        # vocab-sharded gather has no working DTensor strategy
        lab = torch.gather(replicate_dims(logits, -1), -1,
                           lab_c[..., None].long())[..., 0]
        return torch.sum((lse - lab) * m_c), torch.sum(m_c)

    if S <= loss_chunk:
        return piece(h, labels, mask)
    if S % loss_chunk:
        raise ValueError(f"sequence {S} is not a multiple of loss_chunk "
                         f"{loss_chunk}")
    nll = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, loss_chunk):
        sl = slice(c, c + loss_chunk)
        n, m = piece(shard(h[:, sl], "batch", None, None),
                     shard(labels[:, sl], "batch", None),
                     shard(mask[:, sl], "batch", None))
        nll, cnt = nll + n, cnt + m
    return nll, cnt


def _shift_left(x: torch.Tensor, n: int = 1) -> torch.Tensor:
    """x[:, n:] padded with n zeros at the end of axis 1."""
    return torch.cat([x[:, n:], torch.zeros_like(x[:, :n])], dim=1)


def loss_fn(cfg: ModelConfig, params, batch, *, loss_chunk: int = 512,
            remat: str | None = None):
    """Next-token cross-entropy of ``batch`` ({"tokens": (B,S) int,
    optional "loss_mask": (B,S) f32, and the config's other inputs:
    "embeds", "positions", "enc_embeds"}), normalised by its token
    count.
    Returns (loss, metrics) with the JAX package's keys: ``loss``,
    ``nll_sum``, ``token_count``, ``aux_loss`` and, with the MTP head,
    ``mtp_loss``; ``loss`` is the mean next-token NLL plus ``aux_loss``,
    the MoE layers' load-balance and z terms (0 without MoE), plus
    ``mtp_weight`` times the MTP head's mean NLL of the token after
    next.  The head is the JAX package's: the final-normed stream and
    the next token's embedding, each normed, concatenated and projected,
    one dense layer of the model's mixer, its final norm, and the shared
    unembedding; its norms run on the fused kernel with a zero residual,
    as layer 0's ``norm1`` does.  The encoder runs under the config's
    remat, as the JAX package's does."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    x = _inputs_to_x(cfg, params, batch, S)
    rope_cs = rope_full(cfg, S, tokens.device, batch.get("positions"))
    enc_out = _encode(cfg, params, batch, remat=None)
    x, res, aux = backbone_full(cfg, params, x, rope_cs=rope_cs,
                                remat=remat, enc_out=enc_out)
    h, _ = fused_norm(cfg, params["final_norm"], x, res)
    nll, cnt = chunked_xent(cfg, params, h, _shift_left(tokens),
                            _shift_left(mask), loss_chunk)
    # lint: disable=host-sync -- a real sync, kept: without MoE layers aux
    # is a host 0.0 copied to the card once a loss (ROADMAP, Host-bound
    # paths); with them it is a tensor already and nothing is copied
    aux = torch.as_tensor(aux, dtype=torch.float32, device=tokens.device)
    loss = nll / torch.clamp(cnt, min=1.0) + aux
    metrics = {"nll_sum": nll.detach(), "token_count": cnt.detach(),
               "aux_loss": aux.detach()}
    if cfg.mtp:
        mtp_loss = _mtp_loss(cfg, params, h, tokens, mask, rope_cs,
                             loss_chunk)
        metrics["mtp_loss"] = mtp_loss.detach()
        loss = loss + cfg.mtp_weight * mtp_loss
    metrics["loss"] = loss.detach()
    return loss, metrics


def _mtp_loss(cfg: ModelConfig, params, h, tokens, mask, rope_cs,
              loss_chunk):
    """The MTP head's mean NLL of the token two ahead, from the model's
    final-normed stream ``h`` (B, S, d)."""
    mp = params["mtp"]
    zeros = torch.zeros_like(h)
    e_next = embed_tokens(cfg, params, _shift_left(tokens))
    hn, _ = fused_norm(cfg, mp["norm_h"], h, zeros)
    en, _ = fused_norm(cfg, mp["norm_e"], e_next, zeros)
    x = mm(torch.cat([hn, en], dim=-1), mp["proj"].to(cfg.cdtype))
    x, y, _ = apply_layer_full(cfg, mp["layer"], x, torch.zeros_like(x),
                               _mtp_mixer(cfg), "dense", rope_cs=rope_cs)
    h_mtp, _ = fused_norm(cfg, mp["final_norm"], x, y)
    nll, cnt = chunked_xent(cfg, params, h_mtp, _shift_left(tokens, 2),
                            _shift_left(mask, 2), loss_chunk)
    return nll / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, inputs, max_seq: int | None = None):
    """inputs: {"tokens": (B, S) int} or {"embeds": (B, S, d)} (embeds
    mode), with "positions" (B, 3, S) for M-RoPE and "enc_embeds" (B,
    frames, d) for the encoder.  Returns (last_token_logits (B,V) fp32,
    cache).  The cache is allocated at ``max_seq`` positions (default S)
    and zero past S, the layout the JAX package's ``pad_cache_to``
    produces; the cross cache holds every frame.  Under rules bound to
    a device mesh the cache is allocated as DTensors at their serving
    placements (``runtime/serve_step.py::cache_shardings``)."""
    if cfg.input_mode == "embeds" and "embeds" in inputs:
        B, S = inputs["embeds"].shape[:2]
        dev = inputs["embeds"].device
    else:
        B, S = inputs["tokens"].shape
        dev = inputs["tokens"].device
    max_seq = S if max_seq is None else max_seq
    if max_seq < S:
        raise ValueError(f"max_seq {max_seq} < prompt length {S}")
    x = _inputs_to_x(cfg, params, inputs, S)
    rope_cs = rope_full(cfg, S, dev, inputs.get("positions"))
    enc_out = _encode(cfg, params, inputs)
    cache = zeros_placed(cache_schema(cfg, B, max_seq), current_rules(),
                         dev)
    res = torch.zeros_like(x)
    for i, bdef in enumerate(cfg.blocks):
        x, res, _ = apply_block_full(
            cfg, bdef, params[f"b{i}"], x, res, rope_cs=rope_cs,
            causal=True, cache=cache[f"b{i}"], enc_out=enc_out,
        )
    h_last, _ = fused_norm(cfg, params["final_norm"], x[:, -1], res[:, -1])
    return unembed(cfg, params, h_last), cache


def _cache_max_seq(cache) -> int:
    """The JAX package's rule: the longest axis 2 of the first block's
    cache leaves of three or more axes (its table's row ``pos`` does not
    depend on the length)."""
    return max(t.shape[2] for t in tree_leaves(cache["b0"]) if t.ndim >= 3)


def decode_step(cfg: ModelConfig, params, cache, inputs):
    """inputs: {"token": (B,) int, "pos": int}, with "positions" (B, 3)
    for M-RoPE.  Returns (logits (B,V) fp32, cache); the cache is
    updated in place and returned."""
    # lint: disable=host-sync -- "pos" is a Python int by contract
    # (launch/serve.py passes P + i): int() of it copies nothing
    token, pos = inputs["token"], int(inputs["pos"])
    x = embed_tokens(cfg, params, token)
    if cfg.pos_embed == "sinusoidal":
        table = sinusoidal_positions(_cache_max_seq(cache), cfg.d_model,
                                     token.device)
        x = x + table[pos].to(cfg.cdtype)
    rope_cs = rope_decode(cfg, pos, token.device, inputs.get("positions"))
    res = torch.zeros_like(x)
    for i, bdef in enumerate(cfg.blocks):
        x, res = apply_block_decode(
            cfg, bdef, params[f"b{i}"], x, res, cache[f"b{i}"], pos,
            rope_cs=rope_cs,
        )
    h, _ = fused_norm(cfg, params["final_norm"], x, res)
    return unembed(cfg, params, h), cache
