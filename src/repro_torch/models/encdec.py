"""Whisper-style encoder (the conv frontend stubbed to frame embeddings).

The JAX package's ``models/encdec.py``: the frame embeddings plus the
sinusoidal table, ``encoder_layers`` non-causal (attention, dense MLP)
layers, then the final norm.  The layers are the decoder's
(``models/transformer.py``): their self-attention runs the flash kernel
over all frames, not causally, and their residual → norm seams follow
the config's norm (whisper's layernorm in plain torch ops).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.models.layers import norm_schema, sinusoidal_positions
from repro_torch.models.transformer import (
    apply_block_full,
    block_schema,
    fused_norm,
)


def _encoder_block(cfg: ModelConfig) -> BlockDef:
    return BlockDef(pattern=(("attn", "dense"),), repeat=cfg.encoder_layers)


def encoder_schema(cfg: ModelConfig):
    return {
        "blocks": block_schema(cfg, _encoder_block(cfg)),
        "final_norm": norm_schema(cfg),
    }


def apply_encoder(cfg: ModelConfig, p, enc_embeds: torch.Tensor, *,
                  remat: str | None = "none") -> torch.Tensor:
    """enc_embeds (B, F, d) stub frame embeddings -> encoder states
    (B, F, d) in the compute dtype.  ``remat`` as ``apply_block_full``
    takes it (``None``: the config's, as the JAX package's encoder
    uses)."""
    F = enc_embeds.shape[1]
    x = enc_embeds.to(cfg.cdtype)
    x = x + sinusoidal_positions(F, cfg.d_model, x.device).to(cfg.cdtype)
    x, res, _ = apply_block_full(
        cfg, _encoder_block(cfg), p["blocks"], x, torch.zeros_like(x),
        rope_cs=None, causal=False, remat=remat,
    )
    h, _ = fused_norm(cfg, p["final_norm"], x, res)
    return h
