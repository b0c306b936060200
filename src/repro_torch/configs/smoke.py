"""Reduced same-family configs for CPU smoke tests.

Shrinks width/depth/experts/vocab while keeping the exact layer pattern
— field for field the JAX package's ``smoke_config``, so both packages
shrink an architecture to the same config.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    BlockDef,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    blocks = tuple(
        BlockDef(pattern=b.pattern, repeat=min(b.repeat, 1)) for b in cfg.blocks
    )
    layers = sum(b.layers for b in blocks)
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(
            num_experts=8,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            top_k=min(cfg.moe.top_k, 2),
            d_ff=64,
            capacity_factor=4.0,
            group_size=16,
            dispatch=cfg.moe.dispatch,
            ep_over_dp=cfg.moe.ep_over_dp,
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = SSMConfig(
            d_state=16,
            d_conv=cfg.ssm.d_conv,
            expand=2,
            head_dim=16,
            n_groups=cfg.ssm.n_groups,
            chunk=16,
        )
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(
            q_lora_rank=32 if cfg.mla.q_lora_rank else 0,
            kv_lora_rank=32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=128,
        blocks=blocks,
        moe=moe,
        ssm=ssm,
        mla=mla,
        mrope_sections=(2, 3, 3) if cfg.rope_type == "mrope"
        else cfg.mrope_sections,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_frames=16 if cfg.encoder_layers else cfg.encoder_frames,
        query_chunk=16,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    ).validate()
