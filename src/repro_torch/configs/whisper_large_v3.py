"""Whisper-large-v3 — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356; unverified tier].

Assigned "32L" = 32 decoder layers; the symmetric 32-layer encoder is also
modeled (true whisper-large shape).  The log-mel + conv frontend is a STUB:
input_specs() provides precomputed frame embeddings (batch, 1500, d_model).
Whisper uses absolute sinusoidal positions (pos_embed="sinusoidal"), MHA
(kv=20 == heads), head_dim 64.  Decoder-only shapes (prefill/decode) attach
a cross-attention cache computed once from the encoder output.
"""
from repro_torch.configs.base import BlockDef, ModelConfig, register

WHISPER_LARGE_V3 = register(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    blocks=(BlockDef(pattern=(("attn", "dense"),), repeat=32),),
    encoder_layers=32,
    encoder_frames=1500,
    cross_attention=True,
    pos_embed="sinusoidal",
    rope_type="none",
    mlp_act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    param_dtype="float32",
    optimizer="adamw",
    remat="full",  # "dots" saves unsharded score chunks: 84 GiB at multi
    # 20 heads cannot shard on a 16-way model axis: TP would replicate
    # attention on every model rank (16x). A 1.5B model on 256 chips is
    # best run fully data-parallel (EXPERIMENTS.md §Perf, hillclimb B:
    # step bound 24.9s -> 1.8s).
    flat_dp=True,
    source="arXiv:2212.04356 (Whisper); openai/whisper-large-v3 [unverified]",
))
