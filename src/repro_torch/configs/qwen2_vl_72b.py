"""Qwen2-VL-72B backbone — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

VLM: only the transformer BACKBONE is modeled; the vision frontend is a
STUB — input_specs() provides precomputed patch embeddings merged into the
token stream (input_mode="embeds") plus 3-D M-RoPE position ids
(temporal/height/width sections of the rotary dim).
"""
from repro_torch.configs.base import ModelConfig, dense_blocks, register

QWEN2_VL_72B = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    blocks=dense_blocks(80),
    rope_theta=1_000_000.0,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),
    input_mode="embeds",
    param_dtype="bfloat16",
    optimizer="adamw",
    remat="full",
    source="arXiv:2409.12191 (Qwen2-VL); hf Qwen/Qwen2-VL-72B",
))
