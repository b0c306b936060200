"""IBM Granite-8B (code) — llama-arch dense GQA [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ModelConfig, dense_blocks, register

GRANITE_8B = register(ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    blocks=dense_blocks(36),
    rope_theta=10_000_000.0,
    tie_embeddings=False,
    param_dtype="float32",
    optimizer="adamw",
    remat="full",
    source="arXiv:2405.04324 (Granite Code Models); hf ibm-granite/granite-8b-code-base",
))
