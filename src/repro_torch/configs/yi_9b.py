"""01.AI Yi-9B — depth-upscaled Yi-6B, 48L [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ModelConfig, dense_blocks, register

YI_9B = register(ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    blocks=dense_blocks(48),
    rope_theta=10_000.0,
    param_dtype="float32",
    optimizer="adamw",
    remat="full",
    source="arXiv:2403.04652 (Yi); hf 01-ai/Yi-9B",
))
