"""NVIDIA Minitron-8B — pruned+distilled Nemotron-4 [arXiv:2407.14679; hf].

Nemotron uses squared-ReLU MLP (no gate); kept here via mlp_act="relu2".
vocab 256000 with a 256k sentencepiece tokenizer — the embedding table is
the dominant non-layer tensor and is vocab-sharded on "model".
"""
from repro_torch.configs.base import ModelConfig, dense_blocks, register

MINITRON_8B = register(ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    blocks=dense_blocks(32),
    rope_theta=10_000.0,
    mlp_act="relu2",
    param_dtype="float32",
    optimizer="adamw",
    remat="full",
    source="arXiv:2407.14679 (Minitron); hf nvidia/Minitron-8B-Base",
))
