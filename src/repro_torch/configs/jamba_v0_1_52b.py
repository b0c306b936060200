"""Jamba-v0.1 52B — Mamba+attention 1:7 interleave with 16-expert top-2 MoE
[arXiv:2403.19887; hf ai21labs/Jamba-v0.1].

Period-8 block: attention at in-period index 4, Mamba elsewhere (a=1, l=8);
MoE replaces the MLP at every other layer (e=2, odd offsets).  Jamba's
mixer is Mamba-1 (d_state=16, conv 4, expand 2); we adapt it to the
Mamba-2/SSD formulation (TPU-native chunked scan, same state size) —
recorded as a hardware-adaptation change in DESIGN.md.  Hybrid ->
subquadratic=True: the long_500k cell runs with the 4 attention layers'
KV cache sequence-sharded.
"""
from repro_torch.configs.base import BlockDef, ModelConfig, MoEConfig, SSMConfig, register

_PERIOD = tuple(
    ("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

JAMBA_V01_52B = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    blocks=(BlockDef(pattern=_PERIOD, repeat=4),),
    moe=MoEConfig(
        num_experts=16,
        num_shared_experts=0,
        top_k=2,
        d_ff=14336,
        capacity_factor=1.25,
        group_size=4096,
    ),
    ssm=SSMConfig(
        d_state=16,
        d_conv=4,
        expand=2,
        head_dim=64,
        n_groups=1,
        chunk=256,
    ),
    rope_type="none",       # Jamba uses no positional encoding
    pos_embed="none",
    subquadratic=True,
    param_dtype="bfloat16",
    optimizer="adamw",
    remat="full",
    source="arXiv:2403.19887 (Jamba); hf ai21labs/Jamba-v0.1",
))
