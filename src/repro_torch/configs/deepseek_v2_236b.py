"""DeepSeek-V2 236B — MLA kv_lora=512 + 2 shared / 160 routed top-6 MoE
[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2].

Assigned "d_ff=1536" is the routed-expert hidden; the single leading dense
layer uses intermediate 12288.  Optimizer: AdamW with int8-quantized
moments (8-bit Adam) — fp32 m+v would be ~1.9 TiB (DESIGN.md §6).
"""
from repro_torch.configs.base import BlockDef, MLAConfig, ModelConfig, MoEConfig, register

DEEPSEEK_V2_236B = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=12288,
    vocab_size=102400,
    blocks=(
        BlockDef(pattern=(("mla", "dense"),), repeat=1),
        BlockDef(pattern=(("mla", "moe"),), repeat=59),
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160,
        num_shared_experts=2,
        top_k=6,
        d_ff=1536,
        capacity_factor=1.25,
        group_size=8192,
        # EP over "data" with explicit all-to-all dispatch: -74% collective
        # time and -43% compute vs FSDP-regathered experts
        # (EXPERIMENTS.md §Perf hillclimb A)
        ep_over_dp=True,
    ),
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    optimizer="adamw8bit",
    remat="full",
    source="arXiv:2405.04434 (DeepSeek-V2); hf deepseek-ai/DeepSeek-V2",
))
