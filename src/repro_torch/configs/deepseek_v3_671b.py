"""DeepSeek-V3 671B — MLA + 1 shared / 256 routed top-8 MoE + MTP
[arXiv:2412.19437; hf deepseek-ai/DeepSeek-V3].

Assigned line "d_ff=2048" is the routed-expert hidden (hf
moe_intermediate_size); the first 3 dense layers use intermediate 18432
(hf intermediate_size).  MLA: q_lora 1536, kv_lora 512, rope head 64.
Optimizer: Adafactor — AdamW fp32 moments would need ~9.4 TiB of state,
exceeding a 256-chip v5e pod (DESIGN.md §6).
"""
from repro_torch.configs.base import BlockDef, MLAConfig, ModelConfig, MoEConfig, register

DEEPSEEK_V3_671B = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,
    vocab_size=129280,
    blocks=(
        BlockDef(pattern=(("mla", "dense"),), repeat=3),
        BlockDef(pattern=(("mla", "moe"),), repeat=58),
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        num_shared_experts=1,
        top_k=8,
        d_ff=2048,
        capacity_factor=1.25,
        group_size=8192,
        # EP over "data" with explicit all-to-all dispatch: -74% collective
        # time and -43% compute vs FSDP-regathered experts
        # (EXPERIMENTS.md §Perf hillclimb A)
        ep_over_dp=True,
    ),
    rope_theta=10_000.0,
    mtp=True,
    param_dtype="bfloat16",
    optimizer="adafactor",
    remat="full",
    source="arXiv:2412.19437 (DeepSeek-V3); hf deepseek-ai/DeepSeek-V3",
))
