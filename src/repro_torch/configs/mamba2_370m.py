"""Mamba2-370M — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified tier].

Field for field the JAX package's ``configs/mamba2_370m.py``: 48 layers
of pure Mamba-2 mixers (d_ff=0: the mixer's expand-2 projection is the
FFN), d_inner 2048, head_dim 64 -> 32 SSD heads, d_state 128, one group,
chunk 256; the chunked SSD for prefill, the O(1) recurrent state for
decode.
"""
from repro_torch.configs.base import BlockDef, ModelConfig, SSMConfig, register

MAMBA2_370M = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    blocks=(BlockDef(pattern=(("mamba", "none"),), repeat=48),),
    ssm=SSMConfig(
        d_state=128,
        d_conv=4,
        expand=2,
        head_dim=64,
        n_groups=1,
        chunk=256,
    ),
    rope_type="none",
    pos_embed="none",
    tie_embeddings=True,
    subquadratic=True,
    param_dtype="float32",
    optimizer="adamw",
    remat="full",
    source="arXiv:2405.21060 (Mamba-2/SSD); "
           "state-spaces/mamba2-370m [unverified]",
))
