"""Architecture registry of the port.

Every architecture the JAX package registers: the dense GQA decoders
Yi-6B, Yi-9B, Granite-8B and Minitron-8B (squared-ReLU MLP),
mamba2-370m, the pure Mamba-2 (SSD) stack, Jamba-v0.1, the hybrid of
attention, Mamba-2 and mixture-of-experts layers, DeepSeek-V2 and -V3,
multi-head latent attention (MLA) over mixture-of-experts layers, V3
with its multi-token-prediction (MTP) head, Qwen2-VL-72B's backbone
(M-RoPE over patch-embedding inputs) and whisper-large-v3 (an encoder,
cross-attention, layernorm, sinusoidal positions).  Each module is the
JAX package's ``repro/configs/`` file with only its imports changed.
``get_config("<id>")`` resolves one;
``smoke_config(cfg)`` shrinks it for CPU tests.
"""
from repro_torch.configs.base import (
    REGISTRY,
    BlockDef,
    ModelConfig,
    RunConfig,
    dense_blocks,
    get_config,
    register,
)
from repro_torch.configs.deepseek_v2_236b import DEEPSEEK_V2_236B
from repro_torch.configs.deepseek_v3_671b import DEEPSEEK_V3_671B
from repro_torch.configs.granite_8b import GRANITE_8B
from repro_torch.configs.jamba_v0_1_52b import JAMBA_V01_52B
from repro_torch.configs.mamba2_370m import MAMBA2_370M
from repro_torch.configs.minitron_8b import MINITRON_8B
from repro_torch.configs.qwen2_vl_72b import QWEN2_VL_72B
from repro_torch.configs.smoke import smoke_config
from repro_torch.configs.whisper_large_v3 import WHISPER_LARGE_V3
from repro_torch.configs.yi_6b import YI_6B
from repro_torch.configs.yi_9b import YI_9B

ALL_ARCHS = ["granite-8b", "yi-6b", "yi-9b", "minitron-8b",
             "deepseek-v3-671b", "deepseek-v2-236b", "qwen2-vl-72b",
             "whisper-large-v3", "mamba2-370m", "jamba-v0.1-52b"]

__all__ = [
    "ALL_ARCHS",
    "BlockDef",
    "DEEPSEEK_V2_236B",
    "DEEPSEEK_V3_671B",
    "GRANITE_8B",
    "JAMBA_V01_52B",
    "MAMBA2_370M",
    "MINITRON_8B",
    "ModelConfig",
    "QWEN2_VL_72B",
    "REGISTRY",
    "RunConfig",
    "WHISPER_LARGE_V3",
    "YI_6B",
    "YI_9B",
    "dense_blocks",
    "get_config",
    "register",
    "smoke_config",
]
