"""Architecture registry of the port.

Only the architectures the port can serve are registered: Yi-6B, the
dense GQA decoder, and mamba2-370m, the pure Mamba-2 (SSD) stack.
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
from repro_torch.configs.mamba2_370m import MAMBA2_370M
from repro_torch.configs.smoke import smoke_config
from repro_torch.configs.yi_6b import YI_6B

ALL_ARCHS = ["yi-6b", "mamba2-370m"]

__all__ = [
    "ALL_ARCHS",
    "BlockDef",
    "MAMBA2_370M",
    "ModelConfig",
    "REGISTRY",
    "RunConfig",
    "YI_6B",
    "dense_blocks",
    "get_config",
    "register",
    "smoke_config",
]
