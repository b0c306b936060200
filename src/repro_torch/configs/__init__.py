"""Architecture registry of the port.

Only the architectures the port can serve are registered: Yi-6B, the
dense GQA decoder.  ``get_config("<id>")`` resolves one;
``smoke_config(cfg)`` shrinks it for CPU tests.
"""
from repro_torch.configs.base import (
    REGISTRY,
    BlockDef,
    ModelConfig,
    dense_blocks,
    get_config,
    register,
)
from repro_torch.configs.smoke import smoke_config
from repro_torch.configs.yi_6b import YI_6B

ALL_ARCHS = ["yi-6b"]

__all__ = [
    "ALL_ARCHS",
    "BlockDef",
    "ModelConfig",
    "REGISTRY",
    "YI_6B",
    "dense_blocks",
    "get_config",
    "register",
    "smoke_config",
]
