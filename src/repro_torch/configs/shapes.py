"""Input-shape cells, as the JAX package declares them.

Four shapes per LM arch:
  train_4k     seq 4096   global_batch 256   -> train_step
  prefill_32k  seq 32768  global_batch 32    -> prefill_step
  decode_32k   seq 32768  global_batch 128   -> decode_step (1 new token)
  long_500k    seq 524288 global_batch 1     -> decode_step (sub-quadratic only)

The JAX module's ``ShapeDtypeStruct`` builders (``input_specs``,
``tokens_like``) serve its dry run and have no counterpart here.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# Smoke-scale variants of the same programs (CPU tests).
SMOKE_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 64, 4),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 64, 2),
    "decode_32k": ShapeConfig("decode_32k", "decode", 64, 4),
    "long_500k": ShapeConfig("long_500k", "decode", 128, 1),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k only runs for sub-quadratic (SSM/hybrid) archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "skipped: pure full-attention arch has no sub-quadratic path"
        )
    return True, ""
