"""Input-shape cells, as the JAX package declares them, and their input
builders.

Four shapes per LM arch:
  train_4k     seq 4096   global_batch 256   -> train_step
  prefill_32k  seq 32768  global_batch 32    -> prefill_step
  decode_32k   seq 32768  global_batch 128   -> decode_step (1 new token)
  long_500k    seq 524288 global_batch 1     -> decode_step (sub-quadratic only)

``input_specs`` gives a ``TensorSpec`` (shape, dtype; no data) for every
non-parameter input of a cell, the JAX module's ``ShapeDtypeStruct``s;
the dry run (``launch/dryrun.py``) makes fake tensors of them.
``tokens_like`` makes concrete inputs of the same specs from an
explicit ``torch.Generator``.  Decode's ``pos`` is a scalar int32 spec,
as in the JAX package; the port's decode step takes it as an ``int``.
"""
from __future__ import annotations

import dataclasses

import torch

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


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, no data: the port's
    ``jax.ShapeDtypeStruct``."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``TensorSpec`` stand-ins for every non-param model input (the JAX
    package's, key for key).  The KV/SSM cache of decode comes from the
    model (``models/model.py::cache_schema``)."""
    B, S = shape.global_batch, shape.seq_len
    sds = TensorSpec
    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "embeds":
            specs["embeds"] = sds((B, S, cfg.d_model), torch.bfloat16)
            if shape.kind == "train":
                specs["tokens"] = sds((B, S), torch.int32)  # labels source
        else:
            specs["tokens"] = sds((B, S), torch.int32)
        if shape.kind == "train":
            specs["loss_mask"] = sds((B, S), torch.float32)
        if cfg.rope_type == "mrope":
            specs["positions"] = sds((B, 3, S), torch.int32)
        if cfg.cross_attention:
            specs["enc_embeds"] = sds(
                (B, cfg.encoder_frames, cfg.d_model), torch.bfloat16
            )
    elif shape.kind == "decode":
        specs["token"] = sds((B,), torch.int32)
        specs["pos"] = sds((), torch.int32)
        if cfg.rope_type == "mrope":
            specs["positions"] = sds((B, 3), torch.int32)
    else:
        raise ValueError(shape.kind)
    return specs


def tokens_like(spec_tree: dict, gen: torch.Generator | None = None,
                device=None) -> dict:
    """Concrete inputs matching ``input_specs`` (smoke tests), drawn from
    ``gen`` (default: a CPU generator seeded 0) on ``device`` (default:
    ``gen``'s): integers in [0, 17), a scalar 3, normals cast to the
    spec's dtype, ``loss_mask`` ones."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    device = gen.device if device is None else device

    def mk(s: TensorSpec) -> torch.Tensor:
        if not s.dtype.is_floating_point:
            if s.shape == ():
                return torch.tensor(3, dtype=s.dtype, device=device)
            return torch.randint(0, 17, s.shape, generator=gen,
                                 device=gen.device).to(device, s.dtype)
        return torch.randn(s.shape, generator=gen, device=gen.device,
                           dtype=torch.float32).to(device, s.dtype)

    return {k: torch.ones(v.shape, dtype=v.dtype, device=device)
            if k == "loss_mask" else mk(v) for k, v in spec_tree.items()}
