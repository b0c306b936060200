"""Model configuration dataclasses, as the JAX package declares them.

One ``ModelConfig`` describes an architecture and ``RunConfig`` the
runtime knobs of a training cell.  The fields and their
defaults are the JAX package's (``repro/configs/base.py``), so a config
reads the same in both packages; only ``pdtype`` / ``cdtype`` map the
dtype strings to ``torch`` dtypes here.  ``MoEConfig``, ``SSMConfig``
and ``MLAConfig`` are plain copies; the port's model serves all three
(Mamba-2, mixture-of-experts and DeepSeek's multi-head latent
attention).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

MixerKind = Literal["attn", "mla", "mamba"]
MlpKind = Literal["dense", "moe", "none"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch`` dtype of a config's dtype string."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} not one of {sorted(DTYPES)}")
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """A repeated group of layers with stacked params.

    ``pattern`` lists (mixer, mlp) per layer inside one repeat unit; the
    unit is repeated ``repeat`` times.
    """

    pattern: tuple[tuple[MixerKind, MlpKind], ...]
    repeat: int

    @property
    def layers(self) -> int:
        return len(self.pattern) * self.repeat


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 1
    d_ff: int = 0                    # per-expert hidden
    capacity_factor: float = 1.25
    group_size: int = 2048           # tokens per dispatch group (einsum path)
    dispatch: str = "einsum"         # "einsum" | "scatter"
    ep_over_dp: bool = False
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-4
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    dt_min: float = 1e-3
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 0             # 0 = full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    blocks: tuple[BlockDef, ...] = ()
    # attention
    rope_theta: float = 1e4
    rope_type: str = "default"       # default | mrope | none
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    query_chunk: int = 1024          # the JAX package's XLA attention chunk
    mlp_act: str = "swiglu"          # swiglu | relu2 | gelu
    pos_embed: str = "rope"          # rope | sinusoidal | none
    # sub-configs
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    mla: MLAConfig | None = None
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500
    cross_attention: bool = False
    # embeddings / IO
    tie_embeddings: bool = False
    input_mode: str = "tokens"       # tokens | embeds
    mtp: bool = False
    mtp_weight: float = 0.3
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # runtime defaults
    optimizer: str = "adamw"         # adamw | adamw8bit | adafactor
    remat: str = "full"              # none | dots | full
    subquadratic: bool = False
    flat_dp: bool = False
    source: str = ""                 # provenance note

    # ---- derived ----
    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def block_layers(self) -> int:
        return sum(b.layers for b in self.blocks)

    def validate(self):
        assert self.block_layers() == self.num_layers, (
            f"{self.name}: blocks cover {self.block_layers()} layers, "
            f"config says {self.num_layers}"
        )
        if self.num_heads and self.mla is None:
            assert self.d_model % self.num_heads == 0 or self.head_dim
        if self.moe is not None:
            assert any(
                mlp == "moe" for b in self.blocks for _, mlp in b.pattern
            )
        return self


def dense_blocks(n: int) -> tuple[BlockDef, ...]:
    return (BlockDef(pattern=(("attn", "dense"),), repeat=n),)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Per-cell runtime knobs, field for field the JAX package's.
    ``zero1`` is read by the sharded train step and
    ``gradient_compression`` by the compressed cross-pod step
    (``runtime/train_step.py``); ``pp_microbatches`` by the pipeline
    step (``runtime/pipeline.py``), and ``pipeline_stages`` by its
    one-process form (with rules the mesh's "pod" axis sets the stage
    count); ``seq_shard`` by the dry run and the perf harness
    (``launch/dryrun.py::cell_rules``: the residual stream's sequence
    over "model")."""

    microbatch: int | None = None    # global microbatch size (None = no accum)
    remat: str | None = None         # override ModelConfig.remat
    optimizer: str | None = None
    grad_dtype: str = "float32"      # gradient accumulation dtype
    zero1: bool = True               # shard optimizer state over data axis
    seq_shard: bool = False          # Megatron-SP residuals
    loss_chunk: int = 512            # chunked xent over seq
    gradient_compression: str = "none"   # none | int8  (cross-pod)
    pipeline_stages: int = 1         # >1: GPipe over the "pod" axis
    pp_microbatches: int = 8


REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    cfg.validate()
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import side-effect registration
    from repro_torch.configs import ALL_ARCHS  # noqa: F401

    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
