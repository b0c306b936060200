"""Deterministic synthetic token pipeline — checkpointable.

The JAX package's ``data/pipeline.py``: batches are a pure function of
(seed, step), drawn with numpy from ``SeedSequence([seed, step])``, so
both packages draw the same tokens and masks bit for bit, and restoring
``step`` from a checkpoint restores the exact data stream with no
iterator state files.  Documents are zipf-distributed token runs; loss
masks zero out the positions past each row's document length.  A config
with embedding inputs also gets ``embeds`` (B, S, d), one with M-RoPE
``positions`` (B, 3, S) (one ``arange`` on all three rows, as the JAX
pipeline has), and one with cross-attention ``enc_embeds`` (B, frames,
d), drawn from the same generator in the same order.  Batches come back
as torch tensors on the pipeline's device (tokens and positions int32,
mask f32, the embeddings bf16 as the JAX pipeline stores them).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int

    def to_extra(self) -> dict:
        return {"data_seed": self.seed, "data_step": self.step}

    @staticmethod
    def from_extra(extra: dict) -> "PipelineState":
        return PipelineState(
            seed=int(extra.get("data_seed", 0)),
            step=int(extra.get("data_step", 0)),
        )


class SyntheticLMPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 device="cpu"):
        self.cfg = cfg
        self.shape = shape
        self.device = torch.device(device)
        self.state = PipelineState(seed=seed, step=0)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        B, S = self.shape.global_batch, self.shape.seq_len
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, step])
        )
        # zipf-ish unigram stream with doc boundaries
        V = cfg.vocab_size
        ranks = rng.zipf(1.3, size=(B, S)).astype(np.int64)
        tokens = np.clip(ranks, 1, V - 1).astype(np.int32)
        doc_len = rng.integers(S // 4, S, size=(B,))
        mask = (np.arange(S)[None, :] < doc_len[:, None]).astype(np.float32)
        out = {"tokens": tokens, "loss_mask": mask}
        if cfg.input_mode == "embeds":
            out["embeds"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        if cfg.rope_type == "mrope":
            out["positions"] = np.broadcast_to(
                np.arange(S, dtype=np.int32)[None, None], (B, 3, S)).copy()
        if cfg.cross_attention:
            out["enc_embeds"] = rng.standard_normal(
                (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
        bf16 = ("embeds", "enc_embeds")
        return {k: torch.from_numpy(v).to(
            self.device, torch.bfloat16 if k in bf16 else None)
            for k, v in out.items()}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    def restore(self, extra: dict):
        self.state = PipelineState.from_extra(extra)
