"""Serving steps: prefill and decode, built for one config.

The JAX package's ``runtime/serve_step.py`` without the sharding
arguments (one card).  The steps run under ``torch.no_grad``; the
decode step updates its cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def build_prefill(cfg: ModelConfig, max_seq: int | None = None):
    @torch.no_grad()
    def fn(params, inputs):
        return M.prefill(cfg, params, inputs, max_seq=max_seq)

    return fn


def build_decode(cfg: ModelConfig):
    @torch.no_grad()
    def fn(params, cache, inputs):
        return M.decode_step(cfg, params, cache, inputs)

    return fn
