"""Serving steps: prefill and decode, built for one config.

The JAX package's ``runtime/serve_step.py``.  The steps run under
``torch.no_grad``; the decode step updates its cache in place.  With
``rules`` a step runs under ``axis_rules`` (and ``implicit_replication``
for the tables the model builds), so the models' ``shard`` sites place
the activations of DTensor inputs; ``cache_shardings`` and
``serve_input_shardings`` give the placements of the cache and the
inputs.  A sharded serving run is not exercised yet: the steps are held
to the JAX package's placements only as specs.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.runtime.train_step import batch_shardings
from repro_torch.sharding.rules import AxisRules, axis_rules, param_shardings


def _under(rules: AxisRules | None):
    if rules is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(axis_rules(rules))
    stack.enter_context(implicit_replication())
    return stack


def build_prefill(cfg: ModelConfig, rules: AxisRules | None = None,
                  max_seq: int | None = None):
    @torch.no_grad()
    def fn(params, inputs):
        with _under(rules):
            return M.prefill(cfg, params, inputs, max_seq=max_seq)

    return fn


def build_decode(cfg: ModelConfig, rules: AxisRules | None = None):
    @torch.no_grad()
    def fn(params, cache, inputs):
        with _under(rules):
            return M.decode_step(cfg, params, cache, inputs)

    return fn


def cache_shardings(cfg: ModelConfig, batch: int, max_seq: int,
                    rules: AxisRules):
    sch = M.cache_schema(cfg, batch, max_seq)
    return param_shardings(sch, rules)


def serve_input_shardings(specs: dict, rules: AxisRules):
    """The ``Sharding`` of each serving input (anything with a
    ``shape``): the batch dim by the rules, a scalar replicated."""
    return batch_shardings(specs, rules)
