"""Serving steps: prefill and decode, built for one config.

The JAX package's ``runtime/serve_step.py``.  The steps run under
``torch.no_grad``; the decode step updates its cache in place.  With
``rules`` a step runs under ``axis_rules`` (and ``implicit_replication``
for the tables the model builds), so the models' ``shard`` sites place
the activations of DTensor inputs.  ``place_params`` and
``place_inputs`` make the parameters and the inputs DTensors at
``param_shardings`` and ``serve_input_shardings``; prefill then
allocates its cache as DTensors at ``cache_shardings``, and decode
gives it back at the same placements.  A cache write on a sharded
sequence dim stays local: only the rank whose shard holds a position
writes it (``sharding/rules.py::write_along``).
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.runtime.train_step import batch_shardings
from repro_torch.sharding.rules import (
    AxisRules,
    axis_rules,
    distribute_params,
    param_shardings,
)


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


def place_params(cfg: ModelConfig, params, rules: AxisRules):
    """Serving parameters, built the same way on every rank, as DTensors
    at ``param_shardings(M.schema(cfg), rules)``."""
    return distribute_params(params,
                             param_shardings(M.schema(cfg), rules))


def place_inputs(inputs: dict, rules: AxisRules) -> dict:
    """A prefill or decode input dict, built the same way on every rank,
    with each tensor a DTensor at ``serve_input_shardings``; anything
    else (decode's ``pos``) as it is."""
    tensors = {k: v for k, v in inputs.items()
               if isinstance(v, torch.Tensor)}
    placed = distribute_params(tensors,
                               serve_input_shardings(tensors, rules))
    return {k: placed.get(k, v) for k, v in inputs.items()}
