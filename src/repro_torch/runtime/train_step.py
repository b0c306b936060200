"""The train step on one card: microbatched gradient accumulation and
the optimizer update.

The JAX package's ``runtime/train_step.py`` without its sharding:
``state_schema``, ``init_state``, ``compute_grads`` and
``build_train_step``.  ``jax.value_and_grad`` becomes
``torch.autograd.grad`` of ``models/model.py::loss_fn`` with respect to
leaves that alias the parameters; microbatches run in the JAX package's
order, each loss normalised by its own token count, gradients summed in
``run.grad_dtype`` and divided by their number.  On the card the
forward runs the LM kernels through their ``autograd.Function``s.
``state_shardings``, ``batch_shardings`` and
``build_compressed_train_step`` wait for the port's sharding.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, torch_dtype
from repro_torch.models import model as M
from repro_torch.models.params import (
    ZEROS,
    ParamSpec,
    init_params,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.optim import Optimizer


def state_schema(cfg: ModelConfig, run: RunConfig, optimizer: Optimizer):
    psch = M.train_schema(cfg)
    return {
        "params": psch,
        "opt": optimizer.state_schema(psch),
        "step": ParamSpec((), (), torch.int32, ZEROS),
    }


def init_state(sch, gen: torch.Generator, device):
    """The parameters of ``sch`` from ``gen``; the optimizer's state
    comes from ``optimizer.init`` (``new_state``)."""
    return init_params(sch["params"], gen, device)


def new_state(params, optimizer: Optimizer) -> dict:
    """``{"params", "opt", "step"}`` at step 0."""
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def loss_and_grads(cfg: ModelConfig, run: RunConfig, params, batch):
    """(loss, metrics, grads) of ``loss_fn`` on ``batch``: the port's
    ``jax.value_and_grad(loss_of, has_aux=True)``."""
    wrt = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = M.loss_fn(cfg, wrt, batch, loss_chunk=run.loss_chunk,
                              remat=run.remat)
    grads = torch.autograd.grad(loss, tree_leaves(wrt))
    return loss.detach(), metrics, tree_unflatten(params, grads)


def compute_grads(cfg: ModelConfig, run: RunConfig, params, batch):
    """Returns (grads, metrics).  Microbatched when run.microbatch is set
    and smaller than the global batch."""
    B = batch["tokens"].shape[0]
    mb_size = run.microbatch or B
    if mb_size >= B:
        _, metrics, grads = loss_and_grads(cfg, run, params, batch)
        return grads, metrics
    if B % mb_size:
        raise ValueError(f"batch {B} is not a multiple of microbatch "
                         f"{mb_size}")
    n_acc = B // mb_size
    gdtype = torch_dtype(run.grad_dtype)
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=gdtype,
                                          device=p.device), params)
    lsum = nll = cnt = torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
    for i in range(n_acc):
        mb = {k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()}
        loss, metrics, g = loss_and_grads(cfg, run, params, mb)
        for a, b in zip(tree_leaves(gsum), tree_leaves(g)):
            a.add_(b.to(gdtype))
        lsum = lsum + loss
        nll = nll + metrics["nll_sum"]
        cnt = cnt + metrics["token_count"]
        del g
    # gradients stay in the accumulation dtype; the optimizer upcasts
    grads = tree_map(lambda g: g / n_acc, gsum)
    return grads, {"loss": lsum / n_acc, "nll_sum": nll, "token_count": cnt}


def build_train_step(cfg: ModelConfig, run: RunConfig, optimizer: Optimizer):
    """``step(state, batch) -> (state, metrics)`` with ``state =
    {"params", "opt", "step"}``; the old state is left as it was."""

    def step(state, batch):
        grads, metrics = compute_grads(cfg, run, state["params"], batch)
        new_params, new_opt = optimizer.update(
            grads, state["opt"], state["params"], state["step"])
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return step
