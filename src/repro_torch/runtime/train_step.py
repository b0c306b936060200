"""The train step: microbatched gradient accumulation and the
optimizer update, on one device or over a DTensor mesh.

The JAX package's ``runtime/train_step.py``: ``state_schema``,
``state_shardings``, ``init_state``, ``batch_pspecs``,
``batch_shardings``, ``compute_grads`` and ``build_train_step``.
``jax.value_and_grad`` becomes ``torch.autograd.grad`` of
``models/model.py::loss_fn`` with respect to leaves that alias the
parameters; microbatches run in the JAX package's order, each loss
normalised by its own token count, gradients summed in
``run.grad_dtype`` and divided by their number.  On the card the
forward runs the LM kernels through their ``autograd.Function``s.

With rules (``sharding/rules.py``) the parameters, the optimizer state
and the batch are DTensors placed by ``state_shardings`` and
``batch_shardings``; the step runs under ``axis_rules`` (the models'
``shard`` sites place the activations) and ``implicit_replication``
(the tables a model builds, RoPE's cos/sin and the masks, are the same
on every rank), and each gradient is redistributed to its parameter's
placements before the update, as the JAX package's ``grad_pspecs``
constrain them.  Under ``run.zero1`` the update runs at the optimizer
state's placements (the parameter's plus a "data" split): gradients and
parameters are cut to them (a local slice) and the new parameters are
gathered back.

``donate=True`` is the JAX package's ``jax.jit(step,
donate_argnums=(0,))``: the step writes the new parameters, optimizer
state and step counter into the state it was given and returns that
state (``optimizer.update_``, ``optim/inplace.py``), one leaf at a time,
freeing each gradient once it is used, so that the card holds one state
and the gradients, not two states.  The values are bitwise the plain
step's.  A caller that still needs the old state clones it first, as a
JAX caller cannot reuse a donated buffer.

``build_compressed_train_step`` is the JAX package's two-level step, its
rendering of the paper's cluster <-> cloud synchronisation (Fig. 1 step
8): each pod runs in a region manual over "pod" (``sharding/rules.py``:
rules with ``manual=("pod",)`` on the ("data", "model") sub-mesh, the
batch over "data"), computes its gradients on its slice of the batch,
and the gradients cross the pod boundary by
``optim/compression.py::cross_pod_reduce`` as ``run.gradient_compression``
says (int8 or an exact sum).  Each pod then updates its own copy of the
state, which comes out ``Replicate()`` over "pod".
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, RunConfig, torch_dtype
from repro_torch.models import model as M
from repro_torch.models.params import (
    ZEROS,
    ParamSpec,
    init_params,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_zip,
)
from repro_torch.optim import Optimizer
from repro_torch.optim.compression import cross_pod_reduce
from repro_torch.optim.inplace import bump_
from repro_torch.sharding.rules import (
    AxisRules,
    Sharding,
    axis_rules,
    distribute_params,
    into_region,
    mesh_shape,
    out_of_region,
    param_shardings,
    place,
    replicate_dims,
    shard,
    zero1_shardings,
)


def state_schema(cfg: ModelConfig, run: RunConfig, optimizer: Optimizer):
    psch = M.train_schema(cfg)
    return {
        "params": psch,
        "opt": optimizer.state_schema(psch),
        "step": ParamSpec((), (), torch.int32, ZEROS),
    }


def state_shardings(sch, rules: AxisRules, run: RunConfig):
    """The ``Sharding`` of every leaf of ``state_schema``'s tree: the
    parameters by their rules, the optimizer state by ZeRO-1's when
    ``run.zero1``, the step replicated."""
    out = {
        "params": param_shardings(sch["params"], rules),
        "step": rules.sharding((), ()),
    }
    shard_fn = zero1_shardings if run.zero1 else param_shardings
    out["opt"] = shard_fn(sch["opt"], rules)
    return out


def _batch_axes(shape) -> tuple:
    """An input's logical axes: its first dim the batch, a scalar none."""
    return ("batch",) + (None,) * (len(shape) - 1) if len(shape) else ()


def batch_pspecs(batch_specs: dict, rules: AxisRules):
    """Specs for a train/serve input dict (batch-dim sharded); each value
    is anything with a ``shape``."""
    return {k: rules.spec(_batch_axes(v.shape), tuple(v.shape))
            for k, v in batch_specs.items()}


def batch_shardings(batch_specs: dict, rules: AxisRules):
    return {k: rules.sharding(_batch_axes(v.shape), tuple(v.shape))
            for k, v in batch_specs.items()}


def _place(x, s: Sharding):
    return place(x, s.placements, s.mesh)


def full_tensor(x):
    """A DTensor gathered whole on every rank; a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


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
    # a leaf the loss does not read (qwen2-vl's token table, its inputs
    # being embeddings) gets zeros, as jax.grad gives it
    grads = torch.autograd.grad(loss, tree_leaves(wrt), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), metrics, tree_unflatten(params, grads)


def compute_grads(cfg: ModelConfig, run: RunConfig, params, batch,
                  grad_shardings=None):
    """Returns (grads, metrics).  Microbatched when run.microbatch is set
    and smaller than the global batch.  With ``grad_shardings`` each
    microbatch's gradients are redistributed to the parameters'
    placements (a reduce-scatter of the partial sums over the batch
    shards where the parameter is sharded, an all-reduce where it is
    replicated)."""
    B = batch["tokens"].shape[0]
    mb_size = run.microbatch or B

    def constrain(g):
        if grad_shardings is None:
            return g
        return tree_zip(_place, g, grad_shardings)

    if mb_size >= B:
        _, metrics, grads = loss_and_grads(cfg, run, params, batch)
        return constrain(grads), metrics
    if B % mb_size:
        raise ValueError(f"batch {B} is not a multiple of microbatch "
                         f"{mb_size}")
    n_acc = B // mb_size
    gdtype = torch_dtype(run.grad_dtype)
    gsum = tree_map(lambda p: torch.zeros_like(p, dtype=gdtype), params)
    lsum = nll = cnt = torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
    for i in range(n_acc):
        # a microbatch is a slice of the batch dim, cut from the whole
        # batch and placed again by the rules
        mb = {k: shard(replicate_dims(v, 0)[i * mb_size:(i + 1) * mb_size],
                       "batch", *(None,) * (v.ndim - 1))
              for k, v in batch.items()}
        loss, metrics, g = loss_and_grads(cfg, run, params, mb)
        g = constrain(g)
        for a, b in zip(tree_leaves(gsum), tree_leaves(g)):
            a.add_(b.to(gdtype))
        lsum = lsum + loss
        nll = nll + metrics["nll_sum"]
        cnt = cnt + metrics["token_count"]
        del g
    # gradients stay in the accumulation dtype; the optimizer upcasts.
    # The mean is taken in place: no second gradient tree
    for g in tree_leaves(gsum):
        g.div_(n_acc)
    return gsum, {"loss": lsum / n_acc, "nll_sum": nll, "token_count": cnt}


def update_shardings(cfg: ModelConfig, run: RunConfig, rules: AxisRules):
    """The update's placements: the optimizer state's under ZeRO-1
    (``run.zero1``), the parameters' otherwise."""
    if run.zero1:
        return zero1_shardings(M.train_schema(cfg), rules)
    return param_shardings(M.train_schema(cfg), rules)


def donated_update_(optimizer: Optimizer, grads, state, shardings=None):
    """The donated step's update: ``optimizer.update_`` of ``state`` in
    place (each leaf of ``grads`` dropped once used; ``shardings`` the
    update's placements where they are not the parameters'), then the
    step counter; returns ``state``."""
    optimizer.update_(grads, state["opt"], state["params"], state["step"],
                      shardings)
    bump_(state["step"])
    return state


def build_train_step(cfg: ModelConfig, run: RunConfig, optimizer: Optimizer,
                     rules: AxisRules | None = None, donate: bool = False):
    """``step(state, batch) -> (state, metrics)`` with ``state =
    {"params", "opt", "step"}``; the old state is left as it was, or,
    with ``donate``, updated in place and returned.  With ``rules`` the
    state and the batch are DTensors (``state_shardings``,
    ``batch_shardings``); the new state keeps its placements, and the
    metrics come back as plain (replicated) tensors."""
    if rules is None:
        def step(state, batch):
            grads, metrics = compute_grads(cfg, run, state["params"], batch)
            if donate:
                return donated_update_(optimizer, grads, state), metrics
            new_params, new_opt = optimizer.update(
                grads, state["opt"], state["params"], state["step"])
            return ({"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}, metrics)

        return step

    sh = state_shardings(state_schema(cfg, run, optimizer), rules, run)
    psh = sh["params"]
    ush = update_shardings(cfg, run, rules)

    def sharded_step(state, batch):
        with axis_rules(rules), implicit_replication():
            grads, metrics = compute_grads(cfg, run, state["params"], batch,
                                           psh)
            if donate:
                new = donated_update_(optimizer, grads, state,
                                      ush if run.zero1 else None)
            else:
                new_params, new_opt = optimizer.update(
                    tree_zip(_place, grads, ush), state["opt"],
                    tree_zip(_place, state["params"], ush), state["step"])
                new = {"params": tree_zip(_place, new_params, psh),
                       "opt": tree_zip(_place, new_opt, sh["opt"]),
                       "step": _place(state["step"] + 1, sh["step"])}
            metrics = {k: full_tensor(v) for k, v in metrics.items()}
        return new, metrics

    return sharded_step


# ---------------------------------------------------------------------------
# Compressed cross-pod train step (a region per pod)
# ---------------------------------------------------------------------------


def pod_rules(rules: AxisRules) -> AxisRules:
    """The rules inside a pod's region: manual over "pod", the batch
    over "data" only (the JAX package's ``inner_rules``)."""
    if "pod" not in mesh_shape(rules.mesh):
        raise ValueError("the compressed step needs a 'pod' mesh axis")
    return dataclasses.replace(
        rules, rules={**rules.rules, "batch": (("data",),)},
        manual=("pod",))


def _pod_batch(batch, rules: AxisRules, inner: AxisRules):
    """Each pod's slice of the batch in its region (the JAX package's
    ``P("pod")`` in-spec), over "data" inside the pod where it
    divides."""
    npods = mesh_shape(rules.mesh)["pod"]
    outer = dataclasses.replace(
        rules, rules={**rules.rules, "batch": (("pod", "data"), ("pod",))})
    out = {}
    for k, v in batch.items():
        if v.ndim and v.shape[0] % npods:
            raise ValueError(f"{k}: batch {v.shape[0]} is not a multiple "
                             f"of the {npods} pods")
        s = outer.sharding(_batch_axes(v.shape), tuple(v.shape))
        out[k] = into_region(_place(v, s), inner)
    return out


def _region_grads(cfg: ModelConfig, run: RunConfig, params, batch,
                  inner: AxisRules, grad_shardings):
    """A pod's gradients, token-weighted and reduced across the pods,
    and the metrics averaged over them; under ``inner``'s rules, on the
    region's DTensors."""
    group = inner.mesh.get_group("pod")
    npods = mesh_shape(inner.mesh)["pod"]
    grads, metrics = compute_grads(cfg, run, params, batch, grad_shardings)
    # each pod's grads are normalised by its own token count; the global
    # gradient is the token-weighted mean across the pods.  The JAX
    # package scales by the count and divides the sum by the total; the
    # weight count / total is applied here before the exchange instead,
    # the same sum up to a rounding, and exactly 1 on one pod
    cnt = full_tensor(metrics["token_count"]).to(torch.float32)
    weight = cnt / cross_pod_reduce(cnt, group, "none")
    grads = tree_map(lambda g: g * weight, grads)
    grads = cross_pod_reduce(grads, group, run.gradient_compression)
    metrics = {k: cross_pod_reduce(full_tensor(v).to(torch.float32), group,
                                   "none") / npods
               for k, v in metrics.items()}
    return grads, metrics


def compressed_grads(cfg: ModelConfig, run: RunConfig, params, batch,
                     rules: AxisRules):
    """The compressed step's gradients (DTensors on ``rules.mesh``,
    ``Replicate()`` over "pod": each pod's own sum) and its metrics
    (plain), from parameters and a batch placed by ``rules``."""
    inner = pod_rules(rules)
    psh = param_shardings(M.train_schema(cfg), inner)
    with axis_rules(inner), implicit_replication():
        grads, metrics = _region_grads(
            cfg, run, tree_map(lambda t: into_region(t, inner), params),
            _pod_batch(batch, rules, inner), inner, psh)
    return tree_map(lambda g: out_of_region(g, inner), grads), metrics


def build_compressed_train_step(cfg: ModelConfig, run: RunConfig,
                                optimizer: Optimizer, rules: AxisRules,
                                donate: bool = False):
    """``step(state, batch) -> (state, metrics)`` on a mesh with a "pod"
    axis: the state and the batch DTensors placed by ``rules``
    (``state_shardings``, ``batch_shardings``), the gradients across
    the pods in int8 or exactly (``run.gradient_compression``), the
    update in each pod's region at the optimizer state's placements
    there.  The new state is ``Replicate()`` over "pod"; the metrics
    are plain tensors, averaged over the pods.  With ``donate`` the
    state (``Replicate()`` over "pod", as the step returns it) is
    updated in place, through the region's views of its local tensors,
    and returned."""
    inner = pod_rules(rules)
    sh = state_shardings(state_schema(cfg, run, optimizer), inner, run)
    psh = sh["params"]
    ush = update_shardings(cfg, run, inner)

    def step(state, batch):
        st = tree_map(lambda t: into_region(t, inner), state)
        with axis_rules(inner), implicit_replication():
            grads, metrics = _region_grads(
                cfg, run, st["params"], _pod_batch(batch, rules, inner),
                inner, psh)
            if donate:
                donated_update_(optimizer, grads, st,
                                ush if run.zero1 else None)
                return state, metrics
            new_params, new_opt = optimizer.update(
                tree_zip(_place, grads, ush), st["opt"],
                tree_zip(_place, st["params"], ush), st["step"])
            new = {"params": tree_zip(_place, new_params, psh),
                   "opt": tree_zip(_place, new_opt, sh["opt"]),
                   "step": _place(st["step"] + 1, sh["step"])}
        return tree_map(lambda t: out_of_region(t, inner), new), metrics

    return step


def distribute_batch(batch, rules: AxisRules):
    """A batch built the same way on every rank as DTensors placed by
    ``batch_shardings``."""
    return distribute_params(batch, batch_shardings(batch, rules))
