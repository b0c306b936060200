"""Pipeline parallelism over the "pod" axis (GPipe).

The JAX package's ``runtime/pipeline.py``, its rendering of the paper's
slow cluster <-> cloud link as an alternative to cross-pod data
parallelism: with data parallelism the whole gradient crosses the link
every step; here each pod holds a contiguous slice of the layers, only
the activations at the stage boundaries (and their gradients) cross,
and the layers' gradients never leave their pod.

``pipeline_compatible(cfg)`` is the JAX package's restriction: one
block of ``("attn", "dense")`` layers, no cross-attention, no MTP head,
no MoE.  ``build_pipeline_train_step(cfg, run, optimizer, rules=None)``
returns ``(step, state_shardings)``.

The schedule is GPipe's over ``run.pp_microbatches`` microbatches and
``n_micro + stages − 1`` ticks: at tick t stage ``sid`` runs microbatch
``t − sid`` where ``0 ≤ t − sid < n_micro`` and does nothing otherwise
(the JAX package computes such a bubble tick and drops it with
``where``; its terms are exact zeros, so the numbers are the same).
Stage 0 embeds its microbatch's tokens, every stage runs its layers,
and the last stage applies the final norm and ``chunked_xent`` and
starts the microbatch's backward at once from ``nll_m / max(Σ cnt, 1)``
(the count depends on the batch alone).  The other stages then run
their backwards in reverse tick order: the gradient of the stage's
output against the one the next stage sent, and the gradient of its
input sent to the stage before.  The hops stay outside autograd (the
JAX package differentiates through its ``ppermute``): inside, a hop's
backward would wait for a peer that never runs it, since stage 0 drops
what it receives and the last tick's output feeds nothing.  The loss is
``Σ nll / max(Σ cnt, 1)`` (the JAX package adds its MoE aux term
averaged over the stages, 0 in the compatible family) and the metrics
are the JAX package's ``loss``, ``nll_sum`` and ``token_count``, the
same on every stage.  Gradients are summed in ``run.grad_dtype``; the
shared leaves' (the embedding, the final norm, the unembedding) over
the stages, each layer's on its own stage.  RoPE has no positions, as
in the JAX package.  The layers run under ``run.remat`` (the config's
unless the run overrides it, as in ``build_train_step``; the JAX
package's pipeline takes the config's: a recompute is bitwise, so the
numbers do not depend on it).

A hop carries the port's stream, the two tensors ``(x, res)`` that
``models/model.py::backbone_full`` hands to the fused final norm where
the JAX package carries one ``x``: each stage's forward is then bitwise
the unsplit forward's, for twice the JAX package's boundary bytes.
``SENT`` counts the bytes the hops move, forward and backward, by
dtype.

Where the stages live (one schedule serves both; neither falls back to
the other):

* with ``rules`` (a mesh whose "pod" axis is ≥ 2; ``run.pipeline_stages``
  is not read, as in the JAX package) each rank runs the stage of its
  "pod" coordinate.  The state is DTensors on ``rules.mesh``: every leaf
  under ``b<i>`` ``Shard(0)`` over "pod" on its stacked-layers dim,
  every other leaf and "step" ``Replicate()`` there, and over ("data",
  "model") each leaf at the placements of the rules inside a pod's
  region (``sharding/rules.py``: manual over "pod", the batch over
  "data", ``seq_res`` over "model", the JAX package's
  ``inner_rules``).  The optimizer state follows its parameter.  A hop
  is one ``batch_isend_irecv`` over ``rules.mesh.get_group("pod")`` of
  the local shards of the region's DTensors, between the ranks with
  equal ("data", "model") coordinates.  The batch is the same on every
  pod, as plain tensors or DTensors.
* with ``rules=None``, ``run.pipeline_stages`` stages live in this
  process on the state's device (the card has one GPU, and NCCL takes
  one rank a GPU); a hop hands the same tensors over, with no copy.
  The state is plain tensors, as ``build_train_step``'s, and
  ``state_shardings`` is ``None``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import (
    BlockDef,
    ModelConfig,
    RunConfig,
    torch_dtype,
)
from repro_torch.models import model as M
from repro_torch.models.layers import embed_tokens
from repro_torch.models.params import (
    map_specs,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_zip,
)
from repro_torch.models.transformer import apply_block_full, fused_norm
from repro_torch.optim import Optimizer
from repro_torch.optim.compression import cross_pod_reduce
from repro_torch.runtime.train_step import donated_update_, full_tensor, \
    pod_rules, state_schema
from repro_torch.sharding.rules import (
    AxisRules,
    Sharding,
    axis_rules,
    into_region,
    local_shape_and_offset,
    mesh_shape,
    param_shardings,
    place,
    shard,
    spec_placements,
)

#: bytes the hops sent, by direction and dtype name
SENT: dict[str, dict[str, int]] = {"forward": {}, "backward": {}}

#: the stream's logical axes at a stage boundary
_BOUNDARY = ("batch", "seq_res", None)


def pipeline_compatible(cfg: ModelConfig) -> bool:
    return (
        len(cfg.blocks) == 1
        and all(m == "attn" and mlp == "dense"
                for m, mlp in cfg.blocks[0].pattern)
        and not cfg.cross_attention
        and not cfg.mtp
        and cfg.moe is None
    )


def _is_block(path) -> bool:
    return any(k.startswith("b") and k[1:].isdigit() for k in path)


def _count(direction: str, t: torch.Tensor) -> None:
    key = str(t.dtype).removeprefix("torch.")
    box = SENT[direction]
    box[key] = box.get(key, 0) + t.numel() * t.element_size()


def _stage_rules(rules: AxisRules) -> AxisRules:
    """The rules inside a pod's region: ``pod_rules`` (manual over
    "pod", the batch over "data") with the residual stream over
    "model" (the JAX package's ``inner_rules``)."""
    inner = pod_rules(rules)
    return dataclasses.replace(
        inner, rules={**inner.rules, "seq_res": (("model",),)})


def pipeline_shardings(sch, rules: AxisRules):
    """The ``Sharding`` (on ``rules.mesh``) of every leaf of a
    ``state_schema`` tree: the region's placements of the leaf, and
    over "pod" ``Shard(0)`` for a leaf under ``b<i>`` (the JAX package's
    ``_block_param_specs``), ``Replicate()`` for the others."""
    inner = _stage_rules(rules)

    def one(path, s):
        spec = inner.spec(s.axes, s.shape)
        if _is_block(path):
            spec = type(spec)("pod", *spec[1:])
        return Sharding(rules.mesh, spec, spec_placements(rules.mesh, spec))

    return map_specs(one, sch)


def _check(cfg: ModelConfig, run: RunConfig,
           rules: AxisRules | None) -> int:
    """The stage count, after the JAX package's checks."""
    if not pipeline_compatible(cfg):
        raise ValueError(f"{cfg.name}: the pipeline takes one block of "
                         f"dense attention layers, no cross-attention, MTP "
                         f"or MoE")
    if rules is None:
        stages = run.pipeline_stages
        if stages < 2:
            raise ValueError(f"pipeline_stages={stages}: the one-process "
                             f"pipeline needs 2 or more")
    else:
        stages = mesh_shape(rules.mesh).get("pod", 1)
        if stages < 2:
            raise ValueError("the pipeline needs a 'pod' mesh axis of 2 or "
                             "more")
    repeat = cfg.blocks[0].repeat
    if repeat % stages:
        raise ValueError(f"{repeat} layers do not split into {stages} "
                         f"stages")
    return stages


class _Handoff:
    """The hops of stages that live in one process: the same tensors
    handed over, no copy."""

    def __init__(self):
        self.box = {}

    def post(self, direction, dst, m, ts):
        for t in ts:
            _count(direction, t)
        self.box[(direction, dst, m)] = tuple(t.detach() for t in ts)

    def exchange(self, direction, t):
        pass

    def take(self, direction, sid, m):
        return _taken(direction, self.box.pop((direction, sid, m)))


class _Wire:
    """The hops of one rank's stage: at each tick boundary one
    ``batch_isend_irecv`` over the pod group of the region DTensors'
    local shards, what this stage sends and what it is owed."""

    def __init__(self, group, sid, stages, n_micro, shape, dtype, inner):
        self.group, self.sid = group, sid
        self.stages, self.n_micro = stages, n_micro
        self.mesh = inner.region_mesh
        self.dtype = dtype
        self.placements = inner.placements(_BOUNDARY, shape)
        # in Python: torch's form reads tensors, which a fake mode (the
        # dry run's) cannot
        self.local_shape, _ = local_shape_and_offset(
            shape, self.mesh, self.placements)
        self.out = None
        self.box = {}

    def post(self, direction, dst, m, ts):
        for t in ts:
            if t.dtype != self.dtype:
                raise TypeError(f"a {t.dtype} hop where the stream is "
                                f"{self.dtype}")
        self.out = (dst, [place(t, self.placements).to_local().contiguous()
                          for t in ts])

    def _owed(self, direction, t):
        """(peer stage, microbatch) this stage receives at the boundary
        after tick t, or None."""
        if direction == "forward":
            src, m = self.sid - 1, t + 1 - self.sid
        else:
            src, m = self.sid + 1, t - 1 - self.sid
        if 0 <= src < self.stages and 0 <= m < self.n_micro:
            return src, m
        return None

    def exchange(self, direction, t):
        ops = []
        if self.out is not None:
            dst, payload = self.out
            peer = dist.get_global_rank(self.group, dst)
            for x in payload:
                _count(direction, x)
                ops.append(dist.P2POp(dist.isend, x, peer, self.group))
        owed = self._owed(direction, t)
        recv = []
        if owed is not None:
            peer = dist.get_global_rank(self.group, owed[0])
            dev = self.mesh.device_type
            recv = [torch.empty(self.local_shape, dtype=self.dtype,
                                device=dev) for _ in range(2)]
            ops += [dist.P2POp(dist.irecv, x, peer, self.group)
                    for x in recv]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self.out = None
        if owed is not None:
            self.box[(direction, self.sid, owed[1])] = tuple(
                DTensor.from_local(x, self.mesh, self.placements,
                                   run_check=False) for x in recv)

    def take(self, direction, sid, m):
        return _taken(direction, self.box.pop((direction, sid, m)))


def _taken(direction, ts):
    """A stage's inputs require grad (its backward sends their
    gradients on); the gradients it receives do not."""
    if direction == "forward":
        return tuple(x.requires_grad_() for x in ts)
    return ts


class _Stage:
    """One stage's parameters (leaves that require grad), its
    microbatches' inputs and outputs, and its gradient sums."""

    def __init__(self, sid, params, grad_shardings, gdtype):
        self.sid = sid
        self.params = tree_map(lambda t: t.detach().requires_grad_(), params)
        self.leaves = tree_leaves(self.params)
        self.grad_shardings = grad_shardings
        self.gsum = [None] * len(self.leaves)
        self.gdtype = gdtype
        self.saved = {}

    def add_grads(self, grads) -> None:
        shs = (tree_leaves(self.grad_shardings)
               if self.grad_shardings is not None else [None] * len(grads))
        for i, (g, s) in enumerate(zip(grads, shs)):
            if g is None:
                continue
            if s is not None:
                g = place(g, s.placements)
            g = g.to(self.gdtype)
            self.gsum[i] = g if self.gsum[i] is None else self.gsum[i] + g

    def grads(self, zeros: bool = True):
        """Each leaf's gradient sum; where none arrived, zeros (or None
        with ``zeros=False``)."""
        return tree_unflatten(self.params, [
            torch.zeros_like(p, dtype=self.gdtype) if g is None and zeros
            else g for p, g in zip(self.leaves, self.gsum)])


def _schedule(cfg, run, stages, n_micro, local, hops, batch, place_in):
    """The GPipe forward and backward of the stages in ``local`` (all of
    them in one process, or one rank's).  Returns the last stage's NLL
    summed over the microbatches (None elsewhere) and the token count
    (the normaliser)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if B % n_micro:
        raise ValueError(f"batch {B} is not a multiple of pp_microbatches "
                         f"{n_micro}")
    mb = B // n_micro
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    labels, lmask = M._shift_left(tokens), M._shift_left(mask)
    cnt = lmask.to(torch.float32).sum()
    denom = torch.clamp(cnt, min=1.0)
    rope_cs = M.rope_full(cfg, S, tokens.device)
    layers = cfg.blocks[0].repeat // stages
    bdef = BlockDef(pattern=cfg.blocks[0].pattern, repeat=layers)
    last = stages - 1
    ticks = n_micro + stages - 1

    def rows(x, m, *axes):
        return place_in(x[m * mb:(m + 1) * mb], *axes)

    nll = None
    for t in range(ticks):
        for st in local:
            m = t - st.sid
            if not 0 <= m < n_micro:
                continue
            p = st.params
            if st.sid == 0:
                x = shard(embed_tokens(cfg, p, rows(tokens, m, "batch",
                                                    None)),
                          "batch", "seq_res", "d_model")
                res = torch.zeros_like(x)
                inputs = ()
            else:
                x, res = hops.take("forward", st.sid, m)
                inputs = (x, res)
            y, yres, _ = apply_block_full(cfg, bdef, p["b0"], x, res,
                                          rope_cs=rope_cs, causal=True,
                                          remat=run.remat)
            y, yres = (shard(a, *_BOUNDARY) for a in (y, yres))
            if st.sid != last:
                st.saved[m] = (inputs, (y, yres))
                hops.post("forward", st.sid + 1, m, (y, yres))
                continue
            h, _ = fused_norm(cfg, p["final_norm"], y, yres)
            nll_m, _ = M.chunked_xent(cfg, p, h, rows(labels, m, "batch",
                                                      None),
                                      rows(lmask, m, "batch", None),
                                      run.loss_chunk)
            g = torch.autograd.grad(nll_m / denom, inputs + tuple(st.leaves),
                                    allow_unused=True)
            st.add_grads(g[len(inputs):])
            st.saved[m] = g[:len(inputs)]
            nll_m = full_tensor(nll_m.detach())
            nll = nll_m if nll is None else nll + nll_m
        hops.exchange("forward", t)
    for t in reversed(range(ticks)):
        for st in local:
            m = t - st.sid
            if not 0 <= m < n_micro:
                continue
            if st.sid == last:
                dx = st.saved.pop(m)
            else:
                inputs, outputs = st.saved.pop(m)
                dy = hops.take("backward", st.sid, m)
                g = torch.autograd.grad(outputs, inputs + tuple(st.leaves),
                                        dy, allow_unused=True)
                st.add_grads(g[len(inputs):])
                dx = g[:len(inputs)]
            if st.sid > 0:
                hops.post("backward", st.sid - 1, m, dx)
        hops.exchange("backward", t)
    return nll, cnt


def _stage_view(params, sid: int, layers: int):
    """Stage ``sid``'s tree: its slice of the stacked layers (views), the
    other leaves as they are."""
    lo = sid * layers
    return {k: tree_map(lambda a: a[lo:lo + layers], v)
            if _is_block((k,)) else v for k, v in params.items()}


def _metrics(nll, cnt):
    nll = nll.to(torch.float32)
    cnt = cnt.to(torch.float32)
    return {"loss": nll / torch.clamp(cnt, min=1.0), "nll_sum": nll,
            "token_count": cnt}


def pipeline_grads(cfg: ModelConfig, run: RunConfig, params, batch):
    """The one-process form's gradients (plain tensors in ``params``'
    layout: each layer's from its stage, the shared leaves' summed over
    the stages in stage order) and metrics, over
    ``run.pipeline_stages`` stages."""
    _check(cfg, run, None)
    stages = run.pipeline_stages
    n_micro = run.pp_microbatches
    layers = cfg.blocks[0].repeat // stages
    gdtype = torch_dtype(run.grad_dtype)
    local = [_Stage(sid, _stage_view(params, sid, layers), None, gdtype)
             for sid in range(stages)]
    nll, cnt = _schedule(cfg, run, stages, n_micro, local, _Handoff(),
                         batch, lambda x, *axes: x)
    per_stage = [st.grads(zeros=False) for st in local]

    def shared_sum(p, *gs):
        # the sum over the stages, in stage order, of the gradients that
        # arrived (a stage that does not use the leaf adds an exact 0)
        gs = [g for g in gs if g is not None]
        if not gs:
            return torch.zeros_like(p, dtype=gdtype)
        return sum(gs[1:], gs[0])

    out = {}
    for k in params:
        if _is_block((k,)):
            out[k] = tree_zip(lambda *gs: torch.cat(gs),
                              *(g[k] for g in per_stage))
        else:
            out[k] = tree_zip(shared_sum, params[k],
                              *(g[k] for g in per_stage))
    return out, _metrics(nll, cnt)


def build_pipeline_train_step(cfg: ModelConfig, run: RunConfig,
                              optimizer: Optimizer,
                              rules: AxisRules | None = None,
                              donate: bool = False):
    """``(step, state_shardings)``: ``step(state, batch) -> (state,
    metrics)`` with ``state = {"params", "opt", "step"}`` (the old state
    left as it was, or with ``donate`` updated in place and returned, as
    ``train_step.build_train_step``'s), and the ``Sharding`` of every
    state leaf on ``rules.mesh`` (``None`` without rules).  Module
    docstring: where the stages live, the schedule, the placements."""
    stages = _check(cfg, run, rules)
    repeat = cfg.blocks[0].repeat
    if rules is None:
        def step(state, batch):
            grads, metrics = pipeline_grads(cfg, run, state["params"],
                                            batch)
            if donate:
                return donated_update_(optimizer, grads, state), metrics
            new_params, new_opt = optimizer.update(
                grads, state["opt"], state["params"], state["step"])
            return ({"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}, metrics)

        return step, None

    sch = state_schema(cfg, run, optimizer)
    shardings = pipeline_shardings(sch, rules)
    inner = _stage_rules(rules)
    layers = repeat // stages
    stage_cfg = dataclasses.replace(
        cfg, num_layers=layers,
        blocks=(BlockDef(pattern=cfg.blocks[0].pattern, repeat=layers),))
    region = param_shardings(M.train_schema(stage_cfg), inner)

    def step(state, batch):
        mesh = inner.region_mesh
        group = rules.mesh.get_group("pod")
        sid = dist.get_rank(group)
        st = tree_map(lambda t: into_region(t, inner), state)
        rep = (Replicate(),) * mesh.ndim
        batch = {k: full_tensor(v) for k, v in batch.items()}

        def place_in(x, *axes):
            return shard(place(x, rep, mesh), *axes)

        B, S = batch["tokens"].shape
        with axis_rules(inner), implicit_replication():
            gdtype = torch_dtype(run.grad_dtype)
            stage = _Stage(sid, st["params"], region, gdtype)
            n_micro = run.pp_microbatches
            hops = _Wire(group, sid, stages, n_micro,
                         (B // n_micro, S, cfg.d_model), cfg.cdtype, inner)
            nll, cnt = _schedule(cfg, run, stages, n_micro, [stage], hops,
                                 batch, place_in)
            grads = stage.grads()
            # the shared leaves' partial sums over the stages; each
            # layer's gradient stays on its stage
            for k in grads:
                if not _is_block((k,)):
                    grads[k] = cross_pod_reduce(grads[k], group, "none")
            if nll is None:
                nll = torch.zeros((), dtype=torch.float32,
                                  device=cnt.device)
            metrics = _metrics(cross_pod_reduce(nll, group, "none"), cnt)
            if donate:
                # the region's leaves are views of the state's local
                # tensors: the update writes the state itself
                donated_update_(optimizer, grads, st)
                return state, metrics
            new_params, new_opt = optimizer.update(
                grads, st["opt"], st["params"], st["step"])
            new = {"params": tree_zip(lambda x, s: place(x, s.placements),
                                      new_params, region),
                   "opt": new_opt, "step": st["step"] + 1}
        return tree_zip(_out_of_region, new, shardings), metrics

    return step, shardings


def _out_of_region(x: DTensor, s: Sharding) -> DTensor:
    """A region DTensor as one on the whole mesh at ``s``'s placements
    (each pod's slice under ``Shard(0)`` over "pod", the same values
    under ``Replicate()``), its local shard as it is."""
    return DTensor.from_local(x.to_local(), s.mesh, s.placements,
                              run_check=False)
