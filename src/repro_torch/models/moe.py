"""Mixture-of-Experts with capacity-based top-k routing.

The JAX package's ``models/moe.py`` on one card, op for op.  Tokens are
cut into groups; within a group each token picks its top-k experts from
an f32 softmax router, gates normalised to sum to one, and each expert
takes at most C = ceil4(max(4, T·k·cf / E)) (token, expert) assignments
in token-major order: an assignment past its expert's C is dropped and
adds nothing to its token's output.  Aux losses: the switch load-balance
term and the router z-loss.

Two dispatches compute the same function:

* ``einsum`` (the default): one-hot dispatch and combine tensors of
  (G, T, E, C), rounded to the compute dtype as in the JAX package
  (``dispatch`` exactly, ``combine`` with the gate in it), and batched
  expert products;
* ``scatter``: each kept assignment copied into its expert's slot and
  the outputs gathered back, weighted by the gate.

The groups run as a Python loop where the JAX package scans.  The expert
products, the einsums and the router stay ``torch.einsum`` /
``torch.matmul``: the JAX package computes them outside any Pallas
kernel.

Under rules (``sharding/rules.py``) the grouped path cuts the tokens
into ``_dp_size()`` shard-local runs of groups, as the JAX package
does, and its nine ``shard`` sites place the group input, the dispatch
and combine tensors, the expert inputs and outputs and the layer's
output.  On DTensors a group's routing (the router, the stable top-k,
the one-hots, the queue positions and, for the einsum dispatch, the
dispatch and combine tensors) runs on each rank's own groups through
``local_map`` (``_on_group_shards``): routing never crosses a group,
and the card's torch has no DTensor rule for some of its ops (cumsum's
backward among them).  lb and z leave that region as partial sums of
the ranks' means.

``apply_moe_ep`` is the JAX package's expert-parallel path (a
``shard_map`` there, one ``local_map`` region here): experts over
"data", their d_model over "model", each (data, model) rank routing its
own tokens, an all-to-all each way over "data" and the hidden sum over
"model" before the SiLU as autograd-aware collectives on the mesh's
sub-groups (``_AllToAll``, ``torch.distributed.nn.functional``'s
all-reduce).  It takes the grouped path where the JAX package does.
``MOE_CALLS`` counts the layer calls of each path; ``record_drops``
collects each call's dropped assignments.

Each group's work runs inside three profiler ranges, ``moe_dispatch``
(routing, the dispatch and combine tensors, the tokens' copy into the
expert slots), ``moe_experts`` (the expert products) and ``moe_combine``
(the outputs back to the tokens), so a trace splits the layer's device
time the way its cost splits (``MOE_RANGES``).

The router is f32 in every schema (``pinned``), whatever the config's
dtypes, as the JAX package declares it; the experts are matrices in the
compute dtype for serving and in the parameter dtype for training
(``models/model.py::train_schema``), each cast at its use.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.local import keep_shards, split_grads
from repro_torch.models.params import normal_param, param
from repro_torch.sharding.rules import (
    P,
    current_rules,
    einsum,
    mesh_shape,
    mm,
    place,
    replicate_dims,
    shard,
    spec_placements,
    view_rows,
)

#: the profiler ranges of a group's dispatch, expert products and combine
MOE_RANGES = ("moe_dispatch", "moe_experts", "moe_combine")

#: MoE layer calls by the path they took (a rematerialised layer counts
#: again in the backward)
MOE_CALLS = {"grouped": 0, "ep": 0}

_drop_log: list | None = None


@contextlib.contextmanager
def record_drops():
    """While active, every MoE layer call appends ``(path, dropped)`` to
    the list it yields: ``dropped`` the (token, expert) assignments this
    rank's routing dropped, a tensor on the tokens' device (the layer's
    groups on one device, the rank's own groups or tokens on a mesh)."""
    global _drop_log
    prev, _drop_log = _drop_log, []
    try:
        yield _drop_log
    finally:
        _drop_log = prev


def _note_drops(path: str, keep: torch.Tensor) -> None:
    if _drop_log is not None:
        _drop_log.append((path, torch.sum(~keep).detach()))

# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def moe_schema(cfg: ModelConfig):
    m = cfg.moe
    if m is None:
        raise ValueError(f"{cfg.name}: a moe layer needs cfg.moe")
    d, f, E = cfg.d_model, m.d_ff, m.num_experts
    cd = cfg.cdtype
    if m.ep_over_dp:
        up_axes = ("experts_ep", "ep_embed", None)
        down_axes = ("experts_ep", None, "ep_embed")
    else:
        up_axes = ("experts", "embed", "mlp")
        down_axes = ("experts", "mlp", "embed")
    s = {
        "router": normal_param((d, E), ("embed", "experts"), 0.02,
                               torch.float32, pinned=True),
        "w_gate": param((E, d, f), up_axes, cd),
        "w_up": param((E, d, f), up_axes, cd),
        "w_down": param((E, f, d), down_axes, cd),
    }
    if m.num_shared_experts:
        fs = m.num_shared_experts * f
        s["shared"] = {
            "gate": param((d, fs), ("embed", "mlp"), cd),
            "up": param((d, fs), ("embed", "mlp"), cd),
            "down": param((fs, d), ("mlp", "embed"), cd),
        }
    return s


def expert_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.num_experts)
    c = max(4, c)
    return (c + 3) // 4 * 4


def _dp_size() -> int:
    """The data-parallel ranks the tokens are split over: the rules'
    ("pod", "data") size, 1 without rules."""
    rules = current_rules()
    if rules is None:
        return 1
    return rules.mesh_axis_size(("pod", "data"))


# ---------------------------------------------------------------------------
# Routing (shared by both dispatch paths)
# ---------------------------------------------------------------------------


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    ties to the lower index (a stable sort; ``torch.topk`` promises no
    order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, p, x_f32: torch.Tensor):
    """x (..., T, d) f32 -> (gate (...,T,k), idx (...,T,k), mask
    (...,T,k,E), lb, z)."""
    m = cfg.moe
    logits = x_f32 @ p["router"].to(torch.float32)           # (...,T,E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, m.top_k)                        # (...,T,k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    mask = F.one_hot(idx, m.num_experts).to(torch.float32)    # (...,T,k,E)
    f_e = torch.mean(torch.sum(mask, dim=-2), dim=-2)         # (...,E)
    p_e = torch.mean(probs, dim=-2)                           # (...,E)
    lb = m.num_experts * torch.mean(torch.sum(f_e / m.top_k * p_e, dim=-1))
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return gate, idx, mask, lb, z


def _positions_in_expert(mask: torch.Tensor) -> torch.Tensor:
    """mask (..., T, k, E) one-hot -> position of each (t, k) within its
    expert's queue, token-major priority, as f32.  Returns (..., T, k).

    The count before each assignment is a cumulative sum along the
    (T·k) axis, taken on the transposed mask, where that axis is the
    contiguous one: PyTorch's scan along an outer axis took 1.37 ms a
    call at Jamba's (8192, 16) and 17.6 ms at DeepSeek-V2's (49152, 160)
    on an H100 (more than the layer's experts).  The counts are
    integers below 2^24, so the f32 values equal the JAX package's
    (``jnp.cumsum`` along axis -2) bit for bit in any order."""
    shp = mask.shape
    T, K, E = shp[-3], shp[-2], shp[-1]
    flat = mask.reshape(*shp[:-3], T * K, E)
    by_expert = flat.transpose(-1, -2).contiguous()           # (..., E, T*K)
    before = torch.cumsum(by_expert, dim=-1) - by_expert      # count before
    pos = torch.sum(before.transpose(-1, -2) * flat, dim=-1)  # (..., T*K)
    return pos.reshape(*shp[:-3], T, K)


def _experts(p, dt):
    return p["w_gate"].to(dt), p["w_up"].to(dt), p["w_down"].to(dt)


def _on_group_shards(fn, n_rows: int, x_g: torch.Tensor, *rest):
    """``fn(x_g, *rest) -> (*rows, lb, z)`` for x_g (G, T, d): a plain
    call on plain tensors.  On a DTensor, one ``local_map`` region over
    x_g's group shards (its dim 0; any other placement of it gathered)
    with ``rest`` replicated: the ``n_rows`` row outputs come back
    sharded as x_g, and lb and z, each rank's mean over its groups, as
    partial sums over the group shards (each local mean divided by their
    number), so that their value is the mean over every group.  A
    replicated input's gradient is partial over the group shards."""
    if not isinstance(x_g, DTensor):
        return fn(x_g, *rest)
    mesh = x_g.device_mesh
    xp = keep_shards(x_g, (0,))
    rep = (Replicate(),) * mesh.ndim
    parts = 1
    for j, pl in enumerate(xp):
        if isinstance(pl, Shard):
            parts *= mesh.size(j)
    mean = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                 for pl in xp)

    def local(xl, *rl):
        *rows, lb, z = fn(xl, *rl)
        return (*rows, lb / parts, z / parts)

    n = len(rest)
    return local_map(local, out_placements=(*(xp,) * n_rows, mean, mean),
                     in_placements=(xp, *(rep,) * n),
                     in_grad_placements=(xp, *(split_grads(rep, xp),) * n),
                     device_mesh=mesh)(
        place(x_g, xp), *(place(t, rep, mesh) for t in rest))


# ---------------------------------------------------------------------------
# Einsum (t5x-style) dispatch — baseline
# ---------------------------------------------------------------------------


def _einsum_routing(cfg: ModelConfig, C: int, x_g, router):
    """x_g (G, T, d) -> (dispatch, combine (G, T, E, C) in the compute
    dtype, lb, z)."""
    dt = cfg.cdtype
    gate, idx, mask, lb, z = route(cfg, {"router": router},
                                   x_g.to(torch.float32))
    pos = _positions_in_expert(mask)                          # (G,T,k)
    keep = pos < C
    _note_drops("grouped", keep)
    slots = torch.arange(C, dtype=pos.dtype, device=pos.device)
    pos_oh = (pos[..., None] == slots).to(torch.float32) \
        * keep.to(torch.float32)[..., None]
    dispatch = torch.einsum("gtke,gtkc->gtec", mask, pos_oh).to(dt)
    # the gate folded into the expert one-hot: one nonzero term per
    # (t, e), so the values are the JAX three-operand einsum's exactly
    combine = torch.einsum("gtke,gtkc->gtec", mask * gate[..., None],
                           pos_oh).to(dt)
    return dispatch, combine, lb, z


def _moe_group_einsum(cfg: ModelConfig, p, x_g: torch.Tensor, C: int):
    """x_g (G, T, d) -> (y (G, T, d) in the compute dtype, lb, z).  On
    DTensors each product runs on local shards (``einsum``): G over
    the batch axes and E where the rules place the experts, the expert
    weights gathered along the rest (the JAX package's FSDP gather)."""
    dt = cfg.cdtype
    with record_function(MOE_RANGES[0]):
        dispatch, combine, lb, z = _on_group_shards(
            functools.partial(_einsum_routing, cfg, C), 2, x_g, p["router"])
        dispatch = shard(dispatch, "batch", None, "experts", None)
        combine = shard(combine, "batch", None, "experts", None)
        xe = einsum("gtd,gtec->gecd", x_g.to(dt), dispatch)
        xe = shard(xe, "batch", "experts", None, None)
    with record_function(MOE_RANGES[1]):
        wg, wu, wd = _experts(p, dt)
        h = F.silu(einsum("gecd,edf->gecf", xe, wg)) \
            * einsum("gecd,edf->gecf", xe, wu)
        ye = einsum("gecf,efd->gecd", h, wd)
        ye = shard(ye, "batch", "experts", None, None)
    with record_function(MOE_RANGES[2]):
        y = einsum("gecd,gtec->gtd", ye, combine)
        y = shard(y, "batch", None, None)
    return y, lb, z


# ---------------------------------------------------------------------------
# Sort/scatter dispatch
# ---------------------------------------------------------------------------


def _scatter_groups(cfg: ModelConfig, C: int, x_g, router, w_gate, w_up,
                    w_down):
    m = cfg.moe
    dt = cfg.cdtype
    G, T, d = x_g.shape
    E, K = m.num_experts, m.top_k
    gate, idx, mask, lb, z = route(cfg, {"router": router},
                                   x_g.to(torch.float32))
    pos = _positions_in_expert(mask)                          # (G,T,K)
    keep = pos < C
    _note_drops("grouped", keep)
    wg, wu, wd = w_gate.to(dt), w_up.to(dt), w_down.to(dt)
    dev = x_g.device
    src = torch.arange(T, device=dev).repeat_interleave(K)
    ys = []
    for g in range(G):
        # dropped assignments all go to the spare row E·C, then cut
        slot = torch.where(keep[g], idx[g] * C + pos[g].long(),
                           E * C).reshape(T * K)
        buf = torch.zeros((E * C + 1, d), dtype=dt, device=dev)
        buf[slot] = x_g[g].to(dt)[src]
        xe = buf[: E * C].reshape(E, C, d)
        h = F.silu(torch.einsum("ecd,edf->ecf", xe, wg)) \
            * torch.einsum("ecd,edf->ecf", xe, wu)
        ye = torch.einsum("ecf,efd->ecd", h, wd).reshape(E * C, d)
        gath = ye[torch.clamp(slot, 0, E * C - 1)] \
            * keep[g].reshape(T * K, 1).to(dt)
        w = gate[g].reshape(T * K, 1).to(dt)
        ys.append(torch.zeros((T, d), dtype=dt, device=dev)
                  .index_add(0, src, gath * w))
    return torch.stack(ys), lb, z


def _moe_group_scatter(cfg: ModelConfig, p, x_g: torch.Tensor, C: int):
    """Same contract as ``_moe_group_einsum``, routed by index copies:
    no (T, E, C) one-hot products.  One group at a time, where the JAX
    package maps over them; on DTensors each rank's groups in one region
    with the experts gathered, as the JAX package's map places nothing."""
    return _on_group_shards(functools.partial(_scatter_groups, cfg, C), 1,
                            x_g, p["router"], p["w_gate"], p["w_up"],
                            p["w_down"])


_GROUP_FNS = {"einsum": _moe_group_einsum, "scatter": _moe_group_scatter}


# ---------------------------------------------------------------------------
# Expert-parallel path
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """t (n, ...) with block i sent to rank i of ``group``; block i of
    the result came from rank i.  The backward is the same exchange of
    the gradient, which sends each block's gradient back to its sender.
    c10d's ``all_to_all_single``, which gloo's CPU ranks run as an
    all-to-all (the functional collective falls back to an all-gather
    there)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


def apply_moe_ep(cfg: ModelConfig, p, x: torch.Tensor):
    """EP over "data" with TP over "model": the JAX package's
    ``shard_map`` as one ``local_map`` region over the rules' mesh.

    Per (data, model) rank: route the rank's Tl = N / (pods·data) tokens
    (capacity C from Tl), put its d/tp slice of each kept assignment in
    its expert's slot of an (E·C, d/tp) buffer, all-to-all the buffer
    over "data" to the experts' owners, the expert products against the
    E→data, d→model weight shards with the hidden summed over "model"
    before the SiLU, the down product, the reverse all-to-all, and each
    kept slot back to its token times its gate.  The collectives are
    autograd-aware: the all-to-all's backward is the reverse exchange,
    the all-reduce's a sum (the psum's transpose).  The d-slices leave
    the region sharded over "model" and are gathered by a DTensor
    redistribution (the JAX body's all-gather; its backward a slice),
    and lb and z as partial sums of each rank's value over the mesh's
    size (the JAX body's pmean over the batch axes: the model ranks hold
    the same value).  Gradients: the tokens' are partial over "model"
    (each model rank's share comes through its own d-slice), the
    router's over every axis (each rank routes its own tokens), the
    experts' over "pod".

    Takes the grouped path where the JAX package does: no rules, no
    "data" axis, or E, N or d indivisible by the mesh.  Under rules
    the tokens must be a DTensor on the rules' mesh, which names a
    "model" axis, as the JAX package's specs do."""
    m = cfg.moe
    rules = current_rules()
    shape = mesh_shape(rules.mesh) if rules is not None else {}
    if "data" not in shape or m.num_experts % shape["data"]:
        return _apply_moe_grouped(cfg, p, x)
    dp, tp, pods = shape["data"], shape["model"], shape.get("pod", 1)
    E, K = m.num_experts, m.top_k
    B, S, d = x.shape
    N = B * S
    if N % (dp * pods) or d % tp:
        return _apply_moe_grouped(cfg, p, x)
    if not isinstance(x, DTensor):
        raise TypeError("apply_moe_ep: under rules the tokens must be a "
                        "DTensor on the rules' mesh")
    MOE_CALLS["ep"] += 1
    mesh, dt = x.device_mesh, cfg.cdtype
    Tl = N // (dp * pods)
    C = expert_capacity(Tl, cfg)
    El, dl = E // dp, d // tp
    batch = ("pod", "data") if pods > 1 else ("data",)
    names = tuple(shape)

    def spec(*parts):
        return spec_placements(mesh, P(*parts))

    xp, rep = spec(batch, None), spec()
    up, downp = spec("data", "model", None), spec("data", None, "model")
    yp = spec(batch, "model")
    part = (Partial(),) * mesh.ndim
    x_grad = tuple(Partial() if a == "model" else q
                   for a, q in zip(names, xp))

    def w_grad(pl):
        return tuple(Partial() if a == "pod" else q
                     for a, q in zip(names, pl))

    data_group, tp_group = mesh.get_group("data"), mesh.get_group("model")
    j = mesh.get_local_rank("model")
    n_ranks = mesh.size()

    def psum(t):
        return dist_fn.all_reduce(t, group=tp_group)

    def body(xl, router, wg, wu, wd):
        # xl (Tl, d); wg/wu (El, dl, f); wd (El, f, dl)
        with record_function(MOE_RANGES[0]):
            gate, idx, mask, lb, z = route(cfg, {"router": router},
                                           xl.to(torch.float32))
            pos = _positions_in_expert(mask)                  # (Tl, K)
            keep = pos < C
            _note_drops("ep", keep)
            slot = torch.where(keep, idx * C + pos.long(),
                               E * C).reshape(Tl * K)
            # each token's d-slice once per choice: (Tl·K, dl), token-major
            xsl = xl.to(dt)[:, j * dl:(j + 1) * dl]
            rows = xsl[:, None].expand(Tl, K, dl).reshape(Tl * K, dl)
            buf = xsl.new_zeros((E * C + 1, dl)).index_put((slot,), rows)
            # token-major -> expert-major over the same ranks
            xe = _AllToAll.apply(buf[:E * C].reshape(dp, El * C, dl),
                                 data_group)
            xe = xe.reshape(dp, El, C, dl).transpose(0, 1) \
                .reshape(El, dp * C, dl)
        with record_function(MOE_RANGES[1]):
            # the contraction over d is split over "model"
            hg = psum(torch.einsum("ead,edf->eaf", xe, wg.to(dt)))
            hu = psum(torch.einsum("ead,edf->eaf", xe, wu.to(dt)))
            ye = torch.einsum("eaf,efd->ead", F.silu(hg) * hu, wd.to(dt))
        with record_function(MOE_RANGES[2]):
            back = ye.reshape(El, dp, C, dl).transpose(0, 1) \
                .reshape(dp, El * C, dl)
            back = _AllToAll.apply(back, data_group).reshape(E * C, dl)
            gath = back[torch.clamp(slot, 0, E * C - 1)] \
                * keep.reshape(Tl * K, 1).to(dt)
            w = gate.reshape(Tl * K, 1).to(dt)
            # a token's K gated outputs summed in one reduction (the
            # JAX package's scatter-add onto its row): an index_add's
            # atomics would sum them in another order on every run
            y = (gath * w).reshape(Tl, K, dl).sum(1)
        return y, lb / n_ranks, z / n_ranks

    y, lb, z = local_map(
        body, out_placements=(yp, part, part),
        in_placements=(xp, rep, up, up, downp),
        in_grad_placements=(x_grad, part, w_grad(up), w_grad(up),
                            w_grad(downp)),
        device_mesh=mesh,
    )(place(_flat_tokens(x), xp), place(p["router"], rep, mesh),
      place(p["w_gate"], up, mesh), place(p["w_up"], up, mesh),
      place(p["w_down"], downp, mesh))
    return _as_tokens(place(y, xp), B, S), lb, z


def _flat_tokens(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) as (B·S, d), on each rank's rows (``view_rows``); a
    DTensor's sequence gathered first, as both paths replicate the
    tokens over "model"."""
    B, S, d = x.shape
    return view_rows(replicate_dims(x, 1), B * S, d)


def _as_tokens(y: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """y (..., d) over the B·S tokens as (B, S, d), on each rank's rows
    (``view_rows``).  A DTensor is placed first as the rules place the
    batch of (B, S, d): its group or token shards may outnumber B (16
    rows over ("pod", "data") = 32)."""
    d = y.shape[-1]
    rules = current_rules()
    if isinstance(y, DTensor) and rules is not None:
        want = rules.placements(("batch", "seq", "d_model"), (B, S, d))
        y = place(y, tuple(q if q == Shard(0) else Replicate()
                           for q in want))
    return view_rows(y, B, S, d)


# ---------------------------------------------------------------------------
# Top-level MoE layer
# ---------------------------------------------------------------------------


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d), {"lb_loss", "z_loss"})."""
    m = cfg.moe
    if m.ep_over_dp:
        y, lb, z = apply_moe_ep(cfg, p, x)
    else:
        y, lb, z = _apply_moe_grouped(cfg, p, x)

    if m.num_shared_experts:
        dt = cfg.cdtype
        sp = p["shared"]
        xd = x.to(dt)
        hs = F.silu(mm(xd, sp["gate"].to(dt))) * mm(xd, sp["up"].to(dt))
        hs = shard(hs, "batch", None, "mlp")
        y = y + mm(hs, sp["down"].to(dt))

    aux = {
        "lb_loss": m.router_aux_weight * lb,
        "z_loss": m.router_z_weight * z,
    }
    return y, aux


def _apply_moe_grouped(cfg: ModelConfig, p, x: torch.Tensor):
    """The tokens as ``dp_g`` shard-local runs of ``n_iter`` groups of
    ``g_eff`` rows each, lb and z averaged over the groups; one group of
    every shard's tokens when the group size does not divide them."""
    MOE_CALLS["grouped"] += 1
    m = cfg.moe
    B, S, d = x.shape
    N = B * S
    dp = _dp_size()
    xf = _flat_tokens(x)
    group_fn = _GROUP_FNS[m.dispatch]

    if N % dp or (N // dp) < 4:
        dp_g = 1
    else:
        dp_g = dp
    per_shard = N // dp_g
    g_eff = min(m.group_size, per_shard)
    n_iter = per_shard // g_eff
    if per_shard % g_eff:
        n_iter, g_eff = 1, per_shard
    C = expert_capacity(g_eff, cfg)

    # (N, d) -> (dp_g, n_iter, g_eff, d): shard-local contiguous rows
    xg = view_rows(xf, dp_g, n_iter, g_eff, d)
    xg = shard(xg, "batch", None, None, None)

    if n_iter == 1:
        y, lb, z = group_fn(cfg, p, xg[:, 0], C)
        y = y[:, None]
    else:
        # the JAX package's scan input: the runs' i-th groups stacked
        xs = shard(xg.movedim(1, 0), None, "batch", None, None)
        ys = []
        for i in range(n_iter):
            y_it, lb_it, z_it = group_fn(cfg, p, xs[i], C)
            lb, z = (lb_it, z_it) if i == 0 else (lb + lb_it, z + z_it)
            ys.append(y_it)
        lb, z = lb / n_iter, z / n_iter
        y = torch.stack(ys, dim=1)   # (dp_g, n_iter, g_eff, d)

    return shard(_as_tokens(y, B, S), "batch", None, "d_model"), lb, z
