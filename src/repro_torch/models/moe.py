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
kernel.  ``apply_moe_ep`` (expert parallelism over the data axis) is a
``shard_map`` in the JAX package; without a mesh it takes the grouped
path, and so it always does here: the port's placements
(``sharding/rules.py``) do not reach the MoE layer yet, and the
expert-parallel form is not ported.

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

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import normal_param, param

#: the profiler ranges of a group's dispatch, expert products and combine
MOE_RANGES = ("moe_dispatch", "moe_experts", "moe_combine")

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
    """The data-parallel ranks the tokens are split over: 1 until the
    port has a mesh."""
    return 1


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


# ---------------------------------------------------------------------------
# Einsum (t5x-style) dispatch — baseline
# ---------------------------------------------------------------------------


def _moe_group_einsum(cfg: ModelConfig, p, x_g: torch.Tensor, C: int):
    """x_g (G, T, d) -> (y (G, T, d) in the compute dtype, lb, z)."""
    dt = cfg.cdtype
    with record_function(MOE_RANGES[0]):
        gate, idx, mask, lb, z = route(cfg, p, x_g.to(torch.float32))
        pos = _positions_in_expert(mask)                      # (G,T,k)
        keep = (pos < C).to(torch.float32)
        slots = torch.arange(C, dtype=pos.dtype, device=pos.device)
        pos_oh = (pos[..., None] == slots).to(torch.float32) \
            * keep[..., None]
        dispatch = torch.einsum("gtke,gtkc->gtec", mask, pos_oh).to(dt)
        # the gate folded into the expert one-hot: one nonzero term per
        # (t, e), so the values are the JAX three-operand einsum's exactly
        combine = torch.einsum("gtke,gtkc->gtec", mask * gate[..., None],
                               pos_oh).to(dt)
        xe = torch.einsum("gtd,gtec->gecd", x_g.to(dt), dispatch)
    with record_function(MOE_RANGES[1]):
        wg, wu, wd = _experts(p, dt)
        h = F.silu(torch.einsum("gecd,edf->gecf", xe, wg)) \
            * torch.einsum("gecd,edf->gecf", xe, wu)
        ye = torch.einsum("gecf,efd->gecd", h, wd)
    with record_function(MOE_RANGES[2]):
        y = torch.einsum("gecd,gtec->gtd", ye, combine)
    return y, lb, z


# ---------------------------------------------------------------------------
# Sort/scatter dispatch
# ---------------------------------------------------------------------------


def _moe_group_scatter(cfg: ModelConfig, p, x_g: torch.Tensor, C: int):
    """Same contract as ``_moe_group_einsum``, routed by index copies:
    no (T, E, C) one-hot products.  One group at a time, where the JAX
    package maps over them."""
    m = cfg.moe
    dt = cfg.cdtype
    G, T, d = x_g.shape
    E, K = m.num_experts, m.top_k
    gate, idx, mask, lb, z = route(cfg, p, x_g.to(torch.float32))
    pos = _positions_in_expert(mask)                          # (G,T,K)
    keep = pos < C
    wg, wu, wd = _experts(p, dt)
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


_GROUP_FNS = {"einsum": _moe_group_einsum, "scatter": _moe_group_scatter}


# ---------------------------------------------------------------------------
# Expert-parallel path
# ---------------------------------------------------------------------------


def apply_moe_ep(cfg: ModelConfig, p, x: torch.Tensor):
    """The JAX package's expert-parallel MoE (experts over the data
    axis, an all-to-all each way) is a ``shard_map`` over a mesh; with no
    mesh it takes the grouped path.  The port has no mesh yet, so this
    is the grouped path; the expert-parallel form waits for the port's
    sharding."""
    return _apply_moe_grouped(cfg, p, x)


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
        hs = F.silu(xd @ sp["gate"].to(dt)) * (xd @ sp["up"].to(dt))
        y = y + hs @ sp["down"].to(dt)

    aux = {
        "lb_loss": m.router_aux_weight * lb,
        "z_loss": m.router_z_weight * z,
    }
    return y, aux


def _apply_moe_grouped(cfg: ModelConfig, p, x: torch.Tensor):
    """The tokens as ``n_iter`` groups of ``g_eff`` rows each, lb and z
    averaged over the groups; one group of every token when the group
    size does not divide them."""
    m = cfg.moe
    B, S, d = x.shape
    N = B * S
    dp = _dp_size()
    xf = x.reshape(N, d)
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
    xg = xf.reshape(dp_g, n_iter, g_eff, d)

    if n_iter == 1:
        y, lb, z = group_fn(cfg, p, xg[:, 0], C)
        y = y[:, None]
    else:
        lb = z = 0.0
        ys = []
        for i in range(n_iter):
            y_it, lb_it, z_it = group_fn(cfg, p, xg[:, i], C)
            lb, z = lb + lb_it, z + z_it
            ys.append(y_it)
        lb, z = lb / n_iter, z / n_iter
        y = torch.stack(ys, dim=1)   # (dp_g, n_iter, g_eff, d)

    return y.reshape(B, S, d), lb, z
