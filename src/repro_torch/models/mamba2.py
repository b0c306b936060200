"""Mamba-2 mixer via SSD (state-space duality).

The JAX package's ``models/mamba2.py`` on one card.  Prefill uses the
chunked SSD algorithm (arXiv:2405.21060 §6): the sequence is cut into
chunks of Q tokens; within a chunk the recurrence is computed in
attention form, across chunks a short Python loop carries the (H, N, P)
state.  Decode is the O(1) recurrent update, as torch ops.

Where the JAX package computes the intra-chunk y and the chunk states
with einsums over B and C repeated to every head, the port calls
``kernels/ssd/ops.py::ssd_chunk`` (the Hopper kernel on the card, the
plain version on the CPU) on views: the model's (B, nc, Q, H, ·) tensors
as (B·nc, H, Q, ·), and B and C of one group as a stride-0 head axis,
so nothing is repeated in memory.  The plain version keeps the chunk
states in f32 where the JAX package rounds ``B·to_end`` to the compute
dtype first (``mamba2.py:200``); in f32 the two are the same.

Projections are split per stream (z/x/B/C/dt) as in the JAX package;
the depthwise causal conv is written as width-4 shifted adds.  The
gated norm ``rms_norm(y·silu(z))`` is the port's ``layers.rms_norm``: no
TPU kernel computes it.  Caches are filled and updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.local import keep_shards, run_local, split_grads
from repro_torch.kernels.ssd.ops import ssd_chunk
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import (
    a_log_param,
    dt_bias_param,
    normal_param,
    param,
    scale_param,
    zeros_param,
)
from repro_torch.sharding.rules import einsum, local_along, mm, place, shard


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    if s is None:
        raise ValueError(f"{cfg.name}: a mamba layer needs cfg.ssm")
    d_in = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    return s, d_in, H, s.n_groups, s.d_state, s.head_dim


def mamba_schema(cfg: ModelConfig):
    """The JAX package's schema for serving.  Leaves the JAX package
    casts to the compute dtype at every use (``CAST_AT_USE``) are stored
    in it; ``A_log`` and ``dt_bias`` (used in f32) and the norm scale in
    the parameter dtype.  The mixer casts each leaf at its use, as the
    JAX package does, so it also takes the training schema's leaves, all
    in the parameter dtype (``models/model.py::train_schema``)."""
    s, d_in, H, G, N, P = _dims(cfg)
    d = cfg.d_model
    pd, cd = cfg.pdtype, cfg.cdtype
    return {
        "wz": param((d, d_in), ("embed", "ssm_inner"), cd),
        "wx": param((d, d_in), ("embed", "ssm_inner"), cd),
        "wb": param((d, G * N), ("embed", None), cd),
        "wc": param((d, G * N), ("embed", None), cd),
        "wdt": param((d, H), ("embed", "ssm_heads"), cd),
        "conv_x": normal_param((s.d_conv, d_in), ("conv_w", "ssm_inner"),
                               0.1, cd),
        "conv_b": normal_param((s.d_conv, G * N), ("conv_w", None), 0.1, cd),
        "conv_c": normal_param((s.d_conv, G * N), ("conv_w", None), 0.1, cd),
        "conv_x_bias": zeros_param((d_in,), ("ssm_inner",), cd),
        "conv_b_bias": zeros_param((G * N,), (None,), cd),
        "conv_c_bias": zeros_param((G * N,), (None,), cd),
        "A_log": a_log_param((H,), ("ssm_heads",), pd),
        "D": scale_param((H,), ("ssm_heads",), cd),
        "dt_bias": dt_bias_param((H,), ("ssm_heads",), s.dt_min, s.dt_max,
                                 pd),
        "norm": scale_param((d_in,), ("ssm_inner",), pd),
        "out": param((d_in, d), ("ssm_inner", "embed"), cd),
    }


def mamba_cache_schema(cfg: ModelConfig, batch: int):
    """The raw pre-conv tails in the compute dtype and the f32 state: a
    size independent of the sequence."""
    s, d_in, H, G, N, P = _dims(cfg)
    cw = s.d_conv - 1
    return {
        "conv_x": zeros_param((batch, cw, d_in),
                              ("batch", "conv_w", "ssm_inner"), cfg.cdtype),
        "conv_b": zeros_param((batch, cw, G * N), ("batch", "conv_w", None),
                              cfg.cdtype),
        "conv_c": zeros_param((batch, cw, G * N), ("batch", "conv_w", None),
                              cfg.cdtype),
        "state": zeros_param((batch, H, N, P),
                             ("batch", "ssm_heads", "ssm_state", None),
                             torch.float32),
    }


#: the leaves the JAX package casts to the compute dtype at every use
#: (``A_log``, ``dt_bias`` and the norm scale are used in f32)
CAST_AT_USE = ("wz", "wx", "wb", "wc", "wdt", "conv_x", "conv_b", "conv_c",
               "conv_x_bias", "conv_b_bias", "conv_c_bias", "D", "out")


def _weights(p, dt) -> dict:
    """The ``CAST_AT_USE`` leaves of ``p`` in the compute dtype ``dt``."""
    return {k: p[k].to(dt) for k in CAST_AT_USE}


def _shift(x: torch.Tensor, i: int) -> torch.Tensor:
    """x (B,S,C) moved ``i`` rows later along S, zeros in front.  Along
    S alone, on local shards: the pad's backward gives a wrong shape on
    a DTensor in torch 2.11."""
    S = x.shape[1]
    return local_along(lambda a: F.pad(a, (0, 0, i, 0))[:, :S], x, 1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as shifted adds.  x (B,S,C), w (W,C)."""
    W = w.shape[0]
    out = x * w[-1]
    for i in range(1, W):
        out = out + _shift(x, i) * w[W - 1 - i]
    return out + b


def _conv_step(x_new: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """x_new (B,C); cache (B,W-1,C) previous raw inputs.  Returns the
    conv output and the new window tail."""
    window = torch.cat([cache, x_new[:, None]], dim=1)       # (B,W,C)
    y = torch.einsum("bwc,wc->bc", window, w) + b
    return y, window[:, 1:]


def _tail(a: torch.Tensor, cw: int) -> torch.Tensor:
    """The last ``cw`` rows of a (B,S,C), zero-padded in front when
    S < cw (the conv's zeros before the prompt).  Along S alone, on
    local shards: torch 2.11 fails to redistribute the pad's input on a
    DTensor."""
    return local_along(lambda t: F.pad(t, (0, 0, cw, 0))[:, -cw:], a, 1)


def apply_mamba_full(cfg: ModelConfig, p, x: torch.Tensor, *, cache=None):
    """Prefill mixer.  x (B,S,d) -> (B,S,d) in the compute dtype.  When
    ``cache`` is given, its conv tails and state are written in place."""
    s, d_in, H, G, N, P = _dims(cfg)
    dt_c = cfg.cdtype
    B_, S, _ = x.shape
    x = x.to(dt_c)
    w = _weights(p, dt_c)
    z = mm(x, w["wz"])
    xs_raw = mm(x, w["wx"])
    b_raw = mm(x, w["wb"])
    c_raw = mm(x, w["wc"])
    dt_in = mm(x, w["wdt"])
    xs = F.silu(_causal_conv(xs_raw, w["conv_x"], w["conv_x_bias"]))
    bs = F.silu(_causal_conv(b_raw, w["conv_b"], w["conv_b_bias"]))
    cs = F.silu(_causal_conv(c_raw, w["conv_c"], w["conv_c_bias"]))
    xs = shard(xs.reshape(B_, S, H, P), "batch", None, "ssm_heads", None)
    bs = bs.reshape(B_, S, G, N)
    cs = cs.reshape(B_, S, G, N)
    dt = F.softplus(dt_in.float() + p["dt_bias"].float())   # (B,S,H)
    A = -torch.exp(p["A_log"].float())                      # (H,)
    dA = dt * A                                             # (B,S,H) <= 0

    y, final_state = ssd_chunked(xs, bs, cs, dt, dA,
                                 chunk=min(s.chunk, S), n_heads=H)
    y = y + xs * w["D"][None, None, :, None]
    y = y.reshape(B_, S, d_in)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = shard(mm(y, w["out"]), "batch", None, "d_model")
    if cache is not None:
        cw = s.d_conv - 1
        cache["conv_x"].copy_(_tail(xs_raw, cw))
        cache["conv_b"].copy_(_tail(b_raw, cw))
        cache["conv_c"].copy_(_tail(c_raw, cw))
        cache["state"].copy_(final_state)
    return out


def _heads(a: torch.Tensor, H: int) -> torch.Tensor:
    """(B, nc, Q, G, N) -> (B·nc, H, Q, N), head h reading group
    h // (H/G): a stride-0 view when G == 1, a repeat otherwise."""
    B_, nc, Q, G, N = a.shape
    a = a.reshape(B_ * nc, Q, G, N).transpose(1, 2)         # (BC,G,Q,N)
    if G == 1:
        return a.expand(B_ * nc, H, Q, N)
    return a.repeat_interleave(H // G, dim=1)


def ssd_chunked(xs, bs, cs, dt, dA, *, chunk: int, n_heads: int):
    """Chunked SSD.  xs (B,S,H,P), bs/cs (B,S,G,N), dt/dA (B,S,H).

    Returns y (B,S,H,P) in xs's dtype and the final state (B,H,N,P)
    f32.  On DTensors the whole of it runs on local shards
    (``_ssd_on_shards``)."""
    if isinstance(xs, DTensor):
        return _ssd_on_shards(xs, bs, cs, dt, dA, chunk=chunk)
    return _ssd_chunked(xs, bs, cs, dt, dA, chunk=chunk, n_heads=n_heads)


def _ssd_on_shards(xs, bs, cs, dt, dA, *, chunk: int):
    """``ssd_chunked`` on (batch, head) shards through ``local_map``,
    the sequence gathered: the chunk views split the sequence and merge
    the batch with the chunks and heads, which torch refuses on sharded
    dims.  B and C follow the heads' shards where their groups split
    with them, else they are replicated there (one group: every head
    reads it); heads whose groups cannot split are gathered.  Counted
    as the SSD kernel's ``local_map`` branch."""
    mesh = xs.device_mesh
    G = bs.shape[2]
    p = keep_shards(xs, (0, 2))                # (B, S, H, P): batch, heads
    batch = tuple(q if q == Shard(0) else Replicate() for q in p)
    heads_m = 1
    for j, q in enumerate(p):
        if q == Shard(2):
            heads_m *= mesh.size(j)
    if G % heads_m == 0:
        pb = p
    elif G == 1:
        pb = batch
    else:
        p = pb = batch
    ph = tuple(Shard(1) if q == Shard(2) else q for q in p)   # (B,H,N,P)
    bg = split_grads(pb, p)

    def fn(xl, bl, cl, dtl, dAl):
        return _ssd_chunked(xl, bl, cl, dtl, dAl, chunk=chunk,
                            n_heads=xl.shape[2])

    args = (place(xs, p), place(bs, pb, mesh), place(cs, pb, mesh),
            place(dt, p, mesh), place(dA, p, mesh))
    return run_local("ssd_chunk", fn, mesh, args, (p, pb, pb, p, p),
                     (p, ph), (p, bg, bg, p, p))


def _ssd_chunked(xs, bs, cs, dt, dA, *, chunk: int, n_heads: int):
    """``ssd_chunked`` on plain tensors."""
    B_, S, H, P = xs.shape
    G, N = bs.shape[2], bs.shape[3]
    if H != n_heads or H % G:
        raise ValueError(f"{H} heads, n_heads={n_heads}, {G} groups")
    pad = (-S) % chunk
    if pad:
        # zero-pad is exact: dA=0 -> decay exp(0)=1, x*dt=0 -> no input
        def zseq(a):
            return local_along(
                lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)), a, 1)
        xs, bs, cs, dt, dA = map(zseq, (xs, bs, cs, dt, dA))
    Sp = S + pad
    nc = Sp // chunk
    Q = chunk
    dt_c = xs.dtype

    xc = xs.reshape(B_, nc, Q, H, P)
    bc = bs.reshape(B_, nc, Q, G, N)
    cc = cs.reshape(B_, nc, Q, G, N)
    dtc = dt.reshape(B_, nc, Q, H)
    dAc = dA.reshape(B_, nc, Q, H)
    # (B,nc,Q,H), along the chunk alone, on local shards: cumsum's
    # backward (a flip) has no DTensor strategy in torch 2.11
    csum = local_along(lambda a: torch.cumsum(a, dim=2), dAc, 2)

    xdt = (xc.float() * dtc[..., None]).to(dt_c)            # (B,nc,Q,H,P)
    # intra-chunk y and chunk states on views: (B·nc, H, Q, ·)
    y_intra, states = ssd_chunk(
        xdt.reshape(B_ * nc, Q, H, P).transpose(1, 2),
        _heads(bc, H), _heads(cc, H),
        csum.reshape(B_ * nc, Q, H).transpose(1, 2))
    y_intra = y_intra.transpose(1, 2).reshape(B_, nc, Q, H, P)
    states = states.reshape(B_, nc, H, N, P)
    chunk_decay = torch.exp(csum[:, :, -1, :])              # (B,nc,H)

    # inter-chunk recurrence: h_c = h_{c-1}·decay_{c-1} + state_{c-1}
    h = torch.zeros((B_, H, N, P), dtype=torch.float32, device=xs.device)
    h_prevs = []
    for i in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    h_prev = torch.stack(h_prevs, dim=1)                    # (B,nc,H,N,P)
    if G > 1:
        cc = cc.repeat_interleave(H // G, dim=3)            # (B,nc,Q,H,N)
    c_in = (cc.float() * torch.exp(csum)[..., None]).to(dt_c)  # (B,nc,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", c_in, h_prev.to(dt_c))
    y = (y_intra + y_inter).reshape(B_, Sp, H, P)
    return (y[:, :S] if pad else y), h


def apply_mamba_decode(cfg: ModelConfig, p, x: torch.Tensor, cache):
    """Decode mixer.  x (B,d) -> (B,d); the O(1) state update in f32.
    ``cache`` is updated in place."""
    s, d_in, H, G, N, P = _dims(cfg)
    dt_c = cfg.cdtype
    B_ = x.shape[0]
    x = x.to(dt_c)
    w = _weights(p, dt_c)
    z = x @ w["wz"]
    x_raw = x @ w["wx"]
    b_raw = x @ w["wb"]
    c_raw = x @ w["wc"]
    dt_in = x @ w["wdt"]
    xs, conv_x = _conv_step(x_raw, cache["conv_x"], w["conv_x"],
                            w["conv_x_bias"])
    bs, conv_b = _conv_step(b_raw, cache["conv_b"], w["conv_b"],
                            w["conv_b_bias"])
    cs, conv_c = _conv_step(c_raw, cache["conv_c"], w["conv_c"],
                            w["conv_c_bias"])
    xs, bs, cs = F.silu(xs), F.silu(bs), F.silu(cs)
    xs = xs.reshape(B_, H, P)
    bs = bs.reshape(B_, G, N).repeat_interleave(H // G, dim=1)  # (B,H,N)
    cs = cs.reshape(B_, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt_in.float() + p["dt_bias"].float())   # (B,H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)                                  # (B,H)
    h = cache["state"]                                      # (B,H,N,P) f32
    upd = torch.einsum("bhn,bhp->bhnp", bs.float(), xs.float() * dt[..., None])
    h = h * dA[..., None, None] + upd
    # on (batch, head) shards: the einsum's bmm would merge the two
    y = einsum("bhn,bhnp->bhp", cs.float(), h).to(dt_c)
    y = y + xs * w["D"][None, :, None]
    y = y.reshape(B_, d_in)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ w["out"]
    cache["conv_x"].copy_(conv_x)
    cache["conv_b"].copy_(conv_b)
    cache["conv_c"].copy_(conv_c)
    cache["state"].copy_(h)
    return out
