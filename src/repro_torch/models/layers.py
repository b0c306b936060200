"""Shared layers: norms, the MLPs, rotary embeddings (M-RoPE too),
sinusoidal positions and the token embeddings.

The JAX package's ``models/layers.py``, op for op, each weight cast to
the compute dtype at its use as there (a no-op for serving's leaves,
stored in it).  The norms are RMSNorm and layernorm (scale and bias;
mean, population variance and ``rsqrt(var + eps)`` in f32).  The MLP
takes all three activations: SwiGLU, squared ReLU (``relu2``, no gate)
and the tanh-approximated GELU.  M-RoPE (Qwen2-VL) drives each section
of the rotary frequencies by its own row of (temporal, height, width)
positions; the JAX package's one-hot einsum picks the section, a gather
here, bitwise the same in f32.  The sinusoidal table (whisper) is built
in numpy as there, so the two packages' tables are bitwise equal.  The
decoder's residual → norm seams of an RMSNorm config do not call
``apply_norm``: they go through the fused kernel
(``kernels/rmsnorm/ops.py``), see ``models/transformer.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import (
    normal_param,
    param,
    scale_param,
    zeros_param,
)
from repro_torch.sharding.rules import (
    local_shape_and_offset,
    mm,
    place,
    shard,
)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_schema(cfg: ModelConfig, d: int | None = None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": scale_param((d,), ("d_model",), cfg.pdtype),
                "bias": zeros_param((d,), ("d_model",), cfg.pdtype)}
    return {"scale": scale_param((d,), ("d_model",), cfg.pdtype)}


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / squared-ReLU / GELU)
# ---------------------------------------------------------------------------


def mlp_schema(cfg: ModelConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = {"down": param((f, d), ("mlp", "embed"), cfg.cdtype),
         "up": param((d, f), ("embed", "mlp"), cfg.cdtype)}
    if cfg.mlp_act == "swiglu":
        s["gate"] = param((d, f), ("embed", "mlp"), cfg.cdtype)
    return s


def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.cdtype
    x = x.to(dt)
    if cfg.mlp_act == "swiglu":
        h = F.silu(mm(x, p["gate"].to(dt))) * mm(x, p["up"].to(dt))
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(mm(x, p["up"].to(dt))))
    else:  # gelu
        h = F.gelu(mm(x, p["up"].to(dt)), approximate="tanh")
    h = shard(h, "batch", *(None,) * (h.ndim - 2), "mlp")
    return mm(h, p["down"].to(dt))


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE) and sinusoidal absolute positions
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    # lint: disable=host-sync -- a real sync, kept: theta, a host float,
    # is copied to the card at every RoPE table (ROADMAP, Host-bound paths)
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2), float32."""
    freqs = rope_freqs(dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, dim: int, theta: float,
                  sections):
    """M-RoPE (Qwen2-VL): positions (B, 3, S) -> cos/sin (B, S, dim/2).
    The rotary frequency indices are split into temporal, height and
    width sections (half-dim units summing to dim/2), each driven by its
    own position row."""
    if sum(sections) != dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"{dim // 2}")
    freqs = rope_freqs(dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs     # (B,3,S,D2)
    ang = mrope_select(ang, sections)                         # (B,S,D2)
    return torch.cos(ang), torch.sin(ang)


def mrope_select(ang: torch.Tensor, sections) -> torch.Tensor:
    """ang (B, 3, S, D2) -> (B, S, D2): frequency j takes the row of its
    section (the JAX package's ``_mrope_select``, a gather in place of
    its one-hot einsum)."""
    # each frequency's section, from arange (no host-to-device copy)
    ar = torch.arange(ang.shape[-1], device=ang.device)
    sel = (ar >= sections[0]).long() + (ar >= sections[0] + sections[1])
    idx = sel.expand(ang.shape[0], 1, ang.shape[2], -1)
    return torch.gather(ang, 1, idx)[:, 0]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); cos/sin broadcastable to (..., S, 1, D/2).

    The llama 'rotate-half' convention: first and second halves of the
    head dim are the pairs."""
    d2 = x.shape[-1] // 2
    xf1 = x[..., :d2].to(torch.float32)
    xf2 = x[..., d2:].to(torch.float32)
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=16)
def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal table (n, d), float32: the JAX
    package's numpy computation, bitwise.  Kept per (n, d, device), so
    a decode step copies nothing to the card; callers must not write to
    it.  Row i is the same for every n > i."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    inv = np.exp(-np.log(10000.0) * dim / max(d // 2 - 1, 1))
    ang = pos * inv
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    # lint: disable=host-sync -- once per (n, d, device): the table is
    # cached (lru_cache), so a decode step copies nothing
    return torch.from_numpy(table.astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_schema(cfg: ModelConfig):
    V, d = cfg.vocab_size, cfg.d_model
    s = {"embed": normal_param((V, d), ("vocab", "d_model"), 0.02,
                               cfg.cdtype)}
    if not cfg.tie_embeddings:
        s["unembed"] = normal_param((d, V), ("d_model", "vocab"), 0.02,
                                    cfg.cdtype)
    return s


def embed_tokens(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    w = p["embed"]
    if isinstance(w, DTensor):
        return _embed_shards(w, tokens).to(cfg.cdtype)
    return w[tokens].to(cfg.cdtype)


def _embed_shards(w: DTensor, tokens: torch.Tensor) -> DTensor:
    """``w[tokens]`` on local shards (``local_map``), as Megatron's
    vocab-parallel embedding: each rank of a mesh dim that shards the
    vocabulary looks up the tokens its rows hold, zeros for the rest,
    and the rows are a sum there (exact: one term is not zero); the
    tokens keep their batch shards elsewhere.  A DTensor index refuses
    tokens sharded over two mesh dims and its backward's ``index_put``
    a sharded table, in torch 2.11."""
    mesh = w.device_mesh
    vocab = {j for j, q in enumerate(w.placements)
             if isinstance(q, Shard) and q.dim % w.ndim == 0}
    wp = tuple(Shard(0) if j in vocab else Replicate()
               for j in range(mesh.ndim))
    tp = tuple(Replicate() if j in vocab or not isinstance(q, Shard) else q
               for j, q in enumerate(tokens.placements)) \
        if isinstance(tokens, DTensor) else (Replicate(),) * mesh.ndim
    out = [Partial() if j in vocab else tp[j] for j in range(mesh.ndim)]
    wg = tuple(wp[j] if j in vocab else
               Partial() if isinstance(tp[j], Shard) else Replicate()
               for j in range(mesh.ndim))
    v0 = local_shape_and_offset(w.shape, mesh, wp)[1][0] if vocab else 0

    def fn(wl, tl):
        if not vocab:
            return wl[tl]
        ids = tl - v0
        inside = (ids >= 0) & (ids < wl.shape[0])
        rows = wl[torch.where(inside, ids, torch.zeros_like(ids))]
        return rows * inside[..., None].to(rows.dtype)

    return local_map(fn, out_placements=out, in_placements=(wp, tp),
                     in_grad_placements=(wg, tp), device_mesh=mesh)(
        place(w, wp), place(tokens, tp, mesh))


def unembed(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x (..., d) -> logits (..., V), fp32."""
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    return mm(x.to(cfg.cdtype), w.to(cfg.cdtype)).to(torch.float32)
