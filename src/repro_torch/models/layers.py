"""Shared layers of the decoder: norms, the MLPs, rotary embeddings and
the token embeddings.

The JAX package's ``models/layers.py`` for the pieces the port's models
use, op for op, each weight cast to the compute dtype at its use as
there (a no-op for serving's leaves, stored in it).  The MLP takes all
three activations: SwiGLU, squared ReLU (``relu2``, no gate) and the
tanh-approximated GELU.  M-RoPE, sinusoidal positions and layernorm
raise ``NotImplementedError``.  The residual → norm seams of the decoder
do not call ``apply_norm``: they go through the fused kernel
(``kernels/rmsnorm/ops.py``), see ``models/transformer.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import normal_param, param, scale_param

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def _rmsnorm_only(cfg: ModelConfig) -> None:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"{cfg.name}: norm {cfg.norm!r}; the port has rmsnorm only")


def norm_schema(cfg: ModelConfig, d: int | None = None):
    _rmsnorm_only(cfg)
    d = d or cfg.d_model
    return {"scale": scale_param((d,), ("d_model",), cfg.pdtype)}


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    _rmsnorm_only(cfg)
    return rms_norm(x, p["scale"], cfg.norm_eps)


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
        h = F.silu(x @ p["gate"].to(dt)) * (x @ p["up"].to(dt))
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(x @ p["up"].to(dt)))
    else:  # gelu
        h = F.gelu(x @ p["up"].to(dt), approximate="tanh")
    return h @ p["down"].to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2), float32."""
    freqs = rope_freqs(dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


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
    return p["embed"][tokens].to(cfg.cdtype)


def unembed(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x (..., d) -> logits (..., V), fp32."""
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    return (x.to(cfg.cdtype) @ w.to(cfg.cdtype)).to(torch.float32)
