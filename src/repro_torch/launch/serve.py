"""Batched serving: prefill, then a decode loop over a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-large-v3 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-vl-72b --smoke --device cpu

The JAX package's ``launch/serve.py`` on one card, for any architecture
the port serves (the decode cache is a KV cache for attention layers and
the O(1) conv tails and SSD state for mamba layers; MoE layers keep no
cache; whisper's cross-attention layers keep the encoder frames'
projected k and v).  The stubbed frontends' inputs are drawn as the JAX
CLI draws them: qwen2-vl's patch embeddings (``embeds``) and its M-RoPE
``positions`` (one ``arange`` on all three rows), whisper's frame
embeddings (``enc_embeds``); decode continues M-RoPE from each
request's largest position + 1.  As in the JAX CLI, ``main`` serves on
``make_host_mesh()`` under ``make_rules(mesh, "serve")``: the weights,
the prompts and each step's inputs are placed as DTensors and the cache
is allocated at its serving placements (``runtime/serve_step.py``).  On
one card, or one CPU process, the host mesh is (1, 1) and every
placement ``Replicate()``; a one-rank group is started for it and
closed at the end of ``main``.  ``serve(..., rules=None)`` runs on plain
tensors.  Weights are drawn on the device from a seeded
``torch.Generator`` there (Jamba's 13.3 B-parameter period in 0.11 s on
an H100), never on the host and copied; prompts and samples come from a
second generator.  ``--device`` defaults to ``cuda`` and
raises without a card; ``--device cpu`` runs the plain versions of the
kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_residual_cuda
from repro_torch.kernels.ssd.kernel import ssd_chunk_cuda
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models.params import init_params
from repro_torch.runtime import serve_step
from repro_torch.runtime.train_step import full_tensor
from repro_torch.sharding.rules import AxisRules, make_rules

KERNELS = {"flash_attention": flash_attention_cuda,
           "rmsnorm_residual": rmsnorm_residual_cuda,
           "ssd_chunk": ssd_chunk_cuda}


def make_params(cfg: ModelConfig, device, seed: int = 0):
    """Random weights for ``cfg`` on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(M.schema(cfg), gen, device)


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int,
                 rng: torch.Generator) -> torch.Tensor:
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=rng, device=rng.device)


def make_inputs(cfg: ModelConfig, batch: int, prompt_len: int,
                rng: torch.Generator) -> dict:
    """The prefill inputs beside the prompt tokens that ``cfg`` takes, as
    the JAX serve CLI makes them: ``embeds`` (B, P, d) and ``enc_embeds``
    (B, frames, d), unit normals rounded to bf16, and M-RoPE
    ``positions`` (B, 3, P), one ``arange`` on all three rows."""
    out = {}
    dev = rng.device

    def normal(*shape):
        return torch.randn(shape, generator=rng, device=dev).to(
            torch.bfloat16)

    if cfg.input_mode == "embeds":
        out["embeds"] = normal(batch, prompt_len, cfg.d_model)
    if cfg.rope_type == "mrope":
        out["positions"] = torch.arange(
            prompt_len, dtype=torch.int32, device=dev).expand(
                batch, 3, prompt_len).contiguous()
    if cfg.cross_attention:
        out["enc_embeds"] = normal(batch, cfg.encoder_frames, cfg.d_model)
    return out


def image_positions(batch: int, text_before: int, grid_h: int, grid_w: int,
                    text_after: int, device=None) -> torch.Tensor:
    """M-RoPE positions (B, 3, S) of a prompt with one image, as
    Qwen2-VL's ``get_rope_index`` lays them out: ``text_before`` text
    tokens at 0, 1, ... on all three rows; the ``grid_h`` × ``grid_w``
    (merged) patches of one frame, the temporal row constant, the height
    row the patch's row and the width row its column, all offset by
    ``text_before``; then ``text_after`` text tokens from the grid's
    largest position + 1.  S = text_before + grid_h·grid_w + text_after;
    the three rows differ on the grid."""
    n = grid_h * grid_w
    t = torch.full((n,), text_before)
    h = text_before + torch.arange(grid_h).repeat_interleave(grid_w)
    w = text_before + torch.arange(grid_w).repeat(grid_h)
    start = text_before + max(grid_h, grid_w)
    rows = [torch.cat([torch.arange(text_before), r,
                       start + torch.arange(text_after)]) for r in (t, h, w)]
    return torch.stack(rows).to(device, torch.int32).expand(
        batch, 3, -1).contiguous()


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor         # (B, gen) sampled ids
    first_logits: torch.Tensor   # (B, V) the prefill's last-token logits
    last_logits: torch.Tensor    # (B, V) the last step's logits
    prefill_s: float
    decode_s: float              # all gen - 1 decode steps
    decode_steps: int
    launches: dict               # {"prefill"|"decode": {kernel: count}},
                                 # the kernels of the config's layers


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def serve(cfg: ModelConfig, params, prompts: torch.Tensor, gen: int, *,
          inputs: dict | None = None, temperature: float = 0.0,
          rng: torch.Generator | None = None,
          rules: AxisRules | None = None) -> ServeResult:
    """Prefill ``prompts`` (B, P) with the other ``inputs`` the config
    takes (``make_inputs``), then ``gen - 1`` decode steps, sampling
    greedily (``temperature <= 0``) or from the tempered softmax with
    ``rng``.  With M-RoPE ``positions`` (B, 3, P), step i of request b
    sits at position max(positions[b]) + 1 + i on all three rows (the
    cache index stays P + i).  With ``rules`` the plain ``params``,
    prompts and inputs (the same on every rank) are placed by the serve
    placements, the timed steps include placing each step's inputs,
    and every rank samples from the gathered logits; the result holds
    plain tensors either way.  Times end in a synchronise."""
    dev = prompts.device
    B, P = prompts.shape
    inputs = dict(inputs or {})
    nxt = None
    if "positions" in inputs:
        nxt = inputs["positions"].amax(dim=(1, 2)) + 1       # (B,)
    prefill = serve_step.build_prefill(cfg, rules, max_seq=P + gen)
    decode = serve_step.build_decode(cfg, rules)
    if rules is not None:
        params = serve_step.place_params(cfg, params, rules)

    def feed(d):
        return d if rules is None else serve_step.place_inputs(d, rules)

    def sample(lg):
        if temperature <= 0:
            return torch.argmax(lg, -1)
        probs = torch.softmax(lg / temperature, -1)
        return torch.multinomial(probs, 1, generator=rng)[:, 0]

    _sync(dev)
    c0 = _counts()
    t0 = time.monotonic()
    logits, cache = prefill(params, feed({"tokens": prompts, **inputs}))
    logits = full_tensor(logits)
    _sync(dev)
    t_prefill = time.monotonic() - t0
    c1 = _counts()
    toks, lg = [sample(logits)], logits
    t0 = time.monotonic()
    for i in range(gen - 1):
        step = {"token": toks[-1], "pos": P + i}
        if nxt is not None:
            step["positions"] = (nxt + i)[:, None].expand(B, 3)
        lg, cache = decode(params, cache, feed(step))
        lg = full_tensor(lg)
        toks.append(sample(lg))
    _sync(dev)
    t_decode = time.monotonic() - t0
    c2 = _counts()
    names = M.launches_per_pass(cfg, "prefill")
    return ServeResult(
        tokens=torch.stack(toks, dim=1), first_logits=logits, last_logits=lg,
        prefill_s=t_prefill, decode_s=t_decode, decode_steps=gen - 1,
        launches={"prefill": {k: c1[k] - c0[k] for k in names},
                  "decode": {k: c2[k] - c1[k] for k in names}},
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    dev = resolve_device(args.device)
    own_group = not dist.is_initialized()
    try:
        rules = make_rules(make_host_mesh(device=dev), "serve")
        params = make_params(cfg, dev, seed=0)
        rng = torch.Generator(device=dev).manual_seed(1)
        prompts = make_prompts(cfg, args.batch, args.prompt_len, rng)
        inputs = make_inputs(cfg, args.batch, args.prompt_len, rng)
        res = serve(cfg, params, prompts, args.gen, inputs=inputs,
                    temperature=args.temperature, rng=rng, rules=rules)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()
    B, steps = args.batch, res.decode_steps
    print(f"[serve] prefill {args.prompt_len} tok × {B}: "
          f"{res.prefill_s:.3f}s")
    print(f"[serve] decode {steps} steps: {res.decode_s:.3f}s "
          f"({steps * B / max(res.decode_s, 1e-9):.1f} tok/s)")
    print("[serve] sample output ids:", res.tokens[0, :12].tolist())
    return res


if __name__ == "__main__":
    main()
