#!/usr/bin/env python3
"""The serving invariant of a MoE model on the card under each form of
the fused residual-add + RMSNorm, and under planted decode faults.

    python3 tools/norm_invariant_probe.py [--arch jamba|deepseek]
            [--baseline FILE.cu] [--seeds N] [--faults]  (on a CUDA card)

Builds the cell of ``chip_smoke.py``'s ``jamba_serve`` (Jamba-v0.1 at
full width, one period of 8 layers, well-conditioned attention weights)
or ``deepseek_serve`` (DeepSeek-V2 at full width, 1 + 3 layers, the
init rule's weights), bf16, 4 requests of 2048 prompt tokens, and
computes its serving invariant as the smoke does
(``chip_smoke._held_invariant``: the full prefill's last logits against
prefill(S-1) + one decode step, with the smoke's near-tie gap for the
arch) with the model's norm taken by: the kernel (``kernel``), its
plain version (``plain``), the plain version with the mean of squares
summed in f64 (``exact_sum``: the rounding nearest the exact norm) and,
with ``--baseline``, an earlier source of the kernel with the
single-shape C entry (``tools/rmsnorm_bench.py``'s).  For each it also
gives ``floor``: per request, max |last logits of the full prefill
under this form - under the plain version|, how far a valid change of
the norm's rounding alone moves the logits on these inputs.

``--seeds N`` repeats all of it for the prompts of N generator seeds,
the first the smoke's.  ``--faults`` then computes the invariant, under
the kernel, with a fault planted at run time (nothing in the repo is
edited): ``norm_decode_scaled_*``, the norm's outputs on the decode
step's rows scaled by 1 + 2^-7 or 1 + 2^-5; ``decode_pos_minus_1``, the
decode step run at position S - 2 (an off-by-one in the step's
position: its RoPE and its cache slot).  Every line is JSON; the card's
``nvidia-smi`` name and power limit come first.  Exits 2 without a
card.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from tools import rmsnorm_bench  # noqa: E402

#: the invariant's fields each line keeps
KEEP = ("max_abs_diff", "max_abs_logit", "requests_held",
        "max_abs_diff_per_request", "argmax_agreement", "experts_turned",
        "left_out_at_near_tie", "dropped_per_layer")


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` is ``value`` inside the block."""
    kept = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, kept)


def last_logits(cfg, params, prompts):
    """The full prefill's last logits in f32."""
    from repro_torch.runtime import serve_step

    full, _, _ = cs._split_inputs(params, prompts, None)
    return serve_step.build_prefill(cfg)(params, full)[0].float()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=("jamba", "deepseek"), default="jamba")
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("norm_invariant_probe: no CUDA device available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tm
    from repro_torch.runtime import serve_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cs.emit({"nvidia_smi": smi, "arch": args.arch})
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    def baseline(lib):
        def norm(x, res, scale, eps=1e-5):
            fn, out, h = rmsnorm_bench.baseline_fn(
                lib, x, res, scale.to(torch.float32))
            fn()
            return out, h
        return norm

    def exact_sum(x, res, scale, eps=1e-5):
        h = x.float() + res.float()
        ms = h.double().square().mean(-1, keepdim=True).float()
        out = h * torch.rsqrt(ms + eps) * scale.float()
        return out.to(x.dtype), h.to(x.dtype)

    forms = {"kernel": ops.rmsnorm_residual,
             "plain": ref.rmsnorm_residual_ref,
             "exact_sum": exact_sum}
    if args.baseline is not None:
        forms["baseline"] = baseline(rmsnorm_bench.baseline_lib(
            args.baseline.resolve(), build))

    B, P = 4, 2048

    def decode_rows_scaled(share):
        def norm(x, res, scale, eps=1e-5):
            out, h = ops.rmsnorm_residual(x, res, scale, eps)
            if x.shape[0] == B:
                out = (out.float() * (1 + share)).to(out.dtype)
            return out, h
        return norm

    build_decode = serve_step.build_decode

    def decode_pos_minus_1(cfg, *a, **k):
        fn = build_decode(cfg, *a, **k)
        return lambda params, cache, step: fn(
            params, cache, {**step, "pos": step["pos"] - 1})

    faults = {
        "norm_decode_scaled_2^-7": lambda: patched(
            tm, "rmsnorm_residual", decode_rows_scaled(2.0 ** -7)),
        "norm_decode_scaled_2^-5": lambda: patched(
            tm, "rmsnorm_residual", decode_rows_scaled(2.0 ** -5)),
        "decode_pos_minus_1": lambda: patched(
            serve_step, "build_decode", decode_pos_minus_1),
    } if args.faults else {}

    if args.arch == "jamba":
        cfg, near_tie = cs._jamba_cut(8, "bfloat16"), cs.ROUTER_NEAR_TIE
    else:
        cfg, near_tie = cs._deepseek_cut(cs.V2, 1, 3, "bfloat16"), 0.0
    params = serve.make_params(cfg, dev, seed=cs.SEED)
    if args.arch == "jamba":
        params = cs.well_conditioned(cfg, params)
        torch.cuda.empty_cache()

    def invariant(prompts):
        inv = cs._held_invariant(cfg, params, prompts, cs.SERVE_INV_TOL,
                                 require=False, near_tie=near_tie)
        return {k: inv[k] for k in KEEP}

    for seed in range(args.seeds):
        prompts = serve.make_prompts(
            cfg, B, P,
            torch.Generator(device=dev).manual_seed(cs.SEED + 1 + seed))
        with patched(tm, "rmsnorm_residual", ref.rmsnorm_residual_ref):
            want = last_logits(cfg, params, prompts)
        for name, fn in forms.items():
            with patched(tm, "rmsnorm_residual", fn):
                inv = invariant(prompts)
                floor = (last_logits(cfg, params, prompts) - want).abs()
            floor = floor.amax(-1).tolist()
            cs.emit({"seed": seed, "norm": name, "invariant": inv,
                     "floor_per_request": floor,
                     "floor_held": max((floor[r] for r in
                                        inv["requests_held"]), default=None)})
        for name, ctx in faults.items():
            with ctx():
                inv = invariant(prompts)
            cs.emit({"seed": seed, "fault": name, "invariant": inv})
    return 0


if __name__ == "__main__":
    sys.exit(main())
