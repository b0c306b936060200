#!/usr/bin/env python3
"""Hold the flash-attention kernel to its plain version and time it.

    python3 tools/flash_bench.py [--rounds N] [--baseline FILE.cu ...]
                                                   (on a CUDA card)

Builds only ``flash_attention.cu``, prints its ptxas report (registers,
spills and shared memory of each instantiation), runs ``chip_smoke.py``'s
``attention_vs_plain`` cases (its soft-capped ones too), then times the
bf16 kernel at Yi-6B's prefill (4, 32, 4, 512, 128), at a long prompt
(1, 32, 4, 4096, 128), at Jamba-v0.1's prefill (4, 32, 8, 2048, 128)
and at DeepSeek-V2's MLA prefill (4, 128, 128, 2048, q·k 192, v 128),
causal, and at whisper-large-v3's encoder (8, 20, 20, 1500, 64, not
causal), its cross-attention (Sq = 128 queries against Sk = 1500
frames) and qwen2-vl-72b's prefill (4, 64, 8, 2048, 128, causal), on
the model's strided views, against ``F.scaled_dot_product_attention``
and the bound, and again with the scores soft-capped at
``chip_smoke.SOFTCAP`` (``ms_softcap``; the bound is the same: products
and bytes), ``--rounds`` times in turn.

``--baseline`` (repeatable) builds other sources with the same
``flash_attention_launch`` entry (an earlier version of the kernel, e.g.
``git show <rev>:src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu`` saved under ``build/``; one without the soft-cap
argument is called without it) with the same flags, prints each ptxas
report, checks each at every timed shape and times each in turn with
the current one (baseline, current, current, baseline in each round),
uncapped and, where it takes the argument, capped at
``chip_smoke.SOFTCAP`` (``<name>_ms_softcap``; on these unit-variance
inputs the cap barely moves a score) and with q scaled by
``chip_smoke.SOFTCAP_GAIN`` at the smoke's smallest cap, where the cap
bites every score (``<name>_ms_bite``; v clamped to
``±chip_smoke.SOFTCAP_V``, as the smoke's capped cases hold it, so that
near one-hot rows stay where a bf16 step is within the tolerance).  Every line is JSON; the card's ``nvidia-smi`` name and power
limit come first.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from tools.ssd_bench import build_baselines  # noqa: E402
from tools.stencil_bench import ptxas_report  # noqa: E402

#: (label, shape, causal, Sk) of every timed call
SHAPES = (("yi6b", cs.FLASH_SHAPE, True, None),
          ("long", cs.FLASH_SHAPE_LONG, True, None),
          ("jamba", cs.FLASH_SHAPE_JAMBA, True, None),
          ("mla", cs.FLASH_SHAPE_MLA, True, None),
          ("whisper_enc", *cs.FLASH_WHISPER_ENC),
          ("cross", *cs.FLASH_CROSS),
          ("qwen2vl", *cs.FLASH_QWEN2VL))


def signatures(lib: ctypes.CDLL, capped: bool) -> ctypes.CDLL:
    """``flash_attention_launch``'s C signature, with the soft-cap
    argument after ``causal`` or (an earlier source) without it."""
    v, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.flash_attention_launch.argtypes = (
        [v] * 4 + [i] * 7 + [ll] * 12 + [f, i] + ([f] if capped else [])
        + [i, v])
    lib.flash_attention_launch.restype = i
    return lib


def launcher(lib, capped: bool, q, k, v, causal: bool, softcap=0.0):
    """A call of ``lib``'s entry on (q, k, v) into one output, as the
    wrapper makes it (bf16, the wrapper's checks already passed)."""
    from repro_torch.kernels.flash_attention import kernel as fk

    B, H, S, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((B, S, H, Dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    tail = [D ** -0.5, int(causal)] + ([softcap] if capped else []) + [
        fk.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream]
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            KH, S, Sk, D, Dv, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], *tail]

    def fn():
        err = lib.flash_attention_launch(*args)
        if err:
            raise RuntimeError(f"flash_attention_launch: error {err}")
        return out

    return fn


def inputs(dev, shape, sk, g):
    """q, k, v as ``chip_smoke.flash_timing`` draws them."""
    B, H, KH, S, D = shape[:5]
    Dv = shape[5] if len(shape) > 5 else D
    Sk = S if sk is None else sk
    bt = torch.bfloat16

    def draw(*s):
        return torch.randn(s, generator=g, device=dev).to(bt)

    q = draw(B, S, H, D).transpose(1, 2)
    k = draw(B, Sk, KH, D).transpose(1, 2)
    if Dv == D:
        v = draw(B, Sk, KH, D).transpose(1, 2)
    else:
        v = draw(B, Sk, KH, cs.MLA_NOPE + Dv)[..., cs.MLA_NOPE:] \
            .transpose(1, 2)
    return q, k, v


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--baseline", type=Path, action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr
    from repro_torch.kernels.stencil.tune import device_time_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    bw, _, bf16 = cs.peaks_for(torch.cuda.get_device_name(0))
    lib = build.build_all(["flash_attention"])["flash_attention"]
    cs.emit({"nvidia_smi": smi, "design": fk.DESIGN,
             "ptxas": ptxas_report(lib.with_suffix(".log").read_text())})
    libs = {"current": (signatures(ctypes.CDLL(str(lib)), True), True)}
    srcs = [p.resolve() for p in args.baseline]
    for src, base in zip(srcs, build_baselines(srcs, build)):
        capped = "softcap" in src.read_text()
        libs[src.name] = (signatures(ctypes.CDLL(str(base)), capped),
                          capped)
        cs.emit({"baseline": str(src), "softcap_entry": capped,
                 "ptxas": ptxas_report(
                     base.with_suffix(".log").read_text())})

    att = cs.run_attention_vs_plain(dev, np.random.default_rng(cs.SEED))
    cs.emit({k: att[k] for k in ("phase", "tolerance", "max_abs_err")}
            | {"softcap_cases": att["softcap_cases"]})
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    for r in range(args.rounds):
        for label, shape, causal, sk in SHAPES:
            row = {"round": r, "shape": label, "BHKSD": shape,
                   "causal": causal, "Sk": sk}
            row |= cs.flash_timing(dev, shape, bw, bf16, g, causal, sk)
            capped = cs.flash_timing(dev, shape, bw, bf16, g, causal, sk,
                                     softcap=cs.SOFTCAP)
            row |= {"softcap": cs.SOFTCAP, "ms_softcap": capped["ms"],
                    "max_abs_err_softcap": capped["max_abs_err"]}
            cs.emit(row)
    if len(libs) == 1:
        return 0

    # the baselines in turn with the current kernel, uncapped and capped
    others = [n for n in libs if n != "current"]
    order = others + ["current", "current"] + others[::-1]
    for r in range(args.rounds):
        for label, shape, causal, sk in SHAPES:
            q, k, v = inputs(dev, shape, sk, g)
            row = {"round": r, "shape": label, "baseline_vs_current": True}
            reps = max(5, 50 * 512 // shape[3])
            bite = (cs.SOFTCAP_GAIN * q, v.clamp(-cs.SOFTCAP_V, cs.SOFTCAP_V),
                    min(cs.SOFTCAP_CASE_CAPS), "_bite")
            for qq, vv, cap, tag in ((q, v, 0.0, ""),
                                     (q, v, cs.SOFTCAP, "_softcap"), bite):
                want = fr.attention_ref(qq, k, vv, causal=causal,
                                        softcap=cap)
                for name in order:
                    lib, capped = libs[name]
                    if cap and not capped:
                        continue
                    fn = launcher(lib, capped, qq, k, vv, causal, cap)
                    err, ok = cs._close([fn()], [want],
                                        cs.ATTN_TOL[q.dtype])
                    row.setdefault(f"{name}{tag}_max_abs_err", err)
                    if not ok:
                        cs.emit(row | {"ok": False, "failed": name + tag})
                        return 1
                    row.setdefault(f"{name}_ms{tag}", []).append(
                        device_time_ms(fn, reps))
                del want
            cs.emit(row)
            del q, k, v, bite
    return 0


if __name__ == "__main__":
    sys.exit(main())
