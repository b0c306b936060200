#!/usr/bin/env python3
"""Hold the flash-attention kernel to its plain version and time it.

    python3 tools/flash_bench.py [--rounds N]      (on a CUDA card)

Builds only ``flash_attention.cu``, prints its ptxas report, runs
``chip_smoke.py``'s ``attention_vs_plain`` cases, then times the bf16
kernel at Yi-6B's prefill (4, 32, 4, 512, 128), at a long prompt
(1, 32, 4, 4096, 128) and at DeepSeek-V2's MLA prefill (4, 128, 128,
2048, q·k 192, v 128), causal, and at whisper-large-v3's encoder
(8, 20, 20, 1500, 64, not causal), its cross-attention (Sq = 128
queries against Sk = 1500 frames) and qwen2-vl-72b's prefill (4, 64, 8,
2048, 128, causal), on the model's strided views, against
``F.scaled_dot_product_attention`` and the bound, ``--rounds`` times in
turn.  Every line is JSON; the card's ``nvidia-smi`` name and power
limit come first.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    bw, _, bf16 = cs.peaks_for(torch.cuda.get_device_name(0))
    lib = build.build_all(["flash_attention"])["flash_attention"]
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "ptxas" in ln]
    cs.emit({"nvidia_smi": smi, "design": fk.DESIGN, "ptxas": ptxas})
    att = cs.run_attention_vs_plain(dev, np.random.default_rng(cs.SEED))
    cs.emit({k: att[k] for k in ("phase", "tolerance", "max_abs_err")})
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    for r in range(args.rounds):
        for label, (shape, causal, sk) in (
                ("yi6b", (cs.FLASH_SHAPE, True, None)),
                ("long", (cs.FLASH_SHAPE_LONG, True, None)),
                ("mla", (cs.FLASH_SHAPE_MLA, True, None)),
                ("whisper_enc", cs.FLASH_WHISPER_ENC),
                ("cross", cs.FLASH_CROSS),
                ("qwen2vl", cs.FLASH_QWEN2VL)):
            cs.emit({"round": r, "shape": label, "BHKSD": shape,
                     "causal": causal, "Sk": sk}
                    | cs.flash_timing(dev, shape, bw, bf16, g, causal, sk))
    return 0


if __name__ == "__main__":
    sys.exit(main())
