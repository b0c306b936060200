#!/usr/bin/env python3
"""Probe the donated train step's memory at candidate shapes.

    python3 tools/donate_probe.py                      (on a CUDA card)

Builds the kernels and runs ``chip_smoke.py``'s ``moe_train`` cell
(``_moe_train_cell``: 2 updates of ``build_session``'s donated step on
the one-rank NCCL mesh, bf16, remat "full") for DeepSeek-V2 cut to 2
layers at B x S = 2 x 2048 and 1 x 2048 and for Jamba-v0.1 cut to 3
layers at 2 x 2048, each in turn, an out-of-memory caught and printed;
then the ``train`` cell's donated-against-plain check
(``_donate_check``).  How ``MOE_TRAIN_V2`` and ``MOE_TRAIN_JAMBA`` were
chosen: V2 at 2 x 2048 runs out of memory in the gradient pass.  Rerun
it when the pass's memory moves (a flash backward kernel, a torch
release, a change to the MoE or the loss chunking) to see whether V2
now fits 2 x 2048 and ``MOE_TRAIN_V2`` may grow.  Every line is JSON but
the card's ``nvidia-smi`` name and power limit, which come first.
Exits 2 without a card.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

CELLS = (("deepseek-v2 2x2048", (cs.V2, 2)),
         ("deepseek-v2 1x2048", (cs.V2, 1)),
         ("jamba-v0.1 2x2048", ("jamba", 2)))


def main() -> int:
    if not torch.cuda.is_available():
        print("donate_probe: no CUDA device available", file=sys.stderr)
        return 2
    import torch.distributed as dist

    sys.path.insert(0, str(cs.SRC))
    from repro_torch.configs import RunConfig
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.kernels import build

    build.build_all()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for label, (arch, B) in CELLS:
        cfg = (cs._jamba_cut(3, "bfloat16") if arch == "jamba"
               else cs._deepseek_cut(arch, 1, 1, "bfloat16"))
        t0 = time.monotonic()
        try:
            rec = cs._moe_train_cell(dev, smi, cfg, RunConfig(
                loss_chunk=512, remat="full"), B, 2048, label)
        except torch.OutOfMemoryError as e:
            rec = {"out_of_memory": str(e).splitlines()[0]}
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            gc.collect()
            torch.cuda.empty_cache()
        print(json.dumps({"cell": label, "seconds": time.monotonic() - t0,
                          **rec}), flush=True)
    cfg = cs._train_cfg("yi-6b", layers=cs.TRAIN_LAYERS)
    run = RunConfig(microbatch=cs.TRAIN_MB, loss_chunk=512, remat="full",
                    optimizer="adamw")
    shape = ShapeConfig("train_4k_cut", "train", cs.TRAIN_SEQ,
                        cs.TRAIN_BATCH)
    print(json.dumps({"cell": "yi-6b train donated",
                      **cs._donate_check(dev, cfg, run, shape)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
