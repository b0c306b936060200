#!/usr/bin/env python3
"""Hold the wave_block stencil kernel to its plain version and time it.

    python3 tools/stencil_bench.py [--rounds N]      (on a CUDA card)

Builds only ``wave_block.cu``, prints its ptxas report (registers and
shared bytes of each compiled kernel), holds the kernel bitwise to its
plain version on ``chip_smoke.py``'s ``kernel_vs_plain`` cases (the
4096 x 4096, S=4, k=8 block among them), sweeps the tuner's (tile, k)
candidates at 600² and 4096² (S=4), then times the kernel at
(S, NZ, NX, k) = (4, 600, 600, 4), (4, 4096, 4096, 8), (1, 600, 600, 4)
and (1, 4096, 4096, 8) with the default tile and with the tuner's
winner, against the bound, ``--rounds`` times in turn.  Every line is
JSON; the card's ``nvidia-smi`` name and power limit come first.
Exits 2 without a card and 1 if a case is not bitwise.
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

#: the timed shapes: (S, NZ, NX, k); the session's block, the
#: production block and their single-shot entries
SHAPES = ((4, 600, 600, 4), (4, 4096, 4096, 8), (1, 600, 600, 4),
          (1, 4096, 4096, 8))


def ptxas_report(log: str) -> list[dict]:
    """One ``{"kernel", "registers", "info", "frame"}`` per compiled
    kernel of an nvcc ``-Xptxas -v`` log (``frame``: its stack frame and
    spill bytes)."""
    out, name, frame = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name, frame = ln.split("'")[1], ""
        elif "spill stores" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln and name is not None:
            regs = int(ln.split("Used")[1].split("registers")[0])
            out.append({"kernel": name, "registers": regs,
                        "info": ln.split(":", 1)[1].strip(),
                        "frame": frame})
            name = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stencil_bench: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.stencil import kernel, ref, tune

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    bw, f32, _ = cs.peaks_for(torch.cuda.get_device_name(0))
    lib = build.build_all(["wave_block"])["wave_block"]
    default = tuple(kernel.BLOCK_TILE)
    cs.emit({"nvidia_smi": smi, "default_tile": list(default),
             "smem_bytes_k4_k8": [kernel.smem_bytes(4), kernel.smem_bytes(8)],
             "ptxas": ptxas_report(lib.with_suffix(".log").read_text())})

    rng = np.random.default_rng(cs.SEED)
    try:
        cases = cs.run_block_vs_plain(dev, rng)
    except cs.SmokeFailure as e:
        cs.emit({"bitwise": False, "error": str(e)})
        return 1
    cs.emit({"bitwise": True, "cases": [
        (c["case"], c["S"], c["nz"], c["nx"], c["k"]) for c in cases]})

    winners = {}
    for n in (600, 4096):
        sweep = tune.sweep_block(n, n, 4, device=dev)
        best = min(sweep, key=sweep.get)
        winners[n] = best
        cs.emit({"sweep": n, "S": 4, "winner": [list(best[0]), best[1]],
                 "ms_per_step": {f"{t[0]}x{t[1]} k={k}": ms
                                 for (t, k), ms in sorted(sweep.items())}})

    def time_one(shape, tile, reps):
        ns, nz, nx, k = shape
        a = cs.block_inputs(rng, dev, ns, nz, nx, k)
        got = kernel.wave_block_shots_cuda(*a, receiver_row=2, tile=tile)
        want = ref.wave_block_shots_ref(*a, receiver_row=2)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        del got, want
        ms = tune.device_time_ms(lambda: kernel.wave_block_shots_cuda(
            *a, receiver_row=2, tile=tile), reps)
        bound, by = cs.bound_ms(kernel.block_bytes(ns, nz, nx, k),
                                kernel.block_flops(ns, nz, nx, k), bw, f32)
        return {"S": ns, "nz": nz, "nx": nx, "k": k, "tile": list(tile),
                "ms": ms, "ms_per_step": ms / k, "bound_ms": bound,
                "bound_by": by, "share_of_bound": bound / ms,
                "bitwise": exact}

    ok = True
    for r in range(args.rounds):
        for shape in SHAPES:
            reps = 50 if shape[1] == 600 else 10
            row = time_one(shape, default, reps)
            ok = ok and row["bitwise"]
            cs.emit({"round": r, "tile_of": "default"} | row)
        for n, (tile, k) in winners.items():
            row = time_one((4, n, n, k), tile, 50 if n == 600 else 10)
            ok = ok and row["bitwise"]
            cs.emit({"round": r, "tile_of": "tuner"} | row)
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
