#!/usr/bin/env python3
"""Hold the wave_step stencil kernel to its plain version and time it.

    python3 tools/step_bench.py [--rounds N]      (on a CUDA card)

Builds only ``wave_step.cu``, prints its ptxas report (registers and
spills of each compiled kernel), holds the kernel bitwise to its plain
version on ``chip_smoke.py``'s ``STEP_CASES`` (ragged widths, part
strips, offset inputs, 4096 x 4096 S=4 among them) and at every tile
of ``tune.step_candidates()`` at (3, 150, 170) and (2, 67, 1027), sweeps
the tuner at 600² and 4096² (S=4), then times the kernel ``--rounds``
times in turn: at (4, 600, 600) and (4, 4096, 4096) with the default
tile and with the tuner's winner, and at the gamma sweeps' widths,
(4, 4096, 512 | 1024 | 2048) and (4, 600, 128 | 256 | 384 | 512), and
at (2, 4096, 1027 | 1026 | 1024) (1, 2 and 4 columns a thread), with
the default tile; each time beside its bound.  It also times PyTorch's
copy and add at (4, 4096, 4096), in TB/s beside the kernel's, for what
plain streaming reaches on the card.  ``--variants`` first times every
launch the kernel takes at ``VARIANT_SHAPES`` (each candidate tile at
every strip length), each held bitwise: how ``kernel.py``'s launch
rule and default tile were chosen.  Every line is JSON; the card's
``nvidia-smi`` name and power limit come first.  Exits 2 without a card
and 1 if a case is not bitwise.
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

#: (S, NZ, NX) timed with the default tile: the gamma sweeps' widths
SWEEP_SHAPES = ((4, 4096, 512), (4, 4096, 1024), (4, 4096, 2048),
                (4, 600, 128), (4, 600, 256), (4, 600, 384), (4, 600, 512))
#: (S, NZ, NX) timed with the default tile and the tuner's winner
TUNED_SHAPES = ((4, 600, 600), (4, 4096, 4096))
#: (S, NZ, NX) of the ``--variants`` sweep
VARIANT_SHAPES = ((4, 4096, 4096), (4, 4096, 512), (4, 600, 600),
                  (4, 600, 384), (4, 600, 256), (4, 600, 128))
#: (S, NZ, NX) timed with the default tile at 1 and 2 columns a thread
#: (NX % 4 = 3 and 2) beside 4 (NX % 4 = 0)
RAGGED_SHAPES = ((2, 4096, 1027), (2, 4096, 1026), (2, 4096, 1024))


def sweep_variants(cs, kernel, ref, tune, dev, rng, shape) -> dict:
    """{"tile rows=R": ms} of every launch at ``shape`` (the default
    column count a thread), each held bitwise to the plain version."""
    ns, nz, nx = shape
    a = cs.step_inputs(rng, dev, ns, nz, nx)
    want = ref.wave_step_ref(*a)
    outs = [torch.empty_like(a[0]), torch.empty_like(a[0])]
    tensors = (*a, *outs)
    vec = kernel.step_vector(nx, [t.data_ptr() for t in tensors])
    times, exact = {}, True
    for tile in tune.step_candidates():
        for rows, threads in kernel.step_shapes(tile, vec):
            launch = {"vec": vec, "rows": rows, "threads": threads}
            kernel._launch_step(tensors, tile, launch)
            torch.cuda.synchronize()
            exact = exact and all(
                torch.equal(g, w) for g, w in zip(outs, want))
            times[f"{tile[0]}x{tile[1]} rows={rows}"] = tune.device_time_ms(
                lambda: kernel._launch_step(tensors, tile, launch),
                200 if nz * nx <= 600 * 600 else 20)
    return {"variants": list(shape), "vec": vec, "bitwise": exact,
            "ms": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_bench: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.stencil import kernel, ref, tune
    from tools.stencil_bench import ptxas_report

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    bw, f32, _ = cs.peaks_for(torch.cuda.get_device_name(0))
    lib = build.build_all(["wave_step"])["wave_step"]
    default = (kernel.TILE_Z, kernel.TILE_X)
    cs.emit({"nvidia_smi": smi, "default_tile": list(default),
             "ptxas": ptxas_report(lib.with_suffix(".log").read_text())})

    rng = np.random.default_rng(cs.SEED)
    if args.variants:
        for shape in VARIANT_SHAPES:
            row = sweep_variants(cs, kernel, ref, tune, dev, rng, shape)
            cs.emit(row)
            if not row["bitwise"]:
                return 1
    try:
        cases = cs.run_step_vs_plain(dev, rng)
    except cs.SmokeFailure as e:
        cs.emit({"bitwise": False, "error": str(e)})
        return 1
    tiles_ok = {}
    for shape in ((3, 150, 170), (2, 67, 1027)):
        a = cs.step_inputs(rng, dev, *shape)
        want = ref.wave_step_ref(*a)
        for t in tune.step_candidates():
            got = kernel.wave_step_cuda(*a, tile=t)
            tiles_ok[f"{shape} {t}"] = all(
                torch.equal(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    ok = all(tiles_ok.values())
    cs.emit({"bitwise": ok, "cases": [
        (c["case"], c["S"], c["nz"], c["nx"], c["offset"]) for c in cases],
        "tiles": tiles_ok})
    if not ok:
        return 1

    winners = {}
    for ns, nz, nx in TUNED_SHAPES:
        sweep = tune.sweep_step_tile(nz, nx, ns, device=dev)
        winners[nz] = min(sweep, key=sweep.get)
        cs.emit({"sweep": nz, "S": ns, "winner": list(winners[nz]),
                 "ms": {f"{t[0]}x{t[1]}": ms
                        for t, ms in sorted(sweep.items())}})

    def time_one(shape, tile):
        ns, nz, nx = shape
        a = cs.step_inputs(rng, dev, ns, nz, nx)
        got = kernel.wave_step_cuda(*a, tile=tile)
        want = ref.wave_step_ref(*a)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        del got, want
        reps = 200 if nz * nx <= 600 * 600 else 20
        ms = tune.device_time_ms(
            lambda: kernel.wave_step_cuda(*a, tile=tile), reps)
        bound, by = cs.bound_ms(kernel.step_bytes(ns, nz, nx),
                                kernel.step_flops(ns, nz, nx), bw, f32)
        return {"S": ns, "nz": nz, "nx": nx, "tile": list(tile), "ms": ms,
                "bound_ms": bound, "bound_by": by,
                "share_of_bound": bound / ms, "bitwise": exact}

    # what plain streaming reaches on this card at the production batch:
    # PyTorch's copy (1 read : 1 write, as the step kernel's per-shot
    # fields) and add (2 : 1), in TB/s, beside the step kernel's
    a = cs.step_inputs(rng, dev, 4, 4096, 4096)
    out = torch.empty_like(a[0])
    ceiling = {}
    for label, fn, nbytes in (
            ("copy", lambda: out.copy_(a[0]), 2 * a[0].nbytes),
            ("add", lambda: torch.add(a[0], a[1], out=out),
             3 * a[0].nbytes),
            ("wave_step", lambda: kernel.wave_step_cuda(*a, tile=default),
             kernel.step_bytes(4, 4096, 4096))):
        ms = tune.device_time_ms(fn, 20)
        ceiling[label] = {"ms": ms, "tb_per_s": nbytes / ms / 1e9}
    cs.emit({"ceiling": [4, 4096, 4096], "peak_tb_per_s": bw / 1e12}
            | ceiling)
    del a, out
    torch.cuda.empty_cache()

    for r in range(args.rounds):
        for shape in TUNED_SHAPES:
            for of, tile in (("default", default),
                             ("tuner", winners[shape[1]])):
                row = time_one(shape, tile)
                ok = ok and row["bitwise"]
                cs.emit({"round": r, "tile_of": of} | row)
        for shape in SWEEP_SHAPES + RAGGED_SHAPES:
            row = time_one(shape, default)
            ok = ok and row["bitwise"]
            cs.emit({"round": r, "tile_of": "default"} | row)
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
