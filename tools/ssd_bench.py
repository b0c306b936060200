#!/usr/bin/env python3
"""Hold the SSD chunk kernel to its plain version and time it.

    python3 tools/ssd_bench.py [--rounds N] [--baseline FILE.cu ...]
                                                   (on a CUDA card)

Builds only ``ssd_chunk.cu`` and prints its ptxas report (registers,
spills and shared memory of each compiled kernel), holds the kernel to
its plain version on ``chip_smoke.py``'s ``SSD_CASES`` (through the
wrapper, at the smoke's tolerances), then times it at mamba2-370m's
served prefill, (BC, H, Q, N, P) = (32, 32, 256, 128, 64) bf16, in two
layouts, ``--rounds`` times, each beside its bound: **shared**, the
model's views (xdt a view of (BC, Q, H, P), B and C one group with a
stride-0 head axis), and **per-head**, contiguous B and C for every
head.  It times the y tiles alone and the state tiles alone once in
each layout (``ssd_chunk_launch_role``, an entry only this bench
calls), and the shared layout at every heads-per-CTA count the kernel
takes (``heads``: how ``kernel.py``'s launch rule was chosen).
``--baseline`` (repeatable) builds other sources with the same C
entries (earlier versions of the kernel) with the same flags, checks
each on the timed inputs, splits its roles and times it in turn with
the current one (baseline, current, current, baseline in each round).
Every line is JSON; the card's ``nvidia-smi`` name and power limit come
first.  Exits 2 without a card and 1 if a check of the current kernel
fails.
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

ROLES = {"both": 0, "y": 1, "state": 2}


def build_baselines(srcs: list[Path], build) -> list[Path]:
    """Each of ``srcs`` compiled as ``build.py`` compiles the kernels,
    all at once; their library paths (each ptxas log beside it)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in srcs:
        out = build.BUILD_DIR / f"lib{src.stem}_baseline.so"
        procs.append((out, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for out, proc in procs:
        log, _ = proc.communicate(timeout=600)
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise build.BuildError(log)
    return [out for out, _ in procs]


def launcher(lib, kernel, args, role: str, hb: int | None = None):
    """A function that launches ``lib``'s kernel on ``args`` (one role,
    ``hb`` heads a CTA if given, else the launch rule's) into outputs it
    allocated once; returns (fn, y, state)."""
    xdt, b, c, csum = args
    BC, H, Q, P = xdt.shape
    N = b.shape[-1]
    y = torch.empty((BC, Q, H, P), dtype=xdt.dtype,
                    device=xdt.device).transpose(1, 2)
    state = torch.empty((BC, H, N, P), dtype=torch.float32,
                        device=xdt.device)
    launch = kernel.launch_rule(BC, H, Q, N, P, xdt.dtype,
                                kernel.heads_per_group(b, c))
    if hb is not None:
        launch = dict(launch, heads_per_cta=hb)
    cargs = kernel.c_args(xdt, b, c, csum, y, state, launch)
    stream = torch.cuda.current_stream(xdt.device).cuda_stream

    def fn():
        err = lib.ssd_chunk_launch_role(*cargs, ROLES[role], stream)
        if err:
            raise RuntimeError(lib.ssd_chunk_error_string(err).decode())
    return fn, y, state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--baseline", type=Path, action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_bench: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import kernel, ref
    from repro_torch.kernels.stencil.tune import device_time_ms
    from tools.stencil_bench import ptxas_report

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    bw, _, bf16 = cs.peaks_for(torch.cuda.get_device_name(0))
    path = build.build_all(["ssd_chunk"])["ssd_chunk"]
    libs = {"current": kernel._lib()}
    cs.emit({"nvidia_smi": smi, "design": kernel.DESIGN,
             "ptxas": ptxas_report(path.with_suffix(".log").read_text())})
    for src, base in zip(args.baseline, build_baselines(
            [p.resolve() for p in args.baseline], build)):
        libs[src.stem] = kernel.signatures(ctypes.CDLL(str(base)))
        cs.emit({"baseline": str(src), "ptxas": ptxas_report(
            base.with_suffix(".log").read_text())})

    rng = np.random.default_rng(cs.SEED)
    try:
        cases, worst = cs.check_ssd_cases(dev, rng)
    except cs.SmokeFailure as e:
        cs.emit({"ok": False, "error": str(e)})
        return 1
    cs.emit({"ok": True, "max_abs_err": worst, "cases": cases})

    BC, H, Q, N, P = cs.SSD_SERVED
    flops = kernel.ssd_flops(BC, H, Q, N, P)
    inputs, bounds = {}, {}
    for layout, label, groups in (("model", "shared", 1),
                                  ("contiguous", "per_head", H)):
        inputs[label] = cs._ssd_inputs(rng, dev, torch.bfloat16,
                                       *cs.SSD_SERVED, layout=layout)
        bounds[label] = cs.bound_ms(kernel.ssd_bytes(BC, H, Q, N, P, 2,
                                                     groups), flops, bw, bf16)
    ok = True
    for name, lib in libs.items():
        for label, a in inputs.items():
            fn, y, st = launcher(lib, kernel, a, "both")
            fn()
            want = ref.ssd_chunk_ref(*a)
            torch.cuda.synchronize()
            err, good = cs._ssd_ok(torch.bfloat16, (y, st), want, 1e-6)
            ok = ok and (good or name != "current")
            cs.emit({"check": name, "layout": label, "max_abs_err": err,
                     "ok": good})
            del want
    if not ok:
        return 1

    a = inputs["shared"]
    rule = kernel.launch_rule(BC, H, Q, N, P, torch.bfloat16, H)
    for name, lib in libs.items():
        row = {"heads": name}
        for hb in sorted({1, rule["heads_per_cta"]}):
            row[f"ms_hb{hb}"] = device_time_ms(
                launcher(lib, kernel, a, "both", hb)[0], 50)
        cs.emit(row)

    for name, lib in libs.items():
        for label, a in inputs.items():
            launch = kernel.launch_rule(BC, H, Q, N, P, torch.bfloat16,
                                        kernel.heads_per_group(a[1], a[2]))
            row = {"roles": label, "kernel": name, "launch": launch}
            for role in ("y", "state"):
                fn = launcher(lib, kernel, a, role)[0]
                row[f"{role}_ms"] = device_time_ms(fn, 50)
            cs.emit(row)

    others = [n for n in libs if n != "current"]
    order = others + ["current", "current"] + others[::-1]
    for r in range(args.rounds):
        for label, a in inputs.items():
            bound, by = bounds[label]
            row = {"round": r, "layout": label, "bound_ms": bound,
                   "bound_by": by}
            for name in order:
                fn = launcher(libs[name], kernel, a, "both")[0]
                row.setdefault(f"{name}_ms", []).append(
                    device_time_ms(fn, 50))
            cs.emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
