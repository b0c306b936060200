#!/usr/bin/env python3
"""Hold the fused residual-add + RMSNorm kernel to its plain version and
time it beside an earlier version of it.

    python3 tools/rmsnorm_bench.py [--rounds N] [--baseline FILE.cu]
                        [--sweep]  (on a CUDA card)

Builds only ``rmsnorm_residual.cu`` and prints its ptxas report
(registers, spills and shared memory of each instantiation), holds the
kernel to its plain version at every ``ROWS`` shape in f32 and bf16 (out
within ``chip_smoke.py``'s ``RMS_TOL``, h bitwise), then times, in bf16 and
``--rounds`` times, each ``ROWS`` shape beside its bytes bound: the
kernel at the rule's launch, the composition ``x + res`` then
``F.rms_norm`` (``chip_smoke.composition_ms``), and, with
``--baseline``, an earlier source of the kernel with the single-shape C
entry ``rmsnorm_residual_launch(x, res, scale, out, h, n, d, eps, dtype,
stream)`` (one CTA of 256 threads a row), built with the same flags and
checked on the same inputs (baseline, current, current, baseline,
each round).  The card's launch floor (a one-element ``torch.add``) is
timed once a round.  Every line is JSON; the card's ``nvidia-smi`` name
and power limit come first.  ``--sweep`` then
times every one-CTA-a-row launch shape at each ``ROWS`` shape
(``sweep``).  Exits 2 without a card and 1 if a check of the current
kernel fails.
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

#: (label, (N, d)): every shape PERF.md records for the norm
ROWS = [
    ("Yi-6B prefill", (2048, 4096)),
    ("Yi-6B decode", (4, 4096)),
    ("Jamba-v0.1 prefill", cs.RMS_ROWS_JAMBA),
    ("DeepSeek-V2 prefill", cs.RMS_ROWS_DEEPSEEK[0]),
    ("DeepSeek-V3 prefill", cs.RMS_ROWS_DEEPSEEK[1]),
    ("qwen2-vl prefill", (8192, 8192)),
    ("mamba2-370m prefill", (8192, 1024)),
    ("mamba2-370m decode", (4, 1024)),
    ("DeepSeek-V2 decode", (4, 5120)),
    ("DeepSeek-V3 decode", (4, 7168)),
    ("qwen2-vl decode", (4, 8192)),
    ("one decode row", (1, 8192)),
]


def baseline_lib(src: Path, build) -> ctypes.CDLL:
    """``src`` compiled as ``build.py`` compiles the kernels, with the
    earlier C signature."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"lib{src.stem}_baseline.so"
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
        capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise build.BuildError(log)
    lib = ctypes.CDLL(str(out))
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_residual_launch.argtypes = [v] * 5 + [i, i, ctypes.c_float,
                                                      i, v]
    lib.rmsnorm_residual_launch.restype = i
    return lib


def baseline_fn(lib, x, r, sc):
    """A function launching the baseline on (x, r, sc) into outputs it
    allocated once; returns (fn, out, h)."""
    out, h = torch.empty_like(x), torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    n, d = x.shape
    code = 0 if x.dtype == torch.float32 else 1

    def fn():
        err = lib.rmsnorm_residual_launch(
            x.data_ptr(), r.data_ptr(), sc.data_ptr(), out.data_ptr(),
            h.data_ptr(), n, d, 1e-5, code, stream)
        if err:
            raise RuntimeError(f"baseline launch failed ({err})")
    return fn, out, h


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_bench: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import kernel, ref
    from repro_torch.kernels.stencil.tune import device_time_ms
    from tools.stencil_bench import ptxas_report

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    bw, f32, _ = cs.peaks_for(torch.cuda.get_device_name(0))
    path = build.build_all(["rmsnorm_residual"])["rmsnorm_residual"]
    cs.emit({"nvidia_smi": smi, "design": kernel.DESIGN,
             "ptxas": ptxas_report(path.with_suffix(".log").read_text())})
    base = None
    if args.baseline is not None:
        base = baseline_lib(args.baseline.resolve(), build)
        cs.emit({"baseline": str(args.baseline), "ptxas": ptxas_report(
            Path(base._name).with_suffix(".log").read_text())})

    rng = np.random.default_rng(cs.SEED)
    inputs = {}
    ok = True
    for label, (n, d) in ROWS:
        in_dtype = cs._rms_case_inputs(rng, dev, n, d, True, 0)
        for dtype in (torch.float32, torch.bfloat16):
            x, r, sc = in_dtype(dtype)
            want = ref.rmsnorm_residual_ref(x, r, sc)
            got = kernel.rmsnorm_residual_cuda(x, r, sc)
            shape = kernel.rmsnorm_residual_cuda.last_launch
            err, good = cs._close(got, want, *cs.RMS_TOL[dtype])
            good = good and bool(torch.equal(got[1], want[1]))
            ok = ok and good
            cs.emit({"check": label, "N": n, "d": d,
                     "dtype": str(dtype).split(".")[-1],
                     "instantiation": kernel.instantiation(dtype, shape),
                     "threads": [shape["tpr"], shape["rows"]],
                     "max_abs_err": err, "ok": good})
            if base is not None:
                fn, out, h = baseline_fn(base, x, r, sc)
                fn()
                err, good = cs._close((out, h), want, *cs.RMS_TOL[dtype])
                cs.emit({"check": label, "N": n, "d": d, "kernel":
                         "baseline", "dtype": str(dtype).split(".")[-1],
                         "max_abs_err": err, "ok": good})
            if dtype == torch.bfloat16:
                inputs[label] = (x, r, sc)
            del want
        torch.cuda.synchronize()
    if not ok:
        return 1

    one = torch.ones((1,), device=dev)
    for rnd in range(args.rounds):
        cs.emit({"round": rnd, "launch_floor_ms": device_time_ms(
            lambda: torch.add(one, one), 200)})
        for label, (n, d) in ROWS:
            x, r, sc = inputs[label]
            reps = 50 if n * d >= 1 << 24 else 200
            bound, by = cs.bound_ms(kernel.rmsnorm_bytes(n, d, 2),
                                    kernel.rmsnorm_flops(n, d), bw, f32)
            row = {"round": rnd, "case": label, "N": n, "d": d,
                   "bound_ms": bound, "bound_by": by}
            current = (lambda: kernel.rmsnorm_residual_cuda(x, r, sc))
            order = [("current", current)] * 2
            if base is not None:
                bfn = baseline_fn(base, x, r, sc)[0]
                order = [("baseline", bfn), *order, ("baseline", bfn)]
            for name, fn in order:
                row.setdefault(f"{name}_ms", []).append(
                    device_time_ms(fn, reps))
            row["composition_ms"] = cs.composition_ms(x, r, sc, reps // 2)
            cs.emit(row)
    if args.sweep:
        sweep(inputs, kernel, device_time_ms)
    return 0


def sweep(inputs, kernel, device_time_ms) -> None:
    """Every 16-byte launch at each ``ROWS`` shape, bf16: accesses a
    thread ``nv`` and rows a CTA, the threads a row the fewest whole
    warps that hold it (how ``launch_shape``'s targets were chosen); the
    rule's pick marked."""
    lib = kernel._lib()
    for label, (n, d) in ROWS:
        x, r, sc = inputs[label]
        out, h = torch.empty_like(x), torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rule = kernel.launch_shape(n, d, x.dtype, True)
        reps = 50 if n * d >= 1 << 24 else 200
        nvec = d // 8
        for nv in kernel.VECTOR_NV:
            if nv > kernel.TARGET_NV:        # bf16 rows up to MAX_D take 4
                continue
            tpr = 32 * -(-nvec // (32 * nv))
            for rows in (1, 2, 4, 8, 16):
                if tpr * rows > kernel.MAX_THREADS or (
                        rows > 1 and rows > n):
                    continue

                def fn(nv=nv, tpr=tpr, rows=rows):
                    err = lib.rmsnorm_residual_launch(
                        x.data_ptr(), r.data_ptr(), sc.data_ptr(),
                        out.data_ptr(), h.data_ptr(), n, d, 1e-5, 1, 8, nv,
                        tpr, rows, stream)
                    if err:
                        raise RuntimeError(f"launch ({nv}, {tpr}, {rows}) "
                                           f"refused ({err})")
                cs.emit({"sweep": label, "N": n, "d": d, "nv": nv,
                         "tpr": tpr, "rows": rows,
                         "rule": (nv, tpr, rows) == (
                             rule["nv"], rule["tpr"], rule["rows"]),
                         "ms": device_time_ms(fn, reps)})


if __name__ == "__main__":
    sys.exit(main())
