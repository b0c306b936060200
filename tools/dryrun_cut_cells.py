#!/usr/bin/env python3
"""Every train cell of the dry run at cut depth, a few at a time.

    python3 tools/dryrun_cut_cells.py                  (on the card's machine)
    python3 tools/dryrun_cut_cells.py --device cpu --jobs 4

Runs ``launch/dryrun.py::dryrun_cell`` for each arch × train_4k on the
(16, 16) and (2, 16, 16) meshes, the arch cut to one layer of each kind
(``dryrun.cut_depth``) at full width and its own microbatch, each cell
in a spawned process (``dryrun.run_jobs``), and yi-6b whole on (16, 16)
first.  It is the quick check that every site of every arch still
places its views where the installed torch takes them (the full runs
take tens of minutes): ``--device cuda`` (the default) puts the mesh
and the fake tensors on CUDA, which needs a build with CUDA, as the
dry run's CLI does; ``--device cpu`` runs anywhere.  One JSON line a
cell (status, wall and trace seconds, peak GiB a rank, the dominant
roofline term, the error and the end of its traceback), the torch
version and, where there is one, the card's ``nvidia-smi`` name and
power limit first.  Records go under ``--out``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def cell(arch: str, multi: bool, cut: bool, device: str, out: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr

    cfg = get_config(arch)
    c = dr.cut_depth(cfg) if cut else cfg
    t0 = time.time()
    rec = dr.dryrun_cell(arch, "train_4k", multi,
                         Path(out) / ("cut" if cut else "whole"),
                         verbose=False, cfg=c, device=device,
                         reduced=dr.reduced_note(cfg, c) if cut else None)
    return {"arch": arch, "mesh": rec["mesh"],
            "reduced": rec.get("reduced"), "status": rec["status"],
            "wall_s": round(time.time() - t0, 1),
            "trace_s": rec.get("trace_s"),
            "peak_gib": rec.get("memory", {}).get(
                "peak_bytes_per_device", 0) / 2**30,
            "dominant": rec.get("roofline", {}).get("dominant"),
            "error": rec.get("error", "")[:300],
            "traceback": rec.get("traceback", "")[-1500:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=7)
    ap.add_argument("--out", default=str(ROOT / "artifacts" /
                                         "torch_dryrun_cut"))
    args = ap.parse_args(argv)
    import torch

    from repro_torch.configs import ALL_ARCHS
    from repro_torch.launch import dryrun as dr

    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__}), flush=True)
    if shutil.which("nvidia-smi"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    tasks = [("yi-6b", False, False, args.device, args.out)]
    tasks += [(a, m, True, args.device, args.out)
              for m in (False, True) for a in ALL_ARCHS]
    t0 = time.time()
    recs = dr.run_jobs(cell, tasks, args.jobs)
    for r in recs:
        print(json.dumps(r), flush=True)
    bad = [r for r in recs if r["status"] != "ok"]
    print(json.dumps({"cells": len(recs), "not_ok": len(bad),
                      "seconds": round(time.time() - t0, 1)}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
