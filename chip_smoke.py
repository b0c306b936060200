#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py          (from the repository root)

Phases, each printing one JSON line:

1. ``device``: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions.
2. ``build``: nvcc builds ``csrc/*.cu`` for sm_90a from this checkout.
3. ``kernel_vs_plain``: the CUDA stencil kernel against its plain
   PyTorch version on the same card tensors, unit-normal inputs from a
   fixed seed; fails above 1e-5 max abs diff.
4. ``session``: the main path at the paper's size (``FWIConfig()``:
   600 x 600, 4 shots, 600 steps) — ``ElasticOrchestrator`` drives
   ``fwi_session_factory(device="cuda")`` through a scripted GROW and
   RETIRE (checkpoint -> new session -> restore), a ``PreemptionGuard``
   snapshot is saved and loaded mid-run and resumed to the end.  The
   kernel's launch count must equal the blocks dispatched, and the
   final field must match the plain version on the CPU within
   1e-5 * max|ref|.
5. ``production``: ``run_forward`` at 4096 x 4096, 4 shots, 200 steps
   (k = 8): ms per block against the card's bound, one block held to
   the plain version on the card.
6. ``kernels``: ``{"kernels": [...]}``, one entry per hand-written
   kernel with its time, launches, error, bound and plain-version time.

Then the card's ``nvidia-smi`` line, and last the contract line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before it; without a CUDA card, or outside the repository, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
TOL = 1e-5

#: published peaks (NVIDIA data sheets): HBM bytes/s, f32 FLOP/s without
#: tensor cores.  Matched against the name nvidia-smi reports.
PEAKS = [
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
    ("H200", 4.8e12, 67e12),
]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def peaks_for(name: str) -> tuple[float, float]:
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise SmokeFailure(f"no peak rates known for card {name!r}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.stencil import build, kernel, ops, ref

    dev = torch.device("cuda", 0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, f32 = peaks_for(name)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peak_bytes_per_s": bw,
          "peak_f32_flops": f32})

    # 2. build
    t0 = time.monotonic()
    libs = build.build_all()
    build_s = time.monotonic() - t0
    kernel._lib()
    ptxas = [ln.strip() for lib in libs.values()
             for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "smem" in ln]
    emit({"phase": "build", "seconds": round(build_s, 3),
          "libraries": sorted(str(p.relative_to(ROOT))
                              for p in libs.values()),
          "ptxas": ptxas})

    rng = np.random.default_rng(SEED)

    def inputs(ns, nz, nx, k, *, per_shot=True, src=None):
        p = rng.standard_normal((ns, nz, nx), dtype=np.float32)
        pp = rng.standard_normal((ns, nz, nx), dtype=np.float32)
        v2 = rng.uniform(0.05, 0.2, (nz, nx)).astype(np.float32)
        sp = rng.uniform(0.9, 1.0, (nz, nx)).astype(np.float32)
        sv = rng.standard_normal((ns, k) if per_shot else (k,),
                                 dtype=np.float32)
        if src is None:
            src = (rng.integers(0, nz, ns), rng.integers(0, nx, ns))
        sz = np.asarray(src[0], np.int32)
        sx = np.asarray(src[1], np.int32)
        return [torch.from_numpy(a).to(dev)
                for a in (p, pp, v2, sp, sv, sz, sx)]

    def max_diff(got, want) -> float:
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    def compare(args, receiver_row):
        got = ops.wave_block(*args, receiver_row=receiver_row)
        want = ref.wave_block_shots_ref(*args, receiver_row=receiver_row)
        torch.cuda.synchronize()
        return max_diff(got, want), all(
            torch.equal(g, w) for g, w in zip(got, want))

    # 3. kernel_vs_plain
    cases = []
    for label, (ns, nz, nx, k), kw, rrow in [
        ("ragged tiny", (1, 37, 53, 1), dict(per_shot=False), 2),
        ("(S,k) amplitudes", (3, 64, 96, 3), {}, 2),
        ("paper size k=4", (4, 600, 600, 4), {}, 2),
        ("seams and edges k=8", (4, 600, 600, 8),
         dict(src=([32, 31, 0, 599], [64, 0, 599, 33])), 32),
    ]:
        err, exact = compare(inputs(ns, nz, nx, k, **kw), rrow)
        cases.append({"case": label, "S": ns, "nz": nz, "nx": nx, "k": k,
                      "receiver_row": rrow, "max_abs_diff": err,
                      "bitwise": exact})
        check(err <= TOL, f"kernel vs plain {label}: {err} > {TOL}")
    p, pp, v2, sp, sv, sz, sx = inputs(1, 600, 600, 8, per_shot=False)
    got = ops.wave_block(p[0], pp[0], v2, sp, sv, int(sz[0]), int(sx[0]),
                         receiver_row=2)
    want = ref.wave_block_ref(p[0], pp[0], v2, sp, sv, int(sz[0]),
                              int(sx[0]), receiver_row=2)
    torch.cuda.synchronize()
    err = max_diff(got, want)
    cases.append({"case": "2-D entry k=8", "S": 1, "nz": 600, "nx": 600,
                  "k": 8, "receiver_row": 2, "max_abs_diff": err,
                  "bitwise": all(torch.equal(g, w)
                                 for g, w in zip(got, want))})
    check(err <= TOL, f"kernel vs plain 2-D entry: {err} > {TOL}")
    emit({"phase": "kernel_vs_plain", "tolerance": TOL, "cases": cases})

    # 4. session: the main path
    session_launches, session = run_session(dev)
    emit(session)

    # 5. production
    production = run_production(dev, bw, f32)
    emit(production)

    # 6. kernels
    timings = {}
    for label, (ns, nz, nx, k) in (("600", (4, 600, 600, 4)),
                                   ("4096", (4, 4096, 4096, 8))):
        args = inputs(ns, nz, nx, k)
        err, _ = compare(args, 2)
        check(err <= TOL, f"kernel vs plain at {label}: {err} > {TOL}")
        ms = time_ms(lambda: kernel.wave_block_shots_cuda(
            *args, receiver_row=2), reps=50 if label == "600" else 10)
        plain_ms = time_ms(lambda: ref.wave_block_shots_ref(
            *args, receiver_row=2), reps=5 if label == "600" else 2)
        bound = bound_ms(kernel, ns, nz, nx, k, bw, f32)
        timings[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              max_abs_err=err)
        del args
        torch.cuda.empty_cache()
    t6, t4k = timings["600"], timings["4096"]
    entry = {
        "name": "wave_block_shots",
        "route": "cuda",
        "source": "src/repro_torch/kernels/stencil/csrc/wave_block.cu",
        "replaces": "src/repro/kernels/stencil/kernel.py:806",
        "also_replaces": [
            "src/repro/kernels/stencil/kernel.py:673",
            "src/repro/kernels/stencil/kernel.py:501",
            "src/repro/kernels/stencil/kernel.py:375",
        ],
        "launches": session_launches,
        "max_abs_err": max(t6["max_abs_err"], t4k["max_abs_err"]),
        "ms": t6["ms"],
        "plain_ms": t6["plain_ms"],
        "bound_ms": t6["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": "S=4, 600x600, k=4 (the session's block)",
        "ms_4096": t4k["ms"],
        "plain_ms_4096": t4k["plain_ms"],
        "bound_ms_4096": t4k["bound_ms"],
        "shape_4096": "S=4, 4096x4096, k=8",
        "library": "none: no single PyTorch call computes the k-step block",
    }
    print(smi, flush=True)
    emit({"kernels": [entry]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def bound_ms(kernel, ns, nz, nx, k, bw, f32) -> float:
    """Least time of one block: the larger of its bytes over the card's
    memory rate and its f32 operations over the card's peak."""
    by_bytes = kernel.block_bytes(ns, nz, nx, k) / bw
    by_ops = kernel.block_flops(ns, nz, nx, k) / f32
    if by_ops > by_bytes:
        raise SmokeFailure("the stencil block is not bound by bytes")
    return by_bytes * 1e3


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class ScriptedPolicy:
    """GROW at one step, RETIRE at a later one; at ``snap_at`` the
    current session's state is published to a PreemptionGuard and saved
    as a SIGTERM handler would."""

    name = "scripted"

    def __init__(self, grow_at, retire_at, snap_at, sessions, guard):
        self.grow_at, self.retire_at = grow_at, retire_at
        self.snap_at, self.sessions, self.guard = snap_at, sessions, guard

    def decide(self, ctx):
        from repro_torch.core import ScaleAction

        if ctx.step == self.snap_at:
            self.guard.publish(self.sessions[-1], ctx.step)
            self.guard.save()
        if ctx.step == self.grow_at:
            return ScaleAction("grow", chips=64, slowdown=1.4)
        if ctx.step == self.retire_at:
            return ScaleAction("retire")
        return ScaleAction("hold")


def run_session(dev):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import (
        BurstPlanner,
        DeadlinePredictor,
        ElasticOrchestrator,
        LogCapacityModel,
        OverheadModel,
        PodSpec,
        Resources,
    )
    from repro_torch.fwi.driver import (
        FWISession,
        PreemptionGuard,
        TimeModel,
        fwi_session_factory,
        load_session_snapshot,
    )
    from repro_torch.fwi.solver import FWIConfig, run_forward
    from repro_torch.kernels.stencil.kernel import wave_block_shots_cuda

    cfg = FWIConfig()
    steps = cfg.timesteps
    legal = [16, 32, 64, 128]
    model = LogCapacityModel.fit(legal, [64.0 / c for c in legal])
    planner = BurstPlanner(
        cluster_model=model, cloud_model=model, chips_cluster=64,
        legal_slices=legal,
        overheads=OverheadModel(ckpt_s=5.0, provision_s=10.0,
                                restart_s=5.0))
    orch = ElasticOrchestrator(
        planner=planner, predictor=DeadlinePredictor(10_000.0),
        check_every=8, ckpt_every=96, cloud_slowdown=1.4)
    tm = TimeModel(chip_seconds_per_step=64.0, jitter=0.01)
    base = fwi_session_factory(cfg, tm, seed=SEED, device=dev)
    sessions = []

    def factory(res, start_step, restored):
        s = base(res, start_step, restored)
        sessions.append(s)
        return s

    initial = Resources(pods=[PodSpec(64, name="cluster")], shares=[1.0])
    with tempfile.TemporaryDirectory() as tmp:
        guard = PreemptionGuard(CheckpointManager(tmp, async_save=False))
        policy = ScriptedPolicy(200, 400, 296, sessions, guard)
        wave_block_shots_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rec = orch.run(session_factory=factory, initial=initial,
                       steps_total=steps, autoscaler=policy)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = wave_block_shots_cuda.launches
        restored, snap_step = load_session_snapshot(guard.manager)

    kinds = [e.detail["kind"] for e in rec.events if e.kind == "scale"]
    check(rec.completed, "orchestrated run did not complete")
    check(kinds == ["grow", "retire"], f"scale events {kinds}")
    check(len(sessions) == 3, f"{len(sessions)} sessions, expected 3")
    blocks = sum(s.blocks for s in sessions)
    check(launches > 0 and launches == blocks,
          f"kernel launches {launches} != blocks dispatched {blocks}")
    last = sessions[-1]
    check(last.t == steps, f"session ended at t={last.t}, not {steps}")
    p = last.p.cpu()
    check(bool(torch.isfinite(p).all()), "non-finite wavefield")
    t0 = time.monotonic()
    ref, _ = run_forward(cfg, steps=last.t, k=last.k, device="cpu")
    cpu_s = time.monotonic() - t0
    scale = float(ref.p.abs().max())
    err = float((p - ref.p).abs().max())
    check(scale > 0 and err <= TOL * scale,
          f"final field vs CPU plain run: {err} > {TOL} * {scale}")

    # the guard's snapshot resumes to the same final field
    check(snap_step == 296, f"snapshot at step {snap_step}")
    resumed = FWISession(cfg, initial, snap_step, restored,
                         time_model=tm, rng=np.random.default_rng(SEED),
                         device=dev)
    for step in range(snap_step, steps):
        resumed.run_step(step)
    check(resumed.t == last.t and torch.equal(resumed.p.cpu(), p),
          "run resumed from the PreemptionGuard snapshot diverged")

    # the engine alone: 600 steps through run_forward on the card
    run_forward(cfg, steps=8, k=last.k, device=dev)       # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    run_forward(cfg, steps=steps, k=last.k, device=dev)
    torch.cuda.synchronize()
    engine_s = time.monotonic() - t0
    return launches, {
        "phase": "session", "nz": cfg.nz, "nx": cfg.nx,
        "shots": cfg.n_shots, "steps": steps, "k": last.k,
        "scale_events": kinds, "sessions": len(sessions),
        "kernel_launches": launches, "blocks_dispatched": blocks,
        "final_max_abs_diff_vs_cpu": err, "final_max_abs_ref": scale,
        "bitwise_vs_cpu": bool(torch.equal(p, ref.p)),
        "snapshot_step": snap_step,
        "orchestrated_ms_per_step": wall / steps * 1e3,
        "engine_ms_per_step": engine_s / steps * 1e3,
        "cpu_plain_s": cpu_s,
    }


def run_production(dev, bw, f32):
    from repro_torch.fwi.solver import (
        FWIConfig,
        _block_amps,
        model_fields,
        run_forward,
    )
    from repro_torch.kernels.stencil import kernel, ref
    from repro_torch.kernels.stencil.ops import pick_k

    cfg = FWIConfig(nz=4096, nx=4096, n_shots=4, timesteps=200)
    k = pick_k(cfg.nz)
    blocks = -(-cfg.timesteps // k)
    run_forward(cfg, steps=k, k=k, device=dev)             # warm-up
    torch.cuda.synchronize()
    before = kernel.wave_block_shots_cuda.launches
    t0 = time.monotonic()
    st, traces = run_forward(cfg, k=k, device=dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernel.wave_block_shots_cuda.launches - before
    check(launches == blocks, f"{launches} launches for {blocks} blocks")
    check(bool(torch.isfinite(st.p).all()) and bool(
        torch.isfinite(traces).all()), "non-finite production output")
    check(tuple(traces.shape) == (4, cfg.timesteps, cfg.nx),
          f"traces shape {tuple(traces.shape)}")
    mf = model_fields(cfg, dev)
    args = (st.p, st.p_prev, mf.v2dt2, mf.sponge,
            _block_amps(mf, st.t, k, cfg.timesteps), mf.src_z, mf.src_x)
    got = kernel.wave_block_shots_cuda(*args,
                                       receiver_row=cfg.receiver_depth)
    want = ref.wave_block_shots_ref(*args, receiver_row=cfg.receiver_depth)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err <= TOL, f"production block vs plain: {err} > {TOL}")
    ms_block = wall / blocks * 1e3
    bound = bound_ms(kernel, 4, cfg.nz, cfg.nx, k, bw, f32)
    return {
        "phase": "production", "nz": cfg.nz, "nx": cfg.nx, "shots": 4,
        "steps": cfg.timesteps, "k": k, "blocks": blocks,
        "wavefield_bytes": 2 * st.p.numel() * 4,
        "ms_per_block": ms_block, "bound_ms_per_block": bound,
        "share_of_bound": bound / ms_block,
        "block_max_abs_diff_vs_plain": err,
        "block_bitwise_vs_plain": all(
            torch.equal(g, w) for g, w in zip(got, want)),
        "max_abs_p": float(st.p.abs().max()),
    }


if __name__ == "__main__":
    sys.exit(main())
