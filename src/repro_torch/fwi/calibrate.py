"""Empirical calibration — paper §3.2 (eqs. 6, 7, 8) — on the port.

The counterpart of the JAX package's ``fwi/calibrate.py``, with the
same two fits and the same configurations:

* t(γ): execution time vs domain width — wall-clock measurements of the
  step-at-a-time engine (``solver.make_scan_runner``) over a sweep of
  widths (paper Fig. 5), fitted with ``GammaModel`` (eq. 4).
* L(c): log-time vs chip count for each environment (paper Fig. 4).
  One card cannot vary real chip counts, so the samples are the
  measured single-device step time scaled by c and by the environment
  slowdown K, with seeded noise; the fitting path is the one real
  hardware would run (DESIGN.md §10 records this boundary).

* the seam probe (``measure_seam_latency``): the latency of one packed
  halo exchange of the striped engine and the stripe interior's compute
  time per step, which ``OverheadModel.with_overlapped_seam`` turns into
  the planner's seam term.

Every measurement runs on ``device`` (the card unless the caller asks
for the CPU) and times up to ``torch.cuda.synchronize()``, so a time
taken on the card is the card's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.capacity import LogCapacityModel
from repro_torch.core.gamma import GammaModel
from repro_torch.device import resolve_device
from repro_torch.fwi.domain import (
    HALO,
    halo_exchange_plan,
    make_exchange,
    stripe_mesh,
)
from repro_torch.fwi.solver import (
    FWIConfig,
    ShotState,
    make_block_runner,
    make_scan_runner,
    run_forward,
)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_gamma_sweep(
    base: FWIConfig,
    widths: list[int],
    *,
    steps: int = 30,
    repeats: int = 2,
    device="cuda",
) -> tuple[list[int], list[float]]:
    """Wall clock: the best of ``repeats`` runs of ``steps`` timesteps
    of the step-at-a-time engine at each domain width, after one
    warm-up run.  Returns (widths, seconds per step)."""
    dev = resolve_device(device)
    times = []
    for nx in widths:
        cfg = FWIConfig(
            nz=base.nz, nx=nx, dt=base.dt, dx=base.dx,
            timesteps=steps, n_shots=base.n_shots,
            sponge_width=base.sponge_width,
        )
        runner = make_scan_runner(cfg, device=dev)
        st = ShotState.init(cfg, dev)
        runner(st.p, st.p_prev, 0, steps)                 # warm-up
        _sync(dev)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.monotonic()
            runner(st.p, st.p_prev, 0, steps)
            _sync(dev)
            best = min(best, time.monotonic() - t0)
        times.append(best / steps)
    return widths, times


def fit_gamma_model(base: FWIConfig, widths=None, *, device="cuda",
                    **kw) -> GammaModel:
    widths = widths or [128, 192, 256, 384, 512]
    g, t = measure_gamma_sweep(base, widths, device=device, **kw)
    return GammaModel.fit(g, t, name="fwi-width")


def measure_seam_latency(
    cfg: FWIConfig | None = None,
    *,
    n_stripes: int = 2,
    k: int = 4,
    iters: int = 30,
    blocks: int = 8,
    mesh=None,
    device="cuda",
) -> dict:
    """The seam probe feeding ``OverheadModel.with_overlapped_seam``,
    with the shapes the striped engine uses:

    * ``ppermute_latency_s``: the median wall time, to the last copy's
      end, of one packed halo exchange of ``n_stripes`` stripes through
      the striped engine's own exchange, each stripe's payload the real
      ``bytes_per_exchange`` of ``halo_exchange_plan(cfg, n_stripes,
      k)`` (its (S, NZ, k·HALO) edges, p and p_prev for k > 1, both
      ways).  ``mesh`` (default: all stripes in this process on
      ``device``) may be a ``torch.distributed`` group's, whose exchange
      is a message between ranks; ``mesh_devices`` says how many
      devices the stripes spanned: on one card the exchange is a copy
      on it, not a transfer between devices.
    * ``interior_compute_s_per_step``: the best of two timed runs of
      the stripe interior's block engine (width ``nx / n_stripes``, k
      steps a block, ``blocks`` blocks), per step: the compute an
      exchange in flight can hide behind.

    Returns the JAX package's keys; ``backend`` is the device type."""
    cfg = cfg or FWIConfig()
    plan = halo_exchange_plan(cfg, n_stripes, k=k)
    k = int(plan["k"])                     # effective (clamped) block
    mesh = mesh or stripe_mesh(n_stripes, device)
    dev = mesh.devices[0]
    fields = 1 if k == 1 else 2
    local = len(mesh.stripes)
    shape = (cfg.n_shots, cfg.nz, k * HALO)
    edges = [[torch.zeros(shape, device=mesh.devices[j])
              for _ in range(2 * fields)] for j in range(local)]
    halos = [[torch.empty(shape, device=mesh.devices[j])
              for _ in range(4)] for j in range(local)]
    exchange = make_exchange(mesh)

    def once():
        exchange.wait(exchange.start(
            [e[:fields] for e in edges], [e[fields:] for e in edges],
            [h[:2] for h in halos], [h[2:] for h in halos], fields))
        _sync(dev)

    once()                                            # warm-up
    ts = []
    for _ in range(iters):
        t0 = time.monotonic()
        once()
        ts.append(time.monotonic() - t0)
    t_pp = sorted(ts)[len(ts) // 2]

    icfg = FWIConfig(
        nz=cfg.nz, nx=cfg.nx // n_stripes, dt=cfg.dt, dx=cfg.dx,
        timesteps=cfg.timesteps, n_shots=cfg.n_shots,
        sponge_width=cfg.sponge_width,
    )
    st = ShotState.init(icfg, dev)
    blk = make_block_runner(icfg, k=k, collect_traces=False, device=dev)
    steps = k * blocks
    blk(st.p, st.p_prev, 0, steps)                    # warm-up
    _sync(dev)
    best = float("inf")
    for _ in range(2):
        t0 = time.monotonic()
        blk(st.p, st.p_prev, 0, steps)
        _sync(dev)
        best = min(best, time.monotonic() - t0)

    return {
        "plan": plan,
        "ppermute_latency_s": t_pp,
        "interior_compute_s_per_step": best / steps,
        "n_stripes": n_stripes,
        "mesh_devices": len(set(mesh.devices)) if mesh.group is None
        else mesh.n,
        "backend": dev.type,
    }


def measure_single_device_step(cfg: FWIConfig, steps: int = 30,
                               device="cuda") -> float:
    """Seconds per step of ``run_forward`` (the fused block engine) on
    one device, after a 2-step warm-up."""
    dev = resolve_device(device)
    run_forward(cfg, steps=2, device=dev)
    _sync(dev)
    t0 = time.monotonic()
    run_forward(cfg, steps=steps, device=dev)
    _sync(dev)
    return (time.monotonic() - t0) / steps


def fit_capacity_models(
    cfg: FWIConfig,
    *,
    chip_counts=(8, 16, 32, 64, 128, 256),
    cloud_slowdown: float = 1.4,
    noise: float = 0.01,
    seed: int = 0,
    measured_step_s: float | None = None,
    device="cuda",
) -> tuple[LogCapacityModel, LogCapacityModel, dict]:
    """Fit eqs. 6-7.  Samples = measured 1-device step time / c (ideal
    data-parallel scaling of the striped solver) × environment slowdown,
    with measurement noise — simulated scaling, real fitting path.
    ``measured_step_s`` skips the measurement."""
    t1 = measured_step_s or measure_single_device_step(cfg, device=device)
    rng = np.random.default_rng(seed)
    cs = list(chip_counts)
    t_cluster = [
        t1 / c * (1.0 + noise * abs(rng.standard_normal())) for c in cs
    ]
    t_cloud = [
        t1 / c * cloud_slowdown * (1.0 + noise * abs(rng.standard_normal()))
        for c in cs
    ]
    cluster = LogCapacityModel.fit(cs, t_cluster, "fwi-cluster")
    cloud = LogCapacityModel.fit(cs, t_cloud, "fwi-cloud")
    samples = {
        "chips": cs, "t_cluster": t_cluster, "t_cloud": t_cloud,
        "t1_measured": t1,
    }
    return cluster, cloud, samples
