"""Scenario generator for the hybrid-fleet simulator (DESIGN.md §11).

Each scenario is a reproducible world the policy suite is scored
against: foreground scientific jobs on a shared Site, background tenant
demand (the organic "cluster overloaded" condition), and the fault /
deadline dynamics the ROADMAP's scenario-diversity axis asks for.  The
paper's own experiment is essentially ``overload_ramp`` with one job;
the rest generalize it:

  calm              light contention — the no-cost sanity world
  overload_ramp     sustained tenant ramp past capacity (paper §3.3)
  transient_spike   a spike that clears — tests SHRINK/RETIRE and that
                    cloud spend stops once load is gone
  deadline_squeeze  the deadline tightens mid-run (paper §2 notes it
                    "could also change dynamically")
  spot_market       overload on spot-priced cloud chips that get
                    reclaimed mid-run
  node_failures     on-premise nodes die; jobs fall back to checkpoints
  superlinear_cache overload on a cache-superlinear workload — the
                    regime where cost-aware slice sizing (DESIGN.md
                    §14) buys the same hit-rate for fewer cloud $

Queued (multi-tenant) scenarios drive the fleet layer (DESIGN.md §16):
jobs arrive as a *stream* into the CentralQueue instead of being placed
on arrival, a Scheduler picks placements, and a fleet autoscaler sizes
the shared cloud pool under a global budget:

  multi_tenant_rush three tenants of unequal weight flood the queue
                    far past site capacity — the tournament's overload
                    world (fairness + starvation live here)
  diurnal_stream    a day of sinusoidally-modulated Poisson arrivals —
                    the queue-pressure signal the pool policies track

All sizes are in simulated seconds/chips; a full policy×scenario sweep
runs in well under a minute of wall time on CPU.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import OverheadModel
from repro_torch.core.events import BackgroundLoad
from repro_torch.sim.faults import FaultPlan, RetryPolicy
from repro_torch.sim.fleet import CloudProvider, JobSpec
from repro_torch.sim.queue import Tenant

__all__ = [
    "SEAM_PROBE",
    "SHOT_BATCH_PROBE",
    "Scenario",
    "calm",
    "deadline_squeeze",
    "default_scenarios",
    "diurnal_jobs",
    "diurnal_stream",
    "fault_storm",
    "multi_tenant_rush",
    "node_failures",
    "overheads_from_probe",
    "overload_ramp",
    "poisson_background",
    "poisson_jobs",
    "preemption_pressure",
    "queued_scenarios",
    "shot_batch_model_from_probe",
    "spot_market",
    "superlinear_cache",
    "transient_spike",
]

#: shared world constants — one knob set so scenarios stay comparable
SITE_CHIPS = 256
ONPREM_CHIPS = 128
WORK = 1000.0                    # chip·s per step -> 7.8 s/step on 128

#: MEASURED seam probe for the cross-environment halo synchronization —
#: a committed snapshot of ``fwi.calibrate.measure_seam_latency(
#: FWIConfig(), n_stripes=2, k=4)`` on the card (kept as a literal so
#: the sim layer reads no clock; ``chip_smoke.py``'s ``shot_batch_probe``
#: phase prints it in this form to refresh it).  Recorded 2026-10-17 on
#: one NVIDIA H100 80GB HBM3, power limit 700.00 W (``nvidia-smi
#: --query-gpu=name,power.limit --format=csv,noheader``), both stripes
#: on that one card: the latency is the host's issue of the 2·n·2
#: same-card copies of one packed exchange (the engine's 300 KB k=4
#: payload a stripe) to the last copy's end, not a link between devices,
#: and the interior compute is the stripe interior's block engine per
#: step.  On cards joined by a link the same probe times the link.
#: Here the interior (≈0.1 ms a 4-step block) does not hide the
#: exchange (≈0.3 ms), so, unlike the CPU probe that
#: ``overheads_from_probe``'s docstring describes, the planner is
#: charged a seam of ≈0.05 ms a step.
SEAM_PROBE = {
    "plan": {
        "k": 4, "steps_per_exchange": 4, "ppermutes_per_exchange": 2,
        "ppermutes_per_step": 0.5, "bytes_per_exchange": 307200,
        "bytes_per_step": 76800.0, "interior_cols": 300,
        "boundary_cols": 48, "overlap_fraction": 0.8620689655172413,
        "redundant_frac": 0.10666666666666667,
    },
    "ppermute_latency_s": 0.0001509269999999674,
    "interior_compute_s_per_step": 2.813365624998454e-05,
    "n_stripes": 2,
    "mesh_devices": 1,
    "backend": "cuda",
}


def overheads_from_probe(
    probe: dict, *, ckpt_s: float = 5.0, provision_s: float = 60.0,
    restart_s: float = 15.0,
) -> OverheadModel:
    """Build the planner's ``OverheadModel`` from a measured seam probe
    (``fwi.calibrate.measure_seam_latency``), NOT the dispatch-latency
    floor: ``with_overlapped_seam`` charges only the residue the
    pipeline/overlap engine cannot hide behind the measured
    stripe-interior compute (DESIGN.md §15).  With the committed probe
    the interior block (≈7 ms) dwarfs the packed exchange (≈1 ms), so
    the effective seam is 0 — exactly what the BurstPlanner should
    believe about the overlap-and-fuse engine."""
    return OverheadModel(
        ckpt_s=ckpt_s, provision_s=provision_s, restart_s=restart_s,
    ).with_overlapped_seam(
        probe["plan"], probe["ppermute_latency_s"],
        probe["interior_compute_s_per_step"],
    )


#: MEASURED shot-batch scaling probe for the batched stencil engine —
#: a committed snapshot of the shot-batched block kernel's per-timestep
#: wall clock vs batch size S (600×600, k=8, the kernel's default CTA
#: tile of 32 rows, the port's block runner to the card's end, best of
#: 4; ``chip_smoke.py``'s ``shot_batch_probe`` phase prints it in this
#: form to refresh it).  Recorded 2026-10-17 on one NVIDIA H100 80GB
#: HBM3, power limit 700.00 W.  ``t_step_vmapped_s4`` is four S=1
#: launches a block, one a shot, at the full batch.  At 600² the host's
#: issue of a launch outlasts the card's work, so t_step grows little
#: with S and the batched engine's gain is the launches it saves.
SHOT_BATCH_PROBE = {
    "config": {"nz": 600, "nx": 600, "k": 8, "bz": 32,
               "engine": "wave_block_shots_cuda", "backend": "cuda"},
    "s_values": (1, 2, 4),
    "t_step_s": (6.326243333335905e-06, 7.5587216666643065e-06,
                 7.674531666665984e-06),
    "t_step_vmapped_s4": 2.7771688333331213e-05,
    "batched_vs_vmapped": 3.618681834874226,
}


def shot_batch_model_from_probe(probe: dict | None = None):
    """Fit the planner's ``ShotBatchModel`` (``t_step(s) = a + b·s``)
    from a measured shot-batch probe, so BurstPlanner's deadline
    calculus uses the REAL batched engine's throughput law instead of
    the naive ``s · t_step(1)`` — see ``core.capacity.ShotBatchModel``.
    """
    from repro_torch.core.capacity import ShotBatchModel

    p = probe if probe is not None else SHOT_BATCH_PROBE
    return ShotBatchModel.fit(
        p["s_values"], p["t_step_s"],
        name=p.get("config", {}).get("engine", "shot_batch"),
    )


OVERHEADS = overheads_from_probe(SEAM_PROBE)
CLOUD = CloudProvider(
    legal_slices=(16, 32, 64, 128, 256),
    provision_delay_s=60.0,
    price_per_chip_hour=3.0,
    slowdown=1.4,
)


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    jobs: tuple[JobSpec, ...]
    background: tuple[BackgroundLoad, ...] = ()
    deadline_changes: tuple[tuple[float, str, float], ...] = ()
    failures: tuple[tuple[float, str], ...] = ()
    site_chips: int = SITE_CHIPS
    cloud: CloudProvider = CLOUD
    overheads: OverheadModel = OVERHEADS
    eval_interval_s: float = 30.0
    ckpt_every: int = 25
    description: str = ""
    #: BurstPlanner cost/deadline trade-off knob (DESIGN.md §14);
    #: 0 keeps the deadline-first minimal-slice solve
    planner_cost_weight: float = 0.0
    # ---- fleet-of-jobs layer (DESIGN.md §16); defaults reduce the
    # ---- controller exactly to the PR-2 place-on-arrival FleetSim
    #: "immediate" (no queue) or a SCHEDULER_FACTORIES name
    scheduler: str = "immediate"
    #: "none" (no shared pool) or a FLEET_POLICY_FACTORIES name
    fleet_policy: str = "none"
    #: hard cap on concurrent cloud chips held OR staged fleet-wide
    cloud_chip_cap: int | None = None
    #: $ gate: no NEW provisioning once accrued spend crosses this
    cloud_budget_usd: float = float("inf")
    #: declared fair-share tenants; job tenants missing here get weight 1
    tenants: tuple[Tenant, ...] = ()
    #: starvation guard: a weighted tenant waiting longer than this
    #: blocks all admissions that would overtake it
    starve_patience_s: float = 900.0
    # ---- fault layer (DESIGN.md §19); defaults keep every existing
    # ---- scenario bit-identical (no fault draws are ever taken)
    #: seeded fault mix injected into the run; None = fault-free
    faults: FaultPlan | None = None
    #: provisioning retry/backoff; None = give up on first denial
    retry: RetryPolicy | None = None
    #: hardened rollback: verify checkpoint generations and fall back
    #: to the newest intact one.  False trusts the latest blindly — a
    #: corrupt restore collapses the job back to step 0
    ckpt_integrity: bool = True
    #: checkpoint generations each job keeps (floored to 2)
    ckpt_keep: int = 3
    #: scavenger preemption: checkpoint a running zero-weight job
    #: through the ckpt→restart path to admit an expired weighted one
    preemption: bool = False
    #: admission-time deadline handling for infeasible deadlines:
    #: "accept" (run anyway), "renegotiate" (counter-offer the
    #: capacity-model minimum), "reject" (decline the job)
    admission: str = "accept"
    #: safety margin on the renegotiated counter-offer deadline
    admission_margin: float = 0.1


def _jobs(n: int, *, steps: int, deadline_s: float,
          stagger_s: float = 60.0) -> tuple[JobSpec, ...]:
    return tuple(
        JobSpec(
            name=f"job{i}",
            arrival_s=i * stagger_s,
            steps_total=steps,
            deadline_s=deadline_s,
            chip_seconds_per_step=WORK,
            onprem_chips=ONPREM_CHIPS,
        )
        for i in range(n)
    )


def poisson_background(
    rng: np.random.Generator,
    *,
    rate_per_hour: float,
    mean_duration_s: float,
    mean_chips: float,
    horizon_s: float,
) -> tuple[BackgroundLoad, ...]:
    """Poisson tenant arrivals with exponential durations — demand that
    *emerges* from a stochastic process rather than a script."""
    loads = []
    t = 0.0
    while True:
        t += float(rng.exponential(3600.0 / rate_per_hour))
        if t >= horizon_s:
            break
        dur = float(rng.exponential(mean_duration_s))
        chips = max(8, int(rng.poisson(mean_chips)))
        loads.append(BackgroundLoad(t, t + dur, chips))
    return tuple(loads)


def calm(seed: int = 0) -> Scenario:
    rng = np.random.default_rng([seed, 100])
    return Scenario(
        name="calm",
        jobs=_jobs(2, steps=150, deadline_s=1700.0),
        background=poisson_background(
            rng, rate_per_hour=4.0, mean_duration_s=200.0,
            mean_chips=32.0, horizon_s=1500.0,
        ),
        description="light tenant load; every policy should hit at "
                    "(near-)zero cloud cost",
    )


def overload_ramp(seed: int = 0) -> Scenario:
    return Scenario(
        name="overload_ramp",
        jobs=_jobs(2, steps=200, deadline_s=2100.0),
        background=(
            BackgroundLoad(300.0, 10.0 ** 9, 128, name="ramp1"),
            BackgroundLoad(500.0, 10.0 ** 9, 256, name="ramp2"),
        ),
        description="sustained tenant ramp to 2.5x capacity — the paper "
                    "§3.3 congestion, emergent from demand",
    )


def transient_spike(seed: int = 0) -> Scenario:
    return Scenario(
        name="transient_spike",
        jobs=_jobs(2, steps=250, deadline_s=2700.0),
        background=(
            BackgroundLoad(200.0, 600.0, 384, name="spike"),
        ),
        description="a 400 s contention spike that clears — the right "
                    "move is burst-then-retire; cloud spend must stop",
    )


def deadline_squeeze(seed: int = 0) -> Scenario:
    jobs = _jobs(2, steps=200, deadline_s=2600.0)
    return Scenario(
        name="deadline_squeeze",
        jobs=jobs,
        background=(BackgroundLoad(300.0, 10.0 ** 9, 128, name="ramp"),),
        deadline_changes=tuple(
            (800.0, j.name, 2000.0) for j in jobs
        ),
        description="moderate load, then the deadline tightens from "
                    "2600 s to 2000 s mid-run",
    )


def spot_market(seed: int = 0) -> Scenario:
    base = overload_ramp(seed)
    return dataclasses.replace(
        base,
        name="spot_market",
        jobs=tuple(
            dataclasses.replace(j, deadline_s=2400.0) for j in base.jobs
        ),
        cloud=dataclasses.replace(
            CLOUD, spot=True, spot_mean_life_s=700.0,
            price_per_chip_hour=1.0,
        ),
        description="overload on spot chips: cheaper, but pods get "
                    "reclaimed and jobs fall back to checkpoints",
    )


def node_failures(seed: int = 0) -> Scenario:
    rng = np.random.default_rng([seed, 200])
    jobs = _jobs(2, steps=200, deadline_s=2500.0)
    fails = tuple(
        (float(rng.uniform(400.0, 1400.0)), j.name) for j in jobs
    )
    return Scenario(
        name="node_failures",
        jobs=jobs,
        background=(BackgroundLoad(200.0, 10.0 ** 9, 96, name="bg"),),
        failures=fails,
        description="on-premise node failures force rollbacks to the "
                    "last checkpoint under moderate load",
    )


def superlinear_cache(seed: int = 0,
                      cost_weight: float = 0.6) -> Scenario:
    """Overload on a cache-superlinear workload (t ∝ 1/c^1.3): striped
    stencils whose per-device domains go cache-resident speed up faster
    than linearly, so a larger slice finishes and retires early enough
    to bill *fewer* chip-hours — the regime where the cost-aware
    planner's larger-but-cheaper choice is real (DESIGN.md §14).  Run
    with ``cost_weight=0`` for the cost-blind bracket."""
    alpha = 1.3
    # normalize W so the on-premise step time matches the other
    # scenarios (7.8 s/step on 128 chips) despite the steeper law
    work = WORK * float(ONPREM_CHIPS ** (alpha - 1.0))
    jobs = tuple(
        dataclasses.replace(j, chip_seconds_per_step=work,
                            scaling_alpha=alpha, deadline_s=2300.0)
        for j in _jobs(2, steps=200, deadline_s=2300.0)
    )
    return Scenario(
        name="superlinear_cache",
        jobs=jobs,
        background=(
            BackgroundLoad(300.0, 10.0 ** 9, 192, name="ramp"),
        ),
        planner_cost_weight=cost_weight,
        description="sustained overload on a superlinearly-scaling "
                    "workload — cost-aware sizing should buy the same "
                    "hit-rate for fewer cloud $",
    )


def fault_storm(seed: int = 0, *, hardened: bool = True) -> Scenario:
    """Overload under an adversarial fault mix (DESIGN.md §19): the
    ``overload_ramp`` world where bursting is *required* to hit the
    deadline, plus provisioning denials/timeouts, two market-wide
    reclaim storms, frequent silent checkpoint corruption, and
    straggler pods.  ``hardened=True`` arms the robustness machinery
    (retry/backoff + checkpoint-integrity fallback); ``hardened=False``
    is the unhardened baseline — one provisioning denial gives up, and
    a corrupt latest checkpoint is trusted blindly, collapsing the
    rollback to step 0.  The fault draws themselves are identical in
    both variants (same FaultPlan, same seeds)."""
    plan = FaultPlan(
        provision_fail_p=0.35,
        provision_timeout_p=0.25,
        provision_timeout_x=3.0,
        # one market-wide crunch late in the run: every elastic pod is
        # reclaimed when a full restart can no longer make the deadline
        # but a newest-intact-generation fallback still can
        reclaim_storms=((1450.0, 1.0),),
        ckpt_corrupt_p=0.6,
        straggler_p=0.1,
        straggler_x=2.0,
    )
    return Scenario(
        name="fault_storm",
        jobs=_jobs(2, steps=200, deadline_s=2200.0),
        background=(
            BackgroundLoad(300.0, 10.0 ** 9, 128, name="ramp1"),
            BackgroundLoad(500.0, 10.0 ** 9, 256, name="ramp2"),
        ),
        ckpt_every=20,
        ckpt_keep=4,
        faults=plan,
        retry=RetryPolicy(max_retries=4, base_s=10.0, mult=2.0,
                          cap_s=120.0) if hardened else None,
        ckpt_integrity=hardened,
        description="overload_ramp under provisioning denials, reclaim "
                    "storms, checkpoint corruption and stragglers — "
                    "the hardened loop keeps its hit-rate where the "
                    "unhardened baseline collapses",
    )


def preemption_pressure(seed: int = 0) -> Scenario:
    """A scavenger monopolizes the site when a weighted job arrives:
    with ``preemption=True`` the starvation guard checkpoints the
    zero-weight job through the ckpt→restart path and admits the
    expired weighted entry within one evaluation interval
    (DESIGN.md §19)."""
    work = 8.0 * 128
    return Scenario(
        name="preemption_pressure",
        jobs=(
            JobSpec(name="scav0", arrival_s=0.0, steps_total=400,
                    deadline_s=10.0 ** 6, chip_seconds_per_step=work,
                    onprem_chips=128, tenant="scav"),
            JobSpec(name="gold0", arrival_s=60.0, steps_total=60,
                    deadline_s=1500.0, chip_seconds_per_step=work,
                    onprem_chips=128, tenant="gold"),
        ),
        site_chips=128,
        scheduler="fill",
        tenants=(Tenant("gold", weight=2.0), Tenant("scav", weight=0.0)),
        starve_patience_s=180.0,
        preemption=True,
        description="a long scavenger holds the whole site; the "
                    "starved weighted job is admitted by preempting it",
    )


def default_scenarios(seed: int = 0) -> tuple[Scenario, ...]:
    return (
        calm(seed),
        overload_ramp(seed),
        transient_spike(seed),
        deadline_squeeze(seed),
        spot_market(seed),
        node_failures(seed),
        superlinear_cache(seed),
    )


# ---- job streams for the fleet layer (DESIGN.md §16) ----------------------

def _stream_job(
    rng: np.random.Generator, i: int, t: float,
    tenants: tuple[str, ...],
    steps_rng: tuple[int, int], chips_choices: tuple[int, ...],
    work_per_chip_s: float, slack: tuple[float, float],
    name_prefix: str,
) -> JobSpec:
    """One job of a stream: small (site fits several at once), with a
    deadline drawn as a slack multiple of its own on-premise runtime —
    so queue wait is exactly what eats the slack under overload."""
    steps = int(rng.integers(steps_rng[0], steps_rng[1] + 1))
    chips = int(rng.choice(np.asarray(chips_choices)))
    work = work_per_chip_s * chips       # work_per_chip_s s/step on-prem
    run_s = steps * work_per_chip_s
    return JobSpec(
        name=f"{name_prefix}{i}",
        arrival_s=t,
        steps_total=steps,
        deadline_s=run_s * float(rng.uniform(*slack)),
        chip_seconds_per_step=work,
        onprem_chips=chips,
        tenant=tenants[i % len(tenants)],
    )


def poisson_jobs(
    rng: np.random.Generator,
    *,
    n: int,
    rate_per_hour: float,
    tenants: tuple[str, ...] = ("user0",),
    steps_rng: tuple[int, int] = (20, 60),
    chips_choices: tuple[int, ...] = (16, 32, 64),
    work_per_chip_s: float = 8.0,
    slack: tuple[float, float] = (4.0, 10.0),
    name_prefix: str = "job",
) -> tuple[JobSpec, ...]:
    """A Poisson stream of ``n`` foreground jobs, tenants assigned
    round-robin (so tenant mix is exact, not sampled)."""
    out = []
    t = 0.0
    for i in range(n):
        t += float(rng.exponential(3600.0 / rate_per_hour))
        out.append(_stream_job(
            rng, i, t, tenants, steps_rng, chips_choices,
            work_per_chip_s, slack, name_prefix,
        ))
    return tuple(out)


def diurnal_jobs(
    rng: np.random.Generator,
    *,
    n: int,
    base_rate_per_hour: float,
    peak_rate_per_hour: float,
    period_s: float = 86400.0,
    tenants: tuple[str, ...] = ("user0",),
    steps_rng: tuple[int, int] = (20, 60),
    chips_choices: tuple[int, ...] = (16, 32, 64),
    work_per_chip_s: float = 8.0,
    slack: tuple[float, float] = (4.0, 10.0),
    name_prefix: str = "job",
) -> tuple[JobSpec, ...]:
    """Sinusoidally-modulated Poisson arrivals (thinning construction):
    the rate climbs from ``base`` at t=0 to ``peak`` half a period in —
    the day/night pressure signal the pool forecasters track."""
    out = []
    t = 0.0
    i = 0
    while i < n:
        t += float(rng.exponential(3600.0 / peak_rate_per_hour))
        phase = 0.5 - 0.5 * math.cos(2.0 * math.pi * t / period_s)
        rate = (base_rate_per_hour
                + (peak_rate_per_hour - base_rate_per_hour) * phase)
        if float(rng.uniform()) * peak_rate_per_hour > rate:
            continue                     # thinned out
        out.append(_stream_job(
            rng, i, t, tenants, steps_rng, chips_choices,
            work_per_chip_s, slack, name_prefix,
        ))
        i += 1
    return tuple(out)


def multi_tenant_rush(seed: int = 0, n_jobs: int = 60,
                      rate_per_hour: float = 240.0,
                      budget_usd: float = 400.0) -> Scenario:
    """Three tenants of unequal weight flood the queue far past site
    capacity: sustained offered load ≈ 3× the 256-chip site, so hit
    rates separate on (scheduler, fleet-policy) quality and the
    fairness column is live.  ``n_jobs=1000+`` is the tournament's
    thousand-concurrent-jobs configuration — same world, longer rush."""
    rng = np.random.default_rng([seed, 300])
    return Scenario(
        name="multi_tenant_rush",
        jobs=poisson_jobs(
            rng, n=n_jobs, rate_per_hour=rate_per_hour,
            tenants=("gold", "silver", "silver", "scav"),
        ),
        scheduler="fill",
        fleet_policy="adapt",
        cloud_chip_cap=512,
        cloud_budget_usd=budget_usd,
        tenants=(
            Tenant("gold", weight=3.0, priority=1.0),
            Tenant("silver", weight=1.0),
            Tenant("scav", weight=0.0),     # scavenger: runs on leftovers
        ),
        starve_patience_s=600.0,
        description="weighted tenants rush the queue at ~3x site "
                    "capacity; placement + pool policy decide who hits",
    )


def diurnal_stream(seed: int = 0, n_jobs: int = 48,
                   budget_usd: float = 300.0) -> Scenario:
    """A compressed day of diurnal arrivals from two equal tenants: the
    pool forecasters (reg/conpaas) get a predictable pressure wave to
    track; over-provisioning shows up directly in pool_cost."""
    rng = np.random.default_rng([seed, 400])
    return Scenario(
        name="diurnal_stream",
        jobs=diurnal_jobs(
            rng, n=n_jobs, base_rate_per_hour=30.0,
            peak_rate_per_hour=360.0, period_s=7200.0,
            tenants=("ops", "research"),
        ),
        scheduler="best-fit",
        fleet_policy="reg",
        cloud_chip_cap=512,
        cloud_budget_usd=budget_usd,
        tenants=(Tenant("ops"), Tenant("research")),
        description="sinusoidal arrival wave (2 h period): forecasting "
                    "pool policies should pre-provision into the crest "
                    "and drain into the trough",
    )


def queued_scenarios(seed: int = 0) -> tuple[Scenario, ...]:
    """The fleet-layer worlds the tournament runs (DESIGN.md §16)."""
    return (multi_tenant_rush(seed), diurnal_stream(seed))
