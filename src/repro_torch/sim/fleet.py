"""Discrete-event hybrid-fleet simulator (DESIGN.md §11, §16).

The paper evaluates one job bursting once from one loaded cluster.  This
module drives the *same single-job decision code* — StepTimeMonitor,
DeadlinePredictor, BurstPlanner, SimSession, the orchestrator's
apply_scale γ re-split — at fleet scale:

  Site             on-premise capacity; foreground jobs plus background
                   tenant arrivals create demand, and the "cluster
                   overloaded" condition is *emergent* contention
                   (demand / capacity), not a scripted SlowdownWindow
  CloudProvider    elastic capacity with provisioning delay,
                   per-chip-hour price, legal slice shapes, optional
                   spot reclaims
  JobController    per-job runtime: one session, one monitor/predictor/
                   planner, one per-job autoscaler policy — the paper's
                   whole Fig. 1 loop, owned per job
  FleetController  the fleet-of-jobs layer (DESIGN.md §16): owns the
                   site(s), the provider, the CentralQueue + placement
                   Scheduler, the pre-provisioned cloud pool a
                   FleetAutoscaler sizes on queue pressure, the global
                   cloud-budget caps, and all billing
  FleetSim         the PR-2 name for the event loop; now a thin alias
                   of FleetController

Decisions compose from two levels: the fleet level admits queued jobs
(fair-share order, scheduler placement, starvation guard) and converges
the shared cloud pool toward the queue-driven policy's target; the job
level runs the paper's deadline loop and asks for GROW/SHRINK/RETIRE,
which the fleet arbitrates under the global caps — pool chips first
(no provisioning delay), then max-min-fair provisioning headroom.

Per job, the policy's ScaleAction takes effect at the next step boundary
through CHECKPOINT → REMESH → RESHARD → RESUME, exactly like the
orchestrator's burst path: grow pays the full overhead chain (minus
provisioning, which overlaps with execution in the fleet), shrink/retire
pay checkpoint + restart.  Reclaims and failures roll the job back to
its last checkpoint.  All randomness flows from per-job seeded
Generators, so runs are bit-deterministic for a given (scenario,
scheduler, policy, seed) tuple.

Fault layer (DESIGN.md §19): a scenario may carry a ``FaultPlan`` —
provisioning denials/timeouts (retried under the scenario's
``RetryPolicy`` with capped exponential backoff, surfacing ``retries``
/ ``gave_up``), correlated reclaim storms, silently-corrupt checkpoint
writes (rollback falls back to the newest *intact* generation when
``ckpt_integrity`` is on; an unhardened run trusts the latest blindly
and collapses to step 0), and straggler pods attaching with a degraded
K.  On top of the fault layer the admission pass gains scavenger
*preemption* (checkpoint a running zero-weight job through the
ckpt→restart path to admit an expired weighted entry) and admission-
time deadline *renegotiation* (counter-offer or reject an infeasible
deadline using the same calibrated capacity model the planner sizes
with).  All fault draws come from dedicated per-job seeded streams, so
fault runs stay bit-deterministic per (scenario, policy, seed).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable

import numpy as np

from repro_torch.core import (
    BurstPlanner,
    DeadlinePredictor,
    ElasticOrchestrator,
    LogCapacityModel,
    PodSpec,
    Resources,
    ScaleAction,
    ScaleContext,
    StepTimeMonitor,
    elastic_chips,
    floor_to_legal_slice,
    max_min_fair_allocation,
    min_weighted_share,
    proportional_shares,
    round_to_legal_slice,
)
from repro_torch.core.events import BackgroundLoad
from repro_torch.core.orchestrator import AutoscalerPolicy
from repro_torch.core.sim_session import SimSession, SimWorkload
from repro_torch.sim.autoscalers import (
    FLEET_POLICY_FACTORIES,
    FleetAutoscaler,
    FleetContext,
)
from repro_torch.sim.faults import FaultInjector, RetryPolicy
from repro_torch.sim.queue import CentralQueue, QueueEntry, Tenant, tenants_for
from repro_torch.sim.schedulers import CLOUD, SCHEDULER_FACTORIES, SITE, Scheduler

__all__ = [
    "CloudProvider",
    "FleetController",
    "FleetRecord",
    "FleetSim",
    "JobController",
    "JobRecord",
    "JobSpec",
    "RENTED_POD",
    "Site",
]

_MAX_EVENTS = 2_000_000

#: base-pod name for jobs the scheduler places ON the cloud pool
#: (VM-MAD-style cluster expansion).  Deliberately NOT an
#: ELASTIC_PREFIXES name: the per-job policy may still grow/retire an
#: elastic pod on top without apply_scale dropping the job's home pod.
RENTED_POD = "rented"


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One foreground scientific job (the paper's FWI analogue)."""

    name: str
    arrival_s: float
    steps_total: int
    deadline_s: float                 # relative to arrival
    chip_seconds_per_step: float      # work per step (chip·s)
    onprem_chips: int
    jitter: float = 0.01
    #: rate-law exponent t_step ∝ 1 / chips**alpha (SimWorkload docs);
    #: the per-job capacity models are fitted on the same law, so the
    #: paper's pre-processing fit stays exact
    scaling_alpha: float = 1.0
    #: fair-share tenant this job bills against (DESIGN.md §16)
    tenant: str = "user0"
    #: per-job priority boost on top of the tenant's (queue tie-break)
    priority: float = 0.0


class Site:
    """On-premise cluster: finite chips shared by foreground jobs and
    background tenants.  Oversubscription slows every on-premise pod by
    demand/capacity — the organic version of the paper's congestion."""

    def __init__(self, chips: int, name: str = "site"):
        self.chips = chips
        self.name = name
        self._fg_chips: dict[str, int] = {}
        self.background: tuple[BackgroundLoad, ...] = ()

    def attach(self, job: str, chips: int) -> None:
        self._fg_chips[job] = chips

    def release(self, job: str) -> None:
        self._fg_chips.pop(job, None)

    def foreground(self) -> int:
        return sum(self._fg_chips.values())

    def free(self) -> int:
        """Chips not held by foreground jobs (background tenants do not
        reserve capacity — they contend for it, see contention())."""
        return max(self.chips - self.foreground(), 0)

    def demand(self, t: float) -> int:
        bg = sum(
            b.chips for b in self.background if b.start_s <= t < b.end_s
        )
        return self.foreground() + bg

    def contention(self, t: float) -> float:
        return max(1.0, self.demand(t) / self.chips)


@dataclasses.dataclass(frozen=True)
class CloudProvider:
    """Elastic environment: what the paper calls "the cloud"."""

    legal_slices: tuple[int, ...] = (16, 32, 64, 128, 256)
    provision_delay_s: float = 90.0
    price_per_chip_hour: float = 3.0
    slowdown: float = 1.4             # paper's K per cloud chip
    spot: bool = False
    spot_mean_life_s: float = 1800.0

    def cost(self, chip_seconds: float) -> float:
        return chip_seconds / 3600.0 * self.price_per_chip_hour


@dataclasses.dataclass
class JobRecord:
    name: str
    finished: bool
    finish_s: float
    elapsed_s: float
    deadline_s: float
    met_deadline: bool
    steps_total: int
    cloud_chip_s: float
    cloud_cost: float
    overhead_s: float
    rollbacks: int
    events: list[tuple[float, str, dict]]
    tenant: str = "user0"
    #: finished | running | queued | pending (pre-arrival) | rejected
    state: str = "finished"
    wait_s: float = 0.0               # queue wait before placement
    # ---- fault layer (DESIGN.md §19) ----
    retries: int = 0                  # provisioning attempts denied
    gave_up: bool = False             # a grow request was abandoned
    preemptions: int = 0              # times checkpointed off the site
    renegotiated: bool = False        # deadline counter-offered at admit


@dataclasses.dataclass
class FleetRecord:
    scenario: str
    policy: str
    jobs: list[JobRecord]
    hit_rate: float
    cloud_cost: float
    useful_frac: float
    cloud_timeline: list[tuple[float, int]]   # (t, fleet cloud chips)
    makespan_s: float
    scheduler: str = "immediate"
    fleet_policy: str = "none"
    #: max-min fairness of realized per-tenant service (allocator.
    #: min_weighted_share); 1.0 for single-tenant scenarios
    fairness: float = 1.0
    mean_wait_s: float = 0.0
    max_wait_s: float = 0.0
    queued_at_end: int = 0
    pool_cost: float = 0.0            # idle pool $ (included in cloud_cost)
    fleet_events: list[tuple[float, str, dict]] = dataclasses.field(
        default_factory=list
    )


class JobController:
    """Per-job controller: one session plus the paper's Fig. 1 loop
    state (monitor, predictor, planner, per-job policy).  The
    FleetController owns everything shared; this object owns exactly
    one job's runtime (DESIGN.md §16)."""

    def __init__(self, spec: JobSpec, policy: AutoscalerPolicy):
        self.spec = spec
        self.policy = policy
        self.res: Resources | None = None
        self.session: SimSession | None = None
        self.monitor = StepTimeMonitor()
        self.predictor = DeadlinePredictor(spec.deadline_s)
        self.planner: BurstPlanner | None = None
        self.rng: np.random.Generator | None = None
        self.spot_rng: np.random.Generator | None = None
        self.steps_done = 0
        self.last_ckpt = None
        self.last_ckpt_step = 0
        #: checkpoint generations, oldest first: (step, state, intact);
        #: the initial state is an implicit intact generation (§19)
        self.ckpt_gens: list[tuple[int, object, bool]] = [(0, None, True)]
        self.faults: FaultInjector | None = None
        self.retries = 0              # provisioning attempts denied
        self.gave_up = False
        self.provision_failures = 0   # consecutive, reset on success
        self.last_failure_s = -math.inf
        self.preemptions = 0
        self.site_banked_chip_s = 0.0  # site chip·s served pre-preemption
        self.rejected = False
        self.renegotiated = False
        self.ever_placed = False
        self.arrived = False
        self.queued = False
        self.finished = False
        self.finish_s = 0.0
        self.admit_s = 0.0            # placement time (== arrival when
        self.wait_s = 0.0             # admission is immediate)
        self.step_epoch = 0           # invalidates in-flight step events
        self.cloud_epoch = 0          # invalidates stale spot reclaims
        self.pending_action: ScaleAction | None = None
        self.pending_target = 0       # chips requested, not yet online
        self.staged_from_pool = 0     # staged chips drawn from the pool
        self.rented_chips = 0         # cloud-hosted base pod (CLOUD place)
        self.cloud_since = 0.0
        self.cloud_chip_s = 0.0
        self.overhead_s = 0.0
        self.rollbacks = 0
        self.events: list[tuple[float, str, dict]] = []

    @property
    def cloud_chips(self) -> int:
        return elastic_chips(self.res) if self.res else 0

    @property
    def billable_chips(self) -> int:
        """Cloud chips currently billing: the elastic pod plus a
        cloud-hosted (rented) base pod."""
        return self.cloud_chips + self.rented_chips

    def staged_grow(self) -> int:
        """Chips staged by a pending grow (pool draw or completed
        provision awaiting the step boundary)."""
        if (self.pending_action is not None
                and self.pending_action.kind == "grow"):
            return self.pending_action.chips
        return 0

    def cloud_committed(self) -> int:
        """This job's full cloud footprint for the global caps: chips
        held OR staged for it (the PR 4 double-request fix, fleet-wide:
        staged pods count, DESIGN.md §16) plus its rented base pod."""
        return (
            max(self.cloud_chips, self.pending_target, self.staged_grow())
            + self.rented_chips
        )

    @property
    def state(self) -> str:
        if self.rejected:
            return "rejected"
        if self.finished:
            return "finished"
        if self.arrived:
            return "running"
        if self.queued:
            return "queued"
        return "pending"


#: PR-2 name of the per-job runtime, kept for external callers
_JobRt = JobController


class FleetController:
    """Event-driven multi-job run of one scenario (DESIGN.md §16).

    Owns the shared world — Site, CloudProvider, CentralQueue +
    Scheduler, the fleet-policy-sized cloud pool, the global budget
    caps and all billing — and one JobController per job.  With the
    scenario's default ``scheduler="immediate"`` (and no fleet policy
    or caps) it reduces exactly to the PR-2 FleetSim: every job is
    placed on arrival and scales independently.
    """

    def __init__(
        self,
        scenario,                      # scenarios.Scenario
        policy_factory: Callable[[], AutoscalerPolicy],
        *,
        seed: int = 0,
        scheduler: Scheduler | str | None = None,
        fleet_policy: FleetAutoscaler | str | None = None,
    ):
        self.sc = scenario
        self.site = Site(scenario.site_chips)
        self.site.background = tuple(scenario.background)
        self.cloud: CloudProvider = scenario.cloud
        self.seed = seed
        self.now = 0.0
        self._seq = 0
        self._heap: list[tuple[float, int, str, tuple]] = []
        self.jobs = [
            JobController(spec, policy_factory()) for spec in scenario.jobs
        ]
        self.cloud_timeline: list[tuple[float, int]] = [(0.0, 0)]

        # ---- fleet-of-jobs layer (all off by default) --------------------
        sched = scheduler if scheduler is not None else \
            getattr(scenario, "scheduler", "immediate")
        if isinstance(sched, str):
            sched = (
                None if sched == "immediate"
                else SCHEDULER_FACTORIES[sched]()
            )
        self.scheduler: Scheduler | None = sched
        fp = fleet_policy if fleet_policy is not None else \
            getattr(scenario, "fleet_policy", "none")
        if isinstance(fp, str):
            fp = (
                None if fp in ("", "none")
                else FLEET_POLICY_FACTORIES[fp]()
            )
        self.fleet_policy: FleetAutoscaler | None = fp
        self.queue = CentralQueue(
            tenants_for(
                (s.tenant for s in scenario.jobs),
                getattr(scenario, "tenants", ()),
            )
        )
        self.chip_cap: int | None = getattr(scenario, "cloud_chip_cap", None)
        self.budget_usd: float = getattr(
            scenario, "cloud_budget_usd", math.inf
        )
        self.starve_patience_s: float = getattr(
            scenario, "starve_patience_s", 900.0
        )
        # ---- fault layer + robustness knobs (DESIGN.md §19) --------------
        self.faults = getattr(scenario, "faults", None)
        self.retry: RetryPolicy | None = getattr(scenario, "retry", None)
        self.ckpt_integrity: bool = getattr(
            scenario, "ckpt_integrity", True
        )
        self.ckpt_keep: int = max(getattr(scenario, "ckpt_keep", 3), 2)
        self.preemption: bool = getattr(scenario, "preemption", False)
        self.admission: str = getattr(scenario, "admission", "accept")
        self.admission_margin: float = getattr(
            scenario, "admission_margin", 0.1
        )
        if self.faults is not None:
            for i, j in enumerate(self.jobs):
                j.faults = FaultInjector(self.faults, seed, i)
        #: fleet-level stream for the pool's storm draw (per-job storm
        #: hits come from each job's own injector stream)
        self._storm_rng = (
            np.random.default_rng([seed, 911])
            if self.faults is not None else None
        )
        # the shared pre-provisioned pool the fleet policy sizes
        self.pool_free = 0
        self.pool_pending = 0
        self.pool_since = 0.0
        self.pool_chip_s = 0.0
        self._tenant_served: dict[str, float] = {}
        self._fairness_sum = 0.0
        self._fairness_n = 0
        self.fleet_events: list[tuple[float, str, dict]] = []

        if self.scheduler is not None:
            biggest = max(
                self.site.chips,
                max(self.cloud.legal_slices)
                if self.fleet_policy is not None else 0,
            )
            for s in scenario.jobs:
                if s.onprem_chips > biggest:
                    raise ValueError(
                        f"job {s.name!r} requests {s.onprem_chips} chips "
                        f"but no placement target can ever hold more "
                        f"than {biggest}"
                    )

    # ---- event plumbing ---------------------------------------------------

    def _push(self, t: float, kind: str, payload: tuple = ()) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, payload))

    def _fleet_event(self, kind: str, detail: dict) -> None:
        self.fleet_events.append((self.now, kind, detail))

    # ---- job lifecycle ----------------------------------------------------

    def _make_session(self, jrt: JobController, start_step: int,
                      restored) -> SimSession:
        def contention_slowdown(i: int, step: int, jrt=jrt) -> float:
            pod = jrt.res.pods[i]
            if pod.name == self.site.name:
                return self.site.contention(self.now)
            return 1.0

        return SimSession(
            SimWorkload(jrt.spec.chip_seconds_per_step, jrt.spec.jitter,
                        scaling_alpha=jrt.spec.scaling_alpha),
            jrt.res, start_step, restored,
            rng=jrt.rng,
            extra_slowdown=contention_slowdown,
        )

    def _make_planner(self, spec: JobSpec) -> BurstPlanner:
        """Per-job capacity models from the workload's own scaling law
        (t = W/c**α), cloud curve K× above — the paper's pre-processing
        fit, done analytically since the simulated law is known."""
        cs = sorted(set(self.cloud.legal_slices) | {spec.onprem_chips})
        w = spec.chip_seconds_per_step
        a = spec.scaling_alpha
        return BurstPlanner(
            cluster_model=LogCapacityModel.fit(
                cs, [w / c ** a for c in cs], name="site"),
            cloud_model=LogCapacityModel.fit(
                cs, [self.cloud.slowdown * w / c ** a for c in cs],
                name="cloud"),
            chips_cluster=spec.onprem_chips,
            legal_slices=self.cloud.legal_slices,
            overheads=self.sc.overheads,
            price_per_chip_hour=self.cloud.price_per_chip_hour,
            cost_weight=self.sc.planner_cost_weight,
        )

    def _min_completion_s(self, spec: JobSpec) -> float:
        """Best-case completion time the calibrated capacity model can
        promise (DESIGN.md §19): home pod plus the largest legal slice
        at the provider's K (seam included), plus one full overhead
        chain — the feasibility bound admission renegotiation uses."""
        planner = self._make_planner(spec)
        t_best = planner._post_burst_step_time(
            max(self.cloud.legal_slices), self.cloud.slowdown
        )
        return spec.steps_total * t_best + self.sc.overheads.total()

    def _arrive(self, jrt: JobController) -> None:
        spec = jrt.spec
        if self.admission in ("renegotiate", "reject"):
            t_min = self._min_completion_s(spec)
            if spec.deadline_s < t_min:
                if self.admission == "reject":
                    # the paper's rejection case: tell the tenant the
                    # deadline cannot be met; the job never runs and is
                    # excluded from the hit-rate denominator
                    jrt.rejected = True
                    jrt.events.append((self.now, "admission_rejected", {
                        "deadline_s": spec.deadline_s,
                        "min_feasible_s": t_min,
                    }))
                    self._fleet_event("admission_rejected", {
                        "job": spec.name, "deadline_s": spec.deadline_s,
                        "min_feasible_s": t_min,
                    })
                    return
                offer = t_min * (1.0 + self.admission_margin)
                jrt.predictor.set_deadline(offer, at_s=self.now)
                jrt.renegotiated = True
                jrt.events.append((self.now, "deadline_renegotiated", {
                    "asked_s": spec.deadline_s, "offered_s": offer,
                    "min_feasible_s": t_min,
                }))
        if self.scheduler is not None:
            jrt.queued = True
            self.queue.push(QueueEntry(
                name=spec.name, tenant=spec.tenant,
                chips=spec.onprem_chips,
                work_chip_s=spec.steps_total * spec.chip_seconds_per_step,
                enqueued_s=self.now, priority=spec.priority,
            ))
            jrt.events.append((self.now, "queued", {
                "chips": spec.onprem_chips, "tenant": spec.tenant,
            }))
            self._admit_pass()
            return
        self._place(jrt, SITE)

    def _place(self, jrt: JobController, placement: str) -> None:
        """Start a job on its placement target — the one path by which
        a job begins running, whether admitted immediately (legacy),
        from the queue by the scheduler, or *resumed* from its newest
        intact checkpoint generation after a preemption (§19)."""
        spec = jrt.spec
        resuming = jrt.ever_placed
        if jrt.rng is None:
            idx = self.jobs.index(jrt)
            jrt.rng = np.random.default_rng([self.seed, idx])
            jrt.spot_rng = np.random.default_rng([self.seed, idx, 1])
        if placement == SITE:
            base = PodSpec(spec.onprem_chips, name=self.site.name)
            self.site.attach(spec.name, spec.onprem_chips)
        else:
            # VM-MAD-style expansion: the job's home pod lives on
            # pre-provisioned pool chips at the provider's K
            self._bill_pool()
            assert self.pool_free >= spec.onprem_chips, (
                "scheduler placed onto more pool than exists"
            )
            self.pool_free -= spec.onprem_chips
            jrt.rented_chips = spec.onprem_chips
            jrt.cloud_since = self.now
            base = PodSpec(
                spec.onprem_chips, slowdown=self.cloud.slowdown,
                name=RENTED_POD,
            )
            self._fleet_event("pool_host", {
                "job": spec.name, "chips": spec.onprem_chips,
            })
        jrt.res = Resources(pods=[base], shares=[1.0])
        if jrt.planner is None:
            jrt.planner = self._make_planner(spec)
        start, restored = self._restore_ckpt(jrt)
        jrt.steps_done = start
        jrt.session = self._make_session(jrt, start, restored)
        jrt.monitor.reset_window()
        jrt.arrived = True
        jrt.queued = False
        jrt.admit_s = self.now
        if resuming:
            jrt.events.append((self.now, "resume", {
                "resume_step": start, "placement": placement,
            }))
        else:
            jrt.wait_s = max(self.now - spec.arrival_s, 0.0)
            jrt.events.append((self.now, "arrival", {}))
        jrt.ever_placed = True
        if self.scheduler is not None:
            self._record_timeline()
        self._start_step(
            jrt,
            extra_delay_s=self.sc.overheads.restart_s if resuming else 0.0,
        )

    # ---- admission (queued modes only) ------------------------------------

    def _tenant_usage(self) -> dict[str, float]:
        """Served chip·seconds per tenant up to `now`: the home pod's
        chips over its held interval plus billed/accrued cloud time —
        the usage the fair-share deficit ranking normalizes by weight."""
        usage = dict(self._tenant_served)
        for j in self.jobs:
            if not j.arrived:
                continue
            end = j.finish_s if j.finished else self.now
            held = j.spec.onprem_chips * max(end - j.admit_s, 0.0)
            cloud = j.cloud_chip_s
            if not j.finished and j.billable_chips > 0:
                cloud += j.billable_chips * max(
                    self.now - j.cloud_since, 0.0
                )
            usage[j.spec.tenant] = (
                usage.get(j.spec.tenant, 0.0) + held + cloud
            )
        return usage

    def _tenant_demand(self, usage: dict[str, float]) -> dict[str, float]:
        """Demand ceiling per tenant: what it consumed plus the work it
        still has queued or in flight — the bound that keeps the
        fairness score from blaming the scheduler for tenants that
        simply asked for less than their entitlement."""
        demand = dict(usage)
        for j in self.jobs:
            if j.finished or not (j.queued or j.arrived):
                continue
            steps_left = j.spec.steps_total - (
                j.steps_done if j.arrived else 0
            )
            demand[j.spec.tenant] = (
                demand.get(j.spec.tenant, 0.0)
                + steps_left * j.spec.chip_seconds_per_step
            )
        return demand

    def _fairness_snapshot(self) -> float:
        usage = self._tenant_usage()
        demand = self._tenant_demand(usage)
        tenants = sorted({j.spec.tenant for j in self.jobs})
        return min_weighted_share(
            [usage.get(t, 0.0) for t in tenants],
            [self.queue.tenants.get(t, Tenant(t)).weight
             for t in tenants],
            [demand.get(t, 0.0) for t in tenants],
        )

    def _admit_pass(self) -> None:
        """One admission round: fair-share-order the queue, enforce the
        starvation guard, let the Scheduler pick placements, start the
        picked jobs.  Site capacity is never over-allocated: admission
        only spends ``Site.free()`` / ``pool_free`` chips."""
        if self.scheduler is None or len(self.queue) == 0:
            return
        ordered = self.queue.order(self._tenant_usage())
        free = {SITE: self.site.free()}
        if self.fleet_policy is not None:
            free[CLOUD] = self.pool_free
        expired = [
            e for e in ordered
            if self.queue.tenants[e.tenant].weight > 0
            and e.wait_s(self.now) > self.starve_patience_s
        ]
        if expired:
            # starvation guard: while any weighted tenant has waited
            # past patience, ONLY its entries may be admitted (greedy
            # first-fit over the expired set, fair-share order)
            placements = []
            for e in expired:
                # fixed site-then-cloud order, not free.items(): the
                # admission order must never depend on dict history
                for tgt in (SITE, CLOUD):
                    if tgt in free and free[tgt] >= e.chips:
                        placements.append((e, tgt))
                        free[tgt] -= e.chips
                        break
            if not placements and self.preemption:
                # last resort before blocking: checkpoint zero-weight
                # scavengers off the site to seat the expired head (§19)
                head = expired[0]
                if self._preempt_for(head):
                    placements.append((head, SITE))
                    free[SITE] = self.site.free() - head.chips
            if not placements:
                self._fleet_event("admission_blocked", {
                    "head": expired[0].name,
                    "waited_s": expired[0].wait_s(self.now),
                })
                return
        else:
            placements = self.scheduler.select(ordered, free)
        admitted = {e.name for e, _ in placements}
        ranks = {e.name: i for i, e in enumerate(ordered)}
        max_rank = max(
            (ranks[n] for n in admitted), default=-1
        )
        for e in ordered:
            if e.name not in admitted and ranks[e.name] < max_rank:
                e.skips += 1
        for entry, target in placements:
            self.queue.remove(entry.name)
            jrt = self._by_name(entry.name)
            assert target == SITE or self.fleet_policy is not None
            assert target != SITE or self.site.free() >= entry.chips, (
                "scheduler over-allocated the site"
            )
            self._place(jrt, target)
            jrt.events.append((self.now, "admit", {
                "placement": target, "chips": entry.chips,
                "wait_s": jrt.wait_s, "skips": entry.skips,
                "site_used_after": self.site.foreground(),
                "expired_present": bool(expired),
                "entry_expired": any(
                    x.name == entry.name for x in expired
                ),
            }))

    # ---- scavenger preemption (DESIGN.md §19) -----------------------------

    def _preempt_for(self, entry: QueueEntry) -> bool:
        """Checkpoint zero-weight scavengers off the site until the
        expired weighted ``entry`` fits.  Victims leave through the
        existing ckpt→restart path, re-queue at their current progress,
        and resume from the newest intact generation when capacity
        returns — the ROADMAP's preemption-through-checkpoint item."""
        victims = sorted(
            (
                j for j in self.jobs
                if j.arrived and not j.finished and j.rented_chips == 0
                and self.queue.tenants.get(
                    j.spec.tenant, Tenant(j.spec.tenant)
                ).weight == 0.0
            ),
            key=lambda j: (-j.spec.onprem_chips, j.spec.name),
        )
        for v in victims:
            if self.site.free() >= entry.chips:
                break
            self._preempt(v, entry.name)
        return self.site.free() >= entry.chips

    def _preempt(self, jrt: JobController, for_job: str) -> None:
        """Take one scavenger off the site: checkpoint at the current
        step, drop every cloud pod, release the home pod, re-queue."""
        self._save_ckpt(jrt, jrt.steps_done,
                        jrt.session.checkpoint(jrt.steps_done))
        jrt.preemptions += 1
        jrt.step_epoch += 1            # invalidate the in-flight step
        self._bill_cloud(jrt)
        before = jrt.cloud_chips
        if jrt.cloud_chips > 0:
            jrt.cloud_epoch += 1       # invalidate stale spot reclaims
            jrt.res = ElasticOrchestrator.apply_scale(
                jrt.res, ScaleAction("retire", reason="preempted")
            )
        self._release_elastic(jrt, before, 0, reclaimed=False)
        self._return_staged_pool(jrt)
        jrt.pending_action = None
        jrt.pending_target = 0
        self.site.release(jrt.spec.name)
        # bank the served site interval now: admit_s resets on resume,
        # so fairness accounting would otherwise lose this window
        served = jrt.spec.onprem_chips * max(self.now - jrt.admit_s, 0.0)
        jrt.site_banked_chip_s += served
        self._tenant_served[jrt.spec.tenant] = (
            self._tenant_served.get(jrt.spec.tenant, 0.0) + served
        )
        jrt.arrived = False
        jrt.queued = True
        steps_left = jrt.spec.steps_total - jrt.last_ckpt_step
        self.queue.push(QueueEntry(
            name=jrt.spec.name, tenant=jrt.spec.tenant,
            chips=jrt.spec.onprem_chips,
            work_chip_s=steps_left * jrt.spec.chip_seconds_per_step,
            enqueued_s=self.now, priority=jrt.spec.priority,
            preemptions=jrt.preemptions,
        ))
        jrt.events.append((self.now, "preempted", {
            "for": for_job, "ckpt_step": jrt.last_ckpt_step,
        }))
        self._fleet_event("preempt", {
            "victim": jrt.spec.name, "for": for_job,
            "chips": jrt.spec.onprem_chips,
        })
        self._record_timeline()

    # ---- billing ----------------------------------------------------------

    def _start_step(self, jrt: JobController,
                    extra_delay_s: float = 0.0) -> None:
        dt = jrt.session.run_step(jrt.steps_done)
        jrt.overhead_s += extra_delay_s
        self._push(self.now + extra_delay_s + dt, "step_done",
                   (jrt, jrt.step_epoch, dt))

    def _bill_cloud(self, jrt: JobController) -> None:
        chips = jrt.billable_chips
        if chips > 0:
            jrt.cloud_chip_s += chips * (self.now - jrt.cloud_since)
            jrt.cloud_since = self.now

    def _bill_pool(self) -> None:
        if self.pool_free > 0:
            self.pool_chip_s += self.pool_free * (self.now - self.pool_since)
        self.pool_since = self.now

    def _spent_usd(self) -> float:
        """Cloud $ committed so far, accrued to `now` — the number the
        global budget gate compares against (DESIGN.md §16)."""
        chip_s = self.pool_chip_s
        if self.pool_free > 0:
            chip_s += self.pool_free * (self.now - self.pool_since)
        for j in self.jobs:
            chip_s += j.cloud_chip_s
            if not j.finished and j.arrived and j.billable_chips > 0:
                chip_s += j.billable_chips * max(
                    self.now - j.cloud_since, 0.0
                )
        return self.cloud.cost(chip_s)

    def _fleet_committed(self) -> int:
        """Fleet-wide cloud footprint: chips held by or staged for ANY
        job, plus the pool (free + provisioning).  Staged pods count —
        otherwise the window between provision-complete and attach
        lets the fleet exceed its caps (DESIGN.md §16)."""
        held = sum(
            j.cloud_committed() for j in self.jobs
            if j.arrived and not j.finished
        )
        return held + self.pool_free + self.pool_pending

    def _record_timeline(self) -> None:
        total = sum(j.billable_chips for j in self.jobs if j.arrived
                    and not j.finished) + self.pool_free
        self.cloud_timeline.append((self.now, total))

    def _measured_tps(self, jrt: JobController) -> list[float]:
        """Per-pod throughput as the monitor would measure it *now*:
        nominal chips/K, derated by site contention for on-premise
        pods.  Feeds the orchestrator's γ rebalance."""
        c = self.site.contention(self.now)
        return [
            p.chips / p.slowdown
            / (c if p.name == self.site.name else 1.0)
            for p in jrt.res.pods
        ]

    # ---- checkpoint generations (DESIGN.md §19) ---------------------------

    def _save_ckpt(self, jrt: JobController, step: int, state) -> None:
        """Record one checkpoint generation.  With a fault plan active
        the write may be *silently* corrupt — nothing notices until a
        restore verifies integrity (DESIGN.md §19).  At most
        ``ckpt_keep`` generations are retained (never fewer than 2, so
        one bad write can never strand the job without a fallback)."""
        intact = True
        if jrt.faults is not None:
            intact = not jrt.faults.ckpt_corrupt()
            if not intact:
                jrt.events.append((self.now, "ckpt_corrupt", {
                    "step": step,
                }))
        jrt.ckpt_gens.append((step, state, intact))
        del jrt.ckpt_gens[:-self.ckpt_keep]
        jrt.last_ckpt = state
        jrt.last_ckpt_step = step

    def _restore_ckpt(self, jrt: JobController) -> tuple[int, object]:
        """Pick the checkpoint a rollback/resume restarts from.

        Hardened (``ckpt_integrity`` on): verify and fall back to the
        newest *intact* generation, paying the extra lost steps when
        the latest write was corrupt.  Unhardened: trust the newest
        blindly — a corrupt latest collapses the job to step 0, the
        failure mode the integrity layer exists to prevent (§19).
        """
        newest = jrt.ckpt_gens[-1]
        if self.ckpt_integrity:
            for step, state, intact in reversed(jrt.ckpt_gens):
                if intact:
                    if step != newest[0]:
                        jrt.events.append((self.now, "ckpt_fallback", {
                            "bad_step": newest[0], "resume_step": step,
                        }))
                    return step, state
            jrt.events.append((self.now, "ckpt_none_intact", {}))
            return 0, None
        step, state, intact = newest
        if not intact:
            jrt.events.append((self.now, "ckpt_restore_failed", {
                "step": step,
            }))
            return 0, None
        return step, state

    # ---- scale transitions ------------------------------------------------

    def _return_staged_pool(self, jrt: JobController) -> None:
        """Give back pool chips staged for a grow that will not attach
        (superseded or rolled back) — they must not leak."""
        if jrt.staged_from_pool > 0:
            self._bill_pool()
            self.pool_free += jrt.staged_from_pool
            self._fleet_event("pool_return", {
                "job": jrt.spec.name, "chips": jrt.staged_from_pool,
                "why": "staged grow cancelled",
            })
            jrt.staged_from_pool = 0

    def _release_elastic(self, jrt: JobController, before: int,
                         after: int, reclaimed: bool) -> None:
        """Elastic chips dropped by a shrink/retire go back to the pool
        when a fleet policy holds one (they are still paid for until it
        shrinks); chips a spot reclaim took are simply gone."""
        drop = before - after
        if drop <= 0 or reclaimed or self.fleet_policy is None:
            return
        self._bill_pool()
        self.pool_free += drop
        self._fleet_event("pool_return", {
            "job": jrt.spec.name, "chips": drop, "why": "scale down",
        })

    def _rescale(self, jrt: JobController, action: ScaleAction,
                 overhead_s: float) -> None:
        """Apply a ScaleAction at a step boundary: checkpoint, re-split
        γ, rebuild the session on the new Resources, pay the overhead.
        Shares always land on *measured* throughputs (the paper's γ from
        current conditions, not nominal chip counts)."""
        ckpt = jrt.session.checkpoint(jrt.steps_done)
        # the new session resumes from the in-memory state; corruption
        # (if drawn) poisons only the *written* generation (§19)
        self._save_ckpt(jrt, jrt.steps_done, ckpt)
        self._bill_cloud(jrt)
        before = jrt.cloud_chips
        if action.kind != "rebalance":
            jrt.res = ElasticOrchestrator.apply_scale(jrt.res, action)
        jrt.res = ElasticOrchestrator.rebalanced(
            jrt.res, self._measured_tps(jrt)
        )
        if action.kind == "grow":
            jrt.staged_from_pool = 0      # drawn chips are now attached
        self._release_elastic(jrt, before, jrt.cloud_chips,
                              reclaimed=False)
        if jrt.billable_chips > 0:
            jrt.cloud_since = self.now
        jrt.session = self._make_session(jrt, jrt.steps_done, ckpt)
        jrt.monitor.reset_window()
        jrt.events.append((self.now, "scale", {
            "kind": action.kind, "cloud_chips": jrt.cloud_chips,
            "overhead_s": overhead_s, "reason": action.reason,
        }))
        self._record_timeline()
        if action.kind == "grow" and self.cloud.spot:
            jrt.cloud_epoch += 1
            life = float(
                jrt.spot_rng.exponential(self.cloud.spot_mean_life_s)
            )
            self._push(self.now + life, "reclaim",
                       (jrt, jrt.cloud_epoch))
        self._start_step(jrt, extra_delay_s=overhead_s)

    def _rollback(self, jrt: JobController, kind: str,
                  drop_cloud: bool) -> None:
        """Fall back to the last checkpoint (spot reclaim / node
        failure): lost steps are re-run, restart overhead is paid."""
        jrt.rollbacks += 1
        jrt.step_epoch += 1
        self._bill_cloud(jrt)
        if drop_cloud:
            jrt.cloud_epoch += 1
            jrt.res = ElasticOrchestrator.apply_scale(
                jrt.res, ScaleAction("retire", reason=kind)
            )
        self._return_staged_pool(jrt)
        jrt.pending_action = None
        jrt.pending_target = 0
        resume_step, state = self._restore_ckpt(jrt)
        lost = jrt.steps_done - resume_step
        jrt.steps_done = resume_step
        jrt.session = self._make_session(jrt, resume_step, state)
        jrt.monitor.reset_window()
        restart = self.sc.overheads.restart_s
        jrt.events.append((self.now, kind, {
            "resume_step": jrt.steps_done, "cloud_chips": jrt.cloud_chips,
            "lost_steps": lost,
        }))
        self._record_timeline()
        self._start_step(jrt, extra_delay_s=restart)

    def _finish(self, jrt: JobController) -> None:
        jrt.finished = True
        jrt.finish_s = self.now
        self._bill_cloud(jrt)
        before = jrt.cloud_chips
        if jrt.cloud_chips > 0:
            jrt.res = ElasticOrchestrator.apply_scale(
                jrt.res, ScaleAction("retire", reason="job finished")
            )
        self._release_elastic(jrt, before, 0, reclaimed=False)
        self._return_staged_pool(jrt)
        if jrt.rented_chips > 0:
            # the home pod's pool chips come back for the next admit
            self._bill_pool()
            self.pool_free += jrt.rented_chips
            self._fleet_event("pool_return", {
                "job": jrt.spec.name, "chips": jrt.rented_chips,
                "why": "job finished",
            })
            jrt.rented_chips = 0
        self.site.release(jrt.spec.name)
        # bank the tenant's served time for the fair-share deficit
        self._tenant_served[jrt.spec.tenant] = (
            self._tenant_served.get(jrt.spec.tenant, 0.0)
            + jrt.spec.onprem_chips * max(self.now - jrt.admit_s, 0.0)
            + jrt.cloud_chip_s
        )
        jrt.events.append((self.now, "finish", {
            "elapsed_s": self.now - jrt.spec.arrival_s,
        }))
        self._record_timeline()
        if all(j.finished or j.rejected for j in self.jobs) \
                and self.pool_free > 0:
            self._bill_pool()
            self._fleet_event("pool_drain", {"chips": self.pool_free})
            self.pool_free = 0
            self._record_timeline()
        self._admit_pass()

    # ---- event handlers ---------------------------------------------------

    def _on_step_done(self, jrt: JobController, epoch: int,
                      dt: float) -> None:
        if jrt.finished or epoch != jrt.step_epoch:
            return
        jrt.monitor.observe(dt)
        jrt.steps_done += 1
        if jrt.steps_done % self.sc.ckpt_every == 0:
            self._save_ckpt(jrt, jrt.steps_done,
                            jrt.session.checkpoint(jrt.steps_done))
        if jrt.steps_done >= jrt.spec.steps_total:
            self._finish(jrt)
            return
        if jrt.pending_action is not None:
            action, jrt.pending_action = jrt.pending_action, None
            ov = self.sc.overheads
            # provisioning overlapped with execution; attach pays the
            # checkpoint + restart legs only (grow or shrink alike)
            self._rescale(jrt, action, ov.ckpt_s + ov.restart_s)
            return
        self._start_step(jrt)

    def _fleet_tick(self) -> None:
        """Fleet-level decision (DESIGN.md §16): size the shared pool
        toward the queue-driven policy's target footprint."""
        committed = self._fleet_committed()
        running = [
            j for j in self.jobs if j.arrived and not j.finished
        ]
        late = 0
        lateness = 0.0
        for j in running:
            est = j.predictor.estimate(
                j.monitor, j.steps_done, j.spec.steps_total,
                self.now - j.spec.arrival_s,
            )
            if est.predictable and est.slack_s < 0:
                late += 1
                lateness += -est.slack_s
        ctx = FleetContext(
            now=self.now, interval_s=self.sc.eval_interval_s,
            queue_depth=self.queue.depth,
            queued_chips=self.queue.queued_chips(),
            queued_work_chip_s=self.queue.queued_work_chip_s(),
            running=len(running), late_jobs=late, lateness_s=lateness,
            cloud_committed=committed, pool_free=self.pool_free,
            legal=list(self.cloud.legal_slices),
            site_free=self.site.free(),
            budget_left_usd=self.budget_usd - self._spent_usd(),
            price_per_chip_hour=self.cloud.price_per_chip_hour,
            cloud_slowdown=self.cloud.slowdown,
        )
        target = max(int(self.fleet_policy.target(ctx)), 0)
        if target > committed:
            grow = round_to_legal_slice(
                target - committed, self.cloud.legal_slices
            )
            grow = self._cap_grow(grow)
            if grow > 0:
                self.pool_pending += grow
                self._push(self.now + self.cloud.provision_delay_s,
                           "pool_online", (grow,))
                self._fleet_event("pool_provision_request", {
                    "chips": grow, "target": target,
                })
        elif target < committed and self.pool_free > 0:
            drop = min(self.pool_free, committed - target)
            self._bill_pool()
            self.pool_free -= drop
            self._fleet_event("pool_shrink", {"chips": drop})
            self._record_timeline()

    def _cap_grow(self, chips: int) -> int:
        """Clamp a requested provisioning increment to the global caps:
        the concurrent-chip cap (counting everything held + staged) and
        the $ budget gate (no NEW provisioning once spent)."""
        if chips <= 0:
            return 0
        if self.budget_usd != math.inf \
                and self._spent_usd() >= self.budget_usd:
            return 0
        if self.chip_cap is not None:
            headroom = self.chip_cap - self._fleet_committed()
            chips = min(chips, max(headroom, 0))
        return floor_to_legal_slice(chips, self.cloud.legal_slices)

    def _on_evaluate(self) -> None:
        if self.fleet_policy is not None:
            self._fleet_tick()
        wants: list[tuple[JobController, int, str]] = []
        for jrt in self.jobs:
            if not jrt.arrived or jrt.finished:
                continue
            elapsed = self.now - jrt.spec.arrival_s
            est = jrt.predictor.estimate(
                jrt.monitor, jrt.steps_done, jrt.spec.steps_total,
                elapsed,
            )
            ctx = ScaleContext(
                step=jrt.steps_done, steps_total=jrt.spec.steps_total,
                elapsed_s=elapsed, est=est, resources=jrt.res,
                cloud_chips=jrt.cloud_chips, planner=jrt.planner,
                monitor=jrt.monitor,
                legal=list(self.cloud.legal_slices),
                contention=self.site.contention(self.now),
                provision_failures=jrt.provision_failures,
                since_failure_s=self.now - jrt.last_failure_s,
            )
            action = jrt.policy.decide(ctx)
            wants_grow = False
            if action.kind == "grow":
                target = max(action.chips, 0)
                # chips already staged for the next step boundary count
                # as held — otherwise the window between
                # provision-complete and attach double-requests (and
                # double-pays) the same slice
                if target > max(jrt.cloud_chips, jrt.pending_target,
                                jrt.staged_grow()):
                    wants.append((jrt, target, action.reason))
                    wants_grow = True
            elif action.kind in ("shrink", "retire") \
                    and jrt.cloud_chips > 0:
                self._return_staged_pool(jrt)
                jrt.pending_action = action
                jrt.pending_target = 0
            if (
                jrt.pending_action is None
                and not wants_grow
                and len(jrt.res.pods) > 1
                and jrt.pending_target == 0
            ):
                # γ drift: conditions moved since the last split (e.g. a
                # spike cleared) — re-split on measured throughput, the
                # fleet analogue of the orchestrator's rebalance path
                want = proportional_shares(self._measured_tps(jrt))
                drift = max(
                    abs(a - b) for a, b in zip(want, jrt.res.shares)
                )
                if drift > 0.1:
                    jrt.pending_action = ScaleAction(
                        "rebalance",
                        reason=f"share drift {drift:.2f}",
                    )
        if wants:
            self._arbitrate_grows(wants)
        self._admit_pass()
        if self.scheduler is not None and len(self.queue) > 0:
            # fairness is judged where it is contested: while anyone
            # waits, sample the demand-bounded min weighted share
            self._fairness_sum += self._fairness_snapshot()
            self._fairness_n += 1
        if any(not (j.finished or j.rejected) for j in self.jobs):
            self._push(self.now + self.sc.eval_interval_s, "evaluate")

    def _arbitrate_grows(
        self, wants: list[tuple[JobController, int, str]]
    ) -> None:
        """Level-2 arbitration of this tick's per-job grow requests
        (DESIGN.md §16).  Pool chips first — a draw attaches at the
        next step boundary with NO provisioning delay, the entire point
        of pre-provisioning on queue pressure.  What the pool cannot
        cover competes for the remaining cap headroom, split max-min
        fair by tenant weight and floored to legal slices, so one
        tenant's burst cannot crowd out another's under a tight cap."""
        provisioning: list[tuple[JobController, int, str]] = []
        for jrt, target, reason in wants:
            inc = target - jrt.cloud_chips
            if (self.fleet_policy is not None and inc > 0
                    and self.pool_free >= inc):
                self._bill_pool()
                self.pool_free -= inc
                self._return_staged_pool(jrt)
                k = self.cloud.slowdown
                if jrt.faults is not None:
                    k = jrt.faults.straggler_k(k)
                    if k > self.cloud.slowdown:
                        jrt.events.append((self.now, "straggler_pod", {
                            "chips": target, "slowdown": k,
                        }))
                jrt.pending_action = ScaleAction(
                    "grow", chips=target, slowdown=k,
                    reason=f"{reason} [pool]",
                )
                jrt.staged_from_pool = inc
                jrt.pending_target = 0
                jrt.events.append((self.now, "pool_draw", {
                    "chips": inc, "target": target,
                }))
                self._fleet_event("pool_draw", {
                    "job": jrt.spec.name, "chips": inc,
                })
            else:
                provisioning.append((jrt, target, reason))
        if not provisioning:
            return
        if self.budget_usd != math.inf \
                and self._spent_usd() >= self.budget_usd:
            for jrt, target, _ in provisioning:
                jrt.events.append((self.now, "cloud_denied", {
                    "wanted": target, "why": "budget exhausted",
                }))
            return
        if self.chip_cap is None:
            granted = [t for _, t, _ in provisioning]
        else:
            headroom = max(self.chip_cap - self._fleet_committed(), 0)
            demands = [
                float(t - j.cloud_committed() + j.rented_chips)
                for j, t, _ in provisioning
            ]
            weights = [
                self.queue.tenants.get(
                    j.spec.tenant, Tenant(j.spec.tenant)
                ).weight
                for j, _, _ in provisioning
            ]
            alloc = max_min_fair_allocation(headroom, demands, weights)
            granted = []
            for (jrt, target, _), inc in zip(provisioning, alloc):
                base = jrt.cloud_committed() - jrt.rented_chips
                granted.append(
                    floor_to_legal_slice(
                        base + inc, self.cloud.legal_slices
                    )
                )
        for (jrt, target, reason), grant in zip(provisioning, granted):
            if grant > max(jrt.cloud_chips, jrt.pending_target,
                           jrt.staged_grow()):
                jrt.pending_target = grant
                self._request_provision(jrt, grant, reason)
                jrt.events.append((self.now, "provision_request", {
                    "chips": grant, "reason": reason,
                }))
            else:
                jrt.events.append((self.now, "cloud_denied", {
                    "wanted": target, "granted": grant,
                    "why": "cap headroom",
                }))

    def _request_provision(self, jrt: JobController, target: int,
                           reason: str, attempt: int = 1) -> None:
        """Issue one provisioning attempt.  The fault draw happens at
        request time (DESIGN.md §19): a denial is only *discovered*
        when the provider answers after the provisioning delay, and a
        "timeout" stretches that delay by ``provision_timeout_x``."""
        denied, delay_x = (False, 1.0)
        if jrt.faults is not None:
            denied, delay_x = jrt.faults.provision_outcome()
            if delay_x > 1.0:
                jrt.events.append((self.now, "provision_timeout", {
                    "chips": target, "attempt": attempt,
                    "delay_x": delay_x,
                }))
        self._push(
            self.now + self.cloud.provision_delay_s * delay_x,
            "provision", (jrt, target, reason, attempt, denied),
        )

    def _on_provision(self, jrt: JobController, target: int,
                      reason: str, attempt: int = 1,
                      denied: bool = False) -> None:
        if jrt.finished or jrt.pending_target != target:
            return                     # superseded or moot
        if denied:
            jrt.retries += 1
            jrt.provision_failures += 1
            jrt.last_failure_s = self.now
            jrt.events.append((self.now, "provision_denied", {
                "chips": target, "attempt": attempt,
            }))
            if (self.retry is not None
                    and attempt <= self.retry.max_retries):
                # capped exponential backoff, jitter from the job's own
                # fault stream — bit-deterministic per seed (§19)
                backoff = self.retry.backoff_s(attempt, jrt.faults.rng)
                jrt.events.append((self.now, "provision_retry", {
                    "attempt": attempt + 1, "backoff_s": backoff,
                }))
                self._push(self.now + backoff, "provision_retry",
                           (jrt, target, reason, attempt + 1))
            else:
                jrt.gave_up = True
                jrt.pending_target = 0
                jrt.events.append((self.now, "provision_gave_up", {
                    "chips": target, "attempts": attempt,
                }))
            return
        jrt.pending_target = 0
        jrt.provision_failures = 0
        self._return_staged_pool(jrt)
        # the pod's *true* K is the provider's, whatever the policy
        # believed when sizing — the sim-vs-real boundary (DESIGN.md §10)
        # ... unless the straggler draw hits and it lands degraded (§19)
        k = self.cloud.slowdown
        if jrt.faults is not None:
            k = jrt.faults.straggler_k(k)
            if k > self.cloud.slowdown:
                jrt.events.append((self.now, "straggler_pod", {
                    "chips": target, "slowdown": k,
                }))
        jrt.pending_action = ScaleAction(
            "grow", chips=target, slowdown=k, reason=reason,
        )

    def _on_pool_online(self, chips: int) -> None:
        self._bill_pool()
        self.pool_pending -= chips
        self.pool_free += chips
        self._fleet_event("pool_online", {"chips": chips})
        self._record_timeline()
        self._admit_pass()

    def _on_storm(self, p: float) -> None:
        """Correlated reclaim storm (DESIGN.md §19): at one instant the
        provider reclaims elastic capacity market-wide — every job
        holding elastic chips is hit independently with probability
        ``p`` (from its own fault stream), and the idle pool is
        reclaimed with the same probability from the fleet stream."""
        self._fleet_event("reclaim_storm", {"p": p})
        if self.pool_free > 0 \
                and float(self._storm_rng.uniform()) < p:
            self._bill_pool()
            self._fleet_event("pool_reclaimed", {
                "chips": self.pool_free,
            })
            self.pool_free = 0
            self._record_timeline()
        for jrt in self.jobs:
            if (jrt.arrived and not jrt.finished
                    and jrt.cloud_chips > 0
                    and jrt.faults.storm_hit(p)):
                self._rollback(jrt, "spot_reclaim", drop_cloud=True)

    # ---- run --------------------------------------------------------------

    def run(self, until_s: float | None = None) -> FleetRecord:
        """Run the event loop to completion, or — with ``until_s`` —
        stop the clock there and return a mid-run snapshot (billing
        accrued up to ``until_s`` on every held pod, DESIGN.md §16)."""
        for jrt in self.jobs:
            self._push(jrt.spec.arrival_s, "arrival", (jrt,))
        for t, name, new_deadline in self.sc.deadline_changes:
            self._push(t, "deadline", (name, new_deadline))
        for t, name in self.sc.failures:
            self._push(t, "fail", (name,))
        if self.faults is not None:
            for t, p in self.faults.reclaim_storms:
                self._push(t, "storm", (p,))
        first = min(
            (j.spec.arrival_s for j in self.jobs), default=0.0
        )
        self._push(first + self.sc.eval_interval_s, "evaluate")

        n_events = 0
        while self._heap:
            if until_s is not None and self._heap[0][0] > until_s:
                self.now = until_s
                break
            n_events += 1
            if n_events > _MAX_EVENTS:
                raise RuntimeError("fleet sim event budget exceeded")
            t, _, kind, payload = heapq.heappop(self._heap)
            self.now = t
            if kind == "arrival":
                self._arrive(payload[0])
            elif kind == "step_done":
                self._on_step_done(*payload)
            elif kind == "evaluate":
                self._on_evaluate()
            elif kind == "provision":
                self._on_provision(*payload)
            elif kind == "provision_retry":
                jrt, target, reason, attempt = payload
                if not jrt.finished and jrt.pending_target == target:
                    self._request_provision(jrt, target, reason, attempt)
            elif kind == "pool_online":
                self._on_pool_online(*payload)
            elif kind == "storm":
                self._on_storm(*payload)
            elif kind == "reclaim":
                jrt, epoch = payload
                if (not jrt.finished and epoch == jrt.cloud_epoch
                        and jrt.cloud_chips > 0):
                    self._rollback(jrt, "spot_reclaim", drop_cloud=True)
            elif kind == "fail":
                jrt = self._by_name(payload[0])
                if jrt is not None and jrt.arrived and not jrt.finished:
                    self._rollback(jrt, "node_failure", drop_cloud=False)
            elif kind == "deadline":
                jrt = self._by_name(payload[0])
                if jrt is not None and not jrt.finished \
                        and not jrt.rejected:
                    jrt.predictor.set_deadline(payload[1], at_s=self.now)
                    jrt.events.append((self.now, "deadline_change", {
                        "new_deadline_s": payload[1],
                    }))
        return self._record()

    def _by_name(self, name: str) -> JobController | None:
        for j in self.jobs:
            if j.spec.name == name:
                return j
        return None

    def _record(self) -> FleetRecord:
        jobs = []
        useful = 0.0
        consumed = 0.0
        for jrt in self.jobs:
            # unfinished jobs report elapsed-so-far (now − arrival), not
            # a garbage negative interval from an unset finish_s
            end = jrt.finish_s if jrt.finished else self.now
            elapsed = (
                max(end - jrt.spec.arrival_s, 0.0)
                if (jrt.arrived or jrt.queued) else 0.0
            )
            # judge against the deadline in force when the job finished
            # (deadline_changes applied later must not retro-tighten)
            deadline = jrt.predictor.deadline_at(end)
            met = jrt.finished and elapsed <= deadline
            # a mid-run snapshot must include the chip-seconds accrued
            # on EVERY currently-held pod (elastic and rented alike)
            # that _bill_cloud has not yet flushed (it only runs at
            # scale/finish/rollback events)
            cloud_s = jrt.cloud_chip_s
            if not jrt.finished and jrt.arrived \
                    and jrt.billable_chips > 0:
                cloud_s += jrt.billable_chips * max(
                    self.now - jrt.cloud_since, 0.0
                )
            cost = self.cloud.cost(cloud_s)
            wait = jrt.wait_s if jrt.arrived else (
                max(self.now - jrt.spec.arrival_s, 0.0)
                if jrt.queued else 0.0
            )
            jobs.append(JobRecord(
                name=jrt.spec.name, finished=jrt.finished,
                finish_s=jrt.finish_s, elapsed_s=elapsed,
                deadline_s=deadline, met_deadline=met,
                steps_total=jrt.spec.steps_total,
                cloud_chip_s=cloud_s, cloud_cost=cost,
                overhead_s=jrt.overhead_s, rollbacks=jrt.rollbacks,
                events=jrt.events, tenant=jrt.spec.tenant,
                state=jrt.state, wait_s=wait,
                retries=jrt.retries, gave_up=jrt.gave_up,
                preemptions=jrt.preemptions,
                renegotiated=jrt.renegotiated,
            ))
            # useful chip·s per step at the on-premise operating point
            # of the job's rate law (== chip_seconds_per_step at α = 1)
            useful += jrt.steps_done * (
                jrt.spec.chip_seconds_per_step
                / jrt.spec.onprem_chips ** (jrt.spec.scaling_alpha - 1.0)
            )
            if jrt.arrived:
                run_end = jrt.finish_s if jrt.finished else self.now
                consumed += jrt.spec.onprem_chips * max(
                    run_end - jrt.admit_s, 0.0
                ) + cloud_s
            elif jrt.preemptions > 0:
                # preempted and still queued: its cloud time was real
                consumed += cloud_s
            consumed += jrt.site_banked_chip_s
        # rejected jobs never ran: the admission control *said no*, so
        # they are excluded from the hit-rate denominator (§19)
        done = [j for j in jobs if j.state != "rejected"]
        pool_s = self.pool_chip_s
        if self.pool_free > 0:
            pool_s += self.pool_free * (self.now - self.pool_since)
        pool_cost = self.cloud.cost(pool_s)
        consumed += pool_s
        # fairness is the mean demand-bounded min weighted share over
        # the contended window (queue non-empty); with no contention
        # ever, the final snapshot (trivially 1.0 when all demand met)
        fairness = (
            self._fairness_sum / self._fairness_n
            if self._fairness_n else self._fairness_snapshot()
        )
        waits = [j.wait_s for j in jobs if j.state != "pending"]
        return FleetRecord(
            scenario=self.sc.name,
            policy=self.jobs[0].policy.name if self.jobs else "?",
            jobs=jobs,
            hit_rate=(
                sum(j.met_deadline for j in done) / len(done)
                if done else 0.0
            ),
            cloud_cost=sum(j.cloud_cost for j in jobs) + pool_cost,
            useful_frac=(
                min(useful / consumed, 1.0) if consumed > 0 else 0.0
            ),
            cloud_timeline=self.cloud_timeline,
            makespan_s=max(
                (j.finish_s for j in jobs if j.finished), default=0.0
            ),
            scheduler=(
                self.scheduler.name if self.scheduler else "immediate"
            ),
            fleet_policy=(
                self.fleet_policy.name if self.fleet_policy else "none"
            ),
            fairness=fairness,
            mean_wait_s=(sum(waits) / len(waits)) if waits else 0.0,
            max_wait_s=max(waits, default=0.0),
            queued_at_end=sum(j.state == "queued" for j in jobs),
            pool_cost=pool_cost,
            fleet_events=self.fleet_events,
        )


class FleetSim(FleetController):
    """PR-2 name for the fleet event loop, kept for every existing
    caller: ``FleetSim(scenario, policy_factory, seed=...)`` behaves
    exactly as before for scenarios that keep the default
    ``scheduler="immediate"`` (no queue, no pool, no caps)."""
