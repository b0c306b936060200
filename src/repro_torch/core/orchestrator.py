"""Elastic orchestrator — paper Fig. 1, steps 2-8 as a state machine.

    MONITOR -> DECIDE -> CHECKPOINT -> REMESH -> RESHARD -> RESUME

The orchestrator owns the loop; the workload is behind a small Session
protocol so the same machinery drives (a) the simulated hybrid cluster
used by the paper-reproduction benchmarks and (b) the real JAX training
session in launch/train.py (where REMESH = jax.make_mesh over the grown
device set and RESHARD = checkpoint restore under the new shardings).

Fault tolerance beyond the paper: periodic checkpoints, failure events
trigger a shrink-and-restart from the last checkpoint, sustained
straggling triggers a γ rebalance using freshly measured throughputs.

Beyond the paper's one-shot burst (its §4 names "scaling down" as future
work), the loop can be driven by an external *autoscaler policy* that is
consulted on a fixed check interval and answers with a ScaleAction —
GROW the elastic pod to a target slice, SHRINK it to a smaller one,
RETIRE it entirely, or HOLD.  Every transition goes through the
identical CHECKPOINT → REMESH → RESHARD → RESUME path as the paper's
burst, so growing and shrinking are symmetric and checkpoint/restore
invariants hold across both (DESIGN.md §8, §11).

Real-session elastic loop (DESIGN.md §14): the policy-driven mode is the
same machinery the fleet simulator evaluates, pointed at a *real*
Session (FWISession) —

  * ``eval_interval_s`` evaluates the policy on the session's clock
    (the elapsed time the monitor integrates) instead of a step count,
    matching the fleet's fixed-interval evaluation semantics;
  * ``deadline_changes`` applies mid-run deadline tightenings /
    relaxations first-class (paper §2: the deadline "could also change
    dynamically"), recorded into the predictor's history;
  * ``cloud_slowdown`` is the provider's *true* K stamped onto grown
    pods regardless of what the policy believed when sizing — the same
    sim-vs-real boundary the fleet's provision handler enforces;
  * elastic chip-seconds actually held are metered (``cloud_chip_s``)
    and priced through the planner's ``price_per_chip_hour``, so a real
    run reports the same hit-rate/cost/overhead axes as a FleetSim run.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Protocol, Sequence

import numpy as np

from repro_torch.core.allocator import (
    HeterogeneousPlan,
    heterogeneous_split,
    proportional_shares,
)
from repro_torch.core.deadline import DeadlineEstimate, DeadlinePredictor
from repro_torch.core.monitor import StepTimeMonitor
from repro_torch.core.planner import BurstDecision, BurstPlanner

#: pod-name prefixes that mark a pod as elastic (cloud-side, scalable);
#: everything else is the fixed on-premise allocation.
ELASTIC_PREFIXES = ("cloud", "burst")


@dataclasses.dataclass
class PodSpec:
    chips: int
    slowdown: float = 1.0            # paper's K for this environment
    name: str = "pod"


@dataclasses.dataclass
class Resources:
    pods: list[PodSpec]
    shares: list[float]              # work share per pod (sums to 1)

    @property
    def total_chips(self) -> int:
        return sum(p.chips for p in self.pods)


def elastic_chips(res: "Resources") -> int:
    """Chips currently held in elastic (cloud-side) pods."""
    return sum(
        p.chips for p in res.pods if p.name.startswith(ELASTIC_PREFIXES)
    )


@dataclasses.dataclass(frozen=True)
class ScaleAction:
    """One autoscaler verdict for the elastic pod.

    kind: "hold" | "grow" | "shrink" | "retire".  ``chips`` is the
    *target* elastic-pod size for grow/shrink (already legal-slice
    rounded by the policy); ``slowdown`` is the paper's K for chips
    provisioned by a grow.
    """

    kind: str
    chips: int = 0
    slowdown: float = 1.0
    reason: str = ""


HOLD = ScaleAction("hold")


@dataclasses.dataclass
class ScaleContext:
    """Everything a policy may look at when deciding (paper Fig. 1 inputs
    plus the fleet-level signals the paper's operator would eyeball)."""

    step: int
    steps_total: int
    elapsed_s: float
    est: DeadlineEstimate
    resources: "Resources"
    cloud_chips: int
    planner: BurstPlanner
    monitor: StepTimeMonitor
    legal: list[int]
    contention: float = 1.0          # site demand / capacity (>= 1)
    # ---- provider-health telemetry (DESIGN.md §19): lets a policy
    # hold off re-requesting from a provider that keeps denying it
    provision_failures: int = 0      # consecutive denials, 0 on success
    since_failure_s: float = math.inf  # time since the last denial


class AutoscalerPolicy(Protocol):
    """Interval-evaluated scaling policy (implementations: repro.sim)."""

    name: str

    def decide(self, ctx: ScaleContext) -> ScaleAction: ...


class Session(Protocol):
    def run_step(self, step: int) -> float: ...
    def checkpoint(self, step: int) -> Any: ...


class PodFailure(RuntimeError):
    def __init__(self, pod: int, step: int):
        super().__init__(f"pod {pod} failed at step {step}")
        self.pod = pod
        self.step = step


@dataclasses.dataclass
class OrchestratorEvent:
    step: int
    kind: str                        # burst | failure | rebalance | ckpt
    detail: dict


@dataclasses.dataclass
class RunRecord:
    completed: bool
    steps: int
    elapsed_s: float
    deadline_s: float
    met_deadline: bool
    events: list[OrchestratorEvent]
    step_times: list[float]
    final_resources: Resources | None = None
    cloud_chip_s: float = 0.0            # elastic chip-seconds held
    cloud_cost_usd: float = 0.0          # priced via planner ($/chip-h)
    retries: int = 0                     # provisioning denials (§19)
    gave_up: bool = False                # a grow was abandoned (§19)


SessionFactory = Callable[[Resources, int, Any], Session]


class ElasticOrchestrator:
    def __init__(
        self,
        *,
        planner: BurstPlanner,
        predictor: DeadlinePredictor,
        monitor: StepTimeMonitor | None = None,
        check_every: int = 8,
        ckpt_every: int = 50,
        max_bursts: int = 2,
        rebalance_straggler_rate: float = 0.2,
        eval_interval_s: float | None = None,
        cloud_slowdown: float | None = None,
        degraded_factor: float | None = None,
    ):
        self.planner = planner
        self.predictor = predictor
        self.monitor = monitor or StepTimeMonitor()
        self.check_every = check_every
        self.ckpt_every = ckpt_every
        self.max_bursts = max_bursts
        self.rebalance_straggler_rate = rebalance_straggler_rate
        #: evaluate decisions on the session clock every this many
        #: seconds instead of every ``check_every`` steps (fleet-style
        #: fixed-interval evaluation for real sessions, DESIGN.md §14)
        if eval_interval_s is not None and eval_interval_s <= 0:
            raise ValueError(
                f"eval_interval_s must be positive, got {eval_interval_s}"
            )
        self.eval_interval_s = eval_interval_s
        #: the provider's true K for grown pods — overrides whatever the
        #: policy believed when sizing (the sim-vs-real boundary the
        #: fleet's provision handler enforces, DESIGN.md §10)
        self.cloud_slowdown = cloud_slowdown
        #: degraded-pod detector (DESIGN.md §19): while elastic chips
        #: are held, a measured step time exceeding ``degraded_factor``
        #: × the planner's modeled step time forces a RETIRE so the
        #: loop re-stripes around the sick pod.  None disables it.
        self.degraded_factor = degraded_factor

    # ---- the γ-split applied to resources --------------------------------

    @staticmethod
    def apply_burst(res: Resources, decision: BurstDecision) -> Resources:
        pods = list(res.pods) + [
            PodSpec(
                chips=decision.chips_burst,
                slowdown=max(decision.correction_K, 1e-6),
                name=f"burst{len(res.pods)}",
            )
        ]
        shares = proportional_shares([p.chips / p.slowdown for p in pods])
        return Resources(pods=pods, shares=shares)

    @staticmethod
    def apply_scale(res: Resources, action: ScaleAction) -> Resources:
        """Resize the elastic pod to the action's target (γ re-split).

        grow/shrink converge on the same code path: set the single
        elastic pod to ``action.chips`` (creating it on first grow,
        keeping its measured K on resize) and recompute shares ∝
        chips/K.  retire (or a target of 0) drops every elastic pod and
        returns all work to the on-premise allocation.
        """
        if action.kind not in ("grow", "shrink", "retire"):
            return res
        fixed = [
            p for p in res.pods if not p.name.startswith(ELASTIC_PREFIXES)
        ]
        elastic = [
            p for p in res.pods if p.name.startswith(ELASTIC_PREFIXES)
        ]
        target = 0 if action.kind == "retire" else max(int(action.chips), 0)
        pods = list(fixed)
        if target > 0:
            slowdown = (
                elastic[0].slowdown if elastic
                else max(action.slowdown, 1e-6)
            )
            pods.append(PodSpec(chips=target, slowdown=slowdown,
                                name="cloud"))
        shares = proportional_shares([p.chips / p.slowdown for p in pods])
        return Resources(pods=pods, shares=shares)

    @staticmethod
    def rebalanced(res: Resources, measured_tps: list[float]) -> Resources:
        if sum(measured_tps) <= 0:
            return res
        return Resources(
            pods=list(res.pods), shares=proportional_shares(measured_tps)
        )

    def split_plan(self, res: Resources, global_batch: int,
                   microbatch: int, seq_len: int) -> HeterogeneousPlan:
        return heterogeneous_split(
            global_batch=global_batch,
            microbatch=microbatch,
            seq_len=seq_len,
            throughputs=[p.chips / p.slowdown for p in res.pods],
        )

    # ---- main loop --------------------------------------------------------

    def run(
        self,
        *,
        session_factory: SessionFactory,
        initial: Resources,
        steps_total: int,
        overhead_s_fn: Callable[[BurstDecision], float] | None = None,
        autoscaler: AutoscalerPolicy | None = None,
        deadline_changes: Sequence[tuple[float, float]] = (),
        fault_hook: Callable[[str, dict], bool] | None = None,
        retry_policy=None,
        rng: np.random.Generator | None = None,
    ) -> RunRecord:
        """Drive the session to ``steps_total`` (see class docstring).

        Failure hardening (DESIGN.md §19): ``fault_hook(kind, detail)``
        is consulted before each provisioning attempt — returning True
        denies it (the injection point for tests and chaos drills).
        Denials retry under ``retry_policy`` (any object with
        ``max_retries`` and ``backoff_s(attempt, rng)``, e.g.
        repro.sim.faults.RetryPolicy) with the backoff drawn from the
        seeded ``rng``; exhaustion surfaces as ``gave_up`` on the
        record and the loop carries on without the grow.
        """
        res = initial
        session = session_factory(res, 0, None)
        elapsed = 0.0
        cloud_chip_s = 0.0
        events: list[OrchestratorEvent] = []
        step_times: list[float] = []
        bursts_done = 0
        retries = 0
        gave_up = False
        provision_failures = 0
        last_failure_elapsed = -math.inf
        if rng is None:
            rng = np.random.default_rng(0)
        last_ckpt: Any = None
        last_ckpt_step = -1
        step = 0
        dl_sched = sorted(deadline_changes)
        dl_idx = 0
        next_eval = self.eval_interval_s or 0.0
        while step < steps_total:
            try:
                dt = session.run_step(step)
            except PodFailure as f:
                # fault tolerance: drop the failed pod, restart from the
                # last checkpoint (re-running the lost steps)
                events.append(OrchestratorEvent(
                    step, "failure", {"pod": f.pod}
                ))
                pods = [p for i, p in enumerate(res.pods) if i != f.pod]
                res = Resources(
                    pods=pods,
                    shares=proportional_shares(
                        [p.chips / p.slowdown for p in pods]
                    ),
                )
                restart = max(last_ckpt_step + 1, 0)
                elapsed += self.planner.overheads.restart_s
                cloud_chip_s += (
                    elastic_chips(res) * self.planner.overheads.restart_s
                )
                session = session_factory(res, restart, last_ckpt)
                self.monitor.reset_window()
                step = restart
                continue
            self.monitor.observe(dt)
            elapsed += dt
            cloud_chip_s += elastic_chips(res) * dt
            step_times.append(dt)
            step += 1

            # first-class dynamic deadlines (paper §2), recorded into
            # the predictor history at the session-clock time they land
            while dl_idx < len(dl_sched) and elapsed >= dl_sched[dl_idx][0]:
                self.predictor.set_deadline(
                    dl_sched[dl_idx][1], at_s=elapsed
                )
                events.append(OrchestratorEvent(
                    step, "deadline",
                    {"deadline_s": dl_sched[dl_idx][1],
                     "at_elapsed_s": elapsed},
                ))
                dl_idx += 1

            if step % self.ckpt_every == 0:
                last_ckpt = session.checkpoint(step)
                last_ckpt_step = step
                events.append(OrchestratorEvent(step, "ckpt", {}))

            if self.eval_interval_s is not None:
                # wall-clock-driven evaluation on the session's clock
                if elapsed < next_eval or step >= steps_total:
                    continue
                while next_eval <= elapsed:
                    next_eval += self.eval_interval_s
            elif step % self.check_every or step >= steps_total:
                continue

            est = self.predictor.estimate(
                self.monitor, step, steps_total, elapsed
            )
            eff_chips = sum(p.chips / p.slowdown for p in res.pods)
            if autoscaler is not None:
                # policy-driven mode: the interval-evaluated autoscaler
                # replaces the built-in burst-once decision, and every
                # resize rides the same ckpt -> remesh -> reshard path
                forced: ScaleAction | None = None
                if (
                    self.degraded_factor is not None
                    and elastic_chips(res) > 0
                ):
                    # degraded-pod detector (DESIGN.md §19): the cluster
                    # model says what this allocation *should* deliver;
                    # measuring far above it means a pod is sick —
                    # retire the elastic pod and re-stripe around it
                    t_meas = self.monitor.step_time()
                    t_model = (
                        self.planner.cluster_model.predict_time(eff_chips)
                        + self.planner.overheads.seam_s_per_step()
                    )
                    if t_model > 0 \
                            and t_meas > self.degraded_factor * t_model:
                        forced = ScaleAction(
                            "retire",
                            reason=(
                                f"degraded pod: measured {t_meas:.3f}s "
                                f"vs modeled {t_model:.3f}s"
                            ),
                        )
                        events.append(OrchestratorEvent(
                            step, "degraded",
                            {"measured_s": t_meas, "modeled_s": t_model},
                        ))
                if forced is not None:
                    action = forced
                else:
                    action = autoscaler.decide(ScaleContext(
                        step=step, steps_total=steps_total,
                        elapsed_s=elapsed,
                        est=est, resources=res,
                        cloud_chips=elastic_chips(res),
                        planner=self.planner, monitor=self.monitor,
                        legal=list(self.planner.legal),
                        provision_failures=provision_failures,
                        since_failure_s=elapsed - last_failure_elapsed,
                    ))
                if (
                    action.kind == "grow"
                    and self.cloud_slowdown is not None
                ):
                    # the pod's *true* K is the provider's, whatever the
                    # policy believed when sizing (DESIGN.md §10)
                    action = dataclasses.replace(
                        action, slowdown=self.cloud_slowdown
                    )
                if action.kind == "grow" and fault_hook is not None:
                    attempt = 1
                    while fault_hook("provision", {
                        "chips": action.chips, "attempt": attempt,
                        "step": step,
                    }):
                        retries += 1
                        provision_failures += 1
                        last_failure_elapsed = elapsed
                        events.append(OrchestratorEvent(
                            step, "provision_denied",
                            {"chips": action.chips, "attempt": attempt},
                        ))
                        if (retry_policy is None
                                or attempt > retry_policy.max_retries):
                            gave_up = True
                            events.append(OrchestratorEvent(
                                step, "provision_gave_up",
                                {"chips": action.chips,
                                 "attempts": attempt},
                            ))
                            action = HOLD
                            break
                        backoff = retry_policy.backoff_s(attempt, rng)
                        elapsed += backoff
                        events.append(OrchestratorEvent(
                            step, "provision_retry",
                            {"attempt": attempt + 1,
                             "backoff_s": backoff},
                        ))
                        attempt += 1
                    else:
                        provision_failures = 0
                new_res = self.apply_scale(res, action)
                if action.kind != "hold" and new_res.pods != res.pods:
                    last_ckpt = session.checkpoint(step)
                    last_ckpt_step = step
                    ov = self.planner.overheads
                    overhead = (
                        ov.total() if action.kind == "grow"
                        else ov.ckpt_s + ov.restart_s
                    )
                    elapsed += overhead
                    res = new_res
                    # provisioning is not billed (the provider's clock
                    # starts at attach, as in the fleet); the ckpt +
                    # restart legs hold the new allocation
                    cloud_chip_s += elastic_chips(res) * max(
                        overhead
                        - (ov.provision_s if action.kind == "grow"
                           else 0.0),
                        0.0,
                    )
                    session = session_factory(res, step, last_ckpt)
                    self.monitor.reset_window()
                    events.append(OrchestratorEvent(
                        step, "scale",
                        {
                            "kind": action.kind,
                            "cloud_chips": elastic_chips(res),
                            "overhead_s": overhead,
                            "reason": action.reason,
                            "shares": list(res.shares),
                        },
                    ))
                continue
            decision = self.planner.plan(
                est, step, steps_total,
                observed_step_s=self.monitor.step_time(),
                effective_chips=eff_chips,
            )
            if decision.burst and bursts_done < self.max_bursts:
                # Fig.1 steps 2,5: save state, move it to the new nodes
                last_ckpt = session.checkpoint(step)
                last_ckpt_step = step
                overhead = (
                    overhead_s_fn(decision) if overhead_s_fn
                    else decision.overhead_s
                )
                elapsed += overhead
                # steps 3,4: expand resources with the γ split
                res = self.apply_burst(res, decision)
                cloud_chip_s += elastic_chips(res) * max(
                    overhead - self.planner.overheads.provision_s, 0.0
                )
                # steps 6,7: assimilate state, restart at the stopped step
                session = session_factory(res, step, last_ckpt)
                self.monitor.reset_window()
                bursts_done += 1
                events.append(OrchestratorEvent(
                    step, "burst",
                    {
                        "chips": decision.chips_burst,
                        "K": decision.correction_K,
                        "overhead_s": overhead,
                        "est_stay": decision.est_time_stay_s,
                        "est_burst": decision.est_time_burst_s,
                        "shares": list(res.shares),
                    },
                ))
            elif (
                self.monitor.straggler_rate() > self.rebalance_straggler_rate
                and len(res.pods) > 1
            ):
                # straggler mitigation: shift γ toward healthy pods using
                # measured (not nominal) throughput
                tps = [p.chips / p.slowdown for p in res.pods]
                res = self.rebalanced(res, tps)
                session = session_factory(res, step, session.checkpoint(step))
                events.append(OrchestratorEvent(
                    step, "rebalance", {"shares": list(res.shares)}
                ))

        return RunRecord(
            completed=True,
            steps=steps_total,
            elapsed_s=elapsed,
            deadline_s=self.predictor.deadline_s,
            met_deadline=elapsed <= self.predictor.deadline_s,
            events=events,
            step_times=step_times,
            final_resources=res,
            cloud_chip_s=cloud_chip_s,
            cloud_cost_usd=self.planner.cost_usd(cloud_chip_s),
            retries=retries,
            gave_up=gave_up,
        )
