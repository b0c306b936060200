"""Auto-scaler policy suite — the paper's Fig. 1 decision loop as one
policy among several, evaluated on a fixed interval (DESIGN.md §11).

The paper's contribution is a *deadline-aware, model-driven* scaler
(capacity models eqs. 1-3 + γ split).  To show what that buys, the fleet
simulator runs it against the classic policy families the auto-scaling
literature benchmarks (React/Hist in the style of the OpenDC prototype
suite) and two brackets:

  no-burst      lower bracket: the static on-premise allocation
  always-burst  upper bracket: provision the maximum slice on arrival
  react         reactive: one legal slice up on a predicted miss, one
                down when slack is comfortable (no model, no sizing)
  hist          predictive: percentile-of-history step time projects
                completion; grows/retires on the projection
  plan          deadline-aware: BurstPlanner sizes the slice via the
                capacity models and K; retires as soon as the on-premise
                side alone meets the deadline

Every policy answers with a ScaleAction; the orchestrator/fleet applies
it through the identical CHECKPOINT → REMESH → RESHARD → RESUME path, so
policies differ only in *when* and *how much* — never in mechanism.

Fleet-level policies (DESIGN.md §16): a second, queue-driven level on
top of the per-job suite.  A FleetAutoscaler sees the *fleet* signals —
queue depth, queued work, aggregate predicted lateness of the running
jobs — and answers with a target for the fleet's total cloud footprint
(held + staged + pooled chips).  The FleetController converges the
pre-provisioned pool toward that target, so queued jobs can start on
cloud chips (VM-MAD's queue-driven cluster expansion) and late jobs can
draw a slice without paying the provisioning delay.  The variants port
the OpenDC prototype zoo: ``adapt`` is the estimator/controller pair
from SNIPPETS.md, ``reg`` a regression forecaster, ``conpaas`` a
percentile provisioner, ``token`` a budget-paced token bucket.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Protocol

from repro_torch.core.capacity import (
    legal_step_down,
    legal_step_up,
    round_to_legal_slice,
)
from repro_torch.core.orchestrator import (
    ELASTIC_PREFIXES,
    HOLD,
    AutoscalerPolicy,
    ScaleAction,
    ScaleContext,
)

__all__ = [
    "AutoscalerPolicy",
    "AlwaysBurstAutoscaler",
    "provider_backoff_active",
    "AdaptFleetAutoscaler",
    "ConpaasFleetAutoscaler",
    "FLEET_POLICY_FACTORIES",
    "FleetAutoscaler",
    "FleetContext",
    "HistAutoscaler",
    "NoBurstAutoscaler",
    "PlanAutoscaler",
    "ReactAutoscaler",
    "RegFleetAutoscaler",
    "TokenFleetAutoscaler",
    "POLICY_FACTORIES",
]


def provider_backoff_active(ctx: ScaleContext, base_s: float = 60.0,
                            cap_s: float = 960.0) -> bool:
    """Capped exponential provider cooldown (DESIGN.md §19).

    After ``ctx.provision_failures`` consecutive denials, hold off
    re-requesting for ``min(base_s * 2**(failures-1), cap_s)`` seconds
    since the last denial — hammering a provider that keeps saying no
    just burns evaluation intervals.  Every grow-capable policy gates
    its grow on this, so the whole suite inherits the cooldown."""
    if ctx.provision_failures <= 0:
        return False
    cooldown = min(base_s * 2.0 ** (ctx.provision_failures - 1), cap_s)
    return ctx.since_failure_s < cooldown


class NoBurstAutoscaler:
    """Baseline: never touch the cloud (the paper's 'static' run)."""

    name = "no-burst"

    def decide(self, ctx: ScaleContext) -> ScaleAction:
        return HOLD


class AlwaysBurstAutoscaler:
    """Upper bracket: hold the largest legal slice for the whole run.

    Maximizes the chance of hitting the deadline and the bill alike —
    the cost anchor the paper's adaptive approach is judged against.
    """

    name = "always-burst"

    def __init__(self, chips: int | None = None, slowdown: float = 1.4):
        self.chips = chips
        self.slowdown = slowdown

    def decide(self, ctx: ScaleContext) -> ScaleAction:
        target = self.chips or max(ctx.legal)
        if ctx.cloud_chips < target:
            if provider_backoff_active(ctx):
                return HOLD
            return ScaleAction("grow", chips=target,
                               slowdown=self.slowdown,
                               reason="always-burst holds max slice")
        return HOLD


class ReactAutoscaler:
    """Reactive scaler: step the slice up/down on the current signal.

    No capacity model: if the deadline estimate says miss, grow by one
    legal slice; if slack exceeds ``shrink_slack_frac`` of the deadline,
    step down (0 chips ⇒ retire).  The provisioning quantum is the next
    legal slice shape (capacity.legal_step_up/down).
    """

    name = "react"

    def __init__(self, slowdown: float = 1.4,
                 shrink_slack_frac: float = 0.25):
        self.slowdown = slowdown
        self.shrink_slack_frac = shrink_slack_frac

    def decide(self, ctx: ScaleContext) -> ScaleAction:
        est = ctx.est
        if not est.predictable:
            return HOLD
        if est.will_miss:
            if provider_backoff_active(ctx):
                return HOLD
            up = legal_step_up(ctx.cloud_chips, ctx.legal)
            if up > ctx.cloud_chips:
                return ScaleAction("grow", chips=up,
                                   slowdown=self.slowdown,
                                   reason="reactive step up on miss")
            return HOLD
        if (
            ctx.cloud_chips > 0
            and est.slack_s > self.shrink_slack_frac * est.deadline_s
        ):
            down = legal_step_down(ctx.cloud_chips, ctx.legal)
            if down == 0:
                return ScaleAction("retire",
                                   reason="reactive retire on slack")
            return ScaleAction("shrink", chips=down,
                               reason="reactive step down on slack")
        return HOLD


class HistAutoscaler:
    """Predictive scaler: percentile-of-history step time.

    Keeps a window of observed per-step times; projects completion with
    a conservative percentile (growth) and an optimistic one (retire),
    so transient spikes don't whipsaw the slice.  Sizing uses the
    work-conservation identity t ∝ 1/chips on the *percentile* step
    time — a model-free cousin of the paper's capacity inversion.
    """

    name = "hist"

    def __init__(self, window: int = 64, grow_pct: float = 0.9,
                 shrink_pct: float = 0.5, slowdown: float = 1.4,
                 margin_frac: float = 0.1):
        self.window = window
        self.grow_pct = grow_pct
        self.shrink_pct = shrink_pct
        self.slowdown = slowdown
        self.margin_frac = margin_frac
        self._hist: deque[float] = deque(maxlen=window)

    @staticmethod
    def _pct(xs: list[float], q: float) -> float:
        s = sorted(xs)
        return s[min(int(q * len(s)), len(s) - 1)]

    def decide(self, ctx: ScaleContext) -> ScaleAction:
        t_now = ctx.monitor.step_time()
        if t_now > 0:
            self._hist.append(t_now)
        if len(self._hist) < 4 or not ctx.est.predictable:
            return HOLD
        steps_rem = max(ctx.steps_total - ctx.step, 0)
        if steps_rem == 0:
            return HOLD
        budget = ctx.est.deadline_s * (1 - self.margin_frac) \
            - ctx.elapsed_s
        t_grow = self._pct(list(self._hist), self.grow_pct)
        if steps_rem * t_grow > budget > 0:
            # invert t ∝ 1/chips at the pessimistic percentile: how many
            # effective chips would bring the projection inside budget?
            eff_now = sum(
                p.chips / p.slowdown for p in ctx.resources.pods
            )
            eff_needed = eff_now * steps_rem * t_grow / budget
            extra = (eff_needed - eff_now) * self.slowdown
            target = round_to_legal_slice(
                ctx.cloud_chips + extra, ctx.legal
            )
            if target > ctx.cloud_chips:
                if provider_backoff_active(ctx):
                    return HOLD
                return ScaleAction(
                    "grow", chips=target, slowdown=self.slowdown,
                    reason=f"p{int(self.grow_pct * 100)} projects miss",
                )
            return HOLD
        if ctx.cloud_chips > 0 and budget > 0:
            # would the optimistic projection hold *without* the cloud?
            t_opt = self._pct(list(self._hist), self.shrink_pct)
            eff_now = sum(
                p.chips / p.slowdown for p in ctx.resources.pods
            )
            eff_onprem = eff_now - ctx.cloud_chips / self.slowdown
            if eff_onprem > 0:
                t_onprem = t_opt * eff_now / eff_onprem
                if steps_rem * t_onprem < budget:
                    return ScaleAction(
                        "retire",
                        reason=f"p{int(self.shrink_pct * 100)} projects "
                               "hit without cloud",
                    )
        return HOLD


class PlanAutoscaler:
    """Deadline-aware scaler — the paper's pipeline, made reversible.

    GROW: BurstPlanner.plan() runs the full Fig. 1 chain (deadline
    estimate → calibrated capacity model → eq. 3 chips → K correction →
    legal slice), so the slice is *sized*, not stepped.  RETIRE: as soon
    as the projected on-premise-only completion (observed step time
    rescaled by the effective-chip ratio) fits the deadline with margin,
    the cloud pod is dropped — the scale-*down* the paper leaves as
    future work (§4).
    """

    name = "plan"

    def __init__(self, retire_margin_frac: float = 0.15):
        self.retire_margin_frac = retire_margin_frac

    def decide(self, ctx: ScaleContext) -> ScaleAction:
        est = ctx.est
        if not est.predictable:
            return HOLD
        eff_now = sum(p.chips / p.slowdown for p in ctx.resources.pods)
        decision = ctx.planner.plan(
            est, ctx.step, ctx.steps_total,
            observed_step_s=ctx.monitor.step_time(),
            effective_chips=eff_now,
        )
        if decision.burst and decision.chips_burst > ctx.cloud_chips:
            if provider_backoff_active(ctx):
                return HOLD
            reason = decision.reason
            if decision.est_cost_usd > 0 and "$" not in reason:
                # cost-aware planner (DESIGN.md §14): surface the
                # projected bill for the sized slice in the audit trail
                reason += f" (~${decision.est_cost_usd:.2f} projected)"
            return ScaleAction(
                "grow", chips=decision.chips_burst,
                slowdown=max(decision.correction_K, 1e-6),
                reason=reason,
            )
        if ctx.cloud_chips > 0:
            cloud_pods = [
                p for p in ctx.resources.pods
                if p.name.startswith(ELASTIC_PREFIXES)
            ]
            eff_cloud = sum(p.chips / p.slowdown for p in cloud_pods)
            eff_onprem = eff_now - eff_cloud
            steps_rem = max(ctx.steps_total - ctx.step, 0)
            t_now = ctx.monitor.step_time()
            if eff_onprem > 0 and t_now > 0:
                # project the on-premise-alone step time through the
                # *calibrated capacity model* (same curve the sizing
                # uses), not a linear effective-chip rescale — on
                # non-linear laws the linear rescale under-estimates and
                # retires too eagerly, thrashing grow/retire cycles
                cal = ctx.planner.calibrated_cluster_model(
                    t_now, eff_now
                )
                t_onprem = cal.predict_time(ctx.planner.chips_cluster)
                ov = ctx.planner.overheads
                projected = (
                    ctx.elapsed_s + ov.ckpt_s + ov.restart_s
                    + steps_rem * t_onprem
                )
                if projected < (1 - self.retire_margin_frac) \
                        * est.deadline_s:
                    return ScaleAction(
                        "retire",
                        reason="on-premise alone meets deadline "
                               f"({projected:.0f}s < {est.deadline_s:.0f}s)",
                    )
        return HOLD


#: fresh-instance factories (Hist is stateful, one instance per job)
POLICY_FACTORIES = {
    "no-burst": NoBurstAutoscaler,
    "always-burst": AlwaysBurstAutoscaler,
    "react": ReactAutoscaler,
    "hist": HistAutoscaler,
    "plan": PlanAutoscaler,
}


# ===================================================================== #
#  Fleet-level (queue-driven) policies — DESIGN.md §16                  #
# ===================================================================== #


@dataclasses.dataclass
class FleetContext:
    """Fleet signals a queue-driven policy may look at each interval."""

    now: float
    interval_s: float
    queue_depth: int
    queued_chips: int              # Σ chips requested by waiting jobs
    queued_work_chip_s: float      # Σ remaining work of waiting jobs
    running: int                   # admitted, unfinished jobs
    late_jobs: int                 # running jobs predicting a miss
    lateness_s: float              # Σ max(0, −slack) over running jobs
    cloud_committed: int           # held + staged + pooled chips
    pool_free: int                 # provisioned, unattached pool chips
    legal: list[int]
    site_free: int
    budget_left_usd: float         # ∞ when uncapped
    price_per_chip_hour: float
    cloud_slowdown: float = 1.4


class FleetAutoscaler(Protocol):
    """Queue-driven capacity policy: answers with the desired TOTAL
    fleet cloud footprint (held + staged + pooled chips).  The
    controller grows/shrinks the pre-provisioned pool toward it."""

    name: str

    def target(self, ctx: FleetContext) -> int: ...


def _demand_chips(ctx: FleetContext) -> float:
    """The raw demand signal every fleet variant filters: cloud chips
    that would (a) host the queued work the site has no room for and
    (b) erase the running jobs' aggregate predicted lateness within
    roughly one evaluation interval."""
    overflow = max(ctx.queued_chips - ctx.site_free, 0)
    hosting = overflow * ctx.cloud_slowdown
    # chip·s of extra capacity needed to claw back the lateness in ~one
    # interval, charged at the provider's K
    rescue = (
        ctx.lateness_s / max(ctx.interval_s, 1.0) * ctx.cloud_slowdown
        * (ctx.late_jobs > 0)
    )
    return hosting + rescue


def _clip_target(ctx: FleetContext, chips: float) -> int:
    """Round a fractional target to a legal total and respect budget
    exhaustion (a spent budget can only shrink, never grow)."""
    if ctx.budget_left_usd <= 0:
        return min(ctx.cloud_committed, ctx.pool_free)
    if chips <= 0:
        return 0
    target = round_to_legal_slice(chips, ctx.legal)
    return min(target, max(ctx.legal) * 4)


class AdaptFleetAutoscaler:
    """OpenDC ``adapt``-style estimator/controller (SNIPPETS.md).

    Estimator: smooth the demand signal and its per-interval delta.
    Controller: the scaling rate R is the smoothed delta damped
    asymmetrically — scale-downs react an order of magnitude slower
    than scale-ups (the prototype divides negative R by 15) so a
    transient lull does not flap the pool.  The target is the current
    footprint plus R, legal-rounded.
    """

    name = "adapt"

    def __init__(self, up_gain: float = 1.0, down_damp: float = 8.0):
        self.up_gain = up_gain
        self.down_damp = down_damp
        self._prev_demand: float | None = None
        self._rate = 0.0

    def target(self, ctx: FleetContext) -> int:
        demand = _demand_chips(ctx)
        if self._prev_demand is None:
            delta = demand - ctx.cloud_committed
        else:
            delta = demand - self._prev_demand
        self._prev_demand = demand
        if delta >= 0:
            self._rate = self.up_gain * delta
        else:
            self._rate = delta / self.down_damp
        want = max(ctx.cloud_committed + self._rate, demand * (delta >= 0))
        return _clip_target(ctx, want)


class RegFleetAutoscaler:
    """Regression forecaster (OpenDC ``reg``): ordinary least squares
    over the recent (t, demand) history predicts the demand one
    interval ahead; the pool is provisioned for the forecast, so a
    diurnal ramp is met *before* the queue actually fills."""

    name = "reg"

    def __init__(self, window: int = 12):
        self.window = window
        self._hist: deque[tuple[float, float]] = deque(maxlen=window)

    def target(self, ctx: FleetContext) -> int:
        demand = _demand_chips(ctx)
        self._hist.append((ctx.now, demand))
        if len(self._hist) < 3:
            return _clip_target(ctx, demand)
        ts = [t for t, _ in self._hist]
        ds = [d for _, d in self._hist]
        n = len(ts)
        tm = sum(ts) / n
        dm = sum(ds) / n
        sxx = sum((t - tm) ** 2 for t in ts)
        if sxx <= 0:
            return _clip_target(ctx, demand)
        slope = sum(
            (t - tm) * (d - dm) for t, d in zip(ts, ds)
        ) / sxx
        forecast = dm + slope * (ctx.now + ctx.interval_s - tm)
        return _clip_target(ctx, max(forecast, 0.0))


class ConpaasFleetAutoscaler:
    """Percentile provisioner (ConPaaS-style): hold enough pool for the
    ``pct`` percentile of the recent demand history — robust to spikes
    (they shift the tail slowly) while still tracking sustained load."""

    name = "conpaas"

    def __init__(self, window: int = 24, pct: float = 0.8):
        self.window = window
        self.pct = pct
        self._hist: deque[float] = deque(maxlen=window)

    def target(self, ctx: FleetContext) -> int:
        self._hist.append(_demand_chips(ctx))
        s = sorted(self._hist)
        want = s[min(int(self.pct * len(s)), len(s) - 1)]
        return _clip_target(ctx, want)


class TokenFleetAutoscaler:
    """Budget-paced token bucket (OpenDC ``token``): each interval
    earns tokens worth ``spend_frac`` of the remaining cloud budget's
    steady-state burn; adding pool capacity spends tokens at the
    provider's $-rate.  Demand above the current footprint is served
    only as far as the bucket allows, so the policy *paces* spend over
    the run instead of blowing the budget on the first rush."""

    name = "token"

    def __init__(self, spend_frac: float = 0.05, horizon_s: float = 3600.0):
        self.spend_frac = spend_frac
        self.horizon_s = horizon_s
        self._tokens_usd = 0.0

    def target(self, ctx: FleetContext) -> int:
        budget = ctx.budget_left_usd
        if budget == float("inf"):
            # uncapped budget: pace against a nominal hourly burn of
            # one max slice so the bucket still smooths the rush
            budget = (
                max(ctx.legal) * ctx.price_per_chip_hour
            )
        self._tokens_usd += (
            self.spend_frac * budget * ctx.interval_s / self.horizon_s
        )
        demand = _demand_chips(ctx)
        grow = max(demand - ctx.cloud_committed, 0.0)
        if grow <= 0:
            return _clip_target(ctx, demand)
        # $ to hold `grow` chips for one horizon-paced hold
        usd_per_chip = ctx.price_per_chip_hour * ctx.interval_s / 3600.0
        affordable = (
            self._tokens_usd / usd_per_chip if usd_per_chip > 0 else grow
        )
        granted = min(grow, affordable)
        self._tokens_usd -= granted * usd_per_chip
        return _clip_target(ctx, ctx.cloud_committed + granted)


FLEET_POLICY_FACTORIES = {
    "adapt": AdaptFleetAutoscaler,
    "reg": RegFleetAutoscaler,
    "conpaas": ConpaasFleetAutoscaler,
    "token": TokenFleetAutoscaler,
}
