"""Burst planner — the paper's Fig. 1 decision pipeline, steps 1-4.

Given a deadline-miss prediction, compute (paper §2):
  step 3: the chip count needed in the elastic environment —
          solve L_cluster for the remaining-time budget, apply the
          correction factor K, subtract on-premise capacity (eq. 3),
          round up to a legal slice shape;
  step 4: the share of the domain (γ) to place there (eqs. 4-5) —
          for LM training, γ is the burst pod's share of the global
          batch, realized by the heterogeneous allocator.

Beyond the paper (its §3.3 names this as future work): the decision
inequality accounts for the burst overhead explicitly —
  T_after = T_ckpt + T_provision + T_transfer + T_restart
            + steps_remaining · t_step(after)
and bursting is only worth it if T_after < min(T_stay, deadline).

Cost-aware sizing (DESIGN.md §14; SLA/cost placement in the spirit of
arXiv:1507.05472): when the planner knows the provider's
``price_per_chip_hour``, the minimal-cores solve becomes the *floor* of
a candidate sweep over legal slices.  Each candidate's projected $ is
``price · chips · hold_s`` where ``hold_s`` is the retire-aware hold
time (the pod is dropped as soon as the remaining work fits on-premise
within the deadline, mirroring the `plan` policy's RETIRE rule).  The
``cost_weight`` knob w ∈ [0, 1] sets how much of the remaining time
budget may be spent chasing savings: a candidate is admissible only if
its projected completion consumes at most ``w · (deadline − elapsed)``,
so w = 0 reproduces the deadline-first minimal slice exactly and w = 1
takes the cheapest deadline-feasible slice.  With the empirically
fitted log-laws the cheapest slice is *not* always the smallest —
superlinear scaling regimes (cache effects on striped stencils) make a
larger slice finish and retire so much earlier that it bills fewer
chip-hours.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.capacity import (
    LogCapacityModel,
    burst_cores,
    correction_factor,
    round_to_legal_slice,
)
from repro_torch.core.deadline import DeadlineEstimate
from repro_torch.core.gamma import GammaModel


@dataclasses.dataclass(frozen=True)
class OverheadModel:
    """Fixed + size-dependent burst overheads (seconds).

    ``seam_latency_s``/``seam_syncs_per_step`` model the per-step halo
    synchronization over the slow cross-environment link (paper §3.3's
    21 KB message is latency-, not bandwidth-, dominated).  With the
    temporally-blocked solver, ``seam_syncs_per_step`` is
    ``halo_exchange_plan(...)["ppermutes_per_step"] / 2`` — k-step
    blocking cuts the recurring burst tax k×.

    Provenance of a *measured* seam (``with_measured_seam``): feed in the
    solver's ``halo_exchange_plan(cfg, n_stripes, k)`` (message shape and
    cadence) plus a per-ppermute latency measured by
    ``benchmarks/bench_overheads.py`` (jitted ``lax.ppermute`` dispatch
    over a seam-sized payload on this host).  One seam sync is one
    packed bidirectional exchange = 2 ppermutes, so
    ``seam_latency_s = 2 · t_ppermute`` and ``seam_syncs_per_step =
    ppermutes_per_step / 2 = 1/k``.  On real hardware substitute the
    cross-DCI ppermute timing; the CPU number is a dispatch-latency
    floor, not a network RTT."""

    ckpt_s: float = 10.0
    provision_s: float = 90.0           # slice spin-up
    restart_s: float = 30.0             # re-compile + re-shard + warmup
    transfer_bytes: float = 0.0         # checkpoint/state moved cross-env
    transfer_bw: float = 6.25e9         # DCI bytes/s
    seam_latency_s: float = 0.0         # one cross-env halo round trip
    seam_syncs_per_step: float = 1.0    # exchanges per timestep (1/k)

    def total(self) -> float:
        xfer = self.transfer_bytes / max(self.transfer_bw, 1.0)
        return self.ckpt_s + self.provision_s + self.restart_s + xfer

    def seam_s_per_step(self) -> float:
        return self.seam_latency_s * self.seam_syncs_per_step

    def with_measured_seam(
        self, plan: dict, ppermute_latency_s: float
    ) -> "OverheadModel":
        """Replace the default-zero seam with a measured one (ROADMAP
        item; provenance in the class docstring).  ``plan`` is
        ``fwi.domain.halo_exchange_plan(...)``."""
        return dataclasses.replace(
            self,
            seam_latency_s=(
                plan["ppermutes_per_exchange"] * ppermute_latency_s
            ),
            seam_syncs_per_step=plan["ppermutes_per_step"] / 2.0,
        )

    def with_overlapped_seam(
        self, plan: dict, ppermute_latency_s: float,
        compute_s_per_step: float = 0.0,
    ) -> "OverheadModel":
        """Measured seam AFTER comm/compute overlap (DESIGN.md §13).

        The overlapped engine issues the packed exchange first and
        computes the stripe interior — ``plan["overlap_fraction"]`` of
        the block's work — while it is in flight, so a k-step block
        costs ``max(interior, seam) + boundary`` instead of
        ``compute + seam``.  The seam surcharge over pure compute is
        therefore only the residue ``max(seam − interior, 0)``:

            seam_block     = ppermutes_per_exchange · t_ppermute
            interior_block = compute_s_per_step · k · overlap_fraction
            effective seam = max(seam_block − interior_block, 0)

        With ``compute_s_per_step = 0`` (unknown) this degrades to
        ``with_measured_seam`` — no overlap credit is taken.  On real
        hardware the hiding needs async collectives; the planner model
        assumes the schedule the engine's program order enables."""
        seam_block = plan["ppermutes_per_exchange"] * ppermute_latency_s
        interior_block = (
            compute_s_per_step * plan["steps_per_exchange"]
            * plan.get("overlap_fraction", 0.0)
        )
        return dataclasses.replace(
            self,
            seam_latency_s=max(seam_block - interior_block, 0.0),
            seam_syncs_per_step=plan["ppermutes_per_step"] / 2.0,
        )


@dataclasses.dataclass(frozen=True)
class BurstDecision:
    burst: bool
    reason: str
    chips_burst: int = 0
    gamma: int = 0                       # work units moved (µbatches/columns)
    gamma_total: int = 0
    est_time_stay_s: float = 0.0
    est_time_burst_s: float = 0.0
    overhead_s: float = 0.0
    correction_K: float = 1.0
    cores_needed: float = 0.0
    est_hold_s: float = 0.0              # projected cloud-pod hold time
    est_cost_usd: float = 0.0            # projected $ for the hold


class BurstPlanner:
    def __init__(
        self,
        *,
        cluster_model: LogCapacityModel,
        cloud_model: LogCapacityModel,
        chips_cluster: int,
        legal_slices: Sequence[int],
        overheads: OverheadModel = OverheadModel(),
        gamma_model: GammaModel | None = None,
        gamma_total: int = 0,
        max_burst_chips: int | None = None,
        price_per_chip_hour: float = 0.0,
        cost_weight: float = 0.0,
    ):
        self.cluster_model = cluster_model
        self.cloud_model = cloud_model
        self.chips_cluster = chips_cluster
        self.legal = list(legal_slices)
        self.overheads = overheads
        self.gamma_model = gamma_model
        self.gamma_total = gamma_total
        self.max_burst_chips = (
            max(self.legal) if max_burst_chips is None else max_burst_chips
        )
        #: provider $ per chip-hour (0 disables cost projection entirely)
        self.price_per_chip_hour = price_per_chip_hour
        #: cost/deadline trade-off knob w ∈ [0, 1] (module docstring):
        #: 0 = deadline-first minimal slice, 1 = cheapest feasible slice
        self.cost_weight = min(max(cost_weight, 0.0), 1.0)

    def cost_usd(self, chip_seconds: float) -> float:
        return chip_seconds / 3600.0 * self.price_per_chip_hour

    # ---- cost-aware sizing (DESIGN.md §14) ---------------------------

    def _burst_hold_s(
        self, chips: int, K: float, cluster_model: LogCapacityModel,
        steps_rem: int, budget_s: float,
    ) -> float:
        """Retire-aware hold-time projection for a candidate slice.

        The `plan` policy drops the pod once the remaining steps fit
        on-premise within the deadline; with per-step times t_burst
        (combined) and t_on (on-premise alone), the pod must be held
        until the accumulated head-start covers the on-premise deficit:

            hold = (steps_rem · t_on − budget) / (t_on / t_burst − 1)

        clamped to [0, steps_rem · t_burst] (never longer than running
        the whole remainder on the combined fleet)."""
        t_burst = self._post_burst_step_time(chips, K, cluster_model)
        t_on = cluster_model.predict_time(self.chips_cluster)
        full = steps_rem * t_burst
        if t_on <= t_burst:
            return full
        deficit = steps_rem * t_on - budget_s
        hold = deficit / (t_on / t_burst - 1.0)
        return min(max(hold, 0.0), full)

    def _cost_aware_choice(
        self, chips_min: int, K: float,
        cluster_model: LogCapacityModel, est: DeadlineEstimate,
        steps_rem: int, overhead_s: float,
    ) -> tuple[int, float, float]:
        """Pick the cheapest admissible legal slice ≥ the deadline-first
        solve; returns (chips, hold_s, cost_usd).  Admissibility: the
        candidate's projected completion must consume at most
        ``cost_weight · (deadline − elapsed)`` of the remaining time —
        when slack is tight no candidate qualifies and the deadline-first
        slice stands (with its own cost projection attached)."""
        budget_s = est.deadline_s - est.elapsed_s - overhead_s
        spendable = self.cost_weight * (est.deadline_s - est.elapsed_s)
        best = None
        for s in sorted(self.legal):
            if s < chips_min or s > self.max_burst_chips:
                continue
            t_after = steps_rem * self._post_burst_step_time(
                s, K, cluster_model
            )
            hold = self._burst_hold_s(
                s, K, cluster_model, steps_rem, budget_s
            )
            dollars = self.cost_usd(s * hold)
            if overhead_s + t_after > spendable:
                continue                    # too close to the deadline
            if best is None or dollars < best[2] * (1.0 - 1e-9):
                best = (s, hold, dollars)
        if best is None:                    # slack too tight: deadline-first
            hold = self._burst_hold_s(
                chips_min, K, cluster_model, steps_rem, budget_s
            )
            return chips_min, hold, self.cost_usd(chips_min * hold)
        return best

    def calibrated_cluster_model(
        self, observed_step_s: float | None, effective_chips: float | None,
    ) -> LogCapacityModel:
        """Online intercept calibration (beyond paper; its §3.3 flags the
        static fit as a source of inaccuracy): shift B so the model
        reproduces the *currently observed* step time at the current
        effective chip count — congestion moves the whole curve up."""
        if not observed_step_s or not effective_chips:
            return self.cluster_model
        predicted = self.cluster_model.predict_time(effective_chips)
        if predicted <= 0:
            return self.cluster_model
        shift = math.log10(max(observed_step_s, 1e-9) / predicted)
        m = self.cluster_model
        return LogCapacityModel(A=m.A, B=m.B + shift, name=m.name + "+cal")

    def plan(
        self,
        est: DeadlineEstimate,
        steps_done: int,
        steps_total: int,
        *,
        observed_step_s: float | None = None,
        effective_chips: float | None = None,
    ) -> BurstDecision:
        if not est.predictable:
            return BurstDecision(False, "step times not yet predictable")
        if not est.will_miss:
            return BurstDecision(
                False, "deadline met on current resources",
                est_time_stay_s=est.estimated_total_s,
            )
        steps_rem = max(steps_total - steps_done, 0)
        if steps_rem == 0:
            return BurstDecision(False, "no steps remaining")
        overhead = self.overheads.total()
        budget = est.deadline_s - est.elapsed_s - overhead
        if budget <= 0:
            return BurstDecision(
                False,
                "deadline unreachable even with burst (overhead exceeds "
                "remaining budget)",
                est_time_stay_s=est.estimated_total_s,
                overhead_s=overhead,
            )
        cluster_model = self.calibrated_cluster_model(
            observed_step_s, effective_chips
        )
        # --- paper step 3: chips needed -------------------------------
        # The capacity model is fitted on *per-step* times; scale the
        # remaining-time budget to a per-step budget.
        t_step_budget = budget / steps_rem
        cores_needed = cluster_model.cores_for(t_step_budget)
        K = correction_factor(
            self.cloud_model, cluster_model, max(cores_needed, 1.0)
        )
        c_n = burst_cores(cores_needed, self.chips_cluster, K)
        chips = round_to_legal_slice(c_n, self.legal)
        chips = min(chips, self.max_burst_chips)
        if chips == 0:
            return BurstDecision(
                False, "cluster alone satisfies the adjusted budget",
                est_time_stay_s=est.estimated_total_s,
                cores_needed=cores_needed, correction_K=K,
            )
        # --- cost-aware slice selection (DESIGN.md §14) ----------------
        hold_s = cost_usd = 0.0
        reason = "deadline at risk; bursting"
        if self.price_per_chip_hour > 0:
            if self.cost_weight > 0:
                chosen, hold_s, cost_usd = self._cost_aware_choice(
                    chips, K, cluster_model, est, steps_rem, overhead
                )
                if chosen != chips:
                    reason = (
                        f"deadline at risk; bursting {chosen} chips "
                        f"(cost-aware over minimal {chips}: "
                        f"${cost_usd:.2f} projected)"
                    )
                    chips = chosen
            else:
                hold_s = self._burst_hold_s(
                    chips, K, cluster_model, steps_rem,
                    est.deadline_s - est.elapsed_s - overhead,
                )
                cost_usd = self.cost_usd(chips * hold_s)
        # --- paper step 4: domain split γ ------------------------------
        # time the on-premise side may spend per step after the split
        gamma = 0
        if self.gamma_model is not None and self.gamma_total > 0:
            gamma = self.gamma_total - self.gamma_model.gamma_for(
                t_step_budget
            )
            gamma = min(max(gamma, 1), self.gamma_total - 1)
        else:
            # LM default: share ∝ burst throughput (chips / K)
            eff = chips / max(K, 1e-9)
            gamma_frac = eff / (self.chips_cluster + eff)
            gamma = max(int(self.gamma_total * gamma_frac), 1) \
                if self.gamma_total else 0
        # --- estimate post-burst completion ---------------------------
        t_step_after = self._post_burst_step_time(chips, K, cluster_model)
        t_burst = est.elapsed_s + overhead + steps_rem * t_step_after
        if t_burst >= est.estimated_total_s:
            return BurstDecision(
                False,
                "burst would not improve completion time "
                "(overhead dominates)",
                est_time_stay_s=est.estimated_total_s,
                est_time_burst_s=t_burst,
                overhead_s=overhead, correction_K=K,
                cores_needed=cores_needed,
            )
        return BurstDecision(
            True,
            reason,
            chips_burst=chips,
            gamma=gamma,
            gamma_total=self.gamma_total,
            est_time_stay_s=est.estimated_total_s,
            est_time_burst_s=t_burst,
            overhead_s=overhead,
            correction_K=K,
            cores_needed=cores_needed,
            est_hold_s=hold_s,
            est_cost_usd=cost_usd,
        )

    def _post_burst_step_time(
        self, chips_burst: int, K: float,
        cluster_model: LogCapacityModel | None = None,
    ) -> float:
        """Combined throughput of cluster + K-degraded burst slice."""
        m = cluster_model or self.cluster_model
        t_cluster = m.predict_time(self.chips_cluster)
        # effective chips: burst chips are 1/K as productive per the
        # correction factor (K >= 1 when the cloud is slower); every
        # split step also pays the cross-env seam synchronization
        eff = self.chips_cluster + chips_burst / max(K, 1e-9)
        base = m.predict_time(eff) if eff > 0 else t_cluster
        return base + self.overheads.seam_s_per_step()
