"""Fault model for the hybrid-fleet simulator (DESIGN.md §19).

The paper's premise is meeting deadlines on an *unreliable* substrate,
yet a simulator in which provisioning always succeeds and checkpoints
are always intact only exercises the happy path.  This module is the
seeded fault layer the hardened elastic loop is scored against:

  FaultPlan      declarative fault mix for a scenario — provisioning
                 denials and slow-provision "timeouts", correlated
                 spot-reclaim storms, silent checkpoint-write
                 corruption, straggler pods landing with a degraded K
  RetryPolicy    capped exponential backoff with jitter for
                 provisioning retries; the jitter draw comes from a
                 seeded Generator the caller supplies, so a retried
                 run stays bit-deterministic per (scenario, seed)
  FaultInjector  one job's draw source: every probabilistic fault is
                 drawn from a per-job ``default_rng([seed, idx, 7])``
                 stream, independent of other jobs and of the step /
                 spot-life streams, so adding faults to one job never
                 perturbs another's trajectory

Determinism contract (DESIGN.md §19): all draws flow from seeded
per-job streams in event-loop order; the module holds no wall-clock,
no global RNG, and no set/dict iteration — the ``sim-determinism``
lint rule gates on it like the rest of ``repro/sim``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "FaultInjector",
    "FaultPlan",
    "RetryPolicy",
]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault mix injected into a FleetSim run.

    Probabilities are per-draw: ``provision_fail_p`` per provisioning
    attempt, ``ckpt_corrupt_p`` per checkpoint write, ``straggler_p``
    per pod attach.  ``reclaim_storms`` are correlated events: at each
    ``(t_s, p)`` every job holding elastic chips is reclaimed with
    probability ``p`` *at the same instant* — the market-wide capacity
    crunch independent per-job spot lifetimes cannot model.
    """

    #: per-attempt probability a provisioning request is denied
    provision_fail_p: float = 0.0
    #: per-attempt probability provisioning is slow ("timeout"): the
    #: provider still delivers, after ``provision_timeout_x`` × delay
    provision_timeout_p: float = 0.0
    provision_timeout_x: float = 4.0
    #: correlated reclaim storms: tuple of (t_s, per-job hit probability)
    reclaim_storms: tuple[tuple[float, float], ...] = ()
    #: per-save probability a written checkpoint is silently corrupt
    ckpt_corrupt_p: float = 0.0
    #: per-attach probability a grown pod is a straggler whose true K is
    #: ``straggler_x`` × the provider's nominal slowdown
    straggler_p: float = 0.0
    straggler_x: float = 3.0

    def any_faults(self) -> bool:
        return bool(
            self.provision_fail_p > 0.0
            or self.provision_timeout_p > 0.0
            or self.reclaim_storms
            or self.ckpt_corrupt_p > 0.0
            or self.straggler_p > 0.0
        )


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff + jitter for provisioning retries
    (DESIGN.md §19).

    Attempt ``k`` (1-based) that fails waits
    ``min(base_s * mult**(k-1), cap_s) * (1 + jitter_frac * U)`` before
    re-requesting, with ``U ~ Uniform[0, 1)`` drawn from the caller's
    seeded Generator — jitter de-synchronizes a fleet of retriers
    without breaking per-seed bit-determinism.  ``max_retries`` bounds
    the re-requests after the first attempt; exhaustion is surfaced as
    ``gave_up`` on the run record.
    """

    max_retries: int = 4
    base_s: float = 5.0
    mult: float = 2.0
    cap_s: float = 120.0
    jitter_frac: float = 0.1

    def backoff_s(self, attempt: int, rng: np.random.Generator) -> float:
        """Backoff before re-attempting after failed attempt ``attempt``
        (1-based).  Always consumes exactly one draw from ``rng`` so the
        stream position is attempt-count deterministic."""
        u = float(rng.uniform())
        base = min(self.base_s * self.mult ** max(attempt - 1, 0),
                   self.cap_s)
        return base * (1.0 + self.jitter_frac * u)


class FaultInjector:
    """Seeded per-job draw source for one :class:`FaultPlan`.

    All of a job's fault draws come from one dedicated
    ``default_rng([seed, job_index, 7])`` stream (DESIGN.md §19) —
    disjoint from the step-jitter (``[seed, idx]``) and spot-lifetime
    (``[seed, idx, 1]``) streams — so enabling faults never shifts the
    draws an existing scenario already consumes, and each fault draw
    happens at a deterministic point of the event loop.
    """

    def __init__(self, plan: FaultPlan, seed: int, job_index: int):
        self.plan = plan
        self.rng = np.random.default_rng([seed, job_index, 7])

    def provision_outcome(self) -> tuple[bool, float]:
        """One provisioning attempt: ``(denied, delay_multiplier)``.

        Both draws always happen (even when their probabilities are 0)
        so the stream position per attempt is fixed regardless of the
        plan's parameters.
        """
        denied = float(self.rng.uniform()) < self.plan.provision_fail_p
        slow = float(self.rng.uniform()) < self.plan.provision_timeout_p
        return denied, (self.plan.provision_timeout_x if slow else 1.0)

    def ckpt_corrupt(self) -> bool:
        """Draw whether this checkpoint write is silently corrupt."""
        return float(self.rng.uniform()) < self.plan.ckpt_corrupt_p

    def straggler_k(self, nominal_slowdown: float) -> float:
        """The true K of a freshly attached pod: nominal, or degraded
        by ``straggler_x`` when the straggler draw hits."""
        if float(self.rng.uniform()) < self.plan.straggler_p:
            return nominal_slowdown * self.plan.straggler_x
        return nominal_slowdown

    def storm_hit(self, p: float) -> bool:
        """Per-job draw for one correlated reclaim storm."""
        return float(self.rng.uniform()) < p
