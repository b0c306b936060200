"""Event injection + clocks: simulated heterogeneity and faults.

What is simulated vs real (DESIGN.md §10): on real hardware the monitor
consumes wall-clock step times; in this CPU container the same code paths
are driven by a SimClock whose step duration reflects a configurable
per-environment slowdown (the paper's cloud-vs-cluster K), injected
congestion windows, stragglers and node failures.  The *decision* code
never knows which clock it is on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


class WallClock:
    def now(self) -> float:
        return time.monotonic()


@dataclasses.dataclass
class SlowdownWindow:
    start_step: int
    end_step: int
    factor: float                # multiply step time by this


@dataclasses.dataclass
class FailureEvent:
    step: int
    kind: str = "node_down"      # node_down | preemption
    pod: int = 0


@dataclasses.dataclass
class DeadlineChange:
    step: int
    new_deadline_s: float


@dataclasses.dataclass(frozen=True)
class BackgroundLoad:
    """A background tenant occupying site chips over a wall-clock window.

    The fleet simulator sums active BackgroundLoads into site demand, so
    the paper's "cluster overloaded" condition emerges from contention
    (demand / capacity) instead of a scripted SlowdownWindow.
    """

    start_s: float
    end_s: float
    chips: int
    name: str = "tenant"


@dataclasses.dataclass
class SimEnvironment:
    """Synthetic step-time generator for one execution platform."""

    name: str
    base_chip_seconds_per_step: float     # work: chip·s per step at K=1
    chips: int
    slowdown: float = 1.0                 # the paper's K for this env
    jitter: float = 0.02
    windows: list[SlowdownWindow] = dataclasses.field(default_factory=list)

    def step_time(self, step: int, rng) -> float:
        t = self.base_chip_seconds_per_step / self.chips * self.slowdown
        for w in self.windows:
            if w.start_step <= step < w.end_step:
                t *= w.factor
        return t * (1.0 + self.jitter * float(rng.standard_normal()))


@dataclasses.dataclass
class SimCluster:
    """Hybrid platform: on-premise pod + optional burst pods, stepped
    synchronously (paper step 8: per-step synchronization) — the combined
    step time is the max over environments plus a sync cost."""

    envs: list[SimEnvironment]
    sync_overhead_s: float = 0.0
    failures: list[FailureEvent] = dataclasses.field(default_factory=list)

    def step_time(self, step: int, shares, rng) -> float:
        """shares: fraction of work per env (γ-split, sums to 1)."""
        times = []
        for env, share in zip(self.envs, shares):
            if share <= 0:
                continue
            t = (
                env.base_chip_seconds_per_step * share / env.chips
                * env.slowdown
            )
            for w in env.windows:
                if w.start_step <= step < w.end_step:
                    t *= w.factor
            t *= (1.0 + env.jitter * float(rng.standard_normal()))
            times.append(t)
        base = max(times) if times else 0.0
        return base + (self.sync_overhead_s if len(times) > 1 else 0.0)

    def failure_at(self, step: int) -> FailureEvent | None:
        for f in self.failures:
            if f.step == step:
                return f
        return None
