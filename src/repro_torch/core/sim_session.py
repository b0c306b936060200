"""Simulated hybrid-cluster session (paper-reproduction benchmarks).

Drives the ElasticOrchestrator with synthetic step times from
core/events.SimEnvironment — the same decision path a real TPU session
exercises, with wall-clock replaced by the simulated platform model
(DESIGN.md §10 records this boundary).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.events import SlowdownWindow
from repro_torch.core.orchestrator import PodFailure, Resources


@dataclasses.dataclass
class SimWorkload:
    chip_seconds_per_step: float      # total work per step (chip·s)
    jitter: float = 0.02
    #: per-pod rate law exponent: a pod of c chips advances its share at
    #: rate ∝ c**alpha / K.  alpha = 1 is the work-conserving default;
    #: alpha > 1 models the superlinear regimes striped stencils hit
    #: when smaller per-device domains become cache-resident — the
    #: regime where the cost-aware planner's larger-but-cheaper slices
    #: are real (DESIGN.md §14).
    scaling_alpha: float = 1.0


class SimSession:
    """Session over a Resources allocation; per-step synchronization
    across pods (paper step 8) makes the step time the max over pods."""

    def __init__(
        self,
        workload: SimWorkload,
        res: Resources,
        start_step: int,
        restored,
        *,
        rng: np.random.Generator,
        windows: dict[int, list[SlowdownWindow]] | None = None,
        failures: dict[int, int] | None = None,  # step -> pod
        sync_overhead_s: float = 0.0,
        extra_slowdown: Callable[[int, int], float] | None = None,
    ):
        self.w = workload
        self.res = res
        self.rng = rng
        self.windows = windows or {}
        self.failures = failures or {}
        self.sync_overhead_s = sync_overhead_s
        # (pod_index, step) -> multiplicative slowdown, queried per step.
        # The fleet simulator hooks site contention in here so overload
        # *emerges* from background-tenant demand instead of being
        # scripted via SlowdownWindow (DESIGN.md §11).
        self.extra_slowdown = extra_slowdown
        # copy: the caller's checkpoint must stay immutable after restore
        self.state = dict(restored) if restored else {"step": start_step}

    def run_step(self, step: int) -> float:
        if step in self.failures:
            pod = self.failures.pop(step)
            if pod < len(self.res.pods):
                raise PodFailure(pod, step)
        times = []
        for i, (pod, share) in enumerate(
            zip(self.res.pods, self.res.shares)
        ):
            if share <= 0:
                continue
            t = (self.w.chip_seconds_per_step * share
                 / pod.chips ** self.w.scaling_alpha)
            t *= pod.slowdown
            for wdw in self.windows.get(i, []):
                if wdw.start_step <= step < wdw.end_step:
                    t *= wdw.factor
            if self.extra_slowdown is not None:
                t *= self.extra_slowdown(i, step)
            times.append(t)
        dt = max(times) if times else 0.0
        dt *= 1.0 + self.w.jitter * abs(float(self.rng.standard_normal()))
        if len(times) > 1:
            dt += self.sync_overhead_s
        self.state["step"] = step + 1
        return dt

    def checkpoint(self, step: int):
        return dict(self.state)


def sim_session_factory(workload: SimWorkload, *, rng=None, windows=None,
                        failures=None, sync_overhead_s=0.0,
                        extra_slowdown=None):
    rng = rng or np.random.default_rng(0)
    failures = dict(failures or {})

    def factory(res: Resources, start_step: int, restored) -> SimSession:
        return SimSession(
            workload, res, start_step, restored,
            rng=rng, windows=windows, failures=failures,
            sync_overhead_s=sync_overhead_s,
            extra_slowdown=extra_slowdown,
        )

    return factory
