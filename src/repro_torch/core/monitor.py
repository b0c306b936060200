"""Step-time monitor — paper §2 "time monitor".

The paper observes that PDE timesteps are near-constant, so a few
monitored steps predict the whole run.  We implement that check rather
than assume it: the monitor tracks a window of recent step times, flags
whether the series is *predictable* (robust coefficient of variation
below a threshold), and estimates the per-step time with a median-of-
window robust estimator plus an EWMA trend.  It also flags stragglers
(paper: "nodes down / concurrency in the local cluster") via a z-score
against the window median/MAD.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


@dataclasses.dataclass
class StepStats:
    step: int
    seconds: float
    is_straggler: bool
    zscore: float


class StepTimeMonitor:
    def __init__(
        self,
        window: int = 32,
        ewma_alpha: float = 0.2,
        straggler_z: float = 4.0,
        predictable_cv: float = 0.25,
        warmup_steps: int = 2,
    ):
        self.window = window
        self.alpha = ewma_alpha
        self.straggler_z = straggler_z
        self.predictable_cv = predictable_cv
        self.warmup_steps = warmup_steps
        self._times: Deque[float] = deque(maxlen=window)
        self._all: Deque[float] = deque(maxlen=window)
        self._ewma: float | None = None
        self._count = 0
        self._consecutive_rejects = 0
        self.stragglers: list[StepStats] = []
        self.regime_changes: list[int] = []
        self.total_observed_s = 0.0

    def observe(self, seconds: float) -> StepStats:
        self._count += 1
        self.total_observed_s += seconds
        z = 0.0
        straggler = False
        if self._count > self.warmup_steps and len(self._times) >= 4:
            med = _median(self._times)
            mad = _median([abs(t - med) for t in self._times]) or 1e-9
            z = (seconds - med) / (1.4826 * mad)
            straggler = z > self.straggler_z
        stats = StepStats(self._count, seconds, straggler, z)
        self._all.append(seconds)
        if straggler:
            self.stragglers.append(stats)
            self._consecutive_rejects += 1
            # change-point handling: a sustained shift is a new regime
            # (paper: cluster congestion), not stragglers — flush the
            # window and trust the recent observations
            if self._consecutive_rejects >= max(4, self.window // 8):
                self._times.clear()
                recent = list(self._all)[-self._consecutive_rejects:]
                self._times.extend(recent)
                self._ewma = recent[-1]
                self.regime_changes.append(self._count)
                self._consecutive_rejects = 0
        else:
            self._consecutive_rejects = 0
        # isolated stragglers pollute the estimate of the *typical* step;
        # keep them out of the window but remember they happened (the
        # planner uses the straggler rate as a signal)
        if not straggler or self._count <= self.warmup_steps:
            self._times.append(seconds)
            self._ewma = (
                seconds if self._ewma is None
                else self.alpha * seconds + (1 - self.alpha) * self._ewma
            )
        return stats

    @property
    def count(self) -> int:
        return self._count

    def step_time(self) -> float:
        """Robust current per-step estimate (median ⊕ EWMA blend)."""
        if not self._times:
            return 0.0
        med = _median(self._times)
        if self._ewma is None:
            return med
        return 0.5 * (med + self._ewma)

    def predictable(self) -> bool:
        """Paper §2: initial steps are monitored to reason whether the
        workload is predictable before trusting extrapolation."""
        if len(self._times) < max(4, self.warmup_steps + 2):
            return False
        med = _median(self._times)
        if med <= 0:
            return False
        mad = _median([abs(t - med) for t in self._times])
        return (1.4826 * mad) / med <= self.predictable_cv

    def straggler_rate(self, last_n: int = 64) -> float:
        recent = [s for s in self.stragglers if s.step > self._count - last_n]
        return len(recent) / max(min(self._count, last_n), 1)

    def reset_window(self):
        """Called after a re-configuration (burst): old step times no
        longer describe the new platform."""
        self._times.clear()
        self._all.clear()
        self._ewma = None
        self._consecutive_rejects = 0
