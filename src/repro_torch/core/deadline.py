"""Deadline predictor — paper §2 step 1.

Extrapolates total completion time from the monitored per-step estimate
and compares against the (dynamically changeable) deadline.  The paper
notes the deadline "could also change dynamically" — set_deadline() may
be called at any time and the next check uses the new value.

Every change is also recorded with the clock time it took effect
(``set_deadline(..., at_s=...)``), so completed work can be judged
against the deadline *in force when it finished* rather than whatever
the deadline happens to be when the record is written
(``deadline_at``) — a job that finished before a later tightening must
not be retro-judged against the new, stricter value (DESIGN.md §14).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.monitor import StepTimeMonitor


@dataclasses.dataclass
class DeadlineEstimate:
    estimated_total_s: float
    elapsed_s: float
    remaining_s: float
    deadline_s: float
    slack_s: float
    will_miss: bool
    predictable: bool


class DeadlinePredictor:
    def __init__(self, deadline_s: float, margin_frac: float = 0.05):
        self.deadline_s = deadline_s
        self.margin_frac = margin_frac
        #: (effective_from_s, deadline_s) change log; the initial
        #: deadline is in force from the beginning of time
        self.history: list[tuple[float, float]] = [(-math.inf, deadline_s)]

    def set_deadline(self, deadline_s: float, at_s: float | None = None):
        """Change the deadline; ``at_s`` (caller's clock) records when
        the change took effect so ``deadline_at`` can answer queries
        about the past.  Without ``at_s`` the predictor has no clock to
        pin the change to, so it governs the *current* deadline
        (``deadline_s``) but is never presumed to predate any finite
        finish time — an untimestamped tightening must not retro-judge
        already-completed work."""
        self.deadline_s = deadline_s
        t = math.inf if at_s is None else float(at_s)
        self.history.append((t, deadline_s))

    def deadline_at(self, t_s: float) -> float:
        """The deadline in force at clock time ``t_s`` — what a job that
        finished then should be judged against.  Entries may be logged
        out of order; the latest-inserted entry at the greatest
        effective time ≤ ``t_s`` wins."""
        best_t = -math.inf
        in_force = self.history[0][1]
        for t, d in self.history:
            if t <= t_s and t >= best_t:
                best_t = t
                in_force = d
        return in_force

    def estimate(
        self,
        monitor: StepTimeMonitor,
        steps_done: int,
        steps_total: int,
        elapsed_s: float,
    ) -> DeadlineEstimate:
        t_step = monitor.step_time()
        remaining = max(steps_total - steps_done, 0) * t_step
        total = elapsed_s + remaining
        margin = self.margin_frac * self.deadline_s
        will_miss = total > self.deadline_s - margin
        return DeadlineEstimate(
            estimated_total_s=total,
            elapsed_s=elapsed_s,
            remaining_s=remaining,
            deadline_s=self.deadline_s,
            slack_s=self.deadline_s - total,
            will_miss=will_miss and monitor.predictable(),
            predictable=monitor.predictable(),
        )
