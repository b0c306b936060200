"""Capacity models — paper eqs. (1), (2), (3), (6), (7).

The paper empirically fits, per environment, a log-law between elapsed
time and core count:

    L_cluster(c) = -D·ln c + E        (eq. 2;  fitted eq. 7)
    L_cloud(c)   = -A·ln c + B        (eq. 1;  fitted eq. 6)

with L = log10(elapsed seconds) and c = cores.  The fit is done on a
small pre-processing job (paper §2) — here: a few monitored steps per
device count, or an analytic TPU cost model when no measurements exist.

The performance-correction factor between environments (paper §2):

    K(c) = L_cloud(c) / L_cluster(c)

and the cores to provision in the elastic environment (eq. 3):

    c_n = (c - c_cluster) · K

where c solves the cluster model for the deadline.  On TPU, "cores" are
chips and c_n is rounded UP to the nearest legal slice shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class LogCapacityModel:
    """L(c) = -A·ln c + B with L = log10(time in seconds)."""

    A: float
    B: float
    name: str = ""

    def log_time(self, cores: float) -> float:
        return -self.A * math.log(max(cores, 1e-12)) + self.B

    def predict_time(self, cores: float) -> float:
        """Elapsed seconds at `cores` (paper eq. 1/2 evaluated)."""
        return 10.0 ** self.log_time(cores)

    def cores_for(self, deadline_s: float) -> float:
        """Invert the model: cores needed to finish within deadline_s."""
        if deadline_s <= 0:
            return math.inf
        if self.A <= 0:
            return math.inf
        ln_c = (self.B - math.log10(deadline_s)) / self.A
        return math.exp(ln_c)

    @staticmethod
    def fit(cores: Sequence[float], times_s: Sequence[float],
            name: str = "") -> "LogCapacityModel":
        """Least-squares on (ln c, log10 t) — the paper's empirical fit."""
        assert len(cores) == len(times_s) and len(cores) >= 2
        xs = [math.log(c) for c in cores]
        ys = [math.log10(t) for t in times_s]
        n = len(xs)
        mx = sum(xs) / n
        my = sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        slope = sxy / max(sxx, 1e-12)
        intercept = my - slope * mx
        return LogCapacityModel(A=-slope, B=intercept, name=name)

    def r2(self, cores: Sequence[float], times_s: Sequence[float]) -> float:
        ys = [math.log10(t) for t in times_s]
        my = sum(ys) / len(ys)
        ss_tot = sum((y - my) ** 2 for y in ys)
        ss_res = sum(
            (y - self.log_time(c)) ** 2 for c, y in zip(cores, ys)
        )
        return 1.0 - ss_res / max(ss_tot, 1e-12)


def correction_factor(cloud: LogCapacityModel, cluster: LogCapacityModel,
                      cores: float, mode: str = "time") -> float:
    """Performance-correction factor K between environments (paper §2).

    mode="paper": K = L_cloud/L_cluster — the paper's literal ratio of
    log10 times.  Only meaningful when elapsed times are far from 1 s
    (the paper's jobs run 10^4-10^5 s); near log10(t)=0 it diverges.

    mode="time" (default): K = t_cloud/t_cluster = 10^(L_cloud−L_cluster)
    — the throughput ratio, dimensionless and stable at any time scale;
    this is what the planner uses.  bench_capacity_fit.py reports both
    (they agree to a few % in the paper's own regime).
    """
    lc = cluster.log_time(cores)
    ld = cloud.log_time(cores)
    if mode == "paper":
        if abs(lc) < 1e-12:
            return 1.0
        return ld / lc
    return 10.0 ** (ld - lc)


def burst_cores(
    cores_needed: float,
    cores_cluster: int,
    K: float,
) -> float:
    """Paper eq. 3: c_n = (c - c_cluster) · K (never negative)."""
    return max(cores_needed - cores_cluster, 0.0) * K


def round_to_legal_slice(c_n: float, legal: Sequence[int]) -> int:
    """Round the fractional chip demand UP to the nearest legal slice."""
    if c_n <= 0:
        return 0
    for s in sorted(legal):
        if s >= c_n:
            return s
    return max(legal)


def floor_to_legal_slice(c_n: float, legal: Sequence[int]) -> int:
    """Round the fractional chip grant DOWN to the nearest legal slice.

    The fleet controller's budget arbitration hands each competing
    grow request its max-min fair share of the remaining headroom;
    the share only becomes a provisionable pod at a legal slice shape,
    and rounding *up* would overspend the cap — so grants floor
    (0 means the request is denied this interval, DESIGN.md §16).
    """
    fit = [s for s in sorted(legal) if s <= c_n]
    return fit[-1] if fit else 0


def legal_step_up(current: int, legal: Sequence[int]) -> int:
    """Next legal slice strictly above `current` (max slice if at top).

    Reactive autoscalers grow one provisioning quantum at a time; on TPU
    the quantum is the next legal slice shape, not +1 chip.
    """
    for s in sorted(legal):
        if s > current:
            return s
    return max(legal)


def legal_step_down(current: int, legal: Sequence[int]) -> int:
    """Largest legal slice strictly below `current`; 0 means retire."""
    down = [s for s in sorted(legal) if s < current]
    return down[-1] if down else 0


@dataclasses.dataclass(frozen=True)
class ThroughputModel:
    """Linear-throughput alternative for per-step workloads.

    The paper's log-law models *total elapsed time* of a fixed job.  For
    step-periodic training the same machinery applies to step time; for
    near-perfect data parallelism t_step(c) ≈ w / c, which is the log-law
    with A = 1/ln(10).  We keep both: the fitted LogCapacityModel is used
    whenever measurements exist, this analytic fallback otherwise.
    """

    work_per_step: float  # chip-seconds per step

    def predict_step_time(self, chips: float) -> float:
        return self.work_per_step / max(chips, 1e-12)

    def chips_for_step_time(self, t_step: float) -> float:
        return self.work_per_step / max(t_step, 1e-12)


@dataclasses.dataclass(frozen=True)
class ShotBatchModel:
    """Affine shot-batch throughput law fitted from measured S-scaling:

        t_step(s) = a + b·s        (seconds per timestep, whole batch)

    ``a`` is the per-step cost the batch AMORTIZES — kernel launches /
    grid passes plus the shared model-field traffic the batched engine
    charges once (DESIGN.md §17); ``b`` is the irreducible per-shot
    cost (each shot's own wavefield reads/writes and stencil math).
    Feeding the planner this law instead of the naive ``s·t_step(1)``
    makes BurstPlanner's deadline calculus reflect the REAL batched
    engine: per-shot time falls as ``a/s + b``, so splitting a shot
    batch across more devices buys less than linear once ``a`` is
    amortized away."""

    a: float               # s/step, batch-amortized overhead
    b: float               # s/step/shot, irreducible per-shot work
    name: str = ""

    @staticmethod
    def fit(s_values: Sequence[float], t_steps: Sequence[float],
            name: str = "") -> "ShotBatchModel":
        """Least-squares fit of t_step(s) = a + b·s over measured
        (batch size, per-step wall clock) points; a is clamped at 0 so
        a noisily super-linear measurement can't imply negative
        overhead."""
        assert len(s_values) == len(t_steps) >= 2, (s_values, t_steps)
        n = float(len(s_values))
        ms = sum(s_values) / n
        mt = sum(t_steps) / n
        var = sum((s - ms) ** 2 for s in s_values)
        cov = sum((s - ms) * (t - mt)
                  for s, t in zip(s_values, t_steps))
        b = cov / var if var else 0.0
        a = max(mt - b * ms, 0.0)
        return ShotBatchModel(a=a, b=b, name=name)

    def t_step(self, s: float) -> float:
        """Seconds per timestep advancing a batch of ``s`` shots."""
        return self.a + self.b * max(s, 0.0)

    def per_shot_step_time(self, s: float) -> float:
        return self.t_step(s) / max(s, 1e-12)

    def amortization(self, s: float) -> float:
        """Speedup of the s-batch over s separate single-shot runs —
        the measured analogue of the traffic model's ratio."""
        return (s * self.t_step(1.0)) / max(self.t_step(s), 1e-12)
