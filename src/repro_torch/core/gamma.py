"""Domain-split solver γ — paper eqs. (4), (5), (8).

The paper fixes one domain dimension and models execution time as linear
in the number of grid columns γ placed in the external environment:

    f(γ) = t = a·γ + b                (eq. 4)
    g(t) = γ = (t − b) / a            (eq. 5; fitted eq. 8)

γ must be an integer (column count).  The same linear model serves the LM
adaptation where the divisible dimension is the global batch: t is linear
in the local batch share for a fixed model, so γ becomes "microbatches
moved to the burst pod".
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class GammaModel:
    """t = a·γ + b (seconds per γ units kept/moved)."""

    a: float
    b: float
    name: str = ""

    def time_for(self, gamma: float) -> float:
        return self.a * gamma + self.b

    def gamma_for(self, t: float) -> int:
        """Paper eq. 5: γ = (t − b)/a, rounded up to an integer."""
        if self.a == 0:
            return 0
        g = (t - self.b) / self.a
        return max(int(-(-g // 1)), 0)  # ceil

    @staticmethod
    def fit(gammas: Sequence[float], times_s: Sequence[float],
            name: str = "") -> "GammaModel":
        assert len(gammas) == len(times_s) and len(gammas) >= 2
        n = len(gammas)
        mx = sum(gammas) / n
        my = sum(times_s) / n
        sxx = sum((x - mx) ** 2 for x in gammas)
        sxy = sum(
            (x - mx) * (y - my) for x, y in zip(gammas, times_s)
        )
        a = sxy / max(sxx, 1e-12)
        b = my - a * mx
        return GammaModel(a=a, b=b, name=name)

    def r2(self, gammas: Sequence[float], times_s: Sequence[float]) -> float:
        my = sum(times_s) / len(times_s)
        ss_tot = sum((y - my) ** 2 for y in times_s)
        ss_res = sum(
            (y - self.time_for(g)) ** 2 for g, y in zip(gammas, times_s)
        )
        return 1.0 - ss_res / max(ss_tot, 1e-12)


def split_gamma(total_columns: int, time_needed: float,
                model: GammaModel) -> int:
    """Columns to move off-premise so the on-premise part finishes in
    time_needed; clamped to [0, total_columns]."""
    keep = model.gamma_for(time_needed)
    move = total_columns - keep
    return min(max(move, 0), total_columns)
