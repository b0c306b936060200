"""Heterogeneous work allocator — the γ split realized for SPMD.

The paper assigns unequal domain shares to unequal environments.  SPMD
requires a uniform per-device program, so unequal shares are realized as
*unequal microbatch counts with padding + loss masking*: every pod runs
the same number of µ-steps (the max), but pods with a smaller share get
zero-masked filler microbatches.  Work conservation holds exactly: the
sum of unmasked tokens equals the global batch.

The striped/greedy second-level placement of the paper (§3.3) maps to
device order inside the mesh: a pod's microbatches are contiguous on its
"data" axis, so only the gradient reduction crosses the pod boundary.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


def max_min_fair_allocation(
    capacity: float,
    demands: Sequence[float],
    weights: Sequence[float] | None = None,
) -> list[float]:
    """Weighted max-min fair split of ``capacity`` across ``demands``.

    Progressive filling: capacity is poured into the unsatisfied
    demands in proportion to their weights until each is either
    satisfied (allocation == demand) or the capacity runs out — the
    classic water-filling definition of (weighted) max-min fairness.
    The fleet controller uses it to arbitrate simultaneous cloud-grow
    requests under the global budget cap, so no tenant can crowd the
    headroom out of another's ungranted request (DESIGN.md §16).

    Zero-weight demands are served only by whatever capacity is left
    after every positive-weight demand is satisfied.
    """
    n = len(demands)
    if weights is None:
        weights = [1.0] * n
    alloc = [0.0] * n
    left = max(float(capacity), 0.0)
    active = [
        i for i in range(n) if demands[i] > 0 and weights[i] > 0
    ]
    while active and left > 1e-12:
        wsum = sum(weights[i] for i in active)
        # the smallest per-weight top-up that satisfies some demand
        limit = min(
            (demands[i] - alloc[i]) / weights[i] for i in active
        )
        fill = min(limit, left / wsum)
        for i in active:
            alloc[i] += fill * weights[i]
        left -= fill * wsum
        active = [
            i for i in active if demands[i] - alloc[i] > 1e-12
        ]
    if left > 1e-12:
        # residual capacity flows to zero-weight demands, equally
        zero = [i for i in range(n) if demands[i] > 0 and weights[i] <= 0]
        while zero and left > 1e-12:
            fill = min(
                min(demands[i] - alloc[i] for i in zero), left / len(zero)
            )
            for i in zero:
                alloc[i] += fill
            left -= fill * len(zero)
            zero = [i for i in zero if demands[i] - alloc[i] > 1e-12]
    return alloc


def min_weighted_share(
    usage: Sequence[float],
    weights: Sequence[float],
    demands: Sequence[float] | None = None,
) -> float:
    """Max-min fairness score of a realized ``usage`` split, in [0, 1].

    1.0 means every positive-weight party received at least its
    weighted proportional share of the total served; lower values are
    the worst party's shortfall ratio (min_i (usage_i/weight_i) /
    (total/total_weight)).  With ``demands`` the entitlement is
    demand-bounded — a party that *asked* for less than its weighted
    share and got everything it asked for is fully satisfied, not a
    fairness victim.  The fleet tournament reports this as its fairness
    column (DESIGN.md §16): a scheduler that starves a tenant scores
    near 0 no matter how good its aggregate hit-rate looks.
    """
    if demands is None:
        demands = [math.inf] * len(usage)
    triples = [
        (u, w, d) for u, w, d in zip(usage, weights, demands)
        if w > 0 and d > 0
    ]
    if len(triples) <= 1:
        return 1.0
    total = sum(u for u, _, _ in triples)
    wtotal = sum(w for _, w, _ in triples)
    if total <= 0:
        return 1.0
    fair_rate = total / wtotal
    worst = min(
        u / min(w * fair_rate, d) for u, w, d in triples
    )
    return max(0.0, min(worst, 1.0))


def proportional_shares(throughputs: Sequence[float]) -> list[float]:
    """Normalized work shares ∝ throughput — the γ split as fractions.

    The paper's cloud pod contributes chips/K effective throughput; every
    place that recomputes shares after a fleet GROW/SHRINK/RETIRE or a
    rebalance goes through this one normalization (DESIGN.md §4).
    """
    total = sum(throughputs)
    if total <= 0:
        n = len(throughputs)
        return [1.0 / n] * n if n else []
    return [t / total for t in throughputs]


@dataclasses.dataclass(frozen=True)
class PodShare:
    pod: int
    microbatches: int            # real (unmasked) microbatches
    padded_microbatches: int     # uniform count run by every pod
    tokens: int


@dataclasses.dataclass(frozen=True)
class HeterogeneousPlan:
    shares: tuple[PodShare, ...]
    microbatch_size: int
    seq_len: int

    @property
    def total_tokens(self) -> int:
        return sum(s.tokens for s in self.shares)

    def mask_for(self, pod: int) -> np.ndarray:
        """(padded_microbatches,) 0/1 mask of real µ-batches for a pod."""
        sh = self.shares[pod]
        m = np.zeros(sh.padded_microbatches, np.float32)
        m[: sh.microbatches] = 1.0
        return m


def heterogeneous_split(
    *,
    global_batch: int,
    microbatch: int,
    seq_len: int,
    throughputs: Sequence[float],
) -> HeterogeneousPlan:
    """Split `global_batch` into per-pod microbatch counts ∝ throughput.

    throughputs: relative tokens/sec of each pod (the paper's 1/K for the
    cloud pod).  Total microbatches are preserved exactly; rounding
    residue goes to the fastest pod.
    """
    assert global_batch % microbatch == 0, (global_batch, microbatch)
    n_mb = global_batch // microbatch
    total_tp = sum(throughputs)
    raw = [n_mb * tp / total_tp for tp in throughputs]
    counts = [int(math.floor(r)) for r in raw]
    # distribute the remainder by largest fractional part, ties → fastest
    residue = n_mb - sum(counts)
    order = sorted(
        range(len(raw)),
        key=lambda i: (raw[i] - counts[i], throughputs[i]),
        reverse=True,
    )
    for i in range(residue):
        counts[order[i % len(order)]] += 1
    padded = max(counts) if counts else 0
    shares = tuple(
        PodShare(
            pod=i,
            microbatches=c,
            padded_microbatches=padded,
            tokens=c * microbatch * seq_len,
        )
        for i, c in enumerate(counts)
    )
    return HeterogeneousPlan(
        shares=shares, microbatch_size=microbatch, seq_len=seq_len
    )


def conservation_ok(plan: HeterogeneousPlan, global_batch: int) -> bool:
    return (
        sum(s.microbatches for s in plan.shares) * plan.microbatch_size
        == global_batch
    )
