"""Placement schedulers for the central job queue (DESIGN.md §16).

Given the fair-share-ordered queue and the free capacity of each
placement target — the on-premise site and (when a fleet autoscaler
holds one) the pre-provisioned cloud pool — a Scheduler picks which
waiting jobs start where.  The policy families mirror the OpenDC
scheduler zoo (best-fit / worst-fit / fill) plus the FIFO baseline the
tournament brackets against:

  fifo        strict order, no skipping, site-first: the head blocks
              the queue until it fits somewhere (classic batch queue)
  fill        first-fit backfill: walk the fair-share order, admit
              anything that fits somewhere, skip what doesn't
  best-fit    repeatedly admit the (entry, target) pair leaving the
              least free capacity behind — packs tightest, so large
              jobs still find contiguous room
  worst-fit   admit the pair leaving the MOST free capacity — keeps
              headroom for the next arrival at some packing cost

Placement prefers the site over the cloud pool at equal fit: site
chips are already paid for, pool chips bill per hour and run at the
provider's K slowdown.  Every scheduler returns placements only; the
FleetController applies them (and enforces the starvation guard) so
mechanism stays policy-independent, exactly like the per-job
ScaleAction split (DESIGN.md §11, §16).
"""
from __future__ import annotations

from typing import Protocol

from repro_torch.sim.queue import QueueEntry

__all__ = [
    "BestFitScheduler",
    "FifoScheduler",
    "FillScheduler",
    "Placement",
    "SCHEDULER_FACTORIES",
    "Scheduler",
    "WorstFitScheduler",
]

#: placement targets, in preference order at equal fit
SITE = "site"
CLOUD = "cloud"

#: (entry, target) pair the controller should admit
Placement = tuple[QueueEntry, str]


class Scheduler(Protocol):
    """Admission policy over the fair-share-ordered queue."""

    name: str

    def select(
        self, ordered: list[QueueEntry], free: dict[str, int]
    ) -> list[Placement]: ...


def _fits(entry: QueueEntry, free: dict[str, int]) -> list[str]:
    """Targets that can hold the entry, site preferred."""
    out = []
    for tgt in (SITE, CLOUD):
        if free.get(tgt, 0) >= entry.chips:
            out.append(tgt)
    return out


class FifoScheduler:
    """Arrival order, head-of-line blocking — the classic batch queue.

    Ignores the fair-share ranking on purpose: FIFO is the tournament's
    discipline baseline, so it must be the undoctored thing the other
    schedulers are judged against.
    """

    name = "fifo"

    def select(self, ordered, free):
        free = dict(free)
        out: list[Placement] = []
        for e in sorted(ordered, key=lambda e: (e.enqueued_s, e.name)):
            fit = _fits(e, free)
            if not fit:
                break                      # the head blocks the queue
            out.append((e, fit[0]))
            free[fit[0]] -= e.chips
        return out


class FillScheduler:
    """First-fit backfill in fair-share order: admit whatever fits,
    skip what doesn't.  The workhorse — fair-share picks who deserves
    chips, fill makes sure no chip idles while anyone fits."""

    name = "fill"

    def select(self, ordered, free):
        free = dict(free)
        out: list[Placement] = []
        for e in ordered:
            fit = _fits(e, free)
            if fit:
                out.append((e, fit[0]))
                free[fit[0]] -= e.chips
        return out


class _FitScheduler:
    """Shared body of best-fit / worst-fit: repeatedly score every
    (entry, target) pair by the free capacity left behind and admit the
    extreme one; fair-share order breaks score ties."""

    #: pick the pair minimizing (best-fit) or maximizing (worst-fit)
    #: the leftover capacity at its target
    _sign = 1

    def select(self, ordered, free):
        free = dict(free)
        waiting = list(ordered)
        out: list[Placement] = []
        while True:
            best: tuple | None = None
            for rank, e in enumerate(waiting):
                for tgt in _fits(e, free):
                    leftover = free[tgt] - e.chips
                    # site preferred at equal leftover (tgt==CLOUD is 1)
                    key = (self._sign * leftover, rank, tgt == CLOUD)
                    if best is None or key < best[0]:
                        best = (key, e, tgt)
            if best is None:
                return out
            _, e, tgt = best
            out.append((e, tgt))
            free[tgt] -= e.chips
            waiting.remove(e)


class BestFitScheduler(_FitScheduler):
    """Tightest packing: admit the job/target pair that leaves the
    least free capacity behind (min leftover)."""

    name = "best-fit"
    _sign = 1


class WorstFitScheduler(_FitScheduler):
    """Maximum headroom: admit the pair that leaves the MOST free
    capacity behind, so the next arrival has room (max leftover)."""

    name = "worst-fit"
    _sign = -1


SCHEDULER_FACTORIES = {
    "fifo": FifoScheduler,
    "fill": FillScheduler,
    "best-fit": BestFitScheduler,
    "worst-fit": WorstFitScheduler,
}
