"""Central job queue with fair-share + priority ordering (DESIGN.md §16).

The paper manages ONE application's deadline; production scale means a
*stream* of FWI sessions from many users competing for one hybrid
fleet.  This module is the admission side of that problem, in the shape
of VM-MAD's queue-driven cluster expansion (arXiv:1302.2529) and the
SLA-advisor's placement-across-jobs view (arXiv:1507.05472):

  Tenant         a user/group with a fair-share ``weight`` and a
                 ``priority`` tie-break; zero-weight tenants only run
                 when nobody else wants the chips
  QueueEntry     one job waiting for placement (chips requested,
                 remaining work, enqueue time, skip count)
  CentralQueue   the queue itself; ``order()`` ranks waiting entries by
                 weighted fair-share deficit — the tenant whose served
                 usage per unit weight is lowest goes first — then
                 priority, then arrival

The queue only *orders*; which ordered entry is admitted where is the
Scheduler's placement call (repro_torch.sim.schedulers), and the starvation
guard — nobody may be admitted past a patience-expired head entry — is
enforced once, in the FleetController's admission pass, so every
scheduler inherits it (DESIGN.md §16).
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "CentralQueue",
    "QueueEntry",
    "Tenant",
    "tenants_for",
]


@dataclasses.dataclass(frozen=True)
class Tenant:
    """A user/group competing for the fleet.

    ``weight`` is the fair-share entitlement (usage is normalized by it
    when ranking); ``priority`` breaks deficit ties, higher first.  A
    weight of 0 marks a scavenger tenant: it is ranked after every
    positive-weight tenant and the starvation guard does not protect it.
    """

    name: str
    weight: float = 1.0
    priority: float = 0.0


@dataclasses.dataclass
class QueueEntry:
    """One job waiting in the central queue."""

    name: str
    tenant: str
    chips: int                     # on-premise-equivalent chips requested
    work_chip_s: float             # total remaining work (chip·seconds)
    enqueued_s: float
    priority: float = 0.0          # per-job boost on top of the tenant's
    skips: int = 0                 # admission passes that overtook it
    preemptions: int = 0           # times checkpointed off the site (§19)

    def wait_s(self, now: float) -> float:
        return max(now - self.enqueued_s, 0.0)


def tenants_for(names, declared: tuple[Tenant, ...] = ()) -> dict[str, Tenant]:
    """Tenant table for a job stream: declared tenants win; any tenant
    name that appears only on jobs gets a default weight-1 entry."""
    table = {t.name: t for t in declared}
    for n in names:
        table.setdefault(n, Tenant(name=n))
    return table


class CentralQueue:
    """FIFO-arrival queue ranked by weighted fair-share deficit.

    The ranking key for an entry of tenant T is
    ``(usage[T] / weight[T], -priority, enqueued_s, name)``: the tenant
    that has consumed the least site time per unit weight goes first —
    the deficit form of weighted fair queueing the HPC fair-share
    schedulers (SLURM multifactor, OpenDC's CentralQueue) use.  Usage
    is supplied by the caller (the FleetController meters served
    chip·seconds per tenant), so the queue itself stays stateless about
    history and trivially deterministic.
    """

    def __init__(self, tenants: dict[str, Tenant] | None = None):
        self.tenants = dict(tenants or {})
        self._entries: dict[str, QueueEntry] = {}

    # ---- membership -------------------------------------------------------

    def push(self, entry: QueueEntry) -> None:
        if entry.name in self._entries:
            raise ValueError(f"job {entry.name!r} already queued")
        self.tenants.setdefault(entry.tenant, Tenant(name=entry.tenant))
        self._entries[entry.name] = entry

    def remove(self, name: str) -> QueueEntry:
        return self._entries.pop(name)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    @property
    def depth(self) -> int:
        return len(self._entries)

    def queued_chips(self) -> int:
        return sum(e.chips for e in self._entries.values())

    def queued_work_chip_s(self) -> float:
        return sum(e.work_chip_s for e in self._entries.values())

    # ---- ordering ---------------------------------------------------------

    def _rank(self, e: QueueEntry, usage: dict[str, float]):
        t = self.tenants.get(e.tenant, Tenant(name=e.tenant))
        if t.weight > 0:
            deficit = usage.get(e.tenant, 0.0) / t.weight
            scavenger = 0
        else:
            deficit = 0.0
            scavenger = 1                  # after every weighted tenant
        return (
            scavenger, deficit, -(t.priority + e.priority),
            e.enqueued_s, e.name,
        )

    def order(self, usage: dict[str, float] | None = None) -> list[QueueEntry]:
        """Waiting entries, most-deserving first.  ``usage`` maps tenant
        name -> served chip·seconds so far (missing = 0)."""
        usage = usage or {}
        return sorted(
            self._entries.values(), key=lambda e: self._rank(e, usage)
        )
