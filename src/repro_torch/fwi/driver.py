"""Self-adaptive FWI driver — the paper end-to-end on the port's solver.

The counterpart of the JAX package's ``fwi/driver.py``.  An FWISession
runs the striped engine (``domain.make_sharded_scan_runner``) over its
stripe count, or the fused block engine (``solver.make_block_runner``)
on one stripe, and the ElasticOrchestrator drives monitoring →
prediction → burst exactly as in the JAX package; CHECKPOINT and
RESHARD are real: the whole fields are gathered to the host and placed
again, under the next session's stripes, by the next session.  So a
GROW through ``elastic_stripes_for`` moves part of the domain onto the
new stripe.

Measurement is amortized over a dispatch of ``scan_block`` timesteps
(a multiple of the block length k): the session times the dispatch up
to ``torch.cuda.synchronize()``, so on the card the amortized step time
is the card's, and reports wall/steps for each logical step inside it.

``autotune=True`` tunes the session's own kernel on the card: the
shot-batched block kernel's (tile, k) at the session's shot count
(``kernels/stencil/tune.py::autotune_block``); on the CPU it raises, as
the plain version has no tiles.
"""
from __future__ import annotations

import dataclasses
import signal
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import (
    CheckpointManager,
    install_preemption_hook,
)
from repro_torch.core.orchestrator import Resources, Session, elastic_chips
from repro_torch.device import resolve_device
from repro_torch.fwi.domain import (
    effective_block,
    make_sharded_scan_runner,
    pick_schedule,
    stripe_mesh,
)
from repro_torch.fwi.solver import FWIConfig, ShotState, make_block_runner
from repro_torch.kernels.stencil.ops import pick_k
from repro_torch.kernels.stencil.tune import autotune_block


@dataclasses.dataclass
class TimeModel:
    """How a step's wall time is derived (DESIGN.md §10).

    measure (``chip_seconds_per_step=None``): the measured wall time of
    the session's dispatch, stretched by the burst environment's K on
    its work share; otherwise the platform model below.
    """

    chip_seconds_per_step: float | None = None  # None -> measure
    congestion: dict[int, float] = dataclasses.field(default_factory=dict)
    congestion_until: int = 10 ** 9
    congestion_from: int = 0
    congestion_factor: float = 1.0
    jitter: float = 0.01
    #: platform-model rate-law exponent (t ∝ 1/chips**alpha), matching
    #: SimWorkload.scaling_alpha (DESIGN.md §14)
    scaling_alpha: float = 1.0


def _field(x, device: torch.device) -> torch.Tensor:
    """A restored wavefield (tensor or array) as f32 on ``device``; an
    array is copied, so the session never aliases a caller's buffer."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.array(x, np.float32)).to(device)


class FWISession(Session):
    def __init__(
        self,
        cfg: FWIConfig,
        res: Resources,
        start_step: int,
        restored,
        *,
        time_model: TimeModel,
        rng: np.random.Generator,
        n_stripes: int | None = None,
        exchange_interval: int | None = 4,
        scan_block: int = 8,
        autotune: bool = False,
        device="cuda",
    ):
        self.cfg = cfg
        self.res = res
        self.tm = time_model
        self.rng = rng
        self.device = resolve_device(device)
        devices = (torch.cuda.device_count()
                   if self.device.type == "cuda" else 1)
        n = n_stripes or min(devices, max(res.total_chips, 1))
        while cfg.nx % n:
            n -= 1
        #: the block kernel's CTA tile (None: the kernel's default)
        self.tile = None
        if autotune:
            if self.device.type != "cuda":
                raise ValueError(
                    f"autotune times the CUDA kernel's tiles; the plain "
                    f"version on {self.device} has none")
            # tuned at the session's own shot count and stripe width, on
            # the kernel it runs; memoized, so a rebuild after a resize
            # does not re-time
            self.tile, k = autotune_block(cfg.nz, cfg.nx // n, cfg.n_shots,
                                          device=self.device)
        else:
            k = exchange_interval if exchange_interval is not None \
                else pick_k(cfg.nz)
        # the overlap windows must fit one stripe (as the JAX package)
        self.k = effective_block(cfg, n, k)
        if n == 1:
            # one stripe exchanges nothing: the block engine, whole
            run = make_block_runner(
                cfg, k=self.k, collect_traces=False, tile=self.tile,
                device=self.device)
            self.runner = lambda p, pp, t, blocks: run(p, pp, t,
                                                       blocks * self.k)
            self._place = self._gather = lambda x: x
            self._launches_per_block = 1
        else:
            self.runner, place, _ = make_sharded_scan_runner(
                cfg, stripe_mesh(n, self.device), k=self.k, tile=self.tile,
                overlap=pick_schedule(self.device), collect_traces=False)
            self._place, self._gather = place, self.runner.gather
            self._launches_per_block = self.runner.launches_per_block
        # timesteps per measured dispatch (a multiple of k)
        self.block = max(scan_block // self.k, 1) * self.k
        #: k-step blocks this session has dispatched
        self.blocks = 0
        if restored is not None:
            st = ShotState(
                p=_field(restored["p"], self.device),
                p_prev=_field(restored["p_prev"], self.device),
                t=int(restored["t"]),
            )
        else:
            st = ShotState.init(cfg, self.device)
        self._p, self._pp = self._place(st.p), self._place(st.p_prev)
        self.t = st.t
        # logical steps already covered by the last dispatched block —
        # carried through checkpoints so a mid-block RESHARD resumes the
        # remaining steps instead of re-dispatching
        self._pending = int(restored.get("pending", 0)) \
            if restored is not None else 0
        self._amortized = float(restored.get("amortized_s", 0.0)) \
            if restored is not None else 0.0
        # fleet signature of the Resources the amortized step time was
        # measured under; a RESHARD onto a different fleet rescales the
        # estimate by the modeled effective-throughput ratio until the
        # next dispatched block re-measures it
        self._n_stripes = n
        self._res_sig = (
            n, tuple((p.chips, round(p.slowdown, 9)) for p in res.pods)
        )
        self._eff = sum(
            p.chips / max(p.slowdown, 1e-9) for p in res.pods
        )
        if restored is not None and self._amortized > 0.0:
            old_sig = restored.get("res_sig")
            old_eff = float(restored.get("amortized_eff", 0.0))
            if (old_sig is not None and old_sig != self._res_sig
                    and old_eff > 0.0 and self._eff > 0.0):
                self._amortized *= old_eff / self._eff

    @property
    def n_stripes(self) -> int:
        return self._n_stripes

    @property
    def p(self) -> torch.Tensor:
        """The whole (S, NZ, NX) wavefield, gathered from the stripes."""
        return self._gather(self._p)

    @property
    def p_prev(self) -> torch.Tensor:
        return self._gather(self._pp)

    @property
    def launches(self) -> int:
        """Block-kernel launches this session has made."""
        return self.blocks * self._launches_per_block

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _advance_block(self) -> float:
        """Dispatch one scan block; returns amortized wall s/step."""
        self._sync()
        t0 = time.monotonic()
        blocks = self.block // self.k
        p, pp = self.runner(self._p, self._pp, self.t, blocks)
        self._sync()
        dt = time.monotonic() - t0
        self._p, self._pp = p, pp
        self.t += self.block
        self.blocks += blocks
        return dt / self.block

    def run_step(self, step: int) -> float:
        if self._pending <= 0:
            self._amortized = self._advance_block()
            self._pending = self.block
        self._pending -= 1
        wall = self._amortized
        if self.tm.chip_seconds_per_step is not None:
            # platform-model time: work split over pods, slowest wins
            times = []
            for pod, share in zip(self.res.pods, self.res.shares):
                if share <= 0:
                    continue
                t = (self.tm.chip_seconds_per_step * share
                     / pod.chips ** self.tm.scaling_alpha
                     * pod.slowdown)
                if (pod.name == "cluster"
                        and self.tm.congestion_from <= step
                        < self.tm.congestion_until):
                    t *= self.tm.congestion_factor
                times.append(t)
            dt = max(times)
        else:
            dt = wall
            k_max = max(
                (p.slowdown for p, s in zip(self.res.pods, self.res.shares)
                 if s > 0), default=1.0,
            )
            if k_max > 1.0:
                time.sleep(wall * (k_max - 1.0))
                dt = wall * k_max
        return dt * (1.0 + self.tm.jitter * abs(self.rng.standard_normal()))

    def checkpoint(self, step: int):
        return {
            "p": self.p.cpu().numpy(),
            "p_prev": self.p_prev.cpu().numpy(),
            "t": self.t,
            "pending": self._pending,
            "amortized_s": self._amortized,
            "res_sig": self._res_sig,
            "amortized_eff": self._eff,
        }


def restored_from_reference(snap: dict, *, device="cuda") -> dict:
    """The port's ``restored`` dict from a JAX package
    ``FWISession.checkpoint()`` dict (numpy ``p``/``p_prev``, scalars,
    ``res_sig``): the wavefields become tensors on ``device``, so a JAX
    session's state resumes in the port."""
    dev = resolve_device(device)
    n, pods = snap["res_sig"]
    return {
        "p": _field(snap["p"], dev),
        "p_prev": _field(snap["p_prev"], dev),
        "t": int(snap["t"]),
        "pending": int(snap["pending"]),
        "amortized_s": float(snap["amortized_s"]),
        "amortized_eff": float(snap["amortized_eff"]),
        "res_sig": (int(n), tuple(tuple(x) for x in pods)),
    }


def save_session_snapshot(manager: CheckpointManager, steps_done: int,
                          snap: dict) -> None:
    """Persist an FWISession.checkpoint() dict through the
    CheckpointManager (DESIGN.md §19): wavefields go as array leaves
    (checksummed per leaf), scalars and the resource signature ride in
    the manifest's ``extra``.  Blocks until the write is durable."""
    arrays = {"p": snap["p"], "p_prev": snap["p_prev"]}
    n, pods = snap["res_sig"]
    extra = {
        "t": int(snap["t"]),
        "pending": int(snap["pending"]),
        "amortized_s": float(snap["amortized_s"]),
        "amortized_eff": float(snap["amortized_eff"]),
        "res_sig": [n, [list(x) for x in pods]],
        "steps_done": int(steps_done),
    }
    manager.save(steps_done, arrays, extra=extra, wait=True)


def load_session_snapshot(manager: CheckpointManager,
                          step: int | None = None) -> tuple[dict, int]:
    """Inverse of save_session_snapshot: returns ``(restored,
    steps_done)`` where ``restored`` feeds FWISession(...) directly
    (numpy wavefields).  The resource signature is rebuilt as nested
    tuples, as FWISession compares it with ``!=`` (DESIGN.md §19)."""
    state, extra = manager.restore({"p": 0, "p_prev": 0}, step=step)
    n, pods = extra["res_sig"]
    restored = {
        "p": state["p"].numpy(),
        "p_prev": state["p_prev"].numpy(),
        "t": int(extra["t"]),
        "pending": int(extra["pending"]),
        "amortized_s": float(extra["amortized_s"]),
        "amortized_eff": float(extra["amortized_eff"]),
        "res_sig": (n, tuple(tuple(x) for x in pods)),
    }
    return restored, int(extra["steps_done"])


class PreemptionGuard:
    """SIGTERM → durable snapshot → clean exit, torn-state-free
    (DESIGN.md §19).

    The driver loop ``publish()``es a coherent snapshot at each step
    boundary — one store into a single slot, atomic with respect to
    signal delivery — and ``save()`` (the SIGTERM handler once
    installed) persists whatever snapshot was last published.
    """

    def __init__(self, manager: CheckpointManager, *,
                 exit_code: int = 143):
        self.manager = manager
        self.exit_code = exit_code
        self._slot: list = [None]    # (steps_done, checkpoint dict)
        self._prev_handler = None

    def publish(self, session: Session, steps_done: int) -> None:
        """Record the step-boundary snapshot the handler may persist.
        Call from the driver loop after each completed step."""
        self._slot[0] = (steps_done, session.checkpoint(steps_done))

    def install(self) -> "PreemptionGuard":
        self._prev_handler = install_preemption_hook(
            self.save, exit_code=self.exit_code
        )
        return self

    def uninstall(self) -> None:
        if self._prev_handler is not None:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._prev_handler = None

    def save(self) -> None:
        """Persist the last published snapshot (no-op before one)."""
        snap = self._slot[0]
        if snap is None:
            return
        steps_done, state = snap
        save_session_snapshot(self.manager, steps_done, state)


def elastic_stripes_for(base_stripes: int = 1, grown_stripes: int = 2):
    """``stripes_for`` mapping for the real elastic loop (DESIGN.md
    §14): ``grown_stripes`` while an elastic (cloud/burst) pod is
    attached, ``base_stripes`` otherwise, so a GROW moves the burst
    pod's stripes of the domain onto it and a RETIRE takes them back."""

    def stripes(res: Resources) -> int:
        return grown_stripes if elastic_chips(res) > 0 else base_stripes

    return stripes


def fwi_session_factory(cfg: FWIConfig, time_model: TimeModel,
                        *, seed: int = 0, stripes_for=None,
                        exchange_interval: int | None = 4,
                        scan_block: int = 8,
                        autotune: bool = False,
                        device="cuda"):
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)

    def factory(res: Resources, start_step: int, restored) -> FWISession:
        n = stripes_for(res) if stripes_for else None
        return FWISession(
            cfg, res, start_step, restored,
            time_model=time_model, rng=rng, n_stripes=n,
            exchange_interval=exchange_interval, scan_block=scan_block,
            autotune=autotune, device=dev,
        )

    return factory
