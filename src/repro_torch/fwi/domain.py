"""Striped domain decomposition with a temporally-blocked halo exchange
on PyTorch (paper Fig. 2): communication-avoiding and -hiding.

The counterpart of the JAX package's ``fwi/domain.py``.  The x-axis
(width) is cut into ``n`` equal column stripes; the height is whole.
Each stripe receives a k·HALO-wide halo from each neighbour once per
block and then runs k timesteps with no communication: a window's
zero-extended edge spoils HALO columns a step, so after k steps exactly
the stripe's own columns are right (overlapping, "ghost-zone" temporal
blocking).  For k > 1 the p_prev edges travel with the p edges; for k =
1 the p_prev halo is never read and is zero.

A ``StripeMesh`` holds the stripes in one of two forms:

* **in one process** (``stripe_mesh(n, devices)``): a list of stripe
  tensors, each on its device (on one card all n live on it).  The
  exchange is a device-to-device copy of the (S, NZ, k·HALO) edges.
* **one stripe per rank** of a ``torch.distributed`` group
  (``stripe_mesh(group=...)``): each direction is one packed message
  (p and p_prev edges stacked), both sent with ``batch_isend_irecv``.

In both forms the physical domain edges receive zeros, which is the
reference's zero-halo convention.

Three schedules compute one block (DESIGN.md §13, §15):

* ``"fused"``: the exchange first, then ONE window over the extended
  stripe [-pad, nxl+pad).  Each stripe lives in an extended buffer
  whose halo columns the exchange overwrites in place, so a block makes
  no copy of the whole stripe.
* ``"overlap"``: the exchange is issued first (on the card, on a side
  CUDA stream ordered by events), the stripe's INTERIOR window runs
  while it is in flight, then two 3·k·HALO-column BOUNDARY windows
  consume the received halos and their valid columns are stitched into
  the interior's output.
* ``"pipeline"``: the halos ride in the loop's carry.  A prologue
  exchange primes block 0; each block runs its boundary windows first,
  issues block b+1's exchange from their fresh edge columns, then runs
  its interior and stitches; the epilogue exchange is discarded.

Sources inject into every window that covers them, with per-shot (S, k)
amplitudes zeroed where a window does not cover a shot's column.  Each
cell's arithmetic does not depend on the window, so every schedule is
bitwise equal to the single-stripe block runner, on the CPU (plain
versions) and on the card (``wave_block.cu``).  Which schedule is
fastest is measured (``pick_schedule``; ``PERF.md``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.fwi.solver import FWIConfig, model_fields
from repro_torch.kernels.stencil.kernel import HALO
from repro_torch.kernels.stencil.ops import wave_block

SCHEDULES = ("fused", "overlap", "pipeline")

#: the schedule measured fastest on each device type (``chip_smoke.py``
#: phase ``striped``, ``PERF.md`` §5): on one H100 at 600² and 4096² the
#: split schedules' two extra launches a stripe cost more than the
#: exchange they hide; on the CPU the exchange is a copy in one process
FASTEST = {"cuda": "fused", "cpu": "fused"}


@dataclasses.dataclass(frozen=True)
class StripeMesh:
    """n column stripes and where the ones this process holds live.

    ``group`` None: all n stripes are in this process, stripe i on
    ``devices[i]``.  Otherwise this process holds the stripe of its rank
    in ``group`` (n ranks), on ``devices[0]``."""

    n: int
    devices: tuple
    group: object = None

    @property
    def stripes(self) -> tuple[int, ...]:
        """Global indices of the stripes this process holds."""
        if self.group is None:
            return tuple(range(self.n))
        return (dist.get_rank(self.group),)


def stripe_mesh(n: int | None = None, devices=None, *,
                group=None) -> StripeMesh:
    """n stripes in this process (``devices``: one device for all, or
    one per stripe; default the card), or, with a ``torch.distributed``
    ``group``, one stripe per rank on ``devices`` (one device)."""
    if group is not None:
        size = dist.get_world_size(group)
        if n is not None and n != size:
            raise ValueError(f"{n} stripes over a group of {size} ranks")
        dev = resolve_device("cuda" if devices is None else devices)
        return StripeMesh(size, (dev,), group)
    if devices is None or isinstance(devices, (str, torch.device)):
        dev = resolve_device("cuda" if devices is None else devices)
        if n is None:
            n = torch.cuda.device_count() if dev.type == "cuda" else 1
        return StripeMesh(n, (dev,) * n)
    devs = tuple(resolve_device(d) for d in devices)
    n = len(devs) if n is None else n
    if len(devs) < n:
        raise ValueError(f"{n} stripes on {len(devs)} devices")
    return StripeMesh(n, devs[:n])


def _backend(backend) -> str:
    if backend is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(backend).type


def pick_schedule(backend=None) -> str:
    """The schedule measured fastest on ``backend`` (a device or its
    type; default the card where there is one).  All three give the
    same bits, so this is purely a performance choice; the JAX package
    picks "pipeline" on the TPU, whose collectives are asynchronous."""
    return FASTEST.get(_backend(backend), "fused")


def pick_overlap(backend=None) -> bool:
    """The boolean view of ``pick_schedule``: True where a split
    (interior/boundary) schedule is picked."""
    return pick_schedule(backend) != "fused"


def _as_schedule(overlap, backend=None) -> str:
    """Normalize the bool knob: True -> "overlap", False -> "fused";
    names pass through; None -> ``pick_schedule(backend)``."""
    if overlap is None:
        return pick_schedule(backend)
    if isinstance(overlap, str):
        if overlap not in SCHEDULES:
            raise ValueError(f"unknown halo schedule: {overlap!r}")
        return overlap
    return "overlap" if overlap else "fused"


def _overlapped_field(arr: np.ndarray, n: int, pad: int) -> torch.Tensor:
    """(NZ, NX) -> (n, NZ, NXl + 2·pad) per-stripe windows with real
    neighbour values in the overlap and zeros outside the domain."""
    nz, nx = arr.shape
    nxl = nx // n
    a = np.pad(np.asarray(arr, np.float32), ((0, 0), (pad, pad)))
    return torch.from_numpy(np.stack(
        [a[:, i * nxl: i * nxl + nxl + 2 * pad] for i in range(n)]))


def effective_block(cfg: FWIConfig, n_stripes: int, k: int) -> int:
    """Clamp k so the overlap windows fit inside one stripe: the two
    2·k·HALO-column boundary source regions must be disjoint, i.e.
    2·k·HALO ≤ NX/stripes."""
    nxl = cfg.nx // n_stripes
    return max(1, min(k, nxl // (2 * HALO)))


def halo_bytes_per_step(cfg: FWIConfig, n_stripes: int, k: int = 1) -> int:
    """Per-seam traffic amortized per timestep (the paper's 21 KB
    message-size analogue), after the effective-block clamp."""
    return int(halo_exchange_plan(cfg, n_stripes, k)["bytes_per_step"])


def halo_exchange_plan(cfg: FWIConfig, n_stripes: int, k: int = 1) -> dict:
    """Seam traffic and overlap shape of one k-step block, for the burst
    planner (``OverheadModel.with_overlapped_seam``) and the seam probe.
    ``overlap_fraction`` is the share of a block's column work that does
    not depend on the exchange (the interior window); ``redundant_frac``
    the boundary windows' extra columns over the stripe width.  The same
    keys and numbers as the JAX package's plan."""
    k = effective_block(cfg, n_stripes, k)
    pad = k * HALO
    nxl = cfg.nx // n_stripes
    fields = 1 if k == 1 else 2
    per_exchange = 2 * fields * pad * cfg.nz * cfg.n_shots * 4
    interior_cols = nxl
    boundary_cols = 2 * 3 * pad
    return {
        "k": k,
        "steps_per_exchange": k,
        "ppermutes_per_exchange": 2,
        "ppermutes_per_step": 2.0 / k,
        "bytes_per_exchange": per_exchange,
        "bytes_per_step": per_exchange / k,
        "interior_cols": interior_cols,
        "boundary_cols": boundary_cols,
        "overlap_fraction": interior_cols / (interior_cols + boundary_cols),
        "redundant_frac": 4.0 * pad / nxl,
    }


# --- the exchange ----------------------------------------------------
#
# An exchange moves, for every stripe this process holds, its right
# edge to its right neighbour's left halo and its left edge to its left
# neighbour's right halo.  ``send_r[j]``/``send_l[j]`` are the j-th
# local stripe's edge payloads (``fields`` tensors of (S, NZ, pad));
# ``recv_l[j]``/``recv_r[j]`` the two tensors each halo lands in (p and
# p_prev).  Halos past the sent fields, and at the domain's edges, are
# zeroed.  ``start`` returns a handle; ``wait`` completes it.


class _LocalExchange:
    """All stripes in this process: one copy per field and direction.
    ``side`` runs the copies on a side CUDA stream (all stripes on one
    card), ordered against the current stream by events."""

    def __init__(self, mesh: StripeMesh, side: bool):
        dev = mesh.devices[0]
        one_card = dev.type == "cuda" and len(set(mesh.devices)) == 1
        self.n = mesh.n
        self.stream = torch.cuda.Stream(dev) if side and one_card else None

    def start(self, send_r, send_l, recv_l, recv_r, fields: int):
        ctx = contextlib.nullcontext()
        if self.stream is not None:
            self.stream.wait_stream(
                torch.cuda.current_stream(self.stream.device))
            ctx = torch.cuda.stream(self.stream)
        n = self.n
        with ctx:
            for j in range(n):
                for f in range(2):
                    for dst, src in ((recv_l[j][f], j - 1),
                                     (recv_r[j][f], j + 1)):
                        if f < fields and 0 <= src < n:
                            payload = send_r[src] if src < j else send_l[src]
                            dst.copy_(payload[f])
                        else:
                            dst.zero_()
        if self.stream is None:
            return None
        for lists in (send_r, send_l, recv_l, recv_r):
            for group in lists:
                for t in group:
                    t.record_stream(self.stream)
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def wait(self, handle) -> None:
        if handle is not None:
            torch.cuda.current_stream(self.stream.device).wait_event(handle)


class _GroupExchange:
    """One stripe per rank: each direction is ONE packed message (the
    fields stacked), both directions in one ``batch_isend_irecv``."""

    def __init__(self, mesh: StripeMesh):
        self.group = mesh.group
        self.rank = dist.get_rank(mesh.group)
        self.n = mesh.n

    def _peer(self, r: int) -> int:
        return dist.get_global_rank(self.group, r)

    def start(self, send_r, send_l, recv_l, recv_r, fields: int):
        ops, bufs = [], []
        for recv, peer in ((recv_l[0], self.rank - 1),
                           (recv_r[0], self.rank + 1)):
            if not 0 <= peer < self.n:
                bufs.append((None, recv))
                continue
            buf = torch.empty((fields,) + tuple(recv[0].shape),
                              dtype=recv[0].dtype, device=recv[0].device)
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(peer),
                                  self.group))
            bufs.append((buf, recv))
        for payload, peer in ((send_r[0], self.rank + 1),
                              (send_l[0], self.rank - 1)):
            if 0 <= peer < self.n:
                msg = torch.stack(list(payload[:fields])).contiguous()
                ops.append(dist.P2POp(dist.isend, msg, self._peer(peer),
                                      self.group))
        reqs = dist.batch_isend_irecv(ops) if ops else []
        return reqs, bufs, fields

    def wait(self, handle) -> None:
        reqs, bufs, fields = handle
        for r in reqs:
            r.wait()
        for buf, recv in bufs:
            for f in range(2):
                if buf is not None and f < fields:
                    recv[f].copy_(buf[f])
                else:
                    recv[f].zero_()


def make_exchange(mesh: StripeMesh, side: bool = False):
    """The exchange of ``mesh``'s form; ``side`` puts an in-process
    exchange on a side CUDA stream where all stripes share one card."""
    if mesh.group is None:
        return _LocalExchange(mesh, side)
    return _GroupExchange(mesh)


# --- the windows -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Window:
    """One k-step window of one stripe: its contiguous model fields,
    its per-shot amplitude table (zero where the window does not cover
    a shot) and its clipped local source columns."""

    v2dt2: torch.Tensor      # (NZ, W)
    sponge: torch.Tensor     # (NZ, W)
    amps: torch.Tensor       # (S, T + k): amplitude of step t at [:, t]
    src_z: torch.Tensor      # (S,) int32
    src_x: torch.Tensor      # (S,) int32, clipped to [0, W)


def _window(v2e, spe, amps, src_z, src_x, x0, wx0, lo, hi, dev):
    """The window over extended-stripe columns [lo, hi) (local column
    ``wx0`` at its column 0) of the stripe whose column 0 is global
    ``x0``."""
    w = hi - lo
    xloc = src_x - x0 - wx0
    covered = (xloc >= 0) & (xloc < w)
    table = torch.where(covered[:, None], amps[None, :],
                        torch.zeros((), dtype=amps.dtype))
    return _Window(
        v2dt2=v2e[:, lo:hi].contiguous().to(dev),
        sponge=spe[:, lo:hi].contiguous().to(dev),
        amps=table.contiguous().to(dev),
        src_z=src_z.to(dev),
        src_x=xloc.clamp(0, w - 1).to(torch.int32).contiguous().to(dev),
    )


class _Parts:
    """The k-step block of one (cfg, mesh, k, tile, schedule): the
    windows of every local stripe, built once as contiguous tensors, the
    exchange, and the block bodies."""

    def __init__(self, cfg: FWIConfig, mesh: StripeMesh, k: int, tile,
                 schedule: str):
        n = mesh.n
        if cfg.nx % n:
            raise ValueError(f"nx={cfg.nx} does not split into {n} "
                             f"equal stripes")
        self.cfg, self.mesh, self.tile = cfg, mesh, tile
        self.schedule = schedule
        self.k = k = effective_block(cfg, n, k)
        self.pad = pad = k * HALO
        self.nxl = nxl = cfg.nx // n
        self.fields = 1 if k == 1 else 2
        mf = model_fields(cfg, torch.device("cpu"))
        v2e = _overlapped_field(mf.v2dt2.numpy(), n, pad)
        spe = _overlapped_field(mf.sponge.numpy(), n, pad)
        t_ext = np.clip(np.arange(cfg.timesteps + k), 0, cfg.timesteps - 1)
        amps = mf.amps[torch.from_numpy(t_ext)]
        wins = {"fused": (-pad, 0, nxl + 2 * pad)} if schedule == "fused" \
            else {"interior": (0, pad, pad + nxl),
                  "left": (-pad, 0, 3 * pad),
                  "right": (nxl - 2 * pad, nxl - pad, nxl + 2 * pad)}
        self.windows = []
        for j, g in enumerate(mesh.stripes):
            dev = mesh.devices[j]
            self.windows.append({
                name: _window(v2e[g], spe[g], amps, mf.src_z,
                              mf.src_x, g * nxl, wx0, lo, hi, dev)
                for name, (wx0, lo, hi) in wins.items()})
        self.exchange = make_exchange(mesh, side=schedule != "fused")
        #: wave_block launches of one block, over the local stripes
        self.launches_per_block = len(mesh.stripes) * len(wins)

    # -- layout: "fused" keeps each stripe extended by its halos ------

    def place(self, field: torch.Tensor) -> list[torch.Tensor]:
        """A whole (S, NZ, NX) field -> this process's stripes, each on
        its device, in the schedule's layout."""
        nxl, pad = self.nxl, self.pad
        out = []
        for j, g in enumerate(self.mesh.stripes):
            dev = self.mesh.devices[j]
            part = field[..., g * nxl: (g + 1) * nxl].to(
                device=dev, dtype=torch.float32)
            if self.schedule == "fused":
                ext = torch.zeros(part.shape[:-1] + (nxl + 2 * pad,),
                                  dtype=torch.float32, device=dev)
                ext[..., pad: pad + nxl] = part
                part = ext
            out.append(part.contiguous())
        return out

    def own(self, part: torch.Tensor) -> torch.Tensor:
        """The stripe's own columns of a part (a view)."""
        if self.schedule == "fused":
            return part[..., self.pad: self.pad + self.nxl]
        return part

    def gather(self, parts) -> torch.Tensor:
        """The whole (S, NZ, NX) field from the stripes' parts."""
        return self.cat([self.own(p) for p in parts])

    def cat(self, mine) -> torch.Tensor:
        """The local stripes' own columns side by side, with the other
        ranks' over a group (``all_gather``: every rank gets the whole),
        on the first local stripe's device."""
        if self.mesh.group is None:
            dev = mine[0].device
            return torch.cat([m.to(dev) for m in mine], dim=-1)
        m = mine[0].contiguous()
        got = [torch.empty_like(m) for _ in range(self.mesh.n)]
        dist.all_gather(got, m, group=self.mesh.group)
        return torch.cat(got, dim=-1)

    # -- the k steps of one window ------------------------------------

    def _run(self, w: _Window, p, pp, t0: int):
        kk = self.k
        if t0 + kk <= w.amps.shape[1]:
            sv = w.amps[:, t0: t0 + kk]
        else:
            idx = np.clip(np.arange(t0, t0 + kk), 0, self.cfg.timesteps - 1)
            # lint: disable=host-sync -- only a block that runs past the
            # last timestep takes this branch: k indices, once a run
            sv = w.amps[:, torch.from_numpy(idx).to(w.amps.device)]
        return wave_block(p, pp, w.v2dt2, w.sponge, sv, w.src_z, w.src_x,
                          receiver_row=self.cfg.receiver_depth,
                          tile=self.tile)

    def _empty_halos(self, ps):
        """Boundary-window inputs (S, NZ, 3·pad), one for each side,
        field and stripe, not yet filled."""
        return [[[torch.empty(p.shape[:-1] + (3 * self.pad,),
                              dtype=p.dtype, device=p.device)
                  for _ in range(2)] for _ in range(2)] for p in ps]

    def _start(self, send_r, send_l, bufs):
        """Exchange into the halo columns of the boundary inputs
        ``bufs[j] = [[left p, left pp], [right p, right pp]]``."""
        pad = self.pad
        recv_l = [[b[0][f][..., :pad] for f in range(2)] for b in bufs]
        recv_r = [[b[1][f][..., 2 * pad:] for f in range(2)] for b in bufs]
        return self.exchange.start(send_r, send_l, recv_l, recv_r,
                                   self.fields)

    def _fill_own(self, bufs, ps, pps):
        """The stripe's own 2·pad edge columns into the boundary
        inputs."""
        pad = self.pad
        for b, p, pp in zip(bufs, ps, pps):
            for f, src in enumerate((p, pp)):
                b[0][f][..., pad:].copy_(src[..., : 2 * pad])
                b[1][f][..., : 2 * pad].copy_(src[..., -2 * pad:])

    def _stitch(self, mid, left, right, traces: bool):
        """Boundary windows' valid columns into the interior's output,
        in place: [0, pad) from the left, [nxl-pad, nxl) from the
        right."""
        pad, nxl = self.pad, self.nxl
        for i in range(3 if traces else 2):
            mid[i][..., :pad].copy_(left[i][..., pad: 2 * pad])
            mid[i][..., nxl - pad:].copy_(right[i][..., pad: 2 * pad])
        return mid

    # -- one block of each schedule -----------------------------------

    def fused_block(self, ps, pps, t0: int, traces: bool):
        pad, nxl = self.pad, self.nxl
        send_r = [(p[..., nxl: nxl + pad], pp[..., nxl: nxl + pad])
                  for p, pp in zip(ps, pps)]
        send_l = [(p[..., pad: 2 * pad], pp[..., pad: 2 * pad])
                  for p, pp in zip(ps, pps)]
        recv_l = [(p[..., :pad], pp[..., :pad]) for p, pp in zip(ps, pps)]
        recv_r = [(p[..., nxl + pad:], pp[..., nxl + pad:])
                  for p, pp in zip(ps, pps)]
        self.exchange.wait(self.exchange.start(send_r, send_l, recv_l,
                                               recv_r, self.fields))
        outs = [self._run(w["fused"], p, pp, t0)
                for w, p, pp in zip(self.windows, ps, pps)]
        tr = [o[2][..., pad: pad + nxl] for o in outs] if traces else None
        return [o[0] for o in outs], [o[1] for o in outs], tr

    def overlap_block(self, ps, pps, t0: int, traces: bool):
        # 1) the exchange, issued first (the pipeline's prologue)
        bufs, h = self.prologue(ps, pps)
        # 2) the interiors, which never read a halo, while it flies
        mids = [list(self._run(w["interior"], p, pp, t0))
                for w, p, pp in zip(self.windows, ps, pps)]
        self._fill_own(bufs, ps, pps)
        self.exchange.wait(h)
        # 3) the boundary windows consume the halos; 4) stitch
        for j, (w, b) in enumerate(zip(self.windows, bufs)):
            left = self._run(w["left"], b[0][0], b[0][1], t0)
            right = self._run(w["right"], b[1][0], b[1][1], t0)
            self._stitch(mids[j], left, right, traces)
        return ([m[0] for m in mids], [m[1] for m in mids],
                [m[2] for m in mids] if traces else None)

    def prologue(self, ps, pps):
        """The pipeline's first exchange: block 0's halos, from the
        stripes' edges; returns the carry (boundary inputs, handle)."""
        pad = self.pad
        bufs = self._empty_halos(ps)
        h = self._start([(p[..., -pad:], pp[..., -pad:])
                         for p, pp in zip(ps, pps)],
                        [(p[..., :pad], pp[..., :pad])
                         for p, pp in zip(ps, pps)], bufs)
        return bufs, h

    def pipeline_block(self, ps, pps, t0: int, traces: bool, carry):
        pad = self.pad
        bufs, h = carry
        self._fill_own(bufs, ps, pps)
        self.exchange.wait(h)
        # 1) the boundary windows first: their valid columns are the
        # stripe's fresh edges after this block
        bnd = [(self._run(w["left"], b[0][0], b[0][1], t0),
                self._run(w["right"], b[1][0], b[1][1], t0))
               for w, b in zip(self.windows, bufs)]
        # 2) block b+1's exchange from those edges, before the interior
        nbufs = self._empty_halos(ps)
        nh = self._start(
            [(r[0][..., pad: 2 * pad], r[1][..., pad: 2 * pad])
             for _, r in bnd],
            [(lf[0][..., pad: 2 * pad], lf[1][..., pad: 2 * pad])
             for lf, _ in bnd], nbufs)
        # 3) the interiors while it flies; 4) stitch
        mids = [list(self._run(w["interior"], p, pp, t0))
                for w, p, pp in zip(self.windows, ps, pps)]
        for m, (lf, r) in zip(mids, bnd):
            self._stitch(m, lf, r, traces)
        return ([m[0] for m in mids], [m[1] for m in mids],
                [m[2] for m in mids] if traces else None, (nbufs, nh))

    def block(self, ps, pps, t0: int, traces: bool):
        """One k-step block of the "fused" or "overlap" schedule."""
        if self.schedule == "fused":
            return self.fused_block(ps, pps, t0, traces)
        return self.overlap_block(ps, pps, t0, traces)


@functools.lru_cache(maxsize=32)
def _sharded_block_parts(cfg: FWIConfig, mesh: StripeMesh, k: int,
                         tile=None, schedule: str = "overlap") -> _Parts:
    """The windows and block bodies of one (cfg, mesh, k, tile,
    schedule), memoized so a session rebuilt for an equal mesh reuses
    its model-field windows."""
    return _Parts(cfg, mesh, k, tile, schedule)


def _attach(fn, parts: _Parts):
    fn.k = parts.k
    fn.gather = parts.gather
    fn.schedule = parts.schedule
    fn.launches_per_block = parts.launches_per_block
    return fn


def _placer(parts: _Parts):
    def place(state_fields):
        """A whole field, or a tuple of them, -> the stripes' parts."""
        if isinstance(state_fields, torch.Tensor):
            return parts.place(state_fields)
        return tuple(parts.place(f) for f in state_fields)

    return place


@functools.lru_cache(maxsize=32)
def make_sharded_multistep(cfg: FWIConfig, mesh: StripeMesh, *, k: int = 1,
                           tile=None, overlap: bool | str | None = None):
    """Temporally-blocked striped propagator.

    Returns (block_step, place): ``block_step(p, p_prev, t0)`` advances
    all k timesteps with one exchange and returns (p, p_prev, traces)
    with p, p_prev the stripes' parts and traces the whole (S, k, NX).
    ``overlap`` takes the bool (True="overlap") or a schedule name;
    None picks by device (``pick_schedule``).  A single block carries no
    halos to a next one, so "pipeline" runs as "overlap".  k may be
    clamped to the stripe width (``effective_block``): callers advancing
    t0 use ``block_step.k``; ``block_step.gather`` gives back a whole
    field."""
    schedule = _as_schedule(overlap, mesh.devices[0])
    if schedule == "pipeline":
        schedule = "overlap"
    parts = _sharded_block_parts(cfg, mesh, k, tile, schedule)

    def block_step(p, p_prev, t0: int):
        ps, pps, tr = parts.block(list(p), list(p_prev), int(t0), True)
        return ps, pps, parts.cat(tr)

    return _attach(block_step, parts), _placer(parts)


@functools.lru_cache(maxsize=32)
def make_sharded_step(cfg: FWIConfig, mesh: StripeMesh, *, tile=None):
    """Single-timestep striped propagator (the k=1 block):
    step(p, p_prev, t) -> (p, p_prev, trace (S, NX))."""
    block_step, place = make_sharded_multistep(cfg, mesh, k=1, tile=tile)

    def step(p, p_prev, t: int):
        pn, pp, tr = block_step(p, p_prev, t)
        return pn, pp, tr[:, 0]

    step.gather = block_step.gather
    return step, place


@functools.lru_cache(maxsize=32)
def make_sharded_scan_runner(cfg: FWIConfig, mesh: StripeMesh, *,
                             k: int = 4, tile=None,
                             overlap: bool | str | None = None,
                             collect_traces: bool = True):
    """Blocked, striped runner: run(p, p_prev, t0, blocks) advances
    blocks·k timesteps, one exchange a block, and returns (p, p_prev,
    traces (S, blocks·k, NX)), or (p, p_prev) without traces; p and
    p_prev are the stripes' parts (``place``; ``run.gather`` gives back
    a whole field).  Under "pipeline" the halos ride in the loop's
    carry: a prologue exchange primes block 0, each block issues block
    b+1's exchange before its interior, and the last one is discarded.
    Returns (run, place, k), k the effective block length."""
    schedule = _as_schedule(overlap, mesh.devices[0])
    parts = _sharded_block_parts(cfg, mesh, k, tile, schedule)
    kk = parts.k

    def run(p, p_prev, t0: int, blocks: int):
        ps, pps = list(p), list(p_prev)
        trs = [[] for _ in ps]
        carry = parts.prologue(ps, pps) if schedule == "pipeline" else None
        for b in range(blocks):
            t = int(t0) + b * kk
            if carry is None:
                ps, pps, tr = parts.block(ps, pps, t, collect_traces)
            else:
                ps, pps, tr, carry = parts.pipeline_block(
                    ps, pps, t, collect_traces, carry)
            if collect_traces:
                for acc, x in zip(trs, tr):
                    acc.append(x)
        if carry is not None:
            parts.exchange.wait(carry[1])      # the discarded epilogue
        if not collect_traces:
            return ps, pps
        if blocks == 0:
            return ps, pps, torch.zeros(
                (ps[0].shape[0], 0, cfg.nx), device=ps[0].device)
        return ps, pps, parts.cat([torch.cat(acc, dim=1) for acc in trs])

    return _attach(run, parts), _placer(parts), kk
