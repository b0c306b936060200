"""End-to-end training driver over the host mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --smoke --steps 50 --deadline 120 --device cpu

The JAX package's ``launch/train.py`` for any architecture the port
serves: config -> model -> sharded train step -> synthetic pipeline ->
optimizer, with step-time monitoring, deadline prediction (the paper's
loop), periodic checkpoints (the state and the pipeline's position) and
auto-resume.  ``--smoke`` shrinks the arch; without it the full config
is used.  ``--device`` defaults to ``cuda`` and raises without a card;
``--device cpu`` runs the plain versions of the kernels.  Weights come
from a seeded ``torch.Generator`` on the device, the same on every
rank.

As in the JAX driver, the step comes from ``build_session`` on
``make_host_mesh()``: the train rules, the state's placements and the
step over DTensors, donating its state as JAX's ``jax.jit(...,
donate_argnums=(0,))`` does (``runtime/train_step.py``): each step
writes the new state into the one it was given, so the card holds one
state and the gradients.  On one card (or one CPU process) the host mesh is
(1, 1) and every placement ``Replicate()``; a one-rank group is started
for it and closed at the end of ``train``.  Under a launcher that
started a bigger group (``launch/world.py::World``), every rank runs
``train`` alike: the checkpoints are gathered on every rank and written
by rank 0 (``CheckpointManager.save``), and a resume restores each leaf
onto the placements (``restore(..., shardings=)``).  Re-sizing mid-run
goes through ``launch/elastic.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import RunConfig, get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import DeadlinePredictor, StepTimeMonitor
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import KERNELS
from repro_torch.models.params import tree_map
from repro_torch.optim import Optimizer, make_optimizer, warmup_cosine
from repro_torch.runtime import train_step as ts
from repro_torch.sharding.rules import distribute_params, make_rules


@dataclasses.dataclass
class TrainResult:
    state: dict                  # {"params", "opt", "step"} after the run,
                                 # gathered whole
    start_step: int              # the step the run started from
    losses: list                 # each step's loss, host floats
    step_s: list                 # each step's seconds (host clock, synced)
    launches: dict               # {kernel: launches over the run's steps}


def _launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def build_session(cfg: ModelConfig, run: RunConfig, mesh, steps_total: int,
                  opt: Optimizer | None = None):
    """``(opt, sch, shardings, step_fn, rules)``: the train rules on
    ``mesh``, the optimizer (``opt``, or by default the run's on the
    warmup-cosine schedule over ``steps_total``), the state's schema and
    placements, and the step over DTensors.  The step donates its state:
    after ``step_fn(state, batch)`` the caller's ``state`` holds the new
    values (clone it first to keep the old ones)."""
    rules = make_rules(mesh, "train")
    if opt is None:
        opt = make_optimizer(run.optimizer or cfg.optimizer,
                             warmup_cosine(total_steps=steps_total))
    sch = ts.state_schema(cfg, run, opt)
    shardings = ts.state_shardings(sch, rules, run)
    step_fn = ts.build_train_step(cfg, run, opt, rules, donate=True)
    return opt, sch, shardings, step_fn, rules


def gathered(state):
    """The state as full tensors (a checkpoint is written whole): a
    collective, so every rank calls it."""
    return tree_map(ts.full_tensor, state)


def train(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig, *,
          steps: int, device, deadline: float | None = None,
          ckpt_dir=None, ckpt_every: int = 25, resume: bool = False,
          log_every: int = 10, seed: int = 0) -> TrainResult:
    """Train ``cfg`` on ``shape``'s synthetic batches up to step
    ``steps``, from step 0 or, with ``resume``, from the newest intact
    checkpoint in ``ckpt_dir``; prints the JAX driver's lines."""
    dev = resolve_device(device)
    own_group = not dist.is_initialized()
    try:
        return _train(cfg, run, shape, steps=steps, dev=dev,
                      deadline=deadline, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, resume=resume,
                      log_every=log_every, seed=seed)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(cfg, run, shape, *, steps, dev, deadline, ckpt_dir, ckpt_every,
           resume, log_every, seed) -> TrainResult:
    mesh = make_host_mesh(device=dev)
    opt, sch, shardings, step_fn, rules = build_session(cfg, run, mesh,
                                                        steps)
    pipeline = SyntheticLMPipeline(cfg, shape, device=dev)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if resume and mgr and mgr.latest_step() is not None:
        state, extra = mgr.restore(sch, shardings=shardings)
        pipeline.restore(extra)
        start_step = int(extra.get("data_step", 0))
        print(f"[train] resumed from step {start_step}")
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = distribute_params(
            ts.new_state(ts.init_state(sch, gen, dev), opt), shardings)

    monitor = StepTimeMonitor()
    predictor = DeadlinePredictor(deadline) if deadline else None
    losses, times = [], []
    c0 = _launches()
    t_start = time.monotonic()
    for step in range(start_step, steps):
        batch = ts.distribute_batch(pipeline.batch_at(step), rules)
        t0 = time.monotonic()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.monotonic() - t0
        losses.append(loss)
        times.append(dt)
        monitor.observe(dt)
        pipeline.state.step = step + 1
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, gathered(state),
                     extra=pipeline.state.to_extra())
        if (step + 1) % log_every == 0 or step == start_step:
            msg = (f"[train] step {step + 1}/{steps} "
                   f"loss={loss:.4f} {dt*1000:.0f}ms")
            if predictor:
                est = predictor.estimate(
                    monitor, step + 1, steps, time.monotonic() - t_start,
                )
                msg += (f" est_total={est.estimated_total_s:.0f}s "
                        f"slack={est.slack_s:+.0f}s"
                        + (" [DEADLINE AT RISK — would burst]"
                           if est.will_miss else ""))
            print(msg, flush=True)
    c1 = _launches()
    if mgr:
        mgr.save(steps, gathered(state), extra=pipeline.state.to_extra(),
                 wait=True)
    print(f"[train] done in {time.monotonic() - t_start:.1f}s")
    return TrainResult(state=gathered(state), start_step=start_step,
                       losses=losses,
                       step_s=times,
                       launches={k: c1[k] - c0[k] for k in c1})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--deadline", type=float, default=None,
                    help="seconds; enables the monitoring/prediction loop")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    run = RunConfig(microbatch=args.microbatch,
                    loss_chunk=min(512, args.seq))
    return train(cfg, run, shape, steps=args.steps, device=args.device,
                 deadline=args.deadline, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, resume=args.resume,
                 log_every=args.log_every)


if __name__ == "__main__":
    main()
