"""Elastic LM training with a real mid-run burst on the PyTorch port
(the paper's Fig. 1 end to end): the JAX package's
``examples/elastic_burst_demo.py``.

A granite-family model trains on a "cluster" world of 4 ranks, (2, 2)
("data", "model"); at step 40 an injected congestion (a time stretch)
slows it down; the monitor sees the regime change, the planner solves
eqs. 1-3 for the burst size, and the orchestrator checkpoints, closes
the world, starts one of 8 ranks as (2, 2, 2) ("pod", "data", "model"),
restores the checkpoint onto its placements and resumes: the same
training run, now spanning both "environments".

    PYTHONPATH=src python examples/torch_elastic_burst_demo.py --device cpu
    PYTHONPATH=src python examples/torch_elastic_burst_demo.py \\
        --meshes 1x1,1x1x1

Without ``--device cpu`` the ranks run on CUDA cards, one a rank, and
the default meshes need 4 and then 8 of them; a machine with one card
runs ``--meshes 1x1,1x1x1``.  On the card the model's head dim is
widened from the smoke config's 16 to 32, the narrowest the
flash-attention kernel takes; the events do not depend on it.
"""
import argparse
import dataclasses
import math
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import RunConfig, get_config, smoke_config  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BurstPlanner,
    DeadlinePredictor,
    ElasticOrchestrator,
    LogCapacityModel,
    OverheadModel,
    PodSpec,
    Resources,
)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import elastic  # noqa: E402
from repro_torch.launch.world import World  # noqa: E402

CFG = smoke_config(get_config("granite-8b"))
RUN = RunConfig(loss_chunk=32)
SHAPE = ShapeConfig("demo", "train", 64, 8)
LR = 1e-3                 # AdamW at a constant rate

STEPS = 120
CONGESTION_FROM = 40
CONGESTION = 2.5          # injected slowdown of the "cluster"
WORK_CHIP_S = 4.0         # chip-seconds per step (modelled platform)
#: the worlds' meshes, one pod and two
MESHES = "2x2,2x2x2"
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
#: the narrowest head dim the flash-attention kernel takes on the card
CARD_HEAD_DIM = 32

# What is REAL here: the training math, the mid-run checkpoint, the
# world's restart (2,2) -> (2,2,2) and the reshard-on-restore.  What is
# MODELLED: step wall time, which follows the platform model
# W·share/(chips/slowdown), exactly like the FWI driver (DESIGN.md §10).


def modeled_step_s(res: Resources, step: int,
                   congestion_from=CONGESTION_FROM) -> float:
    """The platform-modelled seconds of ``step`` on ``res``: each pod's
    share of the work over its chips, stretched by its slowdown and, on
    the cluster from ``congestion_from``, by the congestion; per-step
    sync, so the slowest pod wins."""
    times = []
    for pod, share in zip(res.pods, res.shares):
        if share <= 0:
            continue
        t = WORK_CHIP_S * share / pod.chips * pod.slowdown
        if pod.name == "cluster" and step >= congestion_from:
            t *= CONGESTION
        times.append(t)
    return max(times)


def parse_meshes(text: str) -> list[tuple[int, ...]]:
    """``"2x2,2x2x2"`` -> [(2, 2), (2, 2, 2)]: the one-pod world's mesh
    ("data", "model") and the two-pod world's ("pod", "data", "model")."""
    meshes = [tuple(int(x) for x in m.split("x")) for m in text.split(",")]
    if len(meshes) != 2 or len(meshes[0]) != 2 or len(meshes[1]) != 3:
        raise ValueError(f"--meshes wants DxM,PxDxM, got {text!r}")
    return meshes


def spec_for(device) -> elastic.TrainSpec:
    cfg = CFG
    if device.type == "cuda":
        cfg = dataclasses.replace(cfg, head_dim=CARD_HEAD_DIM).validate()
    return elastic.TrainSpec(cfg, RUN, SHAPE, LR)


class LMSession:
    """Real training over the current Resources, on a world of ranks."""

    def __init__(self, res: Resources, start_step: int, restored, *,
                 device, meshes, spec, ckpt_dir,
                 congestion_from=CONGESTION_FROM):
        self.res = res
        self.congestion_from = congestion_from
        self.ckpt_dir = ckpt_dir
        mesh = meshes[min(len(res.pods), 2) - 1]
        self.world = World(mesh, AXES[len(mesh)], device)
        try:
            self.world.call(elastic.setup, spec)
            if restored is None:
                self.world.call(elastic.init, 0)
            else:
                directory, step = restored
                got = self.world.call(elastic.restore, directory, step)
                assert got["data_step"] == step == start_step, got
        except BaseException:
            self.world.close()
            raise
        self.mesh_desc = dict(zip(AXES[len(mesh)], mesh))
        self.last_loss = None

    def run_step(self, step: int) -> float:
        self.last_loss = self.world.call(elastic.step, step)["loss"]
        return modeled_step_s(self.res, step, self.congestion_from)

    def checkpoint(self, step: int):
        self.world.call(elastic.save, self.ckpt_dir, step)
        return (self.ckpt_dir, step)

    def close(self):
        self.world.close()


class ClockSession:
    """A session of the modelled clock alone, with no world: the
    orchestrator's events depend on nothing else, so they are the demo's
    on any device."""

    def __init__(self, res: Resources, congestion_from=CONGESTION_FROM):
        self.res = res
        self.congestion_from = congestion_from

    def run_step(self, step: int) -> float:
        return modeled_step_s(self.res, step, self.congestion_from)

    def checkpoint(self, step: int):
        return step


def clock_record(steps=STEPS, congestion_from=CONGESTION_FROM):
    """The ``RunRecord`` of the demo's orchestration on the modelled
    clock alone (``ClockSession``)."""
    orch, _, _ = make_orchestrator(steps)
    return orch.run(
        session_factory=lambda res, start, restored: ClockSession(
            res, congestion_from),
        initial=Resources(pods=[PodSpec(4, name="cluster")], shares=[1.0]),
        steps_total=steps)


def make_orchestrator(steps=STEPS):
    """The demo's planner and orchestrator: capacity fits of the
    modelled platform, the deadline, the overheads in step times."""
    work = WORK_CHIP_S
    t_step = work / 4
    chips = [1, 2, 4, 8]
    cluster = LogCapacityModel.fit(chips, [work / c for c in chips])
    cloud = LogCapacityModel.fit(chips, [1.25 * work / c for c in chips])
    deadline = t_step * steps * 1.6
    planner = BurstPlanner(
        cluster_model=cluster, cloud_model=cloud, chips_cluster=4,
        legal_slices=[1, 2, 4],
        overheads=OverheadModel(ckpt_s=t_step, provision_s=4 * t_step,
                                restart_s=4 * t_step),
    )
    orch = ElasticOrchestrator(
        planner=planner, predictor=DeadlinePredictor(deadline),
        check_every=6, ckpt_every=30, max_bursts=1,
    )
    return orch, t_step, deadline


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--meshes", default=MESHES,
                    help="the one-pod and two-pod worlds' meshes, DxM,PxDxM "
                         "(one card: 1x1,1x1x1)")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="a cut of the run (the JAX demo's: 120)")
    ap.add_argument("--congestion-from", type=int, default=CONGESTION_FROM,
                    help="the step the congestion starts at (JAX's: 40)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    meshes = parse_meshes(args.meshes)
    if dev.type == "cuda":
        need = max(math.prod(m) for m in meshes)
        if need > torch.cuda.device_count():
            raise RuntimeError(
                f"--meshes {args.meshes} needs {need} CUDA cards, this "
                f"machine has {torch.cuda.device_count()}; one card runs "
                f"--meshes 1x1,1x1x1")
    spec = spec_for(dev)
    print(f"worlds: {meshes[0]} then {meshes[1]} on {dev.type}")
    orch, t_step, deadline = make_orchestrator(args.steps)
    print(f"modeled step {t_step * 1000:.0f} ms on 4 chips -> deadline "
          f"{deadline:.1f}s for {args.steps} steps")

    current: list[LMSession] = []
    with tempfile.TemporaryDirectory() as ckpt_dir:

        def factory(res, start_step, restored):
            # the previous world holds processes (and, on a card, its
            # memory): close it before the next one starts
            while current:
                current.pop().close()
            sess = LMSession(res, start_step, restored, device=dev,
                             meshes=meshes, spec=spec, ckpt_dir=ckpt_dir,
                             congestion_from=args.congestion_from)
            current.append(sess)
            print(f"  [session] pods={[p.chips for p in res.pods]} "
                  f"mesh={sess.mesh_desc} from step {start_step}")
            return sess

        try:
            rec = orch.run(
                session_factory=factory,
                initial=Resources(pods=[PodSpec(4, name="cluster")],
                                  shares=[1.0]),
                steps_total=args.steps,
            )
            last_loss = current[-1].last_loss
        finally:
            while current:
                current.pop().close()
    print(f"elapsed {rec.elapsed_s:.1f}s vs deadline {deadline:.1f}s "
          f"-> met={rec.met_deadline}")
    for e in rec.events:
        if e.kind != "ckpt":
            print(f"  step {e.step}: {e.kind} {e.detail}")
    print(f"final loss {last_loss:.4f}")
    assert rec.met_deadline, "demo expects the burst to rescue the deadline"
    print("elastic_burst_demo OK")
    return rec


if __name__ == "__main__":
    main()
