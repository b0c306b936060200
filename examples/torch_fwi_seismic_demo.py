"""FWI seismic forward modeling with self-adaptive bursting on the
PyTorch port — the paper's own application end to end on the port's
solver (paper-scale 600x600 grid, 4 shots, reduced timestep count for
the demo), its step time measured on the card.

    PYTHONPATH=src python examples/torch_fwi_seismic_demo.py
    PYTHONPATH=src python examples/torch_fwi_seismic_demo.py --device cpu

Without ``--device cpu`` it runs on the CUDA card and raises where there
is none.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    BurstPlanner,
    DeadlinePredictor,
    ElasticOrchestrator,
    OverheadModel,
    PodSpec,
    Resources,
)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.fwi.calibrate import fit_capacity_models  # noqa: E402
from repro_torch.fwi.driver import TimeModel, fwi_session_factory  # noqa: E402,E501
from repro_torch.fwi.solver import FWIConfig, run_forward  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=600,
                    help="grid side of the forward run")
    ap.add_argument("--cal-nz", type=int, default=128,
                    help="rows of the calibration grid (twice as many "
                         "columns)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}")

    # 1) plain forward modeling: propagate + record receiver traces
    cfg = FWIConfig(nz=args.size, nx=args.size, timesteps=120, n_shots=4)
    st, traces = run_forward(cfg, steps=120, device=dev)
    print(f"wavefield max |p| = {float(st.p.abs().max()):.3e}, "
          f"traces {tuple(traces.shape)}, "
          f"energy {float((traces ** 2).sum()):.3e}")

    # 2) calibration (paper §3.2): fit eqs. 6-8 from measured step times
    cal_cfg = FWIConfig(nz=args.cal_nz, nx=2 * args.cal_nz, timesteps=60,
                        n_shots=1, sponge_width=16)
    cluster, cloud, samples = fit_capacity_models(
        cal_cfg, cloud_slowdown=1.4, device=dev,
    )
    print(f"fitted: L_cluster(c) = -{cluster.A:.3g} ln c + {cluster.B:.3g}"
          f" | L_cloud(c) = -{cloud.A:.3g} ln c + {cloud.B:.3g}"
          f" (t1 = {samples['t1_measured'] * 1e3:.4f} ms a step on {dev})")

    # 3) self-adaptive run: congestion at step 30, deadline at 1.35x ideal
    work = samples["t1_measured"]
    tm = TimeModel(chip_seconds_per_step=work, congestion_from=30,
                   congestion_factor=2.0, jitter=0.01)
    deadline = work / 64 * 180 * 1.35
    planner = BurstPlanner(
        cluster_model=cluster, cloud_model=cloud, chips_cluster=64,
        legal_slices=[8, 16, 32, 64, 128],
        overheads=OverheadModel(ckpt_s=work / 64 * 2,
                                provision_s=work / 64 * 6,
                                restart_s=work / 64 * 2),
    )
    orch = ElasticOrchestrator(
        planner=planner, predictor=DeadlinePredictor(deadline),
        check_every=6, ckpt_every=40,
    )
    rec = orch.run(
        session_factory=fwi_session_factory(cal_cfg, tm, device=dev),
        initial=Resources(pods=[PodSpec(chips=64, name="cluster")],
                          shares=[1.0]),
        steps_total=180,
    )
    print(f"adaptive FWI: elapsed {rec.elapsed_s:.4g}s vs deadline "
          f"{deadline:.4g}s -> met={rec.met_deadline}")
    for e in rec.events:
        if e.kind == "burst":
            print(f"  burst at step {e.step}: +{e.detail['chips']} chips, "
                  f"shares={['%.2f' % s for s in e.detail['shares']]}")
    assert rec.completed, "the adaptive run did not complete"
    print("torch_fwi_seismic_demo OK")


if __name__ == "__main__":
    main()
