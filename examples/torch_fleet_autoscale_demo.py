"""Hybrid-fleet auto-scaling demo on the PyTorch port's fleet layer: the
paper's decision loop at fleet scale.

Two scientific jobs share a 256-chip on-premise site.  Background
tenants ramp demand to 2.5x capacity, so "cluster overloaded" emerges
from contention.  Each autoscaler policy is evaluated every 30 simulated
seconds and may GROW / SHRINK / RETIRE a cloud pod per job; every resize
rides the same CHECKPOINT -> REMESH -> RESHARD -> RESUME path as the
paper's one-shot burst.  The planner's seam term comes from the seam
probe measured on the card (``repro_torch.sim.scenarios.SEAM_PROBE``);
the demo also probes the device it is given and shows that the claims
hold under that live probe too.

    PYTHONPATH=src python examples/torch_fleet_autoscale_demo.py
    PYTHONPATH=src python examples/torch_fleet_autoscale_demo.py --device cpu

Without ``--device cpu`` it probes the CUDA card and raises where there
is none.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.fwi.calibrate import measure_seam_latency  # noqa: E402
from repro_torch.fwi.solver import FWIConfig  # noqa: E402
from repro_torch.sim import POLICY_FACTORIES, FleetSim  # noqa: E402
from repro_torch.sim.scenarios import (  # noqa: E402
    OVERHEADS,
    SEAM_PROBE,
    overheads_from_probe,
    overload_ramp,
    transient_spike,
)


def show(scenario, quiet=False):
    if not quiet:
        print(f"\n=== scenario: {scenario.name} ===")
        print(f"    {scenario.description}")
        print(f"{'policy':14s} {'hit-rate':>8s} {'cloud $':>9s} "
              f"{'useful':>7s} {'makespan':>9s}")
    recs = {}
    for pname, pf in POLICY_FACTORIES.items():
        rec = FleetSim(scenario, pf, seed=0).run()
        recs[pname] = rec
        if not quiet:
            print(f"{pname:14s} {rec.hit_rate:8.2f} {rec.cloud_cost:9.2f} "
                  f"{rec.useful_frac:7.3f} {rec.makespan_s:8.0f}s")
    return recs


def check_claims(ramp, spike):
    plan, nb, ab = ramp["plan"], ramp["no-burst"], ramp["always-burst"]
    assert plan.hit_rate > nb.hit_rate, "plan must rescue the deadline"
    assert plan.cloud_cost < ab.cloud_cost, "plan must undercut always-burst"
    assert spike["plan"].cloud_timeline[-1][1] == 0, \
        "cloud pod must be retired once the spike clears"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--probe-size", type=int, default=600,
                    help="grid side of the live seam probe")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.probe_size
    live = measure_seam_latency(FWIConfig(nz=n, nx=n), n_stripes=2, k=4,
                                device=dev)
    print(f"seam probe: committed ({SEAM_PROBE['backend']}) "
          f"{SEAM_PROBE['ppermute_latency_s'] * 1e6:.1f} us an exchange, "
          f"seam {OVERHEADS.seam_s_per_step() * 1e6:.2f} us a step; "
          f"live on {dev} at {n}^2 "
          f"{live['ppermute_latency_s'] * 1e6:.1f} us, seam "
          f"{overheads_from_probe(live).seam_s_per_step() * 1e6:.2f} us")

    ramp = show(overload_ramp(0))
    # what the deadline-aware policy actually did for job0
    job0 = ramp["plan"].jobs[0]
    print("\njob0 under `plan` (scale/rollback events):")
    for t, kind, detail in job0.events:
        if kind in ("scale", "provision_request", "spot_reclaim"):
            print(f"  t={t:7.1f}s {kind:18s} {detail}")
    spike = show(transient_spike(0))
    check_claims(ramp, spike)

    # the same claims with the planner's seam term from the live probe
    ov = overheads_from_probe(live)
    check_claims(
        show(dataclasses.replace(overload_ramp(0), overheads=ov), True),
        show(dataclasses.replace(transient_spike(0), overheads=ov), True))
    print("\ntorch_fleet_autoscale_demo OK")


if __name__ == "__main__":
    main()
