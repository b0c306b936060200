#!/usr/bin/env bash
# Lint + tier-1 verification + engine/fleet smokes for the PyTorch port
# (src/repro_torch), in scripts/ci.sh's order.  Runs on the CPU: every
# entry point defaults to the card, so each stage names device="cpu".
#
# 1. lint (FIRST): python -m repro_torch.analysis --ci — the port's five
#    rules (smem-budget, async-pairing, host-sync, sim-determinism,
#    design-citations); the tree must lint clean, the JSON report must
#    carry the five rules, and the stage must finish in under 10 s.
# 2. the port's tier-1 tests: tests/test_torch_*.py, -x -q (xdist's -n
#    where it is installed).
# 3. fused-engine smoke: the k=4 striped block on one stripe and the
#    k=4 block runner must equal eight single steps bitwise, traces
#    included, on a tiny config (the contract the port's tests pin).
# 4. fleet smoke + fleet-tournament smoke: the policy × scenario sweep
#    and the scheduler × policy-pair grid through repro_torch.sim with
#    the port's own overheads, each claim computed as the benchmark
#    rows of scripts/ci.sh define it: plan beats no-burst on the
#    overload ramp and spends less than always-burst, the cloud is
#    retired after the transient spike, some deadline-aware cell beats
#    FIFO + no-burst at a lower cost than FIFO + always-burst, and every
#    queued job is conserved.
# 5. fault-storm smoke (DESIGN.md §19): the hardened plan loop keeps
#    its hit rate >= the unhardened baseline on the same draws at
#    <= 1.5x a fault-free run's cost, the fault run is deterministic
#    per seed, and preemption admits the expired gold job within one
#    evaluation interval.
# 6. coverage floors: scripts/torch_simcov.py (the JAX package's floors:
#    sim and sim.faults 90 %, kernels.stencil and fwi.solver 85 %,
#    analysis 90 %).
# 7. real-elastic smoke: the react policy drives a small FWI session
#    through the real orchestrator; at least one GROW (re-striping
#    onto 2 stripes) and one RETIRE, and the final field bitwise equal
#    to an unscaled run_forward.
#
# scripts/ci.sh's other stages have no port stage yet:
# - bench-schema and benchmark smokes: they run benchmarks/, the JAX
#   package's harness; they wait for the port's own benchmark harness.
# - big-grid streaming: it drives the Pallas streamed kernel in
#   interpret mode, which has no CPU form in the port (one tiled CUDA
#   kernel serves every size); chip_smoke.py's production phase holds
#   the 4096² kernel bitwise to its plain version on the card.
# - trajectory schema: BENCH_fwi.json is the JAX package's record.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
# the port's tests import jax only to hold the port to the JAX package
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"
WORK="$(mktemp -d)"
trap 'rm -rf "$WORK"' EXIT
CI_T0=$SECONDS

echo "== lint =="
LINT_T0=$SECONDS
python -m repro_torch.analysis --ci --json "$WORK/torch_lint_ci.json"
LINT_ELAPSED=$((SECONDS - LINT_T0))
LINT_JSON="$WORK/torch_lint_ci.json" python - <<'EOF'
import json
import os

doc = json.load(open(os.environ["LINT_JSON"]))
assert doc["version"] == 1, doc
assert doc["count"] == 0 and doc["findings"] == [], doc["findings"]
assert set(doc["rules"]) == {
    "smem-budget", "async-pairing", "host-sync", "sim-determinism",
    "design-citations",
}, doc["rules"]
print("lint json schema OK (5 rules, 0 findings)")
EOF
if [ "$LINT_ELAPSED" -ge 10 ]; then
    echo "lint stage took ${LINT_ELAPSED}s (budget: <10s)" >&2
    exit 1
fi

echo "== tier-1 tests (port) =="
XDIST=()
if python -c "import xdist" 2>/dev/null; then
    XDIST=(-p xdist -n 4 --dist loadfile)
fi
python -m pytest -x -q -p no:cacheprovider "${XDIST[@]}" tests/test_torch_*.py
echo "tier-1 tests (port) OK"

echo "== fused-engine smoke =="
python - <<'EOF'
import torch

from repro_torch.fwi.domain import make_sharded_multistep, stripe_mesh
from repro_torch.fwi.solver import (
    FWIConfig, ShotState, make_block_runner, make_step_fn,
)

cfg = FWIConfig(nz=32, nx=64, timesteps=8, n_shots=1, sponge_width=4)
step = make_step_fn(cfg, device="cpu")
st = ShotState.init(cfg, "cpu")
p, pp = st.p, st.p_prev
traces = []
for t in range(8):
    p, pp, tr = step(p, pp, t)
    traces.append(tr)
ref = (p, pp, torch.stack(traces, dim=1))

blk, place = make_sharded_multistep(cfg, stripe_mesh(1, "cpu"), k=4)
a, b = place((st.p, st.p_prev))
trs = []
for bb in range(2):
    a, b, tr = blk(a, b, bb * blk.k)
    trs.append(tr)
striped = (blk.gather(a), blk.gather(b), torch.cat(trs, dim=1))
block = make_block_runner(cfg, k=4, device="cpu")(st.p, st.p_prev, 0, 8)
for label, got in (("striped-block", striped), ("block-runner", block)):
    assert all(torch.equal(x, y) for x, y in zip(got, ref)), label
    print(f"fused-engine smoke [{label}]: bitwise vs 8 single steps")
assert float(ref[0].abs().max()) > 0
print("fused-engine smoke OK")
EOF

echo "== fleet smoke =="
python - <<'EOF'
from repro_torch.sim import POLICY_FACTORIES, FleetSim
from repro_torch.sim.scenarios import OVERHEADS, default_scenarios

recs = {}
for sc in default_scenarios(0):
    assert sc.overheads == OVERHEADS, sc.name
    for pname, pf in POLICY_FACTORIES.items():
        recs[(sc.name, pname)] = FleetSim(sc, pf, seed=0).run()
for (sc, pol), r in sorted(recs.items()):
    print(f"fleet.{sc}.{pol}: hit={r.hit_rate:.2f} cost={r.cloud_cost:.2f} "
          f"useful={r.useful_frac:.3f} makespan_s={r.makespan_s:.0f}")
plan = recs[("overload_ramp", "plan")]
nb = recs[("overload_ramp", "no-burst")]
ab = recs[("overload_ramp", "always-burst")]
assert plan.hit_rate > nb.hit_rate, \
    "deadline-aware policy must beat no-burst on the overload scenario"
assert plan.cloud_cost < ab.cloud_cost, \
    "deadline-aware policy must undercut always-burst on cloud cost"
spike = recs[("transient_spike", "plan")]
assert spike.cloud_timeline[-1][1] == 0, \
    "cloud pod must be retired once the transient spike clears"
print("fleet smoke OK")
EOF

echo "== fleet-tournament smoke =="
python - <<'EOF'
from repro_torch.sim import POLICY_FACTORIES, FleetSim
from repro_torch.sim.scenarios import OVERHEADS, queued_scenarios

SCHEDULERS = ("fifo", "fill", "best-fit")
PAIRS = (("no-burst", "none"), ("react", "adapt"), ("always-burst", "adapt"))
recs = {}
for sc in queued_scenarios(0):
    assert sc.overheads == OVERHEADS, sc.name
    for sched in SCHEDULERS:
        for pol, fp in PAIRS:
            recs[(sc.name, sched, pol, fp)] = FleetSim(
                sc, POLICY_FACTORIES[pol], seed=0, scheduler=sched,
                fleet_policy=fp).run()
for (sc, sched, pol, fp), r in sorted(recs.items()):
    print(f"fleet_tournament.{sc}.{sched}.{pol}+{fp}: "
          f"hit={r.hit_rate:.2f} cost={r.cloud_cost:.2f} "
          f"fair={r.fairness:.3f} wait_s={r.mean_wait_s:.0f}")
base = recs[("multi_tenant_rush", "fifo", "no-burst", "none")]
ceil = recs[("multi_tenant_rush", "fifo", "always-burst", "adapt")]
wins = [r for (sc, _, pol, _), r in recs.items()
        if sc == "multi_tenant_rush"
        and pol not in ("no-burst", "always-burst")
        and r.hit_rate > base.hit_rate and r.cloud_cost < ceil.cloud_cost]
assert wins, "some deadline-aware (scheduler, policy) cell must beat " \
    "FIFO+no-burst on hit-rate at lower cloud $ than FIFO+always-burst"
assert all(j.state in ("finished", "running", "queued")
           for r in recs.values() for j in r.jobs), \
    "every submitted job must end finished/running/queued in every cell"
print(f"fleet-tournament smoke OK ({len(recs)} cells, {len(wins)} wins)")
EOF

echo "== fault-storm smoke =="
python - <<'EOF'
import dataclasses
import hashlib

from repro_torch.sim import FleetSim, PlanAutoscaler
from repro_torch.sim.scenarios import (
    OVERHEADS, fault_storm, preemption_pressure,
)

def digest(rec):
    return hashlib.sha256(
        repr(dataclasses.asdict(rec)).encode()
    ).hexdigest()

assert fault_storm(0).overheads == OVERHEADS
h = FleetSim(fault_storm(0, hardened=True), PlanAutoscaler, seed=0).run()
again = FleetSim(fault_storm(0, hardened=True), PlanAutoscaler,
                 seed=0).run()
assert digest(h) == digest(again), "fault run not bit-deterministic"
b = FleetSim(fault_storm(0, hardened=False), PlanAutoscaler,
             seed=0).run()
assert all(j.finished for j in h.jobs), "hardened run must finish"
assert h.hit_rate >= b.hit_rate, (h.hit_rate, b.hit_rate)
clean = dataclasses.replace(fault_storm(0, hardened=True),
                            faults=None, retry=None, name="clean")
c = FleetSim(clean, PlanAutoscaler, seed=0).run()
assert h.cloud_cost <= 1.5 * c.cloud_cost, (h.cloud_cost, c.cloud_cost)
sc = preemption_pressure(0)
p = FleetSim(sc, PlanAutoscaler, seed=0).run()
gold = next(j for j in p.jobs if j.name == "gold0")
admit = next(t for t, k, _ in gold.events if k == "admit")
limit = 60.0 + sc.starve_patience_s + sc.eval_interval_s
assert gold.met_deadline and admit <= limit, (admit, limit)
print(f"fault-storm smoke OK: hardened hit={h.hit_rate:.2f} >= "
      f"baseline {b.hit_rate:.2f}, cost {h.cloud_cost:.0f} <= "
      f"1.5x clean {c.cloud_cost:.0f}, preempt admit at {admit:.0f}s")
EOF

echo "== coverage floors =="
python scripts/torch_simcov.py
echo "coverage floors OK"

echo "== real-elastic smoke =="
python - <<'EOF'
import torch

from repro_torch.core import (
    BurstPlanner, DeadlinePredictor, ElasticOrchestrator,
    LogCapacityModel, OverheadModel, PodSpec, Resources, elastic_chips,
)
from repro_torch.fwi.driver import TimeModel, elastic_stripes_for, \
    fwi_session_factory
from repro_torch.fwi.solver import FWIConfig, run_forward
from repro_torch.sim import ReactAutoscaler

cfg = FWIConfig(nz=32, nx=64, timesteps=80, n_shots=1, sponge_width=4)
W, K, LEGAL = 64.0, 1.4, [16, 32, 64]
cs = sorted(set(LEGAL) | {64})
planner = BurstPlanner(
    cluster_model=LogCapacityModel.fit(cs, [W / c for c in cs]),
    cloud_model=LogCapacityModel.fit(cs, [K * W / c for c in cs]),
    chips_cluster=64, legal_slices=LEGAL,
    overheads=OverheadModel(ckpt_s=3.0, provision_s=6.0, restart_s=3.0),
    price_per_chip_hour=3.0,
)
orch = ElasticOrchestrator(
    planner=planner, predictor=DeadlinePredictor(300.0),
    check_every=6, ckpt_every=24, eval_interval_s=6.0, cloud_slowdown=K,
)
base = fwi_session_factory(
    cfg, TimeModel(chip_seconds_per_step=W, jitter=0.01),
    stripes_for=elastic_stripes_for(1, 2),
    exchange_interval=4, scan_block=8, device="cpu",
)
sessions = []

def factory(res, start, restored):
    s = base(res, start, restored)
    sessions.append(s)
    return s

rec = orch.run(
    session_factory=factory,
    initial=Resources(pods=[PodSpec(chips=64, name="cluster")],
                      shares=[1.0]),
    steps_total=80, autoscaler=ReactAutoscaler(slowdown=K),
    deadline_changes=[(15.0, 70.0), (45.0, 300.0)],
)
kinds = [e.detail["kind"] for e in rec.events if e.kind == "scale"]
assert "grow" in kinds and "retire" in kinds, kinds
assert elastic_chips(rec.final_resources) == 0
assert max(s.n_stripes for s in sessions) == 2, "grow must re-stripe"
last = sessions[-1]
assert last.t == 80, last.t
ref, _ = run_forward(cfg, steps=80, k=4, device="cpu")
assert torch.equal(last.p, ref.p) and torch.equal(last.p_prev, ref.p_prev), \
    "wavefield broke across scale events"
print(f"real-elastic smoke OK: scales={kinds}, stripes="
      f"{[s.n_stripes for s in sessions]}, field bitwise vs run_forward")
EOF

echo "torch CI OK ($((SECONDS - CI_T0)) s)"
