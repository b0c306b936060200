"""The paper's deadline-aware loop in the port: ``PlanAutoscaler`` drives
the port's FWI session through a mid-run deadline squeeze and its
relaxation, at the size of the JAX package's end-to-end test
(``tests/test_real_elastic.py``: 48 x 96, 120 steps, 1 shot).

The squeeze makes ``plan`` GROW onto a cloud pod, which
``elastic_stripes_for(1, 2)`` turns into a second stripe (both stripes
in this process), and the relaxation makes it RETIRE back to one.  The
final field is bitwise equal to the port's unscaled ``run_forward``.
With ``chip_seconds_per_step`` set, a step's time comes from the
platform model and the seeded rng only, so the decision stream does not
depend on the device, the stripe count or the package: the scale events
and the elapsed time equal the JAX package's run of the same
orchestrator on one stripe.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

CFG = dict(nz=48, nx=96, timesteps=120, n_shots=1, sponge_width=8)
W, K, LEGAL, CHIPS = 64.0, 1.4, [16, 32, 64, 128], 64
DEADLINE_S = 400.0
DEADLINE_CHANGES = [(20.0, 105.0), (60.0, 400.0)]


def _orchestrate(core, driver, solver, plan_policy, *, stripes_for,
                 **session_kw):
    """One run of the JAX end-to-end test's orchestrator through the
    given package's modules; returns (record, sessions)."""
    cfg = solver.FWIConfig(**CFG)
    cs = sorted(set(LEGAL) | {CHIPS})
    planner = core.BurstPlanner(
        cluster_model=core.LogCapacityModel.fit(cs, [W / c for c in cs]),
        cloud_model=core.LogCapacityModel.fit(cs, [K * W / c for c in cs]),
        chips_cluster=CHIPS, legal_slices=LEGAL,
        overheads=core.OverheadModel(ckpt_s=5.0, provision_s=10.0,
                                     restart_s=5.0),
        price_per_chip_hour=3.0, cost_weight=0.5,
    )
    orch = core.ElasticOrchestrator(
        planner=planner, predictor=core.DeadlinePredictor(DEADLINE_S),
        check_every=8, ckpt_every=40, eval_interval_s=7.0,
        cloud_slowdown=K,
    )
    base = driver.fwi_session_factory(
        cfg, driver.TimeModel(chip_seconds_per_step=W, jitter=0.01),
        stripes_for=stripes_for, exchange_interval=4, scan_block=8,
        **session_kw)
    sessions = []

    def factory(res, start_step, restored):
        s = base(res, start_step, restored)
        sessions.append(s)
        return s

    rec = orch.run(
        session_factory=factory,
        initial=core.Resources(pods=[core.PodSpec(chips=CHIPS,
                                                  name="cluster")],
                               shares=[1.0]),
        steps_total=CFG["timesteps"], autoscaler=plan_policy(),
        deadline_changes=DEADLINE_CHANGES,
    )
    return rec, sessions


def _port_run(device):
    from repro_torch import core
    from repro_torch.fwi import driver, solver
    from repro_torch.sim import PlanAutoscaler

    return _orchestrate(core, driver, solver, PlanAutoscaler,
                        stripes_for=driver.elastic_stripes_for(1, 2),
                        device=device)


def _scale_events(rec):
    return [(e.step, e.detail["kind"], e.detail["cloud_chips"])
            for e in rec.events if e.kind == "scale"]


@pytest.fixture(scope="module")
def port_cpu():
    return _port_run("cpu")


@pytest.fixture(scope="module")
def jax_run():
    from repro import core
    from repro.fwi import driver, solver
    from repro.sim import PlanAutoscaler

    rec, sessions = _orchestrate(core, driver, solver, PlanAutoscaler,
                                 stripes_for=None)
    return rec, sessions, solver.run_forward(solver.FWIConfig(**CFG),
                                             steps=CFG["timesteps"])[0]


def _check_loop(rec, sessions):
    from repro_torch.core import elastic_chips

    kinds = [kind for _, kind, _ in _scale_events(rec)]
    assert "grow" in kinds, kinds
    assert "retire" in kinds or "shrink" in kinds, kinds
    assert rec.completed and rec.met_deadline, (rec.elapsed_s,
                                                rec.deadline_s)
    assert rec.cloud_chip_s > 0
    assert elastic_chips(rec.final_resources) == 0
    stripes = [s.n_stripes for s in sessions]
    assert stripes[0] == 1 and max(stripes) == 2 and stripes[-1] == 1, \
        stripes
    assert sessions[-1].t == CFG["timesteps"]


def test_plan_grows_onto_two_stripes_and_retires(port_cpu):
    _check_loop(*port_cpu)
    # the squeeze lands mid-block: the grown session carries the steps
    # of a block already dispatched
    rec, _ = port_cpu
    assert any(step % 8 for step, _, _ in _scale_events(rec))


def test_final_field_bitwise_vs_unscaled_run(port_cpu):
    from repro_torch.fwi import solver

    _, sessions = port_cpu
    last = sessions[-1]
    ref, _ = solver.run_forward(solver.FWIConfig(**CFG),
                                steps=CFG["timesteps"], k=last.k,
                                device="cpu")
    assert float(ref.p.abs().max()) > 0
    assert torch.equal(last.p, ref.p) and torch.equal(last.p_prev,
                                                      ref.p_prev)


def test_final_field_close_to_jax(port_cpu, jax_run):
    """Within 1e-6·max|ref| of the JAX package's jitted run_forward
    (XLA:CPU's jitted code is not bitwise equal to its eager form), and
    so of the JAX package's own plan-driven session."""
    _, sessions = port_cpu
    _, jax_sessions, ref = jax_run
    got = sessions[-1].p.numpy()
    for want in (np.asarray(ref.p), np.asarray(jax_sessions[-1].p)):
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_decision_stream_equals_jax(port_cpu, jax_run):
    rec, _ = port_cpu
    jrec, jsessions, _ = jax_run
    assert all(s._n_stripes == 1 for s in jsessions)
    assert _scale_events(rec) == _scale_events(jrec)
    assert [(e.step, e.kind) for e in rec.events] \
        == [(e.step, e.kind) for e in jrec.events]
    assert rec.elapsed_s == pytest.approx(jrec.elapsed_s, rel=1e-12)
    assert rec.cloud_chip_s == pytest.approx(jrec.cloud_chip_s, rel=1e-12)
    assert rec.met_deadline == jrec.met_deadline


@pytest.mark.gpu
def test_plan_loop_on_the_card(port_cpu):
    """The same run with its sessions on the card: the same decisions,
    and the final field bitwise equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.stencil.kernel import wave_block_shots_cuda

    wave_block_shots_cuda.launches = 0
    rec, sessions = _port_run("cuda")
    _check_loop(rec, sessions)
    assert wave_block_shots_cuda.launches == sum(s.launches
                                                 for s in sessions) > 0
    cpu_rec, cpu_sessions = port_cpu
    assert _scale_events(rec) == _scale_events(cpu_rec)
    assert rec.elapsed_s == pytest.approx(cpu_rec.elapsed_s, rel=1e-12)
    assert torch.equal(sessions[-1].p.cpu(), cpu_sessions[-1].p)
