"""The port's FWI session, checkpoints and orchestrator against the JAX
package's.

The JAX package's session runs its jitted engine, which XLA:CPU fuses
with FMA contraction and subnormal flushing, so the port's session (op
by op, one rounding per op) is held to it at max|diff| ≤
1e-6·max|ref|, not bitwise.  Within the port, the session, its
checkpoint/restore path and the orchestrator's resizes are bitwise
equal to an unscaled ``run_forward``.  Checkpoints cross between the
two packages in both directions.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402,E501
from repro.core.orchestrator import PodSpec as JPodSpec  # noqa: E402
from repro.core.orchestrator import Resources as JResources  # noqa: E402
from repro.fwi import driver as jdriver  # noqa: E402
from repro.fwi import solver as jsolver  # noqa: E402
from repro_torch.checkpoint.manager import (  # noqa: E402
    CheckpointManager,
    NoIntactCheckpointError,
)
from repro_torch.core import (  # noqa: E402
    BurstPlanner,
    DeadlinePredictor,
    ElasticOrchestrator,
    LogCapacityModel,
    OverheadModel,
    PodSpec,
    Resources,
    ScaleAction,
)
from repro_torch.fwi import driver, solver  # noqa: E402

CFG = dict(nz=48, nx=64, timesteps=48, n_shots=2, sponge_width=8)


def _res(mod_pod=PodSpec, mod_res=Resources, chips=1):
    return mod_res(pods=[mod_pod(chips=chips, name="cluster")],
                   shares=[1.0])


def _port_session(restored=None, start=0, res=None, **kw):
    return driver.FWISession(
        solver.FWIConfig(**CFG), res or _res(), start, restored,
        time_model=driver.TimeModel(jitter=0.0),
        rng=np.random.default_rng(0), device="cpu", **kw)


def _jax_session(restored=None, start=0):
    return jdriver.FWISession(
        jsolver.FWIConfig(**CFG), _res(JPodSpec, JResources), start,
        restored, time_model=jdriver.TimeModel(jitter=0.0),
        rng=np.random.default_rng(0))


def _close(ref, got, rel=1e-6):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.abs(ref - got).max() <= rel * np.abs(ref).max()


def test_session_fresh_and_resumed_from_jax_snapshot():
    js, ts = _jax_session(), _port_session()
    for i in range(20):
        js.run_step(i)
        ts.run_step(i)
    assert js.t == ts.t == 24 and ts.k == js.k == 4
    _close(js.p, ts.p)
    _close(js.p_prev, ts.p_prev)
    # resume the JAX session's state in the port; both run on
    snap = js.checkpoint(20)
    resumed = _port_session(
        driver.restored_from_reference(snap, device="cpu"), start=20)
    assert resumed._pending == snap["pending"]
    assert resumed._amortized == snap["amortized_s"]   # same fleet
    for i in range(20, 40):
        js.run_step(i)
        resumed.run_step(i)
    assert js.t == resumed.t == 40
    _close(js.p, resumed.p)


def test_session_bitwise_equals_run_forward():
    ts = _port_session()
    for i in range(21):
        ts.run_step(i)
    ref, _ = solver.run_forward(solver.FWIConfig(**CFG), steps=ts.t, k=4,
                                device="cpu")
    assert ts.t == 24 and ts.blocks == 6
    assert torch.equal(ts.p, ref.p) and torch.equal(ts.p_prev, ref.p_prev)


def test_driver_checkpoint_carries_block_progress():
    """A mid-block checkpoint/restore must not re-dispatch the pending
    steps: physical timesteps stay in lockstep with logical steps."""
    s = _port_session(exchange_interval=4, scan_block=8)
    for i in range(5):                      # mid-block: 3 steps pending
        s.run_step(i)
    snap = s.checkpoint(5)
    assert snap["t"] == 8 and snap["pending"] == 3
    s2 = _port_session(snap, start=5, exchange_interval=4, scan_block=8)
    for i in range(5, 16):
        s2.run_step(i)
    # 16 logical steps = exactly two blocks of 8 physical timesteps
    assert s2.t == 16


def test_amortized_rescaled_when_resources_differ():
    res1 = _res(chips=64)
    s = _port_session(res=res1)
    for i in range(5):
        s.run_step(i)
    a0 = s._amortized
    assert a0 > 0
    snap = s.checkpoint(5)
    assert _port_session(snap, 5, res=res1)._amortized == a0
    res2 = ElasticOrchestrator.apply_scale(
        res1, ScaleAction("grow", chips=64, slowdown=1.4))
    s2 = _port_session(snap, 5, res=res2)
    assert s2._amortized == pytest.approx(a0 * 64.0 / (64.0 + 64.0 / 1.4))


class _Scripted:
    name = "scripted"

    def __init__(self, grow_at, retire_at):
        self.grow_at, self.retire_at = grow_at, retire_at

    def decide(self, ctx):
        if ctx.step == self.grow_at:
            return ScaleAction("grow", chips=64, slowdown=1.4)
        if ctx.step == self.retire_at:
            return ScaleAction("retire")
        return ScaleAction("hold")


def _planner():
    legal = [16, 32, 64, 128]
    m = LogCapacityModel.fit(legal, [64.0 / c for c in legal])
    return BurstPlanner(
        cluster_model=m, cloud_model=m, chips_cluster=64,
        legal_slices=legal,
        overheads=OverheadModel(ckpt_s=5, provision_s=10, restart_s=5))


def test_orchestrated_grow_retire_equals_unscaled_run():
    cfg = solver.FWIConfig(**CFG)
    base = driver.fwi_session_factory(
        cfg, driver.TimeModel(chip_seconds_per_step=64.0, jitter=0.0),
        device="cpu")
    sessions = []

    def factory(res, start_step, restored):
        s = base(res, start_step, restored)
        sessions.append(s)
        return s

    orch = ElasticOrchestrator(
        planner=_planner(), predictor=DeadlinePredictor(10_000.0),
        check_every=2, ckpt_every=10, cloud_slowdown=1.4)
    rec = orch.run(session_factory=factory, initial=_res(chips=64),
                   steps_total=40, autoscaler=_Scripted(10, 26))
    kinds = [e.detail["kind"] for e in rec.events if e.kind == "scale"]
    assert kinds == ["grow", "retire"] and rec.completed
    assert len(sessions) == 3
    last = sessions[-1]
    ref, _ = solver.run_forward(cfg, steps=last.t, k=4, device="cpu")
    assert torch.equal(last.p, ref.p)
    assert sum(s.blocks for s in sessions) * 4 == last.t


def test_jax_snapshot_loads_in_port_and_back(tmp_path):
    js = _jax_session()
    for i in range(6):
        js.run_step(i)
    snap = js.checkpoint(6)
    jdriver.save_session_snapshot(JManager(tmp_path / "j", async_save=False),
                                  6, snap)
    restored, done = driver.load_session_snapshot(
        CheckpointManager(tmp_path / "j", async_save=False))
    assert done == 6 and restored["res_sig"] == snap["res_sig"]
    np.testing.assert_array_equal(restored["p"], snap["p"])
    for key in ("t", "pending", "amortized_s", "amortized_eff"):
        assert restored[key] == snap[key]
    # and the reverse: a port snapshot resumes in the JAX package
    ts = _port_session(restored, start=6)
    for i in range(6, 9):
        ts.run_step(i)
    tsnap = ts.checkpoint(9)
    driver.save_session_snapshot(
        CheckpointManager(tmp_path / "t", async_save=False), 9, tsnap)
    back, done = jdriver.load_session_snapshot(
        JManager(tmp_path / "t", async_save=False))
    assert done == 9 and back["res_sig"] == tsnap["res_sig"]
    np.testing.assert_array_equal(back["p_prev"], tsnap["p_prev"])
    js2 = _jax_session(back, start=9)
    assert js2.t == ts.t and js2._pending == ts._pending


def test_preemption_guard_snapshot_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    guard = driver.PreemptionGuard(mgr)
    guard.save()                           # nothing published: no-op
    assert mgr.all_steps() == []
    s = _port_session()
    for i in range(3):
        s.run_step(i)
    guard.publish(s, 3)
    guard.save()
    restored, done = driver.load_session_snapshot(mgr)
    assert done == 3 and restored["t"] == s.t
    assert np.array_equal(restored["p"], s.p.numpy())
    s2 = _port_session(restored, start=3)
    for i in range(3, 12):
        s.run_step(i)
        s2.run_step(i)
    assert torch.equal(s.p, s2.p)


def _corrupt(root, step, leaf="x"):
    f = Path(root) / f"step_{step:08d}" / f"{leaf}.npy"
    f.write_bytes(f.read_bytes()[:-3] + b"\x00\x00\x00")


def test_manager_crc_fallback_to_newest_intact(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False, keep=1)
    assert m.keep == 2
    for s in (1, 2, 3):
        m.save(s, {"x": torch.full((4,), float(s))}, extra={"step": s})
    assert m.all_steps() == [2, 3]
    _corrupt(tmp_path, 3)
    assert not m.verify(3) and m.verify(2)
    with pytest.warns(UserWarning, match="failed integrity"):
        state, extra = m.restore({"x": 0})
    assert extra["step"] == 2 and torch.equal(state["x"],
                                              torch.full((4,), 2.0))
    _corrupt(tmp_path, 2)
    with pytest.warns(UserWarning):
        with pytest.raises(NoIntactCheckpointError, match="no intact"):
            m.restore({"x": 0})
    with pytest.raises(NoIntactCheckpointError, match="step 2"):
        m.restore({"x": 0}, step=2)


def test_manager_nested_layout_matches_jax(tmp_path):
    tree = {"b": [np.arange(3.0), {"c": np.ones((2, 2), np.float32)}],
            "a": torch.arange(4, dtype=torch.int32)}
    CheckpointManager(tmp_path, async_save=True).save(5, tree, wait=True)
    names = sorted(p.name for p in (tmp_path / "step_00000005").iterdir())
    assert names == ["a.npy", "b__0.npy", "b__1__c.npy", "manifest.json"]
    jstate, _ = JManager(tmp_path, async_save=False).restore(
        {"a": 0, "b": [0, {"c": 0}]})
    np.testing.assert_array_equal(np.asarray(jstate["b"][1]["c"]),
                                  np.ones((2, 2)))
    state, _ = CheckpointManager(tmp_path, async_save=False).restore(
        {"a": 0, "b": (0, {"c": 0})})
    assert isinstance(state["b"], tuple)
    assert torch.equal(state["a"], torch.arange(4, dtype=torch.int32))


def test_unported_options_raise():
    # the tile sweep times the CUDA kernel; the plain version has no tiles
    with pytest.raises(ValueError, match="autotune"):
        _port_session(autotune=True)
    with pytest.raises(ValueError, match="autotune"):
        _port_session(autotune=True, n_stripes=2)
    # striping is ported: a GROW through elastic_stripes_for(1, 2) now
    # runs the grown session on two stripes
    grown = ElasticOrchestrator.apply_scale(
        _res(chips=64), ScaleAction("grow", chips=32, slowdown=1.4))
    factory = driver.fwi_session_factory(
        solver.FWIConfig(**CFG), driver.TimeModel(),
        stripes_for=driver.elastic_stripes_for(1, 2), device="cpu")
    base = factory(_res(chips=64), 0, None)
    assert base.t == 0 and base.n_stripes == 1
    s = factory(grown, 0, None)
    assert s.n_stripes == 2 and s._res_sig[0] == 2 and s.k == 4


@pytest.mark.parametrize("n", [2, 4])
def test_striped_session_bitwise_equals_one_stripe(n):
    one, many = _port_session(), _port_session(n_stripes=n)
    assert many.n_stripes == n and many._res_sig[0] == n
    for i in range(21):
        one.run_step(i)
        many.run_step(i)
    assert one.t == many.t == 24 and many.blocks == one.blocks == 6
    assert many.launches == 6 * n        # "fused": one window a stripe
    assert torch.equal(many.p, one.p)
    assert torch.equal(many.p_prev, one.p_prev)


def test_striped_session_k_clamped_to_stripe_width():
    """nx = 64 over 8 stripes of 8 columns: k = 8 // (2·HALO) = 2."""
    s = _port_session(n_stripes=8, exchange_interval=8)
    assert s.k == 2 and s.block == 8
    ref = _port_session(exchange_interval=2)
    for i in range(8):
        s.run_step(i)
        ref.run_step(i)
    assert torch.equal(s.p, ref.p)


def test_orchestrated_grow_onto_two_stripes_equals_run_forward():
    """The orchestrator's GROW moves half the domain onto a second
    stripe (``elastic_stripes_for(1, 2)``), RETIRE brings it back; the
    run ends bitwise equal to an unscaled ``run_forward``."""
    cfg = solver.FWIConfig(**CFG)
    base = driver.fwi_session_factory(
        cfg, driver.TimeModel(chip_seconds_per_step=64.0, jitter=0.0),
        stripes_for=driver.elastic_stripes_for(1, 2), device="cpu")
    sessions = []

    def factory(res, start_step, restored):
        s = base(res, start_step, restored)
        sessions.append(s)
        return s

    orch = ElasticOrchestrator(
        planner=_planner(), predictor=DeadlinePredictor(10_000.0),
        check_every=2, ckpt_every=10, cloud_slowdown=1.4)
    rec = orch.run(session_factory=factory, initial=_res(chips=64),
                   steps_total=40, autoscaler=_Scripted(10, 26))
    kinds = [e.detail["kind"] for e in rec.events if e.kind == "scale"]
    assert kinds == ["grow", "retire"] and rec.completed
    assert [s.n_stripes for s in sessions] == [1, 2, 1]
    assert sessions[1].blocks > 0
    assert sessions[1].launches == 2 * sessions[1].blocks
    last = sessions[-1]
    ref, _ = solver.run_forward(cfg, steps=last.t, k=4, device="cpu")
    assert torch.equal(last.p, ref.p) and torch.equal(last.p_prev,
                                                      ref.p_prev)


def test_two_stripe_snapshot_restores_into_one_stripe(tmp_path):
    """A 2-stripe session's snapshot holds whole fields: it resumes on
    one stripe in the port and in the JAX package."""
    s2 = _port_session(n_stripes=2)
    for i in range(5):
        s2.run_step(i)
    mgr = CheckpointManager(tmp_path, async_save=False)
    driver.save_session_snapshot(mgr, 5, s2.checkpoint(5))
    restored, done = driver.load_session_snapshot(mgr)
    assert done == 5 and restored["res_sig"][0] == 2
    assert restored["p"].shape == (2, CFG["nz"], CFG["nx"])
    one = _port_session(restored, start=5)
    assert one.n_stripes == 1
    for i in range(5, 16):
        s2.run_step(i)
        one.run_step(i)
    assert torch.equal(one.p, s2.p) and torch.equal(one.p_prev, s2.p_prev)
    back, _ = jdriver.load_session_snapshot(JManager(tmp_path,
                                                     async_save=False))
    js = _jax_session(back, start=5)
    for i in range(5, 16):
        js.run_step(i)
    _close(js.p, s2.p)


_SIGTERM_CHILD = """
import sys, time
import numpy as np
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import PodSpec, Resources
from repro_torch.fwi.driver import (
    FWISession, PreemptionGuard, TimeModel, load_session_snapshot,
)
from repro_torch.fwi.solver import FWIConfig

mode, ckpt_dir, out = sys.argv[1], sys.argv[2], sys.argv[3]
TOTAL = 20
cfg = FWIConfig(nz=32, nx=64, timesteps=32, n_shots=2, sponge_width=4)
res = Resources(pods=[PodSpec(chips=1, name="cluster")], shares=[1.0])
mgr = CheckpointManager(ckpt_dir, async_save=False)
kw = dict(time_model=TimeModel(jitter=0.0), rng=np.random.default_rng(0),
          exchange_interval=4, scan_block=4, device="cpu")
if mode == "run":
    guard = PreemptionGuard(mgr).install()
    session = FWISession(cfg, res, 0, None, n_stripes=2, **kw)
    start = 0
else:
    restored, start = load_session_snapshot(mgr)
    session = FWISession(cfg, res, start, restored, **kw)
for step in range(start, TOTAL):
    session.run_step(step)
    if mode == "run":
        guard.publish(session, step + 1)
        print(f"STEP {step + 1}", flush=True)
        time.sleep(0.2)
np.save(out, session.p.numpy())
print(f"DONE {start} {session.n_stripes}", flush=True)
"""


def test_sigterm_on_two_stripes_restores_on_one(tmp_path):
    """The preemption chain across stripe counts: a 2-stripe session is
    killed by SIGTERM mid-run, its guard persists the published
    snapshot (whole fields) and the process exits 143; a fresh process
    resumes it on one stripe and ends bitwise equal to an uninterrupted
    run."""
    child = tmp_path / "child.py"
    child.write_text(_SIGTERM_CHILD)
    ckpt, out = tmp_path / "ckpt", tmp_path / "resumed.npy"
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    proc = subprocess.Popen(
        [sys.executable, str(child), "run", str(ckpt), str(out)],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        for line in proc.stdout:
            if line.startswith("STEP") and int(line.split()[1]) >= 3:
                proc.send_signal(signal.SIGTERM)
                break
        proc.stdout.read()
        assert proc.wait(timeout=120) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert not out.exists()
    second = subprocess.run(
        [sys.executable, str(child), "resume", str(ckpt), str(out)],
        capture_output=True, text=True, env=env, check=True, timeout=300)
    _, resumed_from, stripes = second.stdout.split()
    assert 3 <= int(resumed_from) < 20 and stripes == "1"
    cfg = solver.FWIConfig(nz=32, nx=64, timesteps=32, n_shots=2,
                           sponge_width=4)
    ref, _ = solver.run_forward(cfg, steps=20, k=4, device="cpu")
    np.testing.assert_array_equal(np.load(out), ref.p.numpy())


@pytest.mark.gpu
def test_striped_session_bitwise_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = solver.FWIConfig(**CFG)

    def session(n):
        return driver.FWISession(
            cfg, _res(), 0, None, time_model=driver.TimeModel(jitter=0.0),
            rng=np.random.default_rng(0), n_stripes=n, device="cuda")

    one, two = session(1), session(2)
    for i in range(21):
        one.run_step(i)
        two.run_step(i)
    assert torch.equal(one.p, two.p) and torch.equal(one.p_prev,
                                                     two.p_prev)
    ref, _ = solver.run_forward(cfg, steps=two.t, k=4, device="cpu")
    assert torch.equal(two.p.cpu(), ref.p)


def test_cuda_session_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.FWISession(
            solver.FWIConfig(**CFG), _res(), 0, None,
            time_model=driver.TimeModel(), rng=np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.fwi_session_factory(solver.FWIConfig(**CFG),
                                   driver.TimeModel())
