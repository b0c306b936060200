"""The port's striped domain (``repro_torch.fwi.domain``), its shot split
and its seam probe against the JAX package's.

The plan arithmetic and the overlapped model fields are equal to the
JAX package's exactly.  Each cell's arithmetic does not depend on the
window it is computed in, so every striped schedule is bitwise equal to
the port's single-stripe block runner, in one process and over a
2-rank gloo group.  Against the JAX package's jitted runners (XLA:CPU
contracts into FMAs and flushes subnormals) the port is held to
max|diff| ≤ 1e-6·max|ref|; the JAX package's "fused" schedule also
differs from its own reference by subnormal noise (< 1.2e-38).
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fwi import calibrate as jcalibrate  # noqa: E402
from repro.fwi import domain as jdomain  # noqa: E402
from repro.fwi import solver as jsolver  # noqa: E402
from repro_torch.fwi import calibrate, domain, solver  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
CFG = dict(nz=64, nx=128, timesteps=40, n_shots=2, sponge_width=8)
STEPS = 40
FLT_MIN = 1.2e-38


def _cfgs(**over):
    kw = dict(CFG, **over)
    return jsolver.FWIConfig(**kw), solver.FWIConfig(**kw)


def _reference(cfg, k, device="cpu"):
    st = solver.ShotState.init(cfg, device)
    run = solver.make_block_runner(cfg, k=k, device=device)
    return run(st.p, st.p_prev, 0, STEPS)


def _striped(cfg, mesh, k, schedule):
    run, place, kk = domain.make_sharded_scan_runner(cfg, mesh, k=k,
                                                     overlap=schedule)
    st = solver.ShotState.init(cfg, mesh.devices[0])
    p, pp = place((st.p, st.p_prev))
    p, pp, tr = run(p, pp, 0, STEPS // kk)
    return run.gather(p), run.gather(pp), tr


def _close(ref, got, rel=1e-6, floor=0.0):
    ref = np.asarray(ref)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    err = np.abs(ref - got).max()
    assert err <= max(rel * np.abs(ref).max(), floor), err


@pytest.mark.parametrize("over", [{}, dict(nz=96, nx=120, n_shots=3),
                                  dict(nx=600, nz=600, n_shots=4)])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_plan_arithmetic_matches_jax(over, n):
    jcfg, cfg = _cfgs(**over)
    for k in (1, 2, 3, 4, 8, 16, 64):
        assert domain.effective_block(cfg, n, k) \
            == jdomain.effective_block(jcfg, n, k)
        assert domain.halo_exchange_plan(cfg, n, k) \
            == jdomain.halo_exchange_plan(jcfg, n, k)
        assert domain.halo_bytes_per_step(cfg, n, k) \
            == jdomain.halo_bytes_per_step(jcfg, n, k)


@pytest.mark.parametrize("n,pad", [(1, 2), (2, 8), (4, 16)])
def test_overlapped_field_matches_jax(n, pad):
    jcfg, cfg = _cfgs()
    for jarr, arr in (
        ((jsolver.velocity_model(jcfg) * jcfg.dt / jcfg.dx) ** 2,
         solver.model_fields(cfg, torch.device("cpu")).v2dt2),
        (jsolver.sponge_taper(jcfg),
         solver.model_fields(cfg, torch.device("cpu")).sponge),
    ):
        want = np.asarray(jdomain._overlapped_field(np.asarray(jarr), n, pad))
        got = domain._overlapped_field(arr.numpy(), n, pad)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_schedule_selection():
    assert domain._as_schedule(True) == "overlap"
    assert domain._as_schedule(False) == "fused"
    assert domain._as_schedule("pipeline") == "pipeline"
    assert domain._as_schedule(None, "cpu") == domain.pick_schedule("cpu")
    assert domain.pick_schedule("cuda") == domain.FASTEST["cuda"]
    assert domain.pick_overlap("cpu") == (domain.pick_schedule("cpu")
                                          != "fused")
    with pytest.raises(ValueError, match="unknown halo schedule"):
        domain._as_schedule("ring")


@functools.lru_cache(maxsize=None)
def _jax_run_forward(k):
    jcfg, _ = _cfgs()
    st, tr = jsolver.run_forward(jcfg, steps=STEPS, k=k)
    return np.asarray(st.p), np.asarray(st.p_prev), np.asarray(tr)


@pytest.mark.parametrize("schedule", domain.SCHEDULES)
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("n", [2, 4])
def test_striped_runner_bitwise_vs_block_runner(n, k, schedule):
    """Bitwise equal to the port's block runner; within 1e-6·max|ref|
    of the JAX package's jitted ``run_forward``."""
    _, cfg = _cfgs()
    ref = _reference(cfg, k)
    mesh = domain.stripe_mesh(n, "cpu")
    got = _striped(cfg, mesh, k, schedule)
    assert got[2].shape == (cfg.n_shots, STEPS, cfg.nx)
    for g, r, j in zip(got, ref, _jax_run_forward(k)):
        assert torch.equal(g, r)
        _close(j, g)
    assert float(got[0].abs().max()) > 0


@pytest.mark.parametrize("schedule", [None, True, False, "pipeline"])
def test_multistep_and_step_bitwise(schedule):
    """One block at a time (``make_sharded_multistep``; "pipeline" runs
    its within-block form) and one step at a time
    (``make_sharded_step``, k = 1) against the block runner."""
    _, cfg = _cfgs()
    mesh = domain.stripe_mesh(2, "cpu")
    blk, place = domain.make_sharded_multistep(cfg, mesh, k=4,
                                               overlap=schedule)
    st = solver.ShotState.init(cfg, "cpu")
    p, pp = place((st.p, st.p_prev))
    trs = []
    for b in range(STEPS // blk.k):
        p, pp, tr = blk(p, pp, b * blk.k)
        trs.append(tr)
    ref = _reference(cfg, 4)
    assert torch.equal(blk.gather(p), ref[0])
    assert torch.equal(blk.gather(pp), ref[1])
    assert torch.equal(torch.cat(trs, dim=1), ref[2])

    step, place = domain.make_sharded_step(cfg, mesh)
    p, pp = place((st.p, st.p_prev))
    trs = []
    for t in range(12):
        p, pp, tr = step(p, pp, t)
        trs.append(tr)
    st1 = solver.ShotState.init(cfg, "cpu")
    r = solver.make_block_runner(cfg, k=1, device="cpu")(
        st1.p, st1.p_prev, 0, 12)
    assert torch.equal(step.gather(p), r[0])
    assert torch.equal(torch.stack(trs, dim=1), r[2])


def test_k_is_clamped_to_the_stripe_width():
    """A stripe of 16 columns takes k ≤ 4 (2·k·HALO ≤ 16); the runner
    reports the effective k, and the result is the block runner's at
    that k."""
    _, cfg = _cfgs(nx=64)
    run, place, k = domain.make_sharded_scan_runner(
        cfg, domain.stripe_mesh(4, "cpu"), k=8, overlap="pipeline")
    assert k == run.k == 4 == domain.effective_block(cfg, 4, 8)
    st = solver.ShotState.init(cfg, "cpu")
    p, pp = place((st.p, st.p_prev))
    p, pp, tr = run(p, pp, 0, STEPS // k)
    ref = _reference(cfg, 4)
    assert torch.equal(run.gather(p), ref[0])
    assert torch.equal(tr, ref[2])


def test_runner_resumes_and_passes_the_last_step():
    """5 blocks, then 7 more from t = 20 (8 steps past T = 40), equal
    one block-runner run of 48 steps: the state carries across calls
    and the amplitude clamps past the last step as there."""
    _, cfg = _cfgs()
    run, place, k = domain.make_sharded_scan_runner(
        cfg, domain.stripe_mesh(2, "cpu"), k=4, overlap="overlap")
    st = solver.ShotState.init(cfg, "cpu")
    p, pp = place((st.p, st.p_prev))
    p, pp, tr1 = run(p, pp, 0, 5)
    p, pp, tr2 = run(p, pp, 20, 7)             # 8 steps past T = 40
    blk = solver.make_block_runner(cfg, k=4, device="cpu")
    ref = blk(st.p, st.p_prev, 0, 48)
    assert torch.equal(run.gather(p), ref[0])
    assert torch.equal(torch.cat([tr1, tr2], dim=1), ref[2])
    # no traces
    run2, place2, _ = domain.make_sharded_scan_runner(
        cfg, domain.stripe_mesh(2, "cpu"), k=4, overlap="fused",
        collect_traces=False)
    out = run2(*place2((st.p, st.p_prev)), 0, 12)
    assert len(out) == 2 and torch.equal(run2.gather(out[0]), ref[0])


def test_mesh_forms_and_errors():
    mesh = domain.stripe_mesh(3, "cpu")
    assert mesh.stripes == (0, 1, 2)
    assert mesh == domain.stripe_mesh(3, torch.device("cpu"))
    assert domain.stripe_mesh(devices=["cpu", "cpu"]).n == 2
    with pytest.raises(ValueError, match="stripes on"):
        domain.stripe_mesh(3, ["cpu", "cpu"])
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="equal stripes"):
        domain.make_sharded_scan_runner(cfg, mesh, k=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            domain.stripe_mesh(2)


@pytest.mark.parametrize("n", [2, 3])
def test_uneven_shot_split_bitwise(n):
    """4 shots over 3 shards pad with a copy of shot 0; over 2 they split
    evenly.  Both are bitwise equal to the block runner."""
    _, cfg = _cfgs(n_shots=4)
    st = solver.ShotState.init(cfg, "cpu")
    ref = solver.make_block_runner(cfg, k=4, device="cpu")(
        st.p, st.p_prev, 0, STEPS)
    run, place = solver.make_shot_parallel_runner(cfg, n, k=4,
                                                  devices="cpu")
    p, pp = place((st.p, st.p_prev))
    assert p.shape[0] == -(-4 // n) * n
    for fields in ((p, pp), (st.p, st.p_prev)):     # padded or not
        got = run(*fields, 0, STEPS)
        assert len(got) == 3 and got[0].shape[0] == 4
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def test_seam_probe_matches_jax_keys_and_plan():
    jcfg, cfg = _cfgs()
    want = jcalibrate.measure_seam_latency(jcfg, n_stripes=2, k=4,
                                           iters=3, blocks=2)
    got = calibrate.measure_seam_latency(cfg, n_stripes=2, k=4, iters=3,
                                         blocks=2, device="cpu")
    assert sorted(got) == sorted(want)
    assert got["plan"] == want["plan"]
    assert got["backend"] == "cpu" and got["mesh_devices"] == 1
    assert got["ppermute_latency_s"] > 0
    assert got["interior_compute_s_per_step"] > 0
    k1 = calibrate.measure_seam_latency(cfg, n_stripes=4, k=1, iters=2,
                                        blocks=1, device="cpu")
    assert k1["plan"] == jdomain.halo_exchange_plan(jcfg, 4, 1)


_JAX_STRIPED = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from repro.fwi.solver import FWIConfig, ShotState
from repro.fwi.domain import make_sharded_scan_runner, stripe_mesh

cfg = FWIConfig(nz=64, nx=128, timesteps=40, n_shots=2, sponge_width=8)
out = {}
for schedule in ("fused", "overlap", "pipeline"):
    run, place, k = make_sharded_scan_runner(cfg, stripe_mesh(4), k=4,
                                             overlap=schedule)
    s = ShotState.init(cfg)
    p, pp = place((s.p, s.p_prev))
    p, pp, tr = run(p, pp, 0, 40 // k)
    out[schedule + "_p"] = np.asarray(p)
    out[schedule + "_pp"] = np.asarray(pp)
    out[schedule + "_tr"] = np.asarray(tr)
np.savez(sys.argv[2], **out)
print("JAX_STRIPED_OK")
"""


def test_four_stripes_close_to_jax_on_four_host_devices(tmp_path):
    """The JAX package's striped runner on 4 forced host devices, each
    schedule, against the port's 4 stripes."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    path = tmp_path / "jax_striped.npz"
    out = subprocess.run(
        [sys.executable, "-c", _JAX_STRIPED, SRC, str(path)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "JAX_STRIPED_OK" in out.stdout
    want = np.load(path)
    _, cfg = _cfgs()
    mesh = domain.stripe_mesh(4, "cpu")
    for schedule in domain.SCHEDULES:
        got = _striped(cfg, mesh, 4, schedule)
        floor = FLT_MIN if schedule == "fused" else 0.0
        for name, g in zip(("p", "pp", "tr"), got):
            _close(want[f"{schedule}_{name}"], g, floor=floor)


_GLOO = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.fwi import calibrate, domain, solver

rank, store_path, out_path = int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
cfg = solver.FWIConfig(nz=64, nx=128, timesteps=40, n_shots=2,
                       sponge_width=8)
mesh = domain.stripe_mesh(devices="cpu", group=dist.group.WORLD)
assert mesh.n == 2 and mesh.stripes == (rank,)
out = {}
for schedule in domain.SCHEDULES:
    run, place, k = domain.make_sharded_scan_runner(cfg, mesh, k=4,
                                                    overlap=schedule)
    st = solver.ShotState.init(cfg, "cpu")
    p, pp = place((st.p, st.p_prev))
    assert len(p) == 1
    p, pp, tr = run(p, pp, 0, 40 // k)
    out[schedule + "_p"] = run.gather(p).numpy()
    out[schedule + "_pp"] = run.gather(pp).numpy()
    out[schedule + "_tr"] = tr.numpy()
seam = calibrate.measure_seam_latency(cfg, n_stripes=2, k=4, iters=3,
                                      blocks=1, mesh=mesh, device="cpu")
assert seam["mesh_devices"] == 2 and seam["ppermute_latency_s"] > 0
np.savez(out_path, **out)
dist.destroy_process_group()
print("GLOO_OK", rank)
"""


def test_two_rank_gloo_bitwise_vs_in_process(tmp_path):
    """One stripe per rank over a 2-rank gloo group (a FileStore, so no
    port is fixed): each rank's gathered result equals the in-process
    striped run bitwise, for each schedule."""
    env = dict(os.environ)
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO, SRC, str(r), str(store),
         str(tmp_path / f"rank{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, se[-2000:]
        assert f"GLOO_OK {r}" in so
    _, cfg = _cfgs()
    mesh = domain.stripe_mesh(2, "cpu")
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for schedule in domain.SCHEDULES:
            want = _striped(cfg, mesh, 4, schedule)
            for name, w in zip(("p", "pp", "tr"), want):
                np.testing.assert_array_equal(got[f"{schedule}_{name}"],
                                              w.numpy())


# --- on the card ----------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", domain.SCHEDULES)
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("n", [2, 4])
def test_striped_runner_bitwise_on_the_card(cuda_device, n, k, schedule):
    """The block kernel on every window the schedules launch (boundary
    windows of 3·k·HALO columns included) gives the single-stripe run's
    bits."""
    _, cfg = _cfgs()
    ref = _reference(cfg, k, cuda_device)
    got = _striped(cfg, domain.stripe_mesh(n, cuda_device), k, schedule)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 3])
def test_uneven_shot_split_bitwise_on_the_card(cuda_device, n):
    _, cfg = _cfgs(n_shots=4)
    st = solver.ShotState.init(cfg, cuda_device)
    ref = solver.make_block_runner(cfg, k=4, device=cuda_device)(
        st.p, st.p_prev, 0, STEPS)
    run, place = solver.make_shot_parallel_runner(cfg, n, k=4,
                                                  devices=cuda_device)
    got = run(*place((st.p, st.p_prev)), 0, STEPS)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
