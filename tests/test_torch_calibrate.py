"""The port's calibration path (paper §3.2) and tile tuners against the
JAX package's.

* ``fit_capacity_models`` given the same measured step time yields the
  same samples and bitwise-equal fitted A and B in both packages: the
  sampling and the fit are the same float64 arithmetic.
* The measurements themselves are wall-clock, so on the CPU the tests
  hold only their form: one positive time per width or per call.
* The calibrated adaptive run of ``tests/test_system.py`` runs on the
  port's solver on the CPU with the same thresholds (r² > 0.99, the
  deadline met, at least one burst).
* The tile tuners and ``FWISession(autotune=True)`` time the CUDA
  kernels, so off the card they raise.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fwi import calibrate as jcalibrate  # noqa: E402
from repro.fwi import solver as jsolver  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BurstPlanner,
    DeadlinePredictor,
    ElasticOrchestrator,
    GammaModel,
    OverheadModel,
    PodSpec,
    Resources,
)
from repro_torch.fwi import calibrate, driver, solver  # noqa: E402
from repro_torch.kernels.stencil import tune  # noqa: E402

SMALL = dict(nz=32, nx=48, timesteps=12, n_shots=2, sponge_width=6)


@pytest.mark.parametrize("kw", [
    {},
    dict(chip_counts=(8, 16, 32, 64, 128), cloud_slowdown=1.4, seed=3),
    dict(noise=0.05, cloud_slowdown=2.0),
])
def test_capacity_fit_parity(kw):
    t1 = 1.7342e-3
    a = jcalibrate.fit_capacity_models(
        jsolver.FWIConfig(**SMALL), measured_step_s=t1, **kw)
    b = calibrate.fit_capacity_models(
        solver.FWIConfig(**SMALL), measured_step_s=t1, device="cpu", **kw)
    assert a[2] == b[2]
    for ja, pb in zip(a[:2], b[:2]):
        assert (ja.A, ja.B, ja.name) == (pb.A, pb.B, pb.name)


def test_gamma_sweep_times_each_width():
    widths = [16, 24, 40]
    g, t = calibrate.measure_gamma_sweep(
        solver.FWIConfig(**SMALL), widths, steps=3, repeats=2, device="cpu")
    assert g == widths and len(t) == 3
    assert all(math.isfinite(x) and x > 0 for x in t)
    model = calibrate.fit_gamma_model(solver.FWIConfig(**SMALL), [16, 24],
                                      steps=2, repeats=1, device="cpu")
    assert isinstance(model, GammaModel) and model.name == "fwi-width"


def test_single_device_step_and_measured_fit():
    cfg = solver.FWIConfig(**SMALL)
    t1 = calibrate.measure_single_device_step(cfg, steps=4, device="cpu")
    assert math.isfinite(t1) and t1 > 0
    _, _, samples = calibrate.fit_capacity_models(
        cfg, chip_counts=(8, 16), device="cpu")
    assert samples["t1_measured"] > 0


def test_fwi_adaptive_on_port_solver():
    """``test_fwi_adaptive_on_real_solver`` on the port, on the CPU."""
    cfg = solver.FWIConfig(nz=64, nx=128, timesteps=120, n_shots=1,
                           sponge_width=8)
    cluster, cloud, samples = calibrate.fit_capacity_models(
        cfg, cloud_slowdown=1.4, chip_counts=(8, 16, 32, 64, 128),
        device="cpu")
    assert cluster.r2(samples["chips"], samples["t_cluster"]) > 0.99
    work = samples["t1_measured"]
    tm = driver.TimeModel(chip_seconds_per_step=work, congestion_from=30,
                          congestion_factor=2.0, jitter=0.01)
    deadline = work / 64 * 120 * 1.35
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
        session_factory=driver.fwi_session_factory(cfg, tm, device="cpu"),
        initial=Resources(pods=[PodSpec(chips=64, name="cluster")],
                          shares=[1.0]),
        steps_total=120,
    )
    assert rec.completed and rec.met_deadline
    assert [e for e in rec.events if e.kind == "burst"]


def test_tuners_refuse_the_cpu():
    with pytest.raises(ValueError, match="tiles"):
        tune.autotune_step_tile(16, 16, 1, device="cpu")
    with pytest.raises(ValueError, match="tiles"):
        tune.autotune_block(16, 16, 1, device="cpu")
    with pytest.raises(ValueError, match="autotune"):
        driver.FWISession(
            solver.FWIConfig(**SMALL),
            Resources(pods=[PodSpec(chips=1, name="cluster")],
                      shares=[1.0]),
            0, None, time_model=driver.TimeModel(),
            rng=np.random.default_rng(0), autotune=True, device="cpu")
    factory = driver.fwi_session_factory(
        solver.FWIConfig(**SMALL), driver.TimeModel(), autotune=True,
        device="cpu")
    with pytest.raises(ValueError, match="autotune"):
        factory(Resources(pods=[PodSpec(chips=1)], shares=[1.0]), 0, None)


def test_calibration_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = solver.FWIConfig(**SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.measure_gamma_sweep(cfg, [16])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.measure_single_device_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.autotune_block(16, 16, 1)
