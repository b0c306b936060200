"""The port's FWI solver against the JAX package's.

Model fields are built in numpy in both packages and must be bitwise
equal.  ``run_forward`` on the CPU must be bitwise equal to the JAX
package's XLA reference run op by op (its block loop of
``wave_block_shots_ref`` with the solver's amplitudes and tail block).
The JAX package's jitted ``run_forward`` is not bitwise equal to that
op-by-op run itself: XLA:CPU contracts ``a·b + c`` into FMAs when it
fuses the jitted loop.  Against it the port is held to
max|diff| ≤ 1e-6·max|ref|.

XLA:CPU also flushes subnormal results to zero, and the wavefront's
tails pass through subnormals.  The bitwise cases therefore run the
port's CPU path with the same mode (``torch.set_flush_denormal``); the
port itself keeps PyTorch's default, as the card does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.fwi import solver as jsolver  # noqa: E402
from repro.kernels.stencil.ref import wave_block_shots_ref  # noqa: E402
from repro_torch.fwi import solver  # noqa: E402

CFG = dict(nz=64, nx=96, timesteps=48, n_shots=2, sponge_width=8)


@pytest.fixture
def flush_denormal():
    """Subnormals flushed to zero, as XLA:CPU computes."""
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush subnormals")
    yield
    torch.set_flush_denormal(False)


def _cfgs(**over):
    kw = dict(CFG, **over)
    return jsolver.FWIConfig(**kw), solver.FWIConfig(**kw)


def _eager_reference(jcfg, steps, k):
    """The JAX package's block loop, op by op: what
    ``repro.fwi.solver.run_forward(use_pallas=False)`` computes before
    XLA fuses it."""
    v2dt2 = (jsolver.velocity_model(jcfg) * jcfg.dt / jcfg.dx) ** 2
    sponge = jsolver.sponge_taper(jcfg)
    wavelet = jsolver.ricker(jcfg)
    pos = jcfg.shot_positions()
    shape = (jcfg.n_shots, jcfg.nz, jcfg.nx)
    p = pp = jnp.zeros(shape, jnp.float32)
    traces = []
    t = 0
    while t < steps:
        kk = min(k, steps - t)
        srcv = wavelet[jnp.clip(t + jnp.arange(kk), 0,
                                jcfg.timesteps - 1)] * (jcfg.dt ** 2)
        p, pp, tr = wave_block_shots_ref(
            p, pp, v2dt2, sponge, srcv, jnp.asarray(pos[:, 0]),
            jnp.asarray(pos[:, 1]), receiver_row=jcfg.receiver_depth)
        traces.append(tr)
        t += kk
    return p, pp, jnp.concatenate(traces, axis=1)


@pytest.mark.parametrize("over", [{}, dict(nz=37, nx=53, sponge_width=5)])
def test_model_fields_bitwise(over):
    jcfg, tcfg = _cfgs(**over)
    for name in ("velocity_model", "sponge_taper", "ricker"):
        a = np.asarray(getattr(jsolver, name)(jcfg))
        b = getattr(solver, name)(tcfg, device="cpu").numpy()
        np.testing.assert_array_equal(a, b)
    v = jsolver.velocity_model(jcfg)
    mf = solver.model_fields(tcfg, torch.device("cpu"))
    np.testing.assert_array_equal(
        np.asarray((v * jcfg.dt / jcfg.dx) ** 2), mf.v2dt2.numpy())
    np.testing.assert_array_equal(jcfg.shot_positions(),
                                  tcfg.shot_positions())


def test_run_forward_bitwise_with_tail_block(flush_denormal):
    jcfg, tcfg = _cfgs()
    steps, k = 38, 4                     # nine blocks and a tail of 2
    p, pp, tr = _eager_reference(jcfg, steps, k)
    st, ttr = solver.run_forward(tcfg, steps=steps, k=k, device="cpu")
    assert st.t == steps and tuple(ttr.shape) == (2, steps, CFG["nx"])
    np.testing.assert_array_equal(np.asarray(p), st.p.numpy())
    np.testing.assert_array_equal(np.asarray(pp), st.p_prev.numpy())
    np.testing.assert_array_equal(np.asarray(tr), ttr.numpy())


def test_run_forward_close_to_jitted_reference():
    jcfg, tcfg = _cfgs()
    ref, rtr = jsolver.run_forward(jcfg, steps=38, k=4)
    st, ttr = solver.run_forward(tcfg, steps=38, k=4, device="cpu")
    for a, b in ((ref.p, st.p), (ref.p_prev, st.p_prev), (rtr, ttr)):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-6 * np.abs(a).max()


def test_run_forward_resumes_bitwise_and_default_k():
    _, tcfg = _cfgs(timesteps=24)
    full, ftr = solver.run_forward(tcfg, device="cpu")
    assert full.t == 24 and ftr.shape[1] == 24
    half, htr = solver.run_forward(tcfg, steps=13, device="cpu")
    rest, rtr = solver.run_forward(tcfg, state=half, device="cpu")
    assert rest.t == 24
    assert torch.equal(rest.p, full.p) and torch.equal(rest.p_prev,
                                                      full.p_prev)
    assert torch.equal(torch.cat([htr, rtr], dim=1), ftr)
    done, none = solver.run_forward(tcfg, state=full, device="cpu")
    assert done is full and none.shape == (2, 0, CFG["nx"])


def test_block_runner_uses_pick_k_like_jax():
    jcfg, tcfg = _cfgs()
    run = solver.make_block_runner(tcfg, device="cpu")
    assert run.k == jsolver.make_block_runner(jcfg).k


def test_amplitudes_clamp_past_the_last_step(flush_denormal):
    """Steps past ``timesteps`` reuse the last amplitude, as the JAX
    package's ``jnp.clip`` does."""
    jcfg, tcfg = _cfgs(timesteps=10)
    p, pp, tr = _eager_reference(jcfg, 14, 4)
    st, ttr = solver.run_forward(tcfg, steps=14, k=4, device="cpu")
    np.testing.assert_array_equal(np.asarray(p), st.p.numpy())
    np.testing.assert_array_equal(np.asarray(tr), ttr.numpy())


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.run_forward(tcfg, steps=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.ShotState.init(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.velocity_model(tcfg)
