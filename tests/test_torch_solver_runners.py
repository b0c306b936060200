"""The port's block and shot-parallel runners against the JAX package's.

``make_shot_parallel_runner`` splits the shot axis over shards, each a
block loop on its own shots; an uneven split pads with copies of shot 0.
Each shot's arithmetic does not depend on its batch, so on the CPU the
result is BITWISE the JAX package's block loop run op by op (with
subnormals flushed, as XLA:CPU computes), and within 1e-6·max|ref| of
its jitted shot-parallel runner (XLA contracts ``a·b + c`` into FMAs
when it fuses the loop) — the contract of ``tests/test_torch_fwi.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.fwi import solver as jsolver  # noqa: E402
from repro.kernels.stencil.ref import wave_block_shots_ref  # noqa: E402
from repro_torch.fwi import solver  # noqa: E402

CFG = dict(nz=48, nx=72, timesteps=30, n_shots=3, sponge_width=6)


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
    """The JAX package's block loop, op by op, from rest."""
    v2dt2 = (jsolver.velocity_model(jcfg) * jcfg.dt / jcfg.dx) ** 2
    sponge = jsolver.sponge_taper(jcfg)
    wavelet = jsolver.ricker(jcfg)
    pos = jcfg.shot_positions()
    p = pp = jnp.zeros((jcfg.n_shots, jcfg.nz, jcfg.nx), jnp.float32)
    traces, t = [], 0
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


def _rest(cfg):
    st = solver.ShotState.init(cfg, "cpu")
    return st.p, st.p_prev


DEVICES = {
    "one-name": lambda n: "cpu",
    "one-device": lambda n: torch.device("cpu"),
    "list": lambda n: ["cpu"] * n,
    "longer-list": lambda n: [torch.device("cpu")] * (n + 2),
}


@pytest.mark.parametrize("devices", sorted(DEVICES))
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_shot_parallel_bitwise_vs_jax_block_loop(flush_denormal, n, devices):
    """Even (1, 3) and uneven (2, 4) splits of 3 shots, a tail block of 2
    steps, devices named once or one per shard."""
    jcfg, cfg = _cfgs()
    steps, k = 22, 4
    want = _eager_reference(jcfg, steps, k)
    run, place = solver.make_shot_parallel_runner(
        cfg, n, k=k, devices=DEVICES[devices](n))
    assert run.k == k
    got = run(*place(_rest(cfg)), 0, steps)
    assert [tuple(t.shape) for t in got] == [
        (3, 48, 72), (3, 48, 72), (3, steps, 72)]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_shot_parallel_close_to_jitted_jax_runner():
    jcfg, cfg = _cfgs()
    jrun, jplace = jsolver.make_shot_parallel_runner(jcfg, 1, k=4)
    st = jsolver.ShotState.init(jcfg)
    want = jrun(*jplace((st.p, st.p_prev)), 0, 26)
    run, place = solver.make_shot_parallel_runner(cfg, 2, k=4,
                                                  devices="cpu")
    got = run(*place(_rest(cfg)), 0, 26)
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-6 * np.abs(a).max()


def test_shot_parallel_equals_block_runner_from_any_state():
    """From a mid-run state, at an offset t0, with and without traces:
    the same fields as the one-batch block runner; ``place`` and ``run``
    take padded or unpadded fields alike."""
    _, cfg = _cfgs()
    block = solver.make_block_runner(cfg, k=4, device="cpu")
    p, pp, _ = block(*_rest(cfg), 0, 9)
    want = block(p, pp, 9, 13)
    run, place = solver.make_shot_parallel_runner(cfg, 2, k=4,
                                                  devices=["cpu", "cpu"])
    padded = place((p, pp))
    assert [tuple(f.shape) for f in padded] == [(4, 48, 72)] * 2
    assert torch.equal(padded[0][3], p[0])       # the pad is shot 0
    assert torch.equal(place(p), padded[0])
    for ins in (padded, (p, pp)):
        got = run(*ins, 9, 13)
        assert all(torch.equal(a, b) for a, b in zip(want, got))
    run_nt, _ = solver.make_shot_parallel_runner(
        cfg, 2, k=4, collect_traces=False, devices="cpu")
    got = run_nt(p, pp, 9, 13)
    assert len(got) == 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_shot_parallel_refusals_and_defaults():
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="3 shards on 2 devices"):
        solver.make_shot_parallel_runner(cfg, 3, devices=["cpu", "cpu"])
    run, _ = solver.make_shot_parallel_runner(cfg, 1, devices="cpu")
    assert run.k == solver.pick_k(cfg.nz) \
        == jsolver.make_shot_parallel_runner(_cfgs()[0], 1)[0].k
    assert solver.make_shot_parallel_runner(cfg, 1, devices="cpu")[0] is run
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solver.make_shot_parallel_runner(cfg, 2)


def test_block_runner_without_traces_and_with_no_steps(flush_denormal):
    """``collect_traces=False`` returns the two fields bitwise as the
    JAX package's runner without traces computes them op by op; zero
    steps return the state and an empty (S, 0, NX) trace block."""
    jcfg, cfg = _cfgs()
    want = _eager_reference(jcfg, 14, 4)
    run = solver.make_block_runner(cfg, k=4, collect_traces=False,
                                   device="cpu")
    got = run(*_rest(cfg), 0, 14)
    assert len(got) == 2
    for a, b in zip(want[:2], got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jrun = jsolver.make_block_runner(jcfg, k=4, collect_traces=False)
    st = jsolver.ShotState.init(jcfg)
    jout = jrun(st.p, st.p_prev, 0, 14)
    assert len(jout) == 2
    for a, b in zip(jout, got):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-6 * np.abs(a).max()
    p, pp = _rest(cfg)
    for collect in (True, False):
        out = solver.make_block_runner(cfg, k=4, collect_traces=collect,
                                       device="cpu")(p, pp, 5, 0)
        assert out[0] is p and out[1] is pp
        if collect:
            assert tuple(out[2].shape) == (3, 0, 72)
        else:
            assert len(out) == 2
