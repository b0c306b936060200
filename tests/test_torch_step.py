"""The port's one-step stencil and step-at-a-time engine against the JAX
package's.

Tolerances, each with its reason:

* The plain ``wave_step`` (``repro_torch.kernels.stencil.ref``) is
  BITWISE equal to the JAX package's eager ``wave_step_ref``: same ops,
  same accumulation order, one f32 rounding each.
* Against the JAX Pallas kernel ``wave_step_pallas`` in interpret mode
  the port is held to ``atol=3e-6`` on unit-normal inputs, the
  tolerance ``tests/test_kernels.py`` holds that kernel to: the Pallas
  kernel sums the z ring before the x ring.
* Within the port, the step loop, the scan runner and the block runner
  are bitwise equal, traces included.
* The port's scan runner is bitwise equal to the JAX package's step
  loop run op by op, with subnormals flushed as XLA:CPU does, and within
  1e-6·max|ref| of the JAX package's jitted ``make_scan_runner``, which
  XLA:CPU compiles with FMA contraction.
* On the card (marked ``gpu``) the CUDA kernel is bitwise equal to its
  plain version, at every tile the tuners try, at 1, 2 and 4 columns a
  thread (NX % 4 and offset inputs) and with fewer rows than a strip.
* On the CPU the step kernel's launch rule (``kernel.step_launch``) is
  pinned at the shapes the engines run and checked to cover every tile.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.fwi import solver as jsolver  # noqa: E402
from repro.kernels.stencil import ops as jops  # noqa: E402
from repro.kernels.stencil import ref as jref  # noqa: E402
from repro_torch.fwi import solver  # noqa: E402
from repro_torch.kernels.stencil import kernel, ops, ref, tune  # noqa: E402

CFG = dict(nz=64, nx=96, timesteps=48, n_shots=2, sponge_width=8)


def _inputs(seed, shape):
    """Unit-normal wavefields, positive model fields, from a seed."""
    rng = np.random.default_rng(seed)
    nz, nx = shape[-2:]
    p = rng.standard_normal(shape).astype(np.float32)
    pp = rng.standard_normal(shape).astype(np.float32)
    v2 = rng.uniform(0.05, 0.2, (nz, nx)).astype(np.float32)
    sp = rng.uniform(0.9, 1.0, (nz, nx)).astype(np.float32)
    return p, pp, v2, sp


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


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


# ------------------------------------------------------------ the step


@pytest.mark.parametrize("nz,nx,bz", [
    (256, 256, 128), (128, 384, 32), (512, 128, 64), (64, 640, 8),
])
def test_step_matches_pallas_kernel(nz, nx, bz):
    """CPU dispatch vs ``wave_step_pallas`` in interpret mode, at the
    shapes of the JAX package's own kernel test: atol 3e-6."""
    args = _inputs(nz + nx, (nz, nx))
    a = jops.wave_step(*[jnp.asarray(x) for x in args], use_pallas=True,
                       interpret=True, bz=bz)
    b = ops.wave_step(*_torch(args))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0,
                                   atol=3e-6)


@pytest.mark.parametrize("shape", [(37, 53), (1, 37, 53), (3, 21, 34),
                                   (4, 5, 3)])
def test_step_bitwise_vs_reference(shape):
    args = _inputs(sum(shape), shape)
    a = jref.wave_step_ref(*[jnp.asarray(x) for x in args])
    b = ops.wave_step(*_torch(args))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_step_batch_equals_per_shot_calls():
    p, pp, v2, sp = _torch(_inputs(4, (3, 30, 41)))
    bat = ops.wave_step(p, pp, v2, sp)
    for s in range(3):
        one = ops.wave_step(p[s], pp[s], v2, sp)
        for x, y in zip(one, bat):
            assert torch.equal(x, y[s])


def test_step_rejects_what_it_cannot_dispatch():
    p, pp, v2, sp = _torch(_inputs(5, (2, 8, 8)))
    with pytest.raises(ValueError, match="tile"):
        ops.wave_block(p, pp, v2, sp, torch.zeros(2), [0, 0], [0, 0],
                       tile=(16, 16))
    with pytest.raises(ValueError, match="device"):
        ops.wave_step(*[t.to("meta") for t in (p, pp, v2, sp)])
    with pytest.raises(ValueError, match=r"\(S, NZ, NX\)"):
        ops.wave_step(p[None], pp[None], v2, sp)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.wave_step_cuda(p, pp, v2, sp)


def test_cpu_step_never_launches():
    before = kernel.wave_step_cuda.launches
    ops.wave_step(*_torch(_inputs(6, (2, 16, 16))))
    assert kernel.wave_step_cuda.launches == before


def test_step_bound_and_shared_memory_model():
    # least traffic of one step: 600², S=4 and 4096², S=4
    assert kernel.step_bytes(4, 600, 600) == 25_920_000
    assert kernel.step_bytes(4, 4096, 4096) == 1_207_959_552
    assert kernel.step_flops(4, 600, 600) == 24_480_000
    assert kernel.step_bytes(1, 5, 7) == kernel.block_bytes(1, 5, 7, 1) \
        - 4 * 7
    # the streaming kernel holds p in registers and uses no shared
    # memory; every candidate the tuner keeps launches at 4, 2 and 1
    # columns a thread; the ones it drops do not (too many threads, or
    # lanes that are no shuffle segment)
    kept = tune.step_candidates(((8, 64), (128, 256), (64, 256), (8, 48)))
    assert kept == [(8, 64)]
    for t in tune.step_candidates():
        assert all(kernel.step_shapes(t, v) for v in (4, 2, 1))
    assert (kernel.TILE_Z, kernel.TILE_X) in tune.step_candidates()
    pairs = tune.block_candidates()
    assert ((64, 64), 8) in pairs
    assert all(kernel.smem_bytes(k, *t) <= kernel.MAX_SMEM_BYTES
               for t, k in pairs)
    assert tune.block_candidates(((64, 128),), (8,)) == []


@pytest.mark.parametrize("nx,addresses,vec", [
    (600, (0, 512, 1024), 4),    # 16-byte rows and addresses
    (1026, (0, 512), 2),         # NX % 4 = 2
    (1025, (0,), 1),             # NX % 4 = 1
    (1027, (0,), 1),             # NX % 4 = 3
    (600, (0, 4), 1),            # an address 4 bytes into its allocation
    (600, (8, 0), 2),            # 8 bytes in
    (3, (), 1),
])
def test_step_columns_per_thread(nx, addresses, vec):
    assert kernel.step_vector(nx, addresses) == vec


@pytest.mark.parametrize("tile,ok", [
    ((16, 128), True),      # the default
    ((8, 512), True),       # 1024 threads at one column a thread
    ((4, 32), False),       # launches at one column a thread only
    ((64, 256), False),     # too many threads at every column count
    ((16, 96), False),      # 24, 48, 96 lanes: no shuffle segment
    ((5, 128), False),      # rows no whole number of strips
    ((0, 128), False),
    ((16, 0), False),
])
def test_step_tile_rule(tile, ok):
    """The wrapper takes a tile, and the tuner offers it, only where it
    launches at every column count a thread, so whether a tile is taken
    never depends on NX or on the tensors' alignment."""
    assert kernel.step_tile_launches(tile) is ok
    assert (tune.step_candidates((tile,)) == [tile]) is ok
    if ok:
        for vec in kernel.STEP_VECTORS:
            assert kernel.step_launch(2, 601, 598, tile, vec, 132)


@pytest.mark.parametrize("shape,vec,rows,threads,blocks", [
    # default tile (16, 128) on a 132-SM card
    ((4, 600, 600), 4, 4, 128, 4 * 38 * 5),
    ((4, 600, 128), 4, 2, 256, 4 * 38),       # small grid: 2-row strips
    ((4, 4096, 4096), 4, 4, 128, 4 * 256 * 32),
    ((4, 4096, 512), 4, 4, 128, 4 * 256 * 4),
    ((2, 601, 598), 2, 4, 256, 2 * 38 * 5),   # part strip, ragged tile
    ((2, 4096, 1027), 1, 4, 512, 2 * 256 * 9),
    ((2, 3, 260), 4, 2, 256, 2 * 1 * 3),      # fewer rows than a strip
    ((1, 37, 53), 1, 2, 1024, 1 * 3 * 1),
])
def test_step_launch_rule(shape, vec, rows, threads, blocks):
    ns, nz, nx = shape
    tile = (kernel.TILE_Z, kernel.TILE_X)
    got = kernel.step_launch(ns, nz, nx, tile, vec, 132)
    assert got == {"vec": vec, "rows": rows, "threads": threads,
                   "blocks": blocks}
    # the CTA's strips cover its tile once: lanes x strips x cells
    assert threads * rows * vec == tile[0] * tile[1]


def test_step_launch_rule_covers_every_tile():
    """At every candidate tile and column count the launch is a whole
    number of warps within the kernel's bounds, its strips cover the
    tile, and the grid covers the field once per shot."""
    rng = np.random.default_rng(21)
    for tile in tune.step_candidates():
        for vec in (4, 2, 1):
            for _ in range(4):
                ns, nz, nx = (int(rng.integers(1, 5)),
                              int(rng.integers(1, 700)),
                              int(rng.integers(1, 700)))
                got = kernel.step_launch(ns, nz, nx, tile, vec,
                                         int(rng.integers(1, 200)))
                assert got["rows"] in kernel.STEP_ROWS
                assert got["threads"] % 32 == 0
                assert got["threads"] <= 1024 // vec
                assert got["threads"] * got["rows"] * vec \
                    == tile[0] * tile[1]
                assert got["blocks"] == ns * -(-nz // tile[0]) \
                    * -(-nx // tile[1])
    assert kernel.step_launch(1, 64, 64, (8, 48), 4, 132) is None


# ------------------------------------------------------ the engines


def test_runners_agree_bitwise():
    """Step loop, scan runner and block runner: one answer, traces
    included; a restart at an offset changes nothing."""
    _, cfg = _cfgs()
    st = solver.ShotState.init(cfg, "cpu")
    step = solver.make_step_fn(cfg, device="cpu")
    p, pp, traces = st.p, st.p_prev, []
    for t in range(cfg.timesteps):
        p, pp, tr = step(p, pp, t)
        traces.append(tr)
    loop = (p, pp, torch.stack(traces, dim=1))
    scan = solver.make_scan_runner(cfg, collect_traces=True, device="cpu")
    full = scan(st.p, st.p_prev, 0, cfg.timesteps)
    block = solver.make_block_runner(cfg, k=4, device="cpu")(
        st.p, st.p_prev, 0, cfg.timesteps)
    for a, b, c in zip(loop, full, block):
        assert torch.equal(a, b) and torch.equal(a, c)
    p1, pp1, tr1 = scan(st.p, st.p_prev, 0, 21)
    p2, pp2, tr2 = scan(p1, pp1, 21, cfg.timesteps - 21)
    assert torch.equal(p2, full[0]) and torch.equal(pp2, full[1])
    assert torch.equal(torch.cat([tr1, tr2], dim=1), full[2])
    nt = solver.make_scan_runner(cfg, device="cpu")(st.p, st.p_prev, 0, 21)
    assert len(nt) == 2 and torch.equal(nt[0], p1)


def test_scan_runner_bitwise_vs_jax_step_loop(flush_denormal):
    """The JAX package's step (``_raw_step_fn``) run op by op, past the
    last timestep so the amplitude clamp is exercised."""
    jcfg, cfg = _cfgs(timesteps=40)
    steps = 44
    jstep = jsolver._raw_step_fn(jcfg, False)
    jst = jsolver.ShotState.init(jcfg)
    p, pp, traces = jst.p, jst.p_prev, []
    for t in range(steps):
        p, pp, tr = jstep(p, pp, t)
        traces.append(tr)
    st = solver.ShotState.init(cfg, "cpu")
    run = solver.make_scan_runner(cfg, collect_traces=True, device="cpu")
    got = run(st.p, st.p_prev, 0, steps)
    for a, b in zip((p, pp, jnp.stack(traces, axis=1)), got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_scan_runner_close_to_jitted_jax_runner():
    jcfg, cfg = _cfgs()
    ref_out = jsolver.make_scan_runner(jcfg, collect_traces=True)(
        *(lambda s: (s.p, s.p_prev))(jsolver.ShotState.init(jcfg)), 0, 48)
    st = solver.ShotState.init(cfg, "cpu")
    got = solver.make_scan_runner(cfg, collect_traces=True, device="cpu")(
        st.p, st.p_prev, 0, 48)
    for a, b in zip(ref_out, got):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-6 * np.abs(a).max()


def test_factories_memoized_per_device_and_tile():
    _, cfg = _cfgs()
    assert solver.make_scan_runner(cfg, device="cpu") \
        is solver.make_scan_runner(cfg, device="cpu")
    assert solver.make_step_fn(cfg, device="cpu") \
        is solver.make_step_fn(cfg, device="cpu")
    assert solver.make_scan_runner(cfg, device="cpu") \
        is not solver.make_scan_runner(cfg, collect_traces=True,
                                       device="cpu")
    st = solver.ShotState.init(cfg, "cpu")
    with pytest.raises(ValueError, match="tile"):
        solver.make_block_runner(cfg, tile=(32, 32), device="cpu")(
            st.p, st.p_prev, 0, 4)


def test_step_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.make_scan_runner(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.make_step_fn(cfg)


# ------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (1, 37, 53), (3, 64, 96), (2, 5, 3), (4, 130, 70),
    (2, 70, 1025), (2, 70, 1026), (2, 70, 1027),   # NX % 4 = 1, 2, 3
    (2, 3, 260), (3, 1, 64),                       # NZ below a strip
    (1, 601, 598), (1, 4, 128),                    # S = 1
])
def test_step_kernel_bitwise_on_card(cuda_device, shape):
    args = [t.to(cuda_device) for t in _torch(_inputs(11, shape))]
    before = kernel.wave_step_cuda.launches
    got = ops.wave_step(*args)
    assert kernel.wave_step_cuda.launches == before + 1
    want = ref.wave_step_ref(*args)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_step_kernel_bitwise_on_offset_inputs(cuda_device):
    """Inputs 4 and 8 bytes into their allocations take the kernel's 1-
    and 2-column paths at an NX that is a multiple of 4."""
    for offset in (1, 2):
        args = []
        for a in _inputs(14, (2, 66, 128)):
            buf = torch.zeros(a.size + offset, device=cuda_device)
            buf[offset:] = torch.from_numpy(a.reshape(-1)).to(cuda_device)
            args.append(buf[offset:].view(a.shape))
        got = kernel.wave_step_cuda(*args)
        want = ref.wave_step_ref(*args)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), offset


@pytest.mark.gpu
def test_every_tuner_tile_bitwise_on_card(cuda_device):
    for shape in ((2, 67, 1027), (2, 40, 256)):     # 1 and 4 columns
        args = [t.to(cuda_device) for t in _torch(_inputs(15, shape))]
        want = ref.wave_step_ref(*args)
        for t in tune.step_candidates():
            got = kernel.wave_step_cuda(*args, tile=t)
            assert all(torch.equal(x, y) for x, y in zip(got, want)), \
                (shape, t)
        # a tile that would launch at one column a thread only is
        # refused whatever the input
        with pytest.raises(ValueError, match="tile"):
            kernel.wave_step_cuda(*args, tile=(4, 32))
    p, pp, v2, sp = [t.to(cuda_device)
                     for t in _torch(_inputs(12, (3, 150, 170)))]
    want = ref.wave_step_ref(p, pp, v2, sp)
    for t in tune.step_candidates():
        got = kernel.wave_step_cuda(p, pp, v2, sp, tile=t)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), t
    rng = np.random.default_rng(13)
    sv = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    sz = torch.tensor([0, 75, 149], dtype=torch.int32)
    sx = torch.tensor([169, 64, 0], dtype=torch.int32)
    for t, k in tune.block_candidates():
        args = (p, pp, v2, sp, sv[:, :k].contiguous().to(cuda_device),
                sz.to(cuda_device), sx.to(cuda_device))
        got = kernel.wave_block_shots_cuda(*args, receiver_row=64, tile=t)
        want = ref.wave_block_shots_ref(*args, receiver_row=64)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), (t, k)


@pytest.mark.gpu
def test_scan_runner_launches_once_per_step(cuda_device):
    _, cfg = _cfgs()
    st = solver.ShotState.init(cfg, cuda_device)
    run = solver.make_scan_runner(cfg, collect_traces=True,
                                  device=cuda_device)
    before = kernel.wave_step_cuda.launches
    got = run(st.p, st.p_prev, 0, 20)
    assert kernel.wave_step_cuda.launches == before + 20
    cpu = solver.make_scan_runner(cfg, collect_traces=True, device="cpu")(
        st.p.cpu(), st.p_prev.cpu(), 0, 20)
    for x, y in zip(got, cpu):
        assert float((x.cpu() - y).abs().max()) <= 1e-5 * float(
            y.abs().max())
