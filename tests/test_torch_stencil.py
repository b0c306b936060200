"""The port's stencil against the JAX package's.

The plain PyTorch versions (``repro_torch.kernels.stencil.ref``) must be
BITWISE equal to the JAX package's eager XLA references: same ops, same
accumulation order, one f32 rounding each.  The port's dispatch on CPU
tensors must stay within ``atol=1e-5`` of the JAX Pallas kernels in
interpret mode on unit-normal inputs — the contract the JAX package
holds its own Pallas kernels to (their z/x stencil order differs).  The
CUDA kernel is held to the plain version on the card (marked ``gpu``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.stencil import ops as jops  # noqa: E402
from repro.kernels.stencil import ref as jref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.stencil import kernel, ops, ref, tune  # noqa: E402


def _inputs(seed, ns, nz, nx, k, per_shot=True):
    """Unit-normal wavefields, positive model fields, sources at the
    field's edges and corners."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((ns, nz, nx)).astype(np.float32)
    pp = rng.standard_normal((ns, nz, nx)).astype(np.float32)
    v2 = rng.uniform(0.05, 0.2, (nz, nx)).astype(np.float32)
    sp = rng.uniform(0.9, 1.0, (nz, nx)).astype(np.float32)
    shape = (ns, k) if per_shot else (k,)
    sv = rng.standard_normal(shape).astype(np.float32)
    corners_z = np.array([0, nz - 1, nz // 2, 1], np.int32)
    corners_x = np.array([nx - 1, 0, 1, nx // 2], np.int32)
    sz = corners_z[np.arange(ns) % 4]
    sx = corners_x[np.arange(ns) % 4]
    return p, pp, v2, sp, sv, sz, sx


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_bitwise(jax_outs, torch_outs):
    for a, b in zip(jax_outs, torch_outs):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("ns", [1, 3])
@pytest.mark.parametrize("per_shot", [False, True])
@pytest.mark.parametrize("receiver_row", [0, 2])
def test_shots_ref_bitwise(k, ns, per_shot, receiver_row):
    args = _inputs(k * 10 + ns, ns, 21, 34, k, per_shot)
    a = jref.wave_block_shots_ref(*_jax(args), receiver_row=receiver_row)
    b = ref.wave_block_shots_ref(*_torch(args), receiver_row=receiver_row)
    _assert_bitwise(a, b)


@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("receiver_row", [0, 2])
def test_single_shot_ref_bitwise(k, receiver_row):
    p, pp, v2, sp, sv, sz, sx = _inputs(k, 1, 19, 27, k, per_shot=False)
    a = jref.wave_block_ref(*_jax([p[0], pp[0], v2, sp, sv]),
                            int(sz[0]), int(sx[0]),
                            receiver_row=receiver_row)
    b = ref.wave_block_ref(*_torch([p[0], pp[0], v2, sp, sv]),
                           int(sz[0]), int(sx[0]),
                           receiver_row=receiver_row)
    _assert_bitwise(a, b)


def test_wave_step_and_laplacian_bitwise():
    p, pp, v2, sp, *_ = _inputs(5, 2, 23, 31, 1)
    _assert_bitwise(jref.wave_step_ref(*_jax([p, pp, v2, sp])),
                    ref.wave_step_ref(*_torch([p, pp, v2, sp])))
    _assert_bitwise([jref.laplacian(jnp.asarray(p), 0.25)],
                    [ref.laplacian(torch.from_numpy(p), 0.25)])


@pytest.mark.parametrize("stream", [False, True])
def test_dispatch_cpu_matches_pallas_shots(stream):
    """CPU dispatch vs the JAX shot-batched Pallas kernels (resident and
    streamed) in interpret mode: atol 1e-5 on unit-normal inputs."""
    args = _inputs(7, 2, 64, 128, 4)
    a = jops.wave_block(*_jax(args), receiver_row=2, use_pallas=True,
                        interpret=True, stream=stream,
                        bz=16 if stream else None)
    b = ops.wave_block(*_torch(args), receiver_row=2)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("stream", [False, True])
def test_dispatch_cpu_matches_pallas_single_shot(stream):
    p, pp, v2, sp, sv, sz, sx = _inputs(8, 1, 64, 128, 3, per_shot=False)
    two_d = [p[0], pp[0], v2, sp, sv]
    a = jops.wave_block(*_jax(two_d), int(sz[0]), int(sx[0]),
                        receiver_row=0, use_pallas=True, interpret=True,
                        stream=stream, bz=16 if stream else None)
    b = ops.wave_block(*_torch(two_d), int(sz[0]), int(sx[0]),
                       receiver_row=0)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0,
                                   atol=1e-5)


def test_two_d_entry_equals_s1_batch():
    p, pp, v2, sp, sv, sz, sx = _inputs(9, 1, 30, 41, 4, per_shot=False)
    t = _torch([p, pp, v2, sp, sv])
    two = ops.wave_block(t[0][0], t[1][0], t[2], t[3], t[4],
                         int(sz[0]), int(sx[0]), receiver_row=2)
    bat = ops.wave_block(t[0], t[1], t[2], t[3], t[4],
                         torch.from_numpy(sz), torch.from_numpy(sx),
                         receiver_row=2)
    for x, y in zip(two, bat):
        assert torch.equal(x, y[0])


def test_cpu_dispatch_never_launches():
    before = kernel.wave_block_shots_cuda.launches
    ops.wave_block(*_torch(_inputs(1, 2, 16, 16, 2)), receiver_row=0)
    assert kernel.wave_block_shots_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernel.wave_block_shots_cuda(*_torch(_inputs(2, 1, 8, 8, 1)),
                                     receiver_row=0)


def test_dispatch_rejects_receiver_outside_field():
    with pytest.raises(ValueError, match="receiver_row"):
        ops.wave_block(*_torch(_inputs(3, 1, 8, 8, 1)), receiver_row=8)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(build.BuildError, match="nvcc"):
        build.nvcc_path()


def test_bound_and_shared_memory_model():
    # least traffic of one block (600², S=4, k=4 and 4096², S=4, k=8)
    assert kernel.block_bytes(4, 600, 600, 4) == 25_958_400
    assert kernel.block_bytes(4, 4096, 4096, 8) == 1_208_483_840
    # what one CTA allocates: WINDOWS buffers of the (TZ+4k, TX+4k)
    # window, its rows rounded up to whole strips, plus 2·HALO zero rows
    tz, tx = kernel.BLOCK_TILE
    wz, wx = tz + 32, tx + 32
    rows = kernel.launch_shape(8)[0]
    assert kernel.smem_bytes(8) == \
        kernel.WINDOWS * (-(-wz // rows) * rows + 4) * wx * 4
    assert kernel.smem_bytes(8) <= kernel.MAX_SMEM_BYTES
    assert ops.pick_k(600) == 8 and ops.pick_k(4096) == 8


def test_block_launch_plan():
    """Every (tile, k) the tuner may launch has a launch shape the
    kernel is built for: the first of ``LAUNCHES`` whose thread limit
    its CTA fits, with the threads covering the window in column pairs
    and whole strips."""
    pairs = tune.block_candidates()
    assert pairs
    for (tz, tx), k in pairs:
        rows, ctas = kernel.launch_shape(k, tz, tx)
        assert tx % 2 == 0
        wz, wx = kernel.window(k, tz, tx)
        assert (wz, wx) == (tz + 4 * k, tx + 4 * k)
        threads = kernel.block_threads(k, tz, tx, rows)
        assert threads == wx // 2 * -(-wz // rows)
        first = next(i for i, (r, c, lim) in enumerate(kernel.LAUNCHES)
                     if kernel.block_threads(k, tz, tx, r) <= lim)
        assert kernel.LAUNCHES[first][:2] == (rows, ctas)
    # the default tile: two CTAs per SM at k=4, one of 768 threads at 8
    assert kernel.launch_shape(4) == (8, 2)
    assert kernel.launch_shape(8) == (4, 1)
    # a window too wide for any launch shape is not launched
    assert kernel.launch_shape(8, 64, 128) is None
    assert tune.block_candidates(((64, 128),), (8,)) == []


def test_shot_groups_rule():
    """Shots spread over CTAs only where the tiles leave the card short
    of ``CTAS_PER_SM`` CTAs per SM, into as few groups as that aim
    allows."""
    sms = 132
    assert kernel.shot_groups(4, 19 * 10, sms) == 2      # 600², (32, 64)
    assert kernel.shot_groups(4, 10 * 10, sms) == 4      # 600², (64, 64)
    assert kernel.shot_groups(4, 128 * 64, sms) == 1     # 4096²
    assert kernel.shot_groups(1, 4, sms) == 1
    assert kernel.shot_groups(0, 4, sms) == 0
    for ns in range(1, 9):
        for tiles in (1, 7, 100, 190, 361, 1000, 8192):
            g = kernel.shot_groups(ns, tiles, sms)
            aim = max(1, -(-ns * tiles // (kernel.CTAS_PER_SM * sms)))
            # the fewest groups whose CTAs take at most `aim` shots each
            assert 1 <= g <= ns and -(-ns // g) <= aim
            assert g == 1 or -(-ns // (g - 1)) > aim


def test_pick_k_matches_jax():
    for nz in (16, 32, 48, 64, 251, 600):
        assert ops.pick_k(nz) == jops.pick_k(nz)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 37, 53, 1), (3, 64, 96, 3),
                                   (2, 70, 70, 8)])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    ns, nz, nx, k = shape
    args = [t.to(cuda_device) for t in _torch(_inputs(11, ns, nz, nx, k))]
    before = kernel.wave_block_shots_cuda.launches
    got = ops.wave_block(*args, receiver_row=2)
    assert kernel.wave_block_shots_cuda.launches == before + 1
    want = ref.wave_block_shots_ref(*args, receiver_row=2)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _seam_inputs(seed, ns, nz, nx, k, tile=kernel.BLOCK_TILE):
    """``_inputs`` with the sources on the tile's seams (the first row
    and column of a tile and the last of the one before) and on the
    field's edges."""
    p, pp, v2, sp, sv, _, _ = _inputs(seed, ns, nz, nx, k)
    tz, tx = tile
    zs = np.array([tz, tz - 1, 0, nz - 1], np.int32).clip(0, nz - 1)
    xs = np.array([tx - 1, nx - 1, tx, 0], np.int32).clip(0, nx - 1)
    return p, pp, v2, sp, sv, zs[np.arange(ns) % 4], xs[np.arange(ns) % 4]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("ns", [1, 3, 4])
def test_kernel_bitwise_on_card(cuda_device, ns, k):
    """Ragged fields (37 x 53, inside one tile's reach; 130 x 203, over
    several tiles with odd columns), sources on tile seams and field
    edges, the receiver on a seam: every output bitwise equal."""
    for nz, nx in ((37, 53), (130, 203)):
        args = [t.to(cuda_device)
                for t in _torch(_seam_inputs(10 * k + ns, ns, nz, nx, k))]
        rrow = min(kernel.BLOCK_TILE[0], nz - 1)
        got = ops.wave_block(*args, receiver_row=rrow)
        want = ref.wave_block_shots_ref(*args, receiver_row=rrow)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want)), (nz, nx)


@pytest.mark.gpu
def test_every_block_candidate_bitwise_on_card(cuda_device):
    """Every (tile, k) the tuner may pick, sources on that tile's seams."""
    for t, k in tune.block_candidates():
        args = [x.to(cuda_device)
                for x in _torch(_seam_inputs(17, 4, 150, 171, k, tile=t))]
        got = kernel.wave_block_shots_cuda(*args, receiver_row=t[0], tile=t)
        want = ref.wave_block_shots_ref(*args, receiver_row=t[0])
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want)), (t, k)


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [1, 2, 3, 4])
def test_shot_groups_bitwise_on_card(cuda_device, monkeypatch, groups):
    """The shots spread over 1-4 CTAs per tile (uneven at 3): bitwise."""
    monkeypatch.setattr(kernel, "shot_groups", lambda ns, tiles, sms: groups)
    args = [t.to(cuda_device)
            for t in _torch(_seam_inputs(23, 4, 130, 203, 4))]
    got = kernel.wave_block_shots_cuda(*args, receiver_row=31)
    want = ref.wave_block_shots_ref(*args, receiver_row=31)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
