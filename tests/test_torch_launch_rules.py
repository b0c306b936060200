"""The stencil kernels' launch rules and wrappers, on the CPU.

Every launch on the card is decided by pure functions of
``kernels/stencil/kernel.py`` (``window``, ``smem_bytes``,
``block_threads``, ``launch_shape``, ``shot_groups``, ``step_vector``,
``step_shapes``, ``step_tile_launches``, ``step_launch``), the tuner's
candidate lists (``tune.py``) and the dispatch (``ops.py``).  Each rule
is held here to what its docstring says, over whole grids of shapes;
``pick_bz_block`` and ``pick_k`` to the JAX package's.

The wrappers' argument checks and the dispatch of CUDA tensors run on
fake CUDA tensors (``FakeTensorMode``; ``dryrun.cuda_methods_without_card``
routes the indexing methods a CPU-only build guards), with the library
loaders made to refuse, so that no kernel can launch on a fake pointer.
They run with a card too; the ``gpu`` tests launch the real kernels
there.
"""
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.kernels.stencil import kernel as jkernel  # noqa: E402
from repro.kernels.stencil import ops as jops  # noqa: E402
from repro_torch.kernels.stencil import kernel, ops, tune  # noqa: E402
from repro_torch.launch.dryrun import cuda_methods_without_card  # noqa: E402

H = kernel.HALO


# ------------------------------------------------ pick_bz_block, pick_k


@pytest.mark.parametrize("cap", [128, 64, 16])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_pick_bz_block_equals_jax(k, cap):
    """Every nz from 1 to 700: the largest divisor ≤ cap, 8-aligned
    first, whose window fits the field, else the whole height."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # the JAX fallback warns
        for nz in range(1, 701):
            bz = ops.pick_bz_block(nz, k, cap)
            assert bz == jkernel.pick_bz_block(nz, k, cap), nz
            fits = [b for b in range(2, cap + 1)
                    if nz % b == 0 and b + 2 * k * H <= nz]
            if not fits:
                assert bz == nz
            elif any(b % 8 == 0 for b in fits):
                assert bz == max(b for b in fits if b % 8 == 0)
            else:
                assert bz == max(fits)


@pytest.mark.parametrize("cap", [8, 4, 2, 1])
def test_pick_k_equals_jax(cap):
    """The largest power of two ≤ cap whose trapezoid still admits a
    multi-strip tiling, for every nz from 1 to 1100."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for nz in range(1, 1101):
            k = ops.pick_k(nz, cap)
            assert k == jops.pick_k(nz, cap), nz
            assert 1 <= k <= cap and k & (k - 1) == 0


# ------------------------------------------------- the block kernel


TILES = [(tz, tx) for tz in (1, 8, 16, 32, 48, 64, 128)
         for tx in (2, 16, 32, 64, 96, 128, 256)]


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 16])
def test_block_launch_rules_follow_their_docstrings(k):
    for tz, tx in TILES:
        wz, wx = kernel.window(k, tz, tx)
        assert (wz, wx) == (tz + 2 * k * H, tx + 2 * k * H)
        for rows in (1, 4, 8):
            # one thread per pair of window columns and strip of rows
            assert kernel.block_threads(k, tz, tx, rows) \
                == wx // 2 * -(-wz // rows)
        fits = [(r, c) for r, c, lim in kernel.LAUNCHES
                if kernel.block_threads(k, tz, tx, r) <= lim]
        shape = kernel.launch_shape(k, tz, tx)
        assert shape == (fits[0] if fits else None), (tz, tx)
        rows = shape[0] if shape else 8
        assert kernel.smem_bytes(k, tz, tx) == \
            kernel.WINDOWS * (-(-wz // rows) * rows + 2 * H) * wx * 4
    assert kernel.window(k) == kernel.window(k, *kernel.BLOCK_TILE)


def test_launch_shapes_are_the_kernels():
    """Two CTAs per SM first, the longer strips first; each limit a
    whole number of warps within a CTA's 1024 threads."""
    assert [c for _, c, _ in kernel.LAUNCHES] == sorted(
        (c for _, c, _ in kernel.LAUNCHES), reverse=True)
    for rows, ctas, limit in kernel.LAUNCHES:
        assert rows in (4, 8) and ctas in (1, 2)
        assert limit % 32 == 0 and limit <= 1024


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
def test_shot_groups_follow_their_docstring(sms):
    """Each CTA takes ceil(ns·tiles / (CTAS_PER_SM·sms)) shots, at least
    one, and the groups are the fewest that hold the batch so."""
    for ns in range(0, 17):
        for tiles in (1, 2, 9, 100, 190, 4096):
            per = max(1, -(-ns * tiles // (kernel.CTAS_PER_SM * sms)))
            g = kernel.shot_groups(ns, tiles, sms)
            assert g == -(-ns // per)
            assert g * per >= ns and (g == 0 or (g - 1) * per < ns)


def test_traffic_and_operation_counts():
    for ns, nz, nx, k in ((1, 5, 7, 1), (4, 600, 600, 4), (3, 37, 53, 8)):
        cells = nz * nx
        assert kernel.block_bytes(ns, nz, nx, k) == \
            4 * (2 * ns * cells + 2 * cells + 2 * ns * cells + ns * k * nx)
        assert kernel.block_flops(ns, nz, nx, k) == 17 * ns * k * cells
        assert kernel.step_bytes(ns, nz, nx) == \
            4 * (2 * ns * cells + 2 * cells + 2 * ns * cells)
        assert kernel.step_flops(ns, nz, nx) == 17 * ns * cells
        # one step moves what a one-step block moves, less the trace
        assert kernel.step_bytes(ns, nz, nx) \
            == kernel.block_bytes(ns, nz, nx, 1) - 4 * ns * nx


# -------------------------------------------------- the step kernel


def test_step_vector_follows_its_docstring():
    """4, 2 or 1: the most columns for which NX and every address allow
    one aligned access of that width."""
    for nx in range(1, 40):
        for addrs in ((), (0,), (0, 4), (0, 8), (16, 32), (8, 16, 32),
                      (12,), (4096, 2)):
            want = next((v for v in (4, 2)
                         if nx % v == 0 and all(a % (4 * v) == 0
                                                for a in addrs)), 1)
            assert kernel.step_vector(nx, addrs) == want, (nx, addrs)


STEP_TILES = [(tz, tx) for tz in (1, 2, 4, 6, 8, 16, 32, 64, 128)
              for tx in (8, 16, 24, 32, 48, 64, 96, 128, 256, 512, 1024)]


@pytest.mark.parametrize("vec", [4, 2, 1])
def test_step_shapes_follow_their_docstring(vec):
    for tile in STEP_TILES:
        tz, tx = tile
        want = []
        lanes = tx // vec
        if tx % vec == 0 and (lanes in (8, 16) or lanes % 32 == 0):
            for rows in kernel.STEP_ROWS:
                threads = lanes * (tz // rows)
                if tz % rows == 0 and threads % 32 == 0 \
                        and 0 < threads <= 1024 // vec:
                    want.append((rows, threads))
        assert kernel.step_shapes(tile, vec) == want, tile
    assert kernel.step_shapes((16, 6), 4) == []      # tx not whole vectors


def test_step_tile_launches_is_every_vector():
    for tile in STEP_TILES:
        assert kernel.step_tile_launches(tile) == all(
            kernel.step_shapes(tile, v) for v in kernel.STEP_VECTORS)
    assert kernel.step_tile_launches((kernel.TILE_Z, kernel.TILE_X))


@pytest.mark.parametrize("vec", [4, 2, 1])
def test_step_launch_follows_its_docstring(vec):
    """The longest strip whose grid still gives every SM
    ``STEP_THREADS_PER_SM`` threads, else the shortest that launches;
    one shot per CTA; None where the tile cannot launch."""
    rng = np.random.default_rng(vec)
    for tile in STEP_TILES:
        shapes = kernel.step_shapes(tile, vec)
        for _ in range(6):
            ns, nz, nx = (int(rng.integers(1, 9)), int(rng.integers(1, 900)),
                          int(rng.integers(1, 900)))
            sms = int(rng.choice([1, 16, 132]))
            got = kernel.step_launch(ns, nz, nx, tile, vec, sms)
            if not shapes:
                assert got is None
                continue
            tiles = -(-nz // tile[0]) * -(-nx // tile[1])
            enough = [s for s in shapes
                      if ns * tiles * s[1] >= kernel.STEP_THREADS_PER_SM * sms]
            rows, threads = enough[0] if enough else shapes[-1]
            assert got == {"vec": vec, "rows": rows, "threads": threads,
                           "blocks": tiles * ns}


# ------------------------------------------------ the tuner's lists


def test_tuner_candidates_follow_their_docstrings():
    assert tune.step_candidates() == [
        t for t in tune.STEP_TILES if kernel.step_tile_launches(t)]
    assert tune.step_candidates(STEP_TILES) == [
        t for t in STEP_TILES if kernel.step_tile_launches(t)]
    pairs = tune.block_candidates()
    assert pairs == [
        (t, k) for k in tune.BLOCK_KS for t in tune.BLOCK_TILES
        if kernel.smem_bytes(k, *t) <= kernel.MAX_SMEM_BYTES
        and kernel.launch_shape(k, *t) is not None]
    assert kernel.BLOCK_TILE in {t for t, _ in pairs}
    wide = tune.block_candidates(TILES, (1, 2, 4, 8, 16))
    for t, k in wide:
        assert kernel.smem_bytes(k, *t) <= kernel.MAX_SMEM_BYTES
        assert kernel.launch_shape(k, *t) is not None


def test_sweeps_refuse_any_device_but_the_card():
    with pytest.raises(ValueError, match="plain version has no tiles"):
        tune.sweep_step_tile(16, 16, 1, device="cpu")
    with pytest.raises(ValueError, match="plain version has no tiles"):
        tune.sweep_block(16, 16, 1, device="cpu")
    with pytest.raises(ValueError, match="plain version has no tiles"):
        tune._card("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tune.sweep_step_tile(16, 16, 1)


def test_sweep_fields_are_seeded_and_constant_where_they_should_be():
    cpu = torch.device("cpu")
    p, pp, v, s = tune._fields(12, 20, 3, cpu)
    again = tune._fields(12, 20, 3, cpu)
    assert p.shape == pp.shape == (3, 12, 20) and v.shape == s.shape \
        == (12, 20)
    assert all(torch.equal(a, b) for a, b in zip((p, pp, v, s), again))
    assert not torch.equal(p, pp)       # two tensors, two reads
    assert torch.all(v == 0.1) and torch.all(s == 1.0)


def test_autotune_picks_the_fastest_of_the_sweep(monkeypatch):
    """The public sweeps hand the memoized ones hashable candidates and
    the card's name, and the tuners return the least time."""
    seen = {}
    card = torch.device("cuda", 0)

    def fake_step(nz, nx, ns, tiles, reps, name, dev):
        seen["step"] = (nz, nx, ns, tiles, reps, name, dev)
        return {t: 1.0 + abs(t[0] * t[1] - 2048) for t in tiles}

    def fake_block(nz, nx, ns, tiles, ks, reps, name, dev):
        seen["block"] = (nz, nx, ns, tiles, ks, reps, name, dev)
        return {(t, k): 1.0 / k + t[0] for t in tiles for k in ks}

    monkeypatch.setattr(tune, "_card", lambda device: card)
    monkeypatch.setattr(tune.torch.cuda, "get_device_name",
                        lambda dev: "a card")
    monkeypatch.setattr(tune, "_sweep_step", fake_step)
    monkeypatch.setattr(tune, "_sweep_block", fake_block)
    assert tune.autotune_step_tile(64, 64, 2, tiles=[[16, 128], [8, 64]]) \
        == (16, 128)
    assert seen["step"] == (64, 64, 2, ((16, 128), (8, 64)), 5, "a card",
                            card)
    assert tune.autotune_block(64, 64, 2, tiles=[[16, 32], [32, 32]],
                               ks=[1, 4], reps=2) == ((16, 32), 4)
    assert seen["block"][3:6] == (((16, 32), (32, 32)), (1, 4), 2)


# ------------------------------- the wrappers on fake CUDA tensors


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_sweeps_time_every_candidate_on_card(cuda_device):
    """Every candidate the lists keep is timed (a positive, finite ms per
    step), a sweep is memoized per shape and card, and the tuners return
    the fastest."""
    tiles = tune.step_candidates()[:3]
    kw = dict(tiles=tiles, reps=2, device=cuda_device)
    times = tune.sweep_step_tile(64, 256, 2, **kw)
    assert set(times) == set(tiles)
    assert all(0 < t and math.isfinite(t) for t in times.values())
    hits = tune._sweep_step.cache_info().hits
    assert tune.autotune_step_tile(64, 256, 2, **kw) \
        == min(times, key=times.get)
    assert tune._sweep_step.cache_info().hits == hits + 1
    kw = dict(tiles=((16, 32), (32, 64)), ks=(1, 2), reps=2,
              device=cuda_device)
    times = tune.sweep_block(64, 128, 2, **kw)
    assert set(times) == set(tune.block_candidates(kw["tiles"], kw["ks"]))
    assert all(0 < t and math.isfinite(t) for t in times.values())
    assert tune.autotune_block(64, 128, 2, **kw) == min(times, key=times.get)


@pytest.fixture
def fake_cuda(monkeypatch):
    """A fake-tensor mode for CUDA tensors, with both kernel libraries
    refusing to load: no kernel can launch on a fake pointer, with a
    card or without one."""
    def refuse():
        raise AssertionError("no kernel launches in this test")

    monkeypatch.setattr(kernel, "_lib", refuse)
    monkeypatch.setattr(kernel, "_step_lib", refuse)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Accessing the data pointer")
        with FakeTensorMode(), cuda_methods_without_card():
            yield


def _block_args(ns=2, nz=40, nx=52, k=4, dev="cuda"):
    p = torch.zeros((ns, nz, nx), device=dev)
    pp = torch.zeros((ns, nz, nx), device=dev)
    v = torch.zeros((nz, nx), device=dev)
    s = torch.zeros((nz, nx), device=dev)
    sv = torch.zeros((k,), device=dev)
    sz = torch.zeros((ns,), dtype=torch.int32, device=dev)
    sx = torch.zeros((ns,), dtype=torch.int32, device=dev)
    return [p, pp, v, s, sv, sz, sx]


BLOCK_REFUSALS = [
    # (argument index, replacement maker, keyword, message)
    (0, lambda a: a[0][0], {}, r"\(S, NZ, NX\)"),
    (4, lambda a: a[4].reshape(1, 1, 4), {}, r"\(k,\) or \(S, k\)"),
    (4, lambda a: torch.zeros((4, 2), device="cuda").t(), {},
     "contiguous along k"),
    (4, lambda a: a[4].double(), {}, "src_vals must be f32"),
    (4, lambda a: torch.zeros((3, 4), device="cuda"), {},
     "src_vals must be f32"),
    (4, lambda a: torch.zeros((0,), device="cuda"), {}, "at least 1"),
    (1, lambda a: a[1].double(), {}, "p_prev has dtype"),
    (2, lambda a: a[2][:-1], {}, "v2dt2 has shape"),
    (3, lambda a: torch.zeros((52, 40), device="cuda").t(), {},
     "sponge must be contiguous"),
    (5, lambda a: a[5].long(), {}, "src_z has dtype"),
    (6, lambda a: torch.zeros((2,), dtype=torch.int32), {},
     "src_x is on cpu"),
    (None, None, dict(receiver_row=40), "receiver_row 40"),
    (None, None, dict(receiver_row=-1), "receiver_row -1"),
    (None, None, dict(tile=(0, 64)), "must be positive"),
    (None, None, dict(tile=(32, 63)), "even column count"),
    (None, None, dict(tile=(512, 512)), "shared memory"),
    (None, None, dict(tile=(64, 128)), "more threads per CTA"),
]


@pytest.mark.parametrize("case", range(len(BLOCK_REFUSALS)))
def test_block_wrapper_refuses_what_its_kernel_cannot_take(fake_cuda, case):
    idx, make, kw, msg = BLOCK_REFUSALS[case]
    args = _block_args(k=8 if "threads" in msg else 4)
    if idx is not None:
        args[idx] = make(args)
    kw = dict(dict(receiver_row=2), **kw)
    before = kernel.wave_block_shots_cuda.launches
    with pytest.raises((ValueError, TypeError), match=msg):
        kernel.wave_block_shots_cuda(*args, **kw)
    assert kernel.wave_block_shots_cuda.launches == before


def test_block_wrapper_needs_cuda_tensors():
    args = _block_args(dev="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.wave_block_shots_cuda(*args, receiver_row=0)


def test_cuda_dispatch_without_a_card_raises(fake_cuda):
    """Valid CUDA inputs pass every check and reach the card's SM count,
    which a build without CUDA cannot read: the call raises, no
    launch is counted, and nothing falls back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    before = (kernel.wave_block_shots_cuda.launches,
              kernel.wave_step_cuda.launches)
    p, pp, v, s, sv, sz, sx = _block_args()
    with pytest.raises(AssertionError, match="not compiled with CUDA"):
        ops.wave_block(p, pp, v, s, sv, sz, sx, receiver_row=3)
    with pytest.raises(AssertionError, match="not compiled with CUDA"):
        ops.wave_block(p[0], pp[0], v, s, sv, 1, 2, receiver_row=3)
    with pytest.raises(AssertionError, match="not compiled with CUDA"):
        ops.wave_step(p, pp, v, s)
    with pytest.raises(AssertionError, match="not compiled with CUDA"):
        ops.wave_step(p[0], pp[0], v, s)
    assert (kernel.wave_block_shots_cuda.launches,
            kernel.wave_step_cuda.launches) == before


def test_empty_batch_returns_without_a_launch(fake_cuda, monkeypatch):
    monkeypatch.setattr(kernel, "_sm_count", lambda index: 132)
    monkeypatch.setattr(kernel, "_launch_step", lambda *a: pytest.fail(
        "an empty batch launched the step kernel"))
    before = kernel.wave_block_shots_cuda.launches
    for ns, nx in ((0, 52), (2, 0)):
        args = _block_args(ns=ns, nx=nx, k=3)
        pk, ppk, tr = kernel.wave_block_shots_cuda(*args, receiver_row=0)
        assert pk.shape == ppk.shape == (ns, 40, nx)
        assert tr.shape == (ns, 3, nx) and tr.device.type == "cuda"
        pn, pd = kernel.wave_step_cuda(*args[:4])
        assert pn.shape == pd.shape == (ns, 40, nx)
    assert kernel.wave_block_shots_cuda.launches == before


STEP_REFUSALS = [
    (0, lambda a: a[0][0], {}, r"\(S, NZ, NX\)"),
    (1, lambda a: a[1][:1], {}, "p_prev has shape"),
    (2, lambda a: a[2].half(), {}, "v2dt2 has dtype"),
    (3, lambda a: torch.zeros((40, 52)), {}, "sponge is on cpu"),
    (None, None, dict(tile=(8, 48)), "does not launch"),
    (None, None, dict(tile=(2048, 128)), "does not launch"),
]


@pytest.mark.parametrize("case", range(len(STEP_REFUSALS)))
def test_step_wrapper_refuses_what_its_kernel_cannot_take(fake_cuda, case):
    idx, make, kw, msg = STEP_REFUSALS[case]
    args = _block_args()[:4]
    if idx is not None:
        args[idx] = make(args)
    with pytest.raises((ValueError, TypeError), match=msg):
        kernel.wave_step_cuda(*args, **kw)


@pytest.mark.parametrize("nx,offset", [(52, 0), (50, 0), (51, 0), (52, 1)])
def test_step_wrapper_launches_what_step_launch_says(fake_cuda, monkeypatch,
                                                     nx, offset):
    """The launch the wrapper hands the library is ``step_launch`` at the
    columns ``step_vector`` allows for NX and the six tensors' addresses
    (an input 4 bytes into its storage drops it to one column)."""
    made = []
    monkeypatch.setattr(kernel, "_sm_count", lambda index: 132)
    monkeypatch.setattr(kernel, "_launch_step",
                        lambda tensors, tile, launch: made.append(
                            (tensors, tile, launch)))
    # p starts ``offset`` f32 into its storage
    p = torch.zeros((3 * 40 * nx + offset,), device="cuda")[offset:].view(
        3, 40, nx)
    pp = torch.zeros((3, 40, nx), device="cuda")
    v, s = (torch.zeros((40, nx), device="cuda") for _ in range(2))
    pn, pd = kernel.wave_step_cuda(p, pp, v, s, tile=(16, 128))
    assert pn.shape == pd.shape == (3, 40, nx)
    (tensors, tile, launch), = made
    assert tile == (16, 128) and tensors[:4] == (p, pp, v, s)
    assert tensors[4] is pn and tensors[5] is pd
    vec = kernel.step_vector(nx, [4 * offset])
    assert vec == (1 if offset else 4 if nx % 4 == 0 else 2 if nx % 2 == 0
                   else 1)
    assert launch == kernel.step_launch(3, 40, nx, (16, 128), vec, 132)


def test_cuda_dispatch_hands_the_wrappers_a_batch(fake_cuda, monkeypatch):
    """2-D fields go to the wrappers as the S=1 batch (positions as
    (1,) int32 on the card, the default tile) and come back 2-D; 3-D
    fields go as they are, a scalar position repeated per shot."""
    calls = []

    def block(p, pp, v, s, sv, sz, sx, *, receiver_row, tile):
        calls.append(("block", p.shape, sz, sx, receiver_row, tile))
        ns, nz, nx = p.shape
        return (p, pp, torch.zeros((ns, sv.shape[-1], nx), device="cuda"))

    def step(p, pp, v, s):
        calls.append(("step", p.shape))
        return p, pp

    monkeypatch.setattr(ops, "wave_block_shots_cuda", block)
    monkeypatch.setattr(ops, "wave_step_cuda", step)
    p, pp, v, s, sv, sz, sx = _block_args(ns=3)
    pk, ppk, tr = ops.wave_block(p[1], pp[1], v, s, sv, 7, 9, receiver_row=5)
    assert pk.shape == (40, 52) and tr.shape == (4, 52)
    kind, shape, z, x, row, tile = calls[-1]
    assert shape == (1, 40, 52) and row == 5 and tile == kernel.BLOCK_TILE
    for t in (z, x):
        assert t.shape == (1,) and t.dtype == torch.int32 \
            and t.device.type == "cuda"
    pk, ppk, tr = ops.wave_block(p, pp, v, s, sv, 7, sx, receiver_row=1,
                                 tile=(16, 64))
    kind, shape, z, x, row, tile = calls[-1]
    assert shape == (3, 40, 52) and tile == (16, 64) and z.shape == (3,)
    assert tr.shape == (3, 4, 52)
    assert ops.wave_step(p[0], pp[0], v, s)[0].shape == (40, 52)
    assert calls[-1] == ("step", (1, 40, 52))
    assert ops.wave_step(p, pp, v, s)[0].shape == (3, 40, 52)
    assert calls[-1] == ("step", (3, 40, 52))


def test_dispatch_refuses_devices_and_shapes_it_has_no_kernel_for():
    p = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="no stencil kernel for device"):
        ops.wave_block(*[t.to("meta") for t in (p, p, p[0], p[0])],
                       torch.zeros(2), [0, 0], [0, 0])
    with pytest.raises(ValueError, match="receiver_row 8"):
        ops.wave_block(p, p, p[0], p[0], torch.zeros(2), [0, 0], [0, 0],
                       receiver_row=8)
    with pytest.raises(ValueError, match=r"\(NZ, NX\) or \(S, NZ, NX\)"):
        ops.wave_step(p[0, 0], p[0, 0], p[0], p[0])
    before = (kernel.wave_block_shots_cuda.launches,
              kernel.wave_step_cuda.launches)
    # CPU tensors take the plain version: shapes as given, no launch
    out = ops.wave_block(p[0], p[0], p[0], p[0], torch.zeros(3), 1, 2,
                         receiver_row=1)
    assert [tuple(t.shape) for t in out] == [(8, 8), (8, 8), (3, 8)]
    out = ops.wave_block(p, p, p[0], p[0], torch.zeros(3), [1, 2], [2, 3],
                         receiver_row=1)
    assert [tuple(t.shape) for t in out] == [(2, 8, 8), (2, 8, 8), (2, 3, 8)]
    assert (kernel.wave_block_shots_cuda.launches,
            kernel.wave_step_cuda.launches) == before
