"""The port's SSD intra-chunk block against the JAX package's.

The plain version (``repro_torch.kernels.ssd.ref``) must match the JAX
package's reference and its Pallas kernel in interpret mode on the same
seeded inputs (``tests/test_kernels.py``'s shapes and inputs: unit
normals, ``csum = −cumsum(uniform)``):

* f32: atol 1e-5, the JAX package's own tolerance between the two
  (measured ≤ 7.7e-6 at max|y| 173: the sums run in other orders);
* bf16: both take C·Bᵀ in f32, round (C·Bᵀ)∘L to bf16 and round y once
  more, so y may differ by one bf16 step of an output (2^-7·|y| at
  most) and by the few terms whose bf16 rounding flipped between the
  two f32 sums (one step each): atol 2^-8·max|y| + rtol 2^-7 (measured
  one step, 0.0078 at max|y| 173).  The state is f32 in both: atol 1e-5.

The CUDA kernel is held to the plain version on the card (marked
``gpu``), on contiguous inputs and on the model's views.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.kernel import ssd_chunk_pallas  # noqa: E402
from repro.kernels.ssd.ref import ssd_chunk_ref as jref  # noqa: E402
from repro_torch.kernels.ssd import kernel, ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunk_ref  # noqa: E402

#: tests/test_kernels.py's shapes (BC, H, Q, N, P)
SHAPES = [(4, 2, 64, 32, 64), (2, 4, 128, 128, 64), (3, 1, 32, 16, 16)]
TOL = 1e-5
#: bf16 y: (share of max|y|, rtol); the state stays within TOL
BF16_Y = (2.0 ** -8, 2.0 ** -7)


def _inputs(seed, BC, H, Q, N, P):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BC, H, Q, P), dtype=np.float32)
    b = rng.standard_normal((BC, H, Q, N), dtype=np.float32)
    c = rng.standard_normal((BC, H, Q, N), dtype=np.float32)
    cs = -np.cumsum(rng.uniform(size=(BC, H, Q)).astype(np.float32),
                    axis=-1)
    return x, b, c, cs


def _torch(arrs, dtype, device="cpu"):
    x, b, c, cs = (torch.from_numpy(a).to(device) for a in arrs)
    return x.to(dtype), b.to(dtype), c.to(dtype), cs


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().cpu().numpy()


def _assert_bf16_y(got, want):
    got, want = _np(got), _np(want)
    atol = BF16_Y[0] * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=BF16_Y[1])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_jax_ref_and_pallas(shape):
    arrs = _inputs(sum(shape), *shape)
    jargs = [jnp.asarray(a) for a in arrs]
    got = ssd_chunk_ref(*_torch(arrs, torch.float32))
    assert got[0].dtype == got[1].dtype == torch.float32
    BC, H, Q, N, P = shape
    assert tuple(got[1].shape) == (BC, H, N, P)
    for want in (jref(*jargs), ssd_chunk_pallas(*jargs, interpret=True)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), atol=TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bf16_plain_matches_jax_ref(shape):
    arrs = _inputs(sum(shape) + 1, *shape)
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs[:3]] + [
        jnp.asarray(arrs[3])]
    jy, js = jref(*jargs)
    y, st = ssd_chunk_ref(*_torch(arrs, torch.bfloat16))
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    _assert_bf16_y(y, jy)
    np.testing.assert_allclose(_np(st), _np(js), atol=TOL)


def _views(arrs, dtype, device="cpu"):
    """The inputs as the model hands them over: xdt a (BC, H, Q, P) view
    of a (BC, Q, H, P) tensor, B and C one group seen by every head
    (stride 0), csum a view of (BC, Q, H).  Returns the views and their
    contiguous copies."""
    x, b, c, cs = arrs
    H = x.shape[1]
    xv = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                          ).to(device, dtype).transpose(1, 2)
    bv, cv = (torch.from_numpy(np.ascontiguousarray(a[:, :1])).to(
        device, dtype).expand(-1, H, -1, -1) for a in (b, c))
    sv = torch.from_numpy(np.ascontiguousarray(cs.transpose(0, 2, 1))
                          ).to(device).transpose(1, 2)
    views = (xv, bv, cv, sv)
    assert H == 1 or (bv.stride(1) == 0 and not xv.is_contiguous())
    return views, tuple(t.contiguous() for t in views)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_strided_views_equal_contiguous_copies(dtype):
    views, copies = _views(_inputs(5, 2, 4, 48, 32, 16), dtype)
    for a, b in zip(ssd_chunk_ref(*views), ssd_chunk_ref(*copies)):
        np.testing.assert_allclose(_np(a), _np(b), atol=TOL, rtol=1e-6)


def test_cpu_dispatch_takes_the_plain_version():
    args = _torch(_inputs(3, *SHAPES[2]), torch.float32)
    before = kernel.ssd_chunk_cuda.launches
    got = ops.ssd_chunk(*args)
    want = ssd_chunk_ref(*args)
    assert kernel.ssd_chunk_cuda.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_refuses_tensors_off_the_card():
    args = _torch(_inputs(4, *SHAPES[2]), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_chunk_cuda(*args)
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_chunk(*meta)


def test_bound_model():
    # mamba2-370m's prefill of 4 x 2048 tokens: BC=32, H=32, Q=256,
    # N=128, P=64, bf16, one group: xdt, y and the f32 state 33.6 MB
    # each, B and C 4.2 MB, csum 1 MB
    assert kernel.ssd_bytes(32, 32, 256, 128, 64, 2, 1) == 105_906_176
    pairs = 256 * 257 // 2
    assert kernel.ssd_flops(32, 32, 256, 128, 64) == 2 * 32 * 32 * (
        pairs * (128 + 64) + 256 * 128 * 64)


def test_heads_per_group_from_strides():
    # the model's G = 1 view (stride 0 over heads) is one group of H
    # heads; a repeat_interleave copy (G > 1) and contiguous per-head
    # tensors are read as one group per head
    base = torch.zeros((2, 1, 64, 32), dtype=torch.bfloat16)
    shared = base.expand(2, 8, 64, 32)
    assert kernel.heads_per_group(shared, shared) == 8
    rep = torch.zeros((2, 2, 64, 32)).repeat_interleave(4, dim=1)
    assert kernel.heads_per_group(rep, rep) == 1
    per_head = torch.zeros((2, 8, 64, 32))
    assert kernel.heads_per_group(per_head, per_head) == 1
    assert kernel.heads_per_group(shared, per_head) == 1
    one = base.expand(2, 1, 64, 32)
    assert kernel.heads_per_group(one, one) == 1


@pytest.mark.parametrize("H,Q,N,P,hpg,dtype,hb", [
    (32, 256, 128, 64, 32, torch.bfloat16, 2),    # mamba2-370m, shared
    (32, 256, 128, 64, 1, torch.bfloat16, 1),     # per-head B and C
    (5, 96, 128, 64, 5, torch.bfloat16, 2),       # odd H, ragged Q
    (6, 96, 128, 16, 6, torch.bfloat16, 2),
    (3, 40, 48, 32, 3, torch.bfloat16, 2),
    (8, 256, 256, 128, 8, torch.bfloat16, 2),
    (8, 256, 128, 64, 8, torch.float32, 1),       # f32: one head a CTA
], ids=str)
def test_launch_rule_on_ragged_shapes(H, Q, N, P, hpg, dtype, hb):
    r = kernel.launch_rule(7, H, Q, N, P, dtype, hpg)
    assert r["heads_per_group"] == hpg and r["heads_per_cta"] == hb
    # state CTAs a head block: each head's n blocks of 64 rows, hb a CTA
    assert r["q_tiles"] == -(-Q // 64)
    assert r["n_tiles"] == hb * -(-N // (64 * hb))
    assert r["n_tiles"] * 64 >= N and r["n_tiles"] % hb == 0
    # every head in exactly one block, the last one possibly part full
    assert (r["head_blocks"] - 1) * hb < H <= r["head_blocks"] * hb
    assert r["grid"] == (r["q_tiles"] + r["n_tiles"], r["head_blocks"], 7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES + [
    (2, 4, 96, 128, 64), (4, 8, 256, 128, 64),
    # on the model's stride-0 views: mamba2-370m's heads at Q = 256 and a
    # ragged Q = 96; the largest N and P
    (2, 32, 256, 128, 64), (2, 32, 96, 128, 64), (2, 4, 128, 256, 128)],
    ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    arrs = _inputs(sum(shape) + 2, *shape)
    args = _torch(arrs, dtype, cuda_device)
    before = kernel.ssd_chunk_cuda.launches
    y, st = ops.ssd_chunk(*args)
    assert kernel.ssd_chunk_cuda.launches == before + 1
    wy, wst = ssd_chunk_ref(*args)
    torch.cuda.synchronize()
    # test_kernels' shapes at its atol; the larger ones (|y| to ~300) may
    # round f32 sums an ulp or two apart past it: rtol 1e-6 there
    rtol = 0.0 if shape in SHAPES else 1e-6
    views, _ = _views(arrs, dtype, cuda_device)
    vy, vst = kernel.ssd_chunk_cuda(*views)
    vwy, vwst = ssd_chunk_ref(*views)
    torch.cuda.synchronize()
    for got, want in ((y, wy), (vy, vwy)):
        if dtype == torch.float32:
            np.testing.assert_allclose(_np(got), _np(want), atol=TOL,
                                       rtol=rtol)
        else:
            _assert_bf16_y(got, want)
    # bf16: the kernel carries B·to_end as three bf16 parts (~24 bits)
    for got, want in ((st, wst), (vst, vwst)):
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=rtol)
