"""The port's fused residual-add + RMSNorm against the JAX package's.

The plain version (``repro_torch.kernels.rmsnorm.ref``) must match the
JAX package's Pallas kernel in interpret mode and its reference on the
same seeded inputs, within the JAX package's absolute tolerances
(``tests/test_kernels.py``: atol 1e-6 for f32, 2e-2 for bf16).  XLA and
PyTorch sum the mean of squares in different orders and round the
rsqrt differently, so f32 outputs differ by a few ulps (4 ulps at
|out| = 6.6 in one element of 131072 here), which an absolute 1e-6
cannot hold at |out| > 2: f32 also gets rtol 1e-6.  The residual sum
is bitwise.  The CUDA kernel is held to the plain version on the card
(marked ``gpu``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm.kernel import rmsnorm_residual_pallas  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_residual_ref as jref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel, ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_residual_ref  # noqa: E402

#: name: (JAX dtype, torch dtype, atol, rtol)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 0.0)}


def _inputs(seed, n, d, near_one=False):
    """Unit-normal rows; a unit-normal scale, or ``1 + 0.1·N(0, 1)`` (the
    model's scales start at 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    r = rng.standard_normal((n, d), dtype=np.float32)
    sc = rng.standard_normal(d, dtype=np.float32)
    if near_one:
        sc = (1.0 + 0.1 * sc).astype(np.float32)
    return x, r, sc


def _torch(x, r, sc, dtype, device="cpu"):
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(r).to(device, dtype),
            torch.from_numpy(sc).to(device))


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().cpu().numpy()


@pytest.mark.parametrize("n,d,bn", [(512, 256, 128), (64, 640, 8),
                                    (256, 1024, 256)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_jax_pallas_and_ref(n, d, bn, dtype):
    jdt, tdt, atol, rtol = DTYPES[dtype]
    x, r, sc = _inputs(n + d, n, d)
    jx, jr = jnp.asarray(x).astype(jdt), jnp.asarray(r).astype(jdt)
    pallas = rmsnorm_residual_pallas(jx, jr, jnp.asarray(sc), bn=bn,
                                     interpret=True)
    want = jref(jx, jr, jnp.asarray(sc))
    got = rmsnorm_residual_ref(*_torch(x, r, sc, tdt))
    assert got[0].dtype == tdt and got[1].dtype == tdt
    for w in (pallas, want):
        for a, b in zip(got, w):
            np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol)
    # the residual sum is one rounding of an exact f32 sum: bitwise
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))


def test_cpu_dispatch_takes_the_plain_version():
    args = _torch(*_inputs(3, 37, 96), torch.float32)
    before = kernel.rmsnorm_residual_cuda.launches
    got = ops.rmsnorm_residual(*args, eps=1e-5)
    want = rmsnorm_residual_ref(*args, 1e-5)
    assert kernel.rmsnorm_residual_cuda.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_refuses_tensors_off_the_card():
    args = _torch(*_inputs(4, 4, 64), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.rmsnorm_residual_cuda(*args)
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no kernel"):
        ops.rmsnorm_residual(*meta)


def test_bound_model():
    # Yi-6B's prefill row block (2048 x 4096) in bf16: 67 MB
    assert kernel.rmsnorm_bytes(2048, 4096, 2) == 67_125_248
    assert kernel.rmsnorm_flops(4, 4096) == 5 * 4 * 4096


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(512, 256), (37, 4096), (4, 8192),
                                 (2048, 4096)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_matches_plain_on_card(cuda_device, n, d, dtype):
    _, tdt, atol, rtol = DTYPES[dtype]
    args = _torch(*_inputs(n + d, n, d, near_one=True), tdt, cuda_device)
    before = kernel.rmsnorm_residual_cuda.launches
    got = ops.rmsnorm_residual(*args)
    assert kernel.rmsnorm_residual_cuda.launches == before + 1
    want = rmsnorm_residual_ref(*args)
    torch.cuda.synchronize()
    # a bf16 output may round to the neighbouring bf16 value (2^-8
    # relative) where the two f32 sums straddle a rounding boundary
    if tdt == torch.bfloat16:
        rtol = 2.0 ** -8
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol)
