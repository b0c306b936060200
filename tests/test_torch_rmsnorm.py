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


# ---------------------------------------------------------------------------
# the launch shape (pure Python: the kernel runs only on the card)
# ---------------------------------------------------------------------------


def _widths():
    from repro_torch.configs import REGISTRY, smoke_config

    return sorted({c.d_model for c in REGISTRY.values()}
                  | {smoke_config(c).d_model for c in REGISTRY.values()})


#: the row widths every shape test takes: the configs' and smoke widths,
#: the tests' and the smoke's, a width no vector divides, the widest
SHAPE_WIDTHS = sorted({*_widths(), 96, 256, 640, 37, 4100, 4097, 16384})


def _columns(shape, d):
    """The columns the kernel's threads own under ``shape``, in the
    source's map: access j = k·tpr + thread, kept while j < d / vec,
    columns j·vec ... j·vec + vec − 1."""
    vec, nv, tpr = shape["vec"], shape["nv"], shape["tpr"]
    j = (np.arange(nv)[:, None] * tpr + np.arange(tpr)).ravel()
    j = j[j < d // vec]
    return (j[:, None] * vec + np.arange(vec)).ravel()


def _instantiations():
    """(16-byte path?, nv) of every kernel instantiation the source's
    dispatch launches, read from its text."""
    import re

    text = (kernel.build.KERNELS / "rmsnorm" / "csrc"
            / "rmsnorm_residual.cu").read_text()
    return {(v == "V", int(nv)) for v, nv in re.findall(
        r"return launch<T, (V|1), (\d+)>", text)}


def test_the_python_constants_name_the_sources_instantiations():
    inst = _instantiations()
    assert {nv for v, nv in inst if v} == set(kernel.VECTOR_NV)
    assert {nv for v, nv in inst if not v} == set(kernel.SCALAR_NV)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", SHAPE_WIDTHS)
def test_launch_shape_covers_each_column_once(d, dtype, aligned):
    tdt = DTYPES[dtype][1]
    inst = _instantiations()
    vec16 = 16 // tdt.itemsize
    for n in (1, 4, 37, 131, 132, 2048, 8192):
        shape = kernel.launch_shape(n, d, tdt, aligned)
        vector = aligned and d % vec16 == 0
        assert shape["vec"] == (vec16 if vector else 1)
        assert (vector, shape["nv"]) in inst
        # a bf16 row of MAX_D takes 4 accesses (the source has no 8)
        assert shape["nv"] <= kernel.TARGET_NV or tdt == torch.float32 \
            or not vector
        cols = _columns(shape, d)
        assert len(cols) == d and np.array_equal(np.sort(cols),
                                                 np.arange(d))
        # whole warps, no more than a CTA holds
        tpr, rows = shape["tpr"], shape["rows"]
        assert tpr % 32 == 0 and tpr * rows <= kernel.MAX_THREADS
        assert shape["warps"] == tpr // 32
        assert shape["grid"] == -(-n // rows)
        assert shape["smem_bytes"] == rows * (tpr // 32) * 4
        if n < kernel.SMS:
            assert rows == 1
        # the row's sum in one order whatever the number of rows
        assert {k: shape[k] for k in ("vec", "nv", "tpr")} == {
            k: kernel.launch_shape(1, d, tdt, aligned)[k]
            for k in ("vec", "nv", "tpr")}


def test_launch_shape_by_width():
    """The rule's choices at the widths the models run, bf16 aligned:
    4 accesses of 16 bytes a thread, the fewest warps that hold the row,
    several narrow rows a CTA in prefill, one row a CTA in decode."""
    bf = torch.bfloat16

    def pick(n, d, dtype=bf, aligned=True):
        s = kernel.launch_shape(n, d, dtype, aligned)
        return s["vec"], s["nv"], s["tpr"], s["rows"]

    assert pick(8192, 1024) == (8, 4, 32, 8)
    assert pick(4, 1024) == (8, 4, 32, 1)
    assert pick(4, 64) == (8, 1, 32, 1)
    assert pick(2048, 4096) == (8, 4, 128, 2)
    assert pick(8192, 5120) == (8, 4, 160, 1)
    assert pick(8192, 7168) == (8, 4, 224, 1)
    assert pick(8192, 8192) == (8, 4, 256, 1)
    assert pick(4, 8192, torch.float32) == (4, 4, 512, 1)
    assert pick(1, 16384, torch.float32) == (4, 8, 512, 1)
    # the scalar path: a width no vector divides, or an unaligned pointer
    assert pick(37, 4100) == (1, 16, 288, 1)
    assert pick(2048, 4096, aligned=False) == (1, 8, 512, 1)
    assert kernel.launch_shape(4, 16385, bf, True) is None


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_unaligned_inputs_take_the_scalar_path(dtype):
    """The wrapper reads alignment off the five pointers: any one of
    them an element off 16 bytes takes the one-element accesses."""
    tdt = DTYPES[dtype][1]
    n, d = 4, 4096
    tensors = [torch.empty(n, d, dtype=tdt), torch.empty(n, d, dtype=tdt),
               torch.empty(d), torch.empty(n, d, dtype=tdt),
               torch.empty(n, d, dtype=tdt)]
    assert all(t.data_ptr() % 16 == 0 for t in tensors)
    assert kernel.shape_for(*tensors)["vec"] == 16 // tdt.itemsize
    for i, t in enumerate(tensors):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype)
        moved = list(tensors)
        moved[i] = buf[1:].view(t.shape)
        shape = kernel.shape_for(*moved)
        assert shape["vec"] == 1 and shape["nv"] == 8, i


@pytest.mark.parametrize("d", [16385, 32768])
def test_check_args_refuses_rows_wider_than_the_registers_hold(d):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(4, d, dtype=torch.bfloat16, device="cuda")
        sc = torch.empty(d, device="cuda")
        with pytest.raises(ValueError, match=f"at most {kernel.MAX_D}"):
            kernel.check_args(x, x, sc)
        with pytest.raises(ValueError, match="at most"):
            kernel.rmsnorm_residual_op(x, x, sc, 1e-5)
        x = torch.empty(4, kernel.MAX_D, dtype=torch.bfloat16,
                        device="cuda")
        kernel.check_args(x, x, torch.empty(kernel.MAX_D, device="cuda"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,offset", [
    (512, 256, 0), (37, 4096, 0), (4, 8192, 0), (2048, 4096, 0),
    (8192, 1024, 0), (8192, 8192, 0), (4, 1024, 0), (4, 4096, 0),
    (4, 5120, 0), (4, 7168, 0), (1, 8192, 0), (37, 4100, 0),
    (37, 4096, 1)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_matches_plain_on_card(cuda_device, n, d, offset, dtype):
    """The smoke's shapes; ``offset`` elements into a buffer puts x off
    16-byte alignment (the scalar path)."""
    _, tdt, atol, rtol = DTYPES[dtype]
    args = _torch(*_inputs(n + d, n, d, near_one=True), tdt, cuda_device)
    if offset:
        buf = torch.empty(n * d + offset, dtype=tdt, device=cuda_device)
        buf[offset:] = args[0].reshape(-1)
        args = (buf[offset:].view(n, d), *args[1:])
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
    assert torch.equal(got[1], want[1])
    vec = kernel.rmsnorm_residual_cuda.last_launch["vec"]
    assert (vec > 1) == (not offset and d % (16 // tdt.itemsize) == 0)
