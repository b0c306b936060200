"""The port's attention against the JAX package's.

The plain version (``repro_torch.kernels.flash_attention.ref``) must
match the JAX package's Pallas flash kernel in interpret mode and its
reference on the same seeded inputs, within the JAX package's own
tolerances (``tests/test_kernels.py``: atol 2e-5 for f32, 3e-2 for
bf16), and the JAX model's XLA ``chunked_attention`` at a ragged length
that the TPU kernel cannot take.  The CUDA kernel is held to the plain
version on the card (marked ``gpu``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jref  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
SHAPES = [(2, 4, 2, 256, 64, 128, 128), (1, 8, 8, 128, 128, 64, 64),
          (2, 4, 1, 64, 32, 32, 32), (1, 2, 2, 512, 64, 128, 256)]


def _inputs(seed, b, h, kh, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d), dtype=np.float32),
            rng.standard_normal((b, kh, s, d), dtype=np.float32),
            rng.standard_normal((b, kh, s, d), dtype=np.float32))


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().cpu().numpy()


@pytest.mark.parametrize("B,H,KH,S,D,bq,bk", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_jax_flash_and_ref(B, H, KH, S, D, bq, bk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(S + H, B, H, KH, S, D)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    pallas = flash_attention(jq, jk, jv, bq=bq, bk=bk, causal=True,
                             interpret=True)
    want = jref(jq, jk, jv, causal=True)
    got = attention_ref(*(torch.from_numpy(a).to(tdt) for a in arrays),
                        causal=True)
    assert got.dtype == tdt and tuple(got.shape) == (B, H, S, D)
    for w in (pallas, want):
        np.testing.assert_allclose(_np(got), _np(w), atol=tol)


def test_plain_matches_jax_non_causal():
    arrays = _inputs(0, 1, 2, 2, 128, 64)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    pallas = flash_attention(jq, jk, jv, bq=64, bk=64, causal=False,
                             interpret=True)
    got = attention_ref(*(torch.from_numpy(a) for a in arrays),
                        causal=False)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_chunked_attention_at_ragged_length(causal):
    """S=37 with 16-row query chunks: the JAX model pads the last chunk;
    the port's kernel masks the ragged edge.  Layouts: (B,S,H,D) in the
    model, (B,H,S,D) in the kernel."""
    q, k, v = _inputs(37, 2, 4, 2, 37, 16)
    want = chunked_attention(*(jnp.asarray(a.transpose(0, 2, 1, 3))
                               for a in (q, k, v)),
                             query_chunk=16, causal=causal)
    got = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=causal)
    np.testing.assert_allclose(_np(got).transpose(0, 2, 1, 3), _np(want),
                               atol=2e-5)


@pytest.mark.parametrize("sq,sk", [(7, 65), (128, 37), (1, 16), (40, 40)])
def test_plain_matches_chunked_attention_across_lengths(sq, sk):
    """Cross-attention: Sq decoder queries against Sk encoder frames,
    not causal, as the JAX model's ``apply_cross_attn`` calls
    ``chunked_attention`` (16-row query chunks, the last padded), at
    whisper's head dim 64 with KH < H."""
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.standard_normal((2, sq, 4, 64), dtype=np.float32)
    k, v = (rng.standard_normal((2, sk, 2, 64), dtype=np.float32)
            for _ in range(2))
    want = chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             query_chunk=16, causal=False)
    got = ops.attention(*(torch.from_numpy(a).transpose(1, 2)
                          for a in (q, k, v)), causal=False)
    assert tuple(got.shape) == (2, 4, sq, 64)
    np.testing.assert_allclose(_np(got).transpose(0, 2, 1, 3), _np(want),
                               atol=2e-5)


def test_causal_needs_equal_lengths():
    q, k, v = (torch.zeros((1, 2, n, 64)) for n in (8, 12, 12))
    with pytest.raises(ValueError, match="as many keys as queries"):
        ops.attention(q, k, v, causal=True)


def test_cpu_dispatch_takes_the_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(5, 1, 4, 2, 40, 64)]
    qv = args[0].transpose(1, 2).contiguous().transpose(1, 2)  # strided
    before = kernel.flash_attention_cuda.launches
    got = ops.attention(qv, *args[1:], causal=True)
    assert kernel.flash_attention_cuda.launches == before
    assert torch.equal(got, attention_ref(*args, causal=True))


def test_kernel_refuses_tensors_off_the_card():
    args = [torch.from_numpy(a) for a in _inputs(6, 1, 2, 1, 8, 64)]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_cuda(*args)
    with pytest.raises(ValueError, match="no kernel"):
        ops.attention(*(a.to("meta") for a in args))


def test_bound_model():
    # Yi-6B prefill (B=4, H=32, KH=4, S=512, D=128), causal, bf16
    assert kernel.attention_flops(4, 32, 512, 128, True) == \
        4 * 4 * 32 * 128 * (512 * 513 // 2)
    assert kernel.attention_flops(1, 1, 8, 64, False) == 4 * 64 * 64
    assert kernel.attention_bytes(4, 32, 4, 512, 128, 2) == \
        2 * 512 * 128 * 4 * (2 * 32 + 2 * 4)
    # whisper's cross-attention: 128 queries against 1500 frames, MHA
    assert kernel.attention_flops(8, 20, 128, 64, False, sk=1500) == \
        4 * 8 * 20 * 64 * 128 * 1500
    assert kernel.attention_bytes(8, 20, 20, 128, 64, 2, sk=1500) == \
        2 * 8 * 20 * 2 * 64 * (128 + 1500)


@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_bf16_shared_memory_plan_fits_a_block(D):
    """The bf16 CTA's Q tile and K/V ring fit the 227 KB a Hopper block
    may use (232,448 bytes), twice over: 2 CTAs share an SM."""
    got = kernel.flash_smem_bytes(D)
    assert got == 1024 + (1 + 2 * kernel.STAGES) * 64 * D * 2
    assert 2 * got <= 232_448


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,S,D", [(2, 4, 2, 256, 64), (1, 8, 8, 128, 128),
                                        (1, 4, 2, 300, 128), (1, 2, 1, 1, 64),
                                        (2, 8, 2, 77, 64), (2, 4, 2, 64, 32),
                                        (2, 4, 2, 64, 128), (2, 4, 2, 1, 32),
                                        (1, 4, 2, 1, 128)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, B, H, KH, S, D, dtype,
                                     causal):
    _, tdt, tol = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(cuda_device, tdt)
               for a in _inputs(S + D, B, H, KH, S, D))
    want = attention_ref(q, k, v, causal=causal)
    before = kernel.flash_attention_cuda.launches
    got = ops.attention(q, k, v, causal=causal)
    assert kernel.flash_attention_cuda.launches == before + 1
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


@pytest.mark.gpu
def test_kernel_reads_the_models_layout_in_place(cuda_device):
    """(B,S,H,D) projections go in as transposed views; the output is
    (B,H,S,D) laid out as (B,S,H,D)."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               .transpose(1, 2).contiguous().transpose(1, 2)
               for a in _inputs(9, 2, 8, 2, 96, 128))
    got = ops.attention(q, k, v, causal=True)
    assert got.transpose(1, 2).is_contiguous()
    want = attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2)


@pytest.mark.gpu
def test_kernel_refuses_strides_off_16_bytes(cuda_device):
    """The bf16 kernel copies 16-byte pieces of rows: a row stride of
    (D + 2) * 2 bytes is refused before anything launches."""
    base = torch.zeros((1, 4, 64, 66), dtype=torch.bfloat16,
                       device=cuda_device)
    q = base[..., :64]
    k, v = (torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16,
                        device=cuda_device) for _ in range(2))
    before = kernel.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="multiples of 16"):
        kernel.flash_attention_cuda(q, k, v)
    assert kernel.flash_attention_cuda.launches == before


@pytest.mark.gpu
def test_kernel_refuses_causal_across_lengths(cuda_device):
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, device=cuda_device)
    k = torch.zeros((1, 2, 12, 64), dtype=torch.bfloat16, device=cuda_device)
    before = kernel.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="as many keys as queries"):
        kernel.flash_attention_cuda(q, k, k, causal=True)
    assert kernel.flash_attention_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H,KH,Sq,Sk", [(8, 20, 20, 128, 1500),
                                          (2, 4, 4, 7, 65)])
def test_kernel_matches_plain_across_lengths(cuda_device, B, H, KH, Sq, Sk,
                                             dtype):
    """whisper's cross-attention on the card: the decoder's queries and
    the (B, F, KH, D) cross cache as the model's transposed views, not
    causal, the last key tile ragged."""
    _, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(Sq + Sk)
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, 64),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, KH, 64),
                                                 dtype=np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda_device, tdt).transpose(1, 2) for t in (q, k, v))
    want = attention_ref(q, k, v, causal=False)
    before = kernel.flash_attention_cuda.launches
    got = ops.attention(q, k, v, causal=False)
    assert kernel.flash_attention_cuda.launches == before + 1
    assert tuple(got.shape) == (B, H, Sq, 64)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
