"""The port's multi-head latent attention (``models/mla.py``) and the
flash kernel's (q·k 192, v 128) pair against the JAX package, on the
CPU.

The inputs are made with numpy from a seed and go through the JAX
function and its port, f32, at ``repro.configs.smoke_config``'s MLA
sizes (q_lora 32, kv_lora 32, nope 16, rope 8, v 16: q·k over 24, v 16):

* the plain attention at Dv ≠ Dqk against the JAX model's
  ``chunked_attention``, causal and not: within 1e-6; at equal D against
  the Pallas kernel in interpret mode, as ``tests/test_torch_attention.py``
  holds it;
* ``mla_schema`` and ``mla_cache_schema`` name for name, shape for shape
  and dtype for dtype, with and without ``q_lora_rank``;
* ``apply_mla_full`` (the expanded prefill) and ``apply_mla_decode``
  (the absorbed step against the latent cache) within 1e-5 of max|y|,
  and the cache they write.

The smoke dims are not kernel shapes: the wrapper raises on them, by
design.  The tests marked ``gpu`` hold the kernel at (192, 128) and a
smoke model with DeepSeek's full head dims on the card against the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params,
    map_specs,
    tree_map,
    zeros_like_schema,
)

ARCH = "deepseek-v2-236b"
B, S = 2, 37
ATTN_ATOL = 1e-6
Y_SHARE = 1e-5


def _cfgs(q_lora=True):
    j = jsmoke_config(jget_config(ARCH))
    t = smoke_config(get_config(ARCH))
    if not q_lora:
        j = dataclasses.replace(j, mla=dataclasses.replace(j.mla,
                                                           q_lora_rank=0))
        t = dataclasses.replace(t, mla=dataclasses.replace(t.mla,
                                                           q_lora_rank=0))
    return j, t


def _qkv(seed, dqk, dv, s=S, h=4):
    """(B, S, H, ·) arrays: q and k over dqk, v over dv."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, s, h, dqk), dtype=np.float32),
            rng.standard_normal((B, s, h, dqk), dtype=np.float32),
            rng.standard_normal((B, s, h, dv), dtype=np.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_takes_a_narrower_v(causal):
    """q·k over 24, v 16 (the smoke MLA) against ``chunked_attention``,
    in 16-row query chunks over a ragged S = 37."""
    q, k, v = _qkv(3, 24, 16)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             query_chunk=16, causal=causal)
    got = ops.attention(*(torch.from_numpy(a).transpose(1, 2)
                          for a in (q, k, v)), causal=causal).transpose(1, 2)
    assert tuple(got.shape) == (B, S, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL)


def test_plain_attention_at_equal_d_matches_the_pallas_kernel():
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _qkv(4, 32, 32, s=64))
    pallas = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             bq=32, bk=32, causal=True, interpret=True)
    got = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5)


def test_the_wrapper_takes_the_mla_pair_only():
    """(192, 128) and the equal pairs; the bound model counts q·k over
    192 and p·v over 128."""
    assert (192, 128) in kernel.HEAD_DIM_PAIRS
    assert (24, 16) not in kernel.HEAD_DIM_PAIRS
    assert kernel.attention_flops(4, 128, 2048, 192, True, 128) == \
        2 * 4 * 128 * (192 + 128) * (2048 * 2049 // 2)
    assert kernel.attention_bytes(4, 128, 128, 2048, 192, 2, 128) == \
        2 * 2048 * 4 * (256 * 192 + 256 * 128)
    assert kernel.flash_smem_bytes(192, 128) == \
        1024 + 24_576 + 2 * (24_576 + 16_384)
    assert 2 * kernel.flash_smem_bytes(192, 128) <= 232_448
    q = torch.zeros((1, 2, 8, 24), device="meta")
    v = torch.zeros((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_cuda(q, q, v)


def _jschema(sch):
    return jax.tree.map(lambda s: (s.shape, jnp.dtype(s.dtype).name), sch,
                        is_leaf=lambda x: hasattr(x, "init"))


def _tschema(sch):
    return map_specs(lambda _, s: (s.shape, str(s.dtype).split(".")[-1]),
                     sch)


@pytest.mark.parametrize("q_lora", [True, False])
def test_schemas_match_jax(q_lora):
    """The smoke widths and the full ones (bf16 parameters); the cache
    holds ``ckv`` (B, Smax, kv_lora) and ``kpe`` (B, Smax, rope)."""
    jc, tc = _cfgs(q_lora)
    jf, tf = jget_config(ARCH), get_config(ARCH)
    if not q_lora:
        jf = dataclasses.replace(jf, mla=dataclasses.replace(jf.mla,
                                                             q_lora_rank=0))
        tf = dataclasses.replace(tf, mla=dataclasses.replace(tf.mla,
                                                             q_lora_rank=0))
    for j, t in ((jc, tc), (jf, tf)):
        assert _tschema(mla.mla_schema(t)) == _jschema(jmla.mla_schema(j))
        assert ("wq_a" in mla.mla_schema(t)) == q_lora
        assert _tschema(mla.mla_cache_schema(t, 3, 40)) == \
            _jschema(jmla.mla_cache_schema(j, 3, 40, False))
    full = mla.mla_cache_schema(get_config(ARCH), 4, 2080)
    assert full["ckv"].shape == (4, 2080, 512)
    assert full["kpe"].shape == (4, 2080, 64)


def _layer(q_lora, seed=0):
    jc, tc = _cfgs(q_lora)
    jp = jinit_params(jmla.mla_schema(jc), jax.random.key(seed))
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    return jc, jp, tc, tp


def _close(got, want, share=Y_SHARE):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= share * float(
        np.abs(want).max()), float(np.abs(got - want).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_lora", [True, False])
def test_apply_mla_full_matches_jax(q_lora, causal):
    jc, jp, tc, tp = _layer(q_lora)
    x = np.random.default_rng(5).standard_normal((B, S, tc.d_model),
                                                 dtype=np.float32)
    jy, jcache = jmla.apply_mla_full(
        jc, jp, jnp.asarray(x), rope_cs=JM.rope_full(jc, S), causal=causal,
        return_cache=True)
    cache = zeros_like_schema(mla.mla_cache_schema(tc, B, S + 3), "cpu")
    ty = mla.apply_mla_full(tc, tp, torch.from_numpy(x),
                            rope_cs=M.rope_full(tc, S, "cpu"),
                            causal=causal, cache=cache)
    _close(ty, jy)
    for name in ("ckv", "kpe"):
        _close(cache[name][:, :S], jcache[name])
        assert not cache[name][:, S:].any()


@pytest.mark.parametrize("q_lora", [True, False])
def test_apply_mla_decode_matches_jax(q_lora):
    """Three absorbed steps against a latent cache of 40 positions
    filled by a prefill of 37: outputs and the cache."""
    jc, jp, tc, tp = _layer(q_lora, seed=1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, tc.d_model), dtype=np.float32)
    smax = S + 3
    _, jc0 = jmla.apply_mla_full(jc, jp, jnp.asarray(x),
                                 rope_cs=JM.rope_full(jc, S),
                                 return_cache=True)
    jcache = jax.tree.map(lambda a: jnp.pad(a, ((0, 0), (0, 3), (0, 0))),
                          jc0)
    cache = zeros_like_schema(mla.mla_cache_schema(tc, B, smax), "cpu")
    mla.apply_mla_full(tc, tp, torch.from_numpy(x),
                       rope_cs=M.rope_full(tc, S, "cpu"), cache=cache)
    for pos in range(S, smax):
        xt = rng.standard_normal((B, tc.d_model), dtype=np.float32)
        jy, jcache = jmla.apply_mla_decode(
            jc, jp, jnp.asarray(xt), jcache, jnp.asarray(pos, jnp.int32),
            rope_cs=JM.rope_decode(jc, jnp.asarray(pos, jnp.int32)))
        ty = mla.apply_mla_decode(tc, tp, torch.from_numpy(xt), cache, pos,
                                  rope_cs=M.rope_decode(tc, pos, "cpu"))
        _close(ty, jy)
    for name in ("ckv", "kpe"):
        _close(cache[name], jcache[name])


def test_rope_rotates_the_rope_head_only():
    """Under MLA, RoPE's cos/sin are for the 8-wide (smoke) rope head,
    the JAX package's ``_rope_dim``."""
    _, tc = _cfgs()
    cos, _ = M.rope_full(tc, 5, "cpu")
    assert tuple(cos.shape) == (1, 5, 1, tc.mla.qk_rope_head_dim // 2)
    jcos, _ = JM.rope_full(jsmoke_config(jget_config(ARCH)), 5)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_at_192_128_matches_plain(cuda_device, dtype, atol, causal):
    """H = KH = 16, ragged S = 130, v the strided half of a (B, S, H,
    256) product, as MLA passes it."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k = (torch.randn((2, 130, 16, 192), generator=g, device=cuda_device)
            .to(dtype).transpose(1, 2) for _ in range(2))
    v = torch.randn((2, 130, 16, 256), generator=g, device=cuda_device) \
        .to(dtype)[..., 128:].transpose(1, 2)
    before = kernel.flash_attention_cuda.launches
    got = ops.attention(q, k, v, causal=causal)
    assert kernel.flash_attention_cuda.launches == before + 1
    want = attention_ref(q, k, v, causal=causal)
    assert tuple(got.shape) == (2, 16, 130, 128)
    assert float((got.float() - want.float()).abs().max()) <= atol


@pytest.mark.gpu
def test_full_head_dims_on_card_match_cpu(cuda_device):
    """A smoke DeepSeek-V2 whose MLA has the full head dims (nope 128,
    rope 64, v 128, 4 heads), f32 (no TF32): the card's kernels against
    the CPU's plain versions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t = smoke_config(get_config(ARCH))
    tc = dataclasses.replace(t, mla=dataclasses.replace(
        t.mla, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128))
    tp = init_params(M.schema(tc), torch.Generator().manual_seed(0), "cpu")
    gp = tree_map(lambda a: a.to(cuda_device), tp)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab_size, (B, 70)))
    want = serve.serve(tc, tp, toks, 4)
    got = serve.serve(tc, gp, toks.to(cuda_device), 4)
    for g, w in ((got.first_logits, want.first_logits),
                 (got.last_logits, want.last_logits)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4)
    assert torch.equal(got.tokens.cpu(), want.tokens)
    assert got.launches["prefill"] == M.launches_per_pass(tc, "prefill")
