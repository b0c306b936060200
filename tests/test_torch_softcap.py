"""The attention logit soft-cap in the port against the JAX package's.

``ModelConfig.attn_logit_softcap > 0`` caps every scaled score to
``cap·tanh(s/cap)`` before the mask (``repro.models.attention.
_softcap``).  The same inputs, made with numpy from a seed, go through
both packages on the CPU, where the port runs the flash kernel's plain
version:

* ``attention_ref(softcap=)`` against ``chunked_attention(softcap=)``
  within 2e-5 in f32 (the JAX package's f32 tolerance for attention),
  causal and not, GQA, Sq ≠ Sk, ``query_chunk`` < S with padding; each
  cap moves the output by more than 100× that tolerance, so a dropped
  cap, or one taken after the mask, fails;
* ``apply_attn_full``, ``apply_attn_decode`` and ``apply_cross_attn``
  within 1e-5·max|out| (``tests/test_torch_whisper.py``'s bound for a
  layer), prefill and decode logits of the capped smoke Yi-6B (2
  layers, within 1e-4 and the same greedy tokens, as
  ``tests/test_torch_serve.py``) and whisper (within 1e-4·max|logit|,
  as ``tests/test_torch_whisper.py``), Yi-6B's loss (1e-5 relative) and
  every gradient leaf (1e-4·max|g|, as ``tests/test_torch_train.py``)
  against ``jax.grad``;
* the DTensor branch (``kernels/local.py::attention_local``) on a
  one-rank gloo mesh bitwise the plain version, and the registered op's
  fake implementation on fake CUDA tensors.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import dense_blocks as jdense_blocks  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import RunConfig, get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import dense_blocks  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fo  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import serve_step  # noqa: E402
from repro_torch.runtime import train_step as TS  # noqa: E402

ATOL = 2e-5
#: the cap must move the output by this many tolerances
BITE = 100
LAYER_SHARE = 1e-5
LOGIT_ATOL = 1e-4
LOGIT_SHARE = 1e-4
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4
#: the models' cap: the init rule's near one-hot attention scores reach
#: tens, so 5 bites at every layer
MODEL_CAP = 5.0

#: (label, B, H, KH, Sq, Sk, D, causal, query_chunk)
CASES = [
    ("causal GQA", 2, 4, 2, 48, 48, 16, True, 64),
    ("not causal", 1, 2, 2, 40, 40, 32, False, 64),
    ("Sq != Sk", 2, 4, 2, 7, 33, 16, False, 64),
    ("causal, query_chunk < S, padded", 1, 4, 1, 50, 50, 16, True, 16),
    ("Sq != Sk, query_chunk < S, padded", 2, 4, 4, 21, 30, 16, False, 8),
]


def _inputs(seed, b, h, kh, sq, sk, d, gain=3.0):
    """q, k, v in the model's (B, S, heads, D) layout; q times ``gain``,
    so the scaled scores spread to a few units and a cap of 5 bites."""
    rng = np.random.default_rng(seed)
    q = gain * rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, kh, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, kh, d), dtype=np.float32)
    return q, k, v


def _heads_first(*arrays):
    return [torch.from_numpy(a).transpose(1, 2) for a in arrays]


@pytest.mark.parametrize("cap", [5.0, 50.0])
@pytest.mark.parametrize("label,b,h,kh,sq,sk,d,causal,qc", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_softcap_matches_chunked_attention(label, b, h, kh, sq, sk, d,
                                                 causal, qc, cap):
    gain = 3.0 if cap < 10 else 12.0
    q, k, v = _inputs(sq + 31 * h, b, h, kh, sq, sk, d, gain)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), query_chunk=qc,
                                causal=causal, softcap=cap)
    tq, tk, tv = _heads_first(q, k, v)
    got = attention_ref(tq, tk, tv, causal=causal, softcap=cap)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, sq, d)
    got = got.transpose(1, 2).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    free = attention_ref(tq, tk, tv, causal=causal).transpose(1, 2).numpy()
    moved = float(np.abs(free - got).max())
    assert moved > BITE * ATOL, f"the cap moves the output by {moved} only"


def test_plain_softcap_masks_after_the_cap():
    """A masked key stays out: capped before the mask, -1e30 stays; the
    cap of the mask (-cap) would let the future keys back in."""
    q, k, v = _heads_first(*_inputs(3, 1, 2, 2, 16, 16, 16))
    got = attention_ref(q, k, v, causal=True, softcap=2.0)
    # the first query sees only the first key
    assert torch.allclose(got[:, :, 0], v[:, :, 0], atol=1e-6)


def test_plain_softcap_of_zero_is_no_cap():
    q, k, v = _heads_first(*_inputs(4, 2, 4, 2, 24, 24, 16))
    assert torch.equal(attention_ref(q, k, v, softcap=0.0),
                       attention_ref(q, k, v))


def test_function_backward_is_the_capped_plain_gradient():
    """``FlashAttention`` with the plain forward in the kernel's place:
    its backward is autograd through the capped plain version."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(3 * rng.standard_normal(s)).requires_grad_()
               for s in ((1, 4, 6, 8), (1, 2, 6, 8), (1, 2, 6, 8)))
    assert torch.autograd.gradcheck(
        lambda *a: fo.FlashAttention.apply(
            *a, True, lambda q, k, v, c: attention_ref(
                q, k, v, causal=c, softcap=2.0), 2.0),
        (q, k, v))
    # and not the uncapped gradient
    g1 = torch.autograd.grad(fo.FlashAttention.apply(
        q, k, v, True, lambda q, k, v, c: attention_ref(
            q, k, v, causal=c, softcap=2.0), 2.0).sum(), q)[0]
    g0 = torch.autograd.grad(attention_ref(q, k, v).sum(), q)[0]
    assert float((g1 - g0).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# the model's layers and the capped smoke models
# ---------------------------------------------------------------------------


def _capped(cfg, cap=MODEL_CAP):
    return dataclasses.replace(cfg, attn_logit_softcap=cap)


def _yi(dtype="float32", layers=2):
    j = dataclasses.replace(jsmoke_config(jget_config("yi-6b")),
                            num_layers=layers, blocks=jdense_blocks(layers),
                            compute_dtype=dtype)
    t = dataclasses.replace(smoke_config(get_config("yi-6b")),
                            num_layers=layers, blocks=dense_blocks(layers),
                            compute_dtype=dtype)
    return _capped(j), _capped(t)


@pytest.fixture(scope="module")
def yi():
    jc, tc = _yi()
    jp = jinit_params(JM.schema(jc), jax.random.key(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


@pytest.fixture(scope="module")
def whisper():
    arch = "whisper-large-v3"
    jc = _capped(jsmoke_config(jget_config(arch)))
    tc = _capped(smoke_config(get_config(arch)))
    jp = jinit_params(JM.schema(jc), jax.random.key(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def _share(got, want, share):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    diff = float(np.abs(got - want).max())
    assert diff <= share * float(np.abs(want).max()), diff
    return diff


def _layer0(tree):
    return tree[0] if isinstance(tree, torch.Tensor) else {
        k: _layer0(v) for k, v in tree.items()}


def test_attention_layers_match_jax(yi, whisper):
    """``apply_attn_full`` (causal, with RoPE) and ``apply_attn_decode``
    of Yi-6B's first layer, ``apply_cross_attn`` in prefill and decode
    of whisper's: each within 1e-5·max|out| of the JAX layer, and each
    more than 100× that away from the uncapped layer."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    jc, jp, tc, tp = yi
    jl = jax.tree.map(lambda a: a[0], jp["b0"])["l0"]["mixer"]
    tl = _layer0(tp["b0"])["l0"]["mixer"]
    rng = np.random.default_rng(1)
    S = 20
    x = rng.standard_normal((2, S, tc.d_model), dtype=np.float32)
    jcs = JL.rope_cos_sin(jnp.arange(S), tc.head_dim, jc.rope_theta)
    tcs = TL.rope_cos_sin(torch.arange(S), tc.head_dim, tc.rope_theta)
    want, jcache = JA.apply_attn_full(
        jc, jl, jnp.asarray(x), rope_cs=(jcs[0][:, None], jcs[1][:, None]),
        return_cache=True)
    cache = {n: torch.zeros((2, S + 1, tc.num_kv_heads, tc.head_dim))
             for n in ("k", "v")}
    trope = (tcs[0][:, None], tcs[1][:, None])
    got = TA.apply_attn_full(tc, tl, torch.from_numpy(x), rope_cs=trope,
                             cache=cache)
    tol = _share(got, want, LAYER_SHARE)
    free = TA.apply_attn_full(_capped(tc, 0.0), tl, torch.from_numpy(x),
                              rope_cs=trope)
    assert float((free - got).abs().max()) > BITE * max(tol, 1e-7)

    # one decode step at position S against the filled cache
    xd = rng.standard_normal((2, tc.d_model), dtype=np.float32)
    jcs = JL.rope_cos_sin(jnp.arange(S, S + 1), tc.head_dim, jc.rope_theta)
    tcs = TL.rope_cos_sin(torch.arange(S, S + 1), tc.head_dim,
                          tc.rope_theta)
    jfull = {n: jnp.pad(jcache[n], ((0, 0), (0, 1), (0, 0), (0, 0)))
             for n in ("k", "v")}
    want, _ = JA.apply_attn_decode(
        jc, jl, jnp.asarray(xd), jfull, jnp.asarray(S, jnp.int32),
        rope_cs=(jcs[0][None], jcs[1][None]))
    saved = tree_map(lambda t: t.clone(), cache)
    got = TA.apply_attn_decode(tc, tl, torch.from_numpy(xd), cache, S,
                               rope_cs=(tcs[0][None], tcs[1][None]))
    tol = _share(got, want, LAYER_SHARE)
    free = TA.apply_attn_decode(_capped(tc, 0.0), tl, torch.from_numpy(xd),
                                saved, S, rope_cs=(tcs[0][None],
                                                   tcs[1][None]))
    assert float((free - got).abs().max()) > BITE * max(tol, 1e-7)

    jc, jp, tc, tp = whisper
    jx = jax.tree.map(lambda a: a[0], jp["b0"])["l0"]["cross"]
    tx = _layer0(tp["b0"])["l0"]["cross"]
    enc = rng.standard_normal((2, tc.encoder_frames, tc.d_model),
                              dtype=np.float32)
    jkv = JA.cross_kv(jc, jx, jnp.asarray(enc))
    tkv = TA.cross_kv(tc, tx, torch.from_numpy(enc))
    for shape in ((2, 5, tc.d_model), (2, tc.d_model)):
        x = rng.standard_normal(shape, dtype=np.float32)
        want = JA.apply_cross_attn(jc, jx, jnp.asarray(x), jkv)
        got = TA.apply_cross_attn(tc, tx, torch.from_numpy(x), tkv)
        tol = _share(got, want, LAYER_SHARE)
        free = TA.apply_cross_attn(_capped(tc, 0.0), tx, torch.from_numpy(x),
                                   tkv)
        assert float((free - got).abs().max()) > BITE * max(tol, 1e-7)


def test_yi_prefill_and_decode_match_jax(yi):
    """Prefill S − 1 tokens into a cache of S + STEPS, then STEPS greedy
    decode steps: logits within 1e-4, the same tokens."""
    jc, jp, tc, tp = yi
    S, STEPS = 24, 4
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, (2, S - 1))
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)},
                            max_seq=S + STEPS)
    tl, tcache = serve_step.build_prefill(tc, max_seq=S + STEPS)(
        tp, {"tokens": torch.from_numpy(toks)})
    free, _ = serve_step.build_prefill(_capped(tc, 0.0), max_seq=S + STEPS)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert float((free - tl).abs().max()) > BITE * LOGIT_ATOL
    decode = serve_step.build_decode(tc)
    for i in range(STEPS + 1):
        jl = np.asarray(jl, np.float32)
        np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_ATOL)
        jt = np.argmax(jl, -1)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jt)
        if i == STEPS:
            break
        jl, jcache = JM.decode_step(
            jc, jp, jcache, {"token": jnp.asarray(jt, jnp.int32),
                             "pos": jnp.asarray(S - 1 + i, jnp.int32)})
        tl, tcache = decode(tp, tcache, {"token": torch.from_numpy(jt),
                                         "pos": S - 1 + i})


def test_whisper_prefill_and_decode_match_jax(whisper):
    """The capped whisper smoke: its encoder (not causal), decoder
    (causal) and cross-attention all capped; logits within
    1e-4·max|logit| and the same greedy tokens over 4 decode steps."""
    jc, jp, tc, tp = whisper
    S, STEPS = 12, 4
    rng = np.random.default_rng(11)
    toks = rng.integers(0, tc.vocab_size, (2, S - 1))
    enc = rng.standard_normal((2, tc.encoder_frames, tc.d_model),
                              dtype=np.float32)
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks),
                                     "enc_embeds": jnp.asarray(enc)},
                            max_seq=S + STEPS)
    tl, tcache = serve_step.build_prefill(tc, max_seq=S + STEPS)(
        tp, {"tokens": torch.from_numpy(toks),
             "enc_embeds": torch.from_numpy(enc)})
    decode = serve_step.build_decode(tc)
    for i in range(STEPS + 1):
        jl = np.asarray(jl, np.float32)
        _share(tl, jl, LOGIT_SHARE)
        jt = np.argmax(jl, -1)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jt)
        if i == STEPS:
            break
        jl, jcache = JM.decode_step(
            jc, jp, jcache, {"token": jnp.asarray(jt, jnp.int32),
                             "pos": jnp.asarray(S - 1 + i, jnp.int32)})
        tl, tcache = decode(tp, tcache, {"token": torch.from_numpy(jt),
                                         "pos": S - 1 + i})


def test_yi_loss_and_grads_match_jax():
    """The capped smoke Yi-6B's loss and every gradient leaf against
    ``jax.grad`` on the same batch (f32 parameters, as training keeps
    them)."""
    from repro.configs.shapes import SMOKE_SHAPES as JSMOKE_SHAPES
    from repro.data.pipeline import SyntheticLMPipeline as JPipeline

    jc, tc = _yi()
    jp = jinit_params(JM.schema(jc), jax.random.key(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu",
                           train=True)
    shape = JSMOKE_SHAPES["train_4k"]
    jb = JPipeline(jc, shape).batch_at(0)
    tb = SyntheticLMPipeline(tc, shape).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jc, p, b, loss_chunk=16), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in jb.items()})
    tl, _, tg = TS.loss_and_grads(tc, RunConfig(loss_chunk=16), tp, tb)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    _, _, fg = TS.loss_and_grads(_capped(tc, 0.0), RunConfig(loss_chunk=16),
                                 tp, tb)
    gl, wl, fl = tree_leaves(tg), jax.tree.leaves(jg), tree_leaves(fg)
    assert len(gl) == len(wl) == len(fl)
    moved = 0.0
    for g, w, f in zip(gl, wl, fl):
        w, g = np.asarray(w, np.float64), g.numpy().astype(np.float64)
        scale = float(np.abs(w).max())
        diff = float(np.abs(g - w).max())
        assert diff <= GRAD_SHARE * scale, diff
        moved = max(moved, float(np.abs(f.numpy() - g).max()) / scale)
    assert moved > BITE * GRAD_SHARE, moved


# ---------------------------------------------------------------------------
# the DTensor branch and the registered op
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_mesh():
    assert not dist.is_initialized()
    mesh = tmesh.make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_dtensor_branch_caps_each_shard(host_mesh):
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    q, k, v = (t.contiguous() for t in _heads_first(
        *_inputs(6, 2, 4, 2, 12, 12, 16)))
    rep = (Replicate(),) * host_mesh.ndim
    dq, dk, dv = (distribute_tensor(t.clone().requires_grad_(), host_mesh,
                                    rep) for t in (q, k, v))
    out = fo.attention(dq, dk, dv, causal=True, softcap=5.0)
    assert isinstance(out, DTensor)
    want = attention_ref(q, k, v, causal=True, softcap=5.0)
    assert torch.equal(out.full_tensor(), want)
    assert not torch.equal(want, attention_ref(q, k, v, causal=True))
    g, = torch.autograd.grad(out.sum(), dq)
    pq = q.clone().requires_grad_()
    wg, = torch.autograd.grad(
        attention_ref(pq, k, v, causal=True, softcap=5.0).sum(), pq)
    assert torch.equal(g.full_tensor(), wg)


def _fake_cuda(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="cuda")


def test_op_fake_output_and_cap_checks():
    """The registered op with a cap: its fake output is the uncapped
    call's (shape, strides, dtype), its FLOPs the uncapped formula's; a
    negative or non-finite cap is refused before any launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import op_cost

    with FakeTensorMode():
        q = _fake_cuda(2, 8, 128, 128)
        k, v = _fake_cuda(2, 2, 128, 128), _fake_cuda(2, 2, 128, 128)
        with op_cost.OpCostMode() as m:
            out = fk.flash_attention_op(q, k, v, True, 50.0)
        free = fk.flash_attention_op(q, k, v, True)
        via = fo.attention(q, k, v, causal=True, softcap=50.0)
        for bad in (-1.0, float("inf"), float("nan")):
            with pytest.raises(ValueError, match="softcap"):
                fk.flash_attention_op(q, k, v, True, bad)
    for o in (out, via):
        assert o.shape == free.shape == (2, 8, 128, 128)
        assert o.stride() == free.stride() == (131072, 128, 1024, 1)
        assert o.dtype == torch.bfloat16
    assert m.flops == fk.attention_flops(2, 8, 128, 128, True)
