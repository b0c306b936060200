"""The port's whisper-large-v3 (an encoder over stub frame embeddings,
layernorm, sinusoidal positions, a decoder with cross-attention) against
the JAX package's model, on the CPU.

The smoke config (``repro.configs.smoke_config``: 2 encoder layers over
16 frames, one decoder layer, d_model 64, 4 heads of 16, f32).  The
same JAX parameters go through ``params_from_numpy``; the same prompts,
frame embeddings and batches, made with numpy from a seed, go into
``repro.models.model`` and the port.  On the CPU the port runs the flash
kernel's plain version, so this holds the port's model code to the JAX
package's:

* layernorm within 1e-6 and the sinusoidal table bitwise;
* ``cross_kv`` and ``apply_cross_attn`` in prefill (several queries)
  and decode (one), and ``apply_encoder``, within 1e-5·max|out|
  (measured ≤ 9e-7: the init rule's attention outputs reach ~30);
* prefill and eight decode steps: logits within 1e-4·max|logit| and
  identical greedy tokens; every cache leaf, the cross cache's too,
  within 1e-4·max|leaf|;
* the port's prefill(S) against prefill(S−1) + one decode step within
  2e-4 (``tests/test_archs_smoke.py``);
* ``loss_fn`` within 1e-5 relative and every gradient leaf, the
  encoder's included, within 1e-3·max|g| of ``jax.grad``: measured ≤
  1.5e-4·max|g| in the first encoder layer (≤ 1e-5 in the decoder's),
  whose gradients come back through the cross-attention and a second
  encoder layer, each with the init rule's near one-hot attention (the
  loss agrees to 3e-7 relative);
* parameters both ways, the pipeline's batches bitwise, the kernel
  calls per pass.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.shapes import ShapeConfig as JShape  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as JPipe  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params,
    map_specs,
    tree_leaves,
    tree_map,
)
from repro_torch.runtime import serve_step  # noqa: E402

ARCH = "whisper-large-v3"
B, S, STEPS = 2, 12, 8
LAYER_SHARE = 1e-5
LOGIT_SHARE = 1e-4
INV_ATOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-3


def _cfgs():
    return jsmoke_config(jget_config(ARCH)), smoke_config(get_config(ARCH))


@pytest.fixture(scope="module")
def model():
    jc, tc = _cfgs()
    jp = jinit_params(JM.schema(jc), jax.random.key(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def _frames(cfg, seed=11):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.encoder_frames, cfg.d_model),
                               dtype=np.float32)


def _prompts(vocab, s=S, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (B, s))


def _share(got, want, share):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    diff = float(np.abs(got - want).max())
    assert diff <= share * float(np.abs(want).max()), diff


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax_field_for_field(smoke):
    j, t = jget_config(ARCH), get_config(ARCH)
    if smoke:
        j, t = jsmoke_config(j), smoke_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.cross_attention and t.norm == "layernorm"
    assert t.encoder_layers == (2 if smoke else 32)


@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_match_jax(smoke):
    """1.535 B parameters at full size: 32 encoder and 32 decoder layers,
    the tied 51866-token embedding."""
    j, t = jget_config(ARCH), get_config(ARCH)
    if smoke:
        j, t = jsmoke_config(j), smoke_config(t)
    assert M.param_counts(t) == JM.param_counts(j)
    if not smoke:
        assert M.param_counts(t)[0] == 1_534_809_600


def _jschema(sch):
    return jax.tree.map(lambda s: (s.shape, jnp.dtype(s.dtype).name), sch,
                        is_leaf=lambda x: hasattr(x, "init"))


def test_train_schema_is_jax_schema():
    """Leaf for leaf at full size: the encoder subtree, each decoder
    layer's ``norm_x`` and ``cross``, every norm's scale and bias."""
    j, t = jget_config(ARCH), get_config(ARCH)
    got = map_specs(lambda _, s: (s.shape, str(s.dtype).split(".")[-1]),
                    M.train_schema(t))
    assert got == _jschema(JM.schema(j))
    layer = got["b0"]["l0"]
    assert set(layer) == {"norm1", "mixer", "norm_x", "cross", "norm2",
                          "mlp"}
    assert set(layer["norm_x"]) == {"scale", "bias"}
    assert got["encoder"]["blocks"]["l0"]["mixer"]["wq"][0] == \
        (32, 1280, 20, 64)


def test_cache_schema_has_the_cross_cache():
    j, t = jget_config(ARCH), get_config(ARCH)
    got = map_specs(lambda _, s: s.shape, M.cache_schema(t, 8, 192))
    assert got["b0"]["l0"]["cross"] == {"k": (32, 8, 1500, 20, 64),
                                        "v": (32, 8, 1500, 20, 64)}
    want = jax.tree.map(lambda s: s.shape, JM.cache_schema(j, 8, 192),
                        is_leaf=lambda x: hasattr(x, "init"))
    assert got == want


def test_layernorm_matches_jax(model):
    jc, jp, tc, tp = model
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((5, 7, tc.d_model))).astype(
        np.float32)
    p = {"scale": rng.standard_normal(tc.d_model).astype(np.float32),
         "bias": rng.standard_normal(tc.d_model).astype(np.float32)}
    want = JL.apply_norm(jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = TL.apply_norm(tc, tree_map(torch.from_numpy, p),
                        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    # the fused seam: the sum in x's dtype, then the norm
    r = rng.standard_normal(x.shape).astype(np.float32)
    h, s = transformer.fused_norm(tc, tree_map(torch.from_numpy, p),
                                  torch.from_numpy(x), torch.from_numpy(r))
    np.testing.assert_array_equal(s.numpy(), x + r)
    np.testing.assert_allclose(
        h.numpy(), np.asarray(JL.apply_norm(jc, jax.tree.map(jnp.asarray, p),
                                            jnp.asarray(x + r))),
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n,d", [(16, 64), (1500, 1280), (7, 10), (3, 2)])
def test_sinusoidal_positions_are_bitwise_jax(n, d):
    got = TL.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, d)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JL.sinusoidal_positions(n, d)))


def _layer(tree, i=0):
    return tree[i] if isinstance(tree, torch.Tensor) else {
        k: _layer(v, i) for k, v in tree.items()}


def test_cross_attention_matches_jax(model):
    """One decoder layer's ``cross`` projections: the cross cache from
    an encoder output, then the attention of 5 queries (prefill, the
    flash kernel's plain version) and of one (decode, torch ops)."""
    jc, jp, tc, tp = model
    jx = jax.tree.map(lambda a: a[0], jp["b0"])["l0"]["cross"]
    tx = _layer(tp["b0"])["l0"]["cross"]
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((B, tc.encoder_frames, tc.d_model),
                              dtype=np.float32)
    jkv = JA.cross_kv(jc, jx, jnp.asarray(enc))
    tkv = attn_mod.cross_kv(tc, tx, torch.from_numpy(enc))
    for name in ("k", "v"):
        assert tuple(tkv[name].shape) == (B, 16, tc.num_kv_heads, 16)
        _share(tkv[name], jkv[name], LAYER_SHARE)
    for shape in ((B, 5, tc.d_model), (B, tc.d_model)):
        x = rng.standard_normal(shape, dtype=np.float32)
        want = JA.apply_cross_attn(jc, jx, jnp.asarray(x), jkv)
        got = attn_mod.apply_cross_attn(tc, tx, torch.from_numpy(x), tkv)
        assert tuple(got.shape) == shape
        _share(got, want, LAYER_SHARE)


def test_encoder_matches_jax(model):
    jc, jp, tc, tp = model
    enc = _frames(tc)
    want = JE.apply_encoder(jc, jp["encoder"], jnp.asarray(enc))
    got = encdec.apply_encoder(tc, tp["encoder"], torch.from_numpy(enc))
    assert tuple(got.shape) == (B, tc.encoder_frames, tc.d_model)
    _share(got, want, LAYER_SHARE)


def test_prefill_and_decode_match_jax(model):
    """Prefill S − 1 tokens and the frames into a cache of S + STEPS
    positions, then STEPS greedy decode steps, each adding the
    sinusoidal row at its position: logits, tokens and every cache leaf
    (the cross cache's k and v too)."""
    jc, jp, tc, tp = model
    toks, enc = _prompts(tc.vocab_size, S - 1), _frames(tc)
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks),
                                     "enc_embeds": jnp.asarray(enc)},
                            max_seq=S + STEPS)
    tl, tcache = serve_step.build_prefill(tc, max_seq=S + STEPS)(
        tp, {"tokens": torch.from_numpy(toks),
             "enc_embeds": torch.from_numpy(enc)})
    decode = serve_step.build_decode(tc)
    for i in range(STEPS + 1):
        jl = np.asarray(jl, np.float32)
        assert tl.dtype == torch.float32
        _share(tl, jl, LOGIT_SHARE)
        jt, tt = np.argmax(jl, -1), tl.argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), jt)
        if i == STEPS:
            break
        jl, jcache = JM.decode_step(
            jc, jp, jcache, {"token": jnp.asarray(jt, jnp.int32),
                             "pos": jnp.asarray(S - 1 + i, jnp.int32)})
        tl, tcache = decode(tp, tcache, {"token": tt, "pos": S - 1 + i})
    jshapes = jax.tree.map(lambda a: a.shape, jcache)
    assert tree_map(lambda t: tuple(t.shape), tcache) == jshapes
    assert set(tcache["b0"]["l0"]) == {"mixer", "cross"}
    for g, w in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
        _share(g, w, LOGIT_SHARE)


def test_prefill_decode_consistency(model):
    _, _, tc, tp = model
    toks = torch.from_numpy(_prompts(tc.vocab_size, 16, seed=1))
    enc = torch.from_numpy(_frames(tc, seed=3))
    full, _ = M.prefill(tc, tp, {"tokens": toks, "enc_embeds": enc})
    _, cache = M.prefill(tc, tp, {"tokens": toks[:, :15], "enc_embeds": enc},
                         max_seq=16)
    dec, new = M.decode_step(tc, tp, cache, {"token": toks[:, 15], "pos": 15})
    assert float((full - dec).abs().max()) < INV_ATOL
    assert new is cache


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    mask = (rng.uniform(size=(B, 16)) > 0.1).astype(np.float32)
    enc = rng.standard_normal((B, cfg.encoder_frames, cfg.d_model),
                              dtype=np.float32)
    return toks, mask, enc


def _jax_loss(jc, jp, toks, mask, enc):
    batch = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask),
             "enc_embeds": jnp.asarray(enc)}
    return jax.value_and_grad(
        lambda p: JM.loss_fn(jc, p, batch, loss_chunk=8, remat="none"),
        has_aux=True)(jp)


def _torch_batch(toks, mask, enc):
    return {"tokens": torch.from_numpy(toks),
            "loss_mask": torch.from_numpy(mask),
            "enc_embeds": torch.from_numpy(enc)}


def test_loss_and_grads_match_jax(model):
    """The loss and every gradient leaf, the encoder's, the cross
    projections' and the layernorm biases' included."""
    jc, jp, tc, _ = model
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu",
                           train=True)
    toks, mask, enc = _batch(tc)
    (jl, jm), jg = _jax_loss(jc, jp, toks, mask, enc)
    p = tree_map(lambda a: a.clone().requires_grad_(True), tp)
    tl, tm = M.loss_fn(tc, p, _torch_batch(toks, mask, enc), loss_chunk=8,
                       remat="none")
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["token_count"].item(),
                               float(jm["token_count"]))
    paths = [jax.tree_util.keystr(q)
             for q, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    got, want = tree_leaves(tree_map(lambda a: a.grad, p)), \
        jax.tree.leaves(jg)
    assert len(got) == len(want)
    assert any("encoder" in q for q in paths)
    assert any("'bias'" in q for q in paths)
    for path, g, w in zip(paths, got, want):
        w = np.asarray(w, np.float64)
        assert float(np.abs(w).max()) > 0, path
        diff = float(np.abs(g.numpy() - w).max())
        assert diff <= GRAD_SHARE * float(np.abs(w).max()), (path, diff)


def test_port_parameters_give_jax_the_same_loss():
    """Parameters drawn by the port (``train_schema``, the encoder
    included) as numpy into the JAX package's pytree give the same
    loss."""
    jc, tc = _cfgs()
    tp = init_params(M.train_schema(tc), torch.Generator().manual_seed(4),
                     "cpu")
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), tp))
    assert jax.tree.structure(jp) == jax.tree.structure(
        jinit_params(JM.schema(jc), jax.random.key(0)))
    toks, mask, enc = _batch(tc, seed=5)
    (jl, _), _ = _jax_loss(jc, jp, toks, mask, enc)
    with torch.no_grad():
        tl, _ = M.loss_fn(tc, tp, _torch_batch(toks, mask, enc),
                          loss_chunk=8)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)


def test_params_from_numpy_carries_the_encoder():
    jc, tc = _cfgs()
    jp = jax.tree.map(np.asarray, jinit_params(JM.schema(jc),
                                               jax.random.key(1)))
    tp = params_from_numpy(tc, jp, "cpu")
    np.testing.assert_array_equal(
        tp["encoder"]["blocks"]["l0"]["mixer"]["wq"].numpy(),
        jp["encoder"]["blocks"]["l0"]["mixer"]["wq"])
    np.testing.assert_array_equal(tp["b0"]["l0"]["norm_x"]["bias"].numpy(),
                                  jp["b0"]["l0"]["norm_x"]["bias"])
    del jp["encoder"]["final_norm"]["bias"]
    with pytest.raises(KeyError, match="encoder/final_norm/bias"):
        params_from_numpy(tc, jp, "cpu")


def test_pipeline_batches_are_bitwise_jax():
    """tokens, mask and the frame embeddings (bf16) from one generator
    in the JAX pipeline's order."""
    jc, tc = _cfgs()
    shape = ShapeConfig("t", seq_len=16, global_batch=2, kind="train")
    jshape = JShape("t", seq_len=16, global_batch=2, kind="train")
    for step in (0, 3):
        tb = SyntheticLMPipeline(tc, shape, seed=2).batch_at(step)
        jb = JPipe(jc, jshape, seed=2).batch_at(step)
        assert set(tb) == set(jb) == {"tokens", "loss_mask", "enc_embeds"}
        assert tb["enc_embeds"].dtype == torch.bfloat16
        for k in tb:
            np.testing.assert_array_equal(
                tb[k].float().numpy(), np.asarray(jb[k], np.float32))


def test_kernel_calls_per_pass(model, monkeypatch):
    """Flash once per encoder layer, per decoder self-attention and per
    cross-attention in prefill (none in decode); no norm kernel under
    layernorm.  Full whisper: 96 flash calls a prefill."""
    jc, jp, tc, tp = model
    calls = {"flash_attention": 0, "rmsnorm_residual": 0}

    def counted(name, fn):
        def wrap(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrap

    monkeypatch.setattr(attn_mod, "attention",
                        counted("flash_attention", attn_mod.attention))
    monkeypatch.setattr(transformer, "rmsnorm_residual",
                        counted("rmsnorm_residual",
                                transformer.rmsnorm_residual))
    toks = torch.from_numpy(_prompts(tc.vocab_size))
    enc = torch.from_numpy(_frames(tc))
    _, cache = M.prefill(tc, tp, {"tokens": toks, "enc_embeds": enc},
                         max_seq=S + 1)
    assert calls == M.launches_per_pass(tc, "prefill") == {
        "flash_attention": 4, "rmsnorm_residual": 0}
    calls.update({k: 0 for k in calls})
    M.decode_step(tc, tp, cache, {"token": toks[:, 0], "pos": S})
    assert calls == M.launches_per_pass(tc, "decode") == {
        "flash_attention": 0, "rmsnorm_residual": 0}
    calls.update({k: 0 for k in calls})
    tr, mask, enc2 = _batch(tc)
    M.loss_fn(tc, tp, _torch_batch(tr, mask, enc2), loss_chunk=8)
    assert calls == M.launches_per_pass(tc, "train")
    assert M.launches_per_pass(get_config(ARCH), "prefill") == {
        "flash_attention": 96, "rmsnorm_residual": 0}


def test_serve_cli_on_the_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(ln.startswith("[serve]") for ln in lines)
    assert tuple(res.tokens.shape) == (2, 4)
    zero = {"flash_attention": 0, "rmsnorm_residual": 0}
    assert res.launches == {"prefill": zero, "decode": zero}
