"""The port's serving path (Yi-6B, prefill + decode) against the JAX
package's model.

The same JAX parameters go through ``params_from_numpy``; the same
prompts go into ``repro.models.model.prefill`` / ``decode_step`` and
the port's.  On the CPU the port runs the plain versions of its two
kernels, so this holds the port's model code (projections, RoPE, the
fused residual-norm seams, the KV cache) to the JAX package's:

* f32: logits within 1e-4 (measured 1.3e-6 at max|logit| 0.6) and
  identical greedy tokens over 4 decode steps;
* bf16: each step fed the same tokens, logits within 0.1·max|logit|
  (measured up to 0.037·max).  The fused norm normalises the f32 sum
  x + y where the JAX layer normalises bf16(x + y), and the two
  libraries round bf16 products differently; the random model's peaked
  attention amplifies those roundings, and greedy tokens may part where
  the top two logits are that close.  A wrong cache or position gives
  differences of the order of the logits themselves.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import dense_blocks as jdense_blocks  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import BlockDef, dense_blocks  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params,
    map_specs,
    tree_map,
)
from repro_torch.runtime import serve_step  # noqa: E402

LAYERS = 2
B, S, STEPS = 2, 24, 4


def _cfgs(dtype):
    """The smoke Yi-6B widened to LAYERS layers, in both packages."""
    j = dataclasses.replace(jsmoke_config(jget_config("yi-6b")),
                            num_layers=LAYERS, blocks=jdense_blocks(LAYERS),
                            compute_dtype=dtype)
    t = dataclasses.replace(smoke_config(get_config("yi-6b")),
                            num_layers=LAYERS, blocks=dense_blocks(LAYERS),
                            compute_dtype=dtype)
    return j, t


@pytest.fixture(scope="module")
def models():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, tc = _cfgs(dtype)
        jp = jinit_params(JM.schema(jc), jax.random.key(0))
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
        out[dtype] = (jc, jp, tc, tp)
    return out


def _prompts(vocab, s=S):
    return np.random.default_rng(7).integers(0, vocab, (B, s))


def _run_both(models, dtype, teacher_forced):
    """Prefill (S - 1 tokens, cache of S + STEPS) and STEPS decode
    steps in both packages; returns the JAX and port logits per step
    and their greedy tokens."""
    jc, jp, tc, tp = models[dtype]
    toks = _prompts(tc.vocab_size, S - 1)
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)},
                            max_seq=S + STEPS)
    tl, tcache = serve_step.build_prefill(tc, max_seq=S + STEPS)(
        tp, {"tokens": torch.from_numpy(toks)})
    decode = serve_step.build_decode(tc)
    logits, tokens = [(np.asarray(jl, np.float32), tl.numpy())], []
    for i in range(STEPS):
        jt = np.argmax(logits[-1][0], -1)
        tt = jt if teacher_forced else np.argmax(logits[-1][1], -1)
        tokens.append((jt, tt))
        jl, jcache = JM.decode_step(
            jc, jp, jcache, {"token": jnp.asarray(jt, jnp.int32),
                             "pos": jnp.asarray(S - 1 + i, jnp.int32)})
        tl, tcache = decode(tp, tcache, {"token": torch.from_numpy(tt),
                                         "pos": S - 1 + i})
        logits.append((np.asarray(jl, np.float32), tl.numpy()))
    return logits, tokens


def test_f32_logits_and_greedy_tokens_match_jax(models):
    logits, tokens = _run_both(models, "float32", teacher_forced=False)
    for jl, tl in logits:
        assert tl.dtype == np.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, atol=1e-4)
    for jt, tt in tokens:
        np.testing.assert_array_equal(tt, jt)


def test_bf16_logits_match_jax(models):
    logits, _ = _run_both(models, "bfloat16", teacher_forced=True)
    for jl, tl in logits:
        scale = float(np.abs(jl).max())
        assert scale > 0 and np.isfinite(tl).all()
        assert float(np.abs(tl - jl).max()) <= 0.1 * scale


def test_prefill_cache_matches_jax(models):
    jc, jp, tc, tp = models["float32"]
    toks = _prompts(tc.vocab_size)
    _, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)},
                           max_seq=S + 3)
    _, tcache = M.prefill(tc, tp, {"tokens": torch.from_numpy(toks)},
                          max_seq=S + 3)
    for name in ("k", "v"):
        j = np.asarray(jcache["b0"]["l0"]["mixer"][name])
        t = tcache["b0"]["l0"]["mixer"][name].numpy()
        assert t.shape == j.shape == (LAYERS, B, S + 3, 2, 16)
        np.testing.assert_allclose(t, j, atol=1e-4)
        assert not t[:, :, S:].any()


def test_prefill_decode_consistency(models):
    """The serving invariant (``tests/test_archs_smoke.py``): the full
    prompt's logits equal prefill(S - 1) + one decode step."""
    _, _, tc, tp = models["float32"]
    toks = torch.from_numpy(_prompts(tc.vocab_size))
    full, _ = M.prefill(tc, tp, {"tokens": toks})
    _, cache = M.prefill(tc, tp, {"tokens": toks[:, :S - 1]}, max_seq=S)
    dec, new = M.decode_step(tc, tp, cache,
                             {"token": toks[:, S - 1], "pos": S - 1})
    assert float((full - dec).abs().max()) < 2e-4
    assert new is cache


def test_kernel_calls_per_pass(models, monkeypatch):
    """One attention call per layer in prefill, none in decode; the fused
    norm at 2·layers + 1 seams in both (``launches_per_pass``)."""
    _, _, tc, tp = models["float32"]
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
    _, cache = M.prefill(tc, tp, {"tokens": toks}, max_seq=S + 1)
    assert calls == M.launches_per_pass(tc, "prefill")
    calls.update({k: 0 for k in calls})
    M.decode_step(tc, tp, cache, {"token": toks[:, 0], "pos": S})
    assert calls == M.launches_per_pass(tc, "decode")
    assert M.launches_per_pass(get_config("yi-6b"), "prefill") == {
        "flash_attention": 32, "rmsnorm_residual": 65}


def test_layers_match_jax(models):
    """The unfused norm, RoPE and the SwiGLU MLP against the JAX
    package's layers on the same inputs, f32."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    jc, jp, tc, tp = models["float32"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 64), dtype=np.float32)
    lp_j = jax.tree.map(lambda a: a[0], jp["b0"]["l0"])
    lp_t = tree_map(lambda a: a[0], tp["b0"]["l0"])
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        TL.apply_norm(tc, lp_t["norm1"], xt).numpy(),
        np.asarray(JL.apply_norm(jc, lp_j["norm1"], jnp.asarray(x))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        TL.apply_mlp(tc, lp_t["mlp"], xt).numpy(),
        np.asarray(JL.apply_mlp(jc, lp_j["mlp"], jnp.asarray(x))),
        atol=1e-5, rtol=1e-5)
    q = rng.standard_normal((2, 24, 4, 16), dtype=np.float32)
    jcs = JL.rope_cos_sin(jnp.arange(24), 16, jc.rope_theta)
    tcs = TL.rope_cos_sin(torch.arange(24), 16, tc.rope_theta)
    for a, b in zip(tcs, jcs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(q), tcs[0][:, None], tcs[1][:, None])
        .numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(q), jcs[0][:, None],
                                 jcs[1][:, None])), atol=1e-5)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax_field_for_field(smoke):
    j, t = jget_config("yi-6b"), get_config("yi-6b")
    if smoke:
        j, t = jsmoke_config(j), smoke_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert str(t.cdtype).split(".")[-1] == str(j.cdtype)
    assert str(t.pdtype).split(".")[-1] == str(j.pdtype)


def test_schema_and_param_counts_match_jax():
    j, t = jget_config("yi-6b"), get_config("yi-6b")
    assert M.param_counts(t) == JM.param_counts(j)
    jshapes = jax.tree.map(lambda s: s.shape, JM.schema(jsmoke_config(j)),
                           is_leaf=lambda x: hasattr(x, "init"))
    tshapes = map_specs(lambda _, s: s.shape, M.schema(smoke_config(t)))
    assert tshapes == jshapes
    total, _ = M.param_counts(t)
    assert 6.0e9 < total < 6.1e9
    # jamba: (total, active) and, its parameters being bf16, serving's
    # schema dtypes leaf for leaf, the MoE router f32 in both packages
    j, t = jget_config("jamba-v0.1-52b"), get_config("jamba-v0.1-52b")
    assert M.param_counts(t) == JM.param_counts(j)
    jspecs = jax.tree.map(lambda s: (s.shape, jnp.dtype(s.dtype).name),
                          JM.schema(j), is_leaf=lambda x: hasattr(x, "init"))
    assert map_specs(lambda _, s: (s.shape, str(s.dtype).split(".")[-1]),
                     M.schema(t)) == jspecs
    assert jspecs["b0"]["l1"]["mlp"]["router"][1] == "float32"


def test_weights_in_compute_dtype_equal_jax_casts(models):
    """Matrices and embeddings are stored in the compute dtype, scales in
    the parameter dtype; the stored bf16 weights are JAX's cast at use."""
    jc, jp, tc, tp = models["bfloat16"]
    dtypes = map_specs(lambda _, s: s.dtype, M.schema(tc))
    assert dtypes["embed"] == dtypes["b0"]["l0"]["mixer"]["wq"] \
        == dtypes["b0"]["l0"]["mlp"]["down"] == torch.bfloat16
    assert dtypes["final_norm"]["scale"] == torch.float32
    for got, want in ((tp["b0"]["l0"]["mixer"]["wk"],
                       jp["b0"]["l0"]["mixer"]["wk"]),
                      (tp["embed"], jp["embed"])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32)))
    sp = serve.make_params(tc, "cpu")
    assert sp["b0"]["l0"]["mlp"]["up"].dtype == torch.bfloat16
    assert sp["b0"]["l0"]["norm1"]["scale"].dtype == torch.float32


def test_unported_configs_raise():
    """What the port refuses: a MoE or MLA layer without its config.  A
    logit soft-cap and a layer kind without an MLP, once refused, are
    served and match the JAX package's prefill on the same parameters.
    Whisper's encoder, qwen2-vl's embedding inputs and M-RoPE and
    layernorm are served, and both archs resolve."""
    from repro.configs.base import BlockDef as JBlockDef

    t = smoke_config(get_config("yi-6b"))
    j = jsmoke_config(jget_config("yi-6b"))
    toks = _prompts(t.vocab_size, 8)
    no_mlp = ((("attn", "none"), ("attn", "dense")),)
    for jc, tc in (
            (dataclasses.replace(j, attn_logit_softcap=30.0),
             dataclasses.replace(t, attn_logit_softcap=30.0)),
            (dataclasses.replace(j, num_layers=2, blocks=tuple(
                JBlockDef(p, 1) for p in no_mlp)),
             dataclasses.replace(t, num_layers=2, blocks=tuple(
                 BlockDef(p, 1) for p in no_mlp)))):
        jp = jinit_params(JM.schema(jc), jax.random.key(0))
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
        want, _ = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)})
        got, _ = M.prefill(tc, tp, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    with pytest.raises(ValueError, match="needs cfg.moe"):
        M.schema(dataclasses.replace(t, blocks=(
            BlockDef(pattern=(("attn", "moe"),), repeat=1),)))
    with pytest.raises(ValueError, match="needs cfg.mla"):
        M.schema(dataclasses.replace(t, blocks=(
            BlockDef(pattern=(("mla", "dense"),), repeat=1),)))
    ln = M.schema(dataclasses.replace(t, norm="layernorm"))
    assert set(ln["b0"]["l0"]["norm1"]) == {"scale", "bias"}
    assert get_config("qwen2-vl-72b").rope_type == "mrope"


# ---------------------------------------------------------------------------
# the other dense archs: Yi-9B, Granite-8B, Minitron-8B (squared ReLU)
# ---------------------------------------------------------------------------

DENSE = ("yi-9b", "granite-8b", "minitron-8b")


def _dense_models(arch):
    """The arch's smoke config widened to LAYERS layers, f32, in both
    packages, with the same JAX parameters."""
    j = dataclasses.replace(jsmoke_config(jget_config(arch)),
                            num_layers=LAYERS, blocks=jdense_blocks(LAYERS))
    t = dataclasses.replace(smoke_config(get_config(arch)),
                            num_layers=LAYERS, blocks=dense_blocks(LAYERS))
    jp = jinit_params(JM.schema(j), jax.random.key(0))
    tp = params_from_numpy(t, jax.tree.map(np.asarray, jp), "cpu")
    return {"float32": (j, jp, t, tp)}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_matches_jax_field_for_field(arch, smoke):
    j, t = jget_config(arch), get_config(arch)
    if smoke:
        j, t = jsmoke_config(j), smoke_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_schema_and_param_counts_match_jax(arch):
    j, t = jget_config(arch), get_config(arch)
    total, active = M.param_counts(t)
    assert (total, active) == JM.param_counts(j) and total == active
    jshapes = jax.tree.map(lambda s: s.shape, JM.schema(jsmoke_config(j)),
                           is_leaf=lambda x: hasattr(x, "init"))
    assert map_specs(lambda _, s: s.shape, M.schema(smoke_config(t))) \
        == jshapes
    mlp = M.schema(t)["b0"]["l0"]["mlp"]
    assert ("gate" in mlp) == (t.mlp_act == "swiglu")
    assert 7.5e9 < total < 9.5e9


@pytest.mark.parametrize("arch", DENSE)
def test_dense_logits_and_greedy_tokens_match_jax(arch):
    """Prefill and 4 greedy decode steps, f32: logits within 1e-4 and
    the same tokens (measured ≤ 3.3e-6 at max|logit| 0.49–0.62)."""
    logits, tokens = _run_both(_dense_models(arch), "float32",
                               teacher_forced=False)
    for jl, tl in logits:
        np.testing.assert_allclose(tl, jl, atol=1e-4)
    for jt, tt in tokens:
        np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_mlp_activations_match_jax(act):
    """``apply_mlp`` under each activation against the JAX package's
    (``relu2``: no gate; ``gelu``: the tanh approximation), f32."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    j = dataclasses.replace(jsmoke_config(jget_config("minitron-8b")),
                            mlp_act=act)
    t = dataclasses.replace(smoke_config(get_config("minitron-8b")),
                            mlp_act=act)
    jp = jinit_params(JL.mlp_schema(j), jax.random.key(2))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert set(tp) == ({"gate", "up", "down"} if act == "swiglu"
                       else {"up", "down"})
    assert map_specs(lambda _, s: s.shape, TL.mlp_schema(t)) == \
        {k: v.shape for k, v in jp.items()}
    x = np.random.default_rng(5).standard_normal((2, 24, 64),
                                                 dtype=np.float32)
    np.testing.assert_allclose(
        TL.apply_mlp(t, tp, torch.from_numpy(x)).numpy(),
        np.asarray(JL.apply_mlp(j, jp, jnp.asarray(x))), atol=1e-5,
        rtol=1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_serve_cli_on_the_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(ln.startswith("[serve]") for ln in lines)
    assert tuple(res.tokens.shape) == (2, 3)


def test_serve_cli_on_the_cpu(capsys):
    res = serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(ln.startswith("[serve]") for ln in lines)
    assert "prefill 8 tok × 2" in lines[0]
    assert "decode 3 steps" in lines[1] and "tok/s" in lines[1]
    assert tuple(res.tokens.shape) == (2, 4)
    assert res.launches == {"prefill": {"flash_attention": 0,
                                        "rmsnorm_residual": 0},
                            "decode": {"flash_attention": 0,
                                       "rmsnorm_residual": 0}}


def test_serve_cli_sampling_is_seeded(capsys):
    argv = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "5", "--temperature", "0.8"]
    a, b = serve.main(argv), serve.main(argv)
    assert torch.equal(a.tokens, b.tokens)


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "yi-6b", "--smoke"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_serve_on_card_matches_cpu(cuda_device, models):
    """Kernels on the card against the plain versions on the CPU, same
    weights, f32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, tc, _ = models["float32"]
    tc = dataclasses.replace(tc, head_dim=32)      # a head dim the kernel takes
    tp = init_params(M.schema(tc), torch.Generator().manual_seed(0), "cpu")
    gp = tree_map(lambda t: t.to(cuda_device), tp)
    toks = _prompts(tc.vocab_size)
    want = serve.serve(tc, tp, torch.from_numpy(toks), STEPS)
    got = serve.serve(tc, gp, torch.from_numpy(toks).to(cuda_device),
                      STEPS)
    np.testing.assert_allclose(got.first_logits.cpu().numpy(),
                               want.first_logits.numpy(), atol=1e-4)
    assert torch.equal(got.tokens.cpu(), want.tokens)
    assert got.launches["prefill"] == M.launches_per_pass(tc, "prefill")
