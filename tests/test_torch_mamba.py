"""The port's Mamba-2 serving path (mamba2-370m, chunked-SSD prefill +
O(1) recurrent decode) against the JAX package's.

The smoke mamba2 (d_model 64, d_state N=16, head_dim P=16, 8 heads,
chunk 16) widened to 2 layers; prompts of 40 tokens, so the last chunk
is ragged and the zero padding runs.  The same JAX parameters go
through ``params_from_numpy``; the same inputs go into the JAX
package's functions and the port's.  On the CPU the port runs the plain
versions of its kernels, so this holds the port's model code (the
projections, the causal conv, the chunked SSD around ``ssd_chunk``, the
inter-chunk recurrence, the gated norm, the fused residual-norm seams
and the O(1) cache) to the JAX package's:

* f32: logits within 1e-4 (measured 2.6e-7 at max|logit| 0.49) and
  identical greedy tokens over 4 decode steps;
* bf16: logits within 0.05·max|logit| (measured 0.0049 at 0.49, 1 %).
  The fused norm normalises the f32 sum x + y where the JAX layer
  normalises bf16(x + y), and the port's chunk states are f32 where the
  JAX model rounds ``B·to_end`` to bf16 before its product with xdt
  (``mamba2.py:200``); the two libraries also round bf16 products
  differently.  A wrong cache, decay or chunk boundary gives differences
  of the order of the logits themselves.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import BlockDef as JBlockDef  # noqa: E402
from repro.models import mamba2 as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import BlockDef  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import mamba2 as MB  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    count_params,
    init_params,
    map_specs,
    tree_map,
    zeros_like_schema,
)
from repro_torch.runtime import serve_step  # noqa: E402

ARCH = "mamba2-370m"
LAYERS = 2
B, S, STEPS = 2, 40, 4
#: bf16 logits: share of max|logit| (measured 0.01)
BF16_SHARE = 0.05


def _cfgs(dtype):
    """The smoke mamba2 widened to LAYERS layers, in both packages."""
    pattern = (("mamba", "none"),)
    j = dataclasses.replace(
        jsmoke_config(jget_config(ARCH)), num_layers=LAYERS,
        blocks=(JBlockDef(pattern=pattern, repeat=LAYERS),),
        compute_dtype=dtype)
    t = dataclasses.replace(
        smoke_config(get_config(ARCH)), num_layers=LAYERS,
        blocks=(BlockDef(pattern=pattern, repeat=LAYERS),),
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


def _layer0(models, dtype="float32"):
    jc, jp, tc, tp = models[dtype]
    return (jc, jax.tree.map(lambda a: a[0], jp["b0"]["l0"]["mixer"]),
            tc, tree_map(lambda a: a[0], tp["b0"]["l0"]["mixer"]))


# ------------------------------------------------------------ chunked SSD


def _ssd_inputs(seed, B_, S_, H, P, N, G=1):
    rng = np.random.default_rng(seed)
    xs = 0.5 * rng.standard_normal((B_, S_, H, P), dtype=np.float32)
    bs = 0.5 * rng.standard_normal((B_, S_, G, N), dtype=np.float32)
    cs = 0.5 * rng.standard_normal((B_, S_, G, N), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B_, S_, H)))).astype(
        np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    return xs, bs, cs, dt, (dt * A).astype(np.float32)


@pytest.mark.parametrize("S_", [48, 40])
def test_ssd_chunked_matches_jax_and_the_recurrence(S_):
    """``ssd_chunked`` against the JAX package's and against a literal
    sequential state-space recurrence (``tests/test_kernels.py``'s
    shapes; 40 makes the last chunk ragged)."""
    B_, H, P, N, chunk = 2, 2, 16, 8, 16
    arrs = _ssd_inputs(S_, B_, S_, H, P, N)
    y, st = MB.ssd_chunked(*map(torch.from_numpy, arrs), chunk=chunk,
                           n_heads=H)
    jy, jst = JMB.ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk,
                              n_heads=H)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-5)
    xs, bs, cs, dt, dA = (a.astype(np.float64) for a in arrs)
    h = np.zeros((B_, H, N, P))
    ys = np.zeros((B_, S_, H, P))
    for t in range(S_):
        for b_ in range(B_):
            for hh in range(H):
                h[b_, hh] = np.exp(dA[b_, t, hh]) * h[b_, hh] + np.outer(
                    bs[b_, t, 0], dt[b_, t, hh] * xs[b_, t, hh])
                ys[b_, t, hh] = cs[b_, t, 0] @ h[b_, hh]
    np.testing.assert_allclose(y.numpy(), ys, atol=5e-5)
    np.testing.assert_allclose(st.numpy(), h, atol=5e-5)


def test_ssd_chunked_groups_match_jax():
    """Two groups of B and C over four heads (a repeat, not a view)."""
    arrs = _ssd_inputs(11, 2, 40, 4, 16, 16, G=2)
    y, st = MB.ssd_chunked(*map(torch.from_numpy, arrs), chunk=16,
                           n_heads=4)
    jy, jst = JMB.ssd_chunked(*map(jnp.asarray, arrs), chunk=16, n_heads=4)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-5)


# ----------------------------------------------------------------- mixer


def test_conv_and_conv_step_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 12), dtype=np.float32)
    w = rng.standard_normal((4, 12), dtype=np.float32)
    b = rng.standard_normal(12, dtype=np.float32)
    cache = rng.standard_normal((2, 3, 12), dtype=np.float32)
    got = MB._causal_conv(*map(torch.from_numpy, (x, w, b)))
    want = JMB._causal_conv(*map(jnp.asarray, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    got = MB._conv_step(*map(torch.from_numpy, (x[:, 0], cache, w, b)))
    want = JMB._conv_step(*map(jnp.asarray, (x[:, 0], cache, w, b)))
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-6)


def test_apply_mamba_full_and_decode_match_jax(models):
    jc, jp, tc, tp = _layer0(models)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, 64), dtype=np.float32)
    jout, jcache = JMB.apply_mamba_full(jc, jp, jnp.asarray(x),
                                        return_cache=True)
    cache = zeros_like_schema(MB.mamba_cache_schema(tc, B), "cpu")
    out = MB.apply_mamba_full(tc, tp, torch.from_numpy(x), cache=cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    for name in ("conv_x", "conv_b", "conv_c", "state"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=1e-5)
    xd = rng.standard_normal((B, 64), dtype=np.float32)
    jout, jnew = JMB.apply_mamba_decode(jc, jp, jnp.asarray(xd), jcache)
    out = MB.apply_mamba_decode(tc, tp, torch.from_numpy(xd), cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    for name in ("conv_x", "conv_b", "conv_c", "state"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jnew[name]), atol=1e-5)


def test_short_prompt_cache_holds_leading_zeros(models):
    """A prompt shorter than the conv window: the tails are the prompt
    after the conv's zeros, and the decode step continues the full
    conv."""
    _, _, tc, tp = _layer0(models)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 3, 64), dtype=np.float32))
    full = MB.apply_mamba_full(tc, tp, x)
    cache = zeros_like_schema(MB.mamba_cache_schema(tc, B), "cpu")
    MB.apply_mamba_full(tc, tp, x[:, :2], cache=cache)
    assert not cache["conv_x"][:, 0].any()
    dec = MB.apply_mamba_decode(tc, tp, x[:, 2], cache)
    np.testing.assert_allclose(dec.numpy(), full[:, 2].numpy(), atol=1e-5)


def test_a_log_and_dt_bias_inits():
    jc, tc = _cfgs("float32")
    jp = jinit_params(JM.schema(jc), jax.random.key(1))
    tp = init_params(M.schema(tc), torch.Generator().manual_seed(1), "cpu")
    a_t = tp["b0"]["l0"]["mixer"]["A_log"]
    # equal up to one f32 rounding: XLA's log(7) is one ulp from the
    # correctly rounded value that torch returns
    np.testing.assert_array_max_ulp(
        a_t.numpy(), np.asarray(jp["b0"]["l0"]["mixer"]["A_log"]), maxulp=1)
    H = tc.ssm.n_heads(tc.d_model)
    np.testing.assert_allclose(a_t[0].numpy(), np.log(np.arange(1, H + 1)),
                               rtol=1e-6)
    big = dataclasses.replace(tc, num_layers=8, blocks=(
        BlockDef(pattern=(("mamba", "none"),), repeat=8),))
    bp = init_params(M.schema(big), torch.Generator().manual_seed(2), "cpu")
    dt = torch.nn.functional.softplus(bp["b0"]["l0"]["mixer"]["dt_bias"])
    s = tc.ssm
    assert dt.shape == (8, H)
    assert float(dt.min()) >= s.dt_min * (1 - 1e-5)
    assert float(dt.max()) <= s.dt_max * (1 + 1e-5)
    # log-uniform: the log of dt spreads over the range, not one value
    assert float(dt.log().std()) > 0.3 * np.log(s.dt_max / s.dt_min) / 4


# -------------------------------------------------------------- serving


def _run_both(models, dtype, teacher_forced):
    """Prefill (S tokens) and STEPS decode steps in both packages;
    returns the JAX and port logits per step and their greedy tokens."""
    jc, jp, tc, tp = models[dtype]
    toks = _prompts(tc.vocab_size)
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
                             "pos": jnp.asarray(S + i, jnp.int32)})
        tl, tcache = decode(tp, tcache, {"token": torch.from_numpy(tt),
                                         "pos": S + i})
        logits.append((np.asarray(jl, np.float32), tl.numpy()))
    return logits, tokens, jcache, tcache


def test_f32_logits_and_greedy_tokens_match_jax(models):
    logits, tokens, jcache, tcache = _run_both(models, "float32", False)
    for jl, tl in logits:
        assert tl.dtype == np.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, atol=1e-4)
    for jt, tt in tokens:
        np.testing.assert_array_equal(tt, jt)
    for name in ("conv_x", "conv_b", "conv_c", "state"):
        j = np.asarray(jcache["b0"]["l0"]["mixer"][name])
        t = tcache["b0"]["l0"]["mixer"][name].numpy()
        assert t.shape == j.shape and t.shape[0] == LAYERS
        np.testing.assert_allclose(t, j, atol=1e-5)


def test_bf16_logits_match_jax(models):
    logits, _, _, _ = _run_both(models, "bfloat16", True)
    for jl, tl in logits:
        scale = float(np.abs(jl).max())
        assert scale > 0 and np.isfinite(tl).all()
        assert float(np.abs(tl - jl).max()) <= BF16_SHARE * scale


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


def test_decode_state_is_constant_size():
    """``tests/test_archs_smoke.py``: the SSM cache does not grow with
    the sequence."""
    cfg = smoke_config(get_config(ARCH))
    small = M.cache_schema(cfg, batch=1, max_seq=64)
    big = M.cache_schema(cfg, batch=1, max_seq=256)
    assert count_params(small) == count_params(big) > 0
    full = get_config(ARCH)
    # 48 layers x (3 conv tails x (2048 + 2·128) + 32·128·64 f32 state)
    assert count_params(M.cache_schema(full, 1, 500_000)) == 48 * (
        3 * (2048 + 2 * 128) + 32 * 128 * 64)


def test_kernel_calls_per_pass(models, monkeypatch):
    """The SSD kernel once per mamba layer in prefill and never in
    decode; the fused norm at layers + 1 seams in both; no attention
    (``launches_per_pass``).  Yi-6B's counts are unchanged."""
    _, _, tc, tp = models["float32"]
    calls = {"rmsnorm_residual": 0, "ssd_chunk": 0}

    def counted(name, fn):
        def wrap(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrap

    monkeypatch.setattr(transformer, "rmsnorm_residual",
                        counted("rmsnorm_residual",
                                transformer.rmsnorm_residual))
    monkeypatch.setattr(MB, "ssd_chunk", counted("ssd_chunk", MB.ssd_chunk))
    toks = torch.from_numpy(_prompts(tc.vocab_size))
    _, cache = M.prefill(tc, tp, {"tokens": toks}, max_seq=S + 1)
    assert calls == M.launches_per_pass(tc, "prefill") == {
        "rmsnorm_residual": LAYERS + 1, "ssd_chunk": LAYERS}
    calls.update({k: 0 for k in calls})
    M.decode_step(tc, tp, cache, {"token": toks[:, 0], "pos": S})
    assert calls == M.launches_per_pass(tc, "decode")
    assert M.launches_per_pass(get_config(ARCH), "prefill") == {
        "rmsnorm_residual": 49, "ssd_chunk": 48}
    assert M.launches_per_pass(get_config(ARCH), "decode") == {
        "rmsnorm_residual": 49, "ssd_chunk": 0}
    yi = get_config("yi-6b")
    assert M.launches_per_pass(yi, "prefill") == {
        "flash_attention": 32, "rmsnorm_residual": 65}
    assert M.launches_per_pass(yi, "decode") == {
        "flash_attention": 0, "rmsnorm_residual": 65}


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax_field_for_field(smoke):
    j, t = jget_config(ARCH), get_config(ARCH)
    if smoke:
        j, t = jsmoke_config(j), smoke_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert str(t.cdtype).split(".")[-1] == str(j.cdtype)


def test_schema_and_param_counts_match_jax():
    j, t = jget_config(ARCH), get_config(ARCH)
    assert M.param_counts(t) == JM.param_counts(j)
    jshapes = jax.tree.map(lambda s: s.shape, JM.schema(jsmoke_config(j)),
                           is_leaf=lambda x: hasattr(x, "init"))
    tshapes = map_specs(lambda _, s: s.shape, M.schema(smoke_config(t)))
    assert tshapes == jshapes
    total, _ = M.param_counts(t)
    assert 3.6e8 < total < 3.8e8
    jcache = jax.tree.map(lambda s: s.shape, JM.cache_schema(j, 2, 64),
                          is_leaf=lambda x: hasattr(x, "init"))
    assert map_specs(lambda _, s: s.shape, M.cache_schema(t, 2, 64)) \
        == jcache


def test_weights_in_compute_dtype_equal_jax_casts(models):
    """Leaves the JAX package casts at use are stored in the compute
    dtype; A_log, dt_bias and the norm scales in the parameter dtype."""
    jc, jp, tc, tp = models["bfloat16"]
    dtypes = map_specs(lambda _, s: s.dtype, M.schema(tc))["b0"]["l0"]
    for name in ("wz", "wx", "wb", "wc", "wdt", "out", "conv_x", "D"):
        assert dtypes["mixer"][name] == torch.bfloat16, name
    for name in ("A_log", "dt_bias", "norm"):
        assert dtypes["mixer"][name] == torch.float32, name
    assert dtypes["norm1"]["scale"] == torch.float32
    got, want = tp["b0"]["l0"]["mixer"]["wx"], jp["b0"]["l0"]["mixer"]["wx"]
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32)))


def test_unported_configs_raise():
    t = smoke_config(get_config(ARCH))
    j = jsmoke_config(jget_config(ARCH))
    toks = np.random.default_rng(5).integers(0, t.vocab_size, (B, 8))
    # a logit soft-cap on an attention layer beside the mamba layer, and
    # an attention layer without an MLP: once refused, now served, the
    # prefill the JAX package's on the same parameters
    hybrid = dict(attn_logit_softcap=30.0, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, num_layers=2)
    for pattern in ((("mamba", "none"), ("attn", "dense")),
                    (("mamba", "none"), ("attn", "none"))):
        jc = dataclasses.replace(j, **hybrid, blocks=(
            JBlockDef(pattern=pattern, repeat=1),))
        tc = dataclasses.replace(t, **hybrid, blocks=(
            BlockDef(pattern=pattern, repeat=1),))
        jp = jinit_params(JM.schema(jc), jax.random.key(0))
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
        want, _ = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)})
        got, _ = M.prefill(tc, tp, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # a MoE layer with no MoE config, an MLA layer with no MLA config
    with pytest.raises(ValueError, match="needs cfg.moe"):
        M.schema(dataclasses.replace(t, blocks=(
            BlockDef(pattern=(("mamba", "moe"),), repeat=1),)))
    with pytest.raises(ValueError, match="needs cfg.mla"):
        M.schema(dataclasses.replace(t, blocks=(
            BlockDef(pattern=(("mla", "dense"),), repeat=1),)))
    assert get_config("whisper-large-v3").encoder_layers == 32


def test_serve_cli_on_the_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "40", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(ln.startswith("[serve]") for ln in lines)
    assert "prefill 40 tok × 2" in lines[0]
    assert "decode 3 steps" in lines[1] and "tok/s" in lines[1]
    assert tuple(res.tokens.shape) == (2, 4)
    zero = {"rmsnorm_residual": 0, "ssd_chunk": 0}
    assert res.launches == {"prefill": zero, "decode": zero}


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", ARCH, "--smoke"])


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
    _, _, tc, tp = models["float32"]
    gp = tree_map(lambda t: t.to(cuda_device), tp)
    toks = _prompts(tc.vocab_size)
    want = serve.serve(tc, tp, torch.from_numpy(toks), STEPS)
    got = serve.serve(tc, gp, torch.from_numpy(toks).to(cuda_device),
                      STEPS)
    np.testing.assert_allclose(got.first_logits.cpu().numpy(),
                               want.first_logits.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.last_logits.cpu().numpy(),
                               want.last_logits.numpy(), atol=1e-4)
    assert torch.equal(got.tokens.cpu(), want.tokens)
    assert got.launches["prefill"] == M.launches_per_pass(tc, "prefill")
    assert got.launches["decode"] == {
        k: (STEPS - 1) * v
        for k, v in M.launches_per_pass(tc, "decode").items()}
