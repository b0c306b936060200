"""The port's Jamba hybrid (jamba-v0.1-52b: attention, Mamba-2 and
mixture-of-experts layers in one period) against the JAX package's
model, on the CPU.

The smoke Jamba: one period of 8 layers (attention at index 4, Mamba-2
elsewhere, MoE at the odd indices), d_model 64, 8 experts top-2 with
capacity factor 4 (drop-free, as ``repro.configs.smoke_config`` sets
it), f32.  The same JAX parameters go through ``params_from_numpy``;
the same prompts and batches, made with numpy from a seed, go into
``repro.models.model`` and the port.  On the CPU the port runs the plain
versions of its three kernels, so this holds the port's model code (the
Mamba layers with a ``norm2`` seam, the MoE layers and their aux terms,
attention with no positional encoding, the caches) to the JAX
package's:

* prefill and four decode steps: logits within 1e-4 (measured ≤ 3.5e-6
  at max|logit| 0.48) and identical greedy tokens; every cache leaf
  within 1e-4 (measured ≤ 2.3e-5, a Mamba state);
* the port's prefill(S) against prefill(S−1) + one decode step within
  2e-4 (``tests/test_archs_smoke.py``; measured 8.2e-7);
* the loss with its aux terms within 1e-5 relative (measured equal),
  the aux term within 1e-6 relative (measured 1.7e-7), and every
  gradient leaf within 1e-4·max|g| of ``jax.grad``'s (measured ≤
  3.8e-5·max|g|, as the dense model's near one-hot attention gives in
  ``tests/test_torch_train.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.rules import count_params as jcount  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import mamba2 as mamba_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    count_params,
    init_params,
    map_specs,
    tree_leaves,
    tree_map,
)
from repro_torch.runtime import serve_step  # noqa: E402

ARCH = "jamba-v0.1-52b"
B, S, STEPS = 2, 40, 4
LOGIT_ATOL = 1e-4
INV_ATOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4


def _cfgs(dtype="float32"):
    j = dataclasses.replace(jsmoke_config(jget_config(ARCH)),
                            compute_dtype=dtype)
    t = dataclasses.replace(smoke_config(get_config(ARCH)),
                            compute_dtype=dtype)
    return j, t


@pytest.fixture(scope="module")
def model():
    jc, tc = _cfgs()
    jp = jinit_params(JM.schema(jc), jax.random.key(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def _prompts(vocab, s=S, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (B, s))


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax_field_for_field(smoke):
    """The config, and ``smoke_config``'s MoE and SSM shrink of it, equal
    the JAX package's field for field."""
    j, t = jget_config(ARCH), get_config(ARCH)
    if smoke:
        j, t = jsmoke_config(j), smoke_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert str(t.pdtype).split(".")[-1] == str(j.pdtype)


def test_the_smoke_period_has_every_layer_kind(model):
    _, _, tc, _ = model
    kinds = set(tc.blocks[0].pattern)
    assert kinds == {("mamba", "dense"), ("mamba", "moe"), ("attn", "dense")}
    assert kinds <= set(transformer.LAYER_KINDS)
    assert tc.rope_type == "none" and tc.moe.top_k == 2


def test_prefill_and_decode_match_jax(model):
    """Prefill S−1 tokens into a cache of S + STEPS positions, then STEPS
    greedy decode steps in both packages: logits and tokens."""
    jc, jp, tc, tp = model
    toks = _prompts(tc.vocab_size, S - 1)
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)},
                            max_seq=S + STEPS)
    tl, tcache = serve_step.build_prefill(tc, max_seq=S + STEPS)(
        tp, {"tokens": torch.from_numpy(toks)})
    decode = serve_step.build_decode(tc)
    for i in range(STEPS + 1):
        jl = np.asarray(jl, np.float32)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_ATOL)
        jt, tt = np.argmax(jl, -1), tl.argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), jt)
        if i == STEPS:
            break
        jl, jcache = JM.decode_step(
            jc, jp, jcache, {"token": jnp.asarray(jt, jnp.int32),
                             "pos": jnp.asarray(S - 1 + i, jnp.int32)})
        tl, tcache = decode(tp, tcache, {"token": tt, "pos": S - 1 + i})
    got, want = tree_leaves(tcache), jax.tree.leaves(jcache)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=LOGIT_ATOL)


def test_prefill_cache_matches_jax(model):
    """Every cache leaf after a prefill: the attention layer's k and v
    (zero past S), the Mamba layers' conv tails and f32 states."""
    jc, jp, tc, tp = model
    toks = _prompts(tc.vocab_size)
    _, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)},
                           max_seq=S + 3)
    _, tcache = M.prefill(tc, tp, {"tokens": torch.from_numpy(toks)},
                          max_seq=S + 3)
    jshapes = jax.tree.map(lambda a: a.shape, jcache)
    assert tree_map(lambda t: tuple(t.shape), tcache) == jshapes
    for g, w in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=LOGIT_ATOL)
    kv = tcache["b0"]["l4"]["mixer"]
    assert not kv["k"][:, :, S:].any() and not kv["v"][:, :, S:].any()
    assert tcache["b0"]["l0"]["mixer"]["state"].dtype == torch.float32


def test_prefill_decode_consistency(model):
    """The serving invariant (``tests/test_archs_smoke.py``): the full
    prompt's logits equal prefill(S − 1) + one decode step."""
    _, _, tc, tp = model
    s = 32
    toks = torch.from_numpy(_prompts(tc.vocab_size, s, seed=1))
    full, _ = M.prefill(tc, tp, {"tokens": toks})
    _, cache = M.prefill(tc, tp, {"tokens": toks[:, :s - 1]}, max_seq=s)
    dec, new = M.decode_step(tc, tp, cache,
                             {"token": toks[:, s - 1], "pos": s - 1})
    assert float((full - dec).abs().max()) < INV_ATOL
    assert new is cache


def test_decode_state_is_constant_size():
    """Only the attention layer's cache grows with the sequence
    (``tests/test_archs_smoke.py``); the Mamba layers' O(1) state does
    not.  The cache schema is the JAX package's, shape for shape."""
    tc = smoke_config(get_config(ARCH))
    small = M.cache_schema(tc, 1, 64)
    big = M.cache_schema(tc, 1, 256)
    assert count_params(big) / count_params(small) < 4.0
    for name, lc in small["b0"].items():
        if "state" in lc["mixer"]:
            assert map_specs(lambda _, s: s.shape, lc) == \
                map_specs(lambda _, s: s.shape, big["b0"][name])
    jc = jsmoke_config(jget_config(ARCH))
    for max_seq in (64, 256):
        jsch = jax.tree.map(lambda s: s.shape,
                            JM.cache_schema(jc, 1, max_seq),
                            is_leaf=lambda x: hasattr(x, "init"))
        assert map_specs(lambda _, s: s.shape,
                         M.cache_schema(tc, 1, max_seq)) == jsch


@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_match_jax(smoke):
    j, t = jget_config(ARCH), get_config(ARCH)
    if smoke:
        j, t = jsmoke_config(j), smoke_config(t)
    total, active = M.param_counts(t)
    assert (total, active) == JM.param_counts(j)
    assert active < total
    assert total == jcount(JM.schema(j))
    if not smoke:
        assert 5.1e10 < total < 5.2e10 and 1.19e10 < active < 1.21e10


def test_schema_matches_jax_with_an_f32_router():
    """The full config's schema (bf16 parameters) leaf for leaf: shapes
    and dtypes, the router f32 in serving's and in training's schema."""
    j, t = jget_config(ARCH), get_config(ARCH)
    jsch = jax.tree.map(lambda s: (s.shape, jnp.dtype(s.dtype).name),
                        JM.schema(j), is_leaf=lambda x: hasattr(x, "init"))
    for sch in (M.schema(t), M.train_schema(t)):
        got = map_specs(lambda _, s: (s.shape, str(s.dtype).split(".")[-1]),
                        sch)
        assert got == jsch
        router = sch["b0"]["l1"]["mlp"]["router"]
        assert router.dtype == torch.float32 and router.pinned


def test_params_from_numpy_keeps_the_router_f32():
    """bf16 compute and parameters: serving's and training's leaves in
    their schemas' dtypes, the router in f32 and equal to JAX's bits."""
    jc, tc = _cfgs("bfloat16")
    jc = dataclasses.replace(jc, param_dtype="bfloat16")
    tc = dataclasses.replace(tc, param_dtype="bfloat16")
    jp = jinit_params(JM.schema(jc), jax.random.key(1))
    tree = jax.tree.map(np.asarray, jax.tree.map(
        lambda a: a.astype(jnp.float32), jp))
    for train in (False, True):
        tp = params_from_numpy(tc, tree, "cpu", train=train)
        moe = tp["b0"]["l3"]["mlp"]
        assert moe["router"].dtype == torch.float32
        assert moe["w_down"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            moe["router"].numpy(),
            np.asarray(jp["b0"]["l3"]["mlp"]["router"]))
        np.testing.assert_array_equal(
            moe["w_up"].float().numpy(),
            np.asarray(jp["b0"]["l3"]["mlp"]["w_up"].astype(jnp.float32)))
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError):
        params_from_numpy(tc, bad, "cpu")


def _batch(vocab, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, 32)).astype(np.int32)
    mask = (rng.uniform(size=(B, 32)) > 0.1).astype(np.float32)
    return toks, mask


def test_loss_with_aux_and_grads_match_jax(model):
    """``loss_fn`` (mean NLL + the MoE layers' lb and z terms) and every
    gradient leaf against ``jax.grad``; remat "full" gives the same bits
    as "none"."""
    jc, jp, tc, _ = model
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu",
                           train=True)
    toks, mask = _batch(tc.vocab_size)
    jbatch = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jc, p, jbatch, loss_chunk=16, remat="none"),
        has_aux=True)(jp)
    tbatch = {"tokens": torch.from_numpy(toks),
              "loss_mask": torch.from_numpy(mask)}
    grads = {}
    for remat in ("none", "full"):
        p = tree_map(lambda a: a.clone().requires_grad_(True), tp)
        tl, tm = M.loss_fn(tc, p, tbatch, loss_chunk=16, remat=remat)
        tl.backward()
        grads[remat] = tree_map(lambda a: a.grad, p)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    assert float(jm["aux_loss"]) > 0
    np.testing.assert_allclose(tm["aux_loss"].item(), float(jm["aux_loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tm["nll_sum"].item(), float(jm["nll_sum"]),
                               rtol=LOSS_RTOL)
    paths = [jax.tree_util.keystr(q)
             for q, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    got, want = tree_leaves(grads["none"]), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        w = np.asarray(w, np.float64)
        diff = float(np.abs(g.numpy() - w).max())
        assert diff <= GRAD_SHARE * float(np.abs(w).max()), (path, diff)
    for g, h in zip(got, tree_leaves(grads["full"])):
        assert torch.equal(g, h)


def test_kernel_calls_per_pass(model, monkeypatch):
    """The fused norm at both seams of every layer with an MLP (Mamba
    ones too) and one of each without, plus the final norm; attention
    once per attention layer and the SSD chunk once per Mamba layer in
    prefill, neither in decode (``launches_per_pass``)."""
    _, _, tc, tp = model
    calls = {"flash_attention": 0, "rmsnorm_residual": 0, "ssd_chunk": 0}

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
    monkeypatch.setattr(mamba_mod, "ssd_chunk",
                        counted("ssd_chunk", mamba_mod.ssd_chunk))
    toks = torch.from_numpy(_prompts(tc.vocab_size))
    _, cache = M.prefill(tc, tp, {"tokens": toks}, max_seq=S + 1)
    assert calls == M.launches_per_pass(tc, "prefill") == {
        "flash_attention": 1, "rmsnorm_residual": 17, "ssd_chunk": 7}
    calls.update({k: 0 for k in calls})
    M.decode_step(tc, tp, cache, {"token": toks[:, 0], "pos": S})
    assert calls == M.launches_per_pass(tc, "decode")
    assert M.launches_per_pass(get_config(ARCH), "prefill") == {
        "flash_attention": 4, "rmsnorm_residual": 65, "ssd_chunk": 28}


def test_serve_cli_on_the_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(ln.startswith("[serve]") for ln in lines)
    assert "prefill 20 tok × 2" in lines[0]
    assert tuple(res.tokens.shape) == (2, 4)
    zero = {"flash_attention": 0, "rmsnorm_residual": 0, "ssd_chunk": 0}
    assert res.launches == {"prefill": zero, "decode": zero}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_serve_on_card_matches_cpu(cuda_device):
    """Kernels on the card against the plain versions on the CPU, same
    weights, f32 (no TF32); the attention head dim widened to 32, one
    the flash kernel takes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tc = dataclasses.replace(smoke_config(get_config(ARCH)), head_dim=32)
    tp = init_params(M.schema(tc), torch.Generator().manual_seed(0), "cpu")
    gp = tree_map(lambda t: t.to(cuda_device), tp)
    toks = torch.from_numpy(_prompts(tc.vocab_size))
    want = serve.serve(tc, tp, toks, STEPS)
    got = serve.serve(tc, gp, toks.to(cuda_device), STEPS)
    for g, w in ((got.first_logits, want.first_logits),
                 (got.last_logits, want.last_logits)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4)
    assert torch.equal(got.tokens.cpu(), want.tokens)
    assert got.launches["prefill"] == M.launches_per_pass(tc, "prefill")
    assert got.launches["decode"] == {
        k: (STEPS - 1) * v
        for k, v in M.launches_per_pass(tc, "decode").items()}


@pytest.mark.gpu
def test_loss_on_card_matches_cpu(cuda_device):
    """The training loss with aux terms and its gradients through the
    kernels' autograd Functions on the card, against the CPU, f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tc = dataclasses.replace(smoke_config(get_config(ARCH)), head_dim=32)
    tp = init_params(M.train_schema(tc), torch.Generator().manual_seed(0),
                     "cpu")
    toks, mask = _batch(tc.vocab_size)
    out = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda a: a.to(dev).detach().requires_grad_(True), tp)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "loss_mask": torch.from_numpy(mask).to(dev)}
        loss, m = M.loss_fn(tc, p, batch, loss_chunk=16, remat="full")
        loss.backward()
        out[str(dev)] = (loss.item(), m["aux_loss"].item(),
                         [a.grad.cpu() for a in tree_leaves(p)])
    (lc, ac, gc), (lg, ag, gg) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    np.testing.assert_allclose(ag, ac, rtol=1e-5)
    for g, w in zip(gg, gc):
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max())
