"""The port's DeepSeek-V2 and -V3 (multi-head latent attention over
mixture-of-experts layers, V3 with its multi-token-prediction head)
against the JAX package's model, on the CPU.

The smoke configs (``repro.configs.smoke_config``: one dense and one MoE
layer, d_model 64, MLA q_lora 32, kv_lora 32, q·k over 24, v 16, 8
experts top-2 with one shared), f32.  The same JAX parameters go through
``params_from_numpy``; the same prompts and batches, made with numpy
from a seed, go into ``repro.models.model`` and the port:

* prefill and eight decode steps: logits within 1e-4·max|logit| and
  identical greedy tokens; every cache leaf (the latent ``ckv`` and
  ``kpe``) within 1e-4·max|leaf|;
* routing at a capacity factor of 1, where the MoE layer drops
  assignments: the same expert choices and the same drops as the JAX
  package's ``route`` and queue on the same layer inputs, and the logits
  within 1e-4·max|logit|;
* V3's ``loss_fn`` with the MTP head: the loss and ``mtp_loss`` within
  1e-5 relative, every gradient leaf within 1e-4·max|g| of ``jax.grad``;
* ``params_from_numpy`` carries the MTP subtree, and parameters drawn by
  the port give the JAX package the same loss (both directions);
* the kernel calls per pass of ``launches_per_pass``, MTP included.
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
from repro.models import moe as JMOE  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params,
    map_specs,
    tree_leaves,
    tree_map,
)
from repro_torch.runtime import serve_step  # noqa: E402

ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b")
B, S, STEPS = 2, 24, 8
LOGIT_SHARE = 1e-4
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4


def _cfgs(arch, **moe):
    j, t = jsmoke_config(jget_config(arch)), smoke_config(get_config(arch))
    if moe:
        j = dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe))
    return j, t


def _model(arch, **moe):
    jc, tc = _cfgs(arch, **moe)
    jp = jinit_params(JM.schema(jc), jax.random.key(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


def _prompts(vocab, s=S, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (B, s))


def _share(got, want, share):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    diff = float(np.abs(got - want).max())
    assert diff <= share * float(np.abs(want).max()), diff


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax_field_for_field(arch, smoke):
    j, t = jget_config(arch), get_config(arch)
    if smoke:
        j, t = jsmoke_config(j), smoke_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.mla is not None and t.moe.ep_over_dp


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch, smoke):
    """Total and active counts, the MTP head's leaves included (V3):
    235.7 B / 21.4 B and 671.7 B / 38.2 B at full size."""
    j, t = jget_config(arch), get_config(arch)
    if smoke:
        j, t = jsmoke_config(j), smoke_config(t)
    assert M.param_counts(t) == JM.param_counts(j)
    if not smoke:
        total, active = M.param_counts(t)
        want = {"deepseek-v2-236b": (2.357e11, 2.14e10),
                "deepseek-v3-671b": (6.717e11, 3.82e10)}[arch]
        assert abs(total / want[0] - 1) < 1e-3
        assert abs(active / want[1] - 1) < 3e-3


def _jschema(sch):
    return jax.tree.map(lambda s: (s.shape, jnp.dtype(s.dtype).name), sch,
                        is_leaf=lambda x: hasattr(x, "init"))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_schema_is_jax_schema(arch):
    """The full config (bf16 parameters) leaf for leaf, the router f32,
    V3's ``mtp`` subtree an MLA layer with a dense MLP."""
    j, t = jget_config(arch), get_config(arch)
    got = map_specs(lambda _, s: (s.shape, str(s.dtype).split(".")[-1]),
                    M.train_schema(t))
    assert got == _jschema(JM.schema(j))
    assert got["b1"]["l0"]["mlp"]["router"][1] == "float32"
    assert ("mtp" in got) == t.mtp
    if t.mtp:
        assert set(got["mtp"]) == {"norm_h", "norm_e", "proj", "layer",
                                   "final_norm"}
        assert got["mtp"]["layer"]["mixer"]["wkv_b"][0] == (512, 128, 256)
        assert got["mtp"]["proj"][0] == (2 * 7168, 7168)


def test_prefill_and_decode_match_jax(model):
    """Prefill S − 1 tokens into a cache of S + STEPS positions, then
    STEPS greedy decode steps in both packages: logits, tokens and the
    latent cache."""
    jc, jp, tc, tp = model
    toks = _prompts(tc.vocab_size, S - 1)
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)},
                            max_seq=S + STEPS)
    tl, tcache = serve_step.build_prefill(tc, max_seq=S + STEPS)(
        tp, {"tokens": torch.from_numpy(toks)})
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
    assert set(tcache["b0"]["l0"]["mixer"]) == {"ckv", "kpe"}
    for g, w in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
        _share(g, w, LOGIT_SHARE)


def test_prefill_decode_consistency(model):
    """The serving invariant (``tests/test_archs_smoke.py``): the full
    prompt's logits equal prefill(S − 1) + one absorbed decode step."""
    _, _, tc, tp = model
    toks = torch.from_numpy(_prompts(tc.vocab_size, 32, seed=1))
    full, _ = M.prefill(tc, tp, {"tokens": toks})
    _, cache = M.prefill(tc, tp, {"tokens": toks[:, :31]}, max_seq=32)
    dec, new = M.decode_step(tc, tp, cache, {"token": toks[:, 31], "pos": 31})
    assert float((full - dec).abs().max()) < 2e-4
    assert new is cache


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_drops_match_jax(arch, monkeypatch):
    """At a capacity factor of 1 (C = 4 slots an expert in a group of
    16 tokens, top-2 of 8) the MoE layer drops assignments: each group's
    expert ids and dropped assignments equal the JAX package's on the
    same inputs, and the logits stay within 1e-4·max|logit|."""
    jc, jp, tc, tp = _model(arch, capacity_factor=1.0)
    seen = []
    group0 = moe_mod._GROUP_FNS["einsum"]

    def group(cfg, p, x_g, C):
        seen.append((x_g.clone(), C))
        return group0(cfg, p, x_g, C)

    monkeypatch.setitem(moe_mod._GROUP_FNS, "einsum", group)
    toks = _prompts(tc.vocab_size, 32, seed=3)
    tl, _ = M.prefill(tc, tp, {"tokens": torch.from_numpy(toks)})
    jl, _ = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)})
    _share(tl, jl, LOGIT_SHARE)
    jmoe = jax.tree.map(lambda a: a[0], jp["b1"])["l0"]["mlp"]
    tmoe = tree_map(lambda a: a[0], tp["b1"])["l0"]["mlp"]
    assert len(seen) == 4   # 64 tokens in groups of 16
    dropped = 0
    for x_g, C in seen:
        assert C == JMOE.expert_capacity(16, jc) == 4
        _, tidx, tmask, _, _ = moe_mod.route(tc, tmoe, x_g.float())
        _, jidx, jmask, _, _ = JMOE.route(jc, jmoe, jnp.asarray(x_g.numpy()))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        tdrop = (moe_mod._positions_in_expert(tmask) >= C).numpy()
        jdrop = np.asarray(JMOE._positions_in_expert(jmask) >= C)
        np.testing.assert_array_equal(tdrop, jdrop)
        dropped += int(tdrop.sum())
    assert dropped > 0


def _batch(vocab, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, 32)).astype(np.int32)
    mask = (rng.uniform(size=(B, 32)) > 0.1).astype(np.float32)
    return toks, mask


def _jax_loss(jc, jp, toks, mask):
    batch = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
    return jax.value_and_grad(
        lambda p: JM.loss_fn(jc, p, batch, loss_chunk=16, remat="none"),
        has_aux=True)(jp)


def test_mtp_loss_and_grads_match_jax():
    """V3: the next-token NLL, the MoE aux terms and the MTP head's NLL
    of the token after next (weight 0.3), and every gradient leaf, the
    ``mtp`` subtree's included."""
    jc, jp, tc, _ = _model("deepseek-v3-671b")
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu",
                           train=True)
    toks, mask = _batch(tc.vocab_size)
    (jl, jm), jg = _jax_loss(jc, jp, toks, mask)
    p = tree_map(lambda a: a.clone().requires_grad_(True), tp)
    tl, tm = M.loss_fn(tc, p, {"tokens": torch.from_numpy(toks),
                               "loss_mask": torch.from_numpy(mask)},
                       loss_chunk=16, remat="none")
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    assert float(jm["mtp_loss"]) > 0
    np.testing.assert_allclose(tm["mtp_loss"].item(), float(jm["mtp_loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["aux_loss"].item(), float(jm["aux_loss"]),
                               rtol=1e-6)
    paths = [jax.tree_util.keystr(q)
             for q, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    got, want = tree_leaves(tree_map(lambda a: a.grad, p)), \
        jax.tree.leaves(jg)
    assert len(got) == len(want)
    assert any("mtp" in q for q in paths)
    for path, g, w in zip(paths, got, want):
        w = np.asarray(w, np.float64)
        diff = float(np.abs(g.numpy() - w).max())
        assert diff <= GRAD_SHARE * float(np.abs(w).max()), (path, diff)


def test_port_parameters_give_jax_the_same_loss():
    """The other direction: V3's parameters drawn by the port
    (``train_schema``, MTP included) as numpy into the JAX package's
    pytree give the same loss and ``mtp_loss``."""
    jc, tc = _cfgs("deepseek-v3-671b")
    tp = init_params(M.train_schema(tc), torch.Generator().manual_seed(4),
                     "cpu")
    jp = jax.tree.map(lambda a: jnp.asarray(a), tree_map(
        lambda t: t.numpy(), tp))
    assert jax.tree.structure(jp) == jax.tree.structure(
        jinit_params(JM.schema(jc), jax.random.key(0)))
    toks, mask = _batch(tc.vocab_size, seed=5)
    (jl, jm), _ = _jax_loss(jc, jp, toks, mask)
    with torch.no_grad():
        tl, tm = M.loss_fn(tc, tp, {"tokens": torch.from_numpy(toks),
                                    "loss_mask": torch.from_numpy(mask)},
                           loss_chunk=16)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["mtp_loss"].item(), float(jm["mtp_loss"]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_calls_per_pass(arch, monkeypatch):
    """The fused norm at both seams of every layer and the final norm,
    flash once per MLA layer in prefill and none in decode; in training
    V3's MTP head adds one flash and five norms."""
    jc, jp, tc, tp = _model(arch)
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
    assert calls == M.launches_per_pass(tc, "prefill") == {
        "flash_attention": 2, "rmsnorm_residual": 5}
    calls.update({k: 0 for k in calls})
    M.decode_step(tc, tp, cache, {"token": toks[:, 0], "pos": S})
    assert calls == M.launches_per_pass(tc, "decode")
    calls.update({k: 0 for k in calls})
    tr, mask = _batch(tc.vocab_size)
    M.loss_fn(tc, tp, {"tokens": torch.from_numpy(tr),
                       "loss_mask": torch.from_numpy(mask)}, loss_chunk=16)
    assert calls == M.launches_per_pass(tc, "train") == {
        "flash_attention": 2 + tc.mtp, "rmsnorm_residual": 5 + 5 * tc.mtp}
    full = get_config(arch)
    assert M.launches_per_pass(full, "prefill") == {
        "flash_attention": full.num_layers,
        "rmsnorm_residual": 2 * full.num_layers + 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(ln.startswith("[serve]") for ln in lines)
    assert tuple(res.tokens.shape) == (2, 4)
    zero = {"flash_attention": 0, "rmsnorm_residual": 0}
    assert res.launches == {"prefill": zero, "decode": zero}
