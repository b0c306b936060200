"""Attention and MLA layers without an MLP, and a checkpoint restored
with a partial shardings tree, against the JAX package's, on the CPU.

The JAX package builds ``("attn", "none")`` and ``("mla", "none")``
layers (``repro.models.transformer.layer_schema``): the mixer's output
is the layer's last, and the next layer's fused norm adds it.  Two
smoke configs put such a layer before a layer with an MLP and at the
end of the stack, where the final norm adds it: Yi-6B (``("attn",
"none")``, ``("attn", "dense")``, then ``("attn", "none")``) and
DeepSeek-V2 (the same with MLA, the middle layer a MoE one), f32.  The
same JAX parameters go through ``params_from_numpy``; the same prompts
and batches, made with numpy from a seed, go into ``repro.models.model``
and the port:

* prefill and four greedy decode steps: logits within 1e-4·max|logit|
  and the same tokens (``tests/test_torch_deepseek.py``'s bound);
* the loss within 1e-5 relative and every gradient leaf within
  1e-4·max|g| of ``jax.grad`` (``tests/test_torch_train.py``'s);
* the kernel calls of a prefill, a decode step and a rematerialised
  training step equal to ``launches_per_pass``: no ``norm2`` seam in a
  layer without an MLP.

``CheckpointManager.restore(..., shardings=)`` with a tree that gives
some leaves no sharding (``None``, or absent) places the others on a
one-rank gloo mesh and returns those as the restore without shardings
does; every value bitwise the JAX package's restore of the same
checkpoint with the same partial tree.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402,E501
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import BlockDef as JBlockDef  # noqa: E402
from repro.configs.shapes import SMOKE_SHAPES as JSMOKE_SHAPES  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as JPipeline  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import RunConfig, get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import BlockDef  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.runtime import serve_step  # noqa: E402
from repro_torch.runtime import train_step as TS  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

B, S, STEPS = 2, 16, 4
LOGIT_SHARE = 1e-4
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4
LOSS_CHUNK = 16

#: arch -> its smoke config's layers: a layer without an MLP before one
#: with an MLP, and one at the end of the stack
PATTERNS = {
    "yi-6b": ((("attn", "none"), ("attn", "dense")), (("attn", "none"),)),
    "deepseek-v2-236b": ((("mla", "none"), ("mla", "moe")),
                         (("mla", "none"),)),
}


def _cfgs(arch):
    blocks = PATTERNS[arch]
    n = sum(map(len, blocks))
    j = dataclasses.replace(
        jsmoke_config(jget_config(arch)), num_layers=n,
        blocks=tuple(JBlockDef(p, 1) for p in blocks))
    t = dataclasses.replace(
        smoke_config(get_config(arch)), num_layers=n,
        blocks=tuple(BlockDef(p, 1) for p in blocks))
    return j, t


@pytest.fixture(scope="module", params=sorted(PATTERNS))
def model(request):
    jc, tc = _cfgs(request.param)
    jp = jinit_params(JM.schema(jc), jax.random.key(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def _share(got, want, share):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    diff = float(np.abs(got - want).max())
    assert diff <= share * float(np.abs(want).max()), diff


def test_layer_kinds_are_served():
    for kind in (("attn", "none"), ("mla", "none")):
        assert kind in transformer.LAYER_KINDS
    for arch in PATTERNS:
        _, tc = _cfgs(arch)
        sch = M.schema(tc)
        assert set(sch["b0"]["l0"]) == {"norm1", "mixer"}
        assert set(sch["b1"]["l0"]) == {"norm1", "mixer"}
        assert "mlp" in sch["b0"]["l1"]
    with pytest.raises(NotImplementedError):
        transformer.layer_schema(_cfgs("yi-6b")[1], "attn", "wide")


def test_prefill_and_decode_match_jax(model):
    jc, jp, tc, tp = model
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, (B, S - 1))
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)},
                            max_seq=S + STEPS)
    tl, tcache = serve_step.build_prefill(tc, max_seq=S + STEPS)(
        tp, {"tokens": torch.from_numpy(toks)})
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
    for g, w in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
        _share(g, w, LOGIT_SHARE)


def test_loss_and_grads_match_jax(model):
    jc, jp, tc, _ = model
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu",
                           train=True)
    shape = JSMOKE_SHAPES["train_4k"]
    jb = JPipeline(jc, shape).batch_at(0)
    tb = SyntheticLMPipeline(tc, shape).batch_at(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jc, p, b, loss_chunk=LOSS_CHUNK),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in jb.items()})
    tl, tm, tg = TS.loss_and_grads(tc, RunConfig(loss_chunk=LOSS_CHUNK), tp,
                                   tb)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["aux_loss"].item(), float(jm["aux_loss"]),
                               rtol=LOSS_RTOL)
    gl, wl = tree_leaves(tg), jax.tree.leaves(jg)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        _share(g, w, GRAD_SHARE)


def test_kernel_calls_per_pass(model, monkeypatch):
    """Flash once per attention or MLA layer in prefill and training,
    none in decode; the fused norm at ``norm1`` of every layer,
    ``norm2`` of the one layer with an MLP, and the final norm."""
    _, jp, tc, tp = model
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
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, tc.vocab_size, (B, S)))
    _, cache = M.prefill(tc, tp, {"tokens": toks}, max_seq=S + 1)
    want = M.launches_per_pass(tc, "prefill")
    assert calls == want == {"flash_attention": 3, "rmsnorm_residual": 5}
    calls.update({k: 0 for k in calls})
    M.decode_step(tc, tp, cache, {"token": toks[:, 0], "pos": S})
    assert calls == M.launches_per_pass(tc, "decode") == {
        "flash_attention": 0, "rmsnorm_residual": 5}
    train_p = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu",
                                train=True)
    calls.update({k: 0 for k in calls})
    TS.loss_and_grads(tc, RunConfig(loss_chunk=LOSS_CHUNK, remat="full"),
                      train_p, {"tokens": toks})
    # every layer's launches twice (the recompute), the final norm's once
    assert calls == M.launches_per_pass(tc, "train", "full") == {
        "flash_attention": 6, "rmsnorm_residual": 9}


# ---------------------------------------------------------------------------
# restore with a partial shardings tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_mesh():
    assert not dist.is_initialized()
    mesh = tmesh.make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def _state():
    rng = np.random.default_rng(9)
    w = rng.standard_normal((4, 6), dtype=np.float32)
    return {
        "params": {"w": torch.from_numpy(w),
                   "b": torch.from_numpy(
                       rng.standard_normal(6, dtype=np.float32)).to(
                           torch.bfloat16)},
        "opt": {"m": torch.from_numpy(
                    rng.standard_normal((4, 6), dtype=np.float32)),
                "count": torch.tensor(7, dtype=torch.int32)},
    }


def _bits(a) -> np.ndarray:
    a = np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                   and a.dtype == torch.bfloat16 else a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def test_restore_with_a_partial_shardings_tree_equals_jax(host_mesh,
                                                          tmp_path):
    from torch.distributed.tensor import DTensor

    state = _state()
    CheckpointManager(tmp_path, async_save=False).save(3, state)
    rules = R.make_rules(host_mesh)
    w_sh = rules.sharding(("embed", "mlp"), (4, 6))
    m_sh = rules.sharding(("embed", None), (4, 6))
    # "w" and "m" placed; "b" None; "count" absent
    shardings = {"params": {"w": w_sh, "b": None}, "opt": {"m": m_sh}}
    got, _ = CheckpointManager(tmp_path, async_save=False).restore(
        state, step=3, shardings=shardings)
    plain, _ = CheckpointManager(tmp_path, async_save=False).restore(
        state, step=3)
    for name in ("w", "m"):
        leaf = got["params" if name == "w" else "opt"][name]
        assert isinstance(leaf, DTensor) and leaf.device_mesh is host_mesh
    assert got["params"]["w"].placements == w_sh.placements
    for grp, name in (("params", "b"), ("opt", "count")):
        leaf = got[grp][name]
        assert type(leaf) is torch.Tensor and leaf.device.type == "cpu"
        assert leaf.dtype == plain[grp][name].dtype
        assert torch.equal(leaf, plain[grp][name])

    dev = jax.devices()[0]
    jsh = jax.sharding.SingleDeviceSharding(dev)
    target = jax.tree.map(
        lambda t: jax.ShapeDtypeStruct(
            tuple(t.shape), {torch.float32: jnp.float32,
                             torch.bfloat16: jnp.bfloat16,
                             torch.int32: jnp.int32}[t.dtype]), state)
    jgot, _ = JManager(tmp_path, async_save=False).restore(
        target, step=3, shardings={"params": {"w": jsh, "b": None},
                                   "opt": {"m": jsh}})
    for grp in state:
        for name, leaf in got[grp].items():
            if isinstance(leaf, DTensor):
                leaf = leaf.full_tensor()
            want = jgot[grp][name]
            assert leaf.dtype == state[grp][name].dtype
            np.testing.assert_array_equal(
                _bits(leaf), _bits(np.asarray(want, np.float32)
                                   if want.dtype == jnp.bfloat16
                                   else np.asarray(want)))
            np.testing.assert_array_equal(_bits(leaf),
                                          _bits(state[grp][name]))
