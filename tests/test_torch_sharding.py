"""The port's placements (``sharding/rules.py``, ``launch/mesh.py``)
against the JAX package's rules, with no ranks; the kernels' DTensor
branch on a one-rank gloo mesh.

Check 1: for every config the port registers, full and smoke, each
leaf's spec from the port's rules equals ``tuple()`` of the JAX
``PartitionSpec`` that ``repro.sharding.rules`` gives on a
``jax.sharding.AbstractMesh`` of the same axis sizes — the parameters,
the ZeRO-1 specs of the optimizer state (AdamW, 8-bit AdamW,
Adafactor), the decode cache under the serve rules and the train
inputs' batch specs — at (1, 1), (2, 2) and (16, 16) ("data", "model")
and (2, 2, 2) and (2, 16, 16) ("pod", "data", "model"), under both
phases' rules and ``flat_dp`` both ways.  Specs are metadata, so the
full configs cost no memory.  One case per (config, mesh, phase).

The JAX 8-bit AdamW schema gives a bare spec for the moments of a leaf
too small to quantise where its state (and the port's schema) holds
``{"q": ...}`` (ROADMAP caveat 8): such a ``q`` is compared with the
JAX leaf one level up.

The activation placements at the MLA and MoE ``shard`` sites (the JAX
package's ``models/mla.py`` and ``models/moe.py``) equal the JAX ones
too: each package's ``shard`` is replaced by a recorder of (logical
axes, shape, the rules' spec), and the MoE layer, MLA's prefill with
its cache and one decode step run at full width on abstract values
(``jax.eval_shape``; the port on the meta device) under rules on
``AbstractMesh``es up to (2, 16, 16), for DeepSeek-V2 (both MoE
layouts), -V3 and Jamba.  The expert-parallel body has no site in the
JAX package; it is stubbed in both.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.configs.shapes import SMOKE_SHAPES as JSMOKE_SHAPES  # noqa: E402
from repro.configs.shapes import input_specs as jinput_specs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.runtime import train_step as JTS  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)

from repro_torch.configs import RunConfig, get_config, smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.local import LOCAL_MAP_CALLS  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm_residual  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_residual_ref  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_chunk  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunk_ref  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.params import map_specs  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.runtime import serve_step as SS  # noqa: E402
from repro_torch.runtime import train_step as TS  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")
#: decode caches: a long-context batch (< 8) and a wide one
CACHES = ((1, 128), (16, 64))
#: the train inputs: the full cell (B=256) and the smoke one (B=4)
TRAIN_SHAPES = (JSHAPES["train_4k"], JSMOKE_SHAPES["train_4k"])


def _walk(tree, path=()):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_walk(v, path + (k,)))
        return out
    return {path: tree}


def _same(jtree, ttree, what):
    """Every port spec equals tuple() of the JAX spec at its path; the
    trees hold the same leaves."""
    jl, tl = _walk(jtree), _walk(ttree)
    seen = set()
    for path, t in tl.items():
        jpath = path
        if jpath not in jl and path[-1] == "q" and path[:-1] in jl:
            jpath = path[:-1]               # caveat 8: JAX's bare spec
        assert jpath in jl, (what, path)
        j = jl[jpath]
        assert isinstance(j, JP) and isinstance(t, R.PartitionSpec)
        assert t == tuple(j), (what, path, t, j)
        seen.add(jpath)
    assert seen == set(jl), (what, set(jl) - seen)


def _cfgs(name, smoke):
    j, t = jget_config(name), get_config(name)
    return (jsmoke_config(j), smoke_config(t)) if smoke else (j, t)


CASES = [(name, smoke, mesh, phase) for name in ALL_ARCHS
         for smoke in (False, True) for mesh in MESHES
         for phase in ("train", "serve")]


@pytest.mark.parametrize(
    "name,smoke,mesh,phase", CASES,
    ids=[f"{n}{'-smoke' if s else ''}-{m}-{p}" for n, s, m, p in CASES])
def test_specs_equal_jax(name, smoke, mesh, phase):
    jc, tc = _cfgs(name, smoke)
    shape, axes = MESHES[mesh]
    for flat_dp in (False, True):
        jr = JR.make_rules(JAbstractMesh(shape, axes), phase, flat_dp)
        tr = R.make_rules(R.AbstractMesh(shape, axes), phase, flat_dp)
        tag = f"{name} {mesh} {phase} flat_dp={flat_dp}"
        assert tr.rules == jr.rules
        _same(JR.param_pspecs(JM.schema(jc), jr),
              R.param_pspecs(M.schema(tc), tr), f"params {tag}")
        for opt in OPTIMIZERS:
            jo = jmake_optimizer(opt).state_schema(JM.schema(jc))
            to = make_optimizer(opt).state_schema(M.train_schema(tc))
            _same(JR.zero1_pspecs(jo, jr), R.zero1_pspecs(to, tr),
                  f"{opt} zero1 {tag}")
        for b, s in CACHES:
            _same(JR.param_pspecs(JM.cache_schema(jc, b, s), jr),
                  R.param_pspecs(M.cache_schema(tc, b, s), tr),
                  f"cache {b}x{s} {tag}")
        for cell in TRAIN_SHAPES:
            specs = jinput_specs(jc, cell)
            want = JTS.batch_pspecs(specs, jr)
            got = TS.batch_pspecs(specs, tr)
            assert set(got) == set(want)
            for k in want:
                assert got[k] == tuple(want[k]), (tag, cell, k)


#: (config, ep_over_dp override) of the activation-site check
SITE_ARCHS = (("deepseek-v2-236b", None), ("deepseek-v2-236b", False),
              ("deepseek-v3-671b", None), ("jamba-v0.1-52b", None))
#: (B, S) of the site check: a training batch, a long-context prompt
SITE_SHAPES = ((256, 4096), (1, 8192))
SITE_MESHES = ("2x2", "16x16", "2x16x16")


def _recorder(out, current):
    def shard(x, *axes):
        shape = tuple(x.shape)
        out.add((axes, shape, tuple(current().spec(axes, shape))))
        return x
    return shard


def _jax_sites(jc, B, S, rules, monkeypatch):
    """The JAX package's site records of one MoE layer, one MLA prefill
    with its cache and one MLA decode step."""
    out = set()
    rec = _recorder(out, JR.current_rules)
    monkeypatch.setattr(JMOE, "shard", rec)
    monkeypatch.setattr(JMLA, "shard", rec)
    monkeypatch.setattr(JMOE, "apply_moe_ep", lambda cfg, p, x: (
        x, jnp.zeros(()), jnp.zeros(())))
    dt = jnp.dtype(jc.compute_dtype)

    def run(moe_p, mla_p, x, cache):
        JMOE.apply_moe(jc, moe_p, x)
        if jc.mla is None:
            return 0
        long = B < 8
        JMLA.apply_mla_full(jc, mla_p, x, rope_cs=JM.rope_full(jc, S),
                            return_cache=True, long=long)
        pos = jnp.asarray(S - 1)
        JMLA.apply_mla_decode(jc, mla_p, x[:, 0], cache, pos,
                              rope_cs=JM.rope_decode(jc, pos), long=long)
        return 0

    mla_p = JR.abstract_params(JMLA.mla_schema(jc)) if jc.mla else None
    cache = None
    if jc.mla:
        m = jc.mla
        cache = {"ckv": jax.ShapeDtypeStruct((B, S, m.kv_lora_rank), dt),
                 "kpe": jax.ShapeDtypeStruct((B, S, m.qk_rope_head_dim), dt)}
    with JR.axis_rules(rules):
        jax.eval_shape(run, JR.abstract_params(JMOE.moe_schema(jc)), mla_p,
                       jax.ShapeDtypeStruct((B, S, jc.d_model), dt), cache)
    return out


def _port_sites(tc, B, S, rules, monkeypatch):
    """The port's site records of the same calls, on the meta device."""
    out = set()
    rec = _recorder(out, R.current_rules)
    monkeypatch.setattr(TMOE, "shard", rec)
    monkeypatch.setattr(TMLA, "shard", rec)
    monkeypatch.setattr(TMOE, "apply_moe_ep", lambda cfg, p, x: (
        x, torch.zeros(()), torch.zeros(())))
    monkeypatch.setattr(tattn, "attention", lambda q, k, v, causal: (
        q.new_empty(*q.shape[:3], v.shape[-1])))

    def meta(schema):
        return map_specs(lambda _, s: torch.empty(
            s.shape, dtype=s.dtype, device="meta"), schema)

    x = torch.empty((B, S, tc.d_model), dtype=tc.cdtype, device="meta")
    with R.axis_rules(rules):
        TMOE.apply_moe(tc, meta(TMOE.moe_schema(tc)), x)
        if tc.mla is not None:
            p = meta(TMLA.mla_schema(tc))
            cache = meta(TMLA.mla_cache_schema(tc, B, S))
            TMLA.apply_mla_full(tc, p, x, rope_cs=M.rope_full(tc, S, "meta"),
                                cache=cache)
            TMLA.apply_mla_decode(tc, p, x[:, 0], cache, S - 1,
                                  rope_cs=M.rope_decode(tc, S - 1, "meta"))
    return out


SITE_CASES = [(a, ep, mesh, phase) for a, ep in SITE_ARCHS
              for mesh in SITE_MESHES for phase in ("train", "serve")]


@pytest.mark.parametrize(
    "arch,ep,mesh,phase", SITE_CASES,
    ids=[f"{a}{'' if ep is None else '-grouped'}-{m}-{p}"
         for a, ep, m, p in SITE_CASES])
def test_mla_and_moe_activation_specs_equal_jax(arch, ep, mesh, phase,
                                                 monkeypatch):
    """Every (axes, shape, spec) the JAX package's MLA and MoE ``shard``
    sites record, the port's record too, and no other: the grouped MoE
    path's nine sites (Jamba, V2 with ``ep_over_dp`` off), the shared
    expert's (DeepSeek) and MLA's seven (prefill's q, k, output and
    latent cache, decode's latent cache)."""
    jc, tc = jget_config(arch), get_config(arch)
    if ep is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, ep_over_dp=ep))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, ep_over_dp=ep))
    shape, axes = MESHES[mesh]
    jr = JR.make_rules(JAbstractMesh(shape, axes), phase)
    tr = R.make_rules(R.AbstractMesh(shape, axes), phase)
    for B, S in SITE_SHAPES:
        want = _jax_sites(jc, B, S, jr, monkeypatch)
        got = _port_sites(tc, B, S, tr, monkeypatch)
        assert got == want, (B, S, got ^ want)
        # every site the path reaches was recorded: the scan input only
        # where the shard holds more than one group
        need, scan = set(), {(None, "batch", None, None)}
        if not tc.moe.ep_over_dp:
            need |= {("batch", None, None, None),
                     ("batch", None, "experts", None),
                     ("batch", "experts", None, None),
                     ("batch", None, None), ("batch", None, "d_model")}
        if tc.moe.num_shared_experts:
            need.add(("batch", None, "mlp"))
        if tc.mla is not None:
            need |= {("batch", None, "heads", None),
                     ("batch", None, "d_model"),
                     ("batch", "kv_seq_long" if B < 8 else "kv_seq", None)}
        seen = {a for a, _, _ in got}
        assert need <= seen <= need | scan, (B, S, seen)


def test_rule_tables_and_resolution_match_jax():
    assert R.TRAIN_RULES == JR.TRAIN_RULES
    assert R.SERVE_RULES == JR.SERVE_RULES
    m = ((2, 16, 16), ("pod", "data", "model"))
    jr = JR.make_rules(JAbstractMesh(*m))
    tr = R.make_rules(R.AbstractMesh(*m))
    for names, dims in ((("batch", None), (64, 8)),
                        (("batch", "seq", "heads", None), (32, 8, 48, 4)),
                        (("kv_heads", "heads"), (16, 32)),
                        (("embed", "mlp"), (4096, 11008)),
                        (("heads",), (20,)),
                        (("kv_seq_long", "vocab"), (256, 64000))):
        assert tr.spec(names, dims) == tuple(jr.spec(names, dims))
        assert tr.zero1_spec(names, dims) == \
            tuple(jr.zero1_spec(names, dims))
        taken_j, taken_t = set(), set()
        for n, d in zip(names, dims):
            assert tr.resolve_dim(n, d, taken_t) == \
                jr.resolve_dim(n, d, taken_j)
        assert taken_t == taken_j
    assert tr.mesh_axis_size(("pod", "data")) == \
        jr.mesh_axis_size(("pod", "data")) == 32
    with pytest.raises(ValueError):
        tr.spec(("batch",), (4, 4))


def test_placements_from_specs():
    am = R.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    rules = R.make_rules(am)
    # ("pod", "data") shards dim 0 pod-major, "model" dim 2
    assert rules.placements(("batch", None, "heads"), (64, 3, 32)) == \
        (Shard(0), Shard(0), Shard(2))
    assert rules.placements((None,), (5,)) == (Replicate(),) * 3
    s = rules.sharding(("embed", "mlp"), (4096, 11008))
    assert s.spec == ("data", "model")
    assert s.placements == (Replicate(), Shard(0), Shard(1))
    assert s.mesh is am
    z = rules.zero1_sharding(("layers", "mlp"), (32, 11008))
    assert z.spec == ("data", "model")
    with pytest.raises(ValueError, match="order"):
        R.spec_placements(am, (("data", "pod"),))
    with pytest.raises(ValueError):
        R.AbstractMesh((2, 2), ("data",))


def test_mesh_helpers_match_jax():
    assert tmesh.legal_slice_shapes() == jmesh.legal_slice_shapes()
    assert tmesh.legal_slice_shapes(64) == jmesh.legal_slice_shapes(64)
    with pytest.raises(RuntimeError):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")


def test_host_mesh_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh((1, 1), ("data", "model"))
    assert not dist.is_initialized()


def test_shard_is_a_no_op_without_rules_or_dtensor():
    x = torch.randn(4, 3)
    assert R.shard(x, "batch", None) is x
    am = R.make_rules(R.AbstractMesh((2, 2), ("data", "model")))
    with R.axis_rules(am):
        assert R.current_rules() is am
        assert R.shard(x, "batch", None) is x
        with R.axis_rules(None):
            assert R.current_rules() is None
        assert R.current_rules() is am
    assert R.current_rules() is None
    assert R.replicate_dims(x, 0) is x


def test_serve_shardings_follow_the_rules():
    rules = R.make_rules(R.AbstractMesh((2, 16, 16),
                                        ("pod", "data", "model")), "serve")
    jr = JR.make_rules(JAbstractMesh((2, 16, 16), ("pod", "data", "model")),
                       "serve")
    tc, jc = get_config("yi-6b"), jget_config("yi-6b")
    got = SS.cache_shardings(tc, 16, 64, rules)
    want = _walk(JR.param_pspecs(JM.cache_schema(jc, 16, 64), jr))
    for path, s in _walk(got).items():
        assert s.spec == tuple(want[path])
        assert s.placements == R.spec_placements(rules.mesh, s.spec)
    specs = {"tokens": torch.zeros(32, 8), "pos": torch.zeros(())}
    ins = SS.serve_input_shardings(specs, rules)
    assert ins["tokens"].spec == (("pod", "data"),)
    assert ins["pos"].spec == ()


# ---------------------------------------------------------------------------
# one rank: the mesh, the DTensor branch of each kernel wrapper
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_mesh():
    assert not dist.is_initialized()
    mesh = tmesh.make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_host_mesh_is_one_rank(host_mesh):
    assert tuple(host_mesh.shape) == (1, 1)
    assert host_mesh.mesh_dim_names == ("data", "model")
    assert tmesh.chips(host_mesh) == 1
    rules = R.make_rules(host_mesh)
    assert all(p == Replicate() for p in
               rules.placements(("batch", "heads"), (4, 8)))


def _dt(mesh, t, placements=None):
    placements = placements or (Replicate(),) * mesh.ndim
    return distribute_tensor(t, mesh, placements)


def test_kernel_wrappers_take_dtensors_through_local_map(host_mesh):
    """Each wrapper's DTensor branch runs the plain version on the local
    shard, bitwise the wrapper's plain-tensor result, with gradients."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 8, 16, generator=g)
    k = torch.randn(2, 2, 8, 16, generator=g)
    v = torch.randn(2, 2, 8, 16, generator=g)
    x = torch.randn(6, 32, generator=g)
    res = torch.randn(6, 32, generator=g)
    scale = torch.randn(32, generator=g)
    xdt = torch.randn(2, 2, 8, 4, generator=g)
    bb = torch.randn(2, 2, 8, 3, generator=g)
    cc = torch.randn(2, 2, 8, 3, generator=g)
    csum = -torch.rand(2, 2, 8, generator=g).cumsum(-1)
    before = dict(LOCAL_MAP_CALLS)
    m = host_mesh
    a = attention(_dt(m, q), _dt(m, k), _dt(m, v), causal=True)
    assert isinstance(a, DTensor)
    assert torch.equal(a.full_tensor(), attention_ref(q, k, v, causal=True))
    h, s = rmsnorm_residual(_dt(m, x), _dt(m, res), _dt(m, scale), 1e-5)
    wh, ws = rmsnorm_residual_ref(x, res, scale, 1e-5)
    assert torch.equal(h.full_tensor(), wh) and torch.equal(s.full_tensor(),
                                                            ws)
    y, st = ssd_chunk(_dt(m, xdt), _dt(m, bb), _dt(m, cc), _dt(m, csum))
    wy, wst = ssd_chunk_ref(xdt, bb, cc, csum)
    assert torch.equal(y.full_tensor(), wy)
    assert torch.equal(st.full_tensor(), wst)
    assert {k_: LOCAL_MAP_CALLS[k_] - before[k_] for k_ in before} == \
        {"flash_attention": 1, "rmsnorm_residual": 1, "ssd_chunk": 1}
    # gradients through the branch equal the plain version's
    qd = _dt(m, q).requires_grad_()
    out = attention(qd, _dt(m, k), _dt(m, v), causal=True)
    (gq,) = torch.autograd.grad(out.sum(), qd)
    ql = q.clone().requires_grad_()
    (wq,) = torch.autograd.grad(attention_ref(ql, k, v).sum(), ql)
    assert torch.equal(gq.full_tensor(), wq)


def test_a_sharded_dim_the_kernel_is_not_parallel_over_is_gathered(
        host_mesh):
    """d_model sharded into the norm, the sequence into attention: the
    branch gathers them (here on one rank the shard is the whole)."""
    m = host_mesh
    x = torch.randn(4, 16)
    h, s = rmsnorm_residual(_dt(m, x, (Shard(1), Shard(0))),
                            _dt(m, x), _dt(m, torch.ones(16)), 1e-5)
    assert h.placements == (Replicate(), Shard(0))
    wh, _ = rmsnorm_residual_ref(x, x, torch.ones(16), 1e-5)
    assert torch.equal(h.full_tensor(), wh)
    q = torch.randn(1, 2, 8, 16)
    a = attention(_dt(m, q, (Shard(2), Shard(1))), _dt(m, q), _dt(m, q))
    assert a.placements == (Replicate(), Shard(1))
    assert torch.equal(a.full_tensor(), attention_ref(q, q, q))


def test_train_state_on_one_rank_mesh_is_whole(host_mesh):
    """On the one-rank mesh the parameters are replicated; ZeRO-1 puts
    the optimizer state's largest dim on "data" (size 1, as the JAX rule
    does), which leaves every tensor whole on the rank."""
    cfg = smoke_config(get_config("yi-6b"))
    run = RunConfig(loss_chunk=16)
    sch = TS.state_schema(cfg, run, make_optimizer("adamw"))
    leaves = _walk(TS.state_shardings(sch, R.make_rules(host_mesh), run))
    assert set(k[0] for k in leaves) == {"params", "opt", "step"}
    for path, s in leaves.items():
        if path[0] != "opt":
            assert s.placements == (Replicate(), Replicate()), path
        else:
            assert s.placements[1] == Replicate(), path
            assert set(s.spec) <= {"data", None}, path


def test_remat_recompute_keeps_the_rules_on_another_thread(host_mesh):
    """A checkpointed layer's recompute runs under the rules of its
    forward, also on another thread (the autograd engine's for CUDA
    tensors), where the thread-local rules and DTensor's implicit
    replication are unset: the smoke
    DeepSeek-V2 MoE layer takes the expert-parallel path in the forward
    and again in the recompute, and the gradient equals the one taken
    on the forward's thread.  Without the rules the recompute would take
    the grouped path, and ``torch.utils.checkpoint`` refuses the
    different graph."""
    import threading

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import BlockDef
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params, tree_map

    cfg = smoke_config(get_config("deepseek-v2-236b"))
    bdef = BlockDef((("mla", "moe"),), 1)
    rules = R.make_rules(host_mesh)
    gen = torch.Generator().manual_seed(0)
    p = init_params(TF.block_schema(cfg, bdef), gen, "cpu")
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    rope = M.rope_full(cfg, 16, "cpu")

    def grads(on_thread: bool):
        wrt = tree_map(lambda t: R.place(t, (Replicate(),) * 2, host_mesh)
                       .detach().requires_grad_(), p)
        calls = dict(TMOE.MOE_CALLS)
        with R.axis_rules(rules), implicit_replication():
            dx = R.place(x, (Replicate(),) * 2, host_mesh)
            y, res, aux = TF.apply_block_full(
                cfg, bdef, wrt, dx, torch.zeros_like(dx), rope_cs=rope,
                remat="full")
            loss = (y * y).sum() + (res * res).sum() + aux
            out = []

            def run():
                out.append(torch.autograd.grad(
                    loss, [wrt["l0"]["mlp"]["w_up"]])[0])

            if on_thread:
                t = threading.Thread(target=run)
                t.start()
                t.join()
            else:
                run()
        assert out, "the backward raised"
        return out[0].full_tensor(), {k: TMOE.MOE_CALLS[k] - calls[k]
                                      for k in calls}

    g_main, c_main = grads(False)
    g_thread, c_thread = grads(True)
    assert c_main == c_thread == {"grouped": 0, "ep": 2}
    assert torch.equal(g_main, g_thread)
