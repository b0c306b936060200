"""The port's training path against the JAX package's, on the CPU.

Yi-6B and mamba2-370m, each the smoke config widened to 2 layers, f32.
The same JAX parameters go through ``params_from_numpy(train=True)``
(every leaf in f32, as the JAX schema keeps them); the same batches
come from both packages' pipelines (equal bit for bit).  On the CPU the
port runs the plain versions of its kernels under plain autograd, so
this holds the port's loss (the chunked cross-entropy, the fused norm
seams, the casts at each use), its gradients, its microbatch
accumulation and its train step to the JAX package's:

* loss within 1e-5 relative (measured ≤ 1e-7); ``token_count`` equal;
* each gradient leaf within 1e-4·max|g| of that leaf (measured ≤ 3.7e-5
  for Yi-6B, whose random attention is near one-hot and amplifies
  rounding; ≤ 8.4e-6 for mamba2), with and without microbatches;
* six AdamW steps: each step's loss within 1e-5 relative (measured
  1.8e-6), and each leaf's update (parameter − initial value) and its
  moments within 5 % of JAX's in relative L2 (measured ≤ 2.2 %, Yi's
  embedding; mamba2 ≤ 1e-5).  Adam moves an element by about lr in
  the direction of the sign of its gradient, so elements whose gradient
  lies at the rounding floor (here Yi's rare tokens and its one-hot
  attention) part by up to lr = 1e-3 a step, in both packages alike; an
  elementwise tolerance would have to be that large;
* remat none / dots / full, and resume from a checkpoint: bitwise.

The autograd Functions that carry the kernels on the card are checked
here with their plain forward in the kernel's place
(``torch.autograd.gradcheck`` in f64); their ``gpu`` twins run the
kernels.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import BlockDef as JBlockDef  # noqa: E402
from repro.configs.shapes import SMOKE_SHAPES as JSMOKE_SHAPES  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as JPipeline  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.runtime import train_step as JTS  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    RunConfig,
    get_config,
    smoke_config,
)
from repro_torch.configs.base import BlockDef  # noqa: E402
from repro_torch.configs.shapes import (  # noqa: E402
    SHAPES,
    SMOKE_SHAPES,
    ShapeConfig,
    cell_is_runnable,
)
from repro_torch.data.pipeline import (  # noqa: E402
    PipelineState,
    SyntheticLMPipeline,
)
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fo  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rk  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as ro  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_residual_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd import ops as so  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunk_ref  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params,
    map_specs,
    tree_leaves,
    tree_map,
)
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.runtime import train_step as TS  # noqa: E402

ARCHS = ("yi-6b", "mamba2-370m")
LAYERS = 2
SHAPE = JSMOKE_SHAPES["train_4k"]          # seq 64, batch 4
LOSS_CHUNK = 16                            # 4 chunks of the sequence
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4
#: six steps: relative L2 of each leaf's update and moments
TRAJ_SHARE = 0.05


def _widen(cfg, blocks):
    return dataclasses.replace(cfg, num_layers=LAYERS, blocks=blocks)


def _cfgs(arch):
    j, t = jsmoke_config(jget_config(arch)), smoke_config(get_config(arch))
    jb = tuple(JBlockDef(b.pattern, LAYERS) for b in j.blocks)
    tb = tuple(BlockDef(b.pattern, LAYERS) for b in t.blocks)
    return _widen(j, jb), _widen(t, tb)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jc, tc = _cfgs(request.param)
    jp = jinit_params(JM.schema(jc), jax.random.key(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu",
                           train=True)
    jpipe = JPipeline(jc, SHAPE)
    tpipe = SyntheticLMPipeline(tc, SHAPE)
    return request.param, jc, jp, tc, tp, jpipe, tpipe


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_rel_l2(got, want, base=None, share=TRAJ_SHARE, what=""):
    """Leaf by leaf, ``|(got - base) - (want - base)| ≤ share·|want -
    base|`` in L2 (``base`` the leaves before the steps, or 0)."""
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    bl = jax.tree.leaves(base) if base is not None else [0.0] * len(wl)
    assert len(gl) == len(wl) == len(bl)
    for i, (g, w, b) in enumerate(zip(gl, wl, bl)):
        g, w, b = (np.asarray(_np(a), np.float64) for a in (g, w, b))
        ref = float(np.linalg.norm((w - b).ravel()))
        err = float(np.linalg.norm((g - w).ravel()))
        assert err <= share * ref or err == 0.0, \
            f"{what} leaf {i}: relative L2 {err / max(ref, 1e-30)}"


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _assert_tree_close(got, want, share=None, atol=None, what=""):
    """Leaf by leaf (sorted keys in both), within share·max|want| or
    atol; returns the worst |diff| / max|want|."""
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert len(gl) == len(wl)
    worst = 0.0
    for path, g, w in zip(paths, gl, wl):
        g, w = _np(g).astype(np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, path)
        scale = float(np.abs(w).max())
        diff = float(np.abs(g - w).max())
        tol = share * scale if share is not None else atol
        assert diff <= tol, f"{what} {path}: |diff| {diff} > {tol}"
        worst = max(worst, diff / max(scale, 1e-30))
    return worst


# ---------------------------------------------------------------------------
# configs, shapes, pipeline
# ---------------------------------------------------------------------------


def test_run_config_and_shapes_match_jax():
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(JRunConfig())
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.configs.shapes import cell_is_runnable as jrunnable

    for table, jtable in ((SHAPES, JSHAPES), (SMOKE_SHAPES, JSMOKE_SHAPES)):
        assert {k: dataclasses.asdict(v) for k, v in table.items()} == \
            {k: dataclasses.asdict(v) for k, v in jtable.items()}
    for name in ARCHS:
        for shape in SHAPES:
            got = cell_is_runnable(get_config(name), SHAPES[shape])[0]
            want = jrunnable(jget_config(name), JSHAPES[shape])[0]
            assert got == want


def test_pipeline_batches_are_bitwise_jax(arch):
    _, jc, _, tc, _, jpipe, tpipe = arch
    for step in (0, 1, 7):
        jb, tb = jpipe.batch_at(step), tpipe.batch_at(step)
        assert set(tb) == {"tokens", "loss_mask"}
        for k in tb:
            assert tb[k].dtype == {"tokens": torch.int32,
                                   "loss_mask": torch.float32}[k]
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    state = PipelineState(seed=3, step=5)
    assert PipelineState.from_extra(state.to_extra()) == state
    it = SyntheticLMPipeline(tc, SHAPE)
    next(it)
    assert it.state.step == 1
    it.restore({"data_seed": 0, "data_step": 7})
    assert torch.equal(next(it)["tokens"], tpipe.batch_at(7)["tokens"])


def test_unported_configs_raise_in_training():
    """What the port refuses to train: a MoE or MLA layer without its
    config.  A logit soft-cap and an attention layer without an MLP,
    once refused, train: their loss is the JAX package's on the same
    parameters and batch.  whisper's and qwen2-vl's batches (frame
    embeddings, patch embeddings, M-RoPE positions) are drawn and
    trained."""
    t = smoke_config(get_config("yi-6b"))
    j = jsmoke_config(jget_config("yi-6b"))
    batch = SyntheticLMPipeline(t, SHAPE).batch_at(0)
    no_mlp = (("attn", "none"), ("attn", "dense"))
    for jc, tc in (
            (dataclasses.replace(j, attn_logit_softcap=30.0),
             dataclasses.replace(t, attn_logit_softcap=30.0)),
            (dataclasses.replace(j, num_layers=2, blocks=(
                JBlockDef(no_mlp, 1),)),
             dataclasses.replace(t, num_layers=2, blocks=(
                 BlockDef(no_mlp, 1),)))):
        jp = jinit_params(JM.schema(jc), jax.random.key(0))
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu",
                               train=True)
        jl, _ = JM.loss_fn(jc, jp, _jbatch(batch), loss_chunk=LOSS_CHUNK)
        tl, _ = M.loss_fn(tc, tp, batch, loss_chunk=LOSS_CHUNK)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    for pattern, err in (((("attn", "moe"),), ValueError),
                         ((("mla", "dense"),), ValueError)):
        bad = dataclasses.replace(t, blocks=(BlockDef(pattern=pattern,
                                                      repeat=1),))
        with pytest.raises(err):
            M.train_schema(bad)
    for arch, keys in (("whisper-large-v3", {"enc_embeds"}),
                       ("qwen2-vl-72b", {"embeds", "positions"})):
        cfg = smoke_config(get_config(arch))
        b = SyntheticLMPipeline(cfg, SHAPE).batch_at(0)
        assert set(b) == {"tokens", "loss_mask"} | keys
        loss, _ = M.loss_fn(cfg, init_params(
            M.train_schema(cfg), torch.Generator().manual_seed(0), "cpu"), b)
        assert bool(torch.isfinite(loss))


def test_train_schema_is_jax_schema(arch):
    """Every leaf in the parameter dtype with JAX's shapes; serving's
    schema unchanged (compute-dtype matrices)."""
    name, jc, _, tc, tp, _, _ = arch
    jsch = jax.tree.map(lambda s: (s.shape, str(s.dtype)), JM.schema(jc),
                        is_leaf=lambda x: hasattr(x, "init"))
    tsch = map_specs(lambda _, s: (s.shape, str(s.dtype).split(".")[-1]),
                     M.train_schema(tc))
    assert tsch == jsch
    bf = dataclasses.replace(tc, compute_dtype="bfloat16")
    assert {s.dtype for s in tree_leaves(M.train_schema(bf))} == \
        {torch.float32}
    assert torch.bfloat16 in {s.dtype for s in tree_leaves(M.schema(bf))}
    assert all(t.dtype == torch.float32 for t in tree_leaves(tp))
    # jamba's parameters are bf16 and its MoE router f32, in both packages
    jj, tj = jget_config("jamba-v0.1-52b"), get_config("jamba-v0.1-52b")
    jsch = jax.tree.map(lambda s: (s.shape, jnp.dtype(s.dtype).name),
                        JM.schema(jj), is_leaf=lambda x: hasattr(x, "init"))
    assert map_specs(lambda _, s: (s.shape, str(s.dtype).split(".")[-1]),
                     M.train_schema(tj)) == jsch
    assert jsch["b0"]["l1"]["mlp"]["router"][1] == "float32"
    assert jsch["b0"]["l1"]["mlp"]["w_up"][1] == "bfloat16"


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


def _jvg(jc, run):
    return jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jc, p, b, loss_chunk=run.loss_chunk,
                                remat=run.remat), has_aux=True))


def test_loss_metrics_and_grads_match_jax(arch):
    _, jc, jp, tc, tp, jpipe, tpipe = arch
    run = RunConfig(loss_chunk=LOSS_CHUNK)
    (jl, jm), jg = _jvg(jc, run)(jp, _jbatch(jpipe.batch_at(0)))
    tl, tm, tg = TS.loss_and_grads(tc, run, tp, tpipe.batch_at(0))
    assert set(tm) == set(jm) == {"loss", "nll_sum", "token_count",
                                  "aux_loss"}
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["nll_sum"].item(), float(jm["nll_sum"]),
                               rtol=LOSS_RTOL)
    assert tm["token_count"].item() == float(jm["token_count"])
    assert tm["aux_loss"].item() == float(jm["aux_loss"]) == 0.0
    assert tm["loss"].item() == tl.item()
    _assert_tree_close(tg, jg, share=GRAD_SHARE, what="grad")


def test_loss_without_mask_and_single_chunk(arch):
    _, jc, jp, tc, tp, jpipe, _ = arch
    toks = np.array(jpipe.batch_at(2)["tokens"])
    for chunk in (LOSS_CHUNK, 512):
        jl, _ = JM.loss_fn(jc, jp, {"tokens": jnp.asarray(toks)},
                           loss_chunk=chunk)
        tl, tm = M.loss_fn(tc, tp, {"tokens": torch.from_numpy(toks)},
                           loss_chunk=chunk)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
        assert tm["token_count"].item() == SHAPE.global_batch * (
            SHAPE.seq_len - 1)


def test_microbatch_accumulation_matches_jax(arch):
    _, jc, jp, tc, tp, jpipe, tpipe = arch
    run = RunConfig(microbatch=2, loss_chunk=LOSS_CHUNK)
    jrun = JRunConfig(microbatch=2, loss_chunk=LOSS_CHUNK)
    jg, jm = jax.jit(lambda p, b: JTS.compute_grads(jc, jrun, p, b))(
        jp, _jbatch(jpipe.batch_at(1)))
    tg, tm = TS.compute_grads(tc, run, tp, tpipe.batch_at(1))
    assert set(tm) == set(jm)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    assert tm["token_count"].item() == float(jm["token_count"])
    _assert_tree_close(tg, jg, share=GRAD_SHARE, what="grad")
    # the accumulation is the mean of the microbatches' own gradients
    b = tpipe.batch_at(1)
    halves = [TS.loss_and_grads(tc, run, tp, {k: v[i:i + 2]
                                              for k, v in b.items()})[2]
              for i in (0, 2)]
    for g, h0, h1 in zip(tree_leaves(tg), *map(tree_leaves, halves)):
        assert torch.equal(g, (torch.zeros_like(h0) + h0 + h1) / 2)


def test_remat_modes_are_bitwise(arch):
    _, _, _, tc, tp, _, tpipe = arch
    batch = tpipe.batch_at(3)
    out = {mode: TS.loss_and_grads(
        tc, RunConfig(loss_chunk=LOSS_CHUNK, remat=mode), tp, batch)
        for mode in ("none", "dots", "full")}
    ref_loss, _, ref_g = out["none"]
    for mode in ("dots", "full"):
        loss, _, g = out[mode]
        assert torch.equal(loss, ref_loss), mode
        for a, b in zip(tree_leaves(g), tree_leaves(ref_g)):
            assert torch.equal(a, b), mode
    with pytest.raises(ValueError, match="remat"):
        TS.loss_and_grads(tc, RunConfig(remat="most"), tp, batch)


# ---------------------------------------------------------------------------
# the train step, resume, a JAX checkpoint continued in the port
# ---------------------------------------------------------------------------


STEPS = 6
LR = 1e-3


def _jax_run(jc, jp, jpipe, steps, state=None, start=0):
    jopt = jmake_optimizer("adamw", jconstant(LR))
    step = jax.jit(JTS.build_train_step(
        jc, JRunConfig(loss_chunk=LOSS_CHUNK), jopt))
    if state is None:
        state = {"params": jp, "opt": jopt.init(jp),
                 "step": jnp.zeros((), jnp.int32)}
    losses = []
    for i in range(start, steps):
        state, m = step(state, _jbatch(jpipe.batch_at(i)))
        losses.append(float(m["loss"]))
    return state, losses


def _port_run(tc, tpipe, steps, state, start=0, opt=None):
    opt = opt or make_optimizer("adamw", constant(LR))
    step = TS.build_train_step(tc, RunConfig(loss_chunk=LOSS_CHUNK), opt)
    losses = []
    for i in range(start, steps):
        state, m = step(state, tpipe.batch_at(i))
        losses.append(m["loss"].item())
    return state, losses


@pytest.fixture(scope="module")
def trajectories(arch):
    name, jc, jp, tc, tp, jpipe, tpipe = arch
    jstate, jlosses = _jax_run(jc, jp, jpipe, STEPS)
    opt = make_optimizer("adamw", constant(LR))
    tstate, tlosses = _port_run(tc, tpipe, STEPS, TS.new_state(tp, opt))
    return jstate, jlosses, tstate, tlosses


def test_six_train_steps_match_jax(arch, trajectories):
    jp = arch[2]
    jstate, jlosses, tstate, tlosses = trajectories
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert tlosses[-1] < tlosses[0]
    assert int(tstate["step"]) == int(jstate["step"]) == STEPS
    assert int(tstate["opt"]["count"]) == int(jstate["opt"]["count"])
    _assert_rel_l2(tstate["params"], jstate["params"], jp, what="update")
    _assert_rel_l2(tstate["opt"]["m"], jstate["opt"]["m"], what="m")
    _assert_rel_l2(tstate["opt"]["v"], jstate["opt"]["v"], what="v")


def test_resume_is_bitwise(arch, trajectories, tmp_path):
    """6 steps straight == 3, checkpoint, restore, 3 more (the JAX
    package's ``test_train_resume_bit_exact``)."""
    _, _, _, tc, tp, _, tpipe = arch
    _, _, full, _ = trajectories
    opt = make_optimizer("adamw", constant(LR))
    part, _ = _port_run(tc, tpipe, 3, TS.new_state(tp, opt), opt=opt)
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(3, part, extra={"data_step": 3})
    sch = TS.state_schema(tc, RunConfig(), opt)
    restored, extra = mgr.restore(sch)
    restored, _ = _port_run(tc, tpipe, STEPS, restored,
                            start=int(extra["data_step"]), opt=opt)
    for a, b in zip(tree_leaves(full), tree_leaves(restored)):
        assert torch.equal(a, b)


def test_jax_checkpoint_continues_in_the_port(arch, trajectories, tmp_path):
    """3 JAX steps saved by the JAX package's manager, restored by the
    port's and run 3 more: the JAX package's 6 steps."""
    _, jc, jp, tc, _, jpipe, tpipe = arch
    jstate, jlosses, _, _ = trajectories
    part, _ = _jax_run(jc, jp, jpipe, 3)
    jmanager.CheckpointManager(tmp_path, async_save=False).save(
        3, part, extra={"data_step": 3})
    opt = make_optimizer("adamw", constant(LR))
    restored, extra = CheckpointManager(tmp_path).restore(
        TS.state_schema(tc, RunConfig(), opt))
    assert int(restored["step"]) == 3 and restored["step"].dtype == \
        torch.int32
    tstate, tlosses = _port_run(tc, tpipe, STEPS, restored,
                                start=int(extra["data_step"]), opt=opt)
    np.testing.assert_allclose(tlosses, jlosses[3:], rtol=LOSS_RTOL)
    _assert_rel_l2(tstate["params"], jstate["params"], jp, what="update")


# ---------------------------------------------------------------------------
# the autograd Functions around the kernels
# ---------------------------------------------------------------------------


def _f64(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()


def test_rmsnorm_function_backward_is_the_plain_gradient():
    rng = np.random.default_rng(0)
    x, r, s = _f64(rng, 6, 16), _f64(rng, 6, 16), _f64(rng, 16)
    assert torch.autograd.gradcheck(
        lambda *a: ro.RMSNormResidual.apply(*a, 1e-5, rmsnorm_residual_ref),
        (x, r, s))
    got = torch.autograd.grad(
        sum(o.square().sum() for o in ro.RMSNormResidual.apply(
            x, r, s, 1e-5, rmsnorm_residual_ref)), (x, r, s))
    want = torch.autograd.grad(
        sum(o.square().sum() for o in rmsnorm_residual_ref(x, r, s)),
        (x, r, s))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_rmsnorm_function_backward_where_only_the_scale_needs_grad():
    """qwen2-vl's first layer: x the input embeddings and res zeros, so
    the residual-sum output reaches no input that needs a gradient; the
    scale's gradient is still the plain one."""
    rng = np.random.default_rng(3)
    x, r = (_f64(rng, 6, 16).detach() for _ in range(2))
    s = _f64(rng, 16)
    h, _ = ro.RMSNormResidual.apply(x, r, s, 1e-5, rmsnorm_residual_ref)
    got, = torch.autograd.grad((h.square().sum(),), (s,))
    want, = torch.autograd.grad(
        rmsnorm_residual_ref(x, r, s)[0].square().sum(), (s,))
    assert torch.equal(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_function_backward_is_the_plain_gradient(causal):
    rng = np.random.default_rng(1)
    q, k, v = _f64(rng, 1, 4, 6, 8), _f64(rng, 1, 2, 6, 8), \
        _f64(rng, 1, 2, 6, 8)
    assert torch.autograd.gradcheck(
        lambda *a: fo.FlashAttention.apply(*a, causal,
                                           lambda q, k, v, c: attention_ref(
                                               q, k, v, causal=c)),
        (q, k, v))


def test_ssd_function_backward_is_the_plain_gradient():
    """On the model's views: B and C one group seen by every head
    (stride 0), xdt a permuted view; the gradients sum over the heads
    through the views' own backward."""
    rng = np.random.default_rng(2)
    BC, H, Q, N, P = 2, 3, 8, 4, 4
    xdt = _f64(rng, BC, Q, H, P)
    b, c = _f64(rng, BC, 1, Q, N), _f64(rng, BC, 1, Q, N)
    csum = torch.from_numpy(-np.cumsum(rng.uniform(size=(BC, H, Q)), -1)
                            ).requires_grad_()

    def f(xdt, b, c, csum):
        return so.SSDChunk.apply(xdt.transpose(1, 2), b.expand(BC, H, Q, N),
                                 c.expand(BC, H, Q, N), csum, ssd_chunk_ref)

    assert torch.autograd.gradcheck(f, (xdt, b, c, csum))


def test_ssd_plain_gradient_is_finite_where_the_decay_overflows():
    """Above the diagonal exp(csum_q - csum_t) exceeds f32's range; the
    mask taken before the exponential keeps the backward finite."""
    BC, H, Q, N, P = 1, 2, 64, 16, 16
    g = torch.Generator().manual_seed(0)
    xdt, b, c = (torch.randn(BC, H, Q, n, generator=g).requires_grad_()
                 for n in (P, N, N))
    csum = (-torch.cumsum(torch.full((BC, H, Q), 3.0), -1)).requires_grad_()
    y, state = ssd_chunk_ref(xdt, b, c, csum)
    grads = torch.autograd.grad(y.sum() + state.sum(), (xdt, b, c, csum))
    assert all(bool(torch.isfinite(t).all()) for t in grads)


@pytest.mark.parametrize("wrapper,args", [
    (rk.rmsnorm_residual_cuda, ((4, 8), (4, 8), (8,))),
    (fk.flash_attention_cuda, ((1, 2, 4, 32), (1, 2, 4, 32), (1, 2, 4, 32))),
    (sk.ssd_chunk_cuda, ((1, 2, 4, 16), (1, 2, 4, 16), (1, 2, 4, 16),
                         (1, 2, 4))),
])
def test_kernel_wrappers_refuse_inputs_that_require_grad(wrapper, args):
    ts = [torch.zeros(s) for s in args]
    ts[0].requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        wrapper(*ts)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        wrapper(*ts)          # past the check: the CPU is refused next


def test_train_launch_counts_follow_remat():
    """On the card a training forward launches what a prefill does; under
    remat the backward recomputes every layer (kernels included) but not
    the final norm, which runs outside the checkpointed units."""
    for name in ARCHS:
        cfg = get_config(name)
        pre = M.launches_per_pass(cfg, "prefill")
        assert M.launches_per_pass(cfg, "train") == pre
        for mode in ("dots", "full"):
            assert M.launches_per_pass(cfg, "train", mode) == {
                k: 2 * v - (k == "rmsnorm_residual") for k, v in pre.items()}
    assert M.launches_per_pass(get_config("yi-6b"), "train", "full") == {
        "flash_attention": 64, "rmsnorm_residual": 129}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_train_cli_on_the_cpu(capsys, tmp_path):
    argv = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--steps", "6",
            "--batch", "4", "--seq", "32", "--log-every", "3",
            "--deadline", "600", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3"]
    res = train_cli.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[2] for ln in lines[:-1]] == ["1/6", "3/6", "6/6"]
    assert all(ln.startswith("[train] step") and "loss=" in ln
               and "slack=" in ln for ln in lines[:-1])
    assert lines[-1].startswith("[train] done in")
    assert len(res.losses) == 6 and all(np.isfinite(res.losses))
    assert res.launches == {"flash_attention": 0, "rmsnorm_residual": 0,
                            "ssd_chunk": 0}
    assert CheckpointManager(tmp_path).all_steps() == [3, 6]
    # resume from step 6 for 2 more
    again = train_cli.main(argv[:5] + ["--steps", "8"] + argv[7:]
                           + ["--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 6" in out
    assert again.start_step == 6 and len(again.losses) == 2
    assert int(again.state["step"]) == 8


def test_train_cli_resume_is_bitwise(tmp_path):
    """The CLI's own resume: 4 steps straight against 2, a checkpoint, and
    2 more from it."""
    common = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
              "--batch", "4", "--seq", "32", "--microbatch", "2"]
    full = train_cli.main(common + ["--steps", "4"])
    train_cli.main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    rest = train_cli.main(common + ["--steps", "4", "--ckpt-dir",
                                    str(tmp_path), "--resume"])
    assert rest.losses == full.losses[2:]
    for a, b in zip(tree_leaves(full.state), tree_leaves(rest.state)):
        assert torch.equal(a, b)


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--arch", "yi-6b", "--smoke", "--steps", "1"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ARCHS)
def test_card_grads_match_cpu(cuda_device, name):
    """Kernels in the forward through their Functions, the plain
    backward, f32 (no TF32): the card's loss and gradients against the
    CPU's, and every kernel of the forward launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tc = _cfgs(name)
    if name == "yi-6b":
        # a head dim the kernel takes
        tc = dataclasses.replace(tc, head_dim=32)
    tp = init_params(M.train_schema(tc), torch.Generator().manual_seed(0),
                     "cpu")
    gp = tree_map(lambda t: t.to(cuda_device), tp)
    batch = SyntheticLMPipeline(tc, ShapeConfig("t", "train", 64, 2)
                                ).batch_at(0)
    run = RunConfig(loss_chunk=32, remat="full")
    want_l, _, want_g = TS.loss_and_grads(tc, run, tp, batch)
    counts = {k: fn.launches for k, fn in train_cli.KERNELS.items()}
    got_l, _, got_g = TS.loss_and_grads(
        tc, run, gp, {k: v.to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    launched = {k: fn.launches - counts[k]
                for k, fn in train_cli.KERNELS.items()}
    want = M.launches_per_pass(tc, "train", remat="full")
    assert {k: launched[k] for k in want} == want
    fwd = M.launches_per_pass(tc, "prefill")
    assert want == {k: 2 * v - (k == "rmsnorm_residual")
                    for k, v in fwd.items()}
    np.testing.assert_allclose(got_l.item(), want_l.item(), rtol=1e-4)
    for g, w in zip(tree_leaves(got_g), tree_leaves(want_g)):
        scale = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-3 * scale


@pytest.mark.gpu
def test_card_functions_match_plain_autograd(cuda_device):
    """Each Function on the card (the kernel forward) against autograd
    through the plain version, f32."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def leaf(*shape):
        return torch.randn(shape, generator=g,
                           device=cuda_device).requires_grad_()

    cases = [
        (ro.rmsnorm_residual, rmsnorm_residual_ref,
         (leaf(64, 256), leaf(64, 256), leaf(256)), {}),
        (fo.attention, attention_ref,
         (leaf(2, 4, 128, 64), leaf(2, 2, 128, 64), leaf(2, 2, 128, 64)),
         {"causal": True}),
    ]
    xdt, b, c = leaf(4, 2, 64, 32), leaf(4, 2, 64, 16), leaf(4, 2, 64, 16)
    csum = (-torch.cumsum(torch.rand(4, 2, 64, generator=g,
                                     device=cuda_device), -1)
            ).requires_grad_()
    cases.append((so.ssd_chunk, ssd_chunk_ref, (xdt, b, c, csum), {}))
    for fn, ref, args, kw in cases:
        outs = fn(*args, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        assert all(o.grad_fn is not None for o in outs)
        want_outs = ref(*args, **kw)
        want_outs = want_outs if isinstance(want_outs, tuple) \
            else (want_outs,)
        seeds = [torch.randn(o.shape, generator=g, device=cuda_device)
                 for o in outs]
        got = torch.autograd.grad(outs, args, seeds)
        want = torch.autograd.grad(want_outs, args, seeds)
        for a, b_ in zip(got, want):
            torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-4)
