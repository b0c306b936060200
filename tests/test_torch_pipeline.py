"""The GPipe pipeline step (``runtime/pipeline.py``) against the JAX
package's ``build_pipeline_train_step``.

* gloo worlds ("pod", "data", "model") = (4, 1, 1) with the smoke
  Granite-8B widened to 4 layers, and (2, 2, 1), (2, 1, 2) with its
  2-layer cut (one spawned subprocess a rank, meeting at a
  ``FileStore`` under ``tmp_path``, each with its own timeout), 3 steps
  of the JAX pipeline's batches (B = 8, S = 32), ``pp_microbatches`` =
  4, AdamW at a constant 1e-3, f32: each step's loss within
  ``LOSS_RTOL`` of JAX's pipeline step on an ``AxisType.Auto`` mesh
  ((4, 1, 1), and (2, 2, 2) for the 2-layer worlds; a JAX subprocess on
  forced CPU devices, ``tests/test_distributed.py``'s
  ``_PIPELINE`` with the mesh's axes made Auto, since ``repro``'s
  ``shard`` refuses Explicit ones) whose optimizer is handed the
  step's gradient divided by the stage count; the parameters and both moments
  after 3 steps within 5 % relative L2 of JAX's
  (``tests/test_torch_train.py``'s ``_assert_rel_l2``: Adam's sign
  normalisation parts elements whose gradient is at the rounding floor);
  the metrics the same on every rank; the new state at its placements.
* the reference's gradient is the stage count times the loss's (a
  ``psum``'s transpose under ``check_vma=False`` scales every cotangent
  by it; ROADMAP caveat 12): its first step's, kept raw, divided by the
  count, within 1e-4·max|g| of ``loss_and_grads`` on the whole batch.
  Adam's normalisation hides the factor, except in the moments and
  where ``sqrt(v̂)`` nears eps; the port computes the loss's gradient.
* the one-process form (``rules=None``, 4 stages, in this process)
  bitwise equal to the (4, 1, 1) world, losses and every state leaf;
  its first gradients within 1e-5·max|g| of ``loss_and_grads`` on the
  whole batch, a tied-embedding variant's too (the embedding's the sum
  of the first and the last stage's).
* the hops' byte counter: 2 tensors × (stages − 1) × n_micro × mb × S ×
  d × 4 bytes a step in each direction (summed over a world's ranks,
  each sending its local shards).
* ``pipeline_compatible`` equal to JAX's for every registered config and
  its smoke config; the state placements equal to JAX's
  ``_block_param_specs`` composed with its inner rules' parameter specs
  on ``AbstractMesh``es up to (2, 16, 16); the refusals.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import BlockDef as JBlockDef  # noqa: E402
from repro.configs.shapes import ShapeConfig as JShapeConfig  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as JPipeline  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import RunConfig, get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import BlockDef  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.runtime import pipeline as PP  # noqa: E402
from repro_torch.runtime import train_step as TS  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH = "granite-8b"
SEQ, BATCH = 32, 8
N_MICRO = 4
STEPS = 3
LR = 1e-3
LOSS_CHUNK = 32
#: ``tests/test_torch_train.py``'s bounds
LOSS_RTOL = 1e-5
TRAJ_SHARE = 0.05
GRAD_SHARE = 1e-5
#: the port's gradients against JAX's (``tests/test_torch_train.py``)
JAX_GRAD_SHARE = 1e-4
RANK_TIMEOUT = 300
#: the gloo worlds: mesh, layers, the JAX job they are held to
WORLDS = {"4x1x1": ((4, 1, 1), 4, "4x1x1"),
          "2x2x1": ((2, 2, 1), 2, "2x2x2"),
          "2x1x2": ((2, 1, 2), 2, "2x2x2")}
#: the JAX jobs: mesh, layers
JAX_JOBS = {"4x1x1": ((4, 1, 1), 4), "2x2x2": ((2, 2, 2), 2)}
#: the cuts whose attention weights are rescaled (ROADMAP caveat 6: under
#: the init rule f32 roundings grow ~20× a layer, and at 4 layers they
#: part the two packages' 3-step trajectories)
WELL_CONDITIONED = (4,)
#: ("pod", "data", "model") sizes the placements are held at
SPEC_MESHES = ((2, 1, 1), (2, 2, 2), (4, 2, 2), (2, 16, 16))


def _cut(cfg, block_def, layers):
    return dataclasses.replace(
        cfg, num_layers=layers,
        blocks=(block_def(cfg.blocks[0].pattern, layers),)).validate()


def _cfg(layers, **kw):
    return dataclasses.replace(
        _cut(smoke_config(get_config(ARCH)), BlockDef, layers), **kw)


def _run(stages=1):
    return RunConfig(loss_chunk=LOSS_CHUNK, pipeline_stages=stages,
                     pp_microbatches=N_MICRO)


def _opt():
    return make_optimizer("adamw", constant(LR))


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _well_conditioned(flat: dict, cfg) -> dict:
    """The attention projections rescaled to the fan-in of their
    contraction (``chip_smoke.py::well_conditioned``: d for wq, wk, wv,
    heads·head_dim for wo; the init rule takes axis -2)."""
    H, KH, d = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    gains = {"wq": (H / d) ** 0.5, "wk": (KH / d) ** 0.5,
             "wv": (KH / d) ** 0.5, "wo": H ** -0.5}
    out = dict(flat)
    for k, v in flat.items():
        *path, name = k.split("/")
        if path[-1:] == ["mixer"] and name in gains:
            out[k] = (v * np.float32(gains[name])).astype(v.dtype)
    return out


def _unflatten(flat):
    out = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split("/")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


_JAX = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={sys.argv[4]}"
sys.path.insert(0, sys.argv[1])
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.compat import configure_partial_auto
configure_partial_auto()
from repro.configs import RunConfig, get_config, smoke_config
from repro.configs.base import BlockDef
from repro.optim import Optimizer, constant, make_optimizer
from repro.runtime.pipeline import build_pipeline_train_step
from repro.sharding.rules import make_rules

work, spec, job = sys.argv[2], json.loads(sys.argv[3]), sys.argv[5]
shape, layers = spec["jax"][job]
base = smoke_config(get_config(spec["arch"]))
cfg = dataclasses.replace(
    base, num_layers=layers,
    blocks=(BlockDef(pattern=base.blocks[0].pattern, repeat=layers),),
).validate()
run = RunConfig(loss_chunk=spec["chunk"], pipeline_stages=shape[0],
                pp_microbatches=spec["n_micro"])
mesh = jax.make_mesh(tuple(shape), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
rules = make_rules(mesh, "train")
opt = make_optimizer("adamw", constant(spec["lr"]))


def unflatten(flat):
    out = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split("/")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = jnp.asarray(v)
    return out


def flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# the step's gradient is the stage count times the loss's (a psum's
# transpose under check_vma=False): AdamW gets it divided by that count
# (a power of 2, exact), and the raw gradient is kept in the state
stages = shape[0]


def init(params):
    return {"adamw": opt.init(params),
            "raw": jax.tree.map(jnp.zeros_like, params)}


def update(grads, state, params, step):
    new_params, new = opt.update(
        jax.tree.map(lambda g: g / stages, grads), state["adamw"], params,
        step)
    return new_params, {"adamw": new, "raw": grads}


def state_schema(psch):
    return {"adamw": opt.state_schema(psch), "raw": psch}


adapted = Optimizer(init=init, update=update, state_schema=state_schema)
data = np.load(f"{work}/cut-{layers}.npz")
params = unflatten({k[2:]: data[k] for k in data if k[:2] == "p/"})
state = {"params": params, "opt": adapted.init(params),
         "step": jnp.zeros((), jnp.int32)}
step, _ = build_pipeline_train_step(cfg, run, adapted, rules)
step = jax.jit(step)
metrics, raw = [], None
for i in range(spec["steps"]):
    batch = {k: jnp.asarray(data[f"batch{i}/{k}"])
             for k in ("tokens", "loss_mask")}
    state, m = step(state, batch)
    metrics.append({k: float(v) for k, v in m.items()})
    if raw is None:
        raw = flat(state["opt"]["raw"])
adamw = state["opt"]["adamw"]
np.savez(f"{work}/jax-{job}.npz",
         **{f"p/{k}": v for k, v in flat(state["params"]).items()},
         **{f"m/{k}": v for k, v in flat(adamw["m"]).items()},
         **{f"v/{k}": v for k, v in flat(adamw["v"]).items()},
         **{f"g/{k}": v for k, v in raw.items()})
with open(f"{work}/jax-{job}.json", "w") as f:
    json.dump(metrics, f)
print("JAX_OK")
"""

_RANK = r"""
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import RunConfig, get_config, smoke_config
from repro_torch.configs.base import BlockDef
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves
from repro_torch.optim import constant, make_optimizer
from repro_torch.runtime import pipeline as PP
from repro_torch.runtime import train_step as TS
from repro_torch.sharding.rules import distribute_params, make_rules

rank, world, store, work, wname = (int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4], sys.argv[5], sys.argv[6])
spec = json.loads(sys.argv[7])
shape, layers, _ = spec["worlds"][wname]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
base = smoke_config(get_config(spec["arch"]))
cfg = dataclasses.replace(
    base, num_layers=layers,
    blocks=(BlockDef(pattern=base.blocks[0].pattern, repeat=layers),),
).validate()


def unflatten(flat):
    out = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split("/")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


data = np.load(f"{work}/cut-{layers}.npz")
params = params_from_numpy(
    cfg, unflatten({k[2:]: data[k] for k in data if k[:2] == "p/"}), "cpu",
    train=True)
run = RunConfig(loss_chunk=spec["chunk"], pp_microbatches=spec["n_micro"])
opt = make_optimizer("adamw", constant(spec["lr"]))
rules = make_rules(make_mesh(tuple(shape), ("pod", "data", "model"), "cpu"),
                   "train")
step, sh = PP.build_pipeline_train_step(cfg, run, opt, rules)
state = distribute_params(TS.new_state(params, opt), sh)
sent0 = {d: dict(v) for d, v in PP.SENT.items()}
metrics = []
for i in range(spec["steps"]):
    batch = {k: torch.from_numpy(data[f"batch{i}/{k}"])
             for k in ("tokens", "loss_mask")}
    state, m = step(state, batch)
    metrics.append({k: float(v) for k, v in m.items()})
sent = {d: {k: v - sent0[d].get(k, 0) for k, v in PP.SENT[d].items()}
        for d in PP.SENT}
placed = all(tuple(t.placements) == s.placements
             for t, s in zip(tree_leaves(state), tree_leaves(sh)))
full = [t.full_tensor().numpy() for t in tree_leaves(state)]
with open(f"{work}/port-{wname}-rank{rank}.json", "w") as f:
    json.dump({"metrics": metrics, "sent": sent, "placed": placed}, f)
if rank == 0:
    np.savez(f"{work}/port-{wname}.npz",
             **{f"s{i}": a for i, a in enumerate(full)})
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def _spec() -> dict:
    return {"arch": ARCH, "chunk": LOSS_CHUNK, "n_micro": N_MICRO,
            "lr": LR, "steps": STEPS,
            "worlds": {k: [list(v[0]), v[1], v[2]]
                       for k, v in WORLDS.items()},
            "jax": {k: [list(v[0]), v[1]] for k, v in JAX_JOBS.items()}}


def _wait(procs, marker):
    outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and marker in so, se[-3000:]


def _one_process(work, layers):
    """The one-process form (``rules=None``, ``layers`` stages) from the
    cut's parameters over the JAX batches: each step's metrics, the
    state after the steps and the first step's gradients."""
    cfg = _cfg(layers)
    data = np.load(work / f"cut-{layers}.npz")
    params = params_from_numpy(
        cfg, _unflatten({k[2:]: data[k] for k in data if k[:2] == "p/"}),
        "cpu", train=True)
    run, opt = _run(layers), _opt()
    step, sh = PP.build_pipeline_train_step(cfg, run, opt)
    assert sh is None
    batches = [{k: torch.from_numpy(data[f"batch{i}/{k}"])
                for k in ("tokens", "loss_mask")} for i in range(STEPS)]
    grads, _ = PP.pipeline_grads(cfg, run, params, batches[0])
    state = TS.new_state(params, opt)
    sent0 = {d: dict(v) for d, v in PP.SENT.items()}
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    sent = {d: {k: v - sent0[d].get(k, 0) for k, v in PP.SENT[d].items()}
            for d in PP.SENT}
    return {"metrics": metrics, "state": state, "grads": grads,
            "params": params, "batches": batches, "sent": sent}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every JAX job and every gloo world side by side, and the
    one-process form in this process meanwhile; returns (work dir,
    one-process results)."""
    work = tmp_path_factory.mktemp("pipeline")
    for layers in sorted({v[1] for v in JAX_JOBS.values()}):
        jc = _cut(jsmoke_config(jget_config(ARCH)), JBlockDef, layers)
        jp = _flat(jinit_params(JM.schema(jc), jax.random.key(0)))
        if layers in WELL_CONDITIONED:
            jp = _well_conditioned(jp, jc)
        pipe = JPipeline(jc, JShapeConfig("t", "train", SEQ, BATCH))
        batches = {f"batch{i}/{k}": np.asarray(v)
                   for i in range(STEPS) for k, v in pipe.batch_at(i).items()}
        np.savez(work / f"cut-{layers}.npz",
                 **{f"p/{k}": v for k, v in jp.items()}, **batches)
    spec = json.dumps(_spec())
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")

    def start(*argv):
        return subprocess.Popen([sys.executable, "-c", *argv],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)

    jax_procs = [start(_JAX, SRC, str(work), spec,
                       str(int(np.prod(shape))), job)
                 for job, (shape, _) in JAX_JOBS.items()]
    ranks = []
    for wname, (shape, _, _) in WORLDS.items():
        world = int(np.prod(shape))
        store = work / f"store-{wname}"
        ranks += [start(_RANK, SRC, str(r), str(world), str(store),
                        str(work), wname, spec) for r in range(world)]
    try:
        local = _one_process(work, 4)
        _wait(jax_procs, "JAX_OK")
        _wait(ranks, "RANK_OK")
    finally:
        for p in jax_procs + ranks:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return work, local


def _world(work, wname):
    world = int(np.prod(WORLDS[wname][0]))
    recs = []
    for r in range(world):
        with open(work / f"port-{wname}-rank{r}.json") as f:
            recs.append(json.load(f))
    return recs, np.load(work / f"port-{wname}.npz")


def _jax(work, job):
    with open(work / f"jax-{job}.json") as f:
        metrics = json.load(f)
    return metrics, np.load(work / f"jax-{job}.npz")


def _leaves(npz, prefix):
    keys = sorted(k for k in npz if k.startswith(prefix))
    return [npz[k] for k in keys]


def _port_state(npz, layers):
    """A world's saved state leaves as {"params", "m", "v"} lists in
    ``tree_leaves`` order."""
    cfg = _cfg(layers)
    sch = TS.state_schema(cfg, _run(), _opt())
    n_p = len(tree_leaves(sch["params"]))
    n_o = len(tree_leaves(sch["opt"]))
    leaves = [npz[f"s{i}"] for i in range(n_o + n_p + 1)]
    # the state's sorted keys: opt {count, m, v}, params, step
    m = leaves[1:1 + n_p]
    v = leaves[1 + n_p:1 + 2 * n_p]
    return {"params": leaves[n_o:n_o + n_p], "m": m, "v": v}


def _assert_rel_l2(got, want, base=None, share=TRAJ_SHARE, what=""):
    """Leaf by leaf, ``|(got - base) - (want - base)| ≤ share·|want -
    base|`` in L2 (``base`` the leaves before the steps, or 0)."""
    base = base if base is not None else [0.0] * len(want)
    assert len(got) == len(want) == len(base)
    for i, (g, w, b) in enumerate(zip(got, want, base)):
        g, w, b = (np.asarray(a, np.float64) for a in (g, w, b))
        ref = float(np.linalg.norm((w - b).ravel()))
        err = float(np.linalg.norm((g - w).ravel()))
        assert err <= share * ref or err == 0.0, \
            f"{what} leaf {i}: relative L2 {err / max(ref, 1e-30)}"


@pytest.mark.parametrize("wname", sorted(WORLDS))
def test_world_losses_equal_jax(runs, wname):
    work, _ = runs
    recs, _ = _world(work, wname)
    want, _ = _jax(work, WORLDS[wname][2])
    got = recs[0]["metrics"]
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"loss", "nll_sum", "token_count"}
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["nll_sum"], w["nll_sum"],
                                   rtol=LOSS_RTOL)
        assert g["token_count"] == w["token_count"]
    # every stage reports the same metrics, and the state kept its
    # placements
    assert all(r["metrics"] == got for r in recs)
    assert all(r["placed"] for r in recs)


@pytest.mark.parametrize("what", ["params", "m", "v"])
@pytest.mark.parametrize("wname", sorted(WORLDS))
def test_world_state_equals_jax(runs, wname, what):
    work, _ = runs
    layers = WORLDS[wname][1]
    _, npz = _world(work, wname)
    _, jnpz = _jax(work, WORLDS[wname][2])
    got = _port_state(npz, layers)[what]
    want = _leaves(jnpz, {"params": "p/", "m": "m/", "v": "v/"}[what])
    base = None
    if what == "params":
        base = _leaves(np.load(work / f"cut-{layers}.npz"), "p/")
    _assert_rel_l2(got, want, base, what=f"{wname} {what}")


@pytest.mark.parametrize("job", sorted(JAX_JOBS))
def test_jax_gradient_is_the_stage_count_times_the_loss(runs, job):
    work, _ = runs
    shape, layers = JAX_JOBS[job]
    _, jnpz = _jax(work, job)
    raw = _leaves(jnpz, "g/")
    cfg = _cfg(layers)
    data = np.load(work / f"cut-{layers}.npz")
    params = params_from_numpy(
        cfg, _unflatten({k[2:]: data[k] for k in data if k[:2] == "p/"}),
        "cpu", train=True)
    batch = {k: torch.from_numpy(data[f"batch0/{k}"])
             for k in ("tokens", "loss_mask")}
    _, _, want = TS.loss_and_grads(cfg, _run(), params, batch)
    want = [w.numpy() for w in tree_leaves(want)]
    assert len(raw) == len(want)
    for i, (r, w) in enumerate(zip(raw, want)):
        scale = float(np.abs(w).max())
        assert float(np.abs(r / shape[0] - w).max()) <= \
            JAX_GRAD_SHARE * scale, i


def test_one_process_bitwise_equals_the_4_stage_world(runs):
    work, local = runs
    recs, npz = _world(work, "4x1x1")
    assert local["metrics"] == recs[0]["metrics"]
    got = [t.numpy() for t in tree_leaves(local["state"])]
    assert len(got) == len(npz.files)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, npz[f"s{i}"], err_msg=str(i))


def _assert_grads_close(got, want):
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= GRAD_SHARE * scale, i


def test_one_process_grads_equal_the_whole_batch(runs):
    """Pipeline parallelism's loss is the whole batch's: the first
    step's gradients against ``loss_and_grads`` on all 8 rows."""
    _, local = runs
    cfg = _cfg(4)
    loss, _, want = TS.loss_and_grads(cfg, _run(), local["params"],
                                      local["batches"][0])
    np.testing.assert_allclose(local["metrics"][0]["loss"], float(loss),
                               rtol=LOSS_RTOL)
    _assert_grads_close(local["grads"], want)


@pytest.mark.parametrize("stages", [2, 4])
def test_tied_embedding_grads_equal_the_whole_batch(stages):
    """A tied-embedding variant: the first and the last stage both
    hold the embedding's gradient, and their sum is the whole batch's."""
    cfg = _cfg(4, tie_embeddings=True)
    run = _run(stages)
    sch = TS.state_schema(cfg, run, _opt())
    assert "unembed" not in sch["params"]
    params = TS.init_state(sch, torch.Generator().manual_seed(0), "cpu")
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.configs.shapes import ShapeConfig

    batch = SyntheticLMPipeline(cfg, ShapeConfig("t", "train", SEQ,
                                                 BATCH)).batch_at(0)
    got, metrics = PP.pipeline_grads(cfg, run, params, batch)
    loss, _, want = TS.loss_and_grads(cfg, run, params, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=LOSS_RTOL)
    _assert_grads_close(got, want)


def _hop_bytes(layers):
    cfg = _cfg(layers)
    return 2 * (layers - 1) * N_MICRO * (BATCH // N_MICRO) * SEQ \
        * cfg.d_model * 4


def test_one_process_hop_bytes(runs):
    _, local = runs
    want = STEPS * _hop_bytes(4)
    assert local["sent"] == {"forward": {"float32": want},
                             "backward": {"float32": want}}


@pytest.mark.parametrize("wname", sorted(WORLDS))
def test_world_hop_bytes(runs, wname):
    """Summed over the ranks: each sends its local shards, so the
    ("data", "model") shards of a pod line add up to one whole stream
    (the (2, 1, 2) world's "model" ranks each hold half the sequence)."""
    work, _ = runs
    recs, _ = _world(work, wname)
    shape, layers, _ = WORLDS[wname]
    stages = shape[0]
    want = STEPS * 2 * (stages - 1) * N_MICRO * (BATCH // N_MICRO) * SEQ \
        * _cfg(layers).d_model * 4
    for d in ("forward", "backward"):
        assert sum(r["sent"][d].get("float32", 0) for r in recs) == want
        assert all(set(r["sent"][d]) <= {"float32"} for r in recs)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_pipeline_compatible_equals_jax(arch):
    from repro.runtime.pipeline import pipeline_compatible

    j, t = jget_config(arch), get_config(arch)
    assert PP.pipeline_compatible(t) == pipeline_compatible(j)
    assert PP.pipeline_compatible(smoke_config(t)) == \
        pipeline_compatible(jsmoke_config(j))


def _jax_state_specs(arch, sizes):
    """JAX's ``_block_param_specs`` of the state composed with the inner
    rules' parameter specs, on an ``AbstractMesh``."""
    from jax.sharding import AbstractMesh

    from repro.optim import make_optimizer as jmake_optimizer
    from repro.runtime.pipeline import _block_param_specs
    from repro.sharding.rules import make_rules, param_pspecs

    cfg = jget_config(arch)
    rules = make_rules(AbstractMesh(sizes, ("pod", "data", "model")),
                       "train")
    inner = dataclasses.replace(
        rules, rules={**rules.rules, "batch": (("data",),),
                      "seq_res": (("model",),)})
    psch = JM.schema(cfg)
    sch = {"params": psch, "opt": jmake_optimizer("adamw").state_schema(psch)}
    outer = jax.tree.leaves(_block_param_specs(sch),
                            is_leaf=lambda x: isinstance(x, tuple))
    specs = jax.tree.leaves(param_pspecs(sch, inner),
                            is_leaf=lambda x: isinstance(x, tuple))
    out = []
    for o, s in zip(outer, specs):
        s = tuple(s)
        if tuple(o) == ("pod",):
            assert not s or s[0] is None
            s = ("pod",) + s[1:]
        out.append(s)
    return out


COMPATIBLE = [a for a in ALL_ARCHS if PP.pipeline_compatible(get_config(a))]


@pytest.mark.parametrize("sizes", SPEC_MESHES)
@pytest.mark.parametrize("arch", COMPATIBLE)
def test_state_placements_equal_jax(arch, sizes):
    cfg = get_config(arch)
    run, opt = RunConfig(), make_optimizer("adamw")
    mesh = R.AbstractMesh(sizes, ("pod", "data", "model"))
    rules = R.make_rules(mesh, "train")
    sh = PP.pipeline_shardings(TS.state_schema(cfg, run, opt), rules)
    got = [tuple(s.spec) for s in tree_leaves({"params": sh["params"],
                                               "opt": sh["opt"]})]
    assert got == _jax_state_specs(arch, sizes)
    assert tuple(sh["step"].spec) == ()
    for s in tree_leaves(sh):
        assert s.placements == R.spec_placements(mesh, s.spec)
    # the builder hands back the same placements
    if cfg.blocks[0].repeat % sizes[0] == 0:
        _, bsh = PP.build_pipeline_train_step(cfg, run, opt, rules)
        assert bsh == sh


def test_refusals():
    cfg = _cfg(4)
    opt = _opt()
    abstract = R.AbstractMesh((1, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="pod"):
        PP.build_pipeline_train_step(cfg, _run(), opt,
                                     R.make_rules(abstract))
    no_pod = R.AbstractMesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="pod"):
        PP.build_pipeline_train_step(cfg, _run(), opt, R.make_rules(no_pod))
    with pytest.raises(ValueError, match="pipeline_stages"):
        PP.build_pipeline_train_step(cfg, _run(1), opt)
    with pytest.raises(ValueError, match="stages"):
        PP.build_pipeline_train_step(cfg, _run(3), opt)
    three = R.AbstractMesh((3, 1, 1), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="stages"):
        PP.build_pipeline_train_step(cfg, _run(), opt, R.make_rules(three))
    mamba = smoke_config(get_config("mamba2-370m"))
    with pytest.raises(ValueError, match="dense attention"):
        PP.build_pipeline_train_step(mamba, _run(2), opt)
    step, _ = PP.build_pipeline_train_step(cfg, _run(2), opt)
    params = TS.init_state(TS.state_schema(cfg, _run(2), opt),
                           torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.ones((6, SEQ), dtype=torch.int32)}
    with pytest.raises(ValueError, match="pp_microbatches"):
        step(TS.new_state(params, opt), batch)


# ---------------------------------------------------------------------------
# on the card: the one-process form against the train step
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("stages", [2, 4])
def test_card_one_process_equals_train_step(stages):
    """The one-process form on the card (the kernels through their
    Functions) against ``build_train_step`` in microbatches of the
    pipeline's, 2 steps from one state: losses within 1e-5 relative,
    every parameter leaf's update within 5 % relative L2.  Smoke
    Granite-8B at 4 layers with its head dim widened to 32, which the
    card's flash kernel takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLMPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = _cfg(4, head_dim=32)
    run = dataclasses.replace(_run(stages), microbatch=BATCH // N_MICRO)
    opt = _opt()
    sch = TS.state_schema(cfg, run, opt)
    params = TS.init_state(sch, torch.Generator(device=dev).manual_seed(0),
                           dev)
    pipe = SyntheticLMPipeline(cfg, ShapeConfig("t", "train", SEQ, BATCH),
                               device=dev)
    step, _ = PP.build_pipeline_train_step(cfg, run, opt)
    plain = TS.build_train_step(cfg, run, opt)
    got, want = TS.new_state(params, opt), TS.new_state(params, opt)
    for i in range(2):
        # no loss mask: every microbatch counts the same tokens, so the
        # train step's mean of its microbatches' means is the pipeline's
        # mean over the batch
        b = {"tokens": pipe.batch_at(i)["tokens"]}
        got, gm = step(got, b)
        want, wm = plain(want, b)
        assert abs(float(gm["loss"]) - float(wm["loss"])) <= \
            LOSS_RTOL * abs(float(wm["loss"]))
    _assert_rel_l2([t.cpu().numpy() for t in tree_leaves(got["params"])],
                   [t.cpu().numpy() for t in tree_leaves(want["params"])],
                   [t.cpu().numpy() for t in tree_leaves(params)],
                   what="card update")
