"""The donated train step, the port's ``jax.jit(step,
donate_argnums=(0,))``, on the CPU.

``build_train_step(..., donate=True)`` (and the compressed and pipeline
steps' ``donate``) write the new state into the state they were given
through ``optimizer.update_`` (``optim/inplace.py``).  Four smoke
configs, each with its config's optimizer: yi-6b (f32, AdamW); a 2-layer
cut of the Jamba period, (mamba, moe) and (attn, dense), in bf16 with
AdamW's f32 master; DeepSeek-V2 (8-bit AdamW; its experts widened to
256, so that an expert row holds two int8 blocks); DeepSeek-V3
(Adafactor; its MoE block repeated twice, so that the expert leaves are
stacked over layers).  The parameters are drawn with numpy from a seed
(each leaf by its schema's init rule); the batches are the port's
pipeline's.

* the donated step equals the plain step bitwise over 3 steps, without
  rules and under the train rules on a one-rank gloo mesh, and returns
  the state it was given, every leaf at its ``data_ptr()``;
* ``update_`` equals ``update`` bitwise with ``CHUNK_BYTES`` patched so
  that a chunk is one row, three rows or the whole of the stacked expert
  leaf (Adafactor: its per-layer path), and empties the gradient tree;
* ``launch/train.py::build_session``'s step against the JAX package's
  own ``repro.launch.train.build_session`` step (jitted with
  ``donate_argnums=(0,)``; a JAX subprocess on a (1, 1) mesh of
  ``AxisType.Auto`` axes, since ``jax.make_mesh``'s default Explicit
  axes fail, ROADMAP caveat 1), 3 steps from the same numpy parameters:
  each loss within 1e-5 relative and each leaf's update (parameters and
  the f32 master) within 5 % relative L2, the bounds of
  ``tests/test_torch_train.py::test_six_train_steps_match_jax``;
* an async checkpoint followed at once by a donated step holds the
  saved step's values (the writer held back until the step is done);
* the compressed step on a (1, 1, 1) pod mesh and the GPipe step (2
  stages in one process) donated equal their plain forms bitwise;
* on 2 gloo ranks (one subprocess each, meeting at a ``FileStore``
  under ``tmp_path``) under ZeRO-1 (the optimizer state split over
  "data" = 2, the update leaf by leaf at those placements): the donated
  sharded step equals the plain one bitwise for the four configs, and
  so does the pipeline step under rules at 2 stages.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.checkpoint import manager as cmanager  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    RunConfig,
    get_config,
    smoke_config,
)
from repro_torch.configs.base import BlockDef  # noqa: E402
from repro_torch.configs.shapes import SMOKE_SHAPES  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adafactor, adamw, constant, inplace  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.runtime import pipeline as PP  # noqa: E402
from repro_torch.runtime import train_step as TS  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ("yi-6b", "jamba-v0.1-52b", "deepseek-v2-236b", "deepseek-v3-671b")
STEPS = 3
LOSS_CHUNK = 16
#: test_torch_train.py::test_six_train_steps_match_jax's bounds
LOSS_RTOL = 1e-5
TRAJ_SHARE = 0.05
#: the session's warmup-cosine schedule runs over this many steps
SESSION_STEPS = 10
RANK_TIMEOUT = 240
JAX_TIMEOUT = 300
#: the 2-rank world's cases (it runs beside one JAX process: the other
#: test files' workers share the cores)
WORLD = [*ARCHS, "yi-6b-pipeline"]


def _cut(cfg, block_def, arch):
    """The test's form of a smoke config (either package's: its
    ``BlockDef`` is ``block_def``)."""
    if arch == "jamba-v0.1-52b":
        pattern = tuple(cfg.blocks[0].pattern[i] for i in (3, 4))
        return dataclasses.replace(cfg, num_layers=2, param_dtype="bfloat16",
                                   blocks=(block_def(pattern, 1),))
    if arch == "deepseek-v2-236b":
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                d_ff=256))
    if arch == "deepseek-v3-671b":
        *head, last = cfg.blocks
        return dataclasses.replace(cfg, num_layers=cfg.num_layers + 1,
                                   blocks=(*head, block_def(last.pattern, 2)))
    if arch == "yi-6b-pipeline":
        return dataclasses.replace(
            cfg, num_layers=2,
            blocks=tuple(block_def(b.pattern, 2) for b in cfg.blocks))
    return cfg


def _base(arch):
    return arch.removesuffix("-pipeline")


def _cfg(arch):
    return _cut(smoke_config(get_config(_base(arch))), BlockDef, arch)


def _numpy_params(cfg, seed: int = 0) -> dict:
    """Every parameter of ``cfg``'s train schema drawn with numpy from
    ``seed`` by its spec's init rule, in f32 (flattened keys)."""
    rng = np.random.default_rng(seed)
    out = {}

    def draw(path, s):
        if s.init == P.ZEROS:
            a = np.zeros(s.shape)
        elif s.init == P.ONES:
            a = np.ones(s.shape)
        elif s.init == P.A_LOG:
            a = np.broadcast_to(np.log(np.arange(1, s.shape[-1] + 1)),
                                s.shape)
        elif s.init == P.DT_BIAS:
            lo, hi = np.log(s.dt_range)
            dt = np.exp(rng.random(s.shape) * (hi - lo) + lo)
            a = dt + np.log(-np.expm1(-dt))
        else:
            std = P.fan_in_std(s) if s.init == P.FAN_IN else s.std
            a = rng.standard_normal(s.shape) * std
        out["/".join(path)] = np.ascontiguousarray(a, np.float32)

    P.map_specs(draw, M.train_schema(cfg))
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


_JAX_JOB = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import RunConfig, get_config, smoke_config
from repro.configs.base import BlockDef
from repro.configs.shapes import SMOKE_SHAPES
from repro.data.pipeline import SyntheticLMPipeline
from repro.launch.train import build_session
from repro.models import model as JM
from repro.sharding.rules import abstract_params
$CUT
work, archs = sys.argv[1], json.loads(sys.argv[2])


def unflatten(flat):
    out = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split("/")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


for arch in archs:
    cfg = _cut(smoke_config(get_config(arch)), BlockDef, arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    opt, sch, sh, step, rules = build_session(
        cfg, RunConfig(loss_chunk=$CHUNK), mesh, $TOTAL)
    data = np.load(f"{work}/{arch}.npz")
    params = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype),
                          unflatten({k: data[k] for k in data}),
                          abstract_params(JM.schema(cfg)))
    # a buffer of its own for every leaf: the step donates each of them
    state = jax.tree.map(jnp.copy, {"params": params,
                                    "opt": opt.init(params),
                                    "step": jnp.zeros((), jnp.int32)})
    pipe = SyntheticLMPipeline(cfg, SMOKE_SHAPES["train_4k"])
    losses = []
    for i in range($STEPS):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    out = {f"p/{k}": v for k, v in flat(state["params"]).items()}
    if "master" in state["opt"]:
        out.update({f"m/{k}": v
                    for k, v in flat(state["opt"]["master"]).items()})
    np.savez(f"{work}/{arch}.jax.npz", **out)
    with open(f"{work}/{arch}.jax.json", "w") as f:
        json.dump(losses, f)
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
from repro_torch.configs.shapes import SMOKE_SHAPES
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves
from repro_torch.optim import constant, make_optimizer
from repro_torch.runtime import pipeline as PP
from repro_torch.runtime import train_step as TS
from repro_torch.sharding.rules import distribute_params, make_rules
$CUT
rank, world, store, work = (int(sys.argv[2]), int(sys.argv[3]),
                            sys.argv[4], sys.argv[5])
cases = json.loads(sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)


def unflatten(flat):
    out = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split("/")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def compare(arch, mesh_shape, axes, build, run):
    cfg = _cut(smoke_config(get_config(arch.removesuffix("-pipeline"))),
               BlockDef, arch)
    data = np.load(f"{work}/{arch}.npz")
    flat = {k: data[k] for k in data}
    opt = make_optimizer(cfg.optimizer, constant(1e-3))
    rules = make_rules(make_mesh(mesh_shape, axes, "cpu"), "train")
    plain, sh = build(cfg, run, opt, rules, False)
    donated, _ = build(cfg, run, opt, rules, True)
    pipe = SyntheticLMPipeline(cfg, SMOKE_SHAPES["train_4k"])
    batches = [TS.distribute_batch(pipe.batch_at(i), rules)
               for i in range($STEPS)]

    def state0():
        # new tensors each time: a replicated leaf may share its
        # storage with the tensor it was distributed from
        params = params_from_numpy(cfg, unflatten(flat), "cpu", train=True)
        return distribute_params(TS.new_state(params, opt), sh)

    a, b = state0(), state0()
    ptrs = [t.to_local().data_ptr() for t in tree_leaves(b)]
    losses = []
    for batch in batches:
        a, ma = plain(a, batch)
        out, mb = donated(b, batch)
        losses.append([float(ma["loss"]), float(mb["loss"]), out is b])
    # full_tensor() is a collective: every rank gathers every leaf
    equal = [bool(torch.equal(x.full_tensor(), y.full_tensor()))
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    kept = ptrs == [t.to_local().data_ptr() for t in tree_leaves(b)]
    placed = all(x.placements == y.placements
                 for x, y in zip(tree_leaves(a), tree_leaves(b)))
    split = sum(any(not p.is_replicate() for p in t.placements)
                for t in tree_leaves(b["opt"]))
    return {"equal": equal, "kept": kept, "placed": placed,
            "losses": losses, "split_opt_leaves": split}


def sharded(cfg, run, opt, rules, donate):
    sh = TS.state_shardings(TS.state_schema(cfg, run, opt), rules, run)
    return TS.build_train_step(cfg, run, opt, rules, donate=donate), sh


def pipelined(cfg, run, opt, rules, donate):
    return PP.build_pipeline_train_step(cfg, run, opt, rules, donate=donate)


out = {}
for case in cases:
    if case.endswith("-pipeline"):
        out[case] = compare(case, (2, 1, 1), ("pod", "data", "model"),
                            pipelined,
                            RunConfig(loss_chunk=$CHUNK, pp_microbatches=2))
    else:
        out[case] = compare(case, (2, 1), ("data", "model"), sharded,
                            RunConfig(loss_chunk=$CHUNK))
if rank == 0:
    with open(f"{work}/world.json", "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def _script(text):
    return (text.replace("$CUT", "import dataclasses\n"
                         + inspect.getsource(_cut))
            .replace("$CHUNK", str(LOSS_CHUNK))
            .replace("$STEPS", str(STEPS))
            .replace("$TOTAL", str(SESSION_STEPS)))


class _Jobs:
    """The numpy parameters' directory and the jobs started on them."""

    def __init__(self, work: Path, procs: dict):
        self.work, self.procs, self.done = work, procs, set()

    def wait(self, name: str, timeout: float) -> Path:
        """``work`` once job ``name`` has ended well."""
        if name not in self.done:
            try:
                outs = [p.communicate(timeout=timeout)
                        for p in self.procs[name]]
            finally:
                self.kill(name)
            for p, (so, se) in zip(self.procs[name], outs):
                assert p.returncode == 0 and "_OK" in so, se[-3000:]
            self.done.add(name)
        return self.work

    def kill(self, name: str):
        for p in self.procs[name]:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every case's parameters drawn with numpy, and on them the JAX
    session job and the 2-rank world, which run while the in-process
    tests run."""
    work = tmp_path_factory.mktemp("donate")
    for arch in (*ARCHS, "yi-6b-pipeline"):
        np.savez(work / f"{arch}.npz", **_numpy_params(_cfg(arch)))
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC)
    pipes = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                 env=env)
    procs = {"jax": [subprocess.Popen(
        [sys.executable, "-c", _script(_JAX_JOB), str(work),
         json.dumps(ARCHS)], **pipes)]}
    procs["world"] = [subprocess.Popen(
        [sys.executable, "-c", _script(_RANK), SRC, str(r), "2",
         str(work / "store"), str(work), json.dumps(WORLD)], **pipes)
        for r in range(2)]
    jobs = _Jobs(work, procs)
    # this process shares the cores with its jobs' processes
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield jobs
    torch.set_num_threads(threads)
    for name in procs:
        jobs.kill(name)


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group for the rules branch, closed after the
    module's tests."""
    own = not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    yield mesh
    if own and dist.is_initialized():
        dist.destroy_process_group()


def _params(work, arch):
    data = np.load(work / f"{arch}.npz")
    return params_from_numpy(_cfg(arch), _unflatten({k: data[k]
                                                     for k in data}),
                             "cpu", train=True)


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def _ptrs(state):
    return [_local(t).data_ptr() for t in tree_leaves(state)]


def _run_both(plain, donated, s_plain, s_don, batches):
    """The plain and the donated step over ``batches``, each from its own
    copy of one state; the donated step must return the state it got,
    every leaf where it was, and the plain step's bits."""
    ptrs = _ptrs(s_don)
    for batch in batches:
        s_plain, ma = plain(s_plain, batch)
        out, mb = donated(s_don, batch)
        assert out is s_don
        assert torch.equal(ma["loss"], mb["loss"])
    assert _ptrs(s_don) == ptrs
    for x, y in zip(tree_leaves(s_plain), tree_leaves(s_don)):
        assert torch.equal(_full(x), _full(y))
        if hasattr(x, "placements"):
            assert x.placements == y.placements


def _batches(cfg):
    pipe = SyntheticLMPipeline(cfg, SMOKE_SHAPES["train_4k"])
    return [pipe.batch_at(i) for i in range(STEPS)]


@pytest.mark.parametrize("branch", ("unsharded", "rules"))
@pytest.mark.parametrize("arch", ARCHS)
def test_donated_step_is_the_plain_step_bitwise(jobs, group, arch, branch):
    cfg = _cfg(arch)
    run = RunConfig(loss_chunk=LOSS_CHUNK)
    opt = make_optimizer(cfg.optimizer, constant(1e-3))

    def state0():
        return TS.new_state(_params(jobs.work, arch), opt)

    if branch == "unsharded":
        _run_both(TS.build_train_step(cfg, run, opt),
                  TS.build_train_step(cfg, run, opt, donate=True),
                  state0(), state0(), _batches(cfg))
        return
    rules = R.make_rules(group, "train")
    sh = TS.state_shardings(TS.state_schema(cfg, run, opt), rules, run)
    _run_both(TS.build_train_step(cfg, run, opt, rules),
              TS.build_train_step(cfg, run, opt, rules, donate=True),
              R.distribute_params(state0(), sh),
              R.distribute_params(state0(), sh),
              [TS.distribute_batch(b, rules) for b in _batches(cfg)])


#: per config, the stacked leaf whose rows the chunks cut: an expert
#: leaf (Yi has none: its MLP's)
CHUNKED_LEAF = {"yi-6b": ("b0", "l0", "mlp", "up"),
                "jamba-v0.1-52b": ("b0", "l0", "mlp", "w_gate"),
                "deepseek-v2-236b": ("b1", "l0", "mlp", "w_gate"),
                "deepseek-v3-671b": ("b1", "l0", "mlp", "w_gate")}
CUTS = [(a, c) for a in ARCHS[:3] for c in ("1 row", "3 rows", "whole")] \
    + [("deepseek-v3-671b", c) for c in ("layers", "whole")]


def _grads(params, rng):
    """A gradient for every leaf, its magnitudes spread over six decades
    (the int8 codes' range, the log code's span)."""
    return tree_map(lambda p: torch.from_numpy(
        (rng.standard_normal(p.shape) * np.exp(rng.uniform(-14, 0, p.shape)))
        .astype(np.float32)).to(p.dtype), params)


def _clone(tree):
    return tree_map(torch.clone, tree)


@pytest.mark.parametrize("arch,cut", CUTS)
def test_update_in_place_is_update_bitwise(jobs, monkeypatch, arch, cut):
    cfg = _cfg(arch)
    opt = make_optimizer(cfg.optimizer, constant(1e-3))
    shape = inplace.at(M.train_schema(cfg), CHUNKED_LEAF[arch]).shape
    if arch == "deepseek-v3-671b":
        assert shape[0] > 1
        if cut == "layers":
            # every stacked leaf takes the per-layer path, in both forms
            monkeypatch.setattr(adafactor, "CHUNK_BYTES", 1)
    else:
        rows = {"1 row": 1, "3 rows": 3,
                "whole": int(np.prod(shape[:-1]))}[cut]
        monkeypatch.setattr(adamw, "CHUNK_BYTES", 4 * shape[-1] * rows)
    slices = []
    cut_rows = inplace.row_slice
    monkeypatch.setattr(inplace, "row_slice",
                        lambda x, lo, hi: slices.append(
                            (getattr(x, "shape", None), hi - lo))
                        or cut_rows(x, lo, hi))
    rng = np.random.default_rng(1)
    params = _params(jobs.work, arch)
    step = torch.zeros((), dtype=torch.int32)
    # a first update gives the moments values
    params, state = opt.update(_grads(params, rng), opt.init(params),
                               params, step)
    grads = _grads(params, rng)
    want_p, want_s = opt.update(grads, state, params, step + 1)
    got_p, got_s = _clone(params), _clone(state)
    got = {"p": got_p, "s": got_s}
    ptrs = _ptrs(got)
    g = _clone(grads)
    out = opt.update_(g, got_s, got_p, step + 1)
    assert out[0] is got_p and out[1] is got_s
    assert all(x is None for x in tree_leaves(g))
    assert _ptrs(got) == ptrs
    for a, b in zip(tree_leaves(got), tree_leaves({"p": want_p,
                                                   "s": want_s})):
        assert torch.equal(a, b)
    if cut in ("1 row", "3 rows"):
        # the leaf's rows view, (rows, last), was cut into such chunks
        view = (int(np.prod(shape[:-1])), shape[-1])
        mine = [n for shp, n in slices if shp == view]
        assert mine and max(mine) == {"1 row": 1, "3 rows": 3}[cut]


def _rel_l2(got, want, base):
    got, want, base = (np.asarray(a, np.float64) for a in (got, want, base))
    err = float(np.linalg.norm((got - want).ravel()))
    ref = float(np.linalg.norm((want - base).ravel()))
    return err, ref


@pytest.mark.parametrize("arch", ARCHS)
def test_session_step_matches_jax_session(jobs, group, arch):
    """``build_session``'s donated step against the JAX package's, 3
    steps from the same numpy parameters."""
    work = jobs.wait("jax", JAX_TIMEOUT)
    cfg = _cfg(arch)
    run = RunConfig(loss_chunk=LOSS_CHUNK)
    opt, sch, sh, step, rules = train_cli.build_session(cfg, run, group,
                                                        SESSION_STEPS)
    state = R.distribute_params(TS.new_state(_params(work, arch), opt), sh)
    losses = []
    for b in _batches(cfg):
        out, m = step(state, TS.distribute_batch(b, rules))
        assert out is state
        losses.append(float(m["loss"]))
    with open(work / f"{arch}.jax.json") as f:
        np.testing.assert_allclose(losses, json.load(f), rtol=LOSS_RTOL)
    want = np.load(work / f"{arch}.jax.npz")
    base = np.load(work / f"{arch}.npz")
    trees = {"p": state["params"]}
    if "master" in state["opt"]:
        trees["m"] = state["opt"]["master"]
    for tag, tree in trees.items():
        for path in inplace.leaf_paths(tree):
            key = "/".join(path)
            got = _full(inplace.at(tree, path)).float().numpy()
            b = base[key]
            if tag == "p":
                # the start as the parameter's dtype holds it
                b = _full(inplace.at(_params(work, arch), path)).float()
            err, ref = _rel_l2(got, want[f"{tag}/{key}"], b)
            assert err <= TRAJ_SHARE * ref or err == 0.0, \
                (tag, key, err, ref)


def test_async_save_then_donated_step_keeps_the_saved_values(
        jobs, group, tmp_path, monkeypatch):
    """The train CLI's order: ``save(gathered(state))`` returns, the next
    donated step writes the state; the generation holds the saved step's
    values although its writer ran after that step."""
    arch = "jamba-v0.1-52b"
    cfg = _cfg(arch)
    run = RunConfig(loss_chunk=LOSS_CHUNK)
    opt, sch, sh, step, rules = train_cli.build_session(cfg, run, group,
                                                        SESSION_STEPS)
    state = R.distribute_params(TS.new_state(_params(jobs.work, arch), opt),
                                sh)
    b0, b1 = (TS.distribute_batch(b, rules) for b in _batches(cfg)[:2])
    step(state, b0)
    want = tree_map(lambda t: _full(t).clone(), state)
    gate = threading.Event()
    write = cmanager.CheckpointManager._write

    def held(self, job):
        gate.wait(60)
        return write(self, job)

    monkeypatch.setattr(cmanager.CheckpointManager, "_write", held)
    mgr = cmanager.CheckpointManager(tmp_path)
    mgr.save(1, train_cli.gathered(state), extra={"data_step": 1})
    step(state, b1)
    gate.set()
    mgr.wait()
    got, extra = mgr.restore(sch)
    assert extra["data_step"] == 1
    moved = False
    for g, w, s in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(state)):
        assert torch.equal(g, w)
        moved = moved or not torch.equal(_full(s), w)
    assert moved


@pytest.mark.parametrize("arch", ARCHS)
def test_compressed_step_donated_is_bitwise(jobs, group, arch):
    cfg = _cfg(arch)
    run = RunConfig(loss_chunk=LOSS_CHUNK, gradient_compression="int8")
    opt = make_optimizer(cfg.optimizer, constant(1e-3))
    rules = R.make_rules(make_mesh((1, 1, 1), ("pod", "data", "model"),
                                   "cpu"), "train")
    sh = TS.state_shardings(TS.state_schema(cfg, run, opt), rules, run)

    def state0():
        return R.distribute_params(
            TS.new_state(_params(jobs.work, arch), opt), sh)

    _run_both(TS.build_compressed_train_step(cfg, run, opt, rules),
              TS.build_compressed_train_step(cfg, run, opt, rules,
                                             donate=True),
              state0(), state0(),
              [TS.distribute_batch(b, rules) for b in _batches(cfg)])


def test_pipeline_step_donated_is_bitwise(jobs):
    """The one-process GPipe step (the card's form), 2 stages."""
    arch = "yi-6b-pipeline"
    cfg = _cfg(arch)
    run = RunConfig(loss_chunk=LOSS_CHUNK, pipeline_stages=2,
                    pp_microbatches=2)
    opt = make_optimizer(cfg.optimizer, constant(1e-3))
    plain, _ = PP.build_pipeline_train_step(cfg, run, opt)
    donated, _ = PP.build_pipeline_train_step(cfg, run, opt, donate=True)
    _run_both(plain, donated,
              TS.new_state(_params(jobs.work, arch), opt),
              TS.new_state(_params(jobs.work, arch), opt), _batches(cfg))


@pytest.mark.parametrize("case", WORLD)
def test_two_rank_zero1_donated_is_bitwise(jobs, case):
    work = jobs.wait("world", RANK_TIMEOUT)
    with open(work / "world.json") as f:
        rec = json.load(f)[case]
    assert rec["equal"] and all(rec["equal"]), rec
    assert rec["kept"] and rec["placed"]
    assert all(a == b and same for a, b, same in rec["losses"])
    if not case.endswith("-pipeline"):
        # ZeRO-1 split the optimizer state over "data"
        assert rec["split_opt_leaves"] > 0


def test_int8_zero_gradient_keeps_the_parameter_finite():
    """The JAX package's 8-bit AdamW dequantises a zero second moment to
    -7.9e-31, so an exactly zero gradient takes ``sqrt`` of a negative
    and its parameter turns NaN (every embedding row of a token a batch
    lacks; ROADMAP caveat 13).  The port clamps the moment at 0: finite
    there, weight decay alone moving it, and JAX's bits everywhere
    else."""
    import jax.numpy as jnp

    from repro.optim import constant as jconstant
    from repro.optim import make_optimizer as jmake_optimizer

    rng = np.random.default_rng(2)
    p = rng.standard_normal((4, 256)).astype(np.float32)
    g = (rng.standard_normal((4, 256))
         * np.exp(rng.uniform(-8, 0, (4, 256)))).astype(np.float32)
    g[1] = 0.0
    g[2, :128] = 0.0
    jopt = jmake_optimizer("adamw8bit", jconstant(1e-3))
    topt = make_optimizer("adamw8bit", constant(1e-3))
    jp = {"w": jnp.asarray(p)}
    want, _ = jopt.update({"w": jnp.asarray(g)}, jopt.init(jp), jp,
                          jnp.zeros((), jnp.int32))
    tp = {"w": torch.from_numpy(p)}
    got, _ = topt.update({"w": torch.from_numpy(g)}, topt.init(tp), tp,
                         torch.zeros((), dtype=torch.int32))
    want, got, zero = np.asarray(want["w"]), got["w"].numpy(), g == 0
    assert np.isnan(want[zero]).all() and not np.isnan(want[~zero]).any()
    np.testing.assert_array_equal(got[~zero], want[~zero])
    np.testing.assert_allclose(got[zero], p[zero] * (1 - 1e-3 * 0.1),
                               rtol=1e-6)
