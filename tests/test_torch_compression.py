"""The cross-pod gradient compression (``optim/compression.py``) and the
compressed train step against the JAX package.

* ``_q8`` / ``_dq8`` bitwise against ``repro.optim.compression``'s on
  the CPU: sizes below, at and past a block, a padded tail, an all-zero
  block, bf16 input, large, small and subnormal magnitudes (``_q8``
  under ``torch.set_flush_denormal(True)``: XLA's CPU backend flushes
  subnormals to zero); ``compressed_bytes`` equal.
* ``cross_pod_reduce`` on gloo pod groups of 2 and 3 (one spawned
  subprocess a pod, meeting at a ``FileStore`` under ``tmp_path``, each
  with its own timeout), both methods, each pod's tree of leaves drawn
  with numpy from a seed: within 1e-6·max|g| of the JAX package's
  ``cross_pod_reduce`` in a ``shard_map`` manual over "pod" (a JAX
  subprocess on forced CPU devices, an ``AxisType.Auto`` mesh); the
  int8 sum within the JAX test's bound ``max(absmax/127, 1e-6)·1.5 +
  1e-7`` of the exact sum (``tests/test_distributed.py::
  test_compressed_cross_pod_gradients``); the exchange sends int8
  payloads and f32 scales only, ``compressed_bytes`` of each leaf a hop.
* ``build_compressed_train_step`` on gloo ("pod", "data", "model") =
  (2, 2, 1) and (2, 1, 2), smoke yi-6b (f32, B = 8, S = 32, AdamW at
  1e-3), both methods, one step, against the JAX package's compressed
  step on the same Auto mesh and against the port's ``build_train_step``
  under the same rules: losses within ``LOSS_ATOL`` 5e-4 (against the
  SPMD step, the pods' summed NLL over their summed tokens: the step
  reports the mean of the pods' means, as the JAX package's does); the
  gradients
  before the update (``compressed_grads``; the JAX side the manual-pod
  reduction of ``tests/test_distributed.py``) within 2e-5 for "none"
  and within the int8 bound for "int8"; each leaf's update within 5 %
  relative L2 (Adam's sign normalisation parts elements whose gradient
  is at the rounding floor, as ``tests/test_torch_optim.py`` compares
  trajectories).
* The manual branch of ``shard``: the port's specs under rules manual
  over "pod" equal ``repro.sharding.rules.shard``'s inside a
  manual-"pod" abstract mesh, (2, 16, 16), both phases.
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

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.shapes import ShapeConfig as JShapeConfig  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as JPipeline  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.optim import compression as comp  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH = "yi-6b"
PODS = (2, 3)
METHODS = ("none", "int8")
STEP_MESHES = {"2x2x1": (2, 2, 1), "2x1x2": (2, 1, 2)}
LEAF_SHAPES = {"a": (3, 100), "b": (256,), "c": (2, 300), "d": (7,)}
LOSS_ATOL = 5e-4
EXACT_ATOL = 2e-5
REDUCE_SHARE = 1e-6
UPDATE_RL2 = 0.05
RANK_TIMEOUT = 300
SEED = 0


def int8_bound(exact: np.ndarray) -> float:
    """The JAX test's bound on an int8 sum's distance from the exact."""
    return max(float(np.abs(exact).max()) / 127.0, 1e-6) * 1.5 + 1e-7


# ---------------------------------------------------------------------------
# _q8 / _dq8 / compressed_bytes, in this process
# ---------------------------------------------------------------------------


def _q8_cases():
    rng = np.random.default_rng(SEED)
    zero_block = rng.standard_normal(3 * 256).astype(np.float32)
    zero_block[256:512] = 0.0
    return {
        "one": rng.standard_normal(1).astype(np.float32),
        "below": rng.standard_normal(255).astype(np.float32),
        "at": rng.standard_normal(256).astype(np.float32),
        "past": rng.standard_normal(257).astype(np.float32),
        "tail": rng.standard_normal((7, 100)).astype(np.float32),
        "zero-block": zero_block,
        "all-zero": np.zeros(300, np.float32),
        "large": (rng.standard_normal(600) * 1e37).astype(np.float32),
        "small": (rng.standard_normal(600) * 1e-35).astype(np.float32),
        "subnormal": (rng.standard_normal(600) * 1e-39).astype(np.float32),
        "mixed": np.concatenate([rng.standard_normal(256) * 1e-30,
                                 rng.standard_normal(256) * 1e30]
                                ).astype(np.float32),
    }


@pytest.mark.parametrize("name", sorted(_q8_cases()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_and_dq8_bitwise_equal_jax(name, dtype):
    x = _q8_cases()[name]
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js, jn = jcomp._q8(jx)
    # XLA's CPU backend flushes subnormals to zero: the port runs in the
    # same mode (its subnormal scale would be kept otherwise)
    flush = torch.set_flush_denormal(True)
    try:
        tq, ts, tn = comp._q8(tx)
    finally:
        torch.set_flush_denormal(False)
    assert flush
    assert tn == jn == x.size
    assert tq.dtype == torch.int8 and ts.dtype == tx.dtype
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))
    jd = jcomp._dq8(jq, js, jn, x.shape)
    td = comp._dq8(tq, ts, tn, x.shape)
    assert td.dtype == torch.float32 and tuple(td.shape) == x.shape
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 10_000, 1_234_567])
def test_compressed_bytes_equal_jax(n):
    assert comp.compressed_bytes(n) == jcomp.compressed_bytes(n)


# ---------------------------------------------------------------------------
# The manual branch of shard (specs on abstract meshes)
# ---------------------------------------------------------------------------

#: (logical axes, shape) of activations and parameters inside a pod's
#: region at the (2, 16, 16) mesh's sizes
SHARD_SITES = (
    (("batch", None, "d_model"), (32, 4096, 4096)),
    (("batch", None, "heads", None), (32, 4096, 32, 128)),
    (("batch", "kv_heads", None, None), (32, 4, 4096, 128)),
    (("batch", "kv_seq", "kv_heads", None), (32, 4096, 4, 128)),
    (("batch", "kv_seq_long", "kv_heads", None), (4, 4096, 4, 128)),
    (("batch", None, "mlp"), (32, 4096, 11008)),
    (("embed", "heads", "head_dim"), (4096, 32, 128)),
    (("experts", "embed", "mlp"), (64, 4096, 1408)),
    (("experts", "mlp", "embed"), (160, 1536, 5120)),
    (("batch", None, None, None), (2, 64, 256, 5120)),
    (("vocab", "embed"), (64000, 4096)),
    (("batch", None), (3, 7)),
)


def _jax_manual_specs(phase):
    """``repro.sharding.rules.shard``'s spec at every site inside a
    region manual over "pod" (its ``with_sharding_constraint`` replaced
    by a recorder)."""
    from jax.sharding import AbstractMesh, AxisType

    from repro.sharding import rules as JR

    am = AbstractMesh((2, 16, 16), ("pod", "data", "model"),
                      axis_types=(AxisType.Manual, AxisType.Auto,
                                  AxisType.Auto))
    rules = JR.make_rules(
        AbstractMesh((2, 16, 16), ("pod", "data", "model")), phase)
    inner = dataclasses.replace(rules,
                                rules={**rules.rules, "batch": (("data",),)})
    seen = []
    real = JR.jax.lax.with_sharding_constraint

    def record(x, s):
        seen.append(tuple(s.spec))
        return x

    JR.jax.lax.with_sharding_constraint = record
    try:
        with jax.sharding.use_abstract_mesh(am), JR.axis_rules(inner):
            for axes, shape in SHARD_SITES:
                JR.shard(jax.ShapeDtypeStruct(shape, jnp.float32), *axes)
    finally:
        JR.jax.lax.with_sharding_constraint = real
    return seen


@pytest.mark.parametrize("phase", ["train", "serve"])
def test_manual_pod_branch_specs_equal_jax(phase):
    want = _jax_manual_specs(phase)
    outer = R.make_rules(R.AbstractMesh((2, 16, 16),
                                        ("pod", "data", "model")), phase)
    inner = dataclasses.replace(
        outer, rules={**outer.rules, "batch": (("data",),)},
        manual=("pod",))
    got = [tuple(inner.spec(axes, shape)) for axes, shape in SHARD_SITES]
    assert got == want
    assert all("pod" not in R._entry_axes(p) for s in got for p in s)
    region = inner.region_mesh
    assert (region.axis_names, region.axis_sizes) == (("data", "model"),
                                                      (16, 16))
    for (axes, shape), spec in zip(SHARD_SITES, got):
        assert inner.placements(axes, shape) == R.spec_placements(region,
                                                                  spec)


def test_pod_rules_need_a_pod_axis():
    from repro_torch.runtime import train_step as TS

    rules = R.make_rules(R.AbstractMesh((2, 2), ("data", "model")))
    with pytest.raises(ValueError, match="pod"):
        TS.pod_rules(rules)


# ---------------------------------------------------------------------------
# cross_pod_reduce and the compressed step on gloo ranks
# ---------------------------------------------------------------------------

_JAX = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, PartitionSpec as P

from repro.compat import configure_partial_auto, shard_map
configure_partial_auto()
from repro.configs import RunConfig, get_config, smoke_config
from repro.optim import constant, make_optimizer
from repro.optim.compression import cross_pod_reduce
from repro.runtime.train_step import build_compressed_train_step, \
    compute_grads
from repro.sharding.rules import axis_rules, make_rules

work, spec, job = sys.argv[2], json.loads(sys.argv[3]), sys.argv[4]


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


def auto(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                names, axis_types=(AxisType.Auto,) * len(names))


if job == "reduce":
    for pods in spec["pods"]:
        mesh = auto((pods,), ("pod",))
        data = np.load(f"{work}/reduce-{pods}.npz")
        tree = {k: jnp.asarray(data[k]) for k in data}   # (pods, ...)
        for method in spec["methods"]:
            def inner(g):
                g = jax.tree.map(lambda a: a[0], g)
                out = cross_pod_reduce(g, "pod", method=method)
                return jax.tree.map(lambda a: a[None], out)
            specs = jax.tree.map(lambda _: P("pod"), tree)
            out = jax.jit(shard_map(inner, mesh=mesh, in_specs=(specs,),
                                    out_specs=specs, axis_names={"pod"},
                                    check_vma=False))(tree)
            np.savez(f"{work}/jax-reduce-{pods}-{method}.npz",
                     **{k: np.asarray(v) for k, v in out.items()})
else:
    cfg = smoke_config(get_config(spec["arch"]))
    data = np.load(f"{work}/step.npz")
    params = unflatten({k[2:]: data[k] for k in data if k[:2] == "p/"})
    batch = {k: jnp.asarray(data[k]) for k in ("tokens", "loss_mask")}
    mesh = auto(tuple(spec["meshes"][job]), ("pod", "data", "model"))
    rules = make_rules(mesh, "train")
    inner_rules = dataclasses.replace(
        rules, rules={**rules.rules, "batch": (("data",),)})
    opt = make_optimizer("adamw", constant(1e-3))
    out = {}
    for method in spec["methods"]:
        run = RunConfig(loss_chunk=32, gradient_compression=method)

        def inner(p, b):
            with axis_rules(inner_rules):
                g, m = compute_grads(cfg, run, p, b)
            cnt = m["token_count"].astype(jnp.float32)
            g = jax.tree.map(lambda x: x * cnt, g)
            g = cross_pod_reduce(g, "pod", method=method)
            cnt_total = jax.lax.psum(cnt, "pod")
            return jax.tree.map(lambda x: x / cnt_total, g)

        def grads_of(p, b):
            pspec = jax.tree.map(lambda _: P(), p)
            bspec = jax.tree.map(lambda x: P("pod") if x.ndim else P(), b)
            return shard_map(inner, mesh=mesh, in_specs=(pspec, bspec),
                             out_specs=pspec, axis_names={"pod"},
                             check_vma=False)(p, b)

        grads = jax.jit(grads_of)(params, batch)
        state = {"params": params, "opt": opt.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        step = jax.jit(build_compressed_train_step(cfg, run, opt, rules))
        new, metrics = step(state, batch)
        np.savez(f"{work}/jax-step-{job}-{method}.npz",
                 **{f"g/{k}": v for k, v in flat(grads).items()},
                 **{f"n/{k}": v for k, v in flat(new["params"]).items()})
        out[method] = float(metrics["loss"])
    with open(f"{work}/jax-step-{job}.json", "w") as f:
        json.dump(out, f)
print("JAX_OK")
"""

_REDUCE_RANK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import compression as comp

rank, world, store, work = (int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                            sys.argv[5])
spec = json.loads(sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
group = make_mesh((world,), ("pod",), "cpu").get_group("pod")
data = np.load(f"{work}/reduce-{world}.npz")
tree = {k: torch.from_numpy(data[k][rank]) for k in data}
rec = {}
for method in spec["methods"]:
    sent0 = dict(comp.SENT)
    out = comp.cross_pod_reduce(tree, group, method)
    rec[method] = {k: comp.SENT[k] - sent0[k] for k in sent0}
    np.savez(f"{work}/port-reduce-{world}-{method}-rank{rank}.npz",
             **{k: v.numpy() for k, v in out.items()})
with open(f"{work}/port-reduce-{world}-rank{rank}.json", "w") as f:
    json.dump(rec, f)
dist.destroy_process_group()
print("RANK_OK", rank)
"""

_STEP_RANK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import RunConfig, get_config, smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves
from repro_torch.optim import constant, make_optimizer
from repro_torch.runtime import train_step as TS
from repro_torch.sharding.rules import axis_rules, distribute_params, \
    make_rules

rank, world, store, work, mname = (int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4], sys.argv[5], sys.argv[6])
spec = json.loads(sys.argv[7])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
cfg = smoke_config(get_config(spec["arch"]))


def unflatten(flat):
    out = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split("/")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def gather(tree):
    return [t.full_tensor().numpy() if isinstance(t, DTensor) else
            t.numpy() for t in tree_leaves(tree)]


data = np.load(f"{work}/step.npz")
params = params_from_numpy(
    cfg, unflatten({k[2:]: data[k] for k in data if k[:2] == "p/"}), "cpu",
    train=True)
batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "loss_mask")}
mesh = make_mesh(tuple(spec["meshes"][mname]), ("pod", "data", "model"),
                 "cpu")
rules = make_rules(mesh, "train")
opt = make_optimizer("adamw", constant(1e-3))
out, arrays = {}, {}
for method in spec["methods"]:
    run = RunConfig(loss_chunk=32, gradient_compression=method)
    sh = TS.state_shardings(TS.state_schema(cfg, run, opt), rules, run)
    state = distribute_params(TS.new_state(params, opt), sh)
    dbatch = TS.distribute_batch(batch, rules)
    grads, gm = TS.compressed_grads(cfg, run, state["params"], dbatch, rules)
    new, metrics = TS.build_compressed_train_step(cfg, run, opt, rules)(
        state, dbatch)
    placed = all(tuple(t.placements) == s.placements
                 for t, s in zip(tree_leaves(new), tree_leaves(sh)))
    out[method] = {"loss": float(metrics["loss"]),
                   "global_loss": float(metrics["nll_sum"]
                                        / metrics["token_count"]),
                   "grad_loss": float(gm["loss"]), "placed": placed,
                   "step": int(new["step"].full_tensor())}
    arrays.update({f"{method}/g{i}": a for i, a in enumerate(gather(grads))})
    arrays.update({f"{method}/n{i}": a
                   for i, a in enumerate(gather(new["params"]))})
# the SPMD baseline under the same rules
run = RunConfig(loss_chunk=32)
sh = TS.state_shardings(TS.state_schema(cfg, run, opt), rules, run)
state = distribute_params(TS.new_state(params, opt), sh)
dbatch = TS.distribute_batch(batch, rules)
with axis_rules(rules), implicit_replication():
    sgrads, _ = TS.compute_grads(cfg, run, state["params"], dbatch,
                                 sh["params"])
new, metrics = TS.build_train_step(cfg, run, opt, rules)(state, dbatch)
out["spmd"] = {"loss": float(metrics["loss"])}
arrays.update({f"spmd/g{i}": a for i, a in enumerate(gather(sgrads))})
arrays.update({f"spmd/n{i}": a for i, a in enumerate(gather(new["params"]))})
if rank == 0:
    np.savez(f"{work}/port-step-{mname}.npz", **arrays)
    with open(f"{work}/port-step-{mname}.json", "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _spec() -> dict:
    return {"arch": ARCH, "pods": list(PODS), "methods": list(METHODS),
            "meshes": {k: list(v) for k, v in STEP_MESHES.items()}}


def _wait(procs, marker):
    outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and marker in so, se[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every JAX job and every world of ranks, side by side; returns the
    work dir."""
    work = tmp_path_factory.mktemp("compression")
    rng = np.random.default_rng(SEED)
    for pods in PODS:
        np.savez(work / f"reduce-{pods}.npz",
                 **{k: (rng.standard_normal((pods,) + s)
                        * rng.uniform(0.1, 10.0)).astype(np.float32)
                    for k, s in LEAF_SHAPES.items()})
    jc = jsmoke_config(jget_config(ARCH))
    jp = jinit_params(JM.schema(jc), jax.random.key(0))
    batch = JPipeline(jc, JShapeConfig("t", "train", 32, 8)).batch_at(0)
    np.savez(work / "step.npz", **{f"p/{k}": v for k, v in _flat(jp).items()},
             **{k: np.asarray(v) for k, v in batch.items()})
    spec = json.dumps(_spec())
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")

    def start(*argv):
        return subprocess.Popen([sys.executable, "-c", *argv],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)

    jax_procs = [start(_JAX, SRC, str(work), spec, job)
                 for job in ("reduce", *STEP_MESHES)]
    ranks = []
    for pods in PODS:
        store = work / f"store-reduce-{pods}"
        ranks += [start(_REDUCE_RANK, SRC, str(r), str(pods), str(store),
                        str(work), spec) for r in range(pods)]
    for mname, shape in STEP_MESHES.items():
        world = int(np.prod(shape))
        store = work / f"store-step-{mname}"
        ranks += [start(_STEP_RANK, SRC, str(r), str(world), str(store),
                        str(work), mname, spec) for r in range(world)]
    try:
        _wait(jax_procs, "JAX_OK")
        _wait(ranks, "RANK_OK")
    finally:
        for p in jax_procs + ranks:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return work


REDUCE_CASES = [(p, m) for p in PODS for m in METHODS]


@pytest.mark.parametrize("pods,method", REDUCE_CASES)
def test_cross_pod_reduce_equals_jax(runs, pods, method):
    want = np.load(runs / f"jax-reduce-{pods}-{method}.npz")
    for r in range(pods):
        got = np.load(runs / f"port-reduce-{pods}-{method}-rank{r}.npz")
        for k in LEAF_SHAPES:
            w = want[k][r]
            assert got[k].shape == w.shape and got[k].dtype == np.float32
            scale = float(np.abs(w).max())
            assert float(np.abs(got[k] - w).max()) <= REDUCE_SHARE * scale, \
                (r, k)


@pytest.mark.parametrize("pods", PODS)
def test_int8_reduce_within_the_quantisation_bound(runs, pods):
    data = np.load(runs / f"reduce-{pods}.npz")
    for r in range(pods):
        exact = np.load(runs / f"port-reduce-{pods}-none-rank{r}.npz")
        got = np.load(runs / f"port-reduce-{pods}-int8-rank{r}.npz")
        for k in LEAF_SHAPES:
            np.testing.assert_allclose(exact[k], data[k].sum(0), rtol=1e-6,
                                       atol=1e-6)
            err = float(np.abs(got[k] - exact[k]).max())
            assert 0 < err <= int8_bound(exact[k]), (r, k, err)


@pytest.mark.parametrize("pods", PODS)
def test_int8_exchange_sends_int8_and_scales_only(runs, pods):
    """Each rank sent ``compressed_bytes`` of every leaf on each of its
    P − 1 hops: the n int8 values and one f32 scale a block; the exact
    sum sent nothing through the exchange."""
    sizes = [int(np.prod(s)) for s in LEAF_SHAPES.values()]
    hops = pods - 1
    for r in range(pods):
        with open(runs / f"port-reduce-{pods}-rank{r}.json") as f:
            rec = json.load(f)
        assert rec["none"] == {"int8": 0, "float32": 0}
        sent = rec["int8"]
        assert sent["int8"] == sum(sizes) * hops
        assert sent["int8"] + sent["float32"] == \
            sum(comp.compressed_bytes(n)[0] for n in sizes) * hops


def _leaf_update_rl2(new, old, ref_new, where=None):
    """The relative L2 distance of one leaf's update from the
    reference's, over the elements ``where`` (all by default)."""
    du, dr = new - old, ref_new - old
    if where is not None:
        du, dr = du[where], dr[where]
    return float(np.linalg.norm(du - dr) / max(np.linalg.norm(dr), 1e-30))


STEP_CASES = [(m, k) for m in STEP_MESHES for k in METHODS]


def _step(runs, mname):
    with open(runs / f"port-step-{mname}.json") as f:
        rec = json.load(f)
    return rec, np.load(runs / f"port-step-{mname}.npz")


def _jax_step(runs, mname, method):
    with open(runs / f"jax-step-{mname}.json") as f:
        loss = json.load(f)[method]
    return loss, np.load(runs / f"jax-step-{mname}-{method}.npz")


def _leaves(npz, prefix):
    keys = sorted((k for k in npz if k.startswith(prefix)),
                  key=lambda k: k[len(prefix):])
    return [npz[k] for k in keys]


def _port_leaves(npz, tag):
    n = len([k for k in npz if k.startswith(tag)])
    return [npz[f"{tag}{i}"] for i in range(n)]


@pytest.mark.parametrize("mname,method", STEP_CASES)
def test_compressed_step_loss_equals_jax_and_the_spmd_step(runs, mname,
                                                           method):
    rec, _ = _step(runs, mname)
    jloss, _ = _jax_step(runs, mname, method)
    got = rec[method]
    assert abs(got["loss"] - jloss) <= LOSS_ATOL, (got, jloss)
    assert abs(got["grad_loss"] - got["loss"]) <= 1e-6, got
    # the step's loss is the pods' mean of their own means, as in the
    # JAX package; its summed NLL over the summed count is the SPMD loss
    assert abs(got["global_loss"] - rec["spmd"]["loss"]) <= LOSS_ATOL, rec
    assert got["placed"] and got["step"] == 1, got


@pytest.mark.parametrize("mname,method", STEP_CASES)
def test_compressed_grads_equal_jax_and_the_spmd_grads(runs, mname, method):
    """Before the update: "none" within 2e-5 of JAX's compressed
    gradients and of the port's SPMD ones; "int8" within the int8 bound
    of JAX's int8 gradients and of the port's exact ones."""
    _, arrays = _step(runs, mname)
    _, jarr = _jax_step(runs, mname, method)
    got = _port_leaves(arrays, f"{method}/g")
    want = _leaves(jarr, "g/")
    spmd = _port_leaves(arrays, "spmd/g")
    exact = _port_leaves(arrays, "none/g")
    assert got and len(got) == len(want) == len(spmd)
    for i, (g, w, s, e) in enumerate(zip(got, want, spmd, exact)):
        assert g.shape == w.shape, i
        if method == "none":
            np.testing.assert_allclose(g, w, atol=EXACT_ATOL, rtol=0)
            np.testing.assert_allclose(g, s, atol=EXACT_ATOL, rtol=0)
        else:
            assert float(np.abs(g - w).max()) <= int8_bound(w), i
            assert float(np.abs(g - e).max()) <= int8_bound(e), i


@pytest.mark.parametrize("mname,method", STEP_CASES)
def test_compressed_update_equals_jax_and_the_spmd_step(runs, mname, method):
    """Each parameter leaf's update within 5 % relative L2 of JAX's
    compressed step's and of the port's SPMD step's.  For "int8" over
    the elements whose exact gradient exceeds twice the int8 bound: a
    first AdamW step moves every element by about ±lr, the sign of its
    gradient, so where the quantisation noise can flip that sign the
    two packages' int8 steps part by 2·lr (they cut a sharded leaf's
    blocks differently, module docstring of ``optim/compression.py``);
    most elements are kept."""
    _, arrays = _step(runs, mname)
    _, jarr = _jax_step(runs, mname, method)
    data = np.load(runs / "step.npz")
    old = _leaves(data, "p/")
    got = _port_leaves(arrays, f"{method}/n")
    want = _leaves(jarr, "n/")
    spmd = _port_leaves(arrays, "spmd/n")
    exact = _port_leaves(arrays, "none/g")
    assert got and len(got) == len(want) == len(old) == len(spmd)
    kept = total = 0
    for i, (n, w, s, o, e) in enumerate(zip(got, want, spmd, old, exact)):
        where = None
        if method == "int8":
            where = np.abs(e) > 2 * int8_bound(e)
            kept, total = kept + int(where.sum()), total + where.size
        assert _leaf_update_rl2(n, o, w, where) <= UPDATE_RL2, i
        assert _leaf_update_rl2(n, o, s, where) <= UPDATE_RL2, i
    assert kept >= 0.5 * total, (kept, total)


@pytest.mark.parametrize("method", METHODS)
def test_one_pod_step_equals_train_step(method):
    """On a one-rank gloo mesh (1, 1, 1) ("pod", "data", "model") the
    compressed step makes no hop: two steps' losses within 1e-6
    relative and every parameter leaf within 1e-6·max|w| of
    ``build_train_step`` on plain tensors, nothing sent through the
    exchange (the card's ``compressed_train`` phase, at the smoke
    size)."""
    import torch.distributed as dist

    from repro_torch.configs import RunConfig, get_config, smoke_config
    from repro_torch.configs.shapes import SMOKE_SHAPES
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch.mesh import ensure_process_group, make_mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.runtime import train_step as TS

    cfg = smoke_config(get_config(ARCH))
    run = RunConfig(loss_chunk=32, microbatch=2,
                    gradient_compression=method)
    opt = make_optimizer("adamw", constant(1e-3))
    sch = TS.state_schema(cfg, run, opt)
    pipe = SyntheticLMPipeline(cfg, SMOKE_SHAPES["train_4k"])
    batches = [pipe.batch_at(i) for i in range(2)]

    def state0():
        return TS.new_state(TS.init_state(
            sch, torch.Generator().manual_seed(0), "cpu"), opt)

    state, want = state0(), []
    plain = TS.build_train_step(cfg, run, opt)
    for b in batches:
        state, m = plain(state, b)
        want.append(float(m["loss"]))
    own = not dist.is_initialized()
    ensure_process_group("cpu")
    try:
        rules = R.make_rules(make_mesh((1, 1, 1), ("pod", "data", "model"),
                                       "cpu"), "train")
        sh = TS.state_shardings(sch, rules, run)
        step = TS.build_compressed_train_step(cfg, run, opt, rules)
        got, sent0 = R.distribute_params(state0(), sh), dict(comp.SENT)
        losses = []
        for b in batches:
            got, m = step(got, TS.distribute_batch(b, rules))
            losses.append(float(m["loss"]))
        assert comp.SENT == sent0
        for g, w in zip(tree_leaves(got["params"]),
                        tree_leaves(state["params"])):
            scale = float(w.abs().max())
            assert float((g.to_local() - w).abs().max()) <= 1e-6 * scale
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()
    for a, b in zip(losses, want):
        assert abs(a - b) <= 1e-6 * abs(b), (losses, want)


# ---------------------------------------------------------------------------
# on the card: the one-rank NCCL mesh with a pod axis
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("method", METHODS)
def test_card_compressed_step_equals_train_step(method):
    """``build_compressed_train_step`` on a (1, 1, 1) ("pod", "data",
    "model") NCCL mesh against ``build_train_step`` on the same state:
    one pod makes no hop, so losses within 1e-6 relative and every
    parameter leaf within 1e-6·max|w|.  Smoke Yi-6B with its head dim
    widened to 32, which the card's flash kernel takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from repro_torch.configs import RunConfig, get_config, smoke_config
    from repro_torch.configs.shapes import SMOKE_SHAPES
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch.mesh import ensure_process_group, make_mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.runtime import train_step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), head_dim=32)
    run = RunConfig(loss_chunk=32, gradient_compression=method)
    opt = make_optimizer("adamw", constant(1e-3))
    own = not dist.is_initialized()
    ensure_process_group()
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
        rules = R.make_rules(mesh, "train")
        sch = TS.state_schema(cfg, run, opt)
        sh = TS.state_shardings(sch, rules, run)
        state = TS.new_state(TS.init_state(
            sch, torch.Generator(device=dev).manual_seed(0), dev), opt)
        batch = SyntheticLMPipeline(cfg, SMOKE_SHAPES["train_4k"],
                                    device=dev).batch_at(0)
        dstate = R.distribute_params(state, sh)
        dbatch = TS.distribute_batch(batch, rules)
        got, gm = TS.build_compressed_train_step(cfg, run, opt, rules)(
            dstate, dbatch)
        want, wm = TS.build_train_step(cfg, run, opt)(state, batch)
        torch.cuda.synchronize()
        assert abs(float(gm["loss"]) - float(wm["loss"])) <= \
            1e-6 * abs(float(wm["loss"]))
        for g, w in zip(tree_leaves(got["params"]),
                        tree_leaves(want["params"])):
            scale = float(w.abs().max())
            assert float((g.full_tensor() - w).abs().max()) <= 1e-6 * scale
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()
