"""Expert parallelism (``models/moe.py::apply_moe_ep``) on gloo ranks
against the JAX package's on 4 forced CPU devices, and the grouped
path's shard-local groups under rules (the ``_dp_size`` fault).

The smoke DeepSeek-V2 MoE (E=8, top-2, d=64, f=64): its parameters are
drawn with numpy from a seed for the whole smoke model (each at the
scale of its init: the router N(0, 0.02²), so that z is near its floor
(log E)² ≈ 4.3 and 1e-6 is a few of its f32 ulps), carried into the
port by ``models/convert.py``; the MoE layer's leaves and x (4, 16,
64) go to both packages.

* The reference is a JAX subprocess (``XLA_FLAGS`` forcing 4 CPU
  devices, an ``AxisType.Auto`` mesh, ``axis_rules(make_rules(mesh,
  "train"))``, ``jax.jit``): y, lb, z and the gradients of ``Σy² + lb +
  z`` for ``repro.models.moe.apply_moe_ep``, and each data rank's
  dropped assignments from ``route`` on its tokens.
* The port runs on spawned gloo ranks, one subprocess a rank meeting
  at a ``FileStore`` under ``tmp_path``, each with its own timeout, on
  DTensors placed by the train rules.
* Meshes ("data", "model") (2, 2) and (4, 1); routing drop-free
  (``capacity_factor`` 4.0) and with drops (1.0).  Bounds: y within
  1e-5·max|y|, lb and z within 1e-6, the gradients (``full_tensor()``)
  within 1e-3·max|g| leaf by leaf, drops per rank equal, and every
  rank took the expert-parallel path.

The ``_dp_size`` fault: the grouped path under rules with data = 2 at N
= 48 tokens, ``group_size`` 16 and ``capacity_factor`` 1.0 (one group of
24 a shard, C = 8; one size of groups for the whole batch would give
three of 16, C = 4) against the JAX grouped path under the same rules,
computed in the same JAX subprocess, with both dispatches: the port on
plain tensors under rules on an ``AbstractMesh`` (2, 2), and on
DTensors over the (2, 2) gloo ranks.
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

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH = "deepseek-v2-236b"
LEAVES = ("router", "w_gate", "w_up", "w_down")
X_SHAPE = (4, 16, 64)
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
ROUTINGS = {"dropfree": 4.0, "drops": 1.0}
#: the fault's shape: N = 48 tokens, groups of 16, capacity factor 1
FAULT_X = (2, 24, 64)
FAULT_GROUP = 16
DISPATCHES = ("einsum", "scatter")
Y_SHARE = 1e-5
AUX_ATOL = 1e-6
GRAD_SHARE = 1e-3
RANK_TIMEOUT = 240
SEED = 0

_JAX = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import get_config, smoke_config
from repro.models import moe
from repro.sharding.rules import axis_rules, make_rules

work = sys.argv[2]
spec = json.loads(sys.argv[3])
data = np.load(f"{work}/inputs.npz")
p = {k: jnp.asarray(data[k]) for k in spec["leaves"]}
base = smoke_config(get_config(spec["arch"]))
out = {}


def mesh_of(shape):
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def cfg_of(cf, **kw):
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf, **kw))


for mname, shape in spec["meshes"].items():
    mesh = mesh_of(shape)
    for rname, cf in spec["routings"].items():
        cfg = cfg_of(cf)
        x = jnp.asarray(data["x"])

        def fwd(p, x):
            return moe.apply_moe_ep(cfg, p, x)

        def loss(p, x):
            y, lb, z = fwd(p, x)
            return jnp.sum(y * y) + lb + z

        with axis_rules(make_rules(mesh, "train")):
            y, lb, z = jax.jit(fwd)(p, x)
            g = jax.jit(jax.grad(loss))(p, x)
        dp = shape[0]
        N, d = x.shape[0] * x.shape[1], x.shape[2]
        tl = N // dp
        C = moe.expert_capacity(tl, cfg)
        drops = []
        for r in range(dp):
            xr = x.reshape(N, d)[r * tl:(r + 1) * tl].astype(jnp.float32)
            _, _, mask, _, _ = moe.route(cfg, p, xr)
            drops.append(int(jnp.sum(moe._positions_in_expert(mask) >= C)))
        key = f"{mname}-{rname}"
        np.savez(f"{work}/jax-{key}.npz", y=np.asarray(y),
                 **{f"g_{k}": np.asarray(g[k]) for k in spec["leaves"]})
        out[key] = {"lb": float(lb), "z": float(z), "drops": drops, "C": C}

for dispatch in spec["dispatches"]:
    cfg = cfg_of(1.0, group_size=spec["fault_group"], dispatch=dispatch)
    with axis_rules(make_rules(mesh_of((2, 2)), "train")):
        y, lb, z = jax.jit(lambda p, x: moe._apply_moe_grouped(cfg, p, x))(
            p, jnp.asarray(data["x_fault"]))
    np.save(f"{work}/jax-fault-{dispatch}.npy", np.asarray(y))
    out[f"fault-{dispatch}"] = {"lb": float(lb), "z": float(z)}
with open(f"{work}/jax.json", "w") as f:
    json.dump(out, f)
print("JAX_OK")
"""

_RANK = r"""
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.sharding.rules import (axis_rules, distribute_params,
                                        make_rules, param_shardings)

rank, world, store, work, mname = (int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4], sys.argv[5], sys.argv[6])
spec = json.loads(sys.argv[7])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
data = np.load(f"{work}/inputs.npz")
base = smoke_config(get_config(spec["arch"]))
mesh = make_mesh(tuple(spec["meshes"][mname]), ("data", "model"), "cpu")
rules = make_rules(mesh, "train")
sh = param_shardings(moe.moe_schema(base), rules)
p = {k: torch.from_numpy(data[k]) for k in spec["leaves"]}
dparams = distribute_params(p, {k: sh[k] for k in spec["leaves"]})


def place_x(a):
    x = torch.from_numpy(a)
    return distribute_tensor(
        x, mesh, rules.placements(("batch", None, None), x.shape))


def cfg_of(cf, **kw):
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf, **kw))


out = {}
for rname, cf in spec["routings"].items():
    cfg = cfg_of(cf)
    wrt = {k: v.detach().requires_grad_() for k, v in dparams.items()}
    calls = dict(moe.MOE_CALLS)
    with axis_rules(rules), implicit_replication(), \
            moe.record_drops() as log:
        y, lb, z = moe.apply_moe_ep(cfg, wrt, place_x(data["x"]))
        loss = torch.sum(y * y) + lb + z
        grads = torch.autograd.grad(loss, [wrt[k] for k in spec["leaves"]])
    rec = {"paths": [path for path, _ in log],
           "drops": [int(n) for _, n in log],
           "ep_calls": moe.MOE_CALLS["ep"] - calls["ep"],
           "grouped_calls": moe.MOE_CALLS["grouped"] - calls["grouped"],
           "lb": float(lb.full_tensor()), "z": float(z.full_tensor())}
    y = y.full_tensor().detach().numpy()
    grads = {f"g_{k}": g.full_tensor().numpy()
             for k, g in zip(spec["leaves"], grads)}
    if rank == 0:
        np.savez(f"{work}/port-{mname}-{rname}.npz", y=y, **grads)
    out[rname] = rec
for dispatch in spec["dispatches"] if mname == "2x2" else ():
    cfg = cfg_of(1.0, group_size=spec["fault_group"], dispatch=dispatch)
    with axis_rules(rules), implicit_replication():
        y, lb, z = moe._apply_moe_grouped(cfg, dparams,
                                          place_x(data["x_fault"]))
    out[f"fault-{dispatch}"] = {"lb": float(lb.full_tensor()),
                                "z": float(z.full_tensor())}
    y = y.full_tensor().numpy()
    if rank == 0:
        np.save(f"{work}/port-fault-{dispatch}.npy", y)
with open(f"{work}/port-{mname}-rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def _spec() -> dict:
    return {"arch": ARCH, "leaves": list(LEAVES),
            "meshes": {k: list(v) for k, v in MESHES.items()},
            "routings": ROUTINGS, "fault_group": FAULT_GROUP,
            "dispatches": list(DISPATCHES)}


def _numpy_params():
    """Every leaf of the smoke model's JAX schema drawn with numpy from
    ``SEED``: N(0, 1/fan-in) matrices, the MoE router N(0, 0.02²) (its
    ``normal_param`` std), norm scales 1."""
    rng = np.random.default_rng(SEED)
    jc = jsmoke_config(jget_config(ARCH))

    def draw(path, s):
        shape = tuple(s.shape)
        if path[-1] == "router":
            return (rng.standard_normal(shape) * 0.02).astype(np.float32)
        if len(shape) < 2 or "norm" in path[-1]:
            return np.ones(shape, np.float32)
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        lambda kp, s: draw(tuple(k.key for k in kp), s), JM.schema(jc),
        is_leaf=lambda x: hasattr(x, "init"))


def _wait(procs, marker):
    outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and marker in so, se[-3000:]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The JAX reference and the port's ranks started side by side; the
    MoE layer's leaves taken from the port's parameters, which come from
    the numpy tree through ``models/convert.py``.  Yields (work dir, the
    JAX process, the ranks' processes by mesh)."""
    work = tmp_path_factory.mktemp("moe_ep")
    tree = _numpy_params()
    tc = smoke_config(get_config(ARCH))
    port = params_from_numpy(tc, tree, "cpu", train=True)
    mlp = port["b1"]["l0"]["mlp"]
    rng = np.random.default_rng(SEED + 1)
    np.savez(work / "inputs.npz",
             x=rng.standard_normal(X_SHAPE).astype(np.float32),
             x_fault=rng.standard_normal(FAULT_X).astype(np.float32),
             **{k: mlp[k][0].numpy() for k in LEAVES})
    spec = json.dumps(_spec())
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")

    def start(*argv):
        return subprocess.Popen([sys.executable, "-c", *argv],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)

    jax_proc = start(_JAX, SRC, str(work), spec)
    ranks = {}
    for mname, shape in MESHES.items():
        world = shape[0] * shape[1]
        store = work / f"store-{mname}"
        ranks[mname] = [start(_RANK, SRC, str(r), str(world), str(store),
                              str(work), mname, spec) for r in range(world)]
    try:
        yield work, jax_proc, ranks
    finally:
        for p in [jax_proc, *(q for ps in ranks.values() for q in ps)]:
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def ref(spawned):
    """The JAX subprocess's results."""
    work, jax_proc, _ = spawned
    _wait([jax_proc], "JAX_OK")
    with open(work / "jax.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(spawned, ref):
    """(work dir, the JAX results, each mesh's ranks' records)."""
    work, _, ranks = spawned
    _wait([p for ps in ranks.values() for p in ps], "RANK_OK")
    recs = {m: [json.load(open(work / f"port-{m}-rank{r}.json"))
                for r in range(len(ranks[m]))] for m in MESHES}
    return work, ref, recs


CASES = [(m, r) for m in MESHES for r in ROUTINGS]


@pytest.mark.parametrize("mname,rname", CASES)
def test_ep_output_and_aux_equal_jax(runs, mname, rname):
    work, ref, ranks = runs
    key = f"{mname}-{rname}"
    want = np.load(work / f"jax-{key}.npz")
    got = np.load(work / f"port-{key}.npz")
    scale = float(np.abs(want["y"]).max())
    assert float(np.abs(got["y"] - want["y"]).max()) <= Y_SHARE * scale
    for r in ranks[mname]:
        assert abs(r[rname]["lb"] - ref[key]["lb"]) <= AUX_ATOL, (r, ref)
        assert abs(r[rname]["z"] - ref[key]["z"]) <= AUX_ATOL, (r, ref)


@pytest.mark.parametrize("mname,rname", CASES)
def test_ep_gradients_equal_jax(runs, mname, rname):
    work, _, _ = runs
    key = f"{mname}-{rname}"
    want = np.load(work / f"jax-{key}.npz")
    got = np.load(work / f"port-{key}.npz")
    for k in LEAVES:
        w, g = want[f"g_{k}"], got[f"g_{k}"]
        assert g.shape == w.shape
        scale = float(np.abs(w).max())
        assert scale > 0, k
        assert float(np.abs(g - w).max()) <= GRAD_SHARE * scale, k


@pytest.mark.parametrize("mname,rname", CASES)
def test_ep_drops_per_rank_equal_jax_and_every_rank_took_ep(runs, mname,
                                                             rname):
    """Each rank's recorded drops equal those of the JAX routing of its
    data rank's tokens (model ranks route the same tokens); the drop-free
    routing drops none, the tight one some; each rank made one
    expert-parallel call and no grouped one."""
    _, ref, ranks = runs
    key = f"{mname}-{rname}"
    dp, tp = MESHES[mname]
    for i, r in enumerate(ranks[mname]):
        rec = r[rname]
        assert rec["ep_calls"] == 1 and rec["grouped_calls"] == 0, rec
        assert rec["paths"] == ["ep"], rec
        assert rec["drops"] == [ref[key]["drops"][i // tp]], (i, rec, ref)
    total = sum(ref[key]["drops"])
    assert (total == 0) == (rname == "dropfree"), ref[key]


def _fault_cfg(dispatch):
    tc = smoke_config(get_config(ARCH))
    return dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, capacity_factor=1.0, group_size=FAULT_GROUP,
        dispatch=dispatch))


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("where", ["abstract-mesh", "gloo-ranks"])
def test_grouped_path_under_rules_cuts_shard_local_groups(
        request, spawned, ref, where, dispatch):
    """The ``_dp_size`` fault: under rules with data = 2 the grouped path
    routes one group of 24 a shard (C = 8), as the JAX package does, not
    three groups of 16 (C = 4).  The port on plain tensors under rules on
    an ``AbstractMesh``, and on DTensors over the (2, 2) gloo ranks
    (routing on each rank's groups; the einsum dispatch's products on
    local shards, the scatter dispatch's groups in one region), with
    both dispatches."""
    work = spawned[0]
    key = f"fault-{dispatch}"
    want = np.load(work / f"jax-{key}.npy")
    data = np.load(work / "inputs.npz")
    if where == "abstract-mesh":
        p = {k: torch.from_numpy(data[k]) for k in LEAVES}
        rules = R.make_rules(R.AbstractMesh((2, 2), ("data", "model")),
                             "train")
        with R.axis_rules(rules):
            y, lb, z = moe_mod._apply_moe_grouped(
                _fault_cfg(dispatch), p, torch.from_numpy(data["x_fault"]))
        got, aux = y.numpy(), [{"lb": float(lb), "z": float(z)}]
    else:
        ranks = request.getfixturevalue("runs")[2]
        got = np.load(work / f"port-{key}.npy")
        aux = [r[key] for r in ranks["2x2"]]
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= Y_SHARE * scale
    for a in aux:
        assert abs(a["lb"] - ref[key]["lb"]) <= AUX_ATOL, (a, ref)
        assert abs(a["z"] - ref[key]["z"]) <= AUX_ATOL, (a, ref)
