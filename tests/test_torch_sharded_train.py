"""A sharded train step over gloo ranks equals the single device.

Check 2 of the placements: spawned ranks (one subprocess each, meeting
at a ``FileStore`` under ``tmp_path``, so no port is fixed; each with
its own timeout) build a ``torch.distributed`` device mesh, place the
state and the batch as DTensors by the train rules and run the port's
``build_train_step(..., rules)``; rank 0 also runs the unsharded step
on the same full tensors.  Four ranks take (2, 2) ("data", "model"),
and (1, 4) for the GQA head mappings; two ranks take (2,) ("data",).
The parameters are the JAX package's (``models/convert.py``), the batch
its pipeline's (smoke ``train_4k``: B=4, S=64), 2 layers, f32: the
smoke DeepSeek-V2's dense and MoE layers (MLA, the expert-parallel MoE
path; its MoE group set to the tokens a data rank holds in a
microbatch, so that the single device's groups are the ranks' token
sets and lb is the same function; its config's 8-bit AdamW, whose int8
blocks gather a sharded last dim), a 2-layer cut of the smoke Jamba
period, (mamba, moe) and (attn, dense) (the grouped MoE path cut into
shard-local groups), the same cut with the residual stream's sequence
over "model" (``seq_shard``, the dry run's Megatron-SP rule: the norm on
a batch and a sequence both sharded, the MoE's tokens flattened per
rank), and the smoke whisper (one decoder layer over its two encoder
layers, ``flat_dp``: the batch over "data" and "model", the token table
replicated; layernorm, so no norm kernel).  Each case steps with its
config's optimizer.

* the sharded loss is within 5e-4 of the JAX package's single-device
  loss (``loss_fn`` averaged over the step's microbatches, as its
  ``compute_grads`` reports it; the bound of
  ``tests/test_distributed.py::test_sharded_loss_equals_single_device``,
  whose multi-device run is red: the single device is the reference,
  ROADMAP caveat 1);
* the sharded step's loss, and the loss after its update, are within
  5e-4 of the port's unsharded step's, and its gradients, gathered with
  ``full_tensor()``, within 1e-3·max|g| of the unsharded gradients,
  leaf by leaf;
* GQA under head sharding: 4 q heads over 2 kv heads on a 4-way "model"
  axis (one q head a rank, kv replicated and sliced per rank), 12 over
  6 (three q heads a rank over two kv heads, gathered per q head), 8
  over 4 on (2, 2) (kv heads sharded with the q heads), and 6 over 3 on
  (2, 2) (3 kv heads do not divide "model": replicated there, while
  DTensor's matmul would shard the k/v product's last dim across a
  head);
* every kernel wrapper the arch runs took its ``local_map`` branch, and
  every MoE layer its path: expert parallelism under an
  ``ep_over_dp`` config, the grouped path otherwise.
"""
import dataclasses
import inspect
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
from repro.configs.base import BlockDef as JBlockDef  # noqa: E402
from repro.configs.shapes import SMOKE_SHAPES as JSMOKE_SHAPES  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as JPipeline  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
LOSS_ATOL = 5e-4
GRAD_SHARE = 1e-3
RANK_TIMEOUT = 240
LOSS_CHUNK = 16

#: name -> (arch, layers, heads, kv heads, mesh, axes, microbatch, MoE
#: group size[, "seq_shard"]); layers: every block repeated that often,
#: or the indices of the one block's pattern to keep, or None for the
#: smoke's blocks; "seq_shard" puts the residual stream's sequence over
#: "model" (Megatron-SP, the dry run's ``cell_rules``)
CASES = {
    "yi-2x2": ("yi-6b", 2, None, None, (2, 2), ("data", "model"), 2, None),
    "mamba-2x2": ("mamba2-370m", 2, None, None, (2, 2), ("data", "model"),
                  None, None),
    "gqa-4over2-1x4": ("yi-6b", 1, 4, 2, (1, 4), ("data", "model"), None,
                       None),
    "gqa-12over6-1x4": ("yi-6b", 1, 12, 6, (1, 4), ("data", "model"), None,
                        None),
    "gqa-8over4-2x2": ("yi-6b", 1, 8, 4, (2, 2), ("data", "model"), None,
                       None),
    "yi-2": ("yi-6b", 2, None, None, (2,), ("data",), None, None),
    "mamba-2": ("mamba2-370m", 2, None, None, (2,), ("data",), 2, None),
    "deepseek-v2-2x2": ("deepseek-v2-236b", None, None, None, (2, 2),
                        ("data", "model"), 2, 64),
    "jamba-2x2": ("jamba-v0.1-52b", (3, 4), None, None, (2, 2),
                  ("data", "model"), None, None),
    "jamba-sp-2x2": ("jamba-v0.1-52b", (3, 4), None, None, (2, 2),
                     ("data", "model"), 2, None, "seq_shard"),
    "gqa-6over3-2x2": ("yi-6b", 1, 6, 3, (2, 2), ("data", "model"), 2,
                       None),
    "whisper-2x2": ("whisper-large-v3", 1, None, None, (2, 2),
                    ("data", "model"), None, None),
}
#: the spawned worlds, run side by side (each started as soon as its
#: cases' parameters are drawn): (ranks, cases run in turn)
WORLDS = ((4, ("mamba-2x2", "whisper-2x2")),
          (4, ("jamba-2x2", "jamba-sp-2x2")),
          (4, ("deepseek-v2-2x2",)),
          (2, ("yi-2", "mamba-2")),
          (4, ("yi-2x2", "gqa-4over2-1x4", "gqa-12over6-1x4",
               "gqa-8over4-2x2", "gqa-6over3-2x2")))


def _cut(cfg, block_def, layers, heads, kv, group):
    """A case's config from the smoke one (either package's: its
    ``BlockDef`` is ``block_def``)."""
    if isinstance(layers, int):
        cfg = dataclasses.replace(
            cfg, num_layers=layers,
            blocks=tuple(block_def(b.pattern, layers) for b in cfg.blocks))
    elif layers is not None:
        pattern = tuple(cfg.blocks[0].pattern[i] for i in layers)
        cfg = dataclasses.replace(cfg, num_layers=len(pattern),
                                  blocks=(block_def(pattern, 1),))
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads, num_kv_heads=kv)
    if group:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, group_size=group))
    return cfg

_RANK = r"""
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import RunConfig, get_config, smoke_config
from repro_torch.configs.base import BlockDef
from repro_torch.kernels.local import LOCAL_MAP_CALLS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves
from repro_torch.optim import constant, make_optimizer
from repro_torch.runtime import train_step as TS
from repro_torch.sharding.rules import (axis_rules, distribute_params,
                                        make_rules)

rank, world, store, work = (int(sys.argv[2]), int(sys.argv[3]),
                            sys.argv[4], sys.argv[5])
cases = json.loads(sys.argv[6])
$CUT
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


for name, (arch, layers, heads, kv, mesh_shape, axes, mb, group,
           *opts) in cases.items():
    cfg = _cut(smoke_config(get_config(arch)), BlockDef, layers, heads, kv,
               group)
    data = np.load(f"{work}/{name}.npz")
    params = params_from_numpy(
        cfg, unflatten({k[2:]: data[k] for k in data if k[:2] == "p/"}),
        "cpu", train=True)
    batch = {k: torch.from_numpy(data[k]) for k in data if k[:2] != "p/"}
    run = RunConfig(loss_chunk=$CHUNK, microbatch=mb,
                    seq_shard="seq_shard" in opts)
    opt = make_optimizer(cfg.optimizer, constant(1e-3))
    mesh = make_mesh(tuple(mesh_shape), tuple(axes), "cpu")
    rules = make_rules(mesh, "train", flat_dp=cfg.flat_dp)
    if run.seq_shard:
        rules = dataclasses.replace(
            rules, rules={**rules.rules, "seq_res": (("model",),)})
    sch = TS.state_schema(cfg, run, opt)
    sh = TS.state_shardings(sch, rules, run)
    state = TS.new_state(params, opt)
    dstate = distribute_params(state, sh)
    dbatch = TS.distribute_batch(batch, rules)
    before = dict(LOCAL_MAP_CALLS)
    moe_before = dict(moe.MOE_CALLS)
    with axis_rules(rules), implicit_replication():
        dgrads, _ = TS.compute_grads(cfg, run, dstate["params"], dbatch,
                                     sh["params"])
    dgrads = [g.full_tensor() for g in tree_leaves(dgrads)]
    step = TS.build_train_step(cfg, run, opt, rules)
    s1, m1 = step(dstate, dbatch)
    with axis_rules(rules), implicit_replication():
        _, m2 = TS.compute_grads(cfg, run, s1["params"], dbatch)
    loss2 = float(m2["loss"].full_tensor())     # a collective: every rank
    calls = {k: LOCAL_MAP_CALLS[k] - before[k] for k in before}
    moe_calls = {k: moe.MOE_CALLS[k] - moe_before[k] for k in moe_before}
    if rank == 0:
        grads, _ = TS.compute_grads(cfg, run, params, batch)
        u1, n1 = TS.build_train_step(cfg, run, opt)(state, batch)
        _, n2 = TS.compute_grads(cfg, run, u1["params"], batch)
        out = {"loss": [float(m1["loss"]), loss2],
               "plain_loss": [float(n1["loss"]), float(n2["loss"])],
               "calls": calls, "moe_calls": moe_calls}
        np.savez(f"{work}/{name}.out.npz",
                 **{f"g{i}": g.numpy() for i, g in enumerate(dgrads)},
                 **{f"w{i}": g.numpy()
                    for i, g in enumerate(tree_leaves(grads))})
        with open(f"{work}/{name}.json", "w") as f:
            json.dump(out, f)
dist.destroy_process_group()
print("RANK_OK", rank)
""".replace("$CHUNK", str(LOSS_CHUNK))


def _cfgs(name):
    arch, layers, heads, kv = CASES[name][:4]
    return _cut(jsmoke_config(jget_config(arch)), JBlockDef, layers, heads,
                kv, CASES[name][7])


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _spawn(world, names, work):
    store = work / f"store-{names[0]}"
    cases = json.dumps({n: CASES[n] for n in names})
    env = dict(os.environ, OMP_NUM_THREADS="1")
    script = _RANK.replace("$CUT", "import dataclasses\n"
                           + inspect.getsource(_cut))
    return [subprocess.Popen(
        [sys.executable, "-c", script, SRC, str(r), str(world), str(store),
         str(work), cases],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]


def _jax_loss(name, jc, jp, batch):
    """The JAX package's single-device loss of the case's step: the mean
    of ``loss_fn`` over its microbatches (``compute_grads``'s metric)."""
    mb = CASES[name][6] or batch["tokens"].shape[0]
    loss = jax.jit(lambda p, b: JM.loss_fn(jc, p, b,
                                           loss_chunk=LOSS_CHUNK)[0])
    parts = [float(loss(jp, {k: jnp.asarray(v[i:i + mb])
                             for k, v in batch.items()}))
             for i in range(0, batch["tokens"].shape[0], mb)]
    return sum(parts) / len(parts)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on its world's spawned ranks; the JAX reference loss
    of each case (computed while the ranks run) beside rank 0's
    results."""
    work = tmp_path_factory.mktemp("sharded")
    inputs, procs = {}, []
    try:
        for world, names in WORLDS:
            for name in names:
                jc = _cfgs(name)
                jp = jinit_params(JM.schema(jc), jax.random.key(0))
                batch = {k: np.asarray(v) for k, v in JPipeline(
                    jc, JSMOKE_SHAPES["train_4k"]).batch_at(0).items()}
                # bf16 embeddings kept exactly as f32 for the ranks
                np.savez(work / f"{name}.npz",
                         **{f"p/{k}": v for k, v in _flat(jp).items()},
                         **{k: v.astype(np.float32) if v.dtype == jnp.bfloat16
                            else v for k, v in batch.items()})
                inputs[name] = (jc, jp, batch)
            procs += _spawn(world, names, work)
        jax_loss = {name: _jax_loss(name, *inputs[name]) for name in CASES}
        outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and "RANK_OK" in so, se[-3000:]
    out = {}
    for name in CASES:
        with open(work / f"{name}.json") as f:
            rec = json.load(f)
        g = np.load(work / f"{name}.out.npz")
        n = len([k for k in g if k[0] == "g"])
        rec["grads"] = [(g[f"g{i}"], g[f"w{i}"]) for i in range(n)]
        rec["jax_loss"] = jax_loss[name]
        out[name] = rec
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_loss_equals_jax_single_device(runs, name):
    r = runs[name]
    assert abs(r["loss"][0] - r["jax_loss"]) <= LOSS_ATOL, r


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_equals_unsharded(runs, name):
    r = runs[name]
    for a, b in zip(r["loss"], r["plain_loss"]):
        assert abs(a - b) <= LOSS_ATOL, r
    assert r["grads"]
    for i, (g, w) in enumerate(r["grads"]):
        scale = float(np.abs(w).max())
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= GRAD_SHARE * scale, (name, i)


def _kinds(name):
    return {kind for b in _cfgs(name).blocks for kind in b.pattern}


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_kernel_took_its_local_map_branch(runs, name):
    mixers = {mixer for mixer, _ in _kinds(name)}
    want = ({"rmsnorm_residual"} if _cfgs(name).norm == "rmsnorm"
            else set()) | (
        {"ssd_chunk"} if "mamba" in mixers else set()) | (
        {"flash_attention"} if mixers & {"attn", "mla"} else set())
    calls = runs[name]["calls"]
    assert all(calls[k] > 0 for k in want), calls
    assert all(calls[k] == 0 for k in set(calls) - want), calls


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_moe_layer_took_its_path(runs, name):
    """Every MoE layer call of the step took expert parallelism under an
    ``ep_over_dp`` config and the grouped path otherwise; no call
    without MoE layers."""
    cfg = _cfgs(name)
    calls = runs[name]["moe_calls"]
    if not any(mlp == "moe" for _, mlp in _kinds(name)):
        assert calls == {"grouped": 0, "ep": 0}, calls
        return
    path = "ep" if cfg.moe.ep_over_dp else "grouped"
    assert calls[path] > 0, calls
    assert calls["ep" if path == "grouped" else "grouped"] == 0, calls


# ---------------------------------------------------------------------------
# on the card: the one-rank NCCL mesh
# ---------------------------------------------------------------------------


def _card_cfg(tc):
    """A smoke config at head dims the card's flash kernel takes (32),
    Jamba cut to its (mamba, moe) and (attn, dense) layers, and a MoE
    group of the step's every token (the one rank's expert-parallel
    routing set)."""
    from repro_torch.configs.base import BlockDef, MLAConfig

    if tc.mla is not None:
        tc = dataclasses.replace(tc, mla=MLAConfig(
            q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=24,
            qk_rope_head_dim=8, v_head_dim=32))
    elif tc.head_dim:
        tc = dataclasses.replace(tc, head_dim=32)
    if tc.ssm is not None and tc.moe is not None:
        tc = _cut(tc, BlockDef, (3, 4), None, None, None)
    if tc.moe is not None:
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, group_size=4 * 64))
    return tc


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("yi-6b", "mamba2-370m",
                                  "deepseek-v2-236b", "jamba-v0.1-52b"))
def test_card_one_rank_mesh_step_equals_unsharded(arch):
    """``build_session`` on ``make_host_mesh()`` (a one-rank NCCL group,
    every placement ``Replicate()``): two steps' losses and the
    gradients equal the unsharded step's, and each kernel launches as
    often a step (the kernels, not the plain versions, run under
    DTensor); DeepSeek's MoE layers take the expert-parallel path on
    the mesh and the grouped one off it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import RunConfig, get_config, smoke_config
    from repro_torch.configs.shapes import SMOKE_SHAPES
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.params import tree_leaves
    from repro_torch.runtime import train_step as TS
    from repro_torch.sharding.rules import axis_rules, distribute_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tc = _card_cfg(smoke_config(get_config(arch)))
    run = RunConfig(loss_chunk=32, remat="full")
    own = not dist.is_initialized()
    mesh = make_host_mesh()
    try:
        opt, sch, sh, step, rules = train_cli.build_session(tc, run, mesh, 4)
        state = TS.new_state(TS.init_state(
            sch, torch.Generator(device=dev).manual_seed(0), dev), opt)
        batch = SyntheticLMPipeline(tc, SMOKE_SHAPES["train_4k"],
                                    device=dev).batch_at(0)

        def counts():
            return {k: fn.launches for k, fn in train_cli.KERNELS.items()}

        plain = TS.build_train_step(tc, run, opt)
        c0, p0 = counts(), dict(moe.MOE_CALLS)
        u1, n1 = plain(state, batch)
        c1, p1 = counts(), dict(moe.MOE_CALLS)
        _, n2 = plain(u1, batch)
        want_g, _ = TS.compute_grads(tc, run, state["params"], batch)
        dstate = distribute_params(state, sh)
        dbatch = TS.distribute_batch(batch, rules)
        # the session's step donates dstate: its gradients first
        with axis_rules(rules), implicit_replication():
            got_g, _ = TS.compute_grads(tc, run, dstate["params"], dbatch,
                                        sh["params"])
        c2, p2 = counts(), dict(moe.MOE_CALLS)
        s1, m1 = step(dstate, dbatch)
        c3, p3 = counts(), dict(moe.MOE_CALLS)
        _, m2 = step(s1, dbatch)
        torch.cuda.synchronize()
        assert {k: c3[k] - c2[k] for k in c3} == \
            {k: c1[k] - c0[k] for k in c1}
        n_moe = p1["grouped"] - p0["grouped"]
        assert p1["ep"] == p0["ep"]
        assert (n_moe > 0) == (tc.moe is not None)
        path = "ep" if tc.moe is not None and tc.moe.ep_over_dp \
            else "grouped"
        assert p3[path] - p2[path] == n_moe
        for a, b in ((m1, n1), (m2, n2)):
            assert abs(float(a["loss"]) - float(b["loss"])) <= \
                1e-6 * abs(float(b["loss"]))
        for g, w in zip(tree_leaves(got_g), tree_leaves(want_g)):
            scale = float(w.abs().max())
            assert float((g.full_tensor() - w).abs().max()) <= 1e-3 * scale
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()
