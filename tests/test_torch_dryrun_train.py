"""The dry run's train cells at the production meshes, on the CPU.

Each cell runs as ``launch/dryrun.py::dryrun_cell`` runs it, on a fake
process group of 256 ranks ((16, 16)) or 512 ((2, 16, 16)), with the
mesh and its fake tensors on ``cpu`` (a train cell on fake CUDA tensors
needs a build with CUDA).  The cells keep one layer of each kind of
their arch (``dryrun.cut_depth``) at full width, and the single-pod
cells accumulate two microbatches in place of their arch's count (the
views and placements of a microbatch are the same; the time is not).
Every site family has a cell: the attention projections with kv heads
that the rules replicate (yi-6b, 4 kv heads; granite-8b, 8), the
sequence-sharded residual stream and its norm (qwen2-vl-72b, Jamba,
DeepSeek-V2), mamba2's chunk views (mamba2-370m, Jamba), the MoE's
token flatten in both paths (Jamba grouped, DeepSeek-V2 expert
parallel), MLA, and whisper's encoder-decoder (1 + 1 layers).  The
(2, 16, 16) cell is DeepSeek-V2's MoE layer at its own microbatch of 16
rows, fewer than the 32 ("pod", "data") ranks its tokens are cut over.

Each cell must run, and no DTensor that its step forms, forward or
backward, may carry a ``_StridedShard``: torch 2.13 forms one where a
view merges a sharded dim with another or splits one unevenly, which
torch 2.11 (the card's build) refuses outright.  The check reads every
sharding propagation of the run (``ShardingPropagator``'s uncached
call, its cache renewed for each cell).

The cells run in four subprocesses at once (a fake process group is
global to its process), beside a fifth that runs ``launch/perf.py``'s
``granite-multi-pp`` (GPipe over "pod" at 512 ranks) at 2 layers: its
hops' local shapes are computed in Python, as a fake mode needs.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.hw import H100_SXM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: (arch, two pods, microbatch: None keeps the arch's), in the
#: subprocess that runs them; on two pods DeepSeek-V2 keeps its MoE layer
#: alone
GROUPS = (
    (("jamba-v0.1-52b", False, 128), ("whisper-large-v3", False, None)),
    (("deepseek-v2-236b", True, None),),
    (("deepseek-v2-236b", False, 128), ("yi-6b", False, 128),
     ("granite-8b", False, 128)),
    (("qwen2-vl-72b", False, 128), ("mamba2-370m", False, 128)),
)
CELLS = [c for g in GROUPS for c in g]


def _name(cell) -> str:
    arch, multi, _ = cell
    return f"{arch}-{'multi' if multi else 'single'}"


_SCRIPT = r"""
import dataclasses, json, sys, traceback
from pathlib import Path
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import _StridedShard
from torch.distributed.tensor._sharding_prop import LocalLRUCache
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun as dr

SEEN = []


def strided(spec):
    if isinstance(spec, (list, tuple)):
        return any(strided(s) for s in spec)
    return any(isinstance(p, _StridedShard)
               for p in getattr(spec, "placements", None) or ())


def where():
    for f in reversed(traceback.extract_stack()):
        if "repro_torch" in f.filename and "/launch/" not in f.filename:
            return f"{f.filename.split('src/')[-1]}:{f.lineno}"
    return "?"


prop = DTensor._op_dispatcher.sharding_propagator
uncached = prop.propagate_op_sharding_non_cached


def recorded(schema):
    out = uncached(schema)
    if strided(out.output_spec) or strided(list(schema.args_spec)):
        SEEN.append(f"{schema.op} at {where()}")
    return out


prop.propagate_op_sharding_non_cached = recorded
out = {}
for arch, multi, mb in json.loads(sys.argv[2]):
    cfg = get_config(arch)
    cut = dr.cut_depth(cfg)
    if multi and cut.moe is not None:
        cut = dataclasses.replace(cut, num_layers=1, blocks=cut.blocks[-1:])
    run = dr.run_config(cut, SHAPES["train_4k"])
    cut_run = run if mb is None else dataclasses.replace(run, microbatch=mb)
    prop.propagate_op_sharding = LocalLRUCache(recorded)
    SEEN.clear()
    rec = dr.dryrun_cell(arch, "train_4k", multi, Path(sys.argv[1]),
                         verbose=False, cfg=cut, run=cut_run, device="cpu",
                         reduced=dr.reduced_note(cfg, cut, run, cut_run))
    out[f"{arch}-{'multi' if multi else 'single'}"] = {
        "rec": {k: v for k, v in rec.items() if k != "traceback"},
        "traceback": rec.get("traceback", ""), "strided": sorted(set(SEEN))}
print(json.dumps(out))
"""


_PIPELINE = r"""
import dataclasses, json
from repro_torch.configs.base import BlockDef
from repro_torch.launch import dryrun as dr
from repro_torch.launch import perf
from repro_torch.launch.mesh import make_production_mesh


def two_layers(cfg):
    return dataclasses.replace(cfg, num_layers=2,
                               blocks=(BlockDef(cfg.blocks[0].pattern, 2),))


exp = dataclasses.replace(perf.EXPERIMENTS["granite-multi-pp"],
                          cfg_fn=two_layers)
with dr.fake_world(512):
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    with dr.fake_cuda():
        cfg, shape, mesh, fn, args, warm = perf.build_variant(exp, mesh)
        hc, mem, _ = dr.run_cell(fn, args, mesh, warm)
print(json.dumps({"granite-multi-pp": {
    "flops": hc["flops"], "dci": hc["collective_dci_bytes"], "memory": mem}}))
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_train")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(out), "OMP_NUM_THREADS": "1"}
    scripts = [[_SCRIPT, str(out / str(i)), json.dumps(g)]
               for i, g in enumerate(GROUPS)] + [[_PIPELINE]]
    procs = [subprocess.Popen([sys.executable, "-c", *a], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for a in scripts]
    res = {}
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        res.update(json.loads(stdout.strip().splitlines()[-1]))
    return res


def _train(cells):
    return {k: v for k, v in cells.items() if k != "granite-multi-pp"}


@pytest.mark.parametrize("cell", CELLS, ids=_name)
def test_train_cell_runs_with_no_strided_shard(cells, cell):
    got = cells[_name(cell)]
    rec = got["rec"]
    assert rec["status"] == "ok", got["traceback"]
    assert got["strided"] == [], got["strided"]
    assert rec["kind"] == "train" and rec["chips"] == (512 if cell[1]
                                                       else 256)
    mem = rec["memory"]
    assert 0 < mem["argument_size_in_bytes"] < mem["peak_bytes_per_device"]
    assert rec["hlo_flops_per_dev"] > 0 and rec["collectives"]["count"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")


def test_train_records_say_what_was_cut(cells):
    rec = cells["jamba-v0.1-52b-single"]["rec"]
    assert rec["reduced"] == "32 -> 3 layers, microbatch 16 -> 128"
    rec = cells["whisper-large-v3-single"]["rec"]
    assert rec["reduced"] == "32 -> 1 layers, encoder 32 -> 1"
    rec = cells["deepseek-v2-236b-multi"]["rec"]
    assert rec["reduced"] == "60 -> 1 layers" and rec["mesh"] == "multi"
    # the budget is a result, not an error
    for got in _train(cells).values():
        assert got["rec"]["hbm_budget_ok"] == (
            got["rec"]["memory"]["peak_bytes_per_device"]
            <= H100_SXM.hbm_bytes)


def test_pipeline_experiment_runs_at_two_pods(cells):
    """GPipe over "pod": its stage hops cross the pod link (DCI)."""
    got = cells["granite-multi-pp"]
    assert got["flops"] > 0 and got["dci"] > 0
    mem = got["memory"]
    assert 0 < mem["argument_size_in_bytes"] < mem["peak_bytes_per_device"]


def test_cut_depth_keeps_one_layer_of_each_kind():
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        cut = dr.cut_depth(cfg)
        kinds = {k for b in cfg.blocks for k in b.pattern}
        assert {k for b in cut.blocks for k in b.pattern} == kinds
        assert cut.num_layers == sum(len(set(b.pattern)) for b in cfg.blocks)
        assert (cut.d_model, cut.num_heads, cut.vocab_size) == (
            cfg.d_model, cfg.num_heads, cfg.vocab_size)
        assert cut.encoder_layers == min(cfg.encoder_layers, 1)
    jamba = dr.cut_depth(get_config("jamba-v0.1-52b"))
    assert jamba.blocks[0].pattern == (("mamba", "dense"), ("mamba", "moe"),
                                       ("attn", "dense"))
