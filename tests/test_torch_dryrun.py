"""The port's dry run and perf harness against the JAX package's.

``repro.launch.dryrun`` and ``repro.launch.perf`` set ``XLA_FLAGS`` to
512 host devices when imported, so no test process imports them: their
constants, the record's keys and the experiments are read from their
source with ``ast``.

* the cell constants (``TRAIN_MICROBATCH``, ``SEQ_SHARD``,
  ``BF16_GRADS``), ``run_config`` and the seq-shard rule equal the JAX
  package's; ``input_specs`` equals JAX's key, shape and dtype for every
  arch × shape, and ``tokens_like`` fills them as JAX's does;
* in a subprocess (the fake process group is global to a process):
  ``dryrun_cell`` of yi-6b × decode_32k and × prefill_32k on the
  single pod (256 fake ranks) writes a record with the JAX package's
  keys, less the ones that have no counterpart (``lower_s``,
  ``compile_s``, ``analyze_s``, ``xla_cost_analysis_raw``) and with
  ``trace_s``, ``input_read_bytes_per_dev``, ``chip`` and
  ``hlo_bytes_by_op`` (summing to ``hlo_bytes_per_dev``); its argument
  bytes are the shard shapes of the port's placements (held to JAX's
  in ``test_torch_sharding.py``); prefill's peak holds no (B, H, S, S)
  score tensor; long_500k skips dense archs and runs mamba2; the
  parameters and AdamW state of the yi-6b train cell on (16, 16) are
  the placements' shard shapes (rank 0's); ``dryrun_step`` on a
  one-rank world counts Yi-6B's prefill of 4 x 512 as its weights and
  tokens plus a rise that holds the cache and one MLP's activations,
  and its donated train step at one layer as the state and the batch
  plus a rise that holds the gradients but no second state;
* a registered kernel under the fake mode allocates only its output
  (``launch/live_bytes.py::LiveBytesMode``), where the CPU's plain
  version holds the scores;
* ``perf --list`` lists the JAX package's 15 experiments, each on its
  cell.
"""
import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ALL_ARCHS as JALL_ARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import perf  # noqa: E402
from repro_torch.launch.hw import H100_SXM  # noqa: E402
from repro_torch.optim import make_optimizer, warmup_cosine  # noqa: E402
from repro_torch.runtime import train_step as TS  # noqa: E402
from repro_torch.sharding.rules import AbstractMesh, make_rules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAX_DRYRUN = ROOT / "src" / "repro" / "launch" / "dryrun.py"
JAX_PERF = ROOT / "src" / "repro" / "launch" / "perf.py"
#: the JAX record's keys with no counterpart in an eager run
DROPPED = {"lower_s", "compile_s", "analyze_s", "xla_cost_analysis_raw"}
ADDED = {"trace_s", "input_read_bytes_per_dev", "chip", "hlo_bytes_by_op"}


def _module_literal(path: Path, name: str):
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def _jax_record_keys() -> set:
    """The keys ``repro.launch.dryrun.dryrun_cell`` writes for an ok
    cell: the first dict literal and the ``rec.update`` dict."""
    tree = ast.parse(JAX_DRYRUN.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_cell")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name) and node.target.id == "rec":
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "update":
            keys |= {k.value for k in node.args[0].keys}
    return keys


# ---------------------------------------------------------------------------
# constants, specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["TRAIN_MICROBATCH", "SEQ_SHARD",
                                  "BF16_GRADS"])
def test_cell_constants_equal_jax(name):
    assert getattr(dr, name) == _module_literal(JAX_DRYRUN, name)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_run_config_and_seq_shard_rule(arch):
    cfg = get_config(arch)
    assert ALL_ARCHS == JALL_ARCHS
    mesh = AbstractMesh((16, 16), ("data", "model"))
    for shape in shapes.SHAPES.values():
        run = dr.run_config(cfg, shape)
        train = shape.kind == "train"
        assert run.microbatch == (dr.TRAIN_MICROBATCH.get(arch, 64)
                                  if train else None)
        assert run.seq_shard == (arch in dr.SEQ_SHARD and train)
        assert run.grad_dtype == ("bfloat16" if arch in dr.BF16_GRADS
                                  else "float32")
        rules = dr.cell_rules(cfg, shape, run, mesh)
        want = (("model",),) if run.seq_shard else ()
        assert rules.rules["seq_res"] == want
        if not cfg.flat_dp:
            assert rules.spec(("batch", "seq_res", "d_model"),
                              (256, 4096, cfg.d_model)) == (
                ("data", "model") if run.seq_shard else ("data",))


_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32,
           jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in shapes.SHAPES.items():
        got = shapes.input_specs(cfg, shape)
        want = jshapes.input_specs(jcfg, jshapes.SHAPES[name])
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == tuple(want[k].shape)
            assert got[k].dtype == _DTYPES[want[k].dtype.type]


def test_tokens_like_fills_the_specs():
    cfg = get_config("qwen2-vl-72b")
    for name, shape in shapes.SMOKE_SHAPES.items():
        specs = shapes.input_specs(cfg, shape)
        got = shapes.tokens_like(specs, torch.Generator().manual_seed(3))
        again = shapes.tokens_like(specs, torch.Generator().manual_seed(3))
        for k, s in specs.items():
            assert tuple(got[k].shape) == s.shape and got[k].dtype == s.dtype
            assert torch.equal(got[k], again[k])
            if k == "loss_mask":
                assert bool((got[k] == 1).all())
            elif k == "pos":
                assert int(got[k]) == 3
            elif not s.dtype.is_floating_point:
                assert 0 <= int(got[k].min()) and int(got[k].max()) < 17


# ---------------------------------------------------------------------------
# the dry run on a fake 256-rank group (a subprocess)
# ---------------------------------------------------------------------------

_CELLS = r"""
import json, sys
from pathlib import Path
import torch
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.models.params import tree_leaves
from repro_torch.runtime import train_step as ts

out_dir = Path(sys.argv[1])
recs = {}
for arch, shape in (("yi-6b", "decode_32k"), ("yi-6b", "prefill_32k"),
                    ("yi-6b", "long_500k"), ("mamba2-370m", "long_500k")):
    recs[f"{arch}/{shape}"] = dr.dryrun_cell(arch, shape, False, out_dir,
                                             verbose=False)
# the train cell's state, placed (its step needs a build with CUDA)
cfg = get_config("yi-6b")
shape = SHAPES["train_4k"]
run = dr.run_config(cfg, shape)
with dr.fake_world(256):
    mesh = make_production_mesh()
    rules = dr.cell_rules(cfg, shape, run, mesh)
    opt = make_optimizer(cfg.optimizer, dr.warmup_cosine())
    sch = ts.state_schema(cfg, run, opt)
    with dr.fake_cuda():
        state = dr.placed_fakes(sch, ts.state_shardings(sch, rules, run))
        recs["train_state"] = [
            [list(t.shape), list(t.to_local().shape), str(t.dtype)]
            for t in tree_leaves(state)]
# one step on a one-rank world: Yi-6B's prefill of 4 x 512 (fake CUDA),
# and its donated train step at one layer, 1 x 512 (fake CPU)
from repro_torch.configs import RunConfig
from repro_torch.configs.shapes import ShapeConfig
recs["step_prefill"] = dr.dryrun_step(
    cfg, ShapeConfig("p", "prefill", 512, 4))["memory"]
recs["step_train"] = dr.dryrun_step(
    dr.cut_depth(cfg), ShapeConfig("t", "train", 512, 1),
    RunConfig(loss_chunk=512, remat="full"), device="cpu")["memory"]
print(json.dumps(recs))
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    res = subprocess.run([sys.executable, "-c", _CELLS, str(out)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin", "HOME": str(out)})
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), out


def test_record_keys_are_jax_s(cells):
    recs, out = cells
    rec = recs["yi-6b/decode_32k"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == (_jax_record_keys() - DROPPED) | ADDED
    assert rec["chips"] == 256 and rec["chip"] == H100_SXM.name
    assert rec["while_trips"] == []
    assert sum(rec["hlo_bytes_by_op"].values()) == pytest.approx(
        rec["hlo_bytes_per_dev"])
    for k in ("compute", "memory", "collective", "dominant",
              "step_time_lower_bound_s", "roofline_fraction"):
        assert k in rec["roofline"]
    assert json.loads((out / "single" / "yi-6b" / "decode_32k.json")
                      .read_text()) == rec
    rows = dr.summarize(out).splitlines()
    assert any("| yi-6b | decode_32k | single | ok |" in r for r in rows)


def _shard_bytes(spec, shape, sizes, itemsize) -> int:
    """Bytes of rank 0's shard of ``shape`` under ``spec`` (ceil-split,
    as ``torch.chunk``)."""
    n = 1
    for i, d in enumerate(shape):
        part = spec[i] if i < len(spec) else None
        axes = () if part is None else (part,) if isinstance(part, str) \
            else tuple(part)
        m = math.prod(sizes[a] for a in axes)
        n *= -(-d // m)
    return n * itemsize


def test_decode_cell_arguments_are_the_placements_shards(cells):
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding.rules import param_pspecs

    recs, _ = cells
    rec = recs["yi-6b/decode_32k"]
    cfg = get_config("yi-6b")
    mesh = AbstractMesh((16, 16), ("data", "model"))
    rules = make_rules(mesh, "serve")
    sizes = {"data": 16, "model": 16}
    want = 0
    psch = dr.cast_schema(M.schema(cfg), torch.bfloat16)
    csch = M.cache_schema(cfg, 128, 32768)
    for sch in (psch, csch):
        specs = param_pspecs(sch, rules)
        for s, spec in zip(tree_leaves(sch), tree_leaves(specs)):
            want += _shard_bytes(spec, s.shape, sizes,
                                 torch.empty((), dtype=s.dtype).element_size())
    want += 128 // 16 * 4                    # the int32 tokens, over "data"
    assert rec["memory"]["argument_size_in_bytes"] == want
    # the step reads all of it, every weight and the whole cache, but the
    # token table: each rank looks its 8 tokens up in its vocab shard
    # (models/layers.py::embed_tokens), 8 rows read
    table = cfg.vocab_size // 16 * cfg.d_model * 2
    assert rec["input_read_bytes_per_dev"] == want - table \
        + 128 // 16 * cfg.d_model * 2
    assert rec["memory"]["peak_bytes_per_device"] >= want
    assert rec["hbm_budget_ok"]


def test_prefill_peak_holds_no_score_tensor(cells):
    recs, _ = cells
    rec = recs["yi-6b/prefill_32k"]
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = get_config("yi-6b")
    # rank 0's batch (32 / 16) and heads (32 / 16): one f32 score tensor
    scores = 2 * 2 * 32768 * 32768 * 4
    peak = rec["memory"]["peak_bytes_per_device"]
    assert peak < scores
    assert rec["memory"]["argument_size_in_bytes"] < peak < H100_SXM.hbm_bytes
    assert cfg.num_heads == 32


def test_long_context_skips_dense_archs(cells):
    recs, _ = cells
    dense = recs["yi-6b/long_500k"]
    assert dense["status"] == "skipped"
    assert "sub-quadratic" in dense["reason"]
    ssm = recs["mamba2-370m/long_500k"]
    assert ssm["status"] == "ok", ssm.get("traceback")
    assert ssm["hlo_flops_per_dev"] > 0


def _schema_bytes(sch) -> int:
    from repro_torch.models.params import tree_leaves

    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype)
               .element_size() for s in tree_leaves(sch))


def test_dryrun_step_prefill_counts_the_rise(cells):
    from repro_torch.models import model as M

    recs, _ = cells
    mem = recs["step_prefill"]
    cfg = get_config("yi-6b")
    # one rank holds every weight (bf16 serving schema) and the tokens;
    # CUDA storages in 512-byte blocks count the same for these sizes
    args = _schema_bytes(M.schema(cfg)) + 4 * 512 * 4
    assert mem["argument_size_in_bytes"] == args
    assert mem["rise_bytes"] == mem["peak_bytes_per_device"] - args
    # the peak falls in a layer's MLP: the cache the prefill fills (k
    # and v of every layer), the three (B, P, d_ff) bf16 activations and
    # a few (B, P, d) ones
    cache = _schema_bytes(M.cache_schema(cfg, 4, 512))
    mlp = 3 * 4 * 512 * cfg.d_ff * 2
    row = 4 * 512 * cfg.d_model * 2
    assert cache + mlp < mem["rise_bytes"] < cache + mlp + 16 * row


def test_dryrun_step_train_counts_the_donated_state_once(cells):
    from repro_torch.configs import RunConfig

    recs, _ = cells
    mem = recs["step_train"]
    cfg = dr.cut_depth(get_config("yi-6b"))
    run = RunConfig(loss_chunk=512, remat="full")
    opt = make_optimizer(cfg.optimizer, warmup_cosine())
    state = _schema_bytes(TS.state_schema(cfg, run, opt))
    batch = 512 * (4 + 4)                    # int32 tokens, f32 mask
    assert mem["argument_size_in_bytes"] == state + batch
    # the f32 gradients are live until the update takes them; the new
    # state is written into the old one and adds nothing
    grads = _schema_bytes(TS.state_schema(cfg, run, opt)["params"]) \
        // torch.empty((), dtype=torch.float32).element_size() * 4
    assert grads <= mem["rise_bytes"] < grads + state
    assert mem["rise_bytes"] == mem["peak_bytes_per_device"] \
        - mem["argument_size_in_bytes"]


def test_train_state_shards_are_the_placements(cells):
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding.rules import param_pspecs, zero1_pspecs

    recs, _ = cells
    got = recs["train_state"]
    cfg = get_config("yi-6b")
    shape = shapes.SHAPES["train_4k"]
    run = dr.run_config(cfg, shape)
    rules = dr.cell_rules(cfg, shape, run,
                          AbstractMesh((16, 16), ("data", "model")))
    opt = make_optimizer(cfg.optimizer, warmup_cosine())
    sch = TS.state_schema(cfg, run, opt)
    specs = {"params": param_pspecs(sch["params"], rules),
             "opt": zero1_pspecs(sch["opt"], rules), "step": ()}
    leaves = tree_leaves(sch)
    spec_leaves = tree_leaves({**specs, "step": None})
    assert len(got) == len(leaves) == len(spec_leaves)
    sizes = {"data": 16, "model": 16}
    n_opt = 0
    for (gshape, lshape, _), s, spec in zip(got, leaves, spec_leaves):
        assert tuple(gshape) == s.shape
        spec = spec or ()
        want = [-(-d // math.prod(
            sizes[a] for a in ((() if i >= len(spec) or spec[i] is None
                                else (spec[i],) if isinstance(spec[i], str)
                                else spec[i]))))
            for i, d in enumerate(s.shape)]
        assert lshape == want, (s.shape, spec)
        n_opt += 1
    assert n_opt > 10


# ---------------------------------------------------------------------------
# a registered kernel under the fake mode
# ---------------------------------------------------------------------------


def _peak_of(device):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.launch.live_bytes import LiveBytesMode

    with FakeTensorMode():
        q = torch.empty((1, 32, 4096, 128), dtype=torch.bfloat16,
                        device=device)
        k = torch.empty((1, 4, 4096, 128), dtype=torch.bfloat16,
                        device=device)
        live = LiveBytesMode()
        live.track(q, k)
        with live:
            out = fo.attention(q, k, k, causal=True)
    return live.peak, out


def test_registered_kernel_allocates_only_its_output():
    inputs = (32 + 4) * 4096 * 128 * 2
    output = 32 * 4096 * 128 * 2
    peak, out = _peak_of("cuda")
    assert out.device.type == "cuda" and tuple(out.shape) == (1, 32, 4096,
                                                              128)
    assert peak == inputs + output
    # the CPU's plain version holds the (B, H, S, S) f32 scores
    cpu_peak, _ = _peak_of("cpu")
    assert cpu_peak >= inputs + 32 * 4096 * 4096 * 4


# ---------------------------------------------------------------------------
# perf
# ---------------------------------------------------------------------------


def _jax_experiments() -> dict:
    """name -> (arch, shape, mesh) of ``repro.launch.perf.EXPERIMENTS``."""
    tree = ast.parse(JAX_PERF.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", "") == "EXPERIMENTS":
            return {k.value: tuple(a.value for a in v.args[1:4])
                    for k, v in zip(node.value.keys, node.value.values)}
    raise KeyError("EXPERIMENTS")


def test_experiments_are_jax_s():
    want = _jax_experiments()
    assert len(want) == 15
    got = {k: (e.arch, e.shape, e.mesh) for k, e in perf.EXPERIMENTS.items()}
    assert got == want
    for e in perf.EXPERIMENTS.values():
        # the TPU predictions' figures are not carried over
        for fig in ("35.5s", "16 GiB", "12.7 GiB", "24.9s", "1.92"):
            assert fig not in e.hypothesis


def test_perf_list_names_the_experiments():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.perf", "--list"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-2000:]
    names = [ln.split(":")[0] for ln in res.stdout.splitlines()]
    assert names == list(_jax_experiments())


def test_variants_transform_their_cells():
    exp = perf.EXPERIMENTS
    cfg = get_config("deepseek-v3-671b")
    assert exp["dsv3-ep"].cfg_fn(cfg).moe.ep_over_dp
    assert not exp["dsv3-baseline-fsdp"].cfg_fn(cfg).moe.ep_over_dp
    assert exp["dsv3-ep-scatter"].cfg_fn(cfg).moe.dispatch == "scatter"
    run = dr.run_config(get_config("granite-8b"), shapes.SHAPES["train_4k"])
    pp = exp["granite-multi-pp"].run_fn(run)
    assert (pp.pipeline_stages, pp.pp_microbatches, pp.microbatch) == (
        2, 8, None)
    assert exp["granite-multi-int8"].run_fn(run).gradient_compression == \
        "int8"
    assert exp["whisper-flatdp"].cfg_fn(
        get_config("whisper-large-v3")).flat_dp


def test_train_cells_need_a_cuda_build(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this build has CUDA")
    with pytest.raises(RuntimeError, match="build with CUDA"):
        dr.check_trainable()
    rec = dr.dryrun_cell("yi-6b", "train_4k", False, tmp_path,
                         verbose=False)
    assert rec["status"] == "error" and "build with CUDA" in rec["error"]
