"""Multi-pod dry run: every (arch × shape × mesh) cell run once on fake
tensors over a fake process group, one rank's view (the JAX package's
``launch/dryrun.py``).

The JAX package lowers and compiles each cell on 512 placeholder host
devices and reads XLA's memory analysis and the compiled HLO.  Eager
PyTorch has neither, so a cell here *runs*, on tensors that hold no
data:

* a fake process group (``torch.testing``'s ``FakeStore``, backend
  ``"fake"``) of 256 ranks, or 512 for the two-pod mesh, whose
  collectives return at once; the production mesh of
  ``launch/mesh.py`` on ``cuda`` over it;
* ``FakeTensorMode``: the parameters (bf16 for serving, as deployed),
  the optimizer state, the cache and the inputs are DTensors at their
  placements over fake CUDA tensors of rank 0's shard shapes
  (``placed_fakes``).  The LM kernels' dispatch takes its CUDA branch
  and reaches each registered op's fake implementation, which allocates
  only the outputs: no nvcc, no launch, and no (B, H, S, S) score tensor
  that the flash kernel never holds;
* ``launch/op_cost.py::OpCostMode`` tallies the rank's FLOPs, bytes and
  collectives, and ``launch/live_bytes.py::LiveBytesMode`` the peak of
  its live bytes: the state, the inputs and every storage the step's
  local ops make, each counted once and until it is freed, a CUDA one
  in the caching allocator's 512-byte blocks (the train step donates
  its state, as the JAX package's does, so the new state is written
  into the old one and adds nothing).  The peak is a property of the
  step, not of the torch that traced it: ``chip_smoke.py``'s
  ``launch_cost`` phase holds the rise of the count over the arguments
  against the card's allocator (``max_memory_allocated`` less
  ``memory_allocated`` before the step) on three steps the smoke runs,
  each traced here by ``dryrun_step`` on a one-rank fake world.

Per cell a JSON record with the JAX package's keys: ``memory``
(``peak_bytes_per_device`` against ``H100_SXM.hbm_bytes``, and
``argument_size_in_bytes``), the ``hlo_flops_per_dev`` and
``hlo_bytes_per_dev`` of ``OpCostMode`` (the names kept so the two
records read side by side; ``hlo_bytes_by_op`` splits the bytes by
op), ``collectives``,
``roofline`` (``launch/roofline.py`` with ``H100_SXM``), the model
FLOPs and the useful-compute ratio.  ``xla_cost_analysis_raw``,
``lower_s`` and ``compile_s`` have no counterpart; ``trace_s`` is the
run's host seconds.

A few tensor methods (indexing ``x[i]``, ``x[i] = y``, ``contiguous``,
``copy_``) pass a CUDA device guard, which a build without CUDA lacks,
before any dispatch; ``cuda_methods_without_card`` runs them as the
select, slice, unsqueeze, index, clone and copy ops they stand for while
a cell runs.

A train cell runs autograd on fake CUDA tensors: a build without CUDA
aborts there for want of a device guard, so ``check_trainable`` refuses
it.  The same cell runs on fake CPU tensors over a mesh on ``cpu``
(``dryrun_cell(..., device="cpu")``), as the CPU tests run it.  The
model places every tensor it views (``sharding/rules.py::contract``,
the kernels' ``local_map`` regions, the MoE's token flatten), so that
no view of a DTensor splits or merges a sharded dim: torch 2.11 (the
card's build) refuses such views, and 2.13 forms strided shards for
them.  ``cut_depth`` keeps one layer of each kind of an arch, for cells
checked at cut depth; their records say so under ``reduced``.

Usage (serving cells on any machine, train cells on the card's):

    python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k --mesh single
    python -m repro_torch.launch.dryrun --all --jobs 7
    python -m repro_torch.launch.dryrun --summarize
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import ALL_ARCHS, RunConfig, get_config
from repro_torch.configs.base import BlockDef
from repro_torch.configs.shapes import SHAPES, cell_is_runnable, input_specs
from repro_torch.launch.hw import H100_SXM
from repro_torch.launch.live_bytes import LiveBytesMode
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.op_cost import OpCostMode
from repro_torch.launch.roofline import model_flops, roofline_terms
from repro_torch.launch.train import build_session
from repro_torch.models import model as M
from repro_torch.models.params import map_specs, tree_leaves, tree_zip
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.runtime import serve_step
from repro_torch.runtime import train_step as ts
from repro_torch.sharding.rules import (
    AxisRules,
    local_shape_and_offset,
    make_rules,
    param_shardings,
)

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / \
    "torch_dryrun"

# Per-arch train microbatch (global): bounds live activations per µ-step.
TRAIN_MICROBATCH = {
    "granite-8b": 64, "yi-6b": 64, "yi-9b": 32, "minitron-8b": 64,
    "qwen2-vl-72b": 16, "deepseek-v2-236b": 16, "deepseek-v3-671b": 32,
    "whisper-large-v3": None, "mamba2-370m": 64, "jamba-v0.1-52b": 16,
}

# Megatron-SP residuals for the big models (remat stash /16; §Perf A)
SEQ_SHARD = {"deepseek-v2-236b", "deepseek-v3-671b", "qwen2-vl-72b",
             "jamba-v0.1-52b", "whisper-large-v3"}


# ≥200B models accumulate grads in bf16 (param-sized fp32 accumulators
# would not fit pod HBM; Adafactor/8-bit moments tolerate bf16 grads).
BF16_GRADS = {"deepseek-v2-236b", "deepseek-v3-671b"}


def run_config(cfg, shape) -> RunConfig:
    return RunConfig(
        microbatch=TRAIN_MICROBATCH.get(cfg.name, 64)
        if shape.kind == "train" else None,
        grad_dtype="bfloat16" if cfg.name in BF16_GRADS else "float32",
        seq_shard=cfg.name in SEQ_SHARD and shape.kind == "train",
        loss_chunk=512,
    )


def cell_rules(cfg, shape, run: RunConfig, mesh) -> AxisRules:
    """The cell's rules: train or serve, ``flat_dp`` as the config says,
    and under ``run.seq_shard`` the residual stream's sequence over
    "model" (``"seq_res": (("model",),)``, Megatron-SP)."""
    rules = make_rules(mesh, "train" if shape.kind == "train" else "serve",
                       flat_dp=cfg.flat_dp)
    if run.seq_shard:
        rules = dataclasses.replace(
            rules, rules={**rules.rules, "seq_res": (("model",),)})
    return rules


# ---------------------------------------------------------------------------
# Fake tensors at their placements
# ---------------------------------------------------------------------------


def cast_schema(schema, dtype: torch.dtype):
    """Every leaf in ``dtype`` (the JAX package's ``cast_schema``), but
    the pinned ones (the MoE router, f32 in every schema of the port)."""
    return map_specs(lambda _, s: s if s.pinned else dataclasses.replace(
        s, dtype=dtype), schema)


def placed_fake(shape, dtype, sharding) -> DTensor:
    """A DTensor of global ``shape`` at ``sharding``'s placements over an
    empty tensor of this rank's shard shape on the mesh's device type (a
    fake tensor under ``FakeTensorMode``)."""
    shape = tuple(shape)
    local, _ = local_shape_and_offset(shape, sharding.mesh,
                                      sharding.placements)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device=sharding.mesh.device_type),
        sharding.mesh,
        sharding.placements, run_check=False, shape=shape, stride=stride)


def placed_fakes(schema, shardings):
    """``placed_fake`` of every leaf of a schema (``ParamSpec``s) or a
    spec dict (``TensorSpec``s), at the matching ``Sharding``: the
    port's ``abstract_params`` with its placements."""
    return tree_zip(lambda s, sh: placed_fake(s.shape, s.dtype, sh),
                    schema, shardings)


def _index_parts(x: torch.Tensor, index):
    """x's basic indexing as ops (ints select, slices slice, None
    unsqueezes, Ellipsis expands), and the tensor indices left for one
    ``aten.index`` on the view, one entry a view dim."""
    idx = index if isinstance(index, tuple) else (index,)
    used = sum(1 for i in idx if i is not None and i is not Ellipsis)
    out, dim, adv = x, 0, []
    for i in idx:
        if i is Ellipsis:
            n = x.ndim - used
            adv += [None] * n
            dim += n
        elif i is None:
            out = out.unsqueeze(dim)
            adv.append(None)
            dim += 1
        elif isinstance(i, slice):
            out = torch.ops.aten.slice.Tensor(out, dim, i.start, i.stop,
                                              1 if i.step is None else i.step)
            adv.append(None)
            dim += 1
        elif isinstance(i, (torch.Tensor, list)):
            t = torch.as_tensor(i, device=x.device)
            if t.dtype == torch.bool:
                raise NotImplementedError("boolean indices")
            adv.append(t)
            dim += 1
        else:
            out = out.select(dim, int(i))
    while adv and adv[-1] is None:
        adv.pop()
    return out, adv


def _getitem(x, index):
    view, adv = _index_parts(x, index)
    return torch.ops.aten.index.Tensor(view, adv) if adv else view


def _setitem(x, index, value):
    view, adv = _index_parts(x, index)
    if adv:
        raise NotImplementedError("assignment through tensor indices")
    if isinstance(value, torch.Tensor):
        view.copy_(value)
    else:
        view.fill_(value)


def _contiguous(x, memory_format=torch.contiguous_format):
    if x.is_contiguous(memory_format=memory_format):
        return x
    return torch.ops.aten.clone.default(x, memory_format=memory_format)


def _copy_(x, src, non_blocking=False):
    return torch.ops.aten.copy_.default(x, src, non_blocking)


#: the guarded methods and the op forms they take on CUDA tensors
_GUARDED = {"__getitem__": _getitem, "__setitem__": _setitem,
            "contiguous": _contiguous, "copy_": _copy_}


@contextlib.contextmanager
def cuda_methods_without_card():
    """The ``_GUARDED`` methods (indexing, ``contiguous``, ``copy_``) on
    CUDA tensors as the ops they stand for while entered, where the
    build has no CUDA: their Python bindings pass a CUDA device guard,
    which such a build lacks, before any dispatch.  Every other tensor
    takes the methods as they are.  Nothing is patched on a build with
    CUDA."""
    if torch.cuda.is_available():
        yield
        return
    cls = torch.Tensor
    saved = {n: cls.__dict__.get(n) for n in _GUARDED}
    orig = {n: getattr(cls, n) for n in saved}

    def route(name, fn):
        def method(self, *args, **kwargs):
            if self.device.type == "cuda":
                return fn(self, *args, **kwargs)
            return orig[name](self, *args, **kwargs)
        return method

    for n, fn in _GUARDED.items():
        setattr(cls, n, route(n, fn))
    try:
        yield
    finally:
        for n, v in saved.items():
            if v is None:
                delattr(cls, n)
            else:
                setattr(cls, n, v)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process rank
    0) for the duration.  Raises where a group is running already (it
    is global to the process: a test runs the dry run in a
    subprocess)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            f"a {dist.get_backend()} group of {dist.get_world_size()} ranks "
            f"is running; the dry run starts a fake one of {world_size}")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_cuda():
    """Fake tensors (``FakeTensorMode``) with CUDA indexing that needs no
    card (``cuda_methods_without_card``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True) as mode, \
            cuda_methods_without_card():
        yield mode


def check_trainable(device="cuda") -> None:
    """Raise where a train cell cannot run: on a build without CUDA the
    autograd engine needs a CUDA device guard for a fake CUDA tensor's
    gradient and aborts the process without one.  Fake CPU tensors
    train anywhere."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a train cell runs autograd on fake CUDA tensors, which needs "
            "a build with CUDA (the card's machine); serving cells run "
            "anywhere")


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def cut_depth(cfg):
    """``cfg`` at full width with one layer of each kind: each block's
    pattern cut to its distinct (mixer, mlp) kinds, repeated once, and
    an encoder of as many layers (Jamba's period of 8 becomes (mamba,
    dense), (mamba, moe), (attn, dense); DeepSeek keeps its dense layer
    and one MoE layer)."""
    blocks = tuple(BlockDef(pattern=tuple(dict.fromkeys(b.pattern)),
                            repeat=1) for b in cfg.blocks)
    n = sum(b.layers for b in blocks)
    return dataclasses.replace(
        cfg, num_layers=n, blocks=blocks,
        encoder_layers=min(cfg.encoder_layers, n))


def reduced_note(cfg, cut, run=None, cut_run=None) -> str:
    """What a cut keeps of a cell: its layers and, where the microbatch
    changed, the accumulation steps."""
    note = f"{cfg.num_layers} -> {cut.num_layers} layers"
    if cfg.encoder_layers:
        note += (f", encoder {cfg.encoder_layers} -> "
                 f"{cut.encoder_layers}")
    if run is not None and cut_run is not None \
            and cut_run.microbatch != run.microbatch:
        note += f", microbatch {run.microbatch} -> {cut_run.microbatch}"
    return note


def build_cell(arch: str, shape_name: str, mesh, cfg=None, run=None):
    """``(fn, args)`` of one cell: the step and its placed fake inputs.
    Call it under ``fake_cuda()`` in a fake world."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name]
    run = run_config(cfg, shape) if run is None else run
    rules = cell_rules(cfg, shape, run, mesh)
    in_specs = input_specs(cfg, shape)

    if shape.kind == "train":
        opt = make_optimizer(cfg.optimizer, warmup_cosine())
        sch = ts.state_schema(cfg, run, opt)
        state = placed_fakes(sch, ts.state_shardings(sch, rules, run))
        batch = placed_fakes(in_specs, ts.batch_shardings(in_specs, rules))
        # the state donated, as the JAX package jits the step
        if run.gradient_compression != "none" \
                and "pod" in mesh.mesh_dim_names:
            fn = ts.build_compressed_train_step(cfg, run, opt, rules,
                                                donate=True)
        else:
            fn = ts.build_train_step(cfg, run, opt, rules, donate=True)
        return fn, (state, batch)

    # serving weights are bf16 (inference-cast), matching real deployments
    psch = cast_schema(M.schema(cfg), torch.bfloat16)
    params = placed_fakes(psch, param_shardings(psch, rules))
    inputs = {k: v for k, v in in_specs.items() if k != "pos"}
    inputs = placed_fakes(inputs, serve_step.serve_input_shardings(
        inputs, rules))

    if shape.kind == "prefill":
        return serve_step.build_prefill(cfg, rules), (params, inputs)

    # decode: the last position, so the step attends over the whole cache
    cache_sch = M.cache_schema(cfg, shape.global_batch, shape.seq_len)
    cache = placed_fakes(cache_sch, param_shardings(cache_sch, rules))
    inputs["pos"] = shape.seq_len - 1
    return serve_step.build_decode(cfg, rules), (params, cache, inputs)


def warm_args(cfg, shape_name: str, run, mesh, args):
    """The arguments that warm a cell up (``run_cell``): a train cell's
    state with a batch of two microbatches, where the cell accumulates
    more (every op and placement of the step, its microbatch loop too,
    at the cell's shapes: DTensor's propagation cache then holds them
    all); any other cell's own arguments."""
    shape = SHAPES[shape_name]
    mb = run.microbatch
    if shape.kind != "train" or not mb or 2 * mb >= shape.global_batch:
        return args
    small = dataclasses.replace(shape, global_batch=2 * mb)
    specs = input_specs(cfg, small)
    rules = cell_rules(cfg, shape, run, mesh)
    return (args[0], placed_fakes(specs, ts.batch_shardings(specs, rules)))


def _leaves(args) -> list:
    return [t for a in args for t in tree_leaves(a)]


def _nbytes(args) -> int:
    return sum(t.to_local().numel() * t.element_size()
               for t in _leaves(args) if isinstance(t, DTensor))


def run_cell(fn, args, mesh, warm=None) -> tuple[dict, dict, float]:
    """Run ``fn(*warm)`` (``warm_args``; ``args`` by default) once to
    fill DTensor's sharding-propagation cache (its first sight of an op
    runs it on fake tensors of the global shapes, which no rank
    allocates), then ``fn(*args)`` once under ``OpCostMode`` and
    ``LiveBytesMode``, the arguments' local shards counted from the
    start: (cost, memory, seconds of the second run)."""
    fn(*(args if warm is None else warm))
    live = LiveBytesMode()
    live.track(*[t for t in _leaves(args) if isinstance(t, DTensor)])
    arg_bytes = _nbytes(args)
    t0 = time.time()
    with live, OpCostMode(mesh) as mode:
        fn(*args)
    secs = time.time() - t0
    return (mode.result(), {"argument_size_in_bytes": arg_bytes,
                            "peak_bytes_per_device": live.peak}, secs)


def dryrun_step(cfg, shape, run=None, *, opt=None, device="cuda") -> dict:
    """The dry run of the step that the card runs on ``make_host_mesh``
    (one rank, a (1, 1) ("data", "model") mesh), at ``shape``
    (a ``ShapeConfig``: its batch and sequence), on a one-rank fake
    world and a (1, 1) mesh on ``device``: for a train shape the train
    CLI's donated step (``launch/train.py::build_session`` with ``run``
    and ``opt``, the run's optimizer by default), for a prefill the
    serve rules' prefill of ``cfg``'s serving weights.  Returns the cost,
    the memory record with ``rise_bytes`` (the peak less the
    arguments: what ``max_memory_allocated`` less ``memory_allocated``
    before the step reads on the card) and the trace seconds."""
    run = run_config(cfg, shape) if run is None else run
    if shape.kind == "train":
        check_trainable(device)
    specs = input_specs(cfg, shape)
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device)
        with fake_cuda():
            if shape.kind == "train":
                _, sch, shardings, fn, rules = build_session(
                    cfg, run, mesh, 1, opt)
                args = (placed_fakes(sch, shardings), placed_fakes(
                    specs, ts.batch_shardings(specs, rules)))
            elif shape.kind == "prefill":
                rules = make_rules(mesh, "serve")
                sch = M.schema(cfg)
                fn = serve_step.build_prefill(cfg, rules)
                args = (placed_fakes(sch, param_shardings(sch, rules)),
                        placed_fakes(specs, serve_step.serve_input_shardings(
                            specs, rules)))
            else:
                raise ValueError(f"dryrun_step runs train and prefill "
                                 f"steps, not {shape.kind}")
            cost, mem, secs = run_cell(fn, args, mesh)
    mem["rise_bytes"] = mem["peak_bytes_per_device"] \
        - mem["argument_size_in_bytes"]
    return {"cost": cost, "memory": mem, "trace_s": secs}


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                out_dir: Path = ARTIFACTS, verbose: bool = True, *,
                cfg=None, run=None, device="cuda",
                reduced: str | None = None) -> dict:
    """One cell's record, written under ``out_dir``.  ``cfg`` and
    ``run`` replace the arch's own (a cut, noted as ``reduced``);
    ``device`` is the mesh's and the fake tensors' (``cpu`` trains
    on any build)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind,
    }
    if reduced:
        rec["reduced"] = reduced
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        _write(rec, out_dir)
        return rec

    chips = 512 if multi_pod else 256
    try:
        if shape.kind == "train":
            check_trainable(device)
        with fake_world(chips):
            # the mesh's rank table is real: built before the fake mode
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            with fake_cuda():
                run = run_config(cfg, shape) if run is None else run
                fn, args = build_cell(arch, shape_name, mesh, cfg=cfg,
                                      run=run)
                hc, mem, trace_s = run_cell(
                    fn, args, mesh,
                    warm_args(cfg, shape_name, run, mesh, args))
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = repr(e)
        rec["traceback"] = traceback.format_exc()[-4000:]
        _write(rec, out_dir)
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: "
                  f"ERROR {e!r}", flush=True)
        return rec

    flops = hc["flops"]
    bytes_acc = hc["hbm_bytes"]
    rl = roofline_terms(flops, bytes_acc, hc, chip=H100_SXM)
    total, active = M.param_counts(cfg)
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind in ("train", "prefill") else 1
    )
    mf = model_flops(active, tokens, train=shape.kind == "train")
    mf_per_dev = mf / chips

    rec.update({
        "status": "ok",
        "chips": chips,
        "trace_s": round(trace_s, 2),
        "hlo_flops_per_dev": flops,
        "hlo_bytes_per_dev": bytes_acc,
        "hlo_bytes_by_op": hc["bytes_by_op"],
        "input_read_bytes_per_dev": hc["input_read_bytes"],
        "collectives": {
            "total_bytes": hc["collective_bytes"],
            "dci_bytes": hc["collective_dci_bytes"],
            "by_type": hc["collective_by_type"],
            "count": hc["collective_count"],
        },
        "while_trips": hc["while_trips"],
        "hlo_warnings": hc["warnings"],
        "memory": mem,
        "roofline": rl,
        "chip": H100_SXM.name,
        "params_total": total,
        "params_active": active,
        "tokens_per_step": tokens,
        "model_flops_per_dev": mf_per_dev,
        "useful_compute_ratio": mf_per_dev / flops if flops else 0.0,
        "hbm_budget_ok": mem["peak_bytes_per_device"] <= H100_SXM.hbm_bytes,
    })
    _write(rec, out_dir)
    if verbose:
        peak = mem["peak_bytes_per_device"] / 2**30
        print(
            f"[dryrun] {arch} × {shape_name} × {mesh_name}: ok "
            f"trace={trace_s:.1f}s dom={rl['dominant']} "
            f"frac={rl['roofline_fraction']:.3f} peak={peak:.2f}GiB",
            flush=True,
        )
    return rec


def _cell_path(rec: dict, out_dir: Path) -> Path:
    return out_dir / rec["mesh"] / rec["arch"] / f"{rec['shape']}.json"


def _write(rec: dict, out_dir: Path):
    p = _cell_path(rec, out_dir)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(rec, indent=1))


def load_all(out_dir: Path = ARTIFACTS) -> list[dict]:
    return [
        json.loads(p.read_text()) for p in sorted(out_dir.glob("*/*/*.json"))
    ]


def summarize(out_dir: Path = ARTIFACTS) -> str:
    rows = load_all(out_dir)
    lines = [
        "| arch | shape | mesh | status | dom | T_comp(s) | T_mem(s) | "
        "T_coll(s) | frac | useful | peak GiB | fits |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"{r['status']} | — | — | — | — | — | — | — | — |"
            )
            continue
        rl = r["roofline"]
        peak = r["memory"].get("peak_bytes_per_device", 0) / 2**30
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{rl['dominant']} | {rl['compute']:.4f} | {rl['memory']:.4f} | "
            f"{rl['collective']:.4f} | {rl['roofline_fraction']:.3f} | "
            f"{r['useful_compute_ratio']:.3f} | {peak:.2f} | "
            f"{'Y' if r['hbm_budget_ok'] else 'N'} |"
        )
    return "\n".join(lines)


def run_jobs(fn, tasks, jobs: int = 1) -> list:
    """``fn(*task)`` for each task: in this process one after another,
    or with ``jobs`` > 1 in spawned processes, one a task (a fake world
    is global to its process), ``jobs`` at a time."""
    if jobs <= 1:
        return [fn(*t) for t in tasks]
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=jobs,
                             mp_context=mp.get_context("spawn"),
                             max_tasks_per_child=1) as ex:
        futs = [ex.submit(fn, *t) for t in tasks]
        return [f.result() for f in futs]


def _cell_job(arch: str, shape: str, multi: bool, out: str) -> dict:
    return dryrun_cell(arch, shape, multi, Path(out))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells that already have artifacts")
    ap.add_argument("--summarize", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, one process each")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.summarize:
        print(summarize(out_dir))
        return

    archs = [args.arch] if args.arch else ALL_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh
    ]
    if not (args.all or args.arch or args.shape):
        ap.error("pass --all or --arch/--shape")

    tasks = []
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                rec = {
                    "arch": arch, "shape": shape,
                    "mesh": "multi" if multi else "single",
                }
                p = _cell_path(rec, out_dir)
                if p.exists() and not args.force:
                    prev = json.loads(p.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[dryrun] cached: {p}", flush=True)
                        continue
                tasks.append((arch, shape, multi, str(out_dir)))
    run_jobs(_cell_job, tasks, args.jobs)


if __name__ == "__main__":
    main()
