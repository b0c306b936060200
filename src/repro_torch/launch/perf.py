"""Perf-iteration harness over the dry run (the JAX package's
``launch/perf.py``).

Each experiment = (cell, variant): a named transform over the
ModelConfig / RunConfig of one (arch × shape × mesh) cell.  The harness
runs the variant as the dry run runs a cell (``launch/dryrun.py``: fake
tensors at their placements over a fake process group of 256 or 512
ranks, ``OpCostMode`` and ``LiveBytesMode``, the peak the port's own
count of live bytes), and writes
``artifacts/torch_perf/<arch>.<shape>.<mesh>/<variant>.json`` so every
hypothesis -> change -> measure step is recorded next to its baseline.

The experiments and their transforms are the JAX package's, name for
name.  Their hypotheses state each mechanism and no figure: the JAX
package's figures are predictions for its TPU target, and the port's
own come from its dry run's records.  All 15 are train cells, which
need a build with CUDA (``dryrun.check_trainable``, the card's
machine); ``--list`` runs anywhere.  Each record has a ``status``: "ok", or
"error" with the error and its traceback.

    python -m repro_torch.launch.perf --list
    python -m repro_torch.launch.perf --run dsv3-ep
    python -m repro_torch.launch.perf --run --jobs 7     # all 15
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import traceback
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, input_specs
from repro_torch.launch import dryrun as dr
from repro_torch.launch.hw import H100_SXM
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import model_flops, roofline_terms
from repro_torch.models import model as M
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.runtime import train_step as ts

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "torch_perf"


@dataclasses.dataclass
class Experiment:
    name: str
    arch: str
    shape: str
    mesh: str                       # single | multi
    hypothesis: str
    cfg_fn: callable = None         # ModelConfig -> ModelConfig
    run_fn: callable = None         # RunConfig -> RunConfig


def _moe_ep(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, ep_over_dp=True)
    )


def _moe_ep_scatter(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, ep_over_dp=True,
                                     dispatch="scatter")
    )


def _moe_no_ep(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, ep_over_dp=False)
    )


EXPERIMENTS = {
    # --- cell A: deepseek-v3-671b × train_4k × single (collective-bound)
    "dsv3-baseline-fsdp": Experiment(
        "dsv3-baseline-fsdp", "deepseek-v3-671b", "train_4k", "single",
        "Paper-faithful baseline record (pre-hillclimb defaults): FSDP-"
        "gathered experts, no SP. Kept regenerable so baseline vs "
        "optimized stay side by side in artifacts/torch_perf.",
        cfg_fn=_moe_no_ep,
    ),
    "dsv3-ep": Experiment(
        "dsv3-ep", "deepseek-v3-671b", "train_4k", "single",
        "FSDP regathers expert weights at every use. EP over (data×model) "
        "moves TOKENS via all-to-all instead, and expert grads become "
        "fully local. Predict the all-gather bytes and T_coll fall "
        "against dsv3-baseline-fsdp; all-to-all bytes appear.",
        cfg_fn=_moe_ep,
    ),
    "dsv3-ep-mb64": Experiment(
        "dsv3-ep-mb64", "deepseek-v3-671b", "train_4k", "single",
        "On top of EP: double microbatch 32->64 halves the number of "
        "dense-layer FSDP gather rounds per step. Predict the residual "
        "all-gather bytes halve against dsv3-ep; activation memory "
        "doubles.",
        cfg_fn=_moe_ep,
        run_fn=lambda r: dataclasses.replace(r, microbatch=64),
    ),
    "dsv3-ep-scatter": Experiment(
        "dsv3-ep-scatter", "deepseek-v3-671b", "train_4k", "single",
        "On top of EP: scatter dispatch removes the one-hot dispatch/"
        "combine einsum FLOPs (2·T·(E·C)·d per group). Predict T_comp "
        "falls against dsv3-ep by that einsum's share.",
        cfg_fn=_moe_ep_scatter,
    ),
    "dsv3-ep-sp": Experiment(
        "dsv3-ep-sp", "deepseek-v3-671b", "train_4k", "single",
        "On top of EP: the peak holds the remat stash of the residual "
        "stream. Sequence-shard the residual stream over 'model' "
        "(Megatron-SP): the stash shrinks by the model axis (16); adds "
        "an all-gather and a reduce-scatter of tokens·d per layer. "
        "Predict the peak falls against dsv3-ep and T_coll rises a "
        "little.",
        cfg_fn=_moe_ep,
        run_fn=lambda r: dataclasses.replace(r, seq_shard=True),
    ),
    "dsv3-ep-sp-multi": Experiment(
        "dsv3-ep-sp-multi", "deepseek-v3-671b", "train_4k", "multi",
        "Params and grads alone set a floor on the single-pod peak. On "
        "512 chips (2 pods) the static state per chip halves. Predict "
        "the peak falls against dsv3-ep-sp by about the static state's "
        "half.",
        cfg_fn=_moe_ep,
        run_fn=lambda r: dataclasses.replace(r, seq_shard=True),
    ),
    "dsv3-ep-sp-nomb": Experiment(
        "dsv3-ep-sp-nomb", "deepseek-v3-671b", "train_4k", "single",
        "With SP the remat stash is small; dropping grad accumulation "
        "removes the separate accumulator and the per-µbatch FSDP "
        "gather rounds. Predict the peak and T_coll fall against "
        "dsv3-ep-sp.",
        cfg_fn=_moe_ep,
        run_fn=lambda r: dataclasses.replace(r, seq_shard=True,
                                             microbatch=None),
    ),
    # --- cell B: whisper-large-v3 × train_4k × single (worst fraction)
    "whisper-mb256": Experiment(
        "whisper-mb256", "whisper-large-v3", "train_4k", "single",
        "The memory term holds the per-µbatch encoder and cross-KV "
        "recompute under full remat. Run the whole batch in one µstep "
        "(no accumulation): the encoder runs once. Predict T_mem falls.",
        run_fn=lambda r: dataclasses.replace(r, microbatch=None),
    ),
    "whisper-mb256-dots": Experiment(
        "whisper-mb256-dots", "whisper-large-v3", "train_4k", "single",
        "On top of mb256: remat 'dots' keeps matmul outputs (incl. "
        "cross-KV) so backward does not recompute the encoder path. "
        "The model is 1.5B, so its activations fit. Predict T_mem falls "
        "further.",
        run_fn=lambda r: dataclasses.replace(r, microbatch=None,
                                             remat="dots"),
    ),
    "whisper-flatdp": Experiment(
        "whisper-flatdp", "whisper-large-v3", "train_4k", "single",
        "Root cause of the low fraction: 20 heads % 16 model ranks != 0"
        " -> attention replicated on every model rank (16x waste in both "
        "compute and memory terms). Flat DP uses 'model' as a second "
        "data axis (batch 256 = 16x16, per-dev batch 1). Predict T_comp "
        "and T_mem fall by up to the model axis (16).",
        cfg_fn=lambda c: dataclasses.replace(c, flat_dp=True),
    ),
    "whisper-flatdp-dots": Experiment(
        "whisper-flatdp-dots", "whisper-large-v3", "train_4k", "single",
        "Flat DP + remat dots (per-dev batch 1: activations are tiny, "
        "full remat is pure waste). Predict T_comp falls against "
        "whisper-flatdp by the recomputed forward's share.",
        cfg_fn=lambda c: dataclasses.replace(c, flat_dp=True),
        run_fn=lambda r: dataclasses.replace(r, remat="dots"),
    ),
    "whisper-flatdp-full": Experiment(
        "whisper-flatdp-full", "whisper-large-v3", "train_4k", "single",
        "flat_dp alone does not engage: microbatch 128 < 256 so the batch "
        "dim cannot split 256-way and falls back to data-only. Run the "
        "full batch per step (no accumulation): per-dev batch 1, "
        "attention finally distributed. Predict T_comp and T_mem fall "
        "by up to the model axis (16) against whisper-mb256-dots.",
        cfg_fn=lambda c: dataclasses.replace(c, flat_dp=True),
        run_fn=lambda r: dataclasses.replace(r, microbatch=None,
                                             remat="dots"),
    ),
    # --- cell C: granite-8b × train_4k × multi (the paper's technique)
    "granite-multi-int8": Experiment(
        "granite-multi-int8", "granite-8b", "train_4k", "multi",
        "Cross-pod DCI traffic is the paper's slow link. int8 gradient "
        "exchange over the pod axis cuts DCI bytes ~4x vs fp32 wire. "
        "Predict collective_dci -> /4.",
        run_fn=lambda r: dataclasses.replace(
            r, gradient_compression="int8"),
    ),
    "granite-multi-pp": Experiment(
        "granite-multi-pp", "granite-8b", "train_4k", "multi",
        "PP over the pod axis instead of cross-pod DP: only stage-"
        "boundary activations cross DCI, and layer grads never leave "
        "their pod. Predict the DCI bytes fall by the ratio of a step's "
        "boundary activations to its gradients. Cost: the pipeline "
        "bubble (stages-1)/(n_micro+stages-1), 1/9 at 8 µbatches.",
        run_fn=lambda r: dataclasses.replace(
            r, pipeline_stages=2, pp_microbatches=8, microbatch=None),
    ),
    "granite-multi-mb128": Experiment(
        "granite-multi-mb128", "granite-8b", "train_4k", "multi",
        "Fewer accumulation rounds -> fewer FSDP gather sweeps. "
        "microbatch 64->128 halves gather volume; activation checkpoint "
        "memory doubles. Predict the all-gather bytes and T_coll halve.",
        run_fn=lambda r: dataclasses.replace(r, microbatch=128),
    ),
}


def build_variant(exp: Experiment, mesh):
    """``(cfg, shape, mesh, fn, args, warm)`` of an experiment: the step,
    its placed fake inputs on ``mesh`` (the production mesh of
    ``exp.mesh``, built before the fake mode) and the arguments that
    warm it up (``dr.warm_args``; None: ``args``).  Call it under
    ``dr.fake_cuda()`` in a fake world (``dr.fake_world``)."""
    cfg = get_config(exp.arch)
    if exp.cfg_fn:
        cfg = exp.cfg_fn(cfg)
    shape = SHAPES[exp.shape]
    run = dr.run_config(cfg, shape)
    if exp.run_fn:
        run = exp.run_fn(run)
    if run.pipeline_stages > 1 and "pod" in mesh.mesh_dim_names:
        from repro_torch.runtime.pipeline import build_pipeline_train_step

        rules = dr.cell_rules(cfg, shape, run, mesh)
        in_specs = input_specs(cfg, shape)
        opt = make_optimizer(cfg.optimizer, warmup_cosine())
        fn, state_sh = build_pipeline_train_step(cfg, run, opt, rules,
                                                 donate=True)
        state = dr.placed_fakes(ts.state_schema(cfg, run, opt), state_sh)
        batch = dr.placed_fakes(in_specs,
                                ts.batch_shardings(in_specs, rules))
        return cfg, shape, mesh, fn, (state, batch), None
    fn, args = dr.build_cell(exp.arch, exp.shape, mesh, cfg=cfg, run=run)
    return (cfg, shape, mesh, fn, args,
            dr.warm_args(cfg, exp.shape, run, mesh, args))


def run_experiment(exp: Experiment, out_root: Path = ARTIFACTS) -> dict:
    """The experiment's record, written under ``out_root``: ``status``
    "ok" with the dry run's cost, memory and roofline, or "error" with
    the error and its traceback."""
    chips = 512 if exp.mesh == "multi" else 256
    rec = {
        "experiment": exp.name,
        "hypothesis": exp.hypothesis,
        "arch": exp.arch, "shape": exp.shape, "mesh": exp.mesh,
    }
    out = out_root / f"{exp.arch}.{exp.shape}.{exp.mesh}"
    out.mkdir(parents=True, exist_ok=True)
    try:
        if SHAPES[exp.shape].kind == "train":
            dr.check_trainable()
        with dr.fake_world(chips):
            mesh = make_production_mesh(multi_pod=exp.mesh == "multi")
            with dr.fake_cuda():
                cfg, shape, mesh, fn, args, warm = build_variant(exp, mesh)
                hc, mem, trace_s = dr.run_cell(fn, args, mesh, warm)
    except Exception as e:
        rec.update(status="error", error=repr(e),
                   traceback=traceback.format_exc()[-4000:])
        (out / f"{exp.name}.json").write_text(json.dumps(rec, indent=1))
        print(f"[perf] {exp.name}: ERROR {e!r}", flush=True)
        return rec
    rl = roofline_terms(hc["flops"], hc["hbm_bytes"], hc, chip=H100_SXM)
    total, active = M.param_counts(cfg)
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind in ("train", "prefill") else 1
    )
    mf = model_flops(active, tokens, train=shape.kind == "train") / chips
    rec.update({
        "status": "ok",
        "trace_s": round(trace_s, 1),
        "hlo_flops_per_dev": hc["flops"],
        "hlo_bytes_per_dev": hc["hbm_bytes"],
        "collectives": {
            "total_bytes": hc["collective_bytes"],
            "dci_bytes": hc["collective_dci_bytes"],
            "by_type": hc["collective_by_type"],
        },
        "memory": mem,
        "roofline": rl,
        "chip": H100_SXM.name,
        "useful_compute_ratio": mf / hc["flops"] if hc["flops"] else 0,
    })
    (out / f"{exp.name}.json").write_text(json.dumps(rec, indent=1))
    print(
        f"[perf] {exp.name}: dom={rl['dominant']} "
        f"T=(c {rl['compute']:.2f} | m {rl['memory']:.2f} | "
        f"x {rl['collective']:.2f})s frac={rl['roofline_fraction']:.3f} "
        f"peak={mem.get('peak_bytes_per_device', 0) / 2**30:.1f}GiB",
        flush=True,
    )
    return rec


def _run_named(name: str, out: str) -> dict:
    return run_experiment(EXPERIMENTS[name], Path(out))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", nargs="*", default=None,
                    help="experiments to run (none named: all 15)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="experiments run at once, one process each")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    if args.list or args.run is None:
        for name, e in EXPERIMENTS.items():
            print(f"{name}: [{e.arch} × {e.shape} × {e.mesh}] "
                  f"{e.hypothesis[:90]}")
        return
    names = args.run or list(EXPERIMENTS)
    for name in names:
        if name not in EXPERIMENTS:
            ap.error(f"no experiment {name!r}")
    dr.run_jobs(_run_named, [(n, args.out) for n in names], args.jobs)


if __name__ == "__main__":
    main()
