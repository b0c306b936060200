#!/usr/bin/env python3
"""Name what the card allocates in a held step that the dry run's count
does not see.

    python3 tools/held_peak_probe.py                   (on a CUDA card)

For each of ``chip_smoke.py``'s ``HELD_STEPS`` (``moe_train``'s two
donated steps and the Yi-6B prefill of 4 x 512 under the serve rules)
the dry run first, in a subprocess: ``held_dryrun`` with a
``LiveBytesMode`` that notes each storage's bytes and the op that made
it, and keeps the storages live at its peak.  Then the step on the card
as the smoke runs it (one warm-up call, the step's second call
measured), under the caching allocator's history: its rise by the
allocator's statistics (``max_memory_allocated`` less
``memory_allocated`` before the step) and by the history (the sizes
asked for), and the blocks live at the history's peak with their
Python frames.  The two live sets are matched by size; what is left on
either side is printed, the card's with its frames.  The dry runs go
first: each makes a CUDA context (a fake CUDA tensor's first sight of
the device), which a card full of a step's state refuses.  One JSON
line a step after the card's ``nvidia-smi`` name and power limit; the
whole record under ``--out``.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

_DRY = r"""
import json, sys
import chip_smoke as cs
from repro_torch.launch import dryrun as dr
from repro_torch.launch import live_bytes as lb

modes = []


class Noted(lb.LiveBytesMode):
    '''The count, noting each storage's bytes and maker, and the
    storages live at its peak (the arguments left out).'''

    def __init__(self):
        super().__init__()
        self.made, self.at_peak, self.op = {}, [], None
        modes.append(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.op = str(func)
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _add(self, t):
        key = t.untyped_storage()._cdata
        new, before = key not in self._storages, self.peak
        super()._add(t)
        if new and self.op is not None:
            self.made[key] = (self._storages[key][1], self.op)
        if self.peak > before:
            self.at_peak = [self.made[k] for k in self._storages
                            if k in self.made]


dr.LiveBytesMode = Noted
rec = cs.held_dryrun(sys.argv[1])
with open(sys.argv[2], "w") as f:
    json.dump({"memory": rec["memory"], "at_peak": modes[-1].at_peak}, f)
"""


def _frames(event) -> list[str]:
    return [f"{f['filename'].split('/')[-1]}:{f['line']} {f['name']}"
            for f in event.get("frames", [])
            if "/torch/" not in f["filename"]][:4]


def card_step(run) -> dict:
    """``run()`` (the step, warmed up) under the allocator's history:
    the rise by the statistics and by the history, and the blocks made
    in it live at the history's peak, as (bytes asked, frames)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python",
        max_entries=2_000_000)
    try:
        out = run()
        torch.cuda.synchronize()
        stats_rise = torch.cuda.max_memory_allocated() - base
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    del out
    live, cur, peak, at_peak = {}, 0, 0, []
    for ev in snap["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], _frames(ev))
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, list(live.values())
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[0]
    return {"stats_rise": stats_rise, "history_rise": peak,
            "at_peak": at_peak}


def unmatched(card: list, dry: list) -> dict:
    """The two live sets matched by size; what is left on each side."""
    c = collections.Counter(s for s, _ in card)
    d = collections.Counter(s for s, _ in dry)
    only_c, only_d = c - d, d - c
    frames = collections.defaultdict(list)
    for s, fr in card:
        if only_c.get(s) and len(frames[s]) < 2:
            frames[s].append(fr)
    ops = collections.defaultdict(set)
    for s, op in dry:
        if only_d.get(s):
            ops[s].add(op)
    return {
        "card_only": [{"bytes": s, "n": n, "frames": frames[s]}
                      for s, n in only_c.most_common(12)],
        "card_only_bytes": sum(s * n for s, n in only_c.items()),
        "dry_only": [{"bytes": s, "n": n, "ops": sorted(ops[s])[:4]}
                     for s, n in only_d.most_common(12)],
        "dry_only_bytes": sum(s * n for s, n in only_d.items())}


def prefill_step(cs, dev):
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import serve_step
    from repro_torch.sharding.rules import make_rules

    cfg = get_config("yi-6b")
    B, P = cs.LAUNCH_COST_PREFILL
    params = serve.make_params(cfg, dev, seed=cs.SEED)
    prompts = serve.make_prompts(
        cfg, B, P, torch.Generator(device=dev).manual_seed(cs.SEED + 1))
    try:
        rules = make_rules(make_host_mesh(device=dev), "serve")
        dparams = serve_step.place_params(cfg, params, rules)
        inputs = serve_step.place_inputs(
            {"tokens": prompts.to(torch.int32)}, rules)
        prefill = serve_step.build_prefill(cfg, rules)
        prefill(dparams, inputs)                              # warm-up
        return card_step(lambda: prefill(dparams, inputs))
    finally:
        dist.destroy_process_group()


def train_step(cs, dev, cfg, B, S):
    import torch.distributed as dist

    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import train_step as ts

    run = cs.moe_train_run()
    try:
        opt, sch, shardings, step_fn, rules = train_mod.build_session(
            cfg, run, make_host_mesh(device=dev), cs.MOE_TRAIN_STEPS,
            cs.moe_train_optimizer(cfg, run))
        state = cs._placed_state(sch, opt, shardings, dev)
        pipe = SyntheticLMPipeline(
            cfg, ShapeConfig("moe_train", "train", S, B), device=dev)
        batches = [ts.distribute_batch(pipe.batch_at(i), rules)
                   for i in range(2)]
        step_fn(state, batches[0])                            # warm-up
        torch.cuda.empty_cache()
        return card_step(lambda: step_fn(state, batches[1]))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "artifacts" / "held_peak"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("held_peak_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", _DRY, name,
                               str(out / f"dry_{name}.json")],
                              cwd=ROOT, env=env)
             for name in cs.HELD_STEPS]
    for p in procs:
        if p.wait(timeout=600):
            raise SystemExit(f"a dry run exited {p.returncode}")
    build.build_all()
    dev = torch.device("cuda", 0)
    cards = {"yi-6b-prefill": prefill_step(cs, dev)}
    torch.cuda.empty_cache()
    for cfg, (B, S), _ in cs.moe_train_cells():
        cards[cfg.name] = train_step(cs, dev, cfg, B, S)
        torch.cuda.empty_cache()
    recs = {}
    for name in cs.HELD_STEPS:
        dry = json.loads((out / f"dry_{name}.json").read_text())
        card = cards[name]
        recs[name] = {
            "step": name, "card_stats_rise": card["stats_rise"],
            "card_history_rise": card["history_rise"],
            "dryrun_rise": dry["memory"]["rise_bytes"],
            "card_blocks": len(card["at_peak"]),
            "dryrun_storages": len(dry["at_peak"]),
            **unmatched(card["at_peak"], [tuple(x) for x in
                                          dry["at_peak"]])}
        print(json.dumps(recs[name]), flush=True)
    (out / "held_peak.json").write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
