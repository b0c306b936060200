"""The elastic burst on the port: a training run moved from a world of
4 ranks, (2, 2) ("data", "model"), to one of 8, (2, 2, 2) ("pod",
"data", "model"), through a checkpoint restored onto the new
placements (``launch/world.py``, ``launch/elastic.py``,
``CheckpointManager.restore(..., shardings=)``,
``examples/torch_elastic_burst_demo.py``).

* the reshard, the port of ``tests/test_distributed.py``'s
  ``_RESHARD``: the smoke Granite-8B from the JAX package's
  ``init_params(..., key(0))``, ``RunConfig(loss_chunk=32)``, B = 8,
  S = 32, AdamW at a constant 1e-3; 4 steps on (2, 2), a save, the
  world closed, a (2, 2, 2) world restoring with ``shardings=`` and 4
  more steps.  The continued parameters within ``RESHARD_ATOL`` (JAX's
  own bound) of 8 un-moved steps on (2, 2); the 4th and 8th losses
  within ``LOSS_RTOL`` of ``_RESHARD``'s own run (a JAX subprocess on 8
  forced CPU devices, its ``jax.make_mesh`` calls given ``AxisType.Auto``
  axes in memory: ``repro``'s ``shard`` refuses Explicit ones).
* the demo: ``examples/elastic_burst_demo.py`` run in a JAX subprocess
  (the same patch) and the port's demo run whole with ``--device cpu``
  (120 steps, 4 then 8 gloo ranks): every event (kind, step, every
  float of its detail), ``elapsed_s`` and ``met_deadline`` equal.
* ``World``: a rank that raises or dies, or a call that outlasts its
  timeout, raises instead of hanging and leaves no process; ``close``
  leaves none either; CUDA without a card, or with fewer cards than
  ranks, raises.
* the rank-aware save: 2 gloo ranks write one generation, which
  verifies; ``launch/train.py::train`` in that world, resumed, equals
  the straight run.

All the worlds and JAX jobs of the reshard and the demo run side by
side in one module fixture.
"""
import ast
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import RunConfig, get_config, smoke_config  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.launch import elastic as E  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.world import RankError, World  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
DEMO = ROOT / "examples" / "torch_elastic_burst_demo.py"
JAX_DEMO = ROOT / "examples" / "elastic_burst_demo.py"
ARCH = "granite-8b"
SEQ, BATCH = 32, 8
LR = 1e-3
#: ``_RESHARD``'s bound on the continued parameters
RESHARD_ATOL = 2e-5
#: each loss against ``_RESHARD``'s (``tests/test_torch_train.py``'s)
LOSS_RTOL = 1e-5
TIMEOUT = 240

#: every JAX ``make_mesh`` call given Auto axes, before the job's source
_AUTO = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType

_make_mesh = jax.make_mesh


def _auto_mesh(shape, axes, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(shape))
    return _make_mesh(shape, axes, **kw)


jax.make_mesh = _auto_mesh
"""

#: the JAX demo's source run as a script once for each (steps,
#: congestion_from) of argv[3], its constants replaced in memory; each
#: run's output between BEGIN and END lines, its ``RunRecord`` as JSON.
#: The runs share a compilation cache in the job's directory (the second
#: compiles nothing anew).
_JAX_DEMO = _AUTO + r"""
import json
sys.path.insert(0, sys.argv[1])
from repro.core import ElasticOrchestrator

_run = ElasticOrchestrator.run
records = []


def _recorded(self, *a, **kw):
    rec = _run(self, *a, **kw)
    records.append(rec)
    return rec


ElasticOrchestrator.run = _recorded
jax.config.update("jax_compilation_cache_dir", os.path.abspath("jax-cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
source = open(sys.argv[2]).read()
for steps, congestion_from in json.loads(sys.argv[3]):
    src = source.replace("STEPS = 120", f"STEPS = {steps}").replace(
        "CONGESTION_FROM = 40", f"CONGESTION_FROM = {congestion_from}")
    assert src.count(f"STEPS = {steps}") == 1
    print(f"BEGIN {steps}", flush=True)
    exec(compile(src, sys.argv[2], "exec"),
         {"__name__": "__main__", "__file__": sys.argv[2]})
    rec = records.pop()
    print("RECORD " + json.dumps({
        "events": [[e.step, e.kind, e.detail] for e in rec.events],
        "elapsed_s": rec.elapsed_s, "met_deadline": rec.met_deadline}))
    print(f"END {steps}", flush=True)
"""
#: the JAX demo's run, and the cut the port's demo runs whole here: 24
#: steps, congestion from step 14, a burst at step 18 (18 steps on
#: (2, 2), 6 on (2, 2, 2); the full run's 72 steps on 8 ranks take the
#: file past its time budget)
FULL = (120, 40)
CUT = (24, 14)


def _reshard_source() -> str:
    """``tests/test_distributed.py``'s ``_RESHARD`` string, read from the
    file (nothing of it changes)."""
    tree = ast.parse((ROOT / "tests" / "test_distributed.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "_RESHARD" for t in node.targets):
            return ast.literal_eval(node.value)
    raise LookupError("_RESHARD not found")


def _spec() -> E.TrainSpec:
    return E.TrainSpec(smoke_config(get_config(ARCH)),
                       RunConfig(loss_chunk=32),
                       ShapeConfig("t", "train", SEQ, BATCH), LR)


def _jax_params() -> dict:
    """``_RESHARD``'s initial parameters, as numpy arrays."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.configs import smoke_config as jsmoke_config
    from repro.models import model as JM
    from repro.sharding.rules import init_params

    cfg = jsmoke_config(jget_config(ARCH))
    return jax.tree.map(np.asarray,
                        init_params(JM.schema(cfg), jax.random.key(0)))


def _port_reshard(work: Path) -> dict:
    """4 steps on (2, 2), a save, 4 more (the un-moved run); then a
    (2, 2, 2) world restores the save and takes the 4 again."""
    spec, params = _spec(), _jax_params()
    out = {"straight": [], "moved": []}
    with World((2, 2), ("data", "model"), "cpu", timeout_s=TIMEOUT) as w:
        w.call(E.setup, spec)
        w.call(E.init, 0, params)
        for i in range(8):
            if i == 4:
                out["saved"] = w.call(E.save, str(work / "ckpt"), 4)
            out["straight"].append(w.call(E.step, i)["loss"])
        out["straight_state"] = w.call(E.state_numpy)
    with World((2, 2, 2), ("pod", "data", "model"), "cpu",
               timeout_s=TIMEOUT) as w:
        out["mesh"] = w.call(E.setup, spec)["mesh"]
        out["restored"] = w.call(E.restore, str(work / "ckpt"), 4)
        out["placed"] = w.call(E.placed)
        for i in range(4, 8):
            out["moved"].append(w.call(E.step, i)["loss"])
        out["moved_state"] = w.call(E.state_numpy)
    return out


def _load_demo():
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_elastic_demo", DEMO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_demo() -> dict:
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rec = _load_demo().main(["--device", "cpu",
                                 "--steps", str(CUT[0]),
                                 "--congestion-from", str(CUT[1])])
    return {"record": rec, "out": buf.getvalue(),
            "seconds": time.monotonic() - t0}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two JAX jobs, the port's reshard and demo, the 2-rank world
    and the failing worlds, all side by side."""
    work = tmp_path_factory.mktemp("elastic")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)

    def start(*argv):
        return subprocess.Popen([sys.executable, "-c", *argv],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env,
                                cwd=work)

    jobs = {"reshard": start(_AUTO + _reshard_source(), SRC),
            "demo": start(_JAX_DEMO, SRC, str(JAX_DEMO),
                          json.dumps([FULL, CUT]))}
    try:
        with ThreadPoolExecutor(4) as pool:
            futs = {"demo": pool.submit(_port_demo),
                    "reshard": pool.submit(_port_reshard, work),
                    "two_ranks": pool.submit(_two_ranks, work / "two"),
                    "failures": pool.submit(_failures)}
            out = {k: f.result() for k, f in futs.items()}
        out["jax"] = {}
        for name, p in jobs.items():
            so, se = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (name, se[-3000:])
            out["jax"][name] = so
    finally:
        for p in jobs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    out["work"] = work
    return out


def _jax_reshard_losses(out: str) -> tuple[float, float]:
    line = next(ln for ln in out.splitlines() if ln.startswith("RESHARD_OK"))
    _, before, after = line.split()
    return float(before), float(after)


def _jax_run(out: str, steps: int) -> tuple[list[str], dict]:
    """The JAX demo's lines of one run, and its record."""
    lines = out.splitlines()
    run = lines[lines.index(f"BEGIN {steps}") + 1:lines.index(f"END {steps}")]
    rec = next(ln for ln in run if ln.startswith("RECORD "))
    return [ln.strip() for ln in run], json.loads(rec[len("RECORD "):])


def _events(rec) -> list:
    return json.loads(json.dumps([[e.step, e.kind, e.detail]
                                  for e in rec.events]))


def test_reshard_continues_the_unmoved_run(runs):
    port = runs
    r = port["reshard"]
    assert r["mesh"] == {"pod": 2, "data": 2, "model": 2}
    assert r["restored"]["data_step"] == 4
    assert r["placed"]
    got = tree_leaves(r["moved_state"]["params"])
    want = tree_leaves(r["straight_state"]["params"])
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=RESHARD_ATOL, err_msg=str(i))
    for part in ("opt", "step"):
        for g, w in zip(tree_leaves(r["moved_state"][part]),
                        tree_leaves(r["straight_state"][part])):
            np.testing.assert_allclose(g, w, atol=RESHARD_ATOL)
    assert int(r["moved_state"]["step"]) == 8
    np.testing.assert_allclose(r["moved"], r["straight"][4:],
                               rtol=LOSS_RTOL)


def test_reshard_losses_equal_jax(runs):
    port, outs = runs, runs["jax"]
    before, after = _jax_reshard_losses(outs["reshard"])
    r = port["reshard"]
    np.testing.assert_allclose(r["straight"][3], before, rtol=LOSS_RTOL)
    np.testing.assert_allclose(r["moved"][3], after, rtol=LOSS_RTOL)


def test_reshard_checkpoint_is_one_generation(runs):
    """4 ranks saved; rank 0 wrote one generation, which verifies."""
    port, work = runs, runs["work"]
    mgr = CheckpointManager(work / "ckpt", async_save=False)
    assert mgr.all_steps() == [4] and mgr.verify(4)
    assert not [p for p in (work / "ckpt").iterdir()
                if p.name != "step_00000004"]
    assert port["reshard"]["saved"]["bytes"] > 0


def test_demo_events_equal_jax(runs):
    """The port's demo, run whole at the cut on 4 then 8 gloo ranks:
    every event, ``elapsed_s`` and ``met_deadline`` equal the JAX
    demo's at the same cut."""
    port, outs = runs, runs["jax"]
    rec = port["demo"]["record"]
    _, want = _jax_run(outs["demo"], CUT[0])
    assert _events(rec) == want["events"]
    assert rec.elapsed_s == want["elapsed_s"]
    assert rec.met_deadline is want["met_deadline"] is True
    assert [e.kind for e in rec.events if e.kind != "ckpt"] == ["burst"]


@pytest.mark.parametrize("run", [FULL, CUT], ids=["full", "cut"])
def test_demo_clock_events_equal_jax(runs, run):
    """The demo's orchestrator and modelled clock over the JAX demo's
    full run (and the cut): its events equal the JAX demo's exactly."""
    outs = runs["jax"]
    rec = _load_demo().clock_record(*run)
    _, want = _jax_run(outs["demo"], run[0])
    assert _events(rec) == want["events"]
    assert rec.elapsed_s == want["elapsed_s"]
    assert rec.met_deadline is want["met_deadline"] is True


def test_demo_bursts_at_step_48():
    rec = _load_demo().clock_record(*FULL)
    bursts = [e for e in rec.events if e.kind == "burst"]
    assert [e.step for e in bursts] == [48]
    d = bursts[0].detail
    assert (d["chips"], d["K"], d["overhead_s"]) == \
        (1, 0.5000000000000001, 9.0)
    assert round(rec.elapsed_s, 1) == 189.0 and rec.deadline_s == 192.0


def test_demo_prints_the_jax_lines(runs):
    port, outs = runs, runs["jax"]
    lines = [ln.strip() for ln in port["demo"]["out"].splitlines()]
    jlines, _ = _jax_run(outs["demo"], CUT[0])
    for prefix in ("[session]", "step ", "elapsed ", "modeled step "):
        want = [ln for ln in jlines if ln.startswith(prefix)]
        assert want and [ln for ln in lines if ln.startswith(prefix)] \
            == want, prefix
    assert lines[-1] == "elastic_burst_demo OK"
    assert port["demo"]["record"].completed


# ---------------------------------------------------------------------------
# World
# ---------------------------------------------------------------------------

#: rank functions: importable by name, so the spawned ranks find them


def _whoami(ctx):
    return {"rank": ctx.rank, "size": ctx.world_size,
            "mesh": dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.shape)),
            "device": str(ctx.device), "backend": dist.get_backend()}


def _fail_on_rank(ctx, bad, how):
    """Rank ``bad`` raises or exits; the others wait in a barrier that
    cannot end without it."""
    if ctx.rank == bad:
        if how == "exit":
            os._exit(3)
        raise ValueError(f"rank {ctx.rank} fails on purpose")
    dist.barrier()


def _sleep(ctx, seconds):
    time.sleep(seconds)


#: the failing worlds' call timeouts: the first call imports this module
#: on the ranks, which takes seconds on a loaded host
FAIL_TIMEOUT = {"raise": 120, "exit": 120, "timeout": 5}


def _failing_world(how):
    """A 2-rank world whose call fails ``how``: the error, the seconds to
    it, and whether the world and its processes are gone after."""
    shape = (1, 1) if how == "timeout" else (2, 1)
    w = World(shape, ("data", "model"), "cpu", timeout_s=FAIL_TIMEOUT[how])
    procs = list(w._procs)
    t0 = time.monotonic()
    try:
        if how == "timeout":
            w.call(_sleep, 600)
        else:
            w.call(_fail_on_rank, 1, how)
        err = None
    except RankError as e:
        err = e
    return {"error": err, "seconds": time.monotonic() - t0,
            "gone": not w.alive and not any(p.is_alive() for p in procs)}


def _failures() -> dict:
    """The three failing worlds side by side."""
    hows = ("raise", "exit", "timeout")
    with ThreadPoolExecutor(len(hows)) as pool:
        return dict(zip(hows, pool.map(_failing_world, hows)))


@pytest.mark.parametrize("how", ["raise", "exit", "timeout"])
def test_world_failing_rank_raises(runs, how):
    """A rank that raises or dies, or a call past its timeout, makes
    ``call`` raise (the other rank stuck in a barrier) and kills the
    world."""
    got = runs["failures"][how]
    want = {"raise": r"rank 1 raised:\n(.|\n)*ValueError: rank 1 fails",
            "exit": "rank 1 exited with code 3",
            "timeout": f"did not answer within {FAIL_TIMEOUT[how]} s"}[how]
    assert isinstance(got["error"], RankError), got
    assert re.search(want, str(got["error"])), str(got["error"])
    assert got["seconds"] < FAIL_TIMEOUT[how] + 30
    assert got["gone"]


def test_world_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        World((1, 1), ("data", "model"), "cuda")


def test_world_wants_a_card_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 cards, this machine "
                                           "has 1"):
        World((2, 2), ("data", "model"), "cuda:0")


# ---------------------------------------------------------------------------
# the rank-aware save, and the train CLI in a world of ranks
# ---------------------------------------------------------------------------


def _save_on_ranks(ctx, directory, async_save):
    """Every rank saves the same state: rank 0 alone writes, and every
    rank finds the generation whole when ``save`` returns."""
    mgr = CheckpointManager(directory, async_save=async_save)
    writes = []
    real = mgr._write
    mgr._write = lambda job: (writes.append(job[0]), real(job))
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "step": torch.tensor(3, dtype=torch.int32)}
    mgr.save(3, state, extra={"data_step": 3})
    assert writes == ([3] if ctx.rank == 0 else []), writes
    assert mgr.all_steps() == [3] and mgr.verify(3)
    got, extra = mgr.restore(state)
    assert torch.equal(got["w"], state["w"]) and extra["data_step"] == 3
    mgr.close()
    return len(writes)


def _train_on_ranks(ctx, directory, steps, resume):
    res = train_cli.train(
        smoke_config(get_config("mamba2-370m")),
        RunConfig(loss_chunk=32, microbatch=2),
        ShapeConfig("cli", "train", 32, 4), steps=steps,
        device=ctx.device, ckpt_dir=directory, ckpt_every=1,
        resume=resume, log_every=100)
    return {"losses": res.losses, "start_step": res.start_step,
            "state": [t.numpy() for t in tree_leaves(res.state)]}


def _two_ranks(work: Path) -> dict:
    """One 2-rank gloo world: who it is, both saves, the train CLI run
    straight, into checkpoints and resumed; then closed."""
    out = {"work": work}
    w = World((2, 1), ("data", "model"), "cpu", timeout_s=120)
    out["procs"], out["store"] = list(w._procs), w._dir
    try:
        out["whoami"] = w.call(_whoami)
        for a in (False, True):
            out[f"writes_{a}"] = w.call(_save_on_ranks,
                                        str(work / f"save-{a}"), a)
        out["full"] = w.call(_train_on_ranks, str(work / "full"), 4, False)
        w.call(_train_on_ranks, str(work / "part"), 2, False)
        out["rest"] = w.call(_train_on_ranks, str(work / "part"), 4, True)
    finally:
        w.close()
    out["closed"] = w
    return out


def test_world_call_and_close(runs):
    two_ranks = runs["two_ranks"]
    assert two_ranks["whoami"] == {"rank": 0, "size": 2,
                                   "mesh": {"data": 2, "model": 1},
                                   "device": "cpu", "backend": "gloo"}
    assert len(two_ranks["procs"]) == 2
    assert not any(p.is_alive() for p in two_ranks["procs"])
    assert not two_ranks["store"].exists()
    w = two_ranks["closed"]
    with pytest.raises(RankError, match="closed"):
        w.call(_whoami)
    w.close()                                 # a second close is harmless


@pytest.mark.parametrize("async_save", [False, True])
def test_two_rank_save_writes_one_generation(runs, async_save):
    two_ranks = runs["two_ranks"]
    assert two_ranks[f"writes_{async_save}"] == 1
    d = two_ranks["work"] / f"save-{async_save}"
    assert [p.name for p in d.iterdir()] == ["step_00000003"]


def test_train_cli_resumes_in_a_two_rank_world(runs):
    """``launch/train.py::train`` on 2 ranks: 4 steps straight against 2
    into checkpoints, and 2 more resumed from them, restored onto the
    placements."""
    two_ranks = runs["two_ranks"]
    full, rest = two_ranks["full"], two_ranks["rest"]
    assert rest["start_step"] == 2 and full["start_step"] == 0
    assert rest["losses"] == full["losses"][2:]
    for a, b in zip(full["state"], rest["state"]):
        np.testing.assert_array_equal(a, b)
    for name in ("full", "part"):
        d = two_ranks["work"] / name
        mgr = CheckpointManager(d, async_save=False)
        assert mgr.all_steps() == [2, 3, 4]
        assert all(mgr.verify(s) for s in (2, 3, 4))
        assert not [p for p in d.iterdir() if p.suffix]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_card_move_between_one_rank_worlds_is_bitwise(tmp_path):
    """The move on one card: a (1, 1) NCCL world takes 2 steps, saves, 2
    more; a (1, 1, 1) world restores and takes the 2 again, with the
    kernels (the smoke Granite-8B with the narrowest head dim the flash
    kernel takes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = _load_demo().spec_for(torch.device("cuda", 0))
    with World((1, 1), ("data", "model"), "cuda") as w:
        w.call(E.setup, spec)
        w.call(E.init, 0)
        w.call(E.step, 0)
        w.call(E.step, 1)
        w.call(E.save, str(tmp_path), 2)
        w.call(E.zero_counts)
        want = [w.call(E.step, i)["loss"] for i in (2, 3)]
        launches = w.call(E.counts)
        want_crc = w.call(E.state_crcs)
    with World((1, 1, 1), ("pod", "data", "model"), "cuda") as w:
        w.call(E.setup, spec)
        assert w.call(E.restore, str(tmp_path), 2)["data_step"] == 2
        assert w.call(E.placed)
        got = [w.call(E.step, i)["loss"] for i in (2, 3)]
        got_crc = w.call(E.state_crcs)
    assert got == want
    assert got_crc == want_crc
    assert launches["flash_attention"] > 0 and launches["rmsnorm_residual"] > 0
