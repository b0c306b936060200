"""Sharded serving on gloo ranks against the single device and against
the JAX package's sharded prefill and decode.

The smoke yi-6b, mamba2-370m, deepseek-v2-236b (its MoE layers on the
expert-parallel path) and jamba-v0.1-52b (f32), their parameters drawn
by the JAX package's ``init_params`` and carried into the port by
``models/convert.py``; a 16-token prompt, a cache of 24 positions, 4
greedy decode steps; batches of 4 (the cache's sequence axis
``kv_seq_long``, over ("data", "model")) and 8 (``kv_seq``, over
"model").

* The port: 4 spawned gloo ranks a mesh (one subprocess a rank, meeting
  at a ``FileStore`` under ``tmp_path``, each with its own timeout),
  ("data", "model") (2, 2) and (1, 4), the parameters and inputs placed
  by ``runtime/serve_step.py``'s ``place_params`` / ``place_inputs``,
  the steps built with ``make_rules(mesh, "serve")``.  Rank 0 also
  serves the same inputs on plain tensors (the single device).
* The JAX package: ``serve_step.build_prefill`` / ``build_decode`` under
  the same rules, jitted, on 4 forced CPU devices (a subprocess a mesh,
  with
  ``XLA_FLAGS``, an ``AxisType.Auto`` mesh: the package's ``shard``
  refuses ``Explicit`` axes), each package feeding its own greedy
  tokens.

Bounds: tokens equal; the logits of the prefill and of every step
within ``ATOL`` = 1e-4 of the single device and of JAX's sharded run
(the bound ``tests/test_torch_serve.py`` holds the port to JAX with;
the JAX package's own sharded logits are within 7.4e-6 of its single
device on these configs); every cache leaf gathered with
``full_tensor()`` after the last step within ``ATOL`` + ``ATOL``·|ref|
elementwise.  The cache's relative term is the JAX package's own
spread: its sharded Jamba cache at B = 8 on (1, 4) is 1.26e-4 from its
single device's on a layer-7 conv tail whose values reach 4.0, where
the port's sharded cache is within 6.4e-5 of JAX's single device and
3.5e-5 of its own.  After the prefill and after every step the
cache's placements equal ``cache_shardings``, and a decode step's write
changed only the owning rank's slots of the step's position: each
rank's local cache is compared before and after.
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
from repro.sharding.rules import init_params as jinit_params  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ("yi-6b", "mamba2-370m", "deepseek-v2-236b", "jamba-v0.1-52b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
BATCHES = (4, 8)
PROMPT, MAX_SEQ, STEPS = 16, 24, 4
ATOL = 1e-4
RANK_TIMEOUT = 300
SEED = 0

_JAX = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import get_config, smoke_config
from repro.runtime import serve_step
from repro.sharding.rules import make_rules

work, spec, mname = sys.argv[2], json.loads(sys.argv[3]), sys.argv[4]
shape = spec["meshes"][mname]


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


for arch in spec["archs"]:
    cfg = smoke_config(get_config(arch))
    data = np.load(f"{work}/{arch}.npz")
    params = unflatten({k[2:]: data[k] for k in data if k[:2] == "p/"})
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rules = make_rules(mesh, "serve")
    prefill = jax.jit(serve_step.build_prefill(
        cfg, rules, max_seq=spec["max_seq"]))
    decode = jax.jit(serve_step.build_decode(cfg, rules))
    for B in spec["batches"]:
        logits, cache = prefill(
            params, {"tokens": jnp.asarray(data[f"prompt{B}"])})
        lgs, toks = [np.asarray(logits)], []
        for i in range(spec["steps"]):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            logits, cache = decode(params, cache, {
                "token": tok,
                "pos": jnp.asarray(spec["prompt"] + i, jnp.int32)})
            lgs.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits, -1)))
        np.savez(f"{work}/jax-{arch}-{mname}-{B}.npz",
                 logits=np.stack(lgs), tokens=np.stack(toks),
                 **{f"c/{k}": v for k, v in flat(cache).items()})
print("JAX_OK")
"""

_RANK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import serve_step
from repro_torch.sharding.rules import make_rules

rank, world, store, work, mname = (int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4], sys.argv[5], sys.argv[6])
spec = json.loads(sys.argv[7])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
mesh = make_mesh(tuple(spec["meshes"][mname]), ("data", "model"), "cpu")
rules = make_rules(mesh, "serve")


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
            out[f"{prefix}{k}"] = v
    return out


def run(cfg, params, prompt, rules, on_step):
    prefill = serve_step.build_prefill(cfg, rules, max_seq=spec["max_seq"])
    decode = serve_step.build_decode(cfg, rules)
    feed = (lambda d: d) if rules is None else \
        (lambda d: serve_step.place_inputs(d, rules))
    full = (lambda t: t) if rules is None else (lambda t: t.full_tensor())
    logits, cache = prefill(params, feed({"tokens": prompt}))
    logits = full(logits)
    on_step(cache, None)
    lgs, toks = [logits], []
    for i in range(spec["steps"]):
        tok = torch.argmax(logits, -1)
        toks.append(tok)
        pos = spec["prompt"] + i
        before = {k: v.to_local().clone() for k, v in flat(cache).items()} \
            if rules is not None else None
        logits, cache = decode(params, cache, feed({"token": tok,
                                                    "pos": pos}))
        logits = full(logits)
        on_step(cache, (pos, before))
        lgs.append(logits)
    toks.append(torch.argmax(logits, -1))
    return (torch.stack(lgs).numpy(), torch.stack(toks).numpy(),
            {k: full(v).numpy() for k, v in flat(cache).items()})


SEQ_LEAVES = ("k", "v", "ckv", "kpe")

out = {}
for arch in spec["archs"]:
    cfg = smoke_config(get_config(arch))
    data = np.load(f"{work}/{arch}.npz")
    params = params_from_numpy(
        cfg, unflatten({k[2:]: data[k] for k in data if k[:2] == "p/"}),
        "cpu")
    dparams = serve_step.place_params(cfg, params, rules)
    for B in spec["batches"]:
        want = flat(serve_step.cache_shardings(cfg, B, spec["max_seq"],
                                               rules))
        rec = {"placements": [], "writes": [], "owns": []}

        def on_step(cache, step):
            got = flat(cache)
            rec["placements"].append(all(
                isinstance(got[k], DTensor)
                and tuple(got[k].placements) == want[k].placements
                for k in want) and set(got) == set(want))
            if step is None:
                return
            pos, before = step
            ok, owned = True, set()
            for k, t in got.items():
                if k.split("/")[-1] not in SEQ_LEAVES:
                    continue
                # (layers, B, Smax, ...): the sequence is dim 2
                shape, off = compute_local_shape_and_global_offset(
                    t.shape, t.device_mesh, t.placements)
                diff = (t.to_local() != before[k]).flatten(3).any(-1)
                idx = sorted({off[2] + int(j)
                              for j in diff.nonzero()[:, 2].tolist()})
                owns = off[2] <= pos < off[2] + shape[2]
                ok = ok and idx == ([pos] if owns else [])
                owned.add(owns)
            rec["writes"].append(ok)
            rec["owns"].append(sorted(owned))

        prompt = torch.from_numpy(data[f"prompt{B}"])
        lg, tk, cache = run(cfg, dparams, prompt, rules, on_step)
        out[f"{arch}-{B}"] = rec
        if rank == 0:
            plg, ptk, pcache = run(cfg, params, prompt, None,
                                   lambda *a: None)
            np.savez(f"{work}/port-{arch}-{mname}-{B}.npz", logits=lg,
                     tokens=tk, plain_logits=plg, plain_tokens=ptk,
                     **{f"c/{k}": v for k, v in cache.items()},
                     **{f"pc/{k}": v for k, v in pcache.items()})
with open(f"{work}/port-{mname}-rank{rank}.json", "w") as f:
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
    return {"archs": list(ARCHS),
            "meshes": {k: list(v) for k, v in MESHES.items()},
            "batches": list(BATCHES), "prompt": PROMPT,
            "max_seq": MAX_SEQ, "steps": STEPS}


def _wait(procs, marker):
    outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and marker in so, se[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocesses and both meshes' ranks run side by side; yields
    (work dir, each mesh's ranks' records)."""
    work = tmp_path_factory.mktemp("sharded_serve")
    rng = np.random.default_rng(SEED)
    for i, arch in enumerate(ARCHS):
        jc = jsmoke_config(jget_config(arch))
        jp = jinit_params(JM.schema(jc), jax.random.key(i))
        np.savez(work / f"{arch}.npz",
                 **{f"p/{k}": v for k, v in _flat(jp).items()},
                 **{f"prompt{B}": rng.integers(0, jc.vocab_size,
                                               (B, PROMPT)).astype(np.int32)
                    for B in BATCHES})
    spec = json.dumps(_spec())
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")

    def start(*argv):
        return subprocess.Popen([sys.executable, "-c", *argv],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)

    procs = [start(_JAX, SRC, str(work), spec, m) for m in MESHES]
    ranks = {}
    for mname, shape in MESHES.items():
        world = shape[0] * shape[1]
        store = work / f"store-{mname}"
        ranks[mname] = [start(_RANK, SRC, str(r), str(world), str(store),
                              str(work), mname, spec) for r in range(world)]
        procs += ranks[mname]
    try:
        _wait(procs[:len(MESHES)], "JAX_OK")
        _wait(procs[len(MESHES):], "RANK_OK")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    recs = {m: [json.load(open(work / f"port-{m}-rank{r}.json"))
                for r in range(len(ranks[m]))] for m in MESHES}
    return work, recs


CASES = [(m, a, b) for m in MESHES for a in ARCHS for b in BATCHES]


def _load(work, who, arch, mname, B):
    return np.load(work / f"{who}-{arch}-{mname}-{B}.npz")


def _caches(npz, prefix):
    return {k[len(prefix):]: npz[k] for k in npz if k.startswith(prefix)}


@pytest.mark.parametrize("mname,arch,B", CASES)
def test_sharded_serve_equals_single_device(runs, mname, arch, B):
    work, _ = runs
    got = _load(work, "port", arch, mname, B)
    np.testing.assert_array_equal(got["tokens"], got["plain_tokens"])
    assert got["logits"].shape == (STEPS + 1, B, got["logits"].shape[-1])
    np.testing.assert_allclose(got["logits"], got["plain_logits"],
                               atol=ATOL, rtol=0)
    sharded, plain = _caches(got, "c/"), _caches(got, "pc/")
    assert sharded and set(sharded) == set(plain)
    for k in plain:
        np.testing.assert_allclose(sharded[k], plain[k], atol=ATOL,
                                   rtol=ATOL, err_msg=k)


@pytest.mark.parametrize("mname,arch,B", CASES)
def test_sharded_serve_equals_jax_sharded(runs, mname, arch, B):
    work, _ = runs
    got = _load(work, "port", arch, mname, B)
    want = _load(work, "jax", arch, mname, B)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], atol=ATOL,
                               rtol=0)
    port, ref = _caches(got, "c/"), _caches(want, "c/")
    assert port and set(port) == set(ref)
    for k in ref:
        assert port[k].shape == ref[k].shape, k
        np.testing.assert_allclose(port[k], ref[k], atol=ATOL, rtol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("mname,arch,B", CASES)
def test_cache_placements_equal_cache_shardings(runs, mname, arch, B):
    """On every rank, after the prefill and after each decode step."""
    recs = runs[1][mname]
    for r in recs:
        assert r[f"{arch}-{B}"]["placements"] == [True] * (STEPS + 1), r


@pytest.mark.parametrize("mname,arch,B", CASES)
def test_decode_write_touches_only_the_owning_shard(runs, mname, arch, B):
    """Each step changed exactly the step's position in the local cache
    of the ranks whose shard holds it, and nothing elsewhere; some rank
    does not hold it where the sequence is sharded."""
    recs = runs[1][mname]
    for r in recs:
        assert r[f"{arch}-{B}"]["writes"] == [True] * STEPS, r
    if arch == "mamba2-370m":             # no cache leaf has a sequence
        assert all(r[f"{arch}-{B}"]["owns"] == [[]] * STEPS for r in recs)
        return
    for i in range(STEPS):
        owns = [r[f"{arch}-{B}"]["owns"][i] for r in recs]
        assert [True] in owns and [False] in owns, owns


def test_serve_cli_runs_on_the_host_mesh_with_the_serve_rules(monkeypatch):
    """``main`` builds ``make_host_mesh()`` (a one-rank gloo group here)
    and ``make_rules(mesh, "serve")``, serves through them and closes
    the group it started."""
    import torch.distributed as dist

    from repro_torch.launch import serve as cli
    from repro_torch.sharding.rules import SERVE_RULES, mesh_shape

    seen = []
    real = cli.serve

    def spy(*args, **kw):
        seen.append(kw.get("rules"))
        return real(*args, **kw)

    monkeypatch.setattr(cli, "serve", spy)
    running = dist.is_initialized()
    res = cli.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                    "--gen", "4"])
    assert dist.is_initialized() == running
    (rules,) = seen
    assert rules.rules == SERVE_RULES
    assert mesh_shape(rules.mesh) == {"data": 1, "model": 1}
    assert res.tokens.shape == (4, 4) and type(res.tokens) is torch.Tensor
    assert torch.isfinite(res.last_logits).all()


@pytest.mark.parametrize("arch", ARCHS + ("whisper-large-v3",
                                          "qwen2-vl-72b"))
def test_serve_with_rules_equals_without_on_one_rank(arch):
    """``serve(..., rules=...)`` on the one-rank gloo mesh (every
    placement ``Replicate()``) against ``serve`` on plain tensors, with
    the inputs the CLI draws: tokens equal and logits bitwise, but for
    DeepSeek-V2, whose MoE layers take expert parallelism on the mesh
    and the grouped path off it (logits within 1e-6, f32)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve as cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.sharding.rules import make_rules

    cfg = smoke_config(get_config(arch))
    params = cli.make_params(cfg, torch.device("cpu"), seed=0)
    rng = torch.Generator().manual_seed(1)
    prompts = cli.make_prompts(cfg, 4, 12, rng)
    inputs = cli.make_inputs(cfg, 4, 12, rng)
    c0 = dict(moe.MOE_CALLS)
    plain = cli.serve(cfg, params, prompts, 4, inputs=inputs)
    c1 = dict(moe.MOE_CALLS)
    own = not dist.is_initialized()
    try:
        rules = make_rules(make_host_mesh(device="cpu"), "serve")
        placed = cli.serve(cfg, params, prompts, 4, inputs=inputs,
                           rules=rules)
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()
    c2 = dict(moe.MOE_CALLS)
    assert torch.equal(placed.tokens, plain.tokens)
    assert placed.launches == plain.launches
    tol = 0.0
    if cfg.moe is not None and cfg.moe.ep_over_dp:
        tol = 1e-6
        assert c1["ep"] == c0["ep"] and c1["grouped"] > c0["grouped"]
        assert c2["ep"] - c1["ep"] == c1["grouped"] - c0["grouped"]
        assert c2["grouped"] == c1["grouped"]
    for got, want in ((placed.first_logits, plain.first_logits),
                      (placed.last_logits, plain.last_logits)):
        assert type(got) is torch.Tensor
        assert float((got - want).abs().max()) <= tol


# ---------------------------------------------------------------------------
# on the card: the one-rank NCCL mesh
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_card_one_rank_mesh_serve_equals_plain(arch):
    """``serve`` on ``make_host_mesh()`` (one NCCL rank) against
    ``serve`` on plain tensors, from the same parameters: tokens equal,
    logits bitwise (DeepSeek-V2's, expert parallelism against the
    grouped path, within 1e-5 in f32), each kernel launched as often
    (the kernels, not the plain versions, run under DTensor).  Head dims
    widened to 32, which the card's flash kernel takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import MLAConfig
    from repro_torch.launch import serve as cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import make_rules

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = smoke_config(get_config(arch))
    if cfg.mla is not None:
        cfg = dataclasses.replace(cfg, mla=MLAConfig(
            q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=24,
            qk_rope_head_dim=8, v_head_dim=32))
    elif cfg.head_dim:
        cfg = dataclasses.replace(cfg, head_dim=32)
    params = cli.make_params(cfg, dev, seed=0)
    prompts = cli.make_prompts(cfg, 4, 64,
                               torch.Generator(device=dev).manual_seed(1))
    plain = cli.serve(cfg, params, prompts, 6)
    own = not dist.is_initialized()
    try:
        rules = make_rules(make_host_mesh(), "serve")
        placed = cli.serve(cfg, params, prompts, 6, rules=rules)
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()
    assert torch.equal(placed.tokens, plain.tokens)
    assert placed.launches == plain.launches
    tol = 1e-5 if cfg.moe is not None and cfg.moe.ep_over_dp else 0.0
    for got, want in ((placed.first_logits, plain.first_logits),
                      (placed.last_logits, plain.last_logits)):
        assert float((got - want).abs().max()) <= tol
