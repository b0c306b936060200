"""``launch/live_bytes.py::LiveBytesMode``: exact byte counts of small
programs, on real CPU tensors and on fake CPU and CUDA ones.

* each program's live and peak bytes are what its storages hold: views
  share their storage, a freed intermediate leaves the count, in-place
  ops add nothing, ``Tensor.resize_`` and ``UntypedStorage.resize_``
  change a storage's count, autograd's saved tensors leave the count
  after backward;
* a CUDA fake counts its bytes in 512-byte blocks, a CPU tensor its
  bytes; real CPU tensors and fake ones count alike;
* AdamW's donated ``update_`` writes every leaf in place: the count
  after it is the state's, less the gradients it dropped;
* in a subprocess (a fake process group is global to its process), a
  DTensor op on a fake world of 1 and of 4 ranks counts the local
  shards only, with DTensor's sharding propagation forced to miss its
  cache inside the counted run.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.live_bytes import (  # noqa: E402
    CUDA_BLOCK,
    LiveBytesMode,
    storage_bytes,
)

ROOT = Path(__file__).resolve().parents[1]
N = 1000                                    # f32 elements: 4000 bytes


def _b(nbytes: int, device: str) -> int:
    return storage_bytes(nbytes, torch.device(device))


def _views(dev):
    x = torch.ones(N, device=dev)
    mode = LiveBytesMode()
    mode.track(x)
    with mode:
        y = x * 2
        views = (y.view(10, 100), y[::2], y.view(10, 100).t(), y.unsqueeze(0))
        one = mode.live
    del views
    return (one, mode.peak), (2 * _b(4 * N, dev), 2 * _b(4 * N, dev))


def _freed(dev):
    x = torch.ones(N, device=dev)
    mode = LiveBytesMode()
    mode.track(x)
    with mode:
        y = x + 1
        z = y * 3
        del y
        after = mode.live
    del z
    return (after, mode.peak, mode.live), (
        2 * _b(4 * N, dev), 3 * _b(4 * N, dev), _b(4 * N, dev))


def _in_place(dev):
    x = torch.ones(N, device=dev)
    mode = LiveBytesMode()
    mode.track(x)
    with mode:
        x.add_(1)
        x.mul_(x)
        x[:10].zero_()
        same = mode.live
        w = torch.empty(3, device=dev)
        w.resize_(2 * N)
        grown = mode.live
        w.untyped_storage().resize_(12)
        shrunk = mode.live
    return (same, grown, shrunk, mode.peak), (
        _b(4 * N, dev), _b(4 * N, dev) + _b(8 * N, dev),
        _b(4 * N, dev) + _b(12, dev), _b(4 * N, dev) + _b(8 * N, dev))


def _autograd(dev):
    w = torch.ones(N, device=dev, requires_grad=True)
    mode = LiveBytesMode()
    mode.track(w)
    with mode:
        h = torch.sin(w)                 # saved by the product below
        loss = (h * h).sum()
        del h
        before = mode.live
        loss.backward()
        after = mode.live
    # before: w, h (saved), the product (freed once summed) gone, loss;
    # after: w, its gradient and loss, h freed with the graph
    return (before, after), (2 * _b(4 * N, dev) + _b(4, dev),
                             2 * _b(4 * N, dev) + _b(4, dev))


PROGRAMS = {"views": _views, "freed": _freed, "in_place": _in_place,
            "autograd": _autograd}


def _on(kind: str, program):
    """``program`` on real CPU tensors or under the dry run's fake mode
    on ``cpu`` or ``cuda``: (got, want)."""
    if kind == "real":
        return program("cpu")
    with dr.fake_cuda():
        return program(kind.split("-")[1])


#: (program, tensors); autograd of a fake CUDA tensor needs a CUDA
#: build's device guard, so it runs on CPU tensors only
CASES = [(name, kind) for name in sorted(PROGRAMS)
         for kind in ("real", "fake-cpu", "fake-cuda")
         if not (name == "autograd" and kind == "fake-cuda")]


@pytest.mark.parametrize("name,kind", CASES)
def test_counts_a_program_exactly(name, kind):
    got, want = _on(kind, PROGRAMS[name])
    assert got == want


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_real_and_fake_tensors_count_alike(name):
    assert _on("real", PROGRAMS[name]) == _on("fake-cpu", PROGRAMS[name])


def test_cuda_storages_are_rounded_to_blocks():
    assert CUDA_BLOCK == 512
    with FakeTensorMode():
        for n in (1, 3, 128, 129, 1000):
            mode = LiveBytesMode()
            with mode:
                c = torch.empty(n, device="cuda")
                p = torch.empty(n, device="cpu")
            assert mode.peak == -(-4 * n // 512) * 512 + 4 * n
            del c, p


def test_donated_update_writes_in_place():
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import constant, make_optimizer

    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(64, 256, generator=gen),
              "b": torch.randn(256, generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in
             params.items()}
    opt = make_optimizer("adamw", constant(1e-3))
    state = opt.init(params)
    step = torch.zeros((), dtype=torch.int32)
    kept = tree_leaves({"params": params, "state": state})
    ptrs = [t.data_ptr() for t in kept]
    nbytes = sum(t.untyped_storage().nbytes() for t in kept)
    gbytes = sum(g.untyped_storage().nbytes() for g in grads.values())
    mode = LiveBytesMode()
    mode.track(*kept, *grads.values(), step)
    with mode:
        opt.update_(grads, state, params, step)
    assert all(g is None for g in grads.values())
    assert [t.data_ptr() for t in tree_leaves(
        {"params": params, "state": state})] == ptrs
    # every leaf written in place, the gradients dropped once used
    assert mode.live == nbytes + step.untyped_storage().nbytes()
    assert mode.peak > nbytes + gbytes      # the update's temporaries


_DTENSOR = r"""
import json
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from repro_torch.launch import dryrun as dr
from repro_torch.launch.live_bytes import LiveBytesMode
from repro_torch.launch.mesh import make_mesh

name = "_propagate_tensor_meta_non_cached"
misses = []
orig = ShardingPropagator.__dict__[name]


def counted(*args, **kwargs):
    misses.append(1)
    return orig(*args, **kwargs)


setattr(ShardingPropagator, name, counted)
out = {}
for ranks in (1, 4):
    with dr.fake_world(ranks):
        mesh = make_mesh((ranks,), ("data",), "cpu")
        with dr.fake_cuda():
            # a shape no op has seen: every op below misses the cache
            rows = 96 + 4 * ranks
            a = DTensor.from_local(torch.ones(rows // ranks, 40), mesh,
                                   [Shard(0)], run_check=False,
                                   shape=(rows, 40), stride=(40, 1))
            mode = LiveBytesMode()
            mode.track(a)
            del misses[:]
            with mode:
                b = a * 2 + 1
                c = b.sum(dim=1)
                # an all-gather over 4 ranks and its wait; none over 1
                e = b.redistribute(mesh, [Replicate()])
            out[ranks] = {"live": mode.live, "peak": mode.peak,
                          "misses": len(misses), "local": rows // ranks,
                          "rows": rows,
                          "b_local": list(b.to_local().shape),
                          "c_local": list(c.to_local().shape),
                          "e_local": list(e.to_local().shape)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def dtensor_counts(tmp_path_factory):
    home = tmp_path_factory.mktemp("live_bytes")
    res = subprocess.run([sys.executable, "-c", _DTENSOR], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin", "HOME": str(home)})
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("ranks", ["1", "4"])
def test_dtensor_op_counts_its_local_shard(dtensor_counts, ranks):
    got = dtensor_counts[ranks]
    rows = got["local"]
    assert got["b_local"] == [rows, 40] and got["c_local"] == [rows]
    assert got["e_local"] == [got["rows"], 40]
    assert got["misses"] >= 1, "the run hit DTensor's cache"
    shard = rows * 40 * 4
    # a, b and c; the gathered rows once (the wait returns its input),
    # where there is more than one rank (else e is b)
    gathered = got["rows"] * 40 * 4 if ranks != "1" else 0
    assert got["live"] == 2 * shard + rows * 4 + gathered
    # a, (a * 2) freed once 1 is added, b: before c and e
    assert got["peak"] == max(3 * shard, got["live"])
