"""The launch layer's cost tools against the JAX package's, on the CPU.

* ``launch/hw.py``: ``TPU_V5E`` and the pod helpers equal the JAX
  package's field for field; ``spec_for`` picks each card the smoke
  names by its data-sheet peaks.
* ``launch/roofline.py``: ``roofline_terms`` and ``model_flops`` equal
  the JAX package's on a grid of inputs, each chip passed to both.
* ``launch/op_cost.py``: ``_collective_wire_bytes`` and
  ``shot_batch_strip_bytes`` equal ``hlo_cost``'s; on a fake 16-rank
  group (a subprocess: the group is global to a process) a sharded
  product counts the rank's shard, a replicated one the whole, and an
  all-gather over "pod" counts as cross-pod; the FLOPs of the smoke
  Yi-6B and Granite-8B prefill and train step equal
  ``hlo_cost.analyze`` of the compiled JAX function on one CPU device
  (within 1 %; measured equal: on the CPU both packages compute every
  (query, key) score, the port's plain attention and JAX's chunked
  attention alike, and the plain norm is elementwise, so no causal
  half and no norm term parts them); each registered LM op is charged
  its kernel's FLOP and byte formulas.
* ``sharding/rules.py::local_shape_and_offset`` equals torch's
  ``compute_local_shape_and_global_offset`` at every coordinate.

The ``gpu`` test holds each registered op bitwise to its bare ctypes
call on the card.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.launch import hlo_cost as jhlo  # noqa: E402
from repro.launch import hw as jhw  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.runtime import serve_step as JSS  # noqa: E402
from repro.runtime import train_step as JTS  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import RunConfig, get_config, smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fo  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rk  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as ro  # noqa: E402
from repro_torch.kernels.ssd import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd import ops as so  # noqa: E402
from repro_torch.launch import hw, op_cost, roofline  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.runtime import serve_step as SS  # noqa: E402
from repro_torch.runtime import train_step as TS  # noqa: E402
from repro_torch.sharding.rules import local_shape_and_offset  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: counted FLOPs against hlo_cost's, as a share
FLOPS_SHARE = 0.01


# ---------------------------------------------------------------------------
# hw and roofline
# ---------------------------------------------------------------------------


def test_tpu_spec_and_pod_helpers_equal_jax():
    for f in dataclasses.fields(jhw.ChipSpec):
        assert getattr(hw.TPU_V5E, f.name) == getattr(jhw.TPU_V5E, f.name)
    assert hw.TPU_V5E.peak_flops_f32 is None
    for chips in (1, 16, 256, 512):
        for spec in (hw.TPU_V5E, hw.H100_SXM):
            assert hw.pod_flops(chips, spec) == jhw.pod_flops(chips, spec)
            assert hw.pod_hbm_bw(chips, spec) == jhw.pod_hbm_bw(chips, spec)
            assert hw.pod_ici_bw(chips, spec) == jhw.pod_ici_bw(chips, spec)
        assert hw.pod_flops(chips) == jhw.pod_flops(chips)


#: the card names nvidia-smi reports -> (spec, HBM bytes/s, f32 FLOP/s,
#: dense bf16 FLOP/s), the data sheets' peaks the smoke's bounds use
CARDS = {
    "NVIDIA H100 80GB HBM3": (hw.H100_SXM, 3.35e12, 67e12, 989e12),
    "NVIDIA H100 PCIe": (hw.H100_PCIE, 2.0e12, 51e12, 756e12),
    "NVIDIA H100 NVL": (hw.H100_NVL, 3.9e12, 60e12, 835e12),
    "NVIDIA H200": (hw.H200, 4.8e12, 67e12, 989e12),
}


@pytest.mark.parametrize("name", sorted(CARDS))
def test_spec_for_picks_each_card(name):
    spec, bw, f32, bf16 = CARDS[name]
    got = hw.spec_for(name)
    assert got is spec
    assert (got.hbm_bw, got.peak_flops_f32, got.peak_flops_bf16) == (
        bw, f32, bf16)
    assert got.dci_bw == jhw.TPU_V5E.dci_bw


def test_spec_for_raises_on_an_unknown_card():
    with pytest.raises(KeyError):
        hw.spec_for("NVIDIA A100-SXM4-80GB")


def test_h100_spec():
    h = hw.H100_SXM
    assert (h.peak_flops_bf16, h.hbm_bw, h.hbm_bytes) == (989e12, 3.35e12,
                                                          80 * 10**9)
    # NVLink 4: 18 links of 25 GB/s a direction
    assert (h.ici_link_bw, h.ici_links) == (25e9, 18)


HC_GRID = [{}, {"collective_bytes": 3.2e9},
           {"collective_bytes": 5e9, "collective_dci_bytes": 1e9},
           {"collective_bytes": 7e8, "collective_dci_bytes": 7e8}]


@pytest.mark.parametrize("chip", ["tpu_v5e", "h100_sxm"])
def test_roofline_terms_equal_jax(chip):
    port = {"tpu_v5e": hw.TPU_V5E, "h100_sxm": hw.H100_SXM}[chip]
    jchip = jhw.TPU_V5E if chip == "tpu_v5e" else port
    for flops in (0.0, 1e9, 3.3e14, 7e17):
        for nbytes in (0.0, 1e6, 8.2e11, 4e13):
            for hc in HC_GRID:
                got = roofline.roofline_terms(flops, nbytes, hc, chip=port)
                want = jroofline.roofline_terms(flops, nbytes, hc,
                                                chip=jchip)
                assert got == want


def test_roofline_defaults_to_the_h100():
    hc = {"collective_bytes": 1e9}
    assert roofline.roofline_terms(1e12, 1e9, hc) == \
        jroofline.roofline_terms(1e12, 1e9, hc, chip=hw.H100_SXM)


def test_model_flops_equal_jax():
    for n in (1, 370_000_000, 6_061_035_520):
        for tokens in (1, 128, 4096 * 256):
            for train in (True, False):
                assert roofline.model_flops(n, tokens, train=train) == \
                    jroofline.model_flops(n, tokens, train=train)


# ---------------------------------------------------------------------------
# op_cost: the copied formulas
# ---------------------------------------------------------------------------


OPCODES = ["all-gather", "all-gather-start", "all-reduce", "all-reduce-start",
           "reduce-scatter", "all-to-all", "collective-permute",
           "collective-permute-start", "collective-broadcast"]


@pytest.mark.parametrize("opcode", OPCODES)
def test_wire_bytes_equal_hlo_cost(opcode):
    for gsize in (0, 1, 2, 3, 4, 16, 256, 512):
        for nbytes in (0, 1, 4096, 123456789):
            assert op_cost._collective_wire_bytes(opcode, nbytes, gsize) == \
                jhlo._collective_wire_bytes(opcode, nbytes, gsize)


def test_shot_batch_strip_bytes_equal_hlo_cost():
    for nz, nx in ((600, 600), (4096, 4096), (37, 53)):
        for s in (1, 2, 4, 8):
            for k in (1, 4, 8):
                for db in (2, 4):
                    assert op_cost.shot_batch_strip_bytes(nz, nx, s, k, db) \
                        == jhlo.shot_batch_strip_bytes(nz, nx, s, k, db)


# ---------------------------------------------------------------------------
# op_cost on a fake 16-rank group
# ---------------------------------------------------------------------------

_FAKE_GROUP = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch.op_cost import OpCostMode

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
dm = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
pm = init_device_mesh("cpu", (4, 4), mesh_dim_names=("pod", "data"))
out = {}


def run(key, fn, mesh):
    with OpCostMode(mesh) as m:
        fn()
    out[key] = m.result()


def dt(shape, mesh, placements):
    local = list(shape)
    for j, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(j)
    return DTensor.from_local(torch.ones(local), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.ones(shape).stride())


a = dt((64, 4096), dm, (Shard(0), Replicate()))
b = dt((4096, 1024), dm, (Replicate(), Shard(1)))
run("sharded", lambda: a @ b, dm)
ar = dt((64, 4096), dm, (Replicate(), Replicate()))
br = dt((4096, 1024), dm, (Replicate(), Replicate()))
run("replicated", lambda: ar @ br, dm)
x = dt((64, 256), pm, (Shard(0), Replicate()))
run("gather_pod", lambda: x.redistribute(pm, (Replicate(), Replicate())), pm)
y = dt((64, 256), pm, (Replicate(), Shard(0)))
run("gather_data", lambda: y.redistribute(pm, (Replicate(), Replicate())), pm)
print(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def fake_group():
    res = subprocess.run([sys.executable, "-c", _FAKE_GROUP], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_sharded_product_counts_the_local_shard(fake_group):
    got = fake_group["sharded"]
    # (64/4 × 4096) @ (4096 × 1024/4): this rank's block, no collective
    assert got["flops"] == 2 * 16 * 4096 * 256
    assert got["hbm_bytes"] == 4 * (16 * 4096 + 4096 * 256 + 16 * 256)
    assert got["collective_bytes"] == 0


def test_replicated_product_counts_the_whole(fake_group):
    got = fake_group["replicated"]
    assert got["flops"] == 2 * 64 * 4096 * 1024
    assert got["hbm_bytes"] == 4 * (64 * 4096 + 4096 * 1024 + 64 * 1024)


def test_all_gather_over_pod_counts_as_dci(fake_group):
    whole = 64 * 256 * 4
    pod, data = fake_group["gather_pod"], fake_group["gather_data"]
    for got in (pod, data):
        assert got["collective_by_type"] == {"all-gather": whole * 3 / 4}
        assert got["collective_count"] == 1
        assert got["collective_bytes"] == whole * 3 / 4
    assert pod["collective_dci_bytes"] == pod["collective_bytes"]
    assert data["collective_dci_bytes"] == 0


# ---------------------------------------------------------------------------
# op_cost against hlo_cost on the smoke models
# ---------------------------------------------------------------------------


def _smoke(arch):
    jc, tc = jsmoke_config(jget_config(arch)), smoke_config(get_config(arch))
    jp = jinit_params(JM.schema(jc), jax.random.key(0))
    return jc, jp, tc


@pytest.mark.parametrize("arch", ["yi-6b", "granite-8b"])
@pytest.mark.parametrize("step", ["prefill", "train"])
def test_flops_equal_hlo_cost(arch, step):
    jc, jp, tc = _smoke(arch)
    B, S = (2, 64) if step == "prefill" else (4, 64)
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, (B, S))
    if step == "prefill":
        fn = jax.jit(JSS.build_prefill(jc))
        text = fn.lower(jp, {"tokens": jnp.asarray(toks, jnp.int32)}) \
            .compile().as_text()
        params = init_params(M.schema(tc), torch.Generator().manual_seed(0),
                             "cpu")
        with op_cost.OpCostMode() as mode:
            SS.build_prefill(tc)(params, {"tokens": torch.as_tensor(toks)})
    else:
        jopt = jmake_optimizer("adamw", jconstant(1e-3))
        fn = jax.jit(JTS.build_train_step(jc, JRunConfig(loss_chunk=16),
                                          jopt))
        jstate = {"params": jp, "opt": jopt.init(jp),
                  "step": jnp.zeros((), jnp.int32)}
        jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
                  "loss_mask": jnp.ones((B, S), jnp.float32)}
        text = fn.lower(jstate, jbatch).compile().as_text()
        opt = make_optimizer("adamw", constant(1e-3))
        params = init_params(M.train_schema(tc),
                             torch.Generator().manual_seed(0), "cpu")
        batch = {"tokens": torch.as_tensor(toks),
                 "loss_mask": torch.ones(B, S)}
        step_fn = TS.build_train_step(tc, RunConfig(loss_chunk=16), opt)
        with op_cost.OpCostMode() as mode:
            step_fn(TS.new_state(params, opt), batch)
    want = jhlo.analyze(text, total_devices=1)["flops"]
    assert want > 0
    assert abs(mode.flops / want - 1) <= FLOPS_SHARE, (mode.flops, want)
    assert mode.result()["while_trips"] == []


def test_analyze_returns_hlo_cost_keys():
    out, cost = op_cost.analyze(torch.matmul, torch.ones(4, 8),
                                torch.ones(8, 2))
    assert torch.equal(out, torch.full((4, 2), 8.0))
    jkeys = {"flops", "hbm_bytes", "collective_bytes",
             "collective_dci_bytes", "collective_by_type",
             "collective_count", "while_trips", "warnings"}
    assert jkeys <= set(cost)
    assert cost["flops"] == 2 * 4 * 8 * 2
    assert cost["hbm_bytes"] == 4 * (32 + 16 + 8)


def test_input_reads_count_each_region_once():
    w = torch.ones(3, 8, 8)                  # a stacked weight: 3 layers
    table = torch.ones(100, 8)
    ids = torch.tensor([1, 5, 7])
    with op_cost.OpCostMode() as mode:
        x = table[ids]                       # 3 rows of the table
        for i in range(3):
            x = x @ w[i]
            x = x @ w[i]                     # the same layer read again
    got = mode.input_read_bytes
    assert got == 4 * (3 * 64 + 3 * 8) + 8 * 3
    # the launch-boundary bytes count each product's operands and output
    assert mode.hbm_bytes > got


# ---------------------------------------------------------------------------
# the registered kernels: formulas, fakes
# ---------------------------------------------------------------------------


def _fake_cuda(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="cuda")


def test_registered_ops_are_charged_their_formulas():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q, k, v = (_fake_cuda(2, 8, 128, 128), _fake_cuda(2, 2, 128, 128),
                   _fake_cuda(2, 2, 128, 128))
        x, res = _fake_cuda(64, 4096), _fake_cuda(64, 4096)
        scale = _fake_cuda(4096, dtype=torch.float32)
        xdt = _fake_cuda(4, 8, 64, 64)
        b = _fake_cuda(4, 1, 64, 16).expand(4, 8, 64, 16)
        csum = _fake_cuda(4, 8, 64, dtype=torch.float32)
        with op_cost.OpCostMode() as m1:
            out = fo.attention(q, k, v, causal=True)
        with op_cost.OpCostMode() as m2:
            y, h = ro.rmsnorm_residual(x, res, scale)
        with op_cost.OpCostMode() as m3:
            yy, st = so.ssd_chunk(xdt, b, b, csum)
    assert out.shape == (2, 8, 128, 128) and out.stride() == (
        131072, 128, 1024, 1)
    assert m1.flops == fk.attention_flops(2, 8, 128, 128, True)
    assert m1.hbm_bytes == fk.attention_bytes(2, 8, 2, 128, 128, 2)
    assert m2.flops == rk.rmsnorm_flops(64, 4096)
    assert m2.hbm_bytes == rk.rmsnorm_bytes(64, 4096, 2)
    assert m3.flops == sk.ssd_flops(4, 8, 64, 16, 64)
    assert m3.hbm_bytes == sk.ssd_bytes(4, 8, 64, 16, 64, 2, 1)
    assert st.shape == (4, 8, 16, 64) and st.dtype == torch.float32
    # the formulas are the generic rule's: each input read once (a
    # stride-0 head axis once), each output written once
    tb = op_cost.tensor_bytes
    assert m1.hbm_bytes == sum(map(tb, (q, k, v, out)))
    assert m2.hbm_bytes == sum(map(tb, (x, res, scale, y, h)))
    assert m3.hbm_bytes == sum(map(tb, (xdt, b, b, csum, yy, st)))


def test_fake_implementations_check_what_the_kernels_take():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = _fake_cuda(1, 4, 16, 48)            # head dim 48: no kernel
        with pytest.raises(ValueError, match="head dims"):
            fo.attention(q, q, q, causal=True)
        x = _fake_cuda(4, 64)
        with pytest.raises(TypeError, match="scale"):
            rk.rmsnorm_residual_op(x, x, _fake_cuda(64), 1e-5)


# ---------------------------------------------------------------------------
# local shapes
# ---------------------------------------------------------------------------


class _Mesh:
    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def get_coordinate(self):
        return list(self.coord)

    def size(self, j):
        return self.shape[j]


def test_local_shape_and_offset_equals_torch():
    from itertools import product

    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset,
    )

    mesh_shape = (2, 3)
    n = 0
    for shape in ((8, 5), (7, 9), (3, 2), (16, 12), (1, 1), (5, 6, 7)):
        kinds = [Replicate()] + [Shard(d) for d in range(len(shape))]
        for pl in product(kinds, repeat=2):
            for coord in product(range(2), range(3)):
                want = _compute_local_shape_and_global_offset(
                    shape, mesh_shape, list(coord), pl)
                got = local_shape_and_offset(shape, _Mesh(mesh_shape, coord),
                                             pl)
                assert (tuple(got[0]), tuple(got[1])) == (
                    tuple(want[0]), tuple(want[1])), (shape, pl, coord)
                n += 1
    assert n > 300


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_registered_ops_equal_ctypes_calls_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        x, res = rand(37, 4096, dtype=dtype), rand(37, 4096, dtype=dtype)
        scale = rand(4096, dtype=torch.float32)
        q = rand(2, 8, 65, 128, dtype=dtype)
        k, v = rand(2, 2, 65, 128, dtype=dtype), rand(2, 2, 65, 128,
                                                       dtype=dtype)
        xdt = rand(4, 8, 64, 64, dtype=dtype)
        b, c = rand(4, 8, 64, 64, dtype=dtype), rand(4, 8, 64, 64,
                                                     dtype=dtype)
        csum = torch.cumsum(-rand(4, 8, 64, dtype=torch.float32).abs(), -1)
        before = (rk.rmsnorm_residual_cuda.launches,
                  fk.flash_attention_cuda.launches,
                  sk.ssd_chunk_cuda.launches)
        pairs = [
            (rk.rmsnorm_residual_op(x, res, scale, 1e-5),
             rk.rmsnorm_residual_cuda(x, res, scale, 1e-5)),
            ((fk.flash_attention_op(q, k, v, True),),
             (fk.flash_attention_cuda(q, k, v, causal=True),)),
            ((fk.flash_attention_op(q, k, v, False),),
             (fk.flash_attention_cuda(q, k, v, causal=False),)),
            (sk.ssd_chunk_op(xdt, b, c, csum),
             sk.ssd_chunk_cuda(xdt, b, c, csum)),
        ]
        torch.cuda.synchronize()
        assert (rk.rmsnorm_residual_cuda.launches,
                fk.flash_attention_cuda.launches,
                sk.ssd_chunk_cuda.launches) == tuple(
                    n + d for n, d in zip(before, (2, 4, 2)))
        for got, want in pairs:
            for a, w in zip(got, want):
                assert a.stride() == w.stride()
                assert torch.equal(a, w)
