"""The port's lint suite (``repro_torch.analysis``, DESIGN.md §18).

The copied pieces are held to the JAX package's on the JAX suite's own
fixtures (read from ``tests/test_lint.py`` by path); each new rule has a
clean and a flagged fixture; real faults re-injected into copies of the
port's sources must each be caught, while the real tree stays clean in
under 10 s; the CLI keeps ``scripts/lint.py``'s flags, exit codes and
JSON schema.  One ``gpu`` test calls the libraries' size queries.
"""
import ast
import json
import pathlib
import shutil
import subprocess
import sys
import textwrap
import time
import types

import pytest

torch = pytest.importorskip("torch")

import repro.analysis as J  # noqa: E402
import repro_torch.analysis as P  # noqa: E402
from repro_torch.analysis import csrc, smem_budget  # noqa: E402
from repro_torch.analysis.csrc import CEval, CEvalError, CudaSource  # noqa
from repro_torch.analysis.symeval import SymEval, SymEvalError  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
KERNELS = PORT / "kernels"
RULE_IDS = {"smem-budget", "async-pairing", "sim-determinism", "host-sync",
            "design-citations"}


def _fixtures() -> dict[str, str]:
    """``tests/test_lint.py``'s module-level fixture strings, read by
    path: each ``NAME = textwrap.dedent('''...''')``."""
    tree = ast.parse((ROOT / "tests" / "test_lint.py").read_text())
    out = {}
    for st in tree.body:
        if isinstance(st, ast.Assign) and isinstance(st.value, ast.Call) \
                and getattr(st.value.func, "attr", "") == "dedent":
            out[st.targets[0].id] = textwrap.dedent(
                ast.literal_eval(st.value.args[0]))
    return out


FIXTURES = _fixtures()


def _same(jax_findings, port_findings) -> bool:
    return [f.to_dict() for f in jax_findings] == \
        [f.to_dict() for f in port_findings]


# ---------------------------------------------------------------------------
# the copies, held to the JAX package
# ---------------------------------------------------------------------------


def test_fixtures_were_found():
    assert {"SIM_BAD", "SIM_GOOD", "VMEM_RESIDENT", "VMEM_DISPATCH",
            "TRACER_BAD", "DMA_GOOD"} <= set(FIXTURES)


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("where", ["src/repro/sim/toy.py",
                                   "src/repro/fwi/toy.py"])
def test_sim_determinism_matches_jax(name, where):
    src = FIXTURES[name]
    got = P.analyze_source(src, P.SimDeterminismRule(), filename=where)
    want = J.analyze_source(src, J.SimDeterminismRule(), filename=where)
    assert _same(want, got)
    if name == "SIM_BAD" and "sim" in where:
        assert len(got) == 10


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_design_citations_match_jax(name, tmp_path):
    (tmp_path / "DESIGN.md").write_text("# §1 — intro\n\n## §2.5 — tiling\n")
    src = FIXTURES[name] + '\n"""DESIGN.md §1, §2.5, §9 and DESIGN.md §3"""\n'
    got = P.analyze_source(src, P.DesignCitationsRule(), filename="src/x.py",
                           root=tmp_path)
    want = J.analyze_source(src, J.DesignCitationsRule(), filename="src/x.py",
                            root=tmp_path)
    assert _same(want, got) and len(got) == 2


SUPPRESSIONS = [
    ("import random  # lint: disable=sim-determinism -- fixture\n", 0),
    ("# lint: disable=sim-determinism -- a justification that\n"
     "# spans two comment lines\nimport random\n", 0),
    ("import random  # lint: disable=host-sync\n", 1),
    ("import random  # lint: disable=all\n", 0),
    ("# lint: disable=sim-determinism -- above a blank line\n\n"
     "import random\nimport random\n", 1),
]


@pytest.mark.parametrize("src,n", SUPPRESSIONS)
def test_suppressions_match_jax(src, n):
    got = P.analyze_source(src, P.SimDeterminismRule(),
                           filename="src/repro/sim/toy.py")
    want = J.analyze_source(src, J.SimDeterminismRule(),
                            filename="src/repro/sim/toy.py")
    assert _same(want, got) and len(got) == n


def test_suppressions_on_every_flagged_line_match_jax():
    lines = FIXTURES["SIM_BAD"].splitlines()
    for i in range(len(lines)):
        src = "\n".join(ln + ("  # lint: disable=sim-determinism"
                              if j == i else "")
                        for j, ln in enumerate(lines)) + "\n"
        got = P.analyze_source(src, P.SimDeterminismRule(),
                               filename="src/repro/sim/toy.py")
        want = J.analyze_source(src, J.SimDeterminismRule(),
                                filename="src/repro/sim/toy.py")
        assert _same(want, got)


SYMEVAL_CALLS = [
    ("VMEM_RESIDENT", "resident_vmem_bytes",
     {"nz": 512, "nx": 256, "k": 4, "s": 3}),
    ("VMEM_RESIDENT", "stream_vmem_bytes",
     {"nz": 512, "nx": 256, "bz": 32, "k": 4}),
    ("VMEM_DISPATCH", "should_stream",
     {"nz": 1024, "nx": 128, "k": 2, "vmem_budget": 10 ** 6}),
    ("VMEM_DISPATCH", "should_stream",
     {"nz": 1024, "nx": 128, "k": 2, "vmem_budget": 10 ** 7, "s": 2}),
    ("VMEM_STREAM", "resident_vmem_bytes", {"nz": 8, "nx": 8, "k": 1}),
    ("VMEM_STREAM", "missing_function", {}),
    ("VMEM_STREAM", "stream_vmem_bytes", {"nz": 8}),          # missing args
    ("VMEM_DISPATCH", "should_stream", {"nz": 8, "nx": 8, "k": 1,
                                        "vmem_budget": None}),
]


def _symeval_result(mod, src, fname, kwargs):
    tree = ast.parse(src)
    try:
        return ("ok", mod.SymEval(tree).call(fname, kwargs=kwargs))
    except mod.SymEvalError as e:
        return ("error", str(e))


@pytest.mark.parametrize("fixture,fname,kwargs", SYMEVAL_CALLS, ids=str)
def test_symeval_matches_jax_on_the_fixtures(fixture, fname, kwargs):
    from repro.analysis import symeval as jsym
    from repro_torch.analysis import symeval as psym

    src = FIXTURES[fixture]
    assert _symeval_result(psym, src, fname, kwargs) == \
        _symeval_result(jsym, src, fname, kwargs)


SYMEVAL_EXPRS = ["nz * nx", "bz if bz else 4", "[x for x in (1, 2)]",
                 "spec", "unknown_name", "min(nz, bz) // 2", "-(-nz // bz)",
                 "nz > 4 and bz", "(nz, bz)", "nz ** 2 % 7"]


@pytest.mark.parametrize("expr", SYMEVAL_EXPRS)
def test_symeval_scope_matches_jax(expr):
    from repro.analysis import symeval as jsym
    from repro_torch.analysis import symeval as psym

    tree = ast.parse(FIXTURES["VMEM_STREAM"])
    scope = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.name == "wave_block_stream_pallas")
    node = ast.parse(expr, mode="eval").body
    out = []
    for mod in (jsym, psym):
        ev = mod.SymEval(tree, env={"nz": 64, "nx": 32, "bz": 8},
                         scope=scope)
        try:
            out.append(("ok", repr(ev.eval(node))))
        except mod.SymEvalError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]


SIM_FILES = sorted(p.name for p in (ROOT / "src/repro/sim").glob("*.py"))


@pytest.mark.parametrize("name", SIM_FILES)
def test_both_sim_determinism_rules_agree_on_both_sims(name):
    orig = (ROOT / "src/repro/sim" / name).read_text()
    port = (PORT / "sim" / name).read_text()
    for src, rel in ((orig, f"src/repro/sim/{name}"),
                     (port, f"src/repro_torch/sim/{name}")):
        got = P.analyze_source(src, P.SimDeterminismRule(), filename=rel)
        want = J.analyze_source(src, J.SimDeterminismRule(), filename=rel)
        assert _same(want, got) and got == []


def test_injected_dict_loop_flags_the_same_line_in_both_sims():
    old = "for j in self.jobs:"
    lines = []
    for mod, rel in ((J, "src/repro/sim/fleet.py"),
                     (P, "src/repro_torch/sim/fleet.py")):
        src = (ROOT / rel).read_text()
        assert old in src
        fs = mod.analyze_source(src.replace(old, "for _t, _u in "
                                            "usage.items():", 1),
                                mod.SimDeterminismRule(), filename=rel)
        assert len(fs) == 1 and "dict view" in fs[0].message
        lines.append((fs[0].line, fs[0].col, fs[0].message))
    assert lines[0] == lines[1]


# ---------------------------------------------------------------------------
# the evaluators' additions
# ---------------------------------------------------------------------------

SYM_SRC = textwrap.dedent('''\
    SHAPES = ((8, 2, 256), (4, 2, 512), (4, 1, 768))


    def window(k, tz):
        return tz + 2 * k, 2 * tz


    def pick(k, tz):
        wz, wx = window(k, tz)
        for rows, ctas, limit in SHAPES:
            if wz * rows <= limit:
                return rows, ctas
        return None


    def first(k, tz):
        return (pick(k, tz) or (8, 1))[0]


    def rule(dtype, h):
        hb = 2 if dtype == torch.bfloat16 and h > 1 else 1
        return {"hb": hb, "grid": (h, hb)}


    def looped_while(n):
        while n:
            n = n - 1
        return n


    def breaks():
        for s in SHAPES:
            break
        return 1
''')


@pytest.mark.parametrize("call,args,env,want", [
    ("window", [2, 32], {}, (36, 64)),
    ("pick", [0, 16], {}, (8, 2)),
    ("pick", [2, 32], {}, (4, 2)),
    ("pick", [50, 32], {}, (4, 1)),
    ("pick", [400, 32], {}, None),
    ("first", [400, 32], {}, 8),
    ("rule", ["bf16", 4], {"torch.bfloat16": "bf16"}, {"hb": 2,
                                                       "grid": (4, 2)}),
    ("rule", ["f32", 4], {"torch.bfloat16": "bf16"}, {"hb": 1,
                                                      "grid": (4, 1)}),
])
def test_symeval_additions(call, args, env, want):
    ev = SymEval(ast.parse(SYM_SRC), env=env)
    assert ev.call(call, args) == want


@pytest.mark.parametrize("call,args", [
    ("looped_while", [3]), ("breaks", []), ("rule", ["bf16", 4]),
])
def test_symeval_rest_of_python_still_raises(call, args):
    with pytest.raises(SymEvalError):
        SymEval(ast.parse(SYM_SRC)).call(call, args)


def test_symeval_imports_and_subscripts():
    tree = ast.parse("def f(i):\n    return (1, 2, 3)[i] + LIMIT\n")
    assert SymEval(tree, imports={"LIMIT": 10}).call("f", [2]) == 13
    with pytest.raises(SymEvalError):
        SymEval(tree).call("f", [2])
    with pytest.raises(SymEvalError):
        SymEval(tree, imports={"LIMIT": 10}).call("f", [7])


CU_SRC = textwrap.dedent('''\
    #include <cuda_runtime.h>
    namespace {
    constexpr int HALO = 2;
    constexpr int LDT = 64 + 4;   // a comment
    template <int D>
    struct Tile {
        static constexpr int RB = 2 * D < 128 ? 2 * D : 128;
        static constexpr int BYTES = 64 * D * 2;
    };
    template <int R>
    __host__ __device__ constexpr int rows(int wz)
    {
        return (wz + R - 1) / R * R;
    }
    template <int A, int B>
    constexpr size_t pick()
    {
        return (size_t)A * LDT > (size_t)64 * B ? (size_t)A * LDT
                                                : (size_t)64 * B;
    }
    size_t plain(int n, int p)
    {
        const size_t a = (n + 63) / 64, b = (size_t)64 * p * 2;
        return 1024 + (a > b ? a : b);
    }
    template <int D>
    void host(int k)
    {
        using T = Tile<D>;
        const int w = k * HALO, v = T::RB;
        auto lam = [&](int t) { return w + (t & 1) * 8; };
    }
    }  // namespace
''')


@pytest.mark.parametrize("expr,env,want", [
    ("rows<8>(37)", {}, 40),
    ("Tile<32>::RB + Tile<128>::BYTES", {}, 64 + 16384),
    ("pick<32, 32>()", {}, 32 * 68),
    ("pick<192, 128>()", {}, 192 * 68),
    ("plain(a.N, 64)", {"a.N": 128}, 1024 + 8192),
    ("sizeof(float) * sizeof(__nv_bfloat16) + sizeof(uint64_t)"
     " + sizeof(float4)", {}, 32),
    ("(int)(7 / 2) - 7 % 3 + (1 << 4) + (0xF0 >> 4) - (6 & 3) + (4 | 1)"
     " + (5 ^ 1) + ~0 + !0", {}, 3 - 1 + 16 + 15 - 2 + 5 + 4 - 1 + 1),
    ("-7 / 2", {}, -3),
    ("HALO * 1024u", {}, 2048),
])
def test_c_evaluator_forms(expr, env, want):
    src = CudaSource("toy.cu", text=CU_SRC)
    assert CEval(src, env=env).eval_text(expr) == want


def test_c_evaluator_scope_locals_lambdas_and_aliases():
    src = CudaSource("toy.cu", text=CU_SRC)
    ev = CEval(src, env={"D": 32, "k": 3}, scope=src.function("host"))
    assert ev.eval_text("w + v") == 6 + 64
    assert [ev.eval_text(f"lam({t})") for t in range(3)] == [6, 14, 6]


@pytest.mark.parametrize("expr", [
    "undefined_name", "rows<8>", "sizeof(double)", "(double)3",
    "Tile<32>::MISSING", "plain(1)", "f(3)", "1.5f", "x.y",
])
def test_c_evaluator_refuses_the_rest(expr):
    src = CudaSource("toy.cu", text=CU_SRC)
    with pytest.raises(CEvalError):
        CEval(src).eval_text(expr)


def test_cu_suppressions():
    lines = ["int a;  // lint: disable=smem-budget -- why",
             "// lint: disable=host-sync,async-pairing -- a block",
             "// more",
             "int b;", "int c;"]
    m = csrc.suppression_map(lines)
    assert m[1] == {"smem-budget"} and m[4] == {"host-sync", "async-pairing"}
    assert 5 not in m


# ---------------------------------------------------------------------------
# each new rule: a clean fixture and a flagged one
# ---------------------------------------------------------------------------


def _toy_kernels(tmp_path, cu: str, py: str = "X = 1\n") -> pathlib.Path:
    kdir = tmp_path / "src" / "repro_torch" / "kernels"
    (kdir / "toy" / "csrc").mkdir(parents=True)
    (kdir / "build.py").write_text("MAX_SMEM_BYTES = 232448\n")
    (kdir / "toy" / "kernel.py").write_text(py)
    (kdir / "toy" / "csrc" / "toy.cu").write_text(cu)
    return kdir


def _run(rule, tmp_path, paths=("src/repro_torch",)):
    analyzer = P.Analyzer([rule], tmp_path)
    return analyzer.run(analyzer.load(list(paths)))


TOY_LAUNCH = textwrap.dedent('''\
    __global__ void k(float* x) { x[0] = 0.f; }
    int launch(float* x, int n, cudaStream_t s)
    {
        const size_t smem = (size_t)n * sizeof(float);
        k<<<1, 32, SMEM, s>>>(x);
        return 0;
    }
''')


@pytest.mark.parametrize("smem,n", [
    ("smem", 1),                     # an unmapped dynamic-smem launch
    ("0", 0),                        # no dynamic shared memory
    ("smem  // lint: disable=smem-budget -- a toy", 0),
])
def test_smem_budget_unmapped_launch(tmp_path, smem, n):
    cu = TOY_LAUNCH.replace("SMEM", smem.split("  //")[0])
    if "disable" in smem:
        cu = cu.replace("k<<<", "// lint: disable=smem-budget -- a toy\n"
                                "    k<<<")
    _toy_kernels(tmp_path, cu)
    fs = _run(P.SmemBudgetRule(), tmp_path)
    assert len(fs) == n
    if n:
        assert "no formula mapping" in fs[0].message
        assert fs[0].file.endswith("toy.cu")


def test_smem_budget_two_budgets_and_a_large_one(tmp_path):
    kdir = _toy_kernels(tmp_path, TOY_LAUNCH.replace("SMEM", "0"))
    (kdir / "toy" / "extra.py").write_text("MAX_SMEM_BYTES = 232448\n")
    assert "a second MAX_SMEM_BYTES" in _run(P.SmemBudgetRule(),
                                             tmp_path)[0].message
    (kdir / "toy" / "extra.py").unlink()
    (kdir / "build.py").write_text("MAX_SMEM_BYTES = 300000\n")
    fs = _run(P.SmemBudgetRule(), tmp_path)
    assert len(fs) == 1 and "exceeds sm_90" in fs[0].message


RING = textwrap.dedent('''\
    __device__ void mbar_init(uint32_t bar)
    {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar));
    }
    __device__ void mbar_expect(uint32_t bar, uint32_t bytes)
    {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(bytes));
    }
    __device__ void mbar_wait(uint32_t bar, uint32_t parity)
    {
        asm volatile("mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;"
                     :: "r"(bar), "r"(parity));
    }
    __device__ void tma(uint32_t dst, uint32_t bar, int r)
    {
        mbar_expect(bar, 1024);
        asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global"
                     ".mbarrier::complete_tx::bytes [%0], [%1, {%2}], [%3];"
                     :: "r"(dst), "l"(0), "r"(r), "r"(bar));
    }
    __global__ void ring(int n)
    {
        __shared__ uint64_t bars[2];
        const uint32_t b0 = (uint32_t)__cvta_generic_to_shared(bars);
        const uint32_t base = (uint32_t)__cvta_generic_to_shared(bars) + 64;
        auto st = [&](int t) { return base + (t & 1) * 1024; };
        auto bar = [&](int t) { return b0 + 8 * (t & 1); };
        auto par = [](int t) { return (uint32_t)(t >> 1) & 1u; };
        const int nt = n / 64;
        if (threadIdx.x == 0) {
            for (int i = 0; i < 2; ++i) mbar_init(b0 + 8 * i);
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
            tma(st(0), bar(0), 0);
            if (nt > 1) tma(st(1), bar(1), 64);
        }
        __syncthreads();
        for (int t = 0; t < nt; ++t) {
            mbar_wait(bar(t), par(t));
            __syncthreads();
            if (threadIdx.x == 0 && t + 2 < nt)
                tma(st(t + 2), bar(t + 2), (t + 2) * 64);
        }
    }
''')


@pytest.mark.parametrize("old,new,frag", [
    (None, None, None),
    ("mbar_wait(bar(t), par(t));", "", "never waited"),
    ("mbar_wait(bar(t), par(t));", "mbar_wait(bar(t), par(t + 1));",
     "phase parity"),
    ('asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");',
     "", "no fence.mbarrier_init"),
    ("tma(st(t + 2), bar(t + 2)", "tma(st(t + 1), bar(t + 2)",
     "fills stage"),
    ("t + 2 < nt", "t + 3 < nt", "deadlock"),
])
def test_async_pairing_fixture(tmp_path, old, new, frag):
    cu = RING if old is None else RING.replace(old, new)
    assert old is None or old in RING
    _toy_kernels(tmp_path, cu)
    fs = _run(P.AsyncPairingRule(), tmp_path)
    if frag is None:
        assert fs == []
    else:
        assert fs and all(frag in f.message for f in fs[:1]), fs


HOT_GOOD = textwrap.dedent('''\
    import torch


    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, causal: bool, n: int):
            k = int(x.shape[0])
            c = int(causal) + int(n) + len(x.shape)
            return _helper(x) * k * c

        @staticmethod
        def backward(ctx, g):
            return g, None, None


    def _helper(x):
        return x * 2


    def setup(x):
        return x.cpu().numpy(), float(x.sum()), print(x)
''')

HOT_BAD = textwrap.dedent('''\
    import numpy as np
    import torch
    from torch.utils.checkpoint import checkpoint


    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            y = _helper(x)
            return y + float(x.sum())

        @staticmethod
        def backward(ctx, g):
            print(g)
            return g.cpu()


    def _helper(x):
        return x * x.sum().item()


    @torch.library.custom_op("toy::op", mutates_args=())
    def op(x: torch.Tensor) -> torch.Tensor:
        return torch.nonzero(x) + torch.where(x > 0)[0]


    def layer(x):
        def inner(y):
            return np.asarray(y.tolist())
        return checkpoint(inner, x)
''')


def test_host_sync_fixture_clean():
    assert P.analyze_source(HOT_GOOD, P.HostSyncRule(),
                            filename="src/repro_torch/models/toy.py") == []


def test_host_sync_fixture_flagged():
    fs = P.analyze_source(HOT_BAD, P.HostSyncRule(),
                          filename="src/repro_torch/models/toy.py")
    blob = "\n".join(f"{f.line} {f.message}" for f in fs)
    for frag in ("`float()` of a value that is not static in hot `forward`",
                 "`.item()` in hot `_helper`", "`print()` in hot `backward`",
                 "`.cpu()` in hot `backward`", "`torch.nonzero` in hot `op`",
                 "one-argument `torch.where` in hot `op`",
                 "`np.asarray` in hot `inner`", "`.tolist()` in hot `inner`"):
        assert frag in blob, (frag, blob)
    assert len(fs) == 8


def test_host_sync_follows_imports_across_modules(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "runtime").mkdir(parents=True)
    (pkg / "models").mkdir()
    (pkg / "runtime" / "serve_step.py").write_text(textwrap.dedent('''\
        from repro_torch.models import model as M
        from repro_torch.models.model import other


        def build_decode(cfg):
            def fn(params, cache, inputs):
                return M.decode_step(cfg, inputs), other(inputs)
            return fn
    '''))
    (pkg / "models" / "model.py").write_text(textwrap.dedent('''\
        def decode_step(cfg, inputs):
            return int(inputs["pos"])


        def other(x):
            return x.item()


        def not_hot(x):
            return x.item()
    '''))
    fs = _run(P.HostSyncRule(), tmp_path)
    assert [(pathlib.Path(f.file).name, f.line) for f in fs] == [
        ("model.py", 2), ("model.py", 6)]


# ---------------------------------------------------------------------------
# real faults re-injected into copies of the port's sources
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_copy(tmp_path_factory):
    """A copy of the port (and DESIGN.md) to inject faults into; each
    test edits one file and puts it back."""
    root = tmp_path_factory.mktemp("port")
    shutil.copytree(PORT, root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "DESIGN.md", root / "DESIGN.md")
    return root


INJECTIONS = [
    ("kernels/flash_attention/kernel.py",
     "return 1024 + ((1 + STAGES) * d + STAGES * dv) * TILE_ROWS * 2",
     "return 1024 + ((1 + STAGES) * d + STAGES * dv) * TILE_ROWS * 3",
     "smem-budget", "drifts from flash_smem_bytes"),
    ("kernels/flash_attention/csrc/flash_attention.cu",
     "return 1024 + (size_t)(1 + STAGES) * TileShape<DQK>::BYTES",
     "return 2048 + (size_t)(1 + STAGES) * TileShape<DQK>::BYTES",
     "smem-budget", "drifts from flash_smem_bytes"),
    ("kernels/build.py", "MAX_SMEM_BYTES = 232448", "MAX_SMEM_BYTES = 300000",
     "smem-budget", "exceeds sm_90"),
    ("kernels/flash_attention/csrc/flash_attention.cu",
     "    mbar_wait(vbar(nt - 1), par(nt - 1));\n", "",
     "async-pairing", "is never waited"),
    ("kernels/flash_attention/csrc/flash_attention.cu",
     "mbar_wait(kbar(t), par(t));", "mbar_wait(kbar(t), par(t + 1));",
     "async-pairing", "phase parity"),
    ("kernels/flash_attention/csrc/flash_attention.cu",
     '        asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: '
     '"memory");\n', "",
     "async-pairing", "no fence.mbarrier_init"),
    ("kernels/ssd/csrc/ssd_chunk.cu",
     '        asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: '
     '"memory");\n        mbar_expect(b0, ncb * BLK);',
     "        mbar_expect(b0, ncb * BLK);",
     "async-pairing", "no fence.mbarrier_init"),
    ("models/attention.py",
     "    out = _attend(q, kk, vv, causal)",
     "    out = _attend(q, kk, vv, causal) * x.sum().item()",
     "host-sync", "`.item()` in hot `apply_attn_full`"),
    ("kernels/rmsnorm/csrc/rmsnorm_residual.cu",
     "    rmsnorm_residual_kernel<T, VEC, NV><<<grid, block, smem, "
     "a.stream>>>(",
     "    cudaDeviceSynchronize();\n"
     "    rmsnorm_residual_kernel<T, VEC, NV><<<grid, block, smem, "
     "a.stream>>>(",
     "host-sync", "`cudaDeviceSynchronize` in the host function `launch`"),
    ("kernels/stencil/tune.py", "if smem_bytes(k, *t) <= MAX_SMEM_BYTES",
     "if smem_bytes(k, *t) <= 2 * MAX_SMEM_BYTES",
     "smem-budget", "block_candidates must keep"),
    ("kernels/ssd/kernel.py", "        smem = simt_smem_bytes(N, P)",
     "        smem = simt_smem_bytes(N, P) + 16",
     "smem-budget", "launch_rule's smem_bytes"),
]


@pytest.mark.parametrize("rel,old,new,rule,frag", INJECTIONS,
                         ids=lambda v: v if isinstance(v, str) and len(v) < 40
                         else None)
def test_injected_fault_is_caught(port_copy, rel, old, new, rule, frag):
    path = port_copy / "src" / "repro_torch" / rel
    pristine = path.read_text()
    assert pristine.count(old) == 1, old
    rule_obj = next(r for r in P.default_rules() if r.name == rule)
    paths = ["src/repro_torch"] if rule == "host-sync" else [
        "src/repro_torch/kernels", "src/repro_torch/configs"]
    if rule != "host-sync":       # (the whole tree's test holds the copy)
        assert _run(rule_obj, port_copy, paths) == []
    path.write_text(pristine.replace(old, new))
    try:
        fs = _run(rule_obj, port_copy, paths)
    finally:
        path.write_text(pristine)
    assert fs and any(frag in f.message for f in fs), \
        P.render_human(fs)


# ---------------------------------------------------------------------------
# the real tree, the table the card checks, the CLI
# ---------------------------------------------------------------------------


def test_the_port_is_clean_under_its_rules_in_under_10s():
    from repro_torch.analysis.__main__ import default_paths

    t0 = time.perf_counter()
    analyzer = P.Analyzer(P.default_rules(), ROOT)
    ctxs = analyzer.load(default_paths(ROOT))
    findings = analyzer.run(ctxs)
    dt = time.perf_counter() - t0
    assert len(ctxs) > 100
    assert findings == [], P.render_human(findings)
    assert dt < 10.0, dt


def test_every_suppression_in_the_port_is_justified():
    """``# lint: disable=<rule> -- why`` (``//`` in a ``.cu`` file): a
    known rule and a reason after the rule list."""
    import re

    files = [*PORT.rglob("*.py"), *KERNELS.glob("*/csrc/*.cu"),
             *(ROOT / "examples").glob("torch_*.py"), ROOT / "chip_smoke.py"]
    marks = 0
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            m = re.search(r"(#|//)\s*lint:\s*disable=([\w,-]+)(.*)", line)
            if m is None or "analysis" in path.parts:
                continue
            marks += 1
            assert set(m.group(2).split(",")) <= RULE_IDS, (path, n)
            why = m.group(3).strip()
            assert why.startswith("--") and len(why) > 12, (path, n, line)
    assert marks >= 9


def test_every_dynamic_smem_launch_is_mapped():
    launches = []
    for cu in sorted(KERNELS.glob("*/csrc/*.cu")):
        src = CudaSource(cu)
        for fn, idx in src.launches():
            args = smem_budget._launch_args(fn, idx)
            if [t.text for t in args[2]] != ["0"]:
                launches.append((cu.stem, fn.name))
    assert sorted(launches) == sorted(smem_budget.LAUNCH_FORMULAS)
    assert len({stem for stem, _ in launches}) == 4


def test_launch_table_configurations():
    rows = smem_budget.launch_table(KERNELS)
    by = {}
    for r in rows:
        by.setdefault((pathlib.Path(r["source"]).stem, r["launch"]),
                      []).append(r)
        assert r["dynamic"] == r["python"]
        assert r["dynamic"] + r["static"] <= 232448
    flash = {(r["config"]["d"], r["config"]["dv"])
             for r in by[("flash_attention", "launch_bf16")]}
    assert flash == {(32, 32), (64, 64), (128, 128), (192, 128)}
    # the SSD configurations: every registered config's (N, P) and its
    # smoke variant's, with and without shared B and C
    from repro_torch.configs import REGISTRY, smoke_config

    ssm = {(c.ssm.d_state, c.ssm.head_dim) for c in REGISTRY.values()
           if c.ssm is not None}
    ssm |= {(smoke_config(c).ssm.d_state, smoke_config(c).ssm.head_dim)
            for c in REGISTRY.values() if c.ssm is not None}
    got = {(r["config"]["n"], r["config"]["p"])
           for r in by[("ssd_chunk", "launch_wgmma")]}
    assert got == ssm
    assert {r["config"]["hb"] for r in by[("ssd_chunk", "launch_wgmma")]} \
        == {1, 2}
    d_models = {c.d_model for c in REGISTRY.values()} | {
        smoke_config(c).d_model for c in REGISTRY.values()}
    norm = by[("rmsnorm_residual", "launch")]
    assert {r["config"]["d"] for r in norm} == d_models
    # both dtypes on both paths, prefill and decode shapes
    assert {(r["config"]["T"], r["config"]["vec"]) for r in norm} == {
        ("float", 4), ("float", 1), ("__nv_bfloat16", 8),
        ("__nv_bfloat16", 1)}
    assert {r["config"]["rows"] for r in norm} > {1}
    # the stencil tuner's kept candidates are all checked
    from repro_torch.kernels.stencil import tune

    kept = {(t, k) for t, k in tune.block_candidates()}
    checked = {((r["config"]["tz"], r["config"]["tx"]), r["config"]["k"])
               for r in by[("wave_block", "launch")]}
    assert kept <= checked


def test_static_smem_matches_the_cards_ptxas_report():
    """The layout ptxas reported for these kernels on the H100 (the
    build phase's report): flash's 5 barriers in 48 bytes, the SSD
    kernel's barriers and decay rows in 544 / 1056, the norm none (its
    sums are dynamic, ``rmsnorm_smem_bytes``)."""
    rows = {(pathlib.Path(r["source"]).stem, r["kernel"], tuple(r["targs"])):
            r["static"] for r in smem_budget.launch_table(KERNELS)}
    assert rows[("flash_attention", "flash_fwd_bf16_kernel", (128, 128))] \
        == 48
    assert rows[("ssd_chunk", "ssd_wgmma_kernel", (64, 1))] == 544
    assert rows[("ssd_chunk", "ssd_wgmma_kernel", (64, 2))] == 1056
    assert rows[("rmsnorm_residual", "rmsnorm_residual_kernel",
                 ("float", 4, 4))] == 0
    assert rows[("wave_block", "wave_block_shots_kernel", (8, 2))] == 0


def _cli(*args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args], cwd=cwd,
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def _main(capsys, *args):
    """The CLI's ``main(argv)`` in this process, answered as ``_cli``'s
    subprocess is: ``returncode``, ``stdout``, ``stderr``."""
    from repro_torch.analysis.__main__ import main

    try:
        rc = main(list(args))
    except SystemExit as exc:          # argparse refuses the arguments
        rc = exc.code
    out = capsys.readouterr()
    return types.SimpleNamespace(returncode=rc, stdout=out.out,
                                 stderr=out.err)


def test_cli_clean_tree_and_json_schema(tmp_path, capsys):
    out = tmp_path / "lint.json"
    proc = _main(capsys, "--ci", "--json", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro-lint (port):" in proc.stdout
    doc = json.loads(out.read_text())
    assert doc["version"] == 1 and doc["count"] == 0
    assert doc["findings"] == [] and set(doc["rules"]) == RULE_IDS


def test_cli_fails_on_an_injected_violation(tmp_path, capsys):
    bad = tmp_path / "sim"
    bad.mkdir()
    (bad / "toy.py").write_text("import random\n")
    proc = _main(capsys, "--rules", "sim-determinism", str(bad), "--json",
                 str(tmp_path / "out.json"))
    assert proc.returncode == 1
    assert "sim-determinism" in proc.stdout
    doc = json.loads((tmp_path / "out.json").read_text())
    assert doc["count"] == 1 and doc["rules"] == ["sim-determinism"]
    assert set(doc["findings"][0]) == {"file", "line", "col", "rule",
                                       "message"}


def test_cli_list_rules_and_unknown_rule(capsys):
    # the one run through ``python -m``: the module's entry point
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    assert {ln.split()[0] for ln in proc.stdout.splitlines()} == RULE_IDS
    assert _main(capsys, "--list-rules").stdout == proc.stdout
    proc = _main(capsys, "--rules", "bogus")
    assert proc.returncode == 2 and "unknown rule" in proc.stderr


@pytest.mark.gpu
def test_size_queries_equal_the_formulas_on_the_card():
    """Each ``.cu`` size query equals its Python formula (and the rule's
    static value) at every configuration the launches are checked at."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import ctypes

    from repro_torch.kernels import build

    libs = build.build_all()
    rows = smem_budget.launch_table(KERNELS)
    for row in rows:
        qname, keys = row["query"]
        fn = getattr(ctypes.CDLL(str(libs[pathlib.Path(row["source"]).stem])),
                     qname)
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_int] * len(keys)
        got = fn(*[int(row["config"][k]) for k in keys])
        assert got == row["python"] == row["dynamic"], row
