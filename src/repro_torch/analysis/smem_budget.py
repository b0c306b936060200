"""smem-budget: tie the CUDA launches' shared memory to the Python formulas.

The port's counterpart of ``vmem-budget``.  Each kernel's dynamic
shared memory is sized twice: in C++ beside its launch
(``kernels/*/csrc/*.cu``) and in Python beside its wrapper
(``kernels/*/kernel.py``), where the wrapper's checks and the stencil
tuner's filter read it.  For every launch ``<<<grid, threads, SMEM,
stream>>>`` with a non-zero dynamic size this rule:

* evaluates both sides at every configuration the dispatch can launch
  — the C++ size through ``csrc.CEval``, the Python formula through
  ``symeval`` — and requires them EQUAL (both are exact integers);
  ``LAUNCH_FORMULAS`` pairs each launch with its formula and maps a
  configuration onto each side's arguments;
* adds the launched kernel's static ``__shared__`` arrays (laid out as
  ptxas reports them: declaration order, each at its alignment, the
  whole in 16-byte granules) and requires the sum to fit the one
  ``MAX_SMEM_BYTES``, which must not exceed sm_90's 227 KB a block;
* pins the stencil tuner's filter (``tune.py::block_candidates``) to
  the same formula and the same ``MAX_SMEM_BYTES`` the wrapper's
  launch check compares against.

The configurations: every (k, tile) of the stencil tuner's sweep that
the wrapper launches; every (DQK, DV) pair the flash entry
instantiates, f32 and bf16; for every SSD config (d_state, head_dim)
and every ``d_model`` written in ``configs/*.py``, the SSD kernel's
(N, PT, HB) that ``ssd/kernel.py::launch_rule`` picks with and without
shared B and C, and the norm's shape that ``rmsnorm/kernel.py::launch_shape``
picks at that row width, in both dtypes, aligned and not, at
``NORM_ROWS`` rows.

A side that cannot be evaluated, and a dynamic-smem launch with no
mapping, are findings.  ``// lint: disable=smem-budget -- why`` in the
``.cu`` file silences a launch there.  ``launch_table`` gives the
evaluated sizes to the card's check (``chip_smoke.py`` phase ``lint``).
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Callable, Iterator

from repro_torch.analysis.core import FileContext, Finding
from repro_torch.analysis.csrc import (
    CEval,
    CEvalError,
    CudaSource,
    Tok,
    _match,
    _split_commas,
    cu_sources,
    parse_number,
)
from repro_torch.analysis.symeval import SymEval, SymEvalError

RULE = "smem-budget"

#: shared memory one block may use on sm_90, static and dynamic
#: together, with the opt-in attribute (CUDA C++ Programming Guide,
#: compute capability 9.0: 227 KB)
SM90_SMEM_PER_BLOCK = 232448

#: ptxas reserves a kernel's static shared memory in 16-byte granules
STATIC_GRANULE = 16

#: the norm's row counts its launches are checked at: a prefill block
#: (rows a CTA by width) and a decode batch (one row a CTA)
NORM_ROWS = (8192, 4)

#: stand-ins for the dtypes ``launch_rule`` compares against
BF16, F32 = "torch.bfloat16", "torch.float32"
DTYPES = {BF16: BF16, F32: F32}


@dataclasses.dataclass(frozen=True)
class LaunchMap:
    """One dynamic-smem launch: its Python formula, the configurations
    it is checked at (``space``), each side's arguments, and the
    library's size query that the card checks."""

    formula: str
    space: str
    cxx: Callable[[dict], dict]
    py: Callable[[dict], tuple]
    query: tuple[str, tuple[str, ...]]


#: (source stem, launching function) -> mapping
LAUNCH_FORMULAS = {
    ("wave_block", "launch"): LaunchMap(
        "smem_bytes", "stencil",
        cxx=lambda c: {"R": c["rows"], "CTAS": c["ctas"], "k": c["k"],
                       "tz": c["tz"], "tx": c["tx"]},
        py=lambda c: (c["k"], c["tz"], c["tx"]),
        query=("wave_block_smem_bytes", ("k", "tz", "tx", "rows"))),
    ("flash_attention", "launch_simt"): LaunchMap(
        "flash_simt_smem_bytes", "flash_f32",
        cxx=lambda c: {"DQK": c["d"], "DV": c["dv"]},
        py=lambda c: (c["d"], c["dv"]),
        query=("flash_smem_query", ("d", "dv", "bf16"))),
    ("flash_attention", "launch_bf16"): LaunchMap(
        "flash_smem_bytes", "flash_bf16",
        cxx=lambda c: {"DQK": c["d"], "DV": c["dv"]},
        py=lambda c: (c["d"], c["dv"]),
        query=("flash_smem_query", ("d", "dv", "bf16"))),
    ("ssd_chunk", "launch_simt"): LaunchMap(
        "simt_smem_bytes", "ssd_f32",
        cxx=lambda c: {"P": c["pt"], "a.N": c["n"]},
        py=lambda c: (c["n"], c["pt"]),
        query=("ssd_smem_query", ("n", "pt", "hb", "wgmma"))),
    ("ssd_chunk", "launch_wgmma"): LaunchMap(
        "wg_smem_bytes", "ssd_bf16",
        cxx=lambda c: {"PT": c["pt"], "HB": c["hb"], "a.N": c["n"]},
        py=lambda c: (c["n"], c["pt"], c["hb"]),
        query=("ssd_smem_query", ("n", "pt", "hb", "wgmma"))),
    ("rmsnorm_residual", "launch"): LaunchMap(
        "rmsnorm_smem_bytes", "norm",
        cxx=lambda c: {"T": c["T"], "VEC": c["vec"], "NV": c["nv"],
                       "a.rows": c["rows"], "a.tpr": c["tpr"]},
        py=lambda c: (c["rows"], c["warps"]),
        query=("rmsnorm_smem_query", ("rows", "warps"))),
}


# ---------------------------------------------------------------------------
# reading the sources
# ---------------------------------------------------------------------------


def _launch_args(fn, idx: int) -> list[list[Tok]]:
    """The ``<<<...>>>`` arguments of the launch at ``fn.body[idx]``."""
    body = fn.body
    end = idx + 1
    while body[end].text != ">>>":
        end += 1
    return _split_commas(body[idx + 1:end])


def _launched_kernel(fn, idx: int) -> tuple[str, list[Tok]]:
    """(kernel name, template-argument tokens) of the launch at
    ``fn.body[idx]``; a local ``auto* fn = kernel<...>;`` is followed."""
    body = fn.body
    j = idx - 1
    if body[j].text == ">":
        depth = 0
        while j >= 0:
            if body[j].text == ">":
                depth += 1
            elif body[j].text == "<":
                depth -= 1
                if depth == 0:
                    break
            j -= 1
        return body[j - 1].text, body[j + 1:idx - 1]
    name = body[j].text
    decl = fn.decls().get(name)
    if decl is not None and decl.init and decl.init[0].kind == "id":
        init = decl.init
        if len(init) > 2 and init[1].text == "<":
            close = _match(init, 1, "<", ">")
            return init[0].text, init[2:close]
        return init[0].text, []
    return name, []


def static_smem_bytes(src: CudaSource, kernel: str, targs: list) -> int:
    """Static ``__shared__`` bytes of ``kernel<targs...>``: its arrays
    in declaration order, each at its alignment, rounded up to whole
    ``STATIC_GRANULE``s (the layout ptxas reports)."""
    fn = src.function(kernel)
    env = dict(zip(fn.tparams, targs))
    ev = CEval(src, env=env)
    offset = 0
    for arr in fn.shared_arrays():
        elem = env.get(arr.elem, arr.elem)
        size = ev.eval_text(f"sizeof({elem})")
        align = arr.align or size
        count = 1
        for dim in arr.dims:
            count *= ev.eval(dim)
        offset = -(-offset // align) * align + size * count
    return -(-offset // STATIC_GRANULE) * STATIC_GRANULE


def switch_targs(src: CudaSource, func: str, callee: str
                 ) -> dict[int, list[int]]:
    """``case N: ... return callee<A, B>(...)`` in ``func`` ->
    {N: [A, B]} (cases that fall through share the next call)."""
    toks = src.function(func).body
    out, pending = {}, []
    for i, t in enumerate(toks):
        if t.text == "case" and toks[i + 2].text == ":":
            pending.append(parse_number(toks[i + 1].text))
        elif t.text == "break" or t.text == "default":
            pending = []
        elif t.text == callee and i + 1 < len(toks) \
                and toks[i + 1].text == "<":
            close = _match(toks, i + 1, "<", ">")
            args = [parse_number(a[0].text)
                    for a in _split_commas(toks[i + 2:close])]
            for case in pending:
                out[case] = args
            pending = []
    return out


def template_calls(src: CudaSource, func: str, callee: str
                   ) -> list[list[int]]:
    """Every ``callee<A, B>`` instantiation written in ``func``."""
    toks = src.function(func).body
    out = []
    for i, t in enumerate(toks):
        if t.text == callee and toks[i + 1].text == "<":
            close = _match(toks, i + 1, "<", ">")
            args = [parse_number(a[0].text)
                    for a in _split_commas(toks[i + 2:close])]
            if args not in out:
                out.append(args)
    return out


class _Tree:
    """A parsed Python module: the rule's file set, else the disk."""

    def __init__(self, ctxs: list[FileContext]):
        self.by_path = {c.path.resolve(): c for c in ctxs}
        self._disk: dict[pathlib.Path, ast.Module] = {}

    def tree(self, path: pathlib.Path) -> ast.Module | None:
        path = path.resolve()
        if path in self.by_path:
            return self.by_path[path].tree
        if path not in self._disk:
            if not path.is_file():
                return None
            self._disk[path] = ast.parse(path.read_text(), filename=str(path))
        return self._disk[path]


def _config_literals(configs: pathlib.Path, tree_of) -> dict:
    """d_model and SSM (d_state, head_dim) values written as literals
    in ``configs/*.py`` (``SSMConfig``'s defaults from ``base.py``)."""
    d_models, ssm = set(), set()
    defaults = {"d_state": None, "head_dim": None}
    base = tree_of(configs / "base.py")
    if base is not None:
        for node in ast.walk(base):
            if isinstance(node, ast.ClassDef) and node.name == "SSMConfig":
                for st in node.body:
                    if isinstance(st, ast.AnnAssign) and isinstance(
                            st.target, ast.Name) and st.target.id in defaults \
                            and isinstance(st.value, ast.Constant):
                        defaults[st.target.id] = st.value.value
    for path in sorted(configs.glob("*.py")):
        tree = tree_of(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = getattr(node.func, "id", getattr(node.func, "attr", ""))
            kw = {k.arg: k.value for k in node.keywords}
            if "d_model" in kw and isinstance(kw["d_model"], ast.Constant):
                d_models.add(kw["d_model"].value)
            if name == "SSMConfig":
                vals = dict(defaults)
                for key in vals:
                    if key in kw:
                        vals[key] = kw[key].value if isinstance(
                            kw[key], ast.Constant) else None
                if None not in vals.values():
                    ssm.add((vals["d_state"], vals["head_dim"]))
    return {"d_model": sorted(d_models), "ssm": sorted(ssm)}


class _Kernels:
    """The kernels directory as the rule sees it: each ``kernel.py``'s
    tree, its ``.cu`` sources, the configs and ``MAX_SMEM_BYTES``."""

    def __init__(self, kernels: pathlib.Path, trees: _Tree):
        self.dir = kernels
        self.trees = trees
        self.max_defs: list[tuple[pathlib.Path, int, object]] = []
        for path in sorted(kernels.rglob("*.py")):
            tree = trees.tree(path)
            for st in tree.body if tree is not None else ():
                if isinstance(st, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == "MAX_SMEM_BYTES"
                        for t in st.targets):
                    val = st.value.value if isinstance(
                        st.value, ast.Constant) else None
                    self.max_defs.append((path, st.lineno, val))
        self.max_smem = self.max_defs[0][2] if self.max_defs else None
        self._configs = None

    def configs(self) -> dict:
        if self._configs is None:
            self._configs = _config_literals(
                self.dir.parent / "configs", self.trees.tree)
        return self._configs

    def ev(self, kernel_py: pathlib.Path, env: dict | None = None):
        tree = self.trees.tree(kernel_py)
        if tree is None:
            raise SymEvalError(f"no {kernel_py}")
        return SymEval(tree, env=env,
                       imports={"MAX_SMEM_BYTES": self.max_smem})

    # -- the configurations the dispatch can launch ------------------------

    def space(self, name: str, kernel_py: pathlib.Path,
              src: CudaSource) -> list[dict]:
        if name == "stencil":
            tune = self.trees.tree(kernel_py.parent / "tune.py")
            if tune is None:
                raise SymEvalError("no tune.py beside the stencil kernel")
            tev = SymEval(tune)
            tiles = tev.eval(ast.Name("BLOCK_TILES"))
            ks = tev.eval(ast.Name("BLOCK_KS"))
            ev = self.ev(kernel_py)
            out = []
            for tz, tx in tiles:
                for k in range(1, max(ks) + 1):
                    shape = ev.call("launch_shape", [k, tz, tx])
                    if shape is None or ev.call(
                            "smem_bytes", [k, tz, tx]) > self.max_smem:
                        continue
                    out.append({"k": k, "tz": tz, "tx": tx,
                                "rows": shape[0], "ctas": shape[1]})
            return out
        if name in ("flash_f32", "flash_bf16"):
            pairs = template_calls(src, "flash_attention_launch", "launch_d")
            bf16 = int(name == "flash_bf16")
            return [{"d": d, "dv": dv, "bf16": bf16} for d, dv in pairs]
        if name in ("ssd_f32", "ssd_bf16"):
            wgmma = name == "ssd_bf16"
            pts = switch_targs(src, "ssd_chunk_launch_role",
                               "launch_pt" if wgmma else "launch_simt")
            ev = self.ev(kernel_py, env=DTYPES)
            out = []
            for n, p in self.configs()["ssm"]:
                if p not in pts:
                    continue
                for hpg in (1, 2):       # per-head, and shared B and C
                    rule = ev.call("launch_rule", [
                        1, 2, 64, n, p, BF16 if wgmma else F32, hpg])
                    cfg = {"n": n, "p": p, "pt": pts[p][0],
                           "hb": rule["heads_per_cta"],
                           "wgmma": int(wgmma),
                           "rule_smem": rule["smem_bytes"]}
                    if cfg not in out:
                        out.append(cfg)
            return out
        if name == "norm":
            ev = self.ev(kernel_py, env=DTYPES)
            out = []
            for d in self.configs()["d_model"]:
                for dtype, t in ((F32, "float"), (BF16, "__nv_bfloat16")):
                    for n in NORM_ROWS:
                        for aligned in (True, False):
                            shape = ev.call("launch_shape",
                                            [n, d, dtype, aligned])
                            cfg = {"d": d, "T": t, **{
                                k: shape[k] for k in ("vec", "nv", "tpr",
                                                      "warps", "rows")}}
                            if cfg not in out:
                                out.append(cfg)
            return out
        raise SymEvalError(f"unknown configuration space {name!r}")


def launch_table(kernels: pathlib.Path, ctxs: list[FileContext] = ()
                 ) -> list[dict]:
    """Every mapped launch at every configuration it is checked at:
    {source, launch, kernel, targs, config, query, dynamic (the C++
    size), python (the formula's), static (the kernel's __shared__
    bytes)}.  Raises ``CEvalError`` / ``SymEvalError`` where a side
    cannot be evaluated (the rule reports those as findings)."""
    ks = _Kernels(pathlib.Path(kernels), _Tree(list(ctxs)))
    rows = []
    for kernel_py in sorted(ks.dir.glob("*/kernel.py")):
        for cu in cu_sources(kernel_py):
            src = CudaSource(cu)
            for fn, idx in src.launches():
                m = LAUNCH_FORMULAS.get((cu.stem, fn.name))
                if m is None:
                    continue
                rows.extend(_evaluate(ks, kernel_py, src, fn, idx, m))
    return rows


def _evaluate(ks: _Kernels, kernel_py, src, fn, idx, m: LaunchMap):
    args = _launch_args(fn, idx)
    kname, ktargs = _launched_kernel(fn, idx)
    ev_py = ks.ev(kernel_py, env=DTYPES)
    for cfg in ks.space(m.space, kernel_py, src):
        env = m.cxx(cfg)
        cev = CEval(src, env=env, scope=fn)
        dynamic = cev.eval(args[2])
        targs = [cev.eval(a) for a in _split_commas(ktargs)]
        python = ev_py.call(m.formula, list(m.py(cfg)))
        yield {"source": src.rel, "launch": fn.name, "line":
               fn.body[idx].line, "kernel": kname, "targs": targs,
               "config": cfg, "query": m.query, "dynamic": dynamic,
               "python": python,
               "static": static_smem_bytes(src, kname, targs)}


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


class SmemBudgetRule:
    """Cross-file pass over ``kernels/*/kernel.py`` and the ``.cu``
    sources beside them."""

    name = RULE

    def run(self, ctxs: list[FileContext],
            root: pathlib.Path) -> Iterator[Finding]:
        kernel_ctxs = [c for c in ctxs if "kernels" in c.parts
                       and c.path.name == "kernel.py"
                       and cu_sources(c.path)]
        if not kernel_ctxs:
            return
        trees = _Tree(ctxs)
        kdir = kernel_ctxs[0].path.resolve().parents[1]
        ks = _Kernels(kdir, trees)
        by_path = {c.path.resolve(): c for c in ctxs}
        yield from self._check_max(ks, by_path, kernel_ctxs[0], root)
        for ctx in kernel_ctxs:
            for cu in cu_sources(ctx.path):
                src = CudaSource(cu, rel=_rel(cu, root))
                for fn, idx in src.launches():
                    yield from self._check_launch(ks, ctx, src, fn, idx)
            if ctx.path.parent.name == "stencil":
                yield from self._check_filter(ctx, trees, by_path, root)

    def _check_max(self, ks: _Kernels, by_path, anchor: FileContext,
                   root) -> Iterator[Finding]:
        if not ks.max_defs:
            yield Finding(anchor.rel, 1, 0, RULE,
                          "no MAX_SMEM_BYTES under kernels/: the launches' "
                          "shared memory has no budget to fit")
            return
        path, line, val = ks.max_defs[0]
        rel = _rel(path, root)
        for other, oline, _ in ks.max_defs[1:]:
            yield Finding(_rel(other, root), oline, 0, RULE,
                          f"a second MAX_SMEM_BYTES (first at {rel}:{line}):"
                          f" define it once and import it")
        if not isinstance(val, int):
            yield Finding(rel, line, 0, RULE,
                          "MAX_SMEM_BYTES is not an integer literal")
        elif val > SM90_SMEM_PER_BLOCK:
            yield Finding(rel, line, 0, RULE,
                          f"MAX_SMEM_BYTES = {val} exceeds sm_90's "
                          f"{SM90_SMEM_PER_BLOCK} bytes of shared memory a "
                          f"block")

    def _check_launch(self, ks: _Kernels, ctx: FileContext, src: CudaSource,
                      fn, idx: int) -> Iterator[Finding]:
        line = fn.body[idx].line
        args = _launch_args(fn, idx)
        if len(args) < 3 or [t.text for t in args[2]] == ["0"]:
            return
        if src.suppressed(RULE, line):
            return
        where = (src.rel, line, 0, RULE)
        m = LAUNCH_FORMULAS.get((src.path.stem, fn.name))
        if m is None:
            yield Finding(*where,
                          f"dynamic-smem launch in `{fn.name}` has no "
                          f"formula mapping (LAUNCH_FORMULAS) — add one or "
                          f"suppress with a justification")
            return
        if not isinstance(ks.max_smem, int):
            return
        try:
            rows = list(_evaluate(ks, ctx.path, src, fn, idx, m))
        except (CEvalError, SymEvalError, KeyError, TypeError,
                ValueError) as e:
            yield Finding(*where,
                          f"could not evaluate `{fn.name}`'s shared memory "
                          f"against {m.formula}: {e}")
            return
        if not rows:
            yield Finding(*where,
                          f"`{fn.name}` has no configuration to check "
                          f"{m.formula} at")
            return
        for row in rows:
            cfg = row["config"]
            if row["dynamic"] != row["python"]:
                yield Finding(*where,
                              f"`{fn.name}` shared memory drifts from "
                              f"{m.formula} at {cfg}: C++ {row['dynamic']} "
                              f"B, Python {row['python']} B")
                return
            if "rule_smem" in cfg and cfg["rule_smem"] != row["dynamic"]:
                yield Finding(*where,
                              f"launch_rule's smem_bytes at {cfg} drifts from"
                              f" `{fn.name}`'s {row['dynamic']} B")
                return
            total = row["dynamic"] + row["static"]
            if total > ks.max_smem:
                yield Finding(*where,
                              f"`{row['kernel']}<{row['targs']}>` takes "
                              f"{row['dynamic']} B dynamic + {row['static']}"
                              f" B static shared memory at {cfg}, more than "
                              f"MAX_SMEM_BYTES = {ks.max_smem}")
                return

    def _check_filter(self, ctx: FileContext, trees: _Tree, by_path,
                      root) -> Iterator[Finding]:
        """The tuner's filter and the wrapper's launch check read the
        same formula against the same MAX_SMEM_BYTES."""
        tune_path = ctx.path.parent / "tune.py"
        tune = trees.tree(tune_path)
        if tune is None:
            return
        rel = _rel(tune_path, root)
        kernel_mod = ".".join(_module_parts(ctx.path))
        imported = {}
        for node in tune.body:
            if isinstance(node, ast.ImportFrom):
                for a in node.names:
                    imported[a.asname or a.name] = node.module
        fdef = next((n for n in tune.body if isinstance(n, ast.FunctionDef)
                     and n.name == "block_candidates"), None)
        if fdef is None:
            yield Finding(rel, 1, 0, RULE,
                          "tune.py has no block_candidates filter to pin")
            return
        pinned = any(
            isinstance(n, ast.Compare) and isinstance(n.left, ast.Call)
            and getattr(n.left.func, "id", "") == "smem_bytes"
            and len(n.ops) == 1 and isinstance(n.ops[0], ast.LtE)
            and isinstance(n.comparators[0], ast.Name)
            and n.comparators[0].id == "MAX_SMEM_BYTES"
            for n in ast.walk(fdef))
        sources_ok = imported.get("smem_bytes") == kernel_mod and \
            imported.get("MAX_SMEM_BYTES") in (
                kernel_mod, "repro_torch.kernels.build")
        if not (pinned and sources_ok):
            yield Finding(rel, fdef.lineno, 0, RULE,
                          "block_candidates must keep a tile only where "
                          "`smem_bytes(...) <= MAX_SMEM_BYTES`, both "
                          "imported from the stencil kernel module (the "
                          "wrapper's launch check)")
        wrapper = next((n for n in ctx.tree.body
                        if isinstance(n, ast.FunctionDef)
                        and n.name == "wave_block_shots_cuda"), None)
        checks = any(
            isinstance(n, ast.Compare) and len(n.ops) == 1
            and isinstance(n.ops[0], ast.Gt)
            and isinstance(n.comparators[0], ast.Name)
            and n.comparators[0].id == "MAX_SMEM_BYTES"
            for n in ast.walk(ctx.tree))
        calls = wrapper is not None and any(
            isinstance(n, ast.Call) and getattr(n.func, "id", "")
            == "smem_bytes" for n in ast.walk(wrapper))
        if not (checks and calls):
            yield Finding(ctx.rel, wrapper.lineno if wrapper else 1, 0, RULE,
                          "wave_block_shots_cuda must check smem_bytes(...) "
                          "against MAX_SMEM_BYTES before it launches")


def _module_parts(path: pathlib.Path) -> list[str]:
    parts = list(path.with_suffix("").parts)
    if "repro_torch" in parts:
        parts = parts[parts.index("repro_torch"):]
    return parts


def _rel(path: pathlib.Path, root: pathlib.Path) -> str:
    try:
        return str(pathlib.Path(path).resolve().relative_to(
            pathlib.Path(root).resolve()))
    except ValueError:
        return str(path)
