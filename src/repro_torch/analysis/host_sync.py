"""host-sync: calls that make the host wait for the card, on the hot path.

The port's counterpart of ``tracer-hygiene``.  A ``.item()``, a
``.cpu()``, an ``int()`` of a device value or a ``nonzero`` makes the
host wait until the card has drained its queue: on the decode step that
wait is host time the card idles through, and a CUDA-graph capture of
the step fails on it.  This rule builds a call graph of the linted
files and flags those calls only in functions REACHABLE from the port's
hot code:

* roots: ``forward`` / ``backward`` of ``torch.autograd.Function``
  subclasses; ``forward`` of ``nn.Module`` subclasses under
  ``models/``; functions decorated with ``torch.library.custom_op`` and
  their ``register_fake`` implementations; targets of ``torch.compile``,
  ``torch.func.*``, ``torch.vmap`` and ``torch.utils.checkpoint``'s
  ``checkpoint``; and ``HOT_STEPS``, the step builders' inner functions
  (the serving steps, the train steps, plain and donated, and the
  optimizers' updates, plain and in place, and the schedules they call,
  the FWI block runner, the striped steps);
* reachability: calls by name within a module and through its imports
  of the linted modules (``from m import f``, ``import m as M`` then
  ``M.f``), ``self.f`` and ``obj.f`` to a method of that name of a class
  in the same module, a local ``g = builder(...)`` called as ``g(...)``
  to the closures ``builder`` defines, functions handed to a call as an
  argument, and every function nested inside a reachable one;
* flagged there: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.to("cpu")``, ``torch.cuda.synchronize``, ``.synchronize()`` (an
  event or a stream), ``.nonzero()``, ``torch.nonzero``,
  ``torch.argwhere``, a one-argument ``torch.where``, ``torch.unique``,
  ``torch.masked_select``, ``print``, ``np.asarray`` / ``np.array``,
  ``float`` / ``int`` / ``bool`` of a value that is not static, and a
  blocking copy of host data to the card (``torch.tensor`` /
  ``torch.as_tensor`` with a ``device``, ``.to(...)`` or ``.cuda()`` of
  a ``torch.tensor`` / ``as_tensor`` / ``from_numpy``), which
  PyTorch's sync-debug mode reports as a sync;
* static, so exempt: constants, ``.shape``, ``.ndim``, ``.size()``,
  ``.dim()``, ``.numel()``, ``.stride()``, ``.dtype``, ``.device``,
  ``len(...)``, attributes of a config (``cfg.*``, ``run.*``),
  parameters annotated ``int`` / ``float`` / ``bool`` / ``str``, module
  constants, loop variables over a ``range`` of static bounds, and
  names assigned only static values.

It also reads the host functions of each kernel's ``csrc/*.cu`` (the
``ctypes`` launch entries and the launch templates), where PyTorch's
sync-debug mode cannot see: ``cudaDeviceSynchronize``,
``cudaStreamSynchronize``, ``cudaEventSynchronize``, a blocking
``cudaMemcpy``, ``cudaMalloc`` and ``cudaFree`` are findings there.

A hot-path sync that the contract makes harmless (``int(pos)`` of a
position the caller passes as a Python int) takes ``# lint:
disable=host-sync -- why`` (``// lint: disable=host-sync -- why`` in a
``.cu`` file); ``chip_smoke.py`` phase ``lint`` holds the rule to
PyTorch's own sync-debug mode on the card.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import Iterator

from repro_torch.analysis.core import FileContext, Finding
from repro_torch.analysis.csrc import CudaSource, cu_sources

RULE = "host-sync"

#: the step builders' inner functions: {file: {builder: [inner defs]}}
HOT_STEPS = {
    "runtime/serve_step.py": {"build_prefill": ["fn"],
                              "build_decode": ["fn"]},
    "runtime/train_step.py": {"build_train_step": ["step", "sharded_step"],
                              "build_compressed_train_step": ["step"]},
    "runtime/pipeline.py": {"build_pipeline_train_step": ["step"]},
    "optim/adamw.py": {"make_adamw": ["update", "update_"]},
    "optim/adafactor.py": {"make_adafactor": ["update", "update_"]},
    "optim/schedule.py": {"warmup_cosine": ["lr"]},
    "fwi/solver.py": {"make_block_runner": ["run"]},
    "fwi/domain.py": {"make_sharded_multistep": ["block_step"],
                      "make_sharded_step": ["step"],
                      "make_sharded_scan_runner": ["run"]},
}

SYNC_METHODS = {"item": "`.item()`", "tolist": "`.tolist()`",
                "cpu": "`.cpu()`", "numpy": "`.numpy()`",
                "nonzero": "`.nonzero()`",
                "synchronize": "`.synchronize()`"}
TORCH_SYNCS = {"nonzero", "argwhere", "unique", "masked_select"}
#: calls that make a tensor of host data (copied if moved to the card)
HOST_MADE = (["torch", "tensor"], ["torch", "as_tensor"],
             ["torch", "from_numpy"])
CASTS = {"float", "int", "bool"}
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                "requires_grad"}
STATIC_METHODS = {"size", "dim", "numel", "stride", "element_size",
                  "is_contiguous", "data_ptr"}
STATIC_FUNCS = {"len", "min", "max", "abs", "round", "range", "isinstance",
                "tuple", "divmod", "sum"}
STATIC_ANNOTATIONS = {"int", "float", "bool", "str"}
CONFIG_NAMES = {"cfg", "config", "run", "mcfg", "scfg"}
NUMPY_NAMES = {"np", "numpy"}
TRANSFORMS = {"compile", "vmap", "checkpoint"}
#: host calls of the CUDA runtime that wait for the card or allocate
CUDA_SYNCS = re.compile(
    r"\b(cudaDeviceSynchronize|cudaStreamSynchronize|cudaEventSynchronize"
    r"|cudaMemcpy(?:2D|3D|ToSymbol|FromSymbol)?|cudaMalloc(?:Host|Managed"
    r"|Pitch)?|cudaFree(?:Host)?)\s*\(")

_Def = ast.FunctionDef | ast.AsyncFunctionDef


def _chain(node: ast.expr) -> list[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.extend(reversed(_chain(node.func)))
    return parts[::-1]


def _module_name(rel: str) -> str:
    parts = list(pathlib.PurePosixPath(rel.replace("\\", "/"))
                 .with_suffix("").parts)
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class _Module:
    """One file: its defs (with their enclosing class and def), its
    imports of other linted modules, its module constants."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.name = _module_name(ctx.rel)
        self.top: dict[str, _Def] = {}
        self.classes: dict[str, ast.ClassDef] = {}
        self.owner: dict[_Def, ast.ClassDef | None] = {}
        self.parent: dict[_Def, _Def | None] = {}
        self.nested: dict[_Def, list[_Def]] = {}
        self.imports: dict[str, tuple[str, str | None]] = {}
        self.consts: set[str] = set()
        for st in ctx.tree.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.top[st.name] = st
            elif isinstance(st, ast.ClassDef):
                self.classes[st.name] = st
            elif isinstance(st, ast.Assign):
                for t in st.targets:
                    if isinstance(t, ast.Name):
                        self.consts.add(t.id)
            elif isinstance(st, ast.AnnAssign) and isinstance(st.target,
                                                              ast.Name):
                self.consts.add(st.target.id)
        self._walk(ctx.tree, None, None)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module:
                for a in node.names:
                    self.imports[a.asname or a.name] = (node.module, a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.imports[a.asname] = (a.name, None)

    def _walk(self, node, owner, parent) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.owner[child] = owner
                self.parent[child] = parent
                self.nested.setdefault(child, [])
                if parent is not None:
                    self.nested[parent].append(child)
                self._walk(child, None, child)
            elif isinstance(child, ast.ClassDef):
                self._walk(child, child, parent)
            else:
                self._walk(child, owner, parent)

    def methods(self, cls: ast.ClassDef) -> dict[str, _Def]:
        return {st.name: st for st in cls.body
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef))}

    def method_named(self, name: str) -> list[_Def]:
        return [m for cls in self.classes.values()
                for n, m in self.methods(cls).items() if n == name]


class _Program:
    """The linted modules, their roots and what the roots reach."""

    def __init__(self, ctxs: list[FileContext]):
        self.mods = {m.name: m for m in map(_Module, ctxs)}
        self.by_ctx = {m.ctx.rel: m for m in self.mods.values()}
        self.roots: list[tuple[_Module, _Def]] = []
        for mod in self.mods.values():
            self.roots.extend((mod, f) for f in self._roots(mod))
        self.reach = self._reach()

    # -- resolution --------------------------------------------------------

    def resolve(self, mod: _Module, fdef: _Def | None,
                func: ast.expr) -> list[tuple[_Module, _Def]]:
        """The defs a call (or a reference) to ``func`` may reach."""
        if isinstance(func, ast.Name):
            scope = fdef
            while scope is not None:
                for child in mod.nested.get(scope, ()):
                    if child.name == func.id:
                        return [(mod, child)]
                if scope.name == func.id and mod.parent.get(scope):
                    return [(mod, scope)]
                scope = mod.parent.get(scope)
            if func.id in mod.top:
                return [(mod, mod.top[func.id])]
            if func.id in mod.imports:
                src, name = mod.imports[func.id]
                target = self.mods.get(src)
                if target is not None and name in target.top:
                    return [(target, target.top[name])]
            return self._built(mod, fdef, func.id)
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name):
                if base.id in mod.imports:
                    src, name = mod.imports[base.id]
                    target = self.mods.get(src if name is None
                                           else f"{src}.{name}")
                    if target is not None:
                        if func.attr in target.top:
                            return [(target, target.top[func.attr])]
                        return []
                if base.id in mod.classes:
                    m = mod.methods(mod.classes[base.id]).get(func.attr)
                    return [(mod, m)] if m else []
                if base.id == "self" and fdef is not None:
                    cls = mod.owner.get(_outermost_method(mod, fdef))
                    if cls is not None:
                        m = mod.methods(cls).get(func.attr)
                        return [(mod, m)] if m else []
            return [(mod, m) for m in mod.method_named(func.attr)]
        return []

    def _built(self, mod: _Module, fdef: _Def | None,
               name: str) -> list[tuple[_Module, _Def]]:
        """A local ``name = builder(...)``: the closures ``builder``
        defines (what calling ``name`` runs)."""
        out = []
        scope = fdef
        while scope is not None:
            for func in _assigned_calls(scope).get(name, ()):
                for m, g in self.resolve(mod, scope, func):
                    out.extend((m, c) for c in m.nested.get(g, ()))
            scope = mod.parent.get(scope)
        return out

    # -- roots -------------------------------------------------------------

    def _roots(self, mod: _Module) -> list[_Def]:
        roots: list[_Def] = []
        for cls in mod.classes.values():
            bases = {".".join(_chain(b)) for b in cls.bases}
            meths = mod.methods(cls)
            if any(b.endswith("autograd.Function") or b == "Function"
                   for b in bases):
                roots += [meths[n] for n in ("forward", "backward")
                          if n in meths]
            if "models" in mod.ctx.parts and any(
                    b.endswith("nn.Module") or b == "Module" for b in bases):
                roots += [meths[n] for n in ("forward",) if n in meths]
        for fdef in mod.owner:
            for dec in fdef.decorator_list:
                ch = _chain(dec.func if isinstance(dec, ast.Call) else dec)
                if ch and (ch[-1] in ("custom_op", "register_fake")
                           or ch[-1] == "compile" and "torch" in ch
                           or "func" in ch[:-1] and ch[0] == "torch"):
                    roots.append(fdef)
        for node in ast.walk(mod.ctx.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            ch = _chain(node.func)
            if not ch:
                continue
            name = ch[-1]
            hot = (name in TRANSFORMS and (ch[0] == "torch" or name ==
                                           "checkpoint" and _imported_from(
                                               mod, ch[0], "checkpoint")))
            hot = hot or (ch[0] == "torch" and "func" in ch[:-1])
            hot = hot or name == "register_fake"
            if hot:
                roots += [f for _, f in self.resolve(
                    mod, _enclosing(mod, node), node.args[0])]
        for key, builders in HOT_STEPS.items():
            if not mod.ctx.rel.replace("\\", "/").endswith(key):
                continue
            for builder, inner in builders.items():
                b = mod.top.get(builder)
                if b is not None:
                    roots += [c for c in mod.nested[b] if c.name in inner]
        return roots

    # -- reachability ------------------------------------------------------

    def _reach(self) -> dict[tuple[str, _Def], tuple[_Module, _Def]]:
        seen: dict[tuple[str, _Def], tuple[_Module, _Def]] = {}
        queue = list(self.roots)
        while queue:
            mod, fdef = queue.pop()
            key = (mod.name, fdef)
            if key in seen:
                continue
            seen[key] = (mod, fdef)
            queue.extend((mod, c) for c in mod.nested.get(fdef, ()))
            for node in _own_nodes(fdef):
                if not isinstance(node, ast.Call):
                    continue
                queue.extend(self.resolve(mod, fdef, node.func))
                for arg in list(node.args) + [k.value for k in
                                               node.keywords]:
                    if isinstance(arg, (ast.Name, ast.Attribute)):
                        queue.extend(self.resolve(mod, fdef, arg))
        return seen


def _imported_from(mod: _Module, name: str, what: str) -> bool:
    src = mod.imports.get(name)
    return src is not None and src[1] == what \
        and src[0].startswith("torch")


def _enclosing(mod: _Module, node: ast.AST) -> _Def | None:
    for fdef in mod.owner:
        if fdef.lineno <= getattr(node, "lineno", 0) <= (
                fdef.end_lineno or fdef.lineno):
            inner = [c for c in mod.nested.get(fdef, ())
                     if c.lineno <= node.lineno <= (c.end_lineno or 0)]
            if not inner:
                return fdef
    return None


def _outermost_method(mod: _Module, fdef: _Def) -> _Def:
    while mod.parent.get(fdef) is not None:
        fdef = mod.parent[fdef]
    return fdef


_NODES: dict[int, tuple[_Def, list[ast.AST]]] = {}
_ASSIGNED: dict[int, tuple[_Def, dict[str, list[ast.expr]]]] = {}


def _own_nodes(fdef: _Def) -> list[ast.AST]:
    """A def's nodes without those of nested defs (a lambda's body is
    its own), cached per def."""
    hit = _NODES.get(id(fdef))
    if hit is not None and hit[0] is fdef:
        return hit[1]
    out: list[ast.AST] = []
    stack: list[ast.AST] = list(fdef.body)
    while stack:
        node = stack.pop()
        out.append(node)
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                stack.append(child)
            elif isinstance(child, ast.Lambda):
                stack.append(child.body)
    _NODES[id(fdef)] = (fdef, out)
    return out


def _assigned_calls(fdef: _Def) -> dict[str, list[ast.expr]]:
    """{name: [callee]} of a def's ``name = callee(...)`` assignments."""
    hit = _ASSIGNED.get(id(fdef))
    if hit is not None and hit[0] is fdef:
        return hit[1]
    out: dict[str, list[ast.expr]] = {}
    for node in _own_nodes(fdef):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append(node.value.func)
    _ASSIGNED[id(fdef)] = (fdef, out)
    return out


# ---------------------------------------------------------------------------
# static values
# ---------------------------------------------------------------------------


def _is_static(node: ast.expr, static: set[str]) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in static
    if isinstance(node, ast.Attribute):
        if node.attr in STATIC_ATTRS:
            return True
        ch = _chain(node)
        return bool(ch) and (ch[0] in CONFIG_NAMES or ch[:2] == [
            "self", "cfg"] or _is_static(node.value, static))
    if isinstance(node, ast.Subscript):
        return _is_static(node.value, static) and _is_static(
            node.slice, static)
    if isinstance(node, ast.Slice):
        return all(p is None or _is_static(p, static)
                   for p in (node.lower, node.upper, node.step))
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_static(e, static) for e in node.elts)
    if isinstance(node, ast.BinOp):
        return _is_static(node.left, static) and _is_static(node.right,
                                                             static)
    if isinstance(node, ast.UnaryOp):
        return _is_static(node.operand, static)
    if isinstance(node, ast.BoolOp):
        return all(_is_static(v, static) for v in node.values)
    if isinstance(node, ast.Compare):
        return _is_static(node.left, static) and all(
            _is_static(c, static) for c in node.comparators)
    if isinstance(node, ast.IfExp):
        return all(_is_static(n, static)
                   for n in (node.test, node.body, node.orelse))
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in STATIC_METHODS:
            return True
        if isinstance(f, ast.Name) and (f.id in STATIC_FUNCS
                                        or f.id in CASTS):
            return all(_is_static(a, static) for a in node.args)
    return False


def _annotation_static(ann: ast.expr | None) -> bool:
    if ann is None:
        return False
    names = {n.id for n in ast.walk(ann) if isinstance(n, ast.Name)}
    names.discard("None")
    return bool(names) and names <= STATIC_ANNOTATIONS


def _static_names(mod: _Module, fdef: _Def) -> set[str]:
    static = {c for c in mod.consts}
    scope: _Def | None = fdef
    while scope is not None:
        a = scope.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            if _annotation_static(arg.annotation):
                static.add(arg.arg)
        scope = mod.parent.get(scope)
    assigned: dict[str, list[ast.expr]] = {}
    loops: dict[str, list[ast.expr]] = {}
    for node in _own_nodes(fdef):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    assigned.setdefault(t.id, []).append(node.value)
                elif isinstance(t, ast.Tuple):
                    for e in t.elts:
                        if isinstance(e, ast.Name):
                            assigned.setdefault(e.id, []).append(
                                node.value)
        elif isinstance(node, ast.For) and isinstance(node.target,
                                                      ast.Name):
            loops.setdefault(node.target.id, []).append(node.iter)
    for _ in range(3):
        for name, values in assigned.items():
            if all(_is_static(v, static) for v in values):
                static.add(name)
        for name, iters in loops.items():
            if all(isinstance(i, ast.Call) and _chain(i.func) == ["range"]
                   and all(_is_static(a, static) for a in i.args)
                   for i in iters):
                static.add(name)
    return static


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


class HostSyncRule:
    """Cross-file pass: the call graph over every linted module."""

    name = RULE

    def run(self, ctxs: list[FileContext],
            root: pathlib.Path) -> Iterator[Finding]:
        _NODES.clear()
        _ASSIGNED.clear()
        prog = _Program(ctxs)
        for mod, fdef in sorted(prog.reach.values(),
                                key=lambda mf: (mf[0].ctx.rel,
                                                mf[1].lineno)):
            yield from self._check_fn(mod, fdef)
        _NODES.clear()
        _ASSIGNED.clear()
        for ctx in ctxs:
            if "kernels" in ctx.parts and ctx.path.name == "kernel.py":
                for cu in cu_sources(ctx.path):
                    yield from self._check_cu(cu, root)

    def _check_fn(self, mod: _Module, fdef: _Def) -> Iterator[Finding]:
        static = _static_names(mod, fdef)
        for node in _own_nodes(fdef):
            if not isinstance(node, ast.Call):
                continue
            what = _sync(node, static)
            if what is not None:
                yield Finding(mod.ctx.rel, node.lineno, node.col_offset,
                              RULE, f"{what} in hot `{fdef.name}` makes "
                                    f"the host wait for the card")

    def _check_cu(self, cu: pathlib.Path, root: pathlib.Path
                  ) -> Iterator[Finding]:
        try:
            rel = str(cu.resolve().relative_to(pathlib.Path(root).resolve()))
        except ValueError:
            rel = str(cu)
        src = CudaSource(cu, rel=rel)
        for fn in src.functions:
            if not fn.is_host:
                continue
            for i, t in enumerate(fn.body):
                m = CUDA_SYNCS.match(t.text + "(") if t.kind == "id" \
                    else None
                if m is None or i + 1 >= len(fn.body) \
                        or fn.body[i + 1].text != "(":
                    continue
                if src.suppressed(RULE, t.line):
                    continue
                yield Finding(rel, t.line, 0, RULE,
                              f"`{t.text}` in the host function "
                              f"`{fn.name}` blocks the host (or the "
                              f"device) on every launch")


def _sync(node: ast.Call, static: set[str]) -> str | None:
    """What makes ``node`` a host sync, or None."""
    func = node.func
    if isinstance(func, ast.Attribute):
        ch = _chain(func)
        if func.attr in SYNC_METHODS and not node.args and (
                func.attr != "synchronize" or ch[:2] != ["torch", "cuda"]):
            return SYNC_METHODS[func.attr]
        if ch[:3] == ["torch", "cuda", "synchronize"]:
            return "`torch.cuda.synchronize()`"
        targets = list(node.args) + [k.value for k in node.keywords]
        to_cpu = any(isinstance(a, ast.Constant) and a.value == "cpu"
                     for a in targets)
        if func.attr == "to" and to_cpu:
            return '`.to("cpu")`'
        if func.attr in ("to", "cuda") and not to_cpu and isinstance(
                func.value, ast.Call) and _chain(func.value.func) in HOST_MADE:
            return (f"`.{func.attr}(...)` of a host tensor (a blocking copy "
                    f"to the card)")
        if ch[:1] == ["torch"] and len(ch) == 2:
            if ch[1] in ("tensor", "as_tensor") and any(
                    k.arg == "device" and not (isinstance(
                        k.value, ast.Constant) and k.value.value in (
                        "cpu", None)) for k in node.keywords):
                return (f"`torch.{ch[1]}(..., device=...)` of host data (a "
                        f"blocking copy to the card)")
            if ch[1] in TORCH_SYNCS:
                return f"`torch.{ch[1]}`"
            if ch[1] == "where" and len(node.args) == 1:
                return "a one-argument `torch.where`"
        if func.attr in ("asarray", "array") and isinstance(
                func.value, ast.Name) and func.value.id in NUMPY_NAMES:
            return f"`{func.value.id}.{func.attr}`"
        return None
    if isinstance(func, ast.Name):
        if func.id == "print":
            return "`print()`"
        if func.id in CASTS and node.args and not _is_static(node.args[0],
                                                             static):
            return f"`{func.id}()` of a value that is not static"
    return None
