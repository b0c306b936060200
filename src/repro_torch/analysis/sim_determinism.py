"""sim-determinism: protect ``repro_torch.sim``'s bitwise-determinism pin.

The fleet simulator is pinned bit-identical across processes and
platforms (DESIGN.md §16 — the tournament CI diffs full event streams),
which one careless iteration order can silently break: Python ``set``
order depends on PYTHONHASHSEED, dict order on insertion history, and
wall-clock / unseeded RNG on the machine.  Inside ``repro/sim`` this
rule flags:

* statement-level ``for`` loops over ``.items()/.keys()/.values()``
  views or set-valued expressions (wrap in ``sorted(...)`` or iterate
  an explicit ordered tuple);
* list/generator/dict comprehensions drawing from a set or dict view,
  unless the comprehension feeds an order-insensitive reducer
  (``sum``/``min``/``max``/``len``/``any``/``all``/``sorted``/``set``/
  ``frozenset``) or is itself a set comprehension;
* ``list(...)``/``tuple(...)`` materializations of set-valued
  expressions or dict views;
* ``import random`` (the unseeded global stdlib RNG) and bare
  ``np.random.*`` module calls; ``np.random.default_rng()`` with no
  seed;
* wall-clock reads (``time.time``/``perf_counter``/``monotonic``,
  ``datetime.now``/``utcnow``/``today``);
* ``id(...)`` (CPython address — run-dependent ordering key).

Set-valued names are tracked flow-insensitively per scope: a name
assigned a set literal/comprehension/``set()``/``frozenset()`` call or
a union/intersection of those counts as a set everywhere in the scope.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import FileContext, Finding, PerFileRule

RULE = "sim-determinism"

DICT_VIEWS = {"items", "keys", "values"}
SAFE_REDUCERS = {"sum", "min", "max", "len", "any", "all", "sorted",
                 "set", "frozenset"}
SAFE_RNG = {"default_rng", "Generator", "SeedSequence", "PCG64",
            "Philox", "MT19937", "BitGenerator"}
CLOCKS = {"time": {"time", "time_ns", "perf_counter", "perf_counter_ns",
                   "monotonic", "monotonic_ns"},
          "datetime": {"now", "utcnow", "today"},
          "date": {"today"}}


def _terminal(func: ast.expr) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _chain(node: ast.expr) -> list[str]:
    """Dotted attribute chain, e.g. ``np.random.rand`` -> [np,random,rand]."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _is_dict_view(node: ast.expr) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in DICT_VIEWS
            and not node.args)


def _is_set_valued(node: ast.expr, set_names: set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Name):
        return node.id in set_names
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return (_is_set_valued(node.left, set_names)
                or _is_set_valued(node.right, set_names))
    return False


def _scope_walk(body: list[ast.stmt]) -> Iterator[ast.AST]:
    """Walk a scope's statements without descending into nested defs."""
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                stack.append(child)


def _set_names(body: list[ast.stmt]) -> set[str]:
    names: set[str] = set()
    for _ in range(2):                      # one fixpoint pass for chains
        for node in _scope_walk(body):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and _is_set_valued(node.value, names):
                names.add(node.targets[0].id)
    return names


class SimDeterminismRule(PerFileRule):
    name = RULE

    def applies(self, ctx: FileContext) -> bool:
        return "sim" in ctx.parts

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not self.applies(ctx):
            return
        parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(ctx.tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        scopes: list[list[ast.stmt]] = [ctx.tree.body] + [
            n.body for n in ast.walk(ctx.tree)
            if isinstance(n, ast.FunctionDef)
        ]
        for body in scopes:
            yield from self._check_scope(ctx, body, parents)
        yield from self._check_rng_and_clocks(ctx)

    # -- iteration order ---------------------------------------------------

    def _check_scope(self, ctx: FileContext, body: list[ast.stmt],
                     parents) -> Iterator[Finding]:
        set_names = _set_names(body)

        def unordered(node):
            return _is_dict_view(node) or _is_set_valued(node, set_names)

        for node in _scope_walk(body):
            if isinstance(node, ast.For) and unordered(node.iter):
                kind = "dict view" if _is_dict_view(node.iter) else "set"
                yield Finding(
                    ctx.rel, node.iter.lineno, node.iter.col_offset, RULE,
                    f"for-loop over a {kind} — iteration order is a "
                    f"hidden determinism dependency; iterate "
                    f"sorted(...) or an explicit ordered tuple",
                )
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                                   ast.DictComp)):
                for gen in node.generators:
                    if unordered(gen.iter) and \
                            not self._reduced(node, parents):
                        kind = ("dict view" if _is_dict_view(gen.iter)
                                else "set")
                        yield Finding(
                            ctx.rel, gen.iter.lineno, gen.iter.col_offset,
                            RULE,
                            f"comprehension over a {kind} produces an "
                            f"order-dependent result; wrap the source "
                            f"in sorted(...) or reduce "
                            f"order-insensitively",
                        )
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id in ("list", "tuple") \
                    and len(node.args) == 1 and unordered(node.args[0]):
                yield Finding(
                    ctx.rel, node.lineno, node.col_offset, RULE,
                    f"{node.func.id}(...) materializes a set/dict view "
                    f"in hash/insertion order; use sorted(...)",
                )

    def _reduced(self, comp: ast.AST, parents) -> bool:
        """True when the comprehension feeds an order-insensitive
        reducer (its immediate consumer is a SAFE_REDUCERS call)."""
        parent = parents.get(comp)
        return (isinstance(parent, ast.Call)
                and comp in parent.args
                and _terminal(parent.func) in SAFE_REDUCERS)

    # -- entropy sources ---------------------------------------------------

    def _check_rng_and_clocks(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[0] == "random":
                        yield Finding(
                            ctx.rel, node.lineno, node.col_offset, RULE,
                            "stdlib `random` is an unseeded process-"
                            "global RNG; use np.random.default_rng("
                            "seed)",
                        )
            elif isinstance(node, ast.ImportFrom):
                if (node.module or "").split(".")[0] == "random":
                    yield Finding(
                        ctx.rel, node.lineno, node.col_offset, RULE,
                        "stdlib `random` is an unseeded process-global "
                        "RNG; use np.random.default_rng(seed)",
                    )
            elif isinstance(node, ast.Call):
                yield from self._check_call(ctx, node)

    def _check_call(self, ctx: FileContext,
                    node: ast.Call) -> Iterator[Finding]:
        chain = _chain(node.func)
        if len(chain) >= 2 and "random" in chain[:-1]:
            if chain[-1] not in SAFE_RNG:
                yield Finding(
                    ctx.rel, node.lineno, node.col_offset, RULE,
                    f"`{'.'.join(chain)}` draws from the global numpy "
                    f"RNG; use a seeded default_rng",
                )
            elif chain[-1] == "default_rng" and not node.args:
                yield Finding(
                    ctx.rel, node.lineno, node.col_offset, RULE,
                    "default_rng() without a seed pulls OS entropy; "
                    "pass an explicit seed",
                )
        if len(chain) == 2 and chain[1] in CLOCKS.get(chain[0], ()):
            yield Finding(
                ctx.rel, node.lineno, node.col_offset, RULE,
                f"`{'.'.join(chain)}` reads the wall clock — sim time "
                f"must come from the event loop",
            )
        if isinstance(node.func, ast.Name) and node.func.id == "id" \
                and node.args:
            yield Finding(
                ctx.rel, node.lineno, node.col_offset, RULE,
                "id() is a CPython address — run-dependent; order by a "
                "stable key instead",
            )
        for kw in node.keywords:
            if kw.arg == "key" and isinstance(kw.value, ast.Name) \
                    and kw.value.id == "id":
                yield Finding(
                    ctx.rel, node.lineno, node.col_offset, RULE,
                    "key=id sorts by CPython address — run-dependent; "
                    "use a stable key",
                )
