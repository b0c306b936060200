"""Mini symbolic evaluator for straight-line numeric Python (DESIGN.md §18).

The smem-budget rule needs to EVALUATE the port's shared-memory
formulas (``kernels/*/kernel.py``: ``smem_bytes``, ``flash_smem_bytes``,
the SSD kernel's ``launch_rule`` ...) at concrete sample points, without
importing the module (kernels import torch; the linter must stay
import-free and fast).  ``repro.analysis.symeval``'s evaluator, grown
where those formulas need it:

* ``for`` over a tuple (a module constant such as the stencil kernel's
  ``LAUNCHES``), with a name or tuple target and an early ``return``;
* tuple-unpacking assignments (``wz, wx = window(...)``);
* subscripts of a tuple or dict by a value, and dict displays with
  constant keys (``launch_rule(...)["heads_per_cta"]``);
* dotted names the sample environment binds (``torch.bfloat16``).

``SymEval`` interprets a restricted AST subset against a module's tree:

* expressions: constants, names, ``+ - * / // % **``, unary ``+/-``,
  ``min``/``max``/``int``/``abs`` calls, boolean ops, comparisons
  (including ``is [not] None``), conditional expressions, tuples;
* calls to SAME-MODULE functions, executed as straight-line bodies
  (assignments, ``return``, ``if``/``else`` on decidable tests, ``for``
  over an evaluable tuple — ``while``, ``break``, try, comprehensions
  and starred args are out of scope and raise);
* name resolution, in order: the caller-provided sample environment,
  the enclosing function's top-level assignments (lazily evaluated),
  the function's parameter defaults, module-level constants, then the
  caller-provided values of imported names.

Anything outside the subset raises ``SymEvalError`` — rules treat that
as "cannot prove", never as "ok".
"""
from __future__ import annotations

import ast


class SymEvalError(Exception):
    """Expression/statement outside the evaluable subset."""


_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.FloorDiv: lambda a, b: a // b,
    ast.Mod: lambda a, b: a % b,
    ast.Pow: lambda a, b: a ** b,
}

_BUILTINS = {"min": min, "max": max, "int": int, "abs": abs, "len": len,
             "float": float, "bool": bool}

_MAX_DEPTH = 64
_MAX_ITER = 4096


class SymEval:
    """Evaluate expressions from ``tree`` at a concrete sample point.

    ``env`` — sample values (highest priority; shadows local assigns so
    a wrapper's ``k = int(src_vals.shape[0])`` never needs evaluating
    when the sample provides ``k``).
    ``scope`` — a FunctionDef whose top-level assignments and parameter
    defaults become lazily-evaluated fallbacks (the wrapper function a
    pallas_call lives in).
    ``imports`` — values of module-level names the module imports (a
    constant defined in a sibling module), looked up after the module's
    own constants.
    """

    def __init__(self, tree: ast.Module, env: dict | None = None,
                 scope: ast.FunctionDef | None = None,
                 imports: dict | None = None):
        self.env = dict(env or {})
        self.imports = dict(imports or {})
        self.consts: dict[str, ast.expr] = {}
        self.functions: dict[str, ast.FunctionDef] = {}
        for st in tree.body:
            if (isinstance(st, ast.Assign) and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Name)):
                self.consts[st.targets[0].id] = st.value
            elif isinstance(st, ast.AnnAssign) and st.value is not None \
                    and isinstance(st.target, ast.Name):
                self.consts[st.target.id] = st.value
            elif isinstance(st, ast.FunctionDef):
                self.functions[st.name] = st
        self.local_exprs: dict[str, ast.expr] = {}
        self.local_defaults: dict[str, object] = {}
        if scope is not None:
            for st in scope.body:
                if (isinstance(st, ast.Assign) and len(st.targets) == 1
                        and isinstance(st.targets[0], ast.Name)):
                    self.local_exprs.setdefault(st.targets[0].id, st.value)
            a = scope.args
            pos = a.posonlyargs + a.args
            for arg, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
                if isinstance(d, ast.Constant):
                    self.local_defaults[arg.arg] = d.value
            for arg, d in zip(a.kwonlyargs, a.kw_defaults):
                if isinstance(d, ast.Constant):
                    self.local_defaults[arg.arg] = d.value
        self._memo: dict[str, object] = {}
        self._resolving: set[str] = set()

    # -- name resolution ---------------------------------------------------

    def _name(self, nid: str, frame: dict | None):
        if frame is not None:
            if nid in frame:
                return frame[nid]
            if nid in self.consts:
                return self.eval(self.consts[nid], frame={})
            if nid in self.imports:
                return self.imports[nid]
            raise SymEvalError(f"unresolved name {nid!r}")
        if nid in self.env:
            return self.env[nid]
        if nid in self._memo:
            return self._memo[nid]
        if nid in self.local_exprs and nid not in self._resolving:
            self._resolving.add(nid)
            try:
                val = self.eval(self.local_exprs[nid])
            finally:
                self._resolving.discard(nid)
            self._memo[nid] = val
            return val
        if nid in self.local_defaults:
            return self.local_defaults[nid]
        if nid in self.consts:
            return self.eval(self.consts[nid], frame={})
        if nid in self.imports:
            return self.imports[nid]
        raise SymEvalError(f"unresolved name {nid!r}")

    # -- expression evaluation ---------------------------------------------

    def eval(self, node: ast.expr, frame: dict | None = None,
             depth: int = 0):
        """Evaluate ``node``.  ``frame=None`` means top-level scope
        (sample env + wrapper locals); a dict frame means inside a
        called function (parameters + module constants only)."""
        if depth > _MAX_DEPTH:
            raise SymEvalError("evaluation too deep")
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            return self._name(node.id, frame)
        if isinstance(node, ast.Tuple):
            return tuple(self.eval(e, frame, depth + 1) for e in node.elts)
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand, frame, depth + 1)
            if isinstance(node.op, ast.USub):
                return -v
            if isinstance(node.op, ast.UAdd):
                return +v
            if isinstance(node.op, ast.Not):
                return not v
            raise SymEvalError("unsupported unary op")
        if isinstance(node, ast.BinOp):
            op = _BINOPS.get(type(node.op))
            if op is None:
                raise SymEvalError(
                    f"unsupported operator {type(node.op).__name__}")
            a = self.eval(node.left, frame, depth + 1)
            b = self.eval(node.right, frame, depth + 1)
            try:
                return op(a, b)
            except TypeError as e:
                raise SymEvalError(str(e)) from None
        if isinstance(node, ast.BoolOp):
            isand = isinstance(node.op, ast.And)
            val = isand
            for v in node.values:
                val = self.eval(v, frame, depth + 1)
                if bool(val) != isand:
                    return val
            return val
        if isinstance(node, ast.Compare):
            left = self.eval(node.left, frame, depth + 1)
            for op, cmp in zip(node.ops, node.comparators):
                right = self.eval(cmp, frame, depth + 1)
                if not _compare(op, left, right):
                    return False
                left = right
            return True
        if isinstance(node, ast.IfExp):
            test = self.eval(node.test, frame, depth + 1)
            branch = node.body if test else node.orelse
            return self.eval(branch, frame, depth + 1)
        if isinstance(node, ast.Call):
            return self._call(node, frame, depth)
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value, frame, depth + 1)
            key = self.eval(node.slice, frame, depth + 1)
            if not isinstance(base, (tuple, dict)):
                raise SymEvalError("subscript of a non-tuple, non-dict")
            try:
                return base[key]
            except (KeyError, IndexError, TypeError) as e:
                raise SymEvalError(f"bad subscript: {e}") from None
        if isinstance(node, ast.Dict):
            if any(k is None for k in node.keys):
                raise SymEvalError("dict unpacking")
            return {self.eval(k, frame, depth + 1):
                    self.eval(v, frame, depth + 1)
                    for k, v in zip(node.keys, node.values)}
        if isinstance(node, ast.Attribute):
            dotted = _dotted(node)
            if dotted is not None and dotted in self.env:
                return self.env[dotted]
            raise SymEvalError(f"unresolved attribute {dotted or node.attr!r}")
        raise SymEvalError(f"unsupported expr {type(node).__name__}")

    def _call(self, node: ast.Call, frame: dict | None, depth: int):
        if not isinstance(node.func, ast.Name):
            raise SymEvalError("only plain-name calls are evaluable")
        if any(isinstance(a, ast.Starred) for a in node.args) or \
                any(kw.arg is None for kw in node.keywords):
            raise SymEvalError("starred call arguments")
        args = [self.eval(a, frame, depth + 1) for a in node.args]
        kwargs = {kw.arg: self.eval(kw.value, frame, depth + 1)
                  for kw in node.keywords}
        fname = node.func.id
        if fname in self.functions:
            return self.call(fname, args, kwargs, depth + 1)
        if fname in _BUILTINS and not kwargs:
            try:
                return _BUILTINS[fname](*args)
            except (TypeError, ValueError) as e:
                raise SymEvalError(str(e)) from None
        raise SymEvalError(f"uncallable function {fname!r}")

    # -- function-body execution -------------------------------------------

    def call(self, fname: str, args: list | None = None,
             kwargs: dict | None = None, depth: int = 0):
        """Call module function ``fname`` with concrete arguments."""
        fdef = self.functions.get(fname)
        if fdef is None:
            raise SymEvalError(f"no such function {fname!r}")
        frame = self._bind(fdef, list(args or []), dict(kwargs or {}))
        ret, done = self._exec(fdef.body, frame, depth)
        if not done:
            raise SymEvalError(f"{fname} fell off the end")
        return ret

    def _bind(self, fdef: ast.FunctionDef, args: list,
              kwargs: dict) -> dict:
        a = fdef.args
        pos = [p.arg for p in a.posonlyargs + a.args]
        frame: dict = {}
        for name, val in zip(pos, args):
            frame[name] = val
        if len(args) > len(pos):
            raise SymEvalError(f"too many args for {fdef.name}")
        for name, val in kwargs.items():
            if name in frame:
                raise SymEvalError(f"duplicate arg {name!r}")
            frame[name] = val
        defaults = dict(zip(pos[len(pos) - len(a.defaults):],
                            a.defaults))
        defaults.update({p.arg: d for p, d in zip(a.kwonlyargs,
                                                  a.kw_defaults)
                         if d is not None})
        for p in pos + [p.arg for p in a.kwonlyargs]:
            if p in frame:
                continue
            if p in defaults:
                frame[p] = self.eval(defaults[p], frame={})
            else:
                raise SymEvalError(f"missing arg {p!r} for {fdef.name}")
        return frame

    def _exec(self, stmts: list[ast.stmt], frame: dict, depth: int):
        if depth > _MAX_DEPTH:
            raise SymEvalError("call too deep")
        for st in stmts:
            if isinstance(st, ast.Return):
                if st.value is None:
                    return None, True
                return self.eval(st.value, frame, depth + 1), True
            if isinstance(st, ast.Assign) and len(st.targets) == 1:
                _bind_target(st.targets[0],
                             self.eval(st.value, frame, depth + 1), frame)
            elif isinstance(st, ast.Expr) and isinstance(st.value,
                                                         ast.Constant):
                continue  # docstring
            elif isinstance(st, ast.If):
                test = self.eval(st.test, frame, depth + 1)
                ret, done = self._exec(st.body if test else st.orelse,
                                       frame, depth + 1)
                if done:
                    return ret, True
            elif isinstance(st, ast.For):
                seq = self.eval(st.iter, frame, depth + 1)
                if not isinstance(seq, tuple) or len(seq) > _MAX_ITER:
                    raise SymEvalError("for over a non-tuple")
                for item in seq:
                    _bind_target(st.target, item, frame)
                    ret, done = self._exec(st.body, frame, depth + 1)
                    if done:
                        return ret, True
                ret, done = self._exec(st.orelse, frame, depth + 1)
                if done:
                    return ret, True
            elif isinstance(st, ast.Raise):
                raise SymEvalError("raise statement reached")
            elif isinstance(st, ast.Pass):
                continue
            else:
                raise SymEvalError(
                    f"unsupported statement {type(st).__name__}")
        return None, False


def _dotted(node: ast.expr) -> str | None:
    """``a.b.c`` as a string, or None for anything but a name chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _bind_target(target: ast.expr, value, frame: dict) -> None:
    """Assign ``value`` to a name or a (nested) tuple of names."""
    if isinstance(target, ast.Name):
        frame[target.id] = value
        return
    if isinstance(target, (ast.Tuple, ast.List)):
        if not isinstance(value, tuple) or len(value) != len(target.elts):
            raise SymEvalError("cannot unpack into the targets")
        for t, v in zip(target.elts, value):
            _bind_target(t, v, frame)
        return
    raise SymEvalError(f"unsupported target {type(target).__name__}")


def _compare(op: ast.cmpop, left, right) -> bool:
    if isinstance(op, ast.Is):
        return left is right
    if isinstance(op, ast.IsNot):
        return left is not right
    try:
        if isinstance(op, ast.Eq):
            return left == right
        if isinstance(op, ast.NotEq):
            return left != right
        if isinstance(op, ast.Lt):
            return left < right
        if isinstance(op, ast.LtE):
            return left <= right
        if isinstance(op, ast.Gt):
            return left > right
        if isinstance(op, ast.GtE):
            return left >= right
    except TypeError as e:
        raise SymEvalError(str(e)) from None
    raise SymEvalError(f"unsupported comparison {type(op).__name__}")
