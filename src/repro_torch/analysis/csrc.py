"""Read the port's CUDA sources (``kernels/*/csrc/*.cu``) as text.

The smem-budget, async-pairing and host-sync rules look into the
``.cu`` files beside the kernels' Python wrappers, without a compiler:

* ``CudaSource`` — a ``.cu`` file tokenised with its comments dropped,
  its file-scope ``constexpr`` integers, its functions (template
  parameters, parameters, body, ``__global__`` / ``__device__``
  qualifiers, local declarations and lambdas) and its ``struct``
  templates' ``static constexpr`` members;
* ``// lint: disable=<rule>[,<rule>] -- why`` suppressions, with the
  semantics of ``core``'s ``#`` form (a marker on a code line covers
  that line, on a comment-only line the next code line too);
* ``CEval`` — a small evaluator of C integer expressions: integer
  literals, ``+ - * / % << >> & | ^ ~ !``, comparisons, ``&& ||``,
  ``?:``, parentheses, the casts ``(size_t)``, ``(int)`` and
  ``(uint32_t)``, ``sizeof`` of ``float``, ``__nv_bfloat16``,
  ``uint64_t`` and ``float4``, file-scope ``constexpr`` integers,
  template parameters and ``a.N``-style members bound by the caller,
  calls of the file's functions whose bodies are declarations and one
  ``return`` (``window_rows<R>(wz)``, ``wg_smem_bytes(N, PT, HB)``),
  lambdas (``kbar(t)``), and ``static constexpr`` members of a templated
  struct (``TileShape<D>::BYTES``, through a ``using`` alias too).

Anything outside that subset raises ``CEvalError``: the rules treat it
as "cannot evaluate", never as "ok".
"""
from __future__ import annotations

import dataclasses
import pathlib
import re

SUPPRESS_RE = re.compile(r"//\s*lint:\s*disable=([\w,-]+)")

#: bytes of the types the kernels' sizes take ``sizeof`` of
SIZEOF = {"float": 4, "__nv_bfloat16": 2, "uint64_t": 8, "float4": 16}
#: the integer casts the evaluator takes (values are exact integers)
CASTS = {"size_t", "int", "uint32_t"}

_TOKEN_RE = re.compile(r"""
    (?P<ws>[ \t\r\f\v]+|\n)
  | (?P<str>"(?:\\.|[^"\\\n])*")
  | (?P<chr>'(?:\\.|[^'\\\n])*')
  | (?P<num>0[xX][0-9a-fA-F]+[uUlL]*|\d+\.\d*(?:[eE][+-]?\d+)?[fF]?
            |\d+[eE][+-]?\d+[fF]?|\d+[uUlL]*|\.\d+(?:[eE][+-]?\d+)?[fF]?)
  | (?P<id>[A-Za-z_]\w*)
  | (?P<op><<<|>>>|<<=|>>=|->|::|<<|>>|<=|>=|==|!=|&&|\|\||\+\+|--
            |\+=|-=|\*=|/=|%=|&=|\|=|\^=|[-+*/%&|^~!<>=?:;,.(){}\[\]#])
""", re.X)


class CEvalError(Exception):
    """A C expression or statement outside the evaluable subset."""


@dataclasses.dataclass(frozen=True)
class Tok:
    kind: str            # "str", "chr", "num", "id", "op"
    text: str
    line: int


def strip_comments(text: str) -> str:
    """``text`` with ``//`` and ``/* */`` comments blanked (newlines
    kept, so line numbers hold) and string literals left as they are."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        if c == '"' or c == "'":
            j = i + 1
            while j < n and text[j] != c and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(re.sub(r"[^\n]", " ", text[i:j]))
            i = j
        else:
            out.append(c)
            i += 1
    return "".join(out)


def tokenize(code: str) -> list[Tok]:
    """Tokens of comment-free ``code``; preprocessor lines are dropped."""
    toks: list[Tok] = []
    line, pos, bol = 1, 0, True
    while pos < len(code):
        if bol and code[pos:].lstrip(" \t").startswith("#"):
            # a preprocessor line, with its backslash continuations
            end = pos
            while True:
                nl = code.find("\n", end)
                if nl < 0:
                    end = len(code)
                    break
                if code[nl - 1] == "\\":
                    line += 1
                    end = nl + 1
                    continue
                end = nl
                break
            pos = end
            continue
        m = _TOKEN_RE.match(code, pos)
        if m is None:
            raise CEvalError(f"cannot tokenise line {line}: "
                             f"{code[pos:pos + 20]!r}")
        kind = m.lastgroup
        text = m.group()
        pos = m.end()
        if kind == "ws":
            if text == "\n":
                line += 1
                bol = True
            continue
        bol = False
        toks.append(Tok(kind, text, line))
    return toks


def suppression_map(lines: list[str]) -> dict[int, set[str]]:
    """line number -> rule names silenced there (1-based), from
    ``// lint: disable=<rule>[,<rule>] -- why`` markers."""
    out: dict[int, set[str]] = {}

    def commentish(text: str) -> bool:
        s = text.strip()
        return not s or s.startswith("//")

    for idx, text in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(idx, set()).update(rules)
        if text.lstrip().startswith("//"):
            nxt = idx + 1
            while nxt <= len(lines) and commentish(lines[nxt - 1]):
                nxt += 1
            out.setdefault(nxt, set()).update(rules)
    return out


def _match(toks: list[Tok], i: int, open_: str, close: str) -> int:
    """Index of the token closing the bracket opened at ``toks[i]``."""
    depth = 0
    for j in range(i, len(toks)):
        if toks[j].text == open_:
            depth += 1
        elif toks[j].text == close:
            depth -= 1
            if depth == 0:
                return j
    raise CEvalError(f"unbalanced {open_!r} from line {toks[i].line}")


def _split_commas(toks: list[Tok]) -> list[list[Tok]]:
    """Split at top-level commas (brackets of every kind nest)."""
    parts, cur, depth = [], [], 0
    for t in toks:
        if t.text in "([{":
            depth += 1
        elif t.text in ")]}":
            depth -= 1
        if t.text == "," and depth == 0:
            parts.append(cur)
            cur = []
        else:
            cur.append(t)
    if cur:
        parts.append(cur)
    return parts


def _template_params(toks: list[Tok]) -> list[str]:
    """Names of ``template <int A, typename T>``'s parameters."""
    return [p[-1].text for p in _split_commas(toks) if p
            and p[-1].kind == "id"]


@dataclasses.dataclass
class Decl:
    """A local ``[const|constexpr|static] T name = init;`` declarator."""

    name: str
    init: list[Tok]


@dataclasses.dataclass
class Lambda:
    """``auto name = [..](int t) { return expr; };``"""

    params: list[str]
    body: list[Tok]


@dataclasses.dataclass
class Shared:
    """A static ``__shared__`` array: element type, dims, alignment."""

    elem: str
    dims: list[list[Tok]]
    align: int | None


@dataclasses.dataclass
class CFunc:
    name: str
    tparams: list[str]
    params: list[tuple[str, str]]        # (type text, name)
    quals: set[str]
    body: list[Tok]

    @property
    def is_kernel(self) -> bool:
        return "__global__" in self.quals

    @property
    def is_host(self) -> bool:
        return not ({"__global__", "__device__"} & self.quals) \
            or "__host__" in self.quals

    def statements(self) -> list[list[Tok]]:
        """The body's statements at every depth: runs of tokens ending
        at ``;``, ``{`` or ``}`` (a crude but line-faithful split)."""
        out, cur = [], []
        for t in self.body:
            if t.text in (";", "{", "}"):
                if cur:
                    out.append(cur + [t] if t.text == ";" else cur)
                cur = []
            else:
                cur.append(t)
        if cur:
            out.append(cur)
        return out

    def decls(self) -> dict[str, Decl]:
        """Every local declarator with an initialiser (the first of a
        name wins), lambdas excluded."""
        out: dict[str, Decl] = {}
        for st in _statements_with_lambdas(self.body):
            for d in _declarators(st):
                out.setdefault(d.name, d)
        return out

    def lambdas(self) -> dict[str, Lambda]:
        out: dict[str, Lambda] = {}
        toks = self.body
        for i in range(len(toks) - 3):
            if toks[i].text == "auto" and toks[i + 1].kind == "id" \
                    and toks[i + 2].text == "=" and toks[i + 3].text == "[":
                j = _match(toks, i + 3, "[", "]")
                if toks[j + 1].text != "(":
                    continue
                k = _match(toks, j + 1, "(", ")")
                params = [p[-1].text for p in _split_commas(
                    toks[j + 2:k]) if p]
                b = k + 1
                while toks[b].text != "{":
                    b += 1
                e = _match(toks, b, "{", "}")
                out[toks[i + 1].text] = Lambda(params, toks[b + 1:e])
        return out

    def usings(self) -> dict[str, list[Tok]]:
        """``using X = XTile<PT>;`` aliases: name -> the aliased tokens."""
        out: dict[str, list[Tok]] = {}
        toks = self.body
        for i in range(len(toks) - 2):
            if toks[i].text == "using" and toks[i + 1].kind == "id" \
                    and toks[i + 2].text == "=":
                j = i + 3
                while toks[j].text != ";":
                    j += 1
                out[toks[i + 1].text] = toks[i + 3:j]
        return out

    def shared_arrays(self) -> list[Shared]:
        """The static ``__shared__`` arrays declared in the body."""
        out = []
        for st in self.statements():
            texts = [t.text for t in st]
            if "__shared__" not in texts or "extern" in texts:
                continue
            align = None
            if "__align__" in texts:
                a = texts.index("__align__")
                align = int(texts[a + 2])
            br = texts.index("[")
            dims, i = [], br
            while i < len(st) and st[i].text == "[":
                j = _match(st, i, "[", "]")
                dims.append(st[i + 1:j])
                i = j + 1
            out.append(Shared(st[br - 2].text, dims, align))
        return out


def _statements_with_lambdas(toks: list[Tok]) -> list[list[Tok]]:
    """Statements split at ``;`` (``{``/``}`` too, outside a lambda's
    braces, which stay inside their statement)."""
    out, cur, i = [], [], 0
    while i < len(toks):
        t = toks[i]
        if t.text == "[" and cur and cur[-1].text == "=":
            j = _match(toks, i, "[", "]")
            cur.extend(toks[i:j + 1])
            i = j + 1
            # (params) [mutable] { body }
            while i < len(toks) and toks[i].text != "{":
                cur.append(toks[i])
                i += 1
            if i < len(toks):
                e = _match(toks, i, "{", "}")
                cur.extend(toks[i:e + 1])
                i = e + 1
            continue
        if t.text in (";", "{", "}"):
            if cur:
                out.append(cur)
            cur = []
        else:
            cur.append(t)
        i += 1
    if cur:
        out.append(cur)
    return out


_DECL_WORDS = {"const", "constexpr", "static", "unsigned", "long",
               "signed", "volatile", "__restrict__", "auto"}


def _declarators(st: list[Tok]) -> list[Decl]:
    """The declarators of a declaration statement (``const int a = x,
    b = y``), or [] if ``st`` is not one.  Lambdas are not declarators
    here (``CFunc.lambdas`` reads them)."""
    if not st or st[0].kind != "id" or st[0].text in (
            "return", "if", "for", "while", "else", "using", "typedef",
            "asm", "switch", "case", "do"):
        return []
    parts = _split_commas(st)
    first = parts[0]
    texts = [t.text for t in first]
    if "=" not in texts:
        return []
    eq = texts.index("=")
    if eq < 2 or first[eq - 1].kind != "id":
        return []
    if any(t.kind != "id" and t.text not in ("*", "::", "&")
           for t in first[:eq - 1]):
        return []
    decls = [(first[eq - 1], first[eq + 1:])]
    for p in parts[1:]:
        if len(p) >= 2 and p[0].kind == "id" and p[1].text == "=":
            decls.append((p[0], p[2:]))
        else:
            # commas of a call or a template, not declarators
            decls = [(first[eq - 1], st[eq + 1:])]
            break
    return [Decl(name.text, init) for name, init in decls
            if not (init and init[0].text == "[")]     # lambdas aside


@dataclasses.dataclass
class CStruct:
    tparams: list[str]
    members: dict[str, list[Tok]]        # static constexpr name -> init


class CudaSource:
    """One ``.cu`` file as the rules read it."""

    def __init__(self, path: str | pathlib.Path, text: str | None = None,
                 rel: str | None = None):
        self.path = pathlib.Path(path)
        self.rel = rel if rel is not None else str(path)
        self.text = self.path.read_text() if text is None else text
        self.lines = self.text.splitlines()
        self.code = strip_comments(self.text)
        self.toks = tokenize(self.code)
        self._suppressed = suppression_map(self.lines)
        self.functions: list[CFunc] = []
        self.structs: dict[str, CStruct] = {}
        self.consts: dict[str, list[Tok]] = {}
        self._scan(0, len(self.toks))

    # -- suppressions ------------------------------------------------------

    def suppressed(self, rule: str, line: int) -> bool:
        rules = self._suppressed.get(line, set())
        return rule in rules or "all" in rules

    # -- the file's scopes -------------------------------------------------

    def _scan(self, lo: int, hi: int) -> None:
        """Record the functions, structs and constexprs of the scope
        ``toks[lo:hi]`` (namespaces and ``extern "C"`` blocks are
        transparent)."""
        toks, start, i = self.toks, lo, lo
        while i < hi:
            t = toks[i]
            if t.text == ";":
                self._scope_decl(toks[start:i])
                start = i = i + 1
                continue
            if t.text != "{":
                i += 1
                continue
            head = toks[start:i]
            end = _match(toks, i, "{", "}")
            texts = [h.text for h in head]
            if "namespace" in texts or (texts[:1] == ["extern"]
                                        and len(head) == 2):
                self._scan(i + 1, end)
            elif "struct" in texts or "class" in texts:
                self._struct(head, toks[i + 1:end])
                # `struct S { ... };` — skip the closing semicolon
                if end + 1 < hi and toks[end + 1].text == ";":
                    end += 1
            elif head and head[-1].text in (")", "const", "noexcept"):
                self._function(head, toks[i + 1:end])
            start = i = end + 1

    def _scope_decl(self, st: list[Tok]) -> None:
        texts = [t.text for t in st]
        if "constexpr" in texts and "=" in texts and "(" not in texts[
                :texts.index("=")]:
            for d in _declarators(st):
                self.consts.setdefault(d.name, d.init)

    def _struct(self, head: list[Tok], body: list[Tok]) -> None:
        texts = [h.text for h in head]
        tparams = []
        if texts[:2] == ["template", "<"]:
            close = _match(head, 1, "<", ">")
            tparams = _template_params(head[2:close])
        kw = texts.index("struct") if "struct" in texts \
            else texts.index("class")
        name = head[kw + 1].text
        members = {}
        for st in _statements_with_lambdas(body):
            stt = [t.text for t in st]
            if "static" in stt and "constexpr" in stt:
                for d in _declarators(st):
                    members[d.name] = d.init
        self.structs[name] = CStruct(tparams, members)

    def _function(self, head: list[Tok], body: list[Tok]) -> None:
        texts = [h.text for h in head]
        tparams = []
        begin = 0
        if texts[:2] == ["template", "<"]:
            close = _match(head, 1, "<", ">")
            tparams = _template_params(head[2:close])
            begin = close + 1
        # the parameter list: the last top-level (...) of the head
        j = len(head) - 1
        while head[j].text != ")":
            j -= 1
        depth, k = 0, j
        while k >= 0:
            if head[k].text == ")":
                depth += 1
            elif head[k].text == "(":
                depth -= 1
                if depth == 0:
                    break
            k -= 1
        name_tok = head[k - 1]
        if name_tok.kind != "id":
            return
        params = []
        for p in _split_commas(head[k + 1:j]):
            names = [t for t in p if t.kind == "id"]
            if names:
                ptype = " ".join(t.text for t in p[:-1])
                params.append((ptype, names[-1].text))
        quals = {h.text for h in head[begin:k - 1]
                 if h.text.startswith("__")}
        self.functions.append(CFunc(name_tok.text, tparams, params, quals,
                                    body))

    # -- lookups -----------------------------------------------------------

    def function(self, name: str) -> CFunc:
        for f in self.functions:
            if f.name == name:
                return f
        raise CEvalError(f"no function {name!r} in {self.path.name}")

    def kernels(self) -> list[CFunc]:
        return [f for f in self.functions if f.is_kernel]

    def launches(self) -> list[tuple[CFunc, int]]:
        """(enclosing function, index in its body of ``<<<``) of every
        kernel launch."""
        out = []
        for f in self.functions:
            for i, t in enumerate(f.body):
                if t.text == "<<<":
                    out.append((f, i))
        return out

    def templates(self) -> set[str]:
        return {f.name for f in self.functions if f.tparams} \
            | {n for n, s in self.structs.items() if s.tparams}


# ---------------------------------------------------------------------------
# expression evaluation
# ---------------------------------------------------------------------------

_BINARY = [
    ("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
    ("<", ">", "<=", ">="), ("<<", ">>"), ("+", "-"), ("*", "/", "%"),
]


def _cdiv(a: int, b: int) -> int:
    if b == 0:
        raise CEvalError("division by zero")
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _apply(op: str, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return _cdiv(a, b)
    if op == "%":
        return a - _cdiv(a, b) * b
    if op == "<<":
        return a << b
    if op == ">>":
        return a >> b
    if op == "&":
        return a & b
    if op == "|":
        return a | b
    if op == "^":
        return a ^ b
    if op == "==":
        return int(a == b)
    if op == "!=":
        return int(a != b)
    if op == "<":
        return int(a < b)
    if op == ">":
        return int(a > b)
    if op == "<=":
        return int(a <= b)
    if op == ">=":
        return int(a >= b)
    if op == "&&":
        return int(bool(a) and bool(b))
    if op == "||":
        return int(bool(a) or bool(b))
    raise CEvalError(f"unsupported operator {op!r}")


def parse_number(text: str) -> int:
    body = text.rstrip("uUlL")
    try:
        return int(body, 16) if body[:2] in ("0x", "0X") else int(body)
    except ValueError:
        raise CEvalError(f"not an integer literal: {text!r}") from None


class CEval:
    """Evaluate C integer expressions of one ``CudaSource``.

    ``env`` binds template parameters, parameters and ``a.N``-style
    members; ``scope`` is the function whose local declarations,
    lambdas and ``using`` aliases are lazily evaluated fallbacks;
    ``opaque`` gives locals that cannot be evaluated (runtime addresses
    such as ``__cvta_generic_to_shared(...)``) a distinct symbolic base
    value each instead of raising — the async-pairing rule's way of
    comparing ring offsets without knowing where shared memory lies."""

    def __init__(self, src: CudaSource, env: dict | None = None,
                 scope: CFunc | None = None, opaque: bool = False):
        self.src = src
        self.env = dict(env or {})
        self.scope = scope
        self.opaque = opaque
        self.templates = src.templates()
        self._decls = scope.decls() if scope is not None else {}
        self._lambdas = scope.lambdas() if scope is not None else {}
        self._usings = scope.usings() if scope is not None else {}
        self._memo: dict[str, int] = {}
        self._busy: set[str] = set()
        self._opaque_ids: dict[str, int] = {}

    # -- entry points ------------------------------------------------------

    def eval(self, toks: list[Tok], frame: dict | None = None):
        p = _Parser(self, toks, frame if frame is not None else {})
        v = p.expr()
        if p.i != len(toks):
            raise CEvalError(f"trailing tokens at line {toks[p.i].line}: "
                             f"{' '.join(t.text for t in toks[p.i:][:6])}")
        return v

    def eval_text(self, text: str, frame: dict | None = None):
        return self.eval(tokenize(text), frame)

    # -- names -------------------------------------------------------------

    def name(self, nid: str, frame: dict):
        if nid in frame:
            return frame[nid]
        if nid in self.env:
            return self.env[nid]
        if nid in self._memo:
            return self._memo[nid]
        if nid in self._decls and nid not in self._busy:
            self._busy.add(nid)
            try:
                val = self.eval(self._decls[nid].init)
            except CEvalError:
                if not self.opaque:
                    raise
                val = self.symbol(nid)
            finally:
                self._busy.discard(nid)
            self._memo[nid] = val
            return val
        if nid in self.src.consts:
            return self.eval(self.src.consts[nid], frame={})
        raise CEvalError(f"unresolved name {nid!r}")

    def symbol(self, nid: str) -> int:
        """A symbolic runtime base for ``nid``: far apart, aligned."""
        idx = self._opaque_ids.setdefault(nid, len(self._opaque_ids) + 1)
        return idx << 40

    def member(self, struct: str, targs: list, member: str):
        s = self.src.structs.get(struct)
        if s is None:
            raise CEvalError(f"no struct {struct!r}")
        if member not in s.members or len(targs) != len(s.tparams):
            raise CEvalError(f"cannot evaluate {struct}<...>::{member}")
        frame = dict(zip(s.tparams, targs))
        sub = CEval(self.src, env=frame)
        # members may name earlier members of the same struct
        for m, init in s.members.items():
            if m == member:
                return sub.eval(init, frame)
            frame[m] = sub.eval(init, frame)
        raise CEvalError(f"no member {member!r}")

    def alias(self, name: str):
        """``using X = S<args>`` -> (S, evaluated args)."""
        toks = self._usings.get(name)
        if toks is None or len(toks) < 3 or toks[1].text != "<":
            raise CEvalError(f"unresolved scope {name!r}")
        close = _match(toks, 1, "<", ">")
        args = [self.eval(a) for a in _split_commas(toks[2:close])]
        return toks[0].text, args

    def call(self, name: str, targs: list, args: list):
        lam = self._lambdas.get(name)
        if lam is not None and not targs:
            if len(args) != len(lam.params):
                raise CEvalError(f"lambda {name} takes {len(lam.params)}")
            return self._run(lam.body, dict(zip(lam.params, args)))
        cands = [f for f in self.src.functions if f.name == name
                 and len(f.tparams) == len(targs)
                 and len(f.params) == len(args)]
        if not cands:
            raise CEvalError(f"uncallable function {name!r}")
        f = cands[0]
        frame = dict(zip(f.tparams, targs))
        frame.update({p[1]: a for p, a in zip(f.params, args)})
        sub = CEval(self.src, env=frame)
        return sub._run(f.body, {})

    def _run(self, body: list[Tok], frame: dict):
        """Execute declarations and one ``return`` (nothing else)."""
        frame = dict(frame)
        for st in _statements_with_lambdas(body):
            if st[0].text == "return":
                return self.eval(st[1:], frame)
            decls = _declarators(st)
            if not decls:
                raise CEvalError(f"unsupported statement at line "
                                 f"{st[0].line}: "
                                 f"{' '.join(t.text for t in st[:6])}")
            for d in decls:
                frame[d.name] = self.eval(d.init, frame)
        raise CEvalError("function body has no return")


class _Parser:
    """Recursive descent over one token list, evaluating as it goes."""

    def __init__(self, ev: CEval, toks: list[Tok], frame: dict):
        self.ev, self.toks, self.frame, self.i = ev, toks, frame, 0

    def peek(self, k: int = 0) -> str | None:
        j = self.i + k
        return self.toks[j].text if j < len(self.toks) else None

    def take(self, text: str | None = None) -> Tok:
        if self.i >= len(self.toks):
            raise CEvalError("unexpected end of expression")
        t = self.toks[self.i]
        if text is not None and t.text != text:
            raise CEvalError(f"expected {text!r} at line {t.line}, "
                             f"got {t.text!r}")
        self.i += 1
        return t

    def expr(self):
        cond = self.binary(0)
        if self.peek() == "?":
            self.take("?")
            a = self.expr()
            self.take(":")
            b = self.expr()
            return a if cond else b
        return cond

    def binary(self, level: int, stop_gt: bool = False):
        if level == len(_BINARY):
            return self.unary()
        left = self.binary(level + 1, stop_gt)
        while self.peek() in _BINARY[level] and not (
                stop_gt and self.peek() in (">", ">>", ">=")):
            op = self.take().text
            right = self.binary(level + 1, stop_gt)
            left = _apply(op, left, right)
        return left

    def unary(self):
        t = self.peek()
        if t == "-":
            self.take()
            return -self.unary()
        if t == "+":
            self.take()
            return self.unary()
        if t == "!":
            self.take()
            return int(not self.unary())
        if t == "~":
            self.take()
            return ~self.unary()
        if t == "(" and self.peek(1) in CASTS and self.peek(2) == ")":
            self.i += 3
            return self.unary()
        if t == "sizeof":
            self.take()
            self.take("(")
            name = self.take().text
            self.take(")")
            name = self.ev.env.get(name, name)
            if name not in SIZEOF:
                raise CEvalError(f"sizeof({name}) unknown")
            return SIZEOF[name]
        return self.postfix()

    def targs(self) -> list:
        self.take("<")
        args = []
        while self.peek() != ">":
            args.append(self.binary(0, stop_gt=True))
            if self.peek() == ",":
                self.take(",")
        self.take(">")
        return args

    def postfix(self):
        t = self.take()
        if t.kind == "num":
            return parse_number(t.text)
        if t.text == "(":
            v = self.expr()
            self.take(")")
            return v
        if t.kind != "id":
            raise CEvalError(f"unexpected {t.text!r} at line {t.line}")
        name = t.text
        targs: list = []
        if self.peek() == "<" and name in self.ev.templates:
            targs = self.targs()
        if self.peek() == "::":
            self.take("::")
            member = self.take().text
            if not targs and name not in self.ev.src.structs:
                name, targs = self.ev.alias(name)
            return self.ev.member(name, targs, member)
        if self.peek() == "(":
            self.take("(")
            args = []
            while self.peek() != ")":
                args.append(self.expr())
                if self.peek() == ",":
                    self.take(",")
            self.take(")")
            return self.ev.call(name, targs, args)
        if self.peek() == "." and self.i + 1 < len(self.toks):
            self.take(".")
            dotted = f"{name}.{self.take().text}"
            if dotted in self.frame:
                return self.frame[dotted]
            if dotted in self.ev.env:
                return self.ev.env[dotted]
            raise CEvalError(f"unresolved member {dotted!r}")
        if targs:
            raise CEvalError(f"template {name!r} used as a value")
        return self.ev.name(name, self.frame)


def cu_sources(kernel_py: pathlib.Path) -> list[pathlib.Path]:
    """The ``csrc/*.cu`` files beside a kernel's ``kernel.py``."""
    return sorted((kernel_py.parent / "csrc").glob("*.cu"))
