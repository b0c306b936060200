"""async-pairing: the TMA rings' mbarrier discipline, checked statically.

The port's counterpart of ``dma-pairing``.  ``flash_attention.cu`` and
``ssd_chunk.cu`` feed ``wgmma`` from TMA rings: thread 0 announces a
tile's bytes on an mbarrier (``mbar_expect``) and issues its copy
(``cp.async.bulk.tensor ... mbarrier::complete_tx``), and the consumers
spin on the barrier's phase parity (``mbar_wait``).  A wait with the
wrong parity, or a missing one, hangs the card or reads a tile before
it lands — and only a card run would show it.  This rule reads every
function of a ``kernels/*/csrc/*.cu`` file that initialises mbarriers
(the flash kernel, the SSD kernel's ``y_tile`` and ``state_tile``),
with the ``__device__`` helpers and lambdas it calls, and flags:

* structural faults, always enforced, on thread 0's program order
  simulated at trip counts 1..``TRIPS`` (loops run, conditions on the
  thread's index and the trip count decided; addresses that depend on
  where shared memory lies are symbolic bases):

  - an arrival (``mbar_expect`` or a TMA copy) that no later
    ``mbar_wait`` consumes — an in-flight copy when the function ends;
  - an ``mbar_wait`` with no arrival before it — a deadlock;
  - ``mbar_init`` with no ``fence.mbarrier_init`` before the barrier's
    first arrival (the async proxy must see the init), or with neither
    that fence nor a ``__syncthreads()`` before its first wait;
  - a ``cp.async.bulk.commit_group`` with no
    ``cp.async.bulk.wait_group`` before the function returns;

* phase parity, checked numerically: a wait ``mbar_wait(SLOT(E),
  PAR)`` on a ring lambda ``SLOT`` must give, for the tile u = E at
  every value 0..7 of E's index variable, ``PAR == #{t < u : SLOT(t) ==
  SLOT(u)} mod 2`` (a barrier that is no ring lambda is used once:
  parity 0);
* each TMA issue names the same stage for its destination buffer and
  its barrier (``kst(t + 1)`` with ``kbar(t + 1)``; the stage of a ring
  lambda's value is the first tile index that gives it).

Where a ring expression cannot be evaluated the result is "cannot
prove, skip", as in ``dma-pairing``'s alternation check.  Template
parameters are taken at ``TEMPLATE_SAMPLE``.  ``// lint:
disable=async-pairing -- why`` in the ``.cu`` file silences a line.
"""
from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import Iterator

from repro_torch.analysis.core import FileContext, Finding
from repro_torch.analysis.csrc import (
    CEval,
    CEvalError,
    CFunc,
    CudaSource,
    Tok,
    _declarators,
    _match,
    _split_commas,
    cu_sources,
)

RULE = "async-pairing"

#: trip counts (the sizes loops run to) the structural check simulates
TRIPS = 5
#: tile indices the parity and stage checks probe
N_TILES = 8
#: the value every template parameter takes in the simulation
TEMPLATE_SAMPLE = 2
#: at most this many iterations of one simulated loop
MAX_ITER = 256

_PCT = re.compile(r"%(\d+)")


# ---------------------------------------------------------------------------
# roles: which parameter of a function is a barrier, a parity, a buffer
# ---------------------------------------------------------------------------


def _asm_parts(toks: list[Tok]) -> tuple[str, list[list[Tok]]]:
    """(text, operands) of an ``asm [volatile] (...)`` call's tokens,
    operands numbered as the asm's ``%N`` (outputs, then inputs)."""
    i = 0
    while toks[i].text != "(":
        i += 1
    close = _match(toks, i, "(", ")")
    inner = toks[i + 1:close]
    text, j = "", 0
    while j < len(inner) and inner[j].kind == "str":
        text += inner[j].text[1:-1]
        j += 1
    groups, cur, depth = [], [], 0
    for t in inner[j:]:
        depth += (t.text == "(") - (t.text == ")")
        if t.text in (":", "::") and depth == 0:
            groups.append(cur)
            cur = []
            if t.text == "::":
                groups.append([])
        else:
            cur.append(t)
    groups.append(cur)
    operands = []
    for g in groups[1:3]:                 # outputs, inputs
        for op in _split_commas(g):
            if op and op[0].kind == "str" and len(op) > 1:
                operands.append(op[2:-1])
    return text, operands


def _brackets(text: str) -> list[list[int]]:
    """The ``%N`` operand numbers inside each ``[...]`` of asm text."""
    return [[int(n) for n in _PCT.findall(b)]
            for b in re.findall(r"\[([^\]]*)\]", text)]


def _calls(toks: list[Tok], names: set[str]):
    """(index, name, template-arg tokens, argument token lists) of the
    calls of ``names`` in ``toks``."""
    i = 0
    while i < len(toks):
        t = toks[i]
        if t.kind == "id" and t.text in names and (
                i == 0 or toks[i - 1].text not in (".", "->", "::")):
            j, targs = i + 1, []
            if j < len(toks) and toks[j].text == "<":
                try:
                    close = _match(toks, j, "<", ">")
                except CEvalError:
                    i += 1
                    continue
                targs = toks[j + 1:close]
                j = close + 1
            if j < len(toks) and toks[j].text == "(":
                close = _match(toks, j, "(", ")")
                yield i, t.text, targs, _split_commas(toks[j + 1:close])
                i = close + 1
                continue
        i += 1


def roles(src: CudaSource) -> tuple[dict[str, dict[str, set[int]]],
                                    set[str]]:
    """({function: {role: parameter indices}}, the primitives) for the
    roles ``init``, ``arrive``, ``wait``, ``parity``, ``tma_bar``,
    ``tma_dst``: read from the asm of the mbarrier and TMA primitives,
    and carried to every function that passes its own parameter on to
    one of them."""
    out: dict[str, dict[str, set[int]]] = {}
    funcs = [f for f in src.functions if not f.is_kernel]
    for f in funcs:
        pnames = [p[1] for p in f.params]
        r: dict[str, set[int]] = {}
        for i, t in enumerate(f.body):
            if t.text != "asm":
                continue
            end = i
            while f.body[end].text != ";":
                end += 1
            text, ops = _asm_parts(f.body[i:end])
            br = _brackets(text)

            def param_of(n):
                if n >= len(ops):
                    return None
                ids = [o.text for o in ops[n] if o.text in pnames]
                return pnames.index(ids[0]) if ids else None

            def add(role, n):
                p = param_of(n)
                if p is not None:
                    r.setdefault(role, set()).add(p)

            if "mbarrier.init" in text and br and br[0]:
                add("init", br[0][0])
            elif "mbarrier.arrive" in text and br and br[0]:
                add("arrive", br[0][0])
            elif "mbarrier.try_wait" in text and br and br[0]:
                add("wait", br[0][0])
                rest = [int(n) for n in _PCT.findall(
                    text.split("]", 1)[1])] if "]" in text else []
                if rest:
                    add("parity", rest[0])
            elif "cp.async.bulk.tensor" in text and \
                    "mbarrier::complete_tx" in text and len(br) >= 2:
                add("tma_dst", br[0][0])
                add("tma_bar", br[-1][0])
        if r:
            out[f.name] = r
    primitives = set(out)
    changed = True
    while changed:
        changed = False
        for f in funcs:
            pnames = [p[1] for p in f.params]
            r = out.setdefault(f.name, {})
            for _, name, _, args in _calls(f.body, set(out)):
                if name == f.name:
                    continue
                for role, idxs in out[name].items():
                    for idx in idxs:
                        if idx >= len(args):
                            continue
                        for tok in args[idx]:
                            if tok.text in pnames:
                                p = pnames.index(tok.text)
                                if p not in r.get(role, set()):
                                    r.setdefault(role, set()).add(p)
                                    changed = True
    return {k: v for k, v in out.items() if v}, primitives


# ---------------------------------------------------------------------------
# statements
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Stmt:
    kind: str                  # block, if, for, return, expr, other
    toks: list[Tok]
    parts: list = dataclasses.field(default_factory=list)

    @property
    def line(self) -> int:
        return self.toks[0].line if self.toks else 0


def _stmt_end(toks: list[Tok], i: int) -> int:
    """Index of the ``;`` ending the expression statement at ``i``
    (brackets of every kind nest: a lambda's body stays inside)."""
    depth = 0
    for j in range(i, len(toks)):
        if toks[j].text in "([{":
            depth += 1
        elif toks[j].text in ")]}":
            depth -= 1
        elif toks[j].text == ";" and depth == 0:
            return j
    return len(toks) - 1


def parse_stmts(toks: list[Tok]) -> list[Stmt]:
    out, i = [], 0
    while i < len(toks):
        s, i = _parse_stmt(toks, i)
        if s is not None:
            out.append(s)
    return out


def _parse_stmt(toks: list[Tok], i: int) -> tuple[Stmt | None, int]:
    t = toks[i].text
    if t == ";":
        return None, i + 1
    if t == "{":
        e = _match(toks, i, "{", "}")
        return Stmt("block", toks[i:e + 1], parse_stmts(toks[i + 1:e])), e + 1
    if t == "if":
        j = i + 1
        constexpr = toks[j].text == "constexpr"
        if constexpr:
            j += 1
        c = _match(toks, j, "(", ")")
        cond = toks[j + 1:c]
        then, k = _parse_stmt(toks, c + 1)
        other = None
        if k < len(toks) and toks[k].text == "else":
            other, k = _parse_stmt(toks, k + 1)
        return Stmt("if", toks[i:k], [cond, then, other]), k
    if t == "for":
        c = _match(toks, i + 1, "(", ")")
        head = toks[i + 2:c]
        semis = [n for n, x in enumerate(head) if x.text == ";"]
        if len(semis) != 2:
            body, k = _parse_stmt(toks, c + 1)
            return Stmt("other", toks[i:k], [body]), k
        init, cond, step = (head[:semis[0]], head[semis[0] + 1:semis[1]],
                            head[semis[1] + 1:])
        body, k = _parse_stmt(toks, c + 1)
        return Stmt("for", toks[i:k], [init, cond, step, body]), k
    if t in ("while", "switch"):
        c = _match(toks, i + 1, "(", ")")
        body, k = _parse_stmt(toks, c + 1)
        return Stmt("other", toks[i:k], [body]), k
    if t == "do":
        body, k = _parse_stmt(toks, i + 1)
        e = _stmt_end(toks, k)
        return Stmt("other", toks[i:e + 1], [body]), e + 1
    e = _stmt_end(toks, i)
    kind = "return" if t == "return" else "expr"
    return Stmt(kind, toks[i:e]), e + 1


# ---------------------------------------------------------------------------
# the simulation of one function's program order (thread 0)
# ---------------------------------------------------------------------------


class CannotProve(Exception):
    pass


@dataclasses.dataclass
class Event:
    kind: str                  # init arrive wait tma fence sync commit
    line: int                  # wait_group
    bar: int | None = None
    text: str = ""
    stage: tuple | None = None


class _Sim:
    def __init__(self, src: CudaSource, fn: CFunc, rl: dict, trips: dict):
        self.src, self.fn, self.roles = src, fn, rl
        env = {p: TEMPLATE_SAMPLE for p in fn.tparams}
        env.update({"threadIdx.x": 0, "threadIdx.y": 0, "threadIdx.z": 0})
        env.update(trips)
        self.exact = CEval(src, env=env, scope=fn)
        self.addr = _addresses(src, fn, env)
        self.lambdas = fn.lambdas()
        self.events: list[Event] = []
        self.relevant = set(rl) | {"__syncthreads"}
        self.event_lambdas = {
            n for n, lam in self.lambdas.items()
            if any(t.text in self.relevant or t.text == "asm"
                   for t in lam.body)}
        self.relevant |= self.event_lambdas

    def has_events(self, toks: list[Tok]) -> bool:
        for t in toks:
            if t.text in self.relevant:
                return True
            if t.kind == "str" and any(k in t.text for k in (
                    "mbarrier", "cp.async.bulk")):
                return True
        return False

    def cond(self, toks: list[Tok], frame: dict):
        try:
            return bool(self.exact.eval(toks, frame))
        except (CEvalError, TypeError):
            return None

    def run(self, stmts: list[Stmt], frame: dict) -> bool:
        """Simulate; True when a ``return`` was reached."""
        for s in stmts:
            if self.stmt(s, frame):
                return True
        return False

    def stmt(self, s: Stmt, frame: dict) -> bool:
        if s.kind == "block":
            return self.run(s.parts, dict(frame))
        if s.kind == "return":
            return True
        if s.kind == "if":
            cond, then, other = s.parts
            c = self.cond(cond, frame)
            if c is None:
                if self.has_events(s.toks):
                    raise CannotProve(f"an undecidable branch at line "
                                      f"{s.line} holds ring operations")
                return False             # e.g. `if (h >= H) return;`
            branch = then if c else other
            return self.stmt(branch, frame) if branch is not None else False
        if s.kind == "for":
            if not self.has_events(s.toks):
                return False
            init, cond, step, body = s.parts
            local = dict(frame)
            self.declare(init, local)
            for _ in range(MAX_ITER):
                c = self.cond(cond, local)
                if c is None:
                    raise CannotProve(f"the loop at line {s.line} has an "
                                      f"undecidable bound")
                if not c:
                    return False
                if self.stmt(body, dict(local)):
                    return True
                self.step(step, local)
            raise CannotProve(f"the loop at line {s.line} runs too long")
        if s.kind == "other":
            if self.has_events(s.toks):
                raise CannotProve(f"ring operations inside the loop at "
                                  f"line {s.line}")
            return False
        self.expr(s.toks, frame)
        return False

    def declare(self, toks: list[Tok], frame: dict) -> None:
        for d in _declarators(toks):
            try:
                frame[d.name] = self.exact.eval(d.init, frame)
            except (CEvalError, TypeError):
                frame.pop(d.name, None)

    def step(self, toks: list[Tok], frame: dict) -> None:
        texts = [t.text for t in toks]
        if len(texts) == 2 and texts[0] in ("++", "--"):
            name, d = texts[1], 1 if texts[0] == "++" else -1
        elif len(texts) == 2 and texts[1] in ("++", "--"):
            name, d = texts[0], 1 if texts[1] == "++" else -1
        elif len(texts) >= 3 and texts[1] in ("+=", "-="):
            name = texts[0]
            d = self.exact.eval(toks[2:], frame)
            d = d if texts[1] == "+=" else -d
        else:
            raise CannotProve(f"loop step {' '.join(texts)}")
        frame[name] = frame[name] + d

    def expr(self, toks: list[Tok], frame: dict) -> None:
        if len(toks) > 3 and toks[0].text == "auto" and toks[2].text == "=" \
                and toks[3].text == "[":
            return                          # a lambda: run where called
        if toks and toks[0].kind == "id" and "=" in [t.text for t in toks]:
            self.declare(toks, frame)
        if toks and toks[0].text == "asm":
            text, _ = _asm_parts(toks)
            self.asm(text, toks[0].line)
            return
        for idx, name, targs, args in _calls(toks, self.relevant):
            line = toks[idx].line
            if name == "__syncthreads":
                self.events.append(Event("sync", line))
            elif name in self.event_lambdas:
                lam = self.lambdas[name]
                inner = dict(frame)
                for p, a in zip(lam.params, args):
                    inner[p] = self.exact.eval(a, frame)
                self.run(parse_stmts(lam.body), inner)
            else:
                self.call(name, args, frame, line)

    def asm(self, text: str, line: int) -> None:
        if "fence.mbarrier_init" in text:
            self.events.append(Event("fence", line))
        if "cp.async.bulk.commit_group" in text:
            self.events.append(Event("commit", line))
        if "cp.async.bulk.wait_group" in text:
            self.events.append(Event("wait_group", line))

    def call(self, name: str, args, frame: dict, line: int) -> None:
        r = self.roles[name]

        def bar(role):
            idx = min(r[role])
            return self.addr.eval(args[idx], frame), _text(args[idx])

        if "init" in r:
            b, txt = bar("init")
            self.events.append(Event("init", line, b, text=txt))
        if "arrive" in r:
            b, txt = bar("arrive")
            self.events.append(Event("arrive", line, b, text=txt))
        if "tma_bar" in r:
            b, txt = bar("tma_bar")
            stage = None
            if "tma_dst" in r:
                stage = (self.stage(args[min(r["tma_dst"])], frame),
                         self.stage(args[min(r["tma_bar"])], frame))
            self.events.append(Event("tma", line, b, text=txt, stage=stage))
        if "wait" in r:
            b, txt = bar("wait")
            self.events.append(Event("wait", line, b, text=txt))

    def stage(self, toks: list[Tok], frame: dict):
        """(ring lambda, stage) of the first ring-lambda call in
        ``toks``: the stage is the first tile index giving its value."""
        for idx, name, _, args in _calls(toks, set(self.lambdas)):
            lam = self.lambdas[name]
            if len(args) != 1 or len(lam.params) != 1:
                return None
            try:
                u = self.exact.eval(args[0], frame)
                val = self.addr.call(name, [], [u])
                for t in range(max(u, 0) + 1):
                    if self.addr.call(name, [], [t]) == val:
                        return name, t
            except (CEvalError, TypeError):
                return None
        return None


def _addresses(src: CudaSource, fn: CFunc, env: dict) -> CEval:
    """An evaluator of ``fn``'s shared-memory addresses: its parameters
    and the locals that depend on where shared memory lies (a
    ``__cvta_generic_to_shared``) are symbolic bases."""
    ev = CEval(src, env=dict(env), scope=fn, opaque=True)
    for p in fn.params:
        ev.env[p[1]] = ev.symbol(p[1])
    return ev


def _text(toks: list[Tok]) -> str:
    return " ".join(t.text for t in toks).replace(" ( ", "(") \
        .replace(" )", ")").replace("( ", "(")


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


class AsyncPairingRule:
    """Per-source pass over the ``.cu`` files beside ``kernel.py``s."""

    name = RULE

    def run(self, ctxs: list[FileContext],
            root: pathlib.Path) -> Iterator[Finding]:
        for ctx in ctxs:
            if "kernels" not in ctx.parts or ctx.path.name != "kernel.py":
                continue
            for cu in cu_sources(ctx.path):
                src = CudaSource(cu, rel=_rel(cu, root))
                for fd in self.check(src):
                    if not src.suppressed(RULE, fd.line):
                        yield fd

    def check(self, src: CudaSource) -> Iterator[Finding]:
        rl, primitives = roles(src)
        inits = {n for n in primitives if "init" in rl[n]}
        for fn in src.functions:
            if fn.name in primitives or not any(_calls(fn.body, inits)):
                continue
            yield from self._parity(src, fn, rl)
            yield from self._structure(src, fn, rl)

    # -- phase parity, numerically -----------------------------------------

    def _parity(self, src: CudaSource, fn: CFunc,
                rl: dict) -> Iterator[Finding]:
        waits = {n for n, r in rl.items() if "wait" in r and "parity" in r}
        lambdas = fn.lambdas()
        env = {p: TEMPLATE_SAMPLE for p in fn.tparams}
        addr = _addresses(src, fn, env)
        exact = CEval(src, env=dict(env), scope=fn)
        for idx, name, _, args in _calls(fn.body, waits):
            line = fn.body[idx].line
            r = rl[name]
            bar_toks = args[min(r["wait"])]
            par_toks = args[min(r["parity"])]
            ring = [c for c in _calls(bar_toks, set(lambdas))]
            try:
                if not ring:
                    got = exact.eval(par_toks)
                    if got != 0:
                        yield Finding(src.rel, line, 0, RULE,
                                      f"`{name}({_text(bar_toks)}, "
                                      f"{_text(par_toks)})` waits on parity "
                                      f"{got} of a barrier used once: its "
                                      f"first phase has parity 0")
                    continue
                _, lam, _, largs = ring[0]
                if len(largs) != 1:
                    continue
                tile = largs[0]
                names = {t.text for t in tile + par_toks if t.kind == "id"
                         and t.text not in lambdas
                         and t.text not in src.consts
                         and t.text not in fn.tparams}
                if len(names) > 1:
                    continue                 # cannot prove
                var = next(iter(names), None)
                for v in range(N_TILES):
                    frame = {var: v} if var else {}
                    u = exact.eval(tile, frame)
                    if u < 0:
                        continue
                    slot = addr.call(lam, [], [u])
                    want = sum(addr.call(lam, [], [t]) == slot
                               for t in range(u)) % 2
                    got = exact.eval(par_toks, frame) & 1
                    if got != want:
                        yield Finding(
                            src.rel, line, 0, RULE,
                            f"phase parity: `{name}({_text(bar_toks)}, "
                            f"{_text(par_toks)})` in `{fn.name}` waits on "
                            f"parity {got} for tile {u}, whose stage "
                            f"{lam}({u}) completes phase {want} mod 2 there")
                        break
                    if var is None:
                        break
            except (CEvalError, TypeError):
                continue                     # cannot prove, skip

    # -- structure, on thread 0's program order ----------------------------

    def _structure(self, src: CudaSource, fn: CFunc,
                   rl: dict) -> Iterator[Finding]:
        stmts = parse_stmts(fn.body)
        trips = _trip_names(src, fn, stmts, rl)
        seen: set[tuple] = set()
        for n in range(1, TRIPS + 1):
            sim = _Sim(src, fn, rl, {name: n for name in trips})
            try:
                sim.run(stmts, {})
            except CannotProve:
                return
            except (CEvalError, TypeError):
                return
            for fd in self._events(src, fn, sim.events, n):
                key = (fd.line, fd.message.split(" at trip")[0])
                if key not in seen:
                    seen.add(key)
                    yield fd

    def _events(self, src: CudaSource, fn: CFunc, events: list[Event],
                n: int) -> Iterator[Finding]:
        where = f" at trip count {n}"
        arrivals: dict[int, list[Event]] = {}
        waits: dict[int, int] = {}
        inits: dict[int, Event] = {}
        fenced: set[int] = set()
        synced: set[int] = set()
        first_arrival: set[int] = set()
        commits = 0
        for ev in events:
            if ev.kind == "init":
                inits[ev.bar] = ev
            elif ev.kind == "fence":
                fenced |= set(inits)
            elif ev.kind == "sync":
                synced |= set(inits)
            elif ev.kind in ("arrive", "tma"):
                if ev.kind == "tma" and ev.stage is not None \
                        and None not in ev.stage \
                        and ev.stage[0][1] != ev.stage[1][1]:
                    yield Finding(
                        src.rel, ev.line, 0, RULE,
                        f"TMA issue in `{fn.name}` fills stage "
                        f"{ev.stage[0][1]} ({ev.stage[0][0]}) but signals "
                        f"the barrier of stage {ev.stage[1][1]} "
                        f"({ev.stage[1][0]})")
                if ev.bar in inits and ev.bar not in first_arrival:
                    first_arrival.add(ev.bar)
                    if ev.bar not in fenced:
                        yield Finding(
                            src.rel, inits[ev.bar].line, 0, RULE,
                            f"`mbar_init({inits[ev.bar].text})` in "
                            f"`{fn.name}` has no fence.mbarrier_init before "
                            f"the barrier's first arrival (line {ev.line}): "
                            f"the async proxy may not see the init")
                if ev.kind == "arrive":
                    arrivals.setdefault(ev.bar, []).append(ev)
                elif ev.bar not in arrivals:
                    arrivals.setdefault(ev.bar, [])
            elif ev.kind == "wait":
                if ev.bar in inits and ev.bar not in fenced | synced:
                    yield Finding(
                        src.rel, inits[ev.bar].line, 0, RULE,
                        f"`mbar_init({inits[ev.bar].text})` in `{fn.name}` "
                        f"has neither fence.mbarrier_init nor "
                        f"__syncthreads() before its first wait (line "
                        f"{ev.line})")
                    fenced.add(ev.bar)
                k = waits.get(ev.bar, 0)
                if k >= len(arrivals.get(ev.bar, [])):
                    yield Finding(
                        src.rel, ev.line, 0, RULE,
                        f"`mbar_wait({ev.text}, ...)` in `{fn.name}` waits "
                        f"for arrival {k + 1} on a barrier that has had "
                        f"{len(arrivals.get(ev.bar, []))} — this wait can "
                        f"deadlock{where}")
                    return
                waits[ev.bar] = k + 1
            elif ev.kind == "commit":
                commits += 1
            elif ev.kind == "wait_group":
                commits = 0
        for bar, evs in arrivals.items():
            k = waits.get(bar, 0)
            if len(evs) > k:
                ev = evs[k]
                yield Finding(
                    src.rel, ev.line, 0, RULE,
                    f"arrival on `{ev.text}` in `{fn.name}` (line "
                    f"{ev.line}) is never waited: an in-flight copy races "
                    f"the consumer{where}")
        if commits:
            last = [e for e in events if e.kind == "commit"][-1]
            yield Finding(src.rel, last.line, 0, RULE,
                          f"cp.async.bulk.commit_group in `{fn.name}` has "
                          f"no cp.async.bulk.wait_group before the function "
                          f"returns")


def _trip_names(src: CudaSource, fn: CFunc, stmts: list[Stmt],
                rl: dict) -> set[str]:
    """Names in the bounds of ring loops that cannot be evaluated
    (``nt``): the trip counts the simulation sweeps."""
    names: set[str] = set()
    env = {p: TEMPLATE_SAMPLE for p in fn.tparams}
    ev = CEval(src, env=dict(env, **{"threadIdx.x": 0}), scope=fn)
    relevant = set(rl) | {"__syncthreads"}

    def walk(ss):
        for s in ss:
            if s.kind == "for" and any(t.text in relevant for t in s.toks):
                for t in s.parts[1]:
                    if t.kind == "id" and t.text not in src.consts:
                        try:
                            ev.eval([t])
                        except CEvalError:
                            if t.text in fn.decls() or t.text in [
                                    p[1] for p in fn.params]:
                                names.add(t.text)
            for p in s.parts:
                if isinstance(p, Stmt):
                    walk([p])
                elif isinstance(p, list) and p and isinstance(p[0], Stmt):
                    walk(p)

    walk(stmts)
    return names


def _rel(path: pathlib.Path, root: pathlib.Path) -> str:
    try:
        return str(pathlib.Path(path).resolve().relative_to(
            pathlib.Path(root).resolve()))
    except ValueError:
        return str(path)
