"""repro-lint core: AST static-analysis framework (DESIGN.md §18).

The pieces every rule shares:

* ``Finding``      — one structured diagnostic (file:line:col, rule id,
                     message), ordered and hashable so reports are
                     stable and deduplicated.
* ``FileContext``  — a parsed source file (path, text, AST, per-line
                     suppression map).
* ``Rule``         — the protocol: a ``name`` and
                     ``run(ctxs, root) -> findings``.  Rules see the
                     WHOLE file set, so cross-file passes (e.g. the
                     vmem-budget rule reading the capacity formulas
                     from one module and the kernels from another) are
                     first-class; ``PerFileRule`` is the trivial
                     adapter for rules that only look at one file at a
                     time.
* ``Analyzer``     — loads files, runs rules, applies inline
                     suppressions, renders human or JSON output.

Suppressions: ``# lint: disable=<rule>[,<rule>...]`` on the finding's
line silences those rules there; on a comment-only line it also covers
the next line (the idiom for multi-line calls: put the comment — with
a justification after the rule list — right above the call).
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Iterable, Iterator, Protocol, runtime_checkable

SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([\w,-]+)")

_EMPTY: frozenset[str] = frozenset()


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic: where (file:line:col), what (rule), why (message)."""

    file: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _suppression_map(lines: list[str]) -> dict[int, set[str]]:
    """line number -> rule names silenced there (1-based).

    A marker on a code line covers that line; a marker inside a
    comment block ALSO covers the next code line after the block, so
    multi-line justifications can sit above a multi-line call."""
    out: dict[int, set[str]] = {}

    def is_commentish(text: str) -> bool:
        s = text.strip()
        return not s or s.startswith("#")

    for idx, text in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(idx, set()).update(rules)
        if text.lstrip().startswith("#"):
            nxt = idx + 1
            while nxt <= len(lines) and is_commentish(lines[nxt - 1]):
                nxt += 1
            out.setdefault(nxt, set()).update(rules)
    return out


class FileContext:
    """A parsed source file as rules see it."""

    def __init__(self, path: str | pathlib.Path, source: str,
                 rel: str | None = None):
        self.path = pathlib.Path(path)
        self.rel = rel if rel is not None else str(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self._suppressed = _suppression_map(self.lines)

    @property
    def parts(self) -> tuple[str, ...]:
        return pathlib.PurePosixPath(self.rel.replace("\\", "/")).parts

    def suppressed(self, rule: str, line: int) -> bool:
        rules = self._suppressed.get(line, _EMPTY)
        return rule in rules or "all" in rules


@runtime_checkable
class Rule(Protocol):
    """A lint rule: a stable id and a pass over the parsed file set."""

    name: str

    def run(self, ctxs: list[FileContext],
            root: pathlib.Path) -> Iterator[Finding]: ...


class PerFileRule:
    """Adapter for rules that inspect one file at a time."""

    name = "per-file"

    def run(self, ctxs: list[FileContext],
            root: pathlib.Path) -> Iterator[Finding]:
        for ctx in ctxs:
            yield from self.check(ctx)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError


def iter_py_files(paths: Iterable[str | pathlib.Path],
                  root: pathlib.Path) -> Iterator[pathlib.Path]:
    for p in paths:
        p = pathlib.Path(p)
        if not p.is_absolute():
            p = root / p
        if p.is_dir():
            yield from sorted(
                f for f in p.rglob("*.py") if "__pycache__" not in f.parts
            )
        elif p.suffix == ".py" and p.exists():
            yield p


class Analyzer:
    """Load a file set, run rules over it, apply suppressions."""

    def __init__(self, rules: Iterable[Rule], root: str | pathlib.Path):
        self.rules = list(rules)
        self.root = pathlib.Path(root)

    def load(self, paths: Iterable[str | pathlib.Path]) -> list[FileContext]:
        ctxs = []
        for f in iter_py_files(paths, self.root):
            try:
                rel = str(f.relative_to(self.root))
            except ValueError:
                rel = str(f)
            ctxs.append(FileContext(f, f.read_text(), rel=rel))
        return ctxs

    def run(self, ctxs: list[FileContext]) -> list[Finding]:
        by_rel = {c.rel: c for c in ctxs}
        findings: set[Finding] = set()
        for rule in self.rules:
            for fd in rule.run(ctxs, self.root):
                ctx = by_rel.get(fd.file)
                if ctx is not None and ctx.suppressed(fd.rule, fd.line):
                    continue
                findings.add(fd)
        return sorted(findings)


def analyze_source(source: str, rules, filename: str = "fixture.py",
                   root: str | pathlib.Path | None = None) -> list[Finding]:
    """Run rules over one in-memory source blob (the test-fixture API).

    ``filename`` doubles as the relative path rules use for
    applicability (e.g. ``src/repro/sim/x.py`` for sim-determinism)."""
    if not isinstance(rules, (list, tuple)):
        rules = [rules]
    ctx = FileContext(filename, source, rel=filename)
    rootp = pathlib.Path(root) if root is not None else pathlib.Path(".")
    out: set[Finding] = set()
    for rule in rules:
        for fd in rule.run([ctx], rootp):
            if fd.file == ctx.rel and ctx.suppressed(fd.rule, fd.line):
                continue
            out.add(fd)
    return sorted(out)


def render_human(findings: list[Finding]) -> str:
    return "\n".join(f.render() for f in findings)


def to_json(findings: list[Finding], rules: Iterable[str] = ()) -> str:
    return json.dumps(
        {
            "version": 1,
            "rules": sorted(rules),
            "count": len(findings),
            "findings": [f.to_dict() for f in findings],
        },
        indent=2,
    )
