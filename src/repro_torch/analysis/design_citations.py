"""design-citations: every section citation into DESIGN.md must resolve.

Docstrings across the repo anchor design claims with section-numbered
citations ("DESIGN.md" followed by ``§``-tokens), so DESIGN.md's
numbering is load-bearing for them.  This rule resolves every citation
in the linted file set against the actual ``§``-headings in DESIGN.md
and flags danglers — the same gate scripts/ci.sh used to run as a
standalone grep pass (now subsumed here, with proper file:line
findings).
"""
from __future__ import annotations

import pathlib
import re
from typing import Iterator

from repro_torch.analysis.core import FileContext, Finding

RULE = "design-citations"

#: a heading like ``## §15 Streamed VMEM tiling``
HEADING_RE = re.compile(r"^#+\s+§([\w.-]+)", re.M)
#: a citation like ``DESIGN.md §15`` or ``DESIGN.md §13, §17``
CITE_RE = re.compile(r"DESIGN\.md\s+((?:§[\w.-]+)(?:,\s*§[\w.-]+)*)")
TOKEN_RE = re.compile(r"§([\w.-]+)")


class DesignCitationsRule:
    name = RULE

    def __init__(self, design_name: str = "DESIGN.md"):
        self.design_name = design_name

    def run(self, ctxs: list[FileContext],
            root: pathlib.Path) -> Iterator[Finding]:
        design = root / self.design_name
        if not design.is_file():
            return
        sections = set(HEADING_RE.findall(design.read_text()))
        for ctx in ctxs:
            for m in CITE_RE.finditer(ctx.source):
                for tok in TOKEN_RE.findall(m.group(1)):
                    if tok in sections:
                        continue
                    line = ctx.source.count("\n", 0, m.start()) + 1
                    nl = ctx.source.rfind("\n", 0, m.start())
                    yield Finding(
                        ctx.rel, line, m.start() - nl - 1, RULE,
                        f"dangling citation: DESIGN.md has no §{tok} "
                        f"heading",
                    )
