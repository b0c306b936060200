"""repro-lint for the port: run the suite over the PyTorch port.

Usage (from the repository root):
  PYTHONPATH=src python -m repro_torch.analysis          # the port
  PYTHONPATH=src python -m repro_torch.analysis src/repro_torch/sim
  PYTHONPATH=src python -m repro_torch.analysis --rules host-sync
  PYTHONPATH=src python -m repro_torch.analysis --ci --json /tmp/lint.json
  PYTHONPATH=src python -m repro_torch.analysis --list-rules

The default paths are ``src/repro_torch``, ``examples/torch_*.py`` and
``chip_smoke.py``.  Exit code 0 when clean, 1 when any finding survives
suppressions.  Suppress a finding inline with ``# lint: disable=<rule>
-- why`` on (or on the comment line above) the flagged line, and in a
``.cu`` file with ``// lint: disable=<rule> -- why``.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

from repro_torch.analysis import ALL_RULES, Analyzer, render_human, to_json

#: src/repro_torch/analysis/__main__.py -> repository root
ROOT = pathlib.Path(__file__).resolve().parents[3]


def default_paths(root: pathlib.Path = ROOT) -> list[pathlib.Path]:
    """The port's files: its package, its demos and the card's smoke."""
    return [root / "src" / "repro_torch",
            *sorted((root / "examples").glob("torch_*.py")),
            root / "chip_smoke.py"]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint (default: "
                         "src/repro_torch, examples/torch_*.py, "
                         "chip_smoke.py)")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--json", metavar="PATH", default="",
                    help="also write machine-readable findings to PATH")
    ap.add_argument("--ci", action="store_true",
                    help="CI mode: summary line with timing")
    ap.add_argument("--list-rules", action="store_true",
                    help="print rule ids and one-line docs, then exit")
    args = ap.parse_args(argv)

    rules = [cls() for cls in ALL_RULES]
    if args.list_rules:
        for r in rules:
            head = (sys.modules[type(r).__module__].__doc__ or r.name)
            print(f"{r.name:<18} {head.strip().splitlines()[0]}")
        return 0
    if args.rules:
        wanted = {s.strip() for s in args.rules.split(",") if s.strip()}
        known = {r.name for r in rules}
        unknown = wanted - known
        if unknown:
            ap.error(f"unknown rule(s): {sorted(unknown)} "
                     f"(known: {sorted(known)})")
        rules = [r for r in rules if r.name in wanted]

    t0 = time.perf_counter()
    analyzer = Analyzer(rules, ROOT)
    ctxs = analyzer.load(args.paths or default_paths())
    findings = analyzer.run(ctxs)
    dt = time.perf_counter() - t0

    if args.json:
        pathlib.Path(args.json).write_text(
            to_json(findings, rules=[r.name for r in rules]) + "\n")
    if findings:
        print(render_human(findings))
    if args.ci or not findings:
        print(f"repro-lint (port): {len(ctxs)} files, {len(rules)} rules, "
              f"{len(findings)} finding(s) in {dt:.2f}s")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
