#!/usr/bin/env python
"""Per-package statement-coverage floors for the PyTorch port.

The counterpart of ``scripts/simcov.py`` for ``src/repro_torch``: each
package in ``GATES`` is gated on a minimum statement coverage from the
port's own test modules, at the JAX package's floors — the fleet layer
(DESIGN.md §16), its fault layer (DESIGN.md §19) and the lint suite
(DESIGN.md §18) at 90%, the stencil kernels and the FWI solver (DESIGN.md
§17) at 85%.  The stdlib ``trace`` module gives the executed lines:
the gate's test modules run under a line tracer in a FRESH subprocess
(one gate's imports must not leak into the next gate's tracer), and
traced runs are cached per test set, so gates that share tests pay the
(slow: torch's import alone takes tens of seconds under ``trace``) run
once.

Statements that run only with a card.  Where ``torch.cuda`` sees a card,
the ``gpu``-marked tests in the gate's modules run instead of skipping,
and the floor applies to every statement.  Without a card the report
prints two figures, the whole package and the package without the
functions in ``CARD_ONLY``, and the floor applies to the second.
``CARD_ONLY`` lists functions that raise on CPU tensors or need
``torch.cuda``, ``ctypes`` or the card to run (``tests/test_torch_ci.py``
holds it to that); no function that holds a launch rule is listed, and
no statement is excluded by a pragma.

Usage:  python scripts/torch_simcov.py [--only PKG[,PKG...]]
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

_SIM_TESTS = ("tests/test_torch_fleet.py", "tests/test_torch_faults.py")
_STENCIL_TESTS = ("tests/test_torch_stencil.py", "tests/test_torch_step.py",
                  "tests/test_torch_fwi.py", "tests/test_torch_launch_rules.py",
                  "tests/test_torch_solver_runners.py")

#: (dotted target, floor %, test modules).  A target may be a package
#: directory or a single module.  Torch-heavy suites run many times
#: slower under ``trace``, so each gate lists the smallest set that
#: genuinely exercises its target; gates with the same tuple share one
#: traced run.
GATES = [
    ("repro_torch.sim", 90.0, _SIM_TESTS),
    ("repro_torch.sim.faults", 90.0, _SIM_TESTS),
    ("repro_torch.kernels.stencil", 85.0, _STENCIL_TESTS),
    ("repro_torch.fwi.solver", 85.0, _STENCIL_TESTS),
    ("repro_torch.analysis", 90.0, ("tests/test_torch_lint.py",)),
]

#: tests whose assertion is a wall-clock bound, which a line tracer
#: breaks (it runs Python many times slower): deselected from the traced
#: runs only; the tier-1 suite and ``torch_ci.sh`` run them untraced
TRACE_DESELECT = (
    "tests/test_torch_lint.py::"
    "test_the_port_is_clean_under_its_rules_in_under_10s",
)

#: module -> {function: why it runs only with a card}.  Only top-level
#: functions; every statement of a listed function (its decorators
#: included) leaves the without-card figure.
CARD_ONLY = {
    "repro_torch.kernels.stencil.kernel": {
        "_lib": "builds wave_block.cu with nvcc and loads it by ctypes",
        "_step_lib": "builds wave_step.cu with nvcc and loads it by ctypes",
        "_sm_count": "reads torch.cuda.get_device_properties",
        "_launch_step": "calls the step kernel's library through ctypes "
                        "on the current CUDA stream",
    },
    "repro_torch.kernels.stencil.tune": {
        "device_time_ms": "times by torch.cuda events and synchronize",
        "_sweep_step": "launches wave_step_cuda, which raises on CPU "
                       "tensors",
        "_sweep_block": "launches wave_block_shots_cuda, which raises on "
                        "CPU tensors",
    },
}


def _target_files(dotted: str) -> list[pathlib.Path]:
    """Source files a dotted target covers (package dir or module)."""
    base = ROOT / "src" / pathlib.Path(*dotted.split("."))
    if base.is_dir():
        return sorted(base.glob("*.py"))
    mod = base.with_suffix(".py")
    if mod.is_file():
        return [mod]
    raise SystemExit(f"torch_simcov: no such target {dotted!r} ({base})")


def _module_name(py: pathlib.Path) -> str:
    rel = py.resolve().relative_to(ROOT / "src").with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def card_only_lines(py: pathlib.Path) -> set[int]:
    """Line numbers of the ``CARD_ONLY`` functions of one source file,
    decorators included.  Raises if a listed name is not a top-level
    function there."""
    names = CARD_ONLY.get(_module_name(py), {})
    if not names:
        return set()
    tree = ast.parse(py.read_text(), filename=str(py))
    found: dict[str, set[int]] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in names:
            first = min([node.lineno]
                        + [d.lineno for d in node.decorator_list])
            found[node.name] = set(range(first, node.end_lineno + 1))
    missing = sorted(set(names) - set(found))
    if missing:
        raise SystemExit(f"torch_simcov: CARD_ONLY names {missing} are not "
                         f"top-level functions of {py}")
    return set().union(*found.values())


def have_card() -> bool:
    try:
        import torch
    except ModuleNotFoundError:
        return False
    return bool(torch.cuda.is_available())


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    # the parity tests import jax only to hold the port to it: never on
    # a card
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _traced_lines(tests: tuple[str, ...],
                  _cache: dict = {}) -> dict[str, set[int]]:
    """Executed lines per absolute filename for one traced test run, in
    a fresh subprocess (``--trace-json`` child mode): tracing in-process
    would let an earlier gate's imports hide module top levels from a
    later gate's tracer."""
    if tests in _cache:
        return _cache[tests]
    fd, out = tempfile.mkstemp(suffix=".json", prefix="torch-simcov-")
    os.close(fd)
    try:
        rc = subprocess.call(
            [sys.executable, os.path.abspath(__file__),
             "--trace-json", out, *tests],
            cwd=ROOT, env=_env(),
        )
        if rc != 0:
            raise SystemExit(f"torch_simcov: test run failed (exit {rc}): "
                             f"{tests}")
        with open(out) as fh:
            raw = json.load(fh)
    finally:
        os.unlink(out)
    executed = {fn: set(lines) for fn, lines in raw.items()}
    _cache[tests] = executed
    return executed


def _trace_json(out: str, tests: list[str]) -> int:
    """Child mode: run ``tests`` under a line tracer, dump hit lines."""
    import trace

    import pytest

    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT / "src"))
    # no ignoredirs: trace caches its decisions by bare module name, so
    # ignoring the stdlib's ``queue.py`` would also ignore sim/queue.py
    tracer = trace.Trace(count=1, trace=0)
    deselect = [a for t in TRACE_DESELECT
                if t.split("::")[0] in tests for a in ("--deselect", t)]
    rc = tracer.runfunc(
        pytest.main, ["-q", "-p", "no:cacheprovider", *deselect, *tests]
    )
    if rc != 0:
        return int(rc)
    executed: dict[str, list[int]] = {}
    for (fn, lineno), cnt in tracer.results().counts.items():
        if cnt > 0:
            executed.setdefault(os.path.abspath(fn), []).append(lineno)
    with open(out, "w") as fh:
        json.dump(executed, fh)
    return 0


def _statements(py: pathlib.Path) -> set[int]:
    """Executable line numbers, straight from the code objects: the
    analysis ``trace --count --missing`` reports on, less the line 0
    that Python 3.12 gives a module's ``RESUME`` (no statement, and
    never reported as run)."""
    import trace

    return {n for n in trace._find_executable_linenos(str(py)) if n > 0}


def _pct(hit: int, total: int) -> float:
    return 100.0 * hit / total if total else 100.0


def report(dotted: str, floor: float, tests, executed, card: bool
           ) -> tuple[float, float, list[str]]:
    """Print one gate's table; return (whole %, without-CARD_ONLY %, the
    uncovered ``file:line``s that count: all of them with a card, those
    outside ``CARD_ONLY`` without)."""
    print(f"-- {dotted} (floor {floor:g}%, tests: "
          f"{', '.join(t.rsplit('/', 1)[-1] for t in tests)})")
    print(f"{'module':<22}{'stmts':>7}{'hit':>7}{'cover':>8}"
          f"{'card-only':>11}{'rest':>8}")
    whole = [0, 0]
    rest = [0, 0]
    missed = []
    for py in _target_files(dotted):
        fn = str(py.resolve())
        lnos = _statements(py)
        hit = executed.get(fn, set()) & lnos
        card_lines = lnos & card_only_lines(py)
        kept = lnos - card_lines
        kept_hit = hit & kept
        whole[0] += len(hit)
        whole[1] += len(lnos)
        rest[0] += len(kept_hit)
        rest[1] += len(kept)
        missed += [f"{py.relative_to(ROOT)}:{n}"
                   for n in sorted((lnos if card else kept) - hit)]
        print(f"{py.name:<22}{len(lnos):>7}{len(hit):>7}"
              f"{_pct(len(hit), len(lnos)):>7.1f}%{len(card_lines):>11}"
              f"{_pct(len(kept_hit), len(kept)):>7.1f}%")
    w, r = _pct(*whole), _pct(*rest)
    print(f"{'TOTAL':<22}{whole[1]:>7}{whole[0]:>7}{w:>7.1f}%"
          f"{whole[1] - rest[1]:>11}{r:>7.1f}%")
    return w, r, missed


def run_gates(gates, card: bool, show_missing: bool) -> int:
    failed = []
    for dotted, floor, tests in gates:
        t0 = time.perf_counter()
        whole, rest, missed = report(dotted, floor, tests,
                                     _traced_lines(tests), card)
        figure = whole if card else rest
        which = "every statement (a card is present)" if card \
            else "without CARD_ONLY"
        print(f"gate figure: {figure:.1f}% ({which}); "
              f"{time.perf_counter() - t0:.1f} s")
        if show_missing and missed:
            print("uncovered: " + " ".join(missed))
        if figure < floor:
            failed.append(dotted)
            print(f"torch_simcov: {dotted} coverage {figure:.1f}% is below "
                  f"the {floor:g}% floor", file=sys.stderr)
        else:
            print(f"torch_simcov OK: {dotted} {figure:.1f}% >= {floor:g}% "
                  f"floor")
    return 1 if failed else 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--trace-json"]:  # internal child mode
        return _trace_json(argv[1], argv[2:])
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", default="",
                    help="comma-separated dotted targets to gate")
    ap.add_argument("--missing", action="store_true",
                    help="list the uncovered lines that count")
    args = ap.parse_args(argv)
    only = {s for s in args.only.split(",") if s}
    gates = [g for g in GATES if not only or g[0] in only]
    unknown = only - {g[0] for g in gates}
    if unknown:
        ap.error(f"unknown target(s): {sorted(unknown)}")
    t0 = time.perf_counter()
    card = have_card()
    rc = run_gates(gates, card, args.missing)
    print(f"torch_simcov: {len(gates)} gate(s) in "
          f"{time.perf_counter() - t0:.1f} s (card: {card})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
