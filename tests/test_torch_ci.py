"""The port's CI scripts: ``scripts/torch_simcov.py`` and
``scripts/torch_ci.sh``.

``CARD_ONLY`` is held honest: every function it lists is a top-level
function of the stencil package, names the card in its body
(``torch.cuda``, a ctypes library, a CUDA wrapper) and, on a build
without a card, raises when called; no launch rule is ever listed.  The
floors are never below the JAX package's (``scripts/simcov.py``), and
neither script imports the JAX package or ``benchmarks/``.
"""
import ast
import importlib.util
import re
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.stencil import kernel, tune  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"


def _load_simcov():
    spec = importlib.util.spec_from_file_location(
        "torch_simcov", SCRIPTS / "torch_simcov.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


simcov = _load_simcov()

#: launch rules and cost formulas: pure functions, tested on the CPU,
#: never excused from a floor
RULES = re.compile(r"^(window|smem_bytes|block_threads|launch_shape|"
                   r"shot_groups|step_.*|.*_bytes|.*_flops|.*candidates|"
                   r"pick_.*)$")


def _listed():
    return [(mod, name) for mod, names in simcov.CARD_ONLY.items()
            for name in names]


def _source_file(mod):
    return ROOT / "src" / Path(*mod.split(".")).with_suffix(".py")


def test_card_only_lists_functions_of_the_stencil_package_only():
    assert _listed()
    for mod, names in simcov.CARD_ONLY.items():
        assert mod.startswith("repro_torch.kernels.stencil."), mod
        py = _source_file(mod)
        lines = simcov.card_only_lines(py)   # raises on an unknown name
        assert lines
        for name, why in names.items():
            assert isinstance(why, str) and len(why) > 10, name
            assert not RULES.match(name), f"{name} holds a launch rule"


def _names_the_card(fn: ast.FunctionDef) -> bool:
    src = ast.unparse(fn)
    return bool(re.search(r"torch\.cuda\.|ctypes|build\.load|\b_lib\(|"
                          r"\b_step_lib\(|_cuda\(", src))


def test_card_only_functions_name_the_card_in_their_bodies():
    for mod, name in _listed():
        tree = ast.parse(_source_file(mod).read_text())
        fn = next(n for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name == name)
        assert _names_the_card(fn), f"{mod}.{name}"


def _calls():
    """One call per listed function, on CPU tensors or a CPU device."""
    cpu = torch.device("cpu")
    p = torch.zeros((1, 8, 16))
    v = torch.zeros((8, 16))
    launch = kernel.step_launch(1, 8, 16, (16, 128), 4, 1)
    return {
        ("repro_torch.kernels.stencil.kernel", "_lib"): kernel._lib,
        ("repro_torch.kernels.stencil.kernel", "_step_lib"): kernel._step_lib,
        ("repro_torch.kernels.stencil.kernel", "_sm_count"):
            lambda: kernel._sm_count(0),
        ("repro_torch.kernels.stencil.kernel", "_launch_step"):
            lambda: kernel._launch_step((p, p, v, v, p, p), (16, 128),
                                        launch),
        ("repro_torch.kernels.stencil.tune", "device_time_ms"):
            lambda: tune.device_time_ms(lambda: None, 1),
        ("repro_torch.kernels.stencil.tune", "_sweep_step"):
            lambda: tune._sweep_step.__wrapped__(
                8, 16, 1, ((16, 128),), 1, "cpu", cpu),
        ("repro_torch.kernels.stencil.tune", "_sweep_block"):
            lambda: tune._sweep_block.__wrapped__(
                8, 16, 1, ((32, 64),), (1,), 1, "cpu", cpu),
    }


def test_card_only_functions_raise_without_a_card(monkeypatch, tmp_path):
    """Each listed function fails on a build without a card: CPU tensors
    are refused, or ``torch.cuda`` or the nvcc build is needed."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    calls = _calls()
    assert set(calls) == set(_listed())
    for key, call in calls.items():
        for loader in (kernel._lib, kernel._step_lib):
            loader.cache_clear()
        with pytest.raises((RuntimeError, AssertionError, ValueError,
                            build.BuildError)):
            call()


def _gates(path: Path):
    """The ``GATES`` list of a simcov script, read without importing
    it: {target: floor}."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "GATES" for t in node.targets):
            out = {}
            for elt in node.value.elts:
                out[ast.literal_eval(elt.elts[0])] = \
                    ast.literal_eval(elt.elts[1])
            return out
    raise AssertionError(f"no GATES in {path}")


def test_floors_are_the_jax_packages():
    theirs = _gates(SCRIPTS / "simcov.py")
    mine = {target: floor for target, floor, _ in simcov.GATES}
    assert mine == {t.replace("repro.", "repro_torch.", 1): f
                    for t, f in theirs.items()}
    for target, _, tests in simcov.GATES:
        assert simcov._target_files(target)
        for t in tests:
            assert (ROOT / t).is_file() and Path(t).name.startswith(
                "test_torch_"), t


def test_no_pragma_excludes_a_port_statement():
    for py in (ROOT / "src" / "repro_torch").rglob("*.py"):
        assert "pragma: no cover" not in py.read_text(), py


def test_statements_and_card_only_lines():
    """A module's statements exclude Python 3.12's line-0 ``RESUME``;
    the card-only lines of a module are its listed functions' spans,
    decorators included."""
    py = _source_file("repro_torch.kernels.stencil.kernel")
    stmts = simcov._statements(py)
    assert stmts and min(stmts) >= 1
    lines = simcov.card_only_lines(py)
    tree = ast.parse(py.read_text())
    spans = set()
    for n in tree.body:
        if isinstance(n, ast.FunctionDef) and n.name in simcov.CARD_ONLY[
                "repro_torch.kernels.stencil.kernel"]:
            first = min([n.lineno] + [d.lineno for d in n.decorator_list])
            spans |= set(range(first, n.end_lineno + 1))
    assert lines == spans
    assert simcov.card_only_lines(
        _source_file("repro_torch.kernels.stencil.ref")) == set()


def test_report_floors_the_figure_without_card_only(capsys):
    """Without a card the gate's figure leaves the card-only functions
    out; the table shows both figures."""
    py = _source_file("repro_torch.kernels.stencil.kernel")
    stmts = simcov._statements(py)
    card = simcov.card_only_lines(py) & stmts
    executed = {str(py.resolve()): stmts - card}
    whole, rest, missed = simcov.report(
        "repro_torch.kernels.stencil.kernel", 85.0, ("t.py",), executed,
        card=False)
    assert rest == 100.0 and missed == []
    _, _, missed = simcov.report(
        "repro_torch.kernels.stencil.kernel", 85.0, ("t.py",), executed,
        card=True)
    assert sorted(int(m.rsplit(":", 1)[1]) for m in missed) == sorted(card)
    assert whole == pytest.approx(100.0 * len(stmts - card) / len(stmts))
    out = capsys.readouterr().out
    assert "card-only" in out and "TOTAL" in out


IMPORT_JAX = re.compile(r"from repro\.|import repro\b|benchmarks")


@pytest.mark.parametrize("script", ["torch_ci.sh", "torch_simcov.py"])
def test_scripts_import_nothing_of_the_jax_package(script):
    """Only the ci script's header notes on left-out stages may name
    ``benchmarks/``."""
    lines = (SCRIPTS / script).read_text().splitlines()
    header = True
    for line in lines:
        if script.endswith(".sh") and header and (
                line.startswith("#") or not line):
            continue
        header = False
        assert not IMPORT_JAX.search(line), line


def test_ci_script_stages_in_order():
    text = (SCRIPTS / "torch_ci.sh").read_text()
    assert subprocess.run(["bash", "-n", str(SCRIPTS / "torch_ci.sh")]
                          ).returncode == 0
    assert text.startswith("#!/usr/bin/env bash")
    assert "set -euo pipefail" in text and 'PYTHONPATH="src' in text
    stages = re.findall(r'^echo "== (.+) =="$', text, re.M)
    assert stages == ["lint", "tier-1 tests (port)", "fused-engine smoke",
                      "fleet smoke", "fleet-tournament smoke",
                      "fault-storm smoke", "coverage floors",
                      "real-elastic smoke"]
    # every stage prints an OK line of its own
    for stage in stages:
        head = stage.split(" (")[0]
        assert re.search(rf"{re.escape(head)}[^\n]*OK", text), stage
    assert "python scripts/torch_simcov.py" in text
    assert 'device="cpu"' in text and "tests/test_torch_*.py" in text
