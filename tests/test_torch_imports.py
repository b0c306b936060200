"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package, and the port's copy
of ``repro.core`` differs from the original only in its imports."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
CORE = ["__init__", "allocator", "capacity", "deadline", "gamma",
        "monitor", "orchestrator", "planner"]


def _banned(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _banned(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "jax":
            bad.append(f"jax.{node.attr}")
    assert not bad, f"{path.name} reaches {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules "
        "if n.startswith('repro_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok") and int(out.stdout.split()[1]) > 15


#: the modules of the striped domain, the shot split and the seam probe
STRIPED = ["fwi/domain.py", "fwi/solver.py", "fwi/driver.py",
           "fwi/calibrate.py"]


@pytest.mark.parametrize("name", STRIPED)
def test_striped_modules_stand_alone(name):
    """Each is among the files held to no JAX and no ``repro`` import
    above, and runs its windows as plain calls: no ``torch.vmap``, which
    the JAX lint's tracer-hygiene rule would treat as a traced root."""
    path = ROOT / "src" / "repro_torch" / name
    assert path in PORT_FILES
    test_no_jax_or_repro_imports(path)
    assert "vmap" not in path.read_text()


@pytest.mark.parametrize("name", CORE)
def test_core_is_a_copy(name):
    orig = (ROOT / "src/repro/core" / f"{name}.py").read_text()
    port = (ROOT / "src/repro_torch/core" / f"{name}.py").read_text()
    assert port == orig.replace("repro.core.", "repro_torch.core.")
