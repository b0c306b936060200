"""The port stands alone: ``src/repro_torch``, its demos
(``examples/torch_*.py``) and ``chip_smoke.py`` import neither JAX nor
anything of the JAX package, and the port's
copies of ``repro.core`` and ``repro.sim`` differ from the originals
only in their imports (and ``sim/scenarios.py`` in its two probe
literals, which hold the card's own measurements)."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
CORE = ["__init__", "allocator", "capacity", "deadline", "events", "gamma",
        "monitor", "orchestrator", "planner", "sim_session"]
SIM = ["__init__", "autoscalers", "faults", "fleet", "queue", "scenarios",
       "schedulers"]
#: the module-level literals of ``sim/scenarios.py`` that the port
#: measures on the card instead of copying
PROBES = ("SEAM_PROBE", "SHOT_BATCH_PROBE")


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


#: the mixture-of-experts module and the configs of the Jamba and dense
#: slice; multi-head latent attention and the DeepSeek configs; the
#: whisper encoder and the qwen2-vl and whisper configs
MOE = ["models/moe.py", "models/transformer.py", "configs/jamba_v0_1_52b.py",
       "configs/yi_9b.py", "configs/granite_8b.py", "configs/minitron_8b.py",
       "models/mla.py", "configs/deepseek_v2_236b.py",
       "configs/deepseek_v3_671b.py", "models/encdec.py",
       "configs/qwen2_vl_72b.py", "configs/whisper_large_v3.py"]
CONFIGS = ["jamba_v0_1_52b", "yi_9b", "granite_8b", "minitron_8b",
           "deepseek_v2_236b", "deepseek_v3_671b", "qwen2_vl_72b",
           "whisper_large_v3"]


@pytest.mark.parametrize("name", MOE)
def test_moe_modules_stand_alone(name):
    """Each is among the files held to no JAX and no ``repro`` import
    above, and loops over its token groups where the JAX package scans
    or maps: no ``torch.vmap``, which the JAX lint's tracer-hygiene rule
    would treat as a traced root."""
    path = ROOT / "src" / "repro_torch" / name
    assert path in PORT_FILES
    test_no_jax_or_repro_imports(path)
    assert "vmap" not in path.read_text()


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_are_copies(name):
    """The port's config module is the JAX package's with only its
    imports changed."""
    orig = (ROOT / "src/repro/configs" / f"{name}.py").read_text()
    port = (ROOT / "src/repro_torch/configs" / f"{name}.py").read_text()
    assert port == _ported(orig)


@pytest.mark.parametrize("name", CORE)
def test_core_is_a_copy(name):
    orig = (ROOT / "src/repro/core" / f"{name}.py").read_text()
    port = (ROOT / "src/repro_torch/core" / f"{name}.py").read_text()
    assert port == orig.replace("repro.core.", "repro_torch.core.")


def _ported(text: str) -> str:
    """``text`` with every ``repro.`` module path turned into the
    port's (a word-bounded rewrite: ``from repro.core import`` too)."""
    return re.sub(r"\brepro\.", "repro_torch.", text)


def _without_probes(text: str) -> str:
    """``text`` without the assignments of ``PROBES`` and the comment
    block right above each, cut by the lines ``ast`` gives them."""
    lines = text.splitlines(keepends=True)
    cut = set()
    for node in ast.parse(text).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in PROBES
                for t in node.targets):
            first = node.lineno - 1
            while first > 0 and lines[first - 1].lstrip().startswith("#"):
                first -= 1
            cut.update(range(first, node.end_lineno))
    assert len(cut) > 2 * len(PROBES), "probe literals not found"
    return "".join(ln for i, ln in enumerate(lines) if i not in cut)


@pytest.mark.parametrize("name", SIM)
def test_sim_is_a_copy(name):
    orig = (ROOT / "src/repro/sim" / f"{name}.py").read_text()
    port = (ROOT / "src/repro_torch/sim" / f"{name}.py").read_text()
    if name == "scenarios":
        orig, port = _without_probes(orig), _without_probes(port)
    assert port == _ported(orig)


def _probes(path: Path) -> tuple[dict, str]:
    """The probe literals of a ``scenarios.py`` and the comments above
    them."""
    text = path.read_text()
    values, comments = {}, []
    lines = text.splitlines()
    for node in ast.parse(text).body:
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Name) and node.targets[0].id in PROBES:
            values[node.targets[0].id] = ast.literal_eval(node.value)
            i = node.lineno - 1
            while i > 0 and lines[i - 1].lstrip().startswith("#"):
                i -= 1
                comments.append(lines[i])
    return values, "\n".join(comments)


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_sim_probes_are_the_cards():
    """The port's two probe literals carry the JAX package's keys, were
    taken on the card (``backend`` "cuda", one device under the seam
    probe) and say which card, at which power limit."""
    port, comment = _probes(ROOT / "src/repro_torch/sim/scenarios.py")
    orig, _ = _probes(ROOT / "src/repro/sim/scenarios.py")
    assert set(port) == set(PROBES)
    for name in PROBES:
        assert _keys(port[name]) == _keys(orig[name]), name
    seam, batch = port["SEAM_PROBE"], port["SHOT_BATCH_PROBE"]
    assert seam["backend"] == "cuda" and seam["mesh_devices"] == 1
    assert seam["n_stripes"] == 2 and seam["plan"]["k"] == 4
    assert batch["config"]["backend"] == "cuda"
    assert tuple(batch["s_values"]) == (1, 2, 4)
    assert all(t > 0 for t in batch["t_step_s"])
    assert re.search(r"NVIDIA H100", comment)
    assert re.search(r"\d+\.\d+ W", comment)


#: the placements and the kernels' DTensor branch
PLACEMENTS = ["sharding/__init__.py", "sharding/rules.py", "launch/mesh.py",
              "kernels/local.py"]


@pytest.mark.parametrize("name", PLACEMENTS)
def test_placement_modules_are_held_to_no_jax(name):
    path = ROOT / "src" / "repro_torch" / name
    assert path in PORT_FILES


#: the cross-pod compression and the modules of sharded serving and the
#: compressed step
SHARDED = ["optim/compression.py", "runtime/serve_step.py",
           "runtime/train_step.py", "launch/serve.py", "models/model.py",
           "models/attention.py", "models/mla.py"]


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_serving_and_compression_modules_are_held_to_no_jax(name):
    """Each is among the files held to no JAX and no ``repro`` import
    above, and defines no ``shard_map`` (the JAX lint's tracer-hygiene
    rule roots on that name)."""
    path = ROOT / "src" / "repro_torch" / name
    assert path in PORT_FILES
    test_no_jax_or_repro_imports(path)
    assert "def shard_map" not in path.read_text()


#: the launch layer's cost tools and the input specs they read
LAUNCH = ["launch/hw.py", "launch/roofline.py", "launch/op_cost.py",
          "launch/dryrun.py", "launch/perf.py", "configs/shapes.py"]


@pytest.mark.parametrize("name", LAUNCH)
def test_launch_cost_modules_are_held_to_no_jax(name):
    """Each is among the files held to no JAX and no ``repro`` import
    above; none sets ``XLA_FLAGS`` (the JAX package's dry run and perf
    harness do, at import)."""
    path = ROOT / "src" / "repro_torch" / name
    assert path in PORT_FILES
    test_no_jax_or_repro_imports(path)
    assert "XLA_FLAGS" not in path.read_text()


def test_artifacts_are_not_committed():
    """The dry run and the perf harness write under ``artifacts/``."""
    lines = (ROOT / ".gitignore").read_text().split()
    assert "artifacts/" in lines


#: the lint suite's modules copied from ``repro.analysis`` with only
#: their imports changed, and the port's own (``csrc``, the port's three
#: rules, the evaluator it grew, the CLI)
ANALYSIS_COPIES = ["core", "design_citations", "sim_determinism"]
ANALYSIS = ANALYSIS_COPIES + ["__init__", "__main__", "async_pairing", "csrc",
                              "host_sync", "smem_budget", "symeval"]


@pytest.mark.parametrize("name", ANALYSIS_COPIES)
def test_analysis_copies_differ_only_in_their_imports(name):
    orig = (ROOT / "src/repro/analysis" / f"{name}.py").read_text()
    port = (ROOT / "src/repro_torch/analysis" / f"{name}.py").read_text()
    assert port == _ported(orig)


@pytest.mark.parametrize("name", ANALYSIS)
def test_analysis_imports_neither_torch_nor_jax(name):
    """Each is among the files held to no JAX and no ``repro`` import
    above, and imports no torch: the rules read sources as text."""
    path = ROOT / "src" / "repro_torch" / "analysis" / f"{name}.py"
    assert path in PORT_FILES
    test_no_jax_or_repro_imports(path)
    tree = ast.parse(path.read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)]
    assert not [m for m in mods if m.split(".")[0] in ("torch", "numpy")]
