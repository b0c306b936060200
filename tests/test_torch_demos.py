"""The port's demos run on the CPU at cut sizes and end with their
``... OK`` line; without ``--device cpu`` they ask for the card."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
DEMOS = {
    "torch_fwi_seismic_demo": ["--size", "96", "--cal-nz", "48"],
    "torch_fleet_autoscale_demo": ["--probe-size", "64"],
    "torch_quickstart": [],
    "torch_elastic_burst_demo": [],
}
#: demos whose CPU run is in a test file of their own
RUN_ELSEWHERE = {"torch_elastic_burst_demo"}   # tests/test_torch_elastic.py
#: the line each demo ends with
OK_LINE = {"torch_quickstart": "quickstart OK"}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(set(DEMOS) - RUN_ELSEWHERE))
def test_demo_runs_on_the_cpu(name, capsys):
    _load(name).main(["--device", "cpu", *DEMOS[name]])
    out = capsys.readouterr().out
    assert out.rstrip().endswith(OK_LINE.get(name, f"{name} OK")), \
        out[-2000:]


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_asks_for_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(DEMOS[name])
