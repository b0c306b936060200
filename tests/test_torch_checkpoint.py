"""bf16 and fp8 checkpoint leaves across the two packages.

numpy has no bfloat16 or float8 type, so both managers store such a leaf
as its raw bytes (``uint16`` or ``uint8``) and name the true type in the
manifest, by JAX's names.  A checkpoint written by either package
restores in the other with equal bits.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402,E501
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402

#: manifest name -> (torch dtype, jnp dtype)
RAW = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
       "float8_e4m3fn": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


def _values(seed):
    """Unit-normal values with a few exact ones, as f32 (3, 4)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, 4), dtype=np.float32)
    a[0, :3] = (0.0, 1.0, -2.0)
    return a


def _manifest(directory, step):
    return json.loads(
        (directory / f"step_{step:08d}" / "manifest.json").read_text())


def _bits(t: torch.Tensor) -> np.ndarray:
    ints = {1: torch.int8, 2: torch.int16}[t.element_size()]
    return t.view(ints).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.dtype(f"i{a.dtype.itemsize}"))


def _abstract(tree):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        tree)


def test_roundtrip_and_extra(tmp_path):
    """The port's mirror of the JAX package's test: f32, bf16 and int
    leaves, extra, bits equal."""
    state = {
        "params": {"w": torch.arange(12.0).reshape(3, 4),
                   "b": torch.ones((4,), dtype=torch.bfloat16)},
        "opt": {"m": torch.zeros((3, 4)), "count": torch.tensor(3)},
    }
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(5, state, extra={"data_step": 5})
    restored, extra = m.restore(state)
    assert extra == {"data_step": 5}
    for k in ("params", "opt"):
        for name, want in state[k].items():
            got = restored[k][name]
            assert got.dtype == want.dtype
            assert torch.equal(got, want)
    assert _manifest(tmp_path, 5)["leaves"]["params__b"]["dtype"] \
        == "bfloat16"


@pytest.mark.parametrize("name", sorted(RAW))
def test_port_roundtrip_bits_equal(tmp_path, name):
    tdt, _ = RAW[name]
    t = torch.from_numpy(_values(1)).to(tdt)
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(1, {"x": t})
    got, _ = m.restore({"x": t})
    assert got["x"].dtype == tdt
    np.testing.assert_array_equal(_bits(got["x"]), _bits(t))
    meta = _manifest(tmp_path, 1)["leaves"]["x"]
    assert meta["dtype"] == name
    assert np.load(tmp_path / "step_00000001" / meta["file"]).dtype \
        == np.dtype(f"u{t.element_size()}")


@pytest.mark.parametrize("name", sorted(RAW))
def test_jax_writes_port_restores(tmp_path, name):
    tdt, jdt = RAW[name]
    a = jnp.asarray(_values(2)).astype(jdt)
    JManager(tmp_path, async_save=False).save(3, {"p": {"x": a}})
    assert _manifest(tmp_path, 3)["leaves"]["p__x"]["dtype"] == name
    got, _ = CheckpointManager(tmp_path, async_save=False).restore(
        {"p": {"x": 0}})
    assert got["p"]["x"].dtype == tdt
    np.testing.assert_array_equal(_bits(got["p"]["x"]), _jbits(a))


@pytest.mark.parametrize("name", sorted(RAW))
def test_port_writes_jax_restores(tmp_path, name):
    tdt, jdt = RAW[name]
    t = torch.from_numpy(_values(3)).to(tdt)
    CheckpointManager(tmp_path, async_save=False).save(4, {"p": {"x": t}})
    assert _manifest(tmp_path, 4)["leaves"]["p__x"]["dtype"] == name
    target = {"p": {"x": jnp.zeros((3, 4), jdt)}}
    got, _ = JManager(tmp_path, async_save=False).restore(_abstract(target))
    x = got["p"]["x"]
    assert x.dtype == jdt
    np.testing.assert_array_equal(np.asarray(x, np.float32),
                                  t.float().numpy())
    np.testing.assert_array_equal(_jbits(x), _bits(t))


def test_unknown_manifest_dtype_still_raises(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(2, {"x": torch.zeros(4, dtype=torch.bfloat16)})
    path = tmp_path / "step_00000002" / "manifest.json"
    manifest = json.loads(path.read_text())
    manifest["leaves"]["x"]["dtype"] = "float4_e2m1fn"
    path.write_text(json.dumps(manifest))
    with pytest.raises(TypeError, match="has no numpy dtype here"):
        m.restore({"x": 0}, step=2)
