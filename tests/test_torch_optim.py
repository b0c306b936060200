"""The port's optimizers and schedules against the JAX package's, on the
CPU.

One parameter tree holds the shapes each optimizer treats apart: leaves
whose last axis is a multiple of QBLOCK = 128 (int8 moments in blocks),
a stacked 3-D leaf, a vector, a small matrix that is not quantised
(factored by Adafactor all the same) and, for the f32 master copy, a
bf16 leaf.  Three updates with gradients from a numpy seed go through
both packages:

* ``adamw`` and ``adafactor``: every leaf within 1e-6 of max|leaf| of
  JAX's (measured 9.3e-9 and 2.3e-7: f32 roundings of sums taken in
  another order);
* ``adamw8bit``: the int8 moments within one quantum (measured: equal),
  their scales and the parameters within 1e-6 (measured 1.9e-7);
* both schedules at steps across warmup, decay and past the end: equal
  to JAX's to an f32 rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import map_specs, tree_leaves  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    adafactor,
    constant,
    make_optimizer,
    warmup_cosine,
)

OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")
RTOL = 1e-6
SHAPES = {
    "a": (4, 256),
    "b": {"w": (2, 3, 128), "s": (5,)},
    "c": (3, 5),
    "e": (2, 128),
}
STEPS = 3


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _inputs(bf16_leaf: bool):
    rng = np.random.default_rng(0)
    params = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [_tree(lambda s: (0.01 * rng.standard_normal(s)).astype(
        np.float32)) for _ in range(STEPS)]
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    if bf16_leaf:
        jp["e"] = jp["e"].astype(jnp.bfloat16)
        tp["e"] = tp["e"].to(torch.bfloat16)
    return jp, tp, grads


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _leaves_with_paths(tree):
    return [(jax.tree_util.keystr(p), v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _run_both(name, bf16_leaf, lr=1e-2):
    jp, tp, grads = _inputs(bf16_leaf)
    jopt = jmake_optimizer(name, jconstant(lr))
    topt = make_optimizer(name, constant(lr))
    js, ts = jopt.init(jp), topt.init(tp)
    out = []
    for i, g in enumerate(grads):
        jg = jax.tree.map(jnp.asarray, g)
        tg = jax.tree.map(torch.from_numpy, g)
        jp, js = jopt.update(jg, js, jp, jnp.asarray(i, jnp.int32))
        tp, ts = topt.update(tg, ts, tp, torch.tensor(i, dtype=torch.int32))
        out.append((jp, js, tp, ts))
    return out


@pytest.mark.parametrize("bf16_leaf", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_updates_match_jax(name, bf16_leaf):
    for jp, js, tp, ts in _run_both(name, bf16_leaf):
        for (path, w), g in zip(_leaves_with_paths(jp), tree_leaves(tp)):
            assert str(g.dtype).split(".")[-1] == str(w.dtype), path
            np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL,
                                       atol=RTOL * np.abs(_np(w)).max(),
                                       err_msg=path)
        jst, tst = _leaves_with_paths(js), tree_leaves(ts)
        assert [p for p, _ in jst] == [
            p for p, _ in _leaves_with_paths(_as_jax_tree(ts))]
        for (path, w), g in zip(jst, tst):
            assert str(g.dtype).split(".")[-1] == str(w.dtype), path
            if g.dtype == torch.int8:
                # int8 moments: one quantum at most
                d = np.abs(g.numpy().astype(np.int32)
                           - np.asarray(w).astype(np.int32))
                assert d.max() <= 1, path
            else:
                np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL,
                                           atol=RTOL * np.abs(_np(w)).max(),
                                           err_msg=path)
    assert ("master" in ts) == (bf16_leaf and name != "adafactor")


def _as_jax_tree(tree):
    """A port state as a tree of numpy arrays, for its key paths."""
    if isinstance(tree, dict):
        return {k: _as_jax_tree(v) for k, v in tree.items()}
    return np.zeros(())


def test_int8_moments_quantise_as_jax():
    """``_q8`` / ``_q8log`` and their inverses on the same values."""
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw as tadamw

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 256)) * np.logspace(-6, 0, 256)
         ).astype(np.float32)
    v = np.square(x)
    for tq, jq, arr in ((tadamw._q8, jadamw._q8, x),
                        (tadamw._q8log, jadamw._q8log, v)):
        got = tq(torch.from_numpy(arr))
        want = jq(jnp.asarray(arr))
        assert np.abs(got[0].numpy().astype(int)
                      - np.asarray(want[0]).astype(int)).max() <= 1
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    q, s = tadamw._q8(torch.from_numpy(x))
    back = tadamw._dq8(q, s, x.shape).numpy()
    assert np.abs(back - x).max() <= 0.5 * float(s.max()) + 1e-12
    small = torch.ones(3, 5)
    assert tadamw._q8(small)[1] is None and torch.equal(
        tadamw._dq8(small, None, small.shape), small)


@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_state_schema_is_the_jax_state(name, param_dtype):
    """The port's ``state_schema`` is the layout of the JAX package's
    optimizer state (its ``init``), so a checkpoint restores either way.
    The JAX package's own ``state_schema`` agrees except for the int8
    moments of a leaf too small to quantise (a bare spec where ``init``
    gives ``{"q": f32}``)."""
    import dataclasses

    from repro.sharding.rules import abstract_params

    jc = dataclasses.replace(jsmoke_config(jget_config("yi-6b")),
                             param_dtype=param_dtype)
    tc = dataclasses.replace(smoke_config(get_config("yi-6b")),
                             param_dtype=param_dtype)
    jopt = jmake_optimizer(name)
    jstate = jax.eval_shape(jopt.init, abstract_params(JM.schema(jc)))
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), jstate)
    tsch = make_optimizer(name).state_schema(M.train_schema(tc))
    got = map_specs(lambda _, s: (s.shape, str(s.dtype).split(".")[-1]),
                    tsch)
    assert got == want
    jsch = jax.tree.map(lambda s: (tuple(s.shape), str(jnp.dtype(s.dtype))),
                        jopt.state_schema(JM.schema(jc)),
                        is_leaf=lambda x: hasattr(x, "init"))
    assert (jsch == want) == (name != "adamw8bit")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_init_follows_the_state_schema(name):
    tc = smoke_config(get_config("mamba2-370m"))
    sch = M.train_schema(tc)
    opt = make_optimizer(name)
    params = map_specs(lambda _, s: torch.zeros(s.shape, dtype=s.dtype), sch)
    state = opt.init(params)
    specs = map_specs(lambda _, s: (s.shape, s.dtype), opt.state_schema(sch))
    got = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), state)
    assert got == specs


def test_adafactor_updates_a_large_stacked_leaf_one_layer_at_a_time(
        monkeypatch):
    """Past ``CHUNK_BYTES`` a stacked leaf's update is each layer's own
    (the RMS clip and the relative step per layer), as the JAX package's
    ``lax.map`` path gives it."""
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.standard_normal((3, 4, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 4, 8)).astype(np.float32))
    monkeypatch.setattr(adafactor, "CHUNK_BYTES", 0)
    opt = make_optimizer("adafactor", constant(1e-2))
    got, st = opt.update({"w": g}, opt.init({"w": p}), {"w": p},
                         torch.tensor(0))
    for i in range(3):
        want, wst = opt.update({"w": g[i]}, opt.init({"w": p[i]}),
                               {"w": p[i]}, torch.tensor(0))
        assert torch.equal(got["w"][i], want["w"])
        assert torch.equal(st["stats"]["w"]["vr"][i],
                           wst["stats"]["w"]["vr"])


def test_schedules_match_jax():
    steps = [0, 1, 50, 199, 200, 201, 1000, 5000, 9999, 10_000, 20_000]
    for tf, jf in ((warmup_cosine(), jwarmup_cosine()),
                   (warmup_cosine(1e-3, 10, 100, 0.0),
                    jwarmup_cosine(1e-3, 10, 100, 0.0)),
                   (warmup_cosine(warmup_steps=0, total_steps=1),
                    jwarmup_cosine(warmup_steps=0, total_steps=1)),
                   (constant(3e-4), jconstant(3e-4))):
        for s in steps:
            got = tf(torch.tensor(s, dtype=torch.int32))
            want = jf(jnp.asarray(s, jnp.int32))
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-7)
            assert tf(s).item() == got.item()


def test_make_optimizer_names():
    for name in OPTIMIZERS:
        assert make_optimizer(name).update is not None
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd")
