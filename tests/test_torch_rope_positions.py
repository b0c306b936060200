"""Plain RoPE takes the caller's ``positions``, as the JAX package does.

``repro.models.model.rope_full`` builds the plain-RoPE tables from the
inputs' ``positions`` when given (``arange(S)`` otherwise).  The smoke
Yi-6B at S=8 goes through both packages' ``prefill`` and ``loss_fn`` on
the same parameters, held within the tolerances of
``test_torch_serve.py`` (logits and cache within 1e-4) and
``test_torch_train.py`` (loss within 1e-5 relative), with positions
``arange(8) + 7`` and ``2·arange(8)``.  With the offset the tables
differ from ``arange``'s by up to 0.97; attention scores depend only on
position differences, so the offset leaves the logits and the loss as
they are and shows in the tables and in the keys the prefill caches
(rotated by absolute position).  The strided positions change the
logits and the loss too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import dense_blocks as jdense_blocks  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import dense_blocks  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

B, S, OFFSET, LAYERS = 2, 8, 7, 2
LOGIT_ATOL = 1e-4
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def yi():
    j = dataclasses.replace(jsmoke_config(jget_config("yi-6b")),
                            num_layers=LAYERS, blocks=jdense_blocks(LAYERS))
    t = dataclasses.replace(smoke_config(get_config("yi-6b")),
                            num_layers=LAYERS, blocks=dense_blocks(LAYERS))
    assert t.rope_type not in ("none", "mrope")
    jp = jinit_params(JM.schema(j), jax.random.key(0))
    np_tree = jax.tree.map(np.asarray, jp)
    toks = np.random.default_rng(3).integers(0, t.vocab_size, (B, S))
    return j, jp, t, np_tree, toks


POSITIONS = {"offset": np.arange(S) + OFFSET, "strided": 2 * np.arange(S)}


def test_rope_tables_take_the_positions(yi):
    _, _, t, _, _ = yi
    pos = POSITIONS["offset"]
    cos, sin = M.rope_full(t, S, "cpu", torch.from_numpy(pos))
    cos0, _ = M.rope_full(t, S, "cpu")
    jcos, jsin = JM.rope_full(jsmoke_config(jget_config("yi-6b")), S,
                              jnp.asarray(pos))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    assert float((cos - cos0).abs().max()) > 0.5


@pytest.mark.parametrize("kind", sorted(POSITIONS))
def test_prefill_with_positions_matches_jax(yi, kind):
    j, jp, t, np_tree, toks = yi
    pos = POSITIONS[kind]
    tp = params_from_numpy(t, np_tree, "cpu")
    jl, jcache = JM.prefill(j, jp, {"tokens": jnp.asarray(toks),
                                    "positions": jnp.asarray(pos)})
    tl, tcache = M.prefill(t, tp, {"tokens": torch.from_numpy(toks),
                                   "positions": torch.from_numpy(pos)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache["b0"]["l0"]["mixer"][name].numpy(),
            np.asarray(jcache["b0"]["l0"]["mixer"][name]), atol=LOGIT_ATOL)
    # without positions the cached keys are rotated by arange(S)
    _, t0 = M.prefill(t, tp, {"tokens": torch.from_numpy(toks)})
    k0, k = t0["b0"]["l0"]["mixer"]["k"], tcache["b0"]["l0"]["mixer"]["k"]
    assert float((k0 - k).abs().max()) > 100 * LOGIT_ATOL


@pytest.mark.parametrize("kind", sorted(POSITIONS))
def test_loss_with_positions_matches_jax(yi, kind):
    j, jp, t, np_tree, toks = yi
    pos = POSITIONS[kind]
    tp = params_from_numpy(t, np_tree, "cpu", train=True)
    jl, _ = JM.loss_fn(j, jp, {"tokens": jnp.asarray(toks),
                               "positions": jnp.asarray(pos)}, loss_chunk=S)
    tl, _ = M.loss_fn(t, tp, {"tokens": torch.from_numpy(toks),
                              "positions": torch.from_numpy(pos)},
                      loss_chunk=S)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
