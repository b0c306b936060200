"""The port's mixture-of-experts layer (``repro_torch.models.moe``)
against the JAX package's, on the CPU.

The MoE config of ``tests/test_moe.py`` (8 experts, one shared, top-2,
d_ff 64, groups of 16 tokens) on the smoke Jamba's d_model 64, f32.
The same JAX parameters and numpy inputs from a seed go through both
packages:

* routing (gates, expert ids, the one-hot mask, lb, z), the queue
  positions, both dispatches with and without dropped assignments, the
  grouped path with several groups and with one group of every token,
  a shared expert and ``ep_over_dp`` with no mesh: within 1e-6
  (measured ≤ 4.8e-7 at max|y| 4.4, an ulp; expert ids and queue
  positions equal);
* the gradients of Σy² + lb + z: each leaf within 1e-5·max(1, max|g|)
  (measured ≤ 4e-7·max|g|);
* bf16 compute: within 2^-6·max|y| (measured 0.0086): the dispatch and
  combine are rounded to bf16 as in the JAX package, and each library
  rounds the bf16 expert products in its own order.

The five tests of ``tests/test_moe.py`` run on the port's functions
first.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params,
    map_specs,
    tree_leaves,
    tree_map,
)

ARCH = "jamba-v0.1-52b"
ATOL = 1e-6
BF16_SHARE = 2.0 ** -6


def _moe(**kw):
    base = dict(num_experts=8, num_shared_experts=1, top_k=2, d_ff=64,
                capacity_factor=4.0, group_size=16, dispatch="einsum")
    base.update(kw)
    return base


def _cfg(dispatch="einsum", cf=4.0, E=8, k=2):
    """``tests/test_moe.py``'s config on the port's smoke Jamba."""
    return dataclasses.replace(
        smoke_config(get_config(ARCH)),
        moe=MoEConfig(**_moe(dispatch=dispatch, capacity_factor=cf,
                             num_experts=E, top_k=k)))


def _both(dtype="float32", **kw):
    """The same MoE config in both packages."""
    j = dataclasses.replace(jsmoke_config(jget_config(ARCH)),
                            moe=JMoEConfig(**_moe(**kw)),
                            compute_dtype=dtype)
    t = dataclasses.replace(smoke_config(get_config(ARCH)),
                            moe=MoEConfig(**_moe(**kw)), compute_dtype=dtype)
    return j, t


def _params(jc, tc, seed=0):
    """JAX parameters and the same values in the port's schema dtypes."""
    jp = jinit_params(JMOE.moe_schema(jc), jax.random.key(seed))
    dtypes = map_specs(lambda _, s: s.dtype, moe_mod.moe_schema(tc))

    def conv(a, dt):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dt)

    def walk(j, d):
        if isinstance(j, dict):
            return {k: walk(j[k], d[k]) for k in j}
        return conv(j, d)

    return jp, walk(jp, dtypes)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.fixture(scope="module")
def moe_params():
    cfg = _cfg()
    return cfg, init_params(moe_mod.moe_schema(cfg),
                            torch.Generator().manual_seed(0), "cpu")


# ---------------------------------------------------------------------------
# tests/test_moe.py on the port
# ---------------------------------------------------------------------------


def test_routing_invariants(moe_params):
    cfg, params = moe_params
    x = torch.from_numpy(_x((4 * 16, cfg.d_model), 1))
    gate, idx, mask, lb, z = moe_mod.route(cfg, params, x)
    np.testing.assert_allclose(gate.sum(-1).numpy(), 1.0, atol=1e-5)
    for row in idx.tolist():
        assert len(set(row)) == len(row)
    assert 0.5 < float(lb) < float(cfg.moe.num_experts)
    assert float(z) >= 0


def test_capacity_never_exceeded(moe_params):
    cfg, params = moe_params
    T, C = 64, moe_mod.expert_capacity(64, cfg)
    x = torch.from_numpy(_x((1, T, cfg.d_model), 2))
    gate, idx, mask, *_ = moe_mod.route(cfg, params, x)
    pos = moe_mod._positions_in_expert(mask)
    kept = (pos < C).numpy()
    idx_np, pos_np = idx.numpy(), pos.numpy()
    counts = np.zeros(cfg.moe.num_experts, np.int64)
    for t in range(T):
        for j in range(cfg.moe.top_k):
            if kept[0, t, j]:
                counts[idx_np[0, t, j]] += 1
                assert pos_np[0, t, j] < C
    assert (counts <= C).all()


def test_einsum_vs_scatter_dispatch_equivalent(moe_params):
    """The two dispatches are interchangeable (drop-free config)."""
    _, params = moe_params
    x = torch.from_numpy(_x((2, 32, 64), 3))
    y_e, aux_e = moe_mod.apply_moe(_cfg("einsum"), params, x)
    y_s, aux_s = moe_mod.apply_moe(_cfg("scatter"), params, x)
    np.testing.assert_allclose(y_e.numpy(), y_s.numpy(), atol=2e-5)
    assert abs(float(aux_e["lb_loss"]) - float(aux_s["lb_loss"])) < 1e-6


def test_dropping_under_tight_capacity(moe_params):
    """cf < 1 drops assignments (outputs differ from drop-free) without
    producing NaNs."""
    _, params = moe_params
    x = torch.from_numpy(_x((2, 32, 64), 4))
    y_t, _ = moe_mod.apply_moe(_cfg(cf=0.5), params, x)
    y_l, _ = moe_mod.apply_moe(_cfg(cf=4.0), params, x)
    assert bool(torch.isfinite(y_t).all())
    assert float((y_t - y_l).abs().max()) > 1e-6


def test_moe_grads_flow_to_all_parts(moe_params):
    cfg, params = moe_params
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    x = torch.from_numpy(_x((2, 32, 64), 5))
    y, aux = moe_mod.apply_moe(cfg, p, x)
    (torch.sum(y ** 2) + aux["lb_loss"] + aux["z_loss"]).backward()
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert float(p[name].grad.abs().max()) > 0, name


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ep", [False, True])
def test_schema_matches_jax(ep):
    """Shapes, inits and dtypes leaf for leaf; the router f32 under bf16
    parameters in both of the port's schemas."""
    from repro_torch.models import model as M

    j, t = _both(ep_over_dp=ep)
    spec = lambda s: (s.shape, s.axes)  # noqa: E731
    jsch = jax.tree.map(lambda s: (s.shape, tuple(s.axes)),
                        JMOE.moe_schema(j),
                        is_leaf=lambda x: hasattr(x, "init"))
    assert map_specs(lambda _, s: spec(s), moe_mod.moe_schema(t)) == jsch
    full = get_config(ARCH)
    jfull = jget_config(ARCH)
    jd = jax.tree.map(lambda s: jnp.dtype(s.dtype).name,
                      JMOE.moe_schema(jfull),
                      is_leaf=lambda x: hasattr(x, "init"))
    assert jd["router"] == "float32" and jd["w_up"] == "bfloat16"
    for sch in (moe_mod.moe_schema(full),
                M.train_schema(full)["b0"]["l1"]["mlp"]):
        got = map_specs(lambda _, s: str(s.dtype).split(".")[-1], sch)
        assert got == jd


@pytest.mark.parametrize("tokens", [1, 4, 16, 30, 600, 4096, 8188])
def test_expert_capacity_matches_jax(tokens):
    for cf in (0.5, 1.25, 4.0):
        j, t = _both(capacity_factor=cf, num_experts=16)
        assert moe_mod.expert_capacity(tokens, t) == \
            JMOE.expert_capacity(tokens, j)


def test_route_matches_jax():
    j, t = _both()
    jp, tp = _params(j, t)
    x = _x((3, 16, 64), 10)
    want = JMOE.route(j, jp, jnp.asarray(x))
    got = moe_mod.route(t, tp, torch.from_numpy(x))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        _close(g, w)


def test_top_k_ties_take_the_lower_index():
    """Equal probabilities: ``jax.lax.top_k``'s order, descending with
    ties to the lower index."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    for k in (1, 2, 3):
        vals, idx = moe_mod._top_k(torch.from_numpy(probs), k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_positions_in_expert_match_jax():
    j, t = _both()
    jp, tp = _params(j, t)
    x = _x((2, 48, 64), 11)
    jmask = JMOE.route(j, jp, jnp.asarray(x))[2]
    tmask = moe_mod.route(t, tp, torch.from_numpy(x))[2]
    np.testing.assert_array_equal(
        moe_mod._positions_in_expert(tmask).numpy(),
        np.asarray(JMOE._positions_in_expert(jmask)))


def _positions_outer_scan(mask):
    """The queue positions by a cumulative sum along the (T·k) axis of
    the (T·k, E) mask, the JAX package's form."""
    shp = mask.shape
    flat = mask.reshape(*shp[:-3], shp[-3] * shp[-2], shp[-1])
    pos_e = torch.cumsum(flat, dim=-2) - flat
    return torch.sum(pos_e * flat, dim=-1).reshape(shp[:-1])


def test_positions_in_expert_at_deepseek_width():
    """DeepSeek-V2's routing width (160 experts, top-6) over 2 groups of
    512 tokens: the positions equal the outer-axis scan's and the JAX
    package's bit for bit (integer counts below 2^24 are exact in f32 in
    any order of summation)."""
    j, t = _both(num_experts=160, top_k=6)
    jp, tp = _params(j, t)
    x = _x((2, 512, 64), 12)
    tmask = moe_mod.route(t, tp, torch.from_numpy(x))[2]
    jmask = JMOE.route(j, jp, jnp.asarray(x))[2]
    got = moe_mod._positions_in_expert(tmask)
    assert tuple(got.shape) == (2, 512, 6) and got.dtype == torch.float32
    assert torch.equal(got, _positions_outer_scan(tmask))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JMOE._positions_in_expert(jmask)))
    assert float(got.max()) > 0


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_group_dispatch_matches_jax(dispatch, cf):
    """One call of a group function, (G=2, T=32), drop-free and with
    half the assignments over capacity."""
    j, t = _both(dispatch=dispatch, capacity_factor=cf)
    jp, tp = _params(j, t)
    x = _x((2, 32, 64), 12)
    C = moe_mod.expert_capacity(32, t)
    want = JMOE._GROUP_FNS[dispatch](j, jp, jnp.asarray(x), C)
    got = moe_mod._GROUP_FNS[dispatch](t, tp, torch.from_numpy(x), C)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("shape", [(2, 32), (4, 15), (1, 2)],
                         ids=["4 groups", "one group of 60", "2 tokens"])
def test_grouped_path_matches_jax(dispatch, shape):
    """``_apply_moe_grouped``: 64 tokens in groups of 16 (n_iter 4, lb
    and z averaged), 60 tokens (16 does not divide them: one group of
    all 60) and a decode-sized 2 tokens (C = 4)."""
    j, t = _both(dispatch=dispatch, capacity_factor=1.0)
    jp, tp = _params(j, t)
    x = _x(shape + (64,), 13)
    want = JMOE._apply_moe_grouped(j, jp, jnp.asarray(x))
    got = moe_mod._apply_moe_grouped(t, tp, torch.from_numpy(x))
    assert tuple(got[0].shape) == shape + (64,)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("shared,ep", [(1, False), (0, False), (1, True)],
                         ids=["shared expert", "no shared", "ep_over_dp"])
def test_apply_moe_matches_jax(shared, ep):
    j, t = _both(num_shared_experts=shared, ep_over_dp=ep,
                 capacity_factor=1.0)
    jp, tp = _params(j, t)
    assert ("shared" in tp) == bool(shared)
    x = _x((2, 32, 64), 14)
    jy, jaux = JMOE.apply_moe(j, jp, jnp.asarray(x))
    ty, taux = moe_mod.apply_moe(t, tp, torch.from_numpy(x))
    _close(ty, jy)
    assert set(taux) == set(jaux) == {"lb_loss", "z_loss"}
    for k in jaux:
        _close(taux[k], jaux[k])


def test_apply_moe_bf16_matches_jax():
    """bf16 compute: the dispatch and combine rounded to bf16 as in the
    JAX package; the expert products round in each library's order."""
    j, t = _both("bfloat16", capacity_factor=1.0)
    jp, tp = _params(j, t)
    x = _x((2, 32, 64), 15)
    jy, _ = JMOE.apply_moe(j, jp, jnp.asarray(x, jnp.bfloat16))
    ty, _ = moe_mod.apply_moe(t, tp, torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    scale = float(np.abs(want).max())
    assert float(np.abs(ty.float().numpy() - want).max()) <= \
        BF16_SHARE * scale


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_gradients_match_jax(dispatch):
    """d(Σy² + lb + z) for every leaf and the input, with drops."""
    j, t = _both(dispatch=dispatch, capacity_factor=1.0)
    jp, tp = _params(j, t)
    x = _x((2, 32, 64), 16)

    def jloss(p, xx):
        y, aux = JMOE.apply_moe(j, p, xx)
        return jnp.sum(y ** 2) + aux["lb_loss"] + aux["z_loss"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = tree_map(lambda a: a.clone().requires_grad_(True), tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe_mod.apply_moe(t, tp, xt)
    (torch.sum(y ** 2) + aux["lb_loss"] + aux["z_loss"]).backward()
    got = tree_leaves(tree_map(lambda a: a.grad, tp))
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = float(np.abs(np.asarray(w)).max())
        _close(g, w, atol=1e-5 * max(scale, 1.0))
    _close(xt.grad, jgx, atol=1e-5)
