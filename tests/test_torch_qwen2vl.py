"""The port's qwen2-vl-72b backbone (patch-embedding inputs, M-RoPE
positions) against the JAX package's model, on the CPU.

The smoke config (``repro.configs.smoke_config``: one layer, d_model
64, 4 query heads and 2 kv heads of 16, M-RoPE sections (2, 3, 3),
f32).  The same JAX parameters go through ``params_from_numpy``; the
same embeddings, positions and batches, made with numpy from a seed, go
into ``repro.models.model`` and the port.  The positions are those of a
prompt with one image (``launch/serve.py::image_positions``, Qwen2-VL's
``get_rope_index``): on the image grid the temporal, height and width
rows differ, so a mix-up of the sections shows (one ``arange`` on all
three rows, as the JAX serve CLI and pipeline use, is RoPE itself).

* M-RoPE: the section select bitwise equal to the JAX package's
  ``_mrope_select`` on the same angles, each section's cos/sin bitwise
  equal to the port's RoPE of its row, three equal rows bitwise RoPE,
  and cos/sin within 1e-6 of the JAX package's (``rope_cos_sin``'s
  tolerance in ``tests/test_torch_serve.py``: XLA's and torch's f32 cos
  and sin part by an ulp, measured 6e-8 on the same angles);
* prefill over embeddings and eight decode steps whose positions run
  ahead of the cache index: logits within 1e-4·max|logit|, identical
  greedy tokens, every cache leaf within 1e-4·max|leaf|;
* the port's prefill(S) against prefill(S−1) + one decode step within
  2e-4, the prompt's embeddings being its tokens' rows;
* ``loss_fn`` within 1e-5 relative and every gradient leaf within
  1e-4·max|g| of ``jax.grad``; parameters both ways; the pipeline's
  batches bitwise; the kernel calls per pass.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.shapes import ShapeConfig as JShape  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as JPipe  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import dense_blocks, get_config  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params,
    map_specs,
    tree_leaves,
    tree_map,
)
from repro_torch.runtime import serve_step  # noqa: E402

ARCH = "qwen2-vl-72b"
B, STEPS = 2, 8
#: 4 text tokens, a 4 x 4 image grid, 4 text tokens
GRID = (4, 4, 4, 4)
S = GRID[0] + GRID[1] * GRID[2] + GRID[3]
LOGIT_SHARE = 1e-4
INV_ATOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4


def _cfgs():
    return jsmoke_config(jget_config(ARCH)), smoke_config(get_config(ARCH))


@pytest.fixture(scope="module")
def model():
    jc, tc = _cfgs()
    jp = jinit_params(JM.schema(jc), jax.random.key(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def _positions(batch=B):
    return serve.image_positions(batch, *GRID).numpy()


def _embeds(cfg, s=S, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, s, cfg.d_model), dtype=np.float32)


def _share(got, want, share):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    diff = float(np.abs(got - want).max())
    assert diff <= share * float(np.abs(want).max()), diff


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax_field_for_field(smoke):
    j, t = jget_config(ARCH), get_config(ARCH)
    if smoke:
        j, t = jsmoke_config(j), smoke_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.rope_type == "mrope" and t.input_mode == "embeds"
    assert sum(t.mrope_sections) == t.head_dim // 2


@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_match_jax(smoke):
    """72.7 B at full size (80 layers, untied 152064-token tables); the
    4-layer cut the card serves holds 6.00 B."""
    j, t = jget_config(ARCH), get_config(ARCH)
    if smoke:
        j, t = jsmoke_config(j), smoke_config(t)
    assert M.param_counts(t) == JM.param_counts(j)
    if not smoke:
        assert M.param_counts(t)[0] == 72_705_384_448
        cut = dataclasses.replace(t, num_layers=4, blocks=dense_blocks(4))
        assert M.param_counts(cut)[0] == 6_002_122_752


def test_train_schema_is_jax_schema():
    j, t = jget_config(ARCH), get_config(ARCH)
    got = map_specs(lambda _, s: (s.shape, str(s.dtype).split(".")[-1]),
                    M.train_schema(t))
    assert got == jax.tree.map(
        lambda s: (s.shape, jnp.dtype(s.dtype).name), JM.schema(j),
        is_leaf=lambda x: hasattr(x, "init"))


def test_image_positions_are_get_rope_index():
    """Text at 0..3, the 4 x 4 grid offset by 4 (t constant, h the row,
    w the column), text again from the grid's largest position + 1."""
    p = _positions(1)[0]
    assert p.shape == (3, S)
    np.testing.assert_array_equal(p[:, :4], np.tile(np.arange(4), (3, 1)))
    grid = p[:, 4:20].reshape(3, 4, 4)
    np.testing.assert_array_equal(grid[0], np.full((4, 4), 4))
    np.testing.assert_array_equal(grid[1], 4 + np.arange(4)[:, None]
                                  .repeat(4, 1))
    np.testing.assert_array_equal(grid[2], 4 + np.arange(4)[None]
                                  .repeat(4, 0))
    np.testing.assert_array_equal(p[:, 20:], np.tile(8 + np.arange(4),
                                                     (3, 1)))
    assert p.max() + 1 == 12


@pytest.mark.parametrize("dim,sections", [(16, (2, 3, 3)),
                                          (128, (16, 24, 24))])
def test_mrope_matches_jax(dim, sections):
    theta = 1_000_000.0
    pos = np.concatenate([_positions(), _positions()[:, :, ::-1] + 3], -1)
    rng = np.random.default_rng(dim)
    ang = rng.standard_normal((2, 3, pos.shape[-1], dim // 2),
                              dtype=np.float32)
    np.testing.assert_array_equal(
        TL.mrope_select(torch.from_numpy(ang), sections).numpy(),
        np.asarray(JL._mrope_select(jnp.asarray(ang), sections)))
    got = TL.mrope_cos_sin(torch.from_numpy(pos), dim, theta, sections)
    want = JL.mrope_cos_sin(jnp.asarray(pos), dim, theta, sections)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, pos.shape[-1], dim // 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    # each section is the port's RoPE of its own row, bitwise
    edges = np.cumsum((0,) + sections)
    for row in range(3):
        cs = TL.rope_cos_sin(torch.from_numpy(pos[:, row]), dim, theta)
        cols = slice(edges[row], edges[row + 1])
        for g, r in zip(got, cs):
            assert torch.equal(g[..., cols], r[..., cols])
    # the rows differ, so the sections matter
    assert not np.array_equal(pos[:, 1], pos[:, 2])
    same = np.broadcast_to(pos[:, :1], pos.shape).copy()
    for g, r in zip(TL.mrope_cos_sin(torch.from_numpy(same), dim, theta,
                                     sections),
                    TL.rope_cos_sin(torch.from_numpy(same[:, 0]), dim,
                                    theta)):
        assert torch.equal(g, r)


def _decode_positions(pos, i):
    return (pos.max(axis=(1, 2)) + 1 + i)[:, None].repeat(3, 1)


def test_prefill_and_decode_match_jax(model):
    """Prefill S embeddings at the image's positions into a cache of
    S + STEPS positions, then STEPS greedy decode steps at positions
    max + 1 + i (behind the cache index S + i): logits, tokens, cache."""
    jc, jp, tc, tp = model
    emb, pos = _embeds(tc), _positions()
    assert _decode_positions(pos, 0)[0, 0] < S
    jl, jcache = JM.prefill(jc, jp, {"embeds": jnp.asarray(emb),
                                     "positions": jnp.asarray(pos)},
                            max_seq=S + STEPS)
    tl, tcache = serve_step.build_prefill(tc, max_seq=S + STEPS)(
        tp, {"embeds": torch.from_numpy(emb),
             "positions": torch.from_numpy(pos)})
    decode = serve_step.build_decode(tc)
    for i in range(STEPS + 1):
        jl = np.asarray(jl, np.float32)
        _share(tl, jl, LOGIT_SHARE)
        jt, tt = np.argmax(jl, -1), tl.argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), jt)
        if i == STEPS:
            break
        dp = _decode_positions(pos, i).astype(np.int32)
        jl, jcache = JM.decode_step(
            jc, jp, jcache, {"token": jnp.asarray(jt, jnp.int32),
                             "pos": jnp.asarray(S + i, jnp.int32),
                             "positions": jnp.asarray(dp)})
        tl, tcache = decode(tp, tcache, {"token": tt, "pos": S + i,
                                         "positions": torch.from_numpy(dp)})
    jshapes = jax.tree.map(lambda a: a.shape, jcache)
    assert tree_map(lambda t: tuple(t.shape), tcache) == jshapes
    for g, w in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
        _share(g, w, LOGIT_SHARE)


def test_prefill_decode_consistency(model):
    """The prompt's embeddings are its tokens' rows, so the last prompt
    position may be fed as a token to a decode step at its own M-RoPE
    position."""
    _, _, tc, tp = model
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab_size, (B, S)))
    emb = tp["embed"][toks]
    pos = torch.from_numpy(_positions())
    full, _ = M.prefill(tc, tp, {"embeds": emb, "positions": pos})
    _, cache = M.prefill(tc, tp, {"embeds": emb[:, :-1],
                                  "positions": pos[..., :-1]}, max_seq=S)
    dec, _ = M.decode_step(tc, tp, cache, {"token": toks[:, -1],
                                           "pos": S - 1,
                                           "positions": pos[..., -1]})
    assert float((full - dec).abs().max()) < INV_ATOL


def test_mrope_needs_positions(model):
    _, _, tc, tp = model
    with pytest.raises(ValueError, match="positions"):
        M.prefill(tc, tp, {"embeds": torch.from_numpy(_embeds(tc))})


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.uniform(size=(B, S)) > 0.1).astype(np.float32)
    emb = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    return toks, mask, emb, _positions()


def _jax_loss(jc, jp, toks, mask, emb, pos):
    batch = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask),
             "embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)}
    return jax.value_and_grad(
        lambda p: JM.loss_fn(jc, p, batch, loss_chunk=12, remat="none"),
        has_aux=True)(jp)


def _torch_batch(toks, mask, emb, pos):
    return {"tokens": torch.from_numpy(toks),
            "loss_mask": torch.from_numpy(mask),
            "embeds": torch.from_numpy(emb),
            "positions": torch.from_numpy(pos)}


def test_loss_and_grads_match_jax(model):
    """Every gradient leaf; the token table, which an embeddings-only
    batch never reads, has none in the port and zeros in JAX."""
    jc, jp, tc, _ = model
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu",
                           train=True)
    batch = _batch(tc)
    (jl, _), jg = _jax_loss(jc, jp, *batch)
    p = tree_map(lambda a: a.clone().requires_grad_(True), tp)
    tl, _ = M.loss_fn(tc, p, _torch_batch(*batch), loss_chunk=12,
                      remat="none")
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    paths = [jax.tree_util.keystr(q)
             for q, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    got = tree_leaves(tree_map(
        lambda a: torch.zeros_like(a) if a.grad is None else a.grad, p))
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    assert p["embed"].grad is None
    assert not np.asarray(jg["embed"]).any()
    for path, g, w in zip(paths, got, want):
        w = np.asarray(w, np.float64)
        diff = float(np.abs(g.numpy() - w).max())
        assert diff <= GRAD_SHARE * float(np.abs(w).max()), (path, diff)


def test_port_parameters_give_jax_the_same_loss():
    jc, tc = _cfgs()
    tp = init_params(M.train_schema(tc), torch.Generator().manual_seed(4),
                     "cpu")
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), tp))
    assert jax.tree.structure(jp) == jax.tree.structure(
        jinit_params(JM.schema(jc), jax.random.key(0)))
    batch = _batch(tc, seed=5)
    (jl, _), _ = _jax_loss(jc, jp, *batch)
    with torch.no_grad():
        tl, _ = M.loss_fn(tc, tp, _torch_batch(*batch), loss_chunk=12)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)


def test_pipeline_batches_are_bitwise_jax():
    """tokens, mask, the embeddings (bf16) and the positions from one
    generator in the JAX pipeline's order."""
    jc, tc = _cfgs()
    shape = ShapeConfig("t", seq_len=24, global_batch=2, kind="train")
    jshape = JShape("t", seq_len=24, global_batch=2, kind="train")
    for step in (0, 3):
        tb = SyntheticLMPipeline(tc, shape, seed=2).batch_at(step)
        jb = JPipe(jc, jshape, seed=2).batch_at(step)
        assert set(tb) == set(jb) == {"tokens", "loss_mask", "embeds",
                                      "positions"}
        assert tb["embeds"].dtype == torch.bfloat16
        assert tb["positions"].dtype == torch.int32
        for k in tb:
            np.testing.assert_array_equal(
                tb[k].float().numpy(), np.asarray(jb[k], np.float32))


def test_kernel_calls_per_pass(model, monkeypatch):
    """Flash once per layer in prefill, the fused norm at both seams and
    the final norm in prefill and decode; the 4-layer cut the card
    serves: 4 flash and 9 norm calls a prefill, 9 norm calls a step."""
    jc, jp, tc, tp = model
    calls = {"flash_attention": 0, "rmsnorm_residual": 0}

    def counted(name, fn):
        def wrap(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrap

    monkeypatch.setattr(attn_mod, "attention",
                        counted("flash_attention", attn_mod.attention))
    monkeypatch.setattr(transformer, "rmsnorm_residual",
                        counted("rmsnorm_residual",
                                transformer.rmsnorm_residual))
    pos = torch.from_numpy(_positions())
    _, cache = M.prefill(tc, tp, {"embeds": torch.from_numpy(_embeds(tc)),
                                  "positions": pos}, max_seq=S + 1)
    assert calls == M.launches_per_pass(tc, "prefill") == {
        "flash_attention": 1, "rmsnorm_residual": 3}
    calls.update({k: 0 for k in calls})
    M.decode_step(tc, tp, cache, {"token": torch.zeros(B, dtype=torch.long),
                                  "pos": S, "positions": pos[..., -1] + 1})
    assert calls == M.launches_per_pass(tc, "decode")
    cut = dataclasses.replace(get_config(ARCH), num_layers=4,
                              blocks=dense_blocks(4))
    assert M.launches_per_pass(cut, "prefill") == {
        "flash_attention": 4, "rmsnorm_residual": 9}
    assert M.launches_per_pass(cut, "decode") == {
        "flash_attention": 0, "rmsnorm_residual": 9}


def test_serve_cli_on_the_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(ln.startswith("[serve]") for ln in lines)
    assert tuple(res.tokens.shape) == (2, 4)
    zero = {"flash_attention": 0, "rmsnorm_residual": 0}
    assert res.launches == {"prefill": zero, "decode": zero}
