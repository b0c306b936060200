#!/usr/bin/env python3
"""The serving invariant of Yi-6B at full width, layer by layer, in the
JAX package and in the port, both on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/serve_depth_witness.py \
        [--layers 4] [--batch 2] [--prompt 128]

One set of f32 weights — the JAX package's ``init_params`` — goes to
both packages, to the port through ``params_from_numpy``.  For every
depth L up to ``--layers`` each package computes the invariant of
``tests/test_archs_smoke.py``: the full prompt's last logits against
prefill(S-1) + one decode step.  One JSON line per (init, depth) gives
max|full - decode| and max|logit| per package, and the two packages'
full-prefill logits against each other.  ``init`` is the init rule
itself (fan-in over axis -2: the head count for wq/wk/wv, head_dim for
wo) or ``well_conditioned`` (fan-in over the contraction: d for
wq/wk/wv, heads·head_dim for wo).  At 4 layers it holds ~20 GB of host
memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import dense_blocks as jdense_blocks  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.rules import init_params as jinit_params  # noqa: E402
from repro_torch.configs import dense_blocks, get_config  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime import serve_step  # noqa: E402


def well_conditioned(cfg, tree):
    """The numpy tree with the attention projections rescaled to the
    fan-in of their contraction."""
    H, KH, d = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    gain = {"wq": (H / d) ** 0.5, "wk": (KH / d) ** 0.5,
            "wv": (KH / d) ** 0.5, "wo": H ** -0.5}
    mixer = tree["b0"]["l0"]["mixer"]
    l0 = dict(tree["b0"]["l0"], mixer={
        k: (w * np.float32(gain[k])).astype(np.float32)
        for k, w in mixer.items()})
    return dict(tree, b0=dict(tree["b0"], l0=l0))


def cut(tree, depth):
    return dict(tree, b0=jax.tree.map(lambda a: a[:depth], tree["b0"]))


def jax_invariant(cfg, params, toks):
    S = toks.shape[1]
    full, _ = JM.prefill(cfg, params, {"tokens": toks})
    _, cache = JM.prefill(cfg, params, {"tokens": toks[:, :S - 1]},
                          max_seq=S)
    dec, _ = JM.decode_step(cfg, params, cache, {
        "token": toks[:, S - 1], "pos": jnp.asarray(S - 1, jnp.int32)})
    return np.asarray(full, np.float32), np.asarray(dec, np.float32)


def torch_invariant(cfg, params, toks):
    S = toks.shape[1]
    full, _ = serve_step.build_prefill(cfg)(params, {"tokens": toks})
    _, cache = serve_step.build_prefill(cfg, max_seq=S)(
        params, {"tokens": toks[:, :S - 1]})
    dec, _ = serve_step.build_decode(cfg)(
        params, cache, {"token": toks[:, S - 1], "pos": S - 1})
    return full.numpy(), dec.numpy()


def summary(full, dec):
    return {"max_abs_diff": float(np.abs(full - dec).max()),
            "max_abs_logit": float(np.abs(full).max()),
            "argmax_agreement": float(np.mean(full.argmax(-1)
                                              == dec.argmax(-1)))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=128)
    args = ap.parse_args(argv)
    L = args.layers

    def cfgs(depth):
        j = dataclasses.replace(jget_config("yi-6b"), num_layers=depth,
                                blocks=jdense_blocks(depth),
                                compute_dtype="float32")
        t = dataclasses.replace(get_config("yi-6b"), num_layers=depth,
                                blocks=dense_blocks(depth),
                                compute_dtype="float32")
        return j, t

    jc, _ = cfgs(L)
    t0 = time.monotonic()
    tree = jax.tree.map(np.asarray,
                        jinit_params(JM.schema(jc), jax.random.key(0)))
    print(json.dumps({"init_s": time.monotonic() - t0, "layers": L,
                      "d_model": jc.d_model, "batch": args.batch,
                      "prompt": args.prompt}), flush=True)
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (args.batch, args.prompt)).astype(np.int32)
    for init in ("init_rule", "well_conditioned"):
        if init == "well_conditioned":
            tree = well_conditioned(jc, tree)
        for depth in range(1, L + 1):
            jcd, tcd = cfgs(depth)
            sub = cut(tree, depth)
            t0 = time.monotonic()
            jf, jd = jax_invariant(
                jcd, jax.tree.map(jnp.asarray, sub), jnp.asarray(toks))
            tp = params_from_numpy(tcd, sub, "cpu")
            tf, td = torch_invariant(tcd, tp, torch.from_numpy(toks).long())
            del tp
            print(json.dumps({
                "init": init, "layers": depth,
                "jax": summary(jf, jd), "port": summary(tf, td),
                "port_vs_jax_full_max_abs_diff": float(
                    np.abs(tf - jf).max()),
                "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
