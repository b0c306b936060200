"""Adafactor (factored second moments, momentum-free), the JAX
package's ``optim/adafactor.py`` on torch tensors.

Follows Shazeer & Stern 2018 / the t5x implementation: rank-1 factored
second-moment statistics for >=2D params, decay 1 - t^-0.8, RMS-scaled
update clipping, relative step sizes.  ``update`` is functional;
``update_`` is the donated form (``optim/inplace.py``).
"""
from __future__ import annotations

import torch

from repro_torch.models.params import (
    map_specs,
    tree_leaves,
    tree_map,
    tree_zip,
    zeros_param,
)
from repro_torch.optim import inplace
from repro_torch.optim.adamw import Optimizer
from repro_torch.optim.schedule import constant

#: leaves larger than this (as f32) with a stacked-layers dim > 1 are
#: updated one layer slice at a time (the RMS clip becomes per layer),
#: as the JAX package's ``lax.map`` path does
CHUNK_BYTES = 1 << 28


def make_adafactor(
    *,
    lr_fn=None,
    eps1: float = 1e-30,
    eps2: float = 1e-3,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    lr_fn = lr_fn or constant(1e-4)

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def _stacked(p) -> bool:
        return p.ndim >= 3 and p.shape[0] > 1 and p.numel() * 4 > CHUNK_BYTES

    def init(params):
        def st(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}

        return {"stats": tree_map(st, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device)}

    def scalars(state, step):
        """(count + 1, beta2, lr), read once an update."""
        count = state["count"] + 1
        t = count.to(torch.float32)
        return count, 1.0 - t ** -0.8, lr_fn(step)

    def clip(u):
        rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps1)
        return u / torch.clamp(rms_u / clip_threshold, min=1.0)

    def apply(p, u, lr):
        base = p.to(torch.float32)
        scale = torch.clamp(torch.sqrt(torch.mean(torch.square(base))),
                            min=eps2)
        newp = base - lr * scale * u - lr * weight_decay * base
        return newp.to(p.dtype)

    def upd_factored(p, g, vr_old, vc_old, beta2, lr):
        g = g.to(torch.float32)
        g2 = torch.square(g) + eps1
        vr = beta2 * vr_old + (1 - beta2) * torch.mean(g2, dim=-1)
        vc = beta2 * vc_old + (1 - beta2) * torch.mean(g2, dim=-2)
        rfac = torch.rsqrt(
            vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                             min=eps1))[..., None]
        u = g * rfac * torch.rsqrt(vc)[..., None, :]
        return apply(p, clip(u), lr), vr, vc

    def upd_plain(p, g, v_old, beta2, lr):
        g = g.to(torch.float32)
        g2 = torch.square(g) + eps1
        v = beta2 * v_old + (1 - beta2) * g2
        return apply(p, clip(g * torch.rsqrt(v)), lr), v

    def leaf_math(p, g, st, beta2, lr):
        if "vr" in st:
            if _stacked(p):
                parts = [upd_factored(p[i], g[i], st["vr"][i], st["vc"][i],
                                      beta2, lr)
                         for i in range(p.shape[0])]
                newp, vr, vc = (torch.stack(a) for a in zip(*parts))
            else:
                newp, vr, vc = upd_factored(p, g, st["vr"], st["vc"], beta2,
                                            lr)
            return newp, {"vr": vr, "vc": vc}
        newp, v = upd_plain(p, g, st["v"], beta2, lr)
        return newp, {"v": v}

    def update(grads, state, params, step):
        count, beta2, lr = scalars(state, step)
        out = tree_zip(lambda p, g, st: leaf_math(p, g, st, beta2, lr),
                       params, grads, state["stats"])
        return (tree_map(lambda r: r[0], out),
                {"stats": tree_map(lambda r: r[1], out), "count": count})

    def update_(grads, state, params, step, shardings=None):
        """``update`` in place: a stacked leaf above ``CHUNK_BYTES`` layer
        by layer (the layers ``update`` computes one at a time), any
        other leaf whole (its RMS clip and its row and column means span
        it)."""
        with torch.no_grad():
            count, beta2, lr = scalars(state, step)
            local_scal = tuple(inplace.local(x) for x in (beta2, lr))

            def leaf_(path, p, g):
                st = inplace.at(state["stats"], path)
                if not inplace.whole_on_rank(p, g, st):
                    newp, new_st = leaf_math(p, g, st, beta2, lr)
                    inplace.write_(st, new_st)
                    inplace.write_(p, newp)
                    return
                p, g, st = (inplace.local(x) for x in (p, g, st))
                if "vr" in st and _stacked(p):
                    for i in range(p.shape[0]):
                        newp, vr, vc = upd_factored(
                            p[i], g[i], st["vr"][i], st["vc"][i],
                            *local_scal)
                        st["vr"][i].copy_(vr)
                        st["vc"][i].copy_(vc)
                        p[i].copy_(newp)
                        del newp, vr, vc
                    return
                newp, new_st = leaf_math(p, g, st, *local_scal)
                inplace.write_(st, new_st)
                inplace.write_(p, newp)

            inplace.each_leaf_(params, grads, shardings, leaf_)
            inplace.write_(state["count"], count)
        return params, state

    def state_schema(param_schema):
        def st(_, ps):
            if _factored(ps.shape):
                return {
                    "vr": zeros_param(ps.shape[:-1], ps.axes[:-1],
                                     torch.float32),
                    "vc": zeros_param(ps.shape[:-2] + ps.shape[-1:],
                                     ps.axes[:-2] + ps.axes[-1:],
                                     torch.float32),
                }
            return {"v": zeros_param(ps.shape, ps.axes, torch.float32)}

        return {"stats": map_specs(st, param_schema),
                "count": zeros_param((), (), torch.int32)}

    return Optimizer(init=init, update=update, state_schema=state_schema,
                     update_=update_)
