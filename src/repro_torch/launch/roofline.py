"""Roofline terms from a cell's per-rank cost (the JAX package's
``launch/roofline.py``, its formulas and keys).

Three terms per (arch × shape × mesh), the card's constants from
``launch/hw.py`` (``H100_SXM`` by default):

    T_compute    = FLOPs_per_rank / peak bf16 FLOP/s
    T_memory     = bytes_per_rank / HBM rate
    T_collective = intra-pod bytes / (link rate × links)
                   + cross-pod bytes / the cluster <-> cloud rate

The FLOPs, bytes and collective bytes come from ``launch/op_cost.py``
(``OpCostMode``): the ops one rank runs on its local shards, the
registered kernels' own formulas, and the collectives DTensor issues,
wire-true per type as the JAX package counts them, a group over the
mesh's "pod" dim counted as cross-pod.
"""
from __future__ import annotations

from typing import Any

from repro_torch.launch.hw import H100_SXM, ChipSpec


def roofline_terms(
    flops_per_dev: float,
    bytes_per_dev: float,
    hc: dict,
    *,
    chip: ChipSpec = H100_SXM,
) -> dict[str, Any]:
    t_comp = flops_per_dev / chip.peak_flops_bf16
    t_mem = bytes_per_dev / chip.hbm_bw
    dci = float(hc.get("collective_dci_bytes", 0.0))
    ici = float(hc.get("collective_bytes", 0.0)) - dci
    t_ici = ici / (chip.ici_link_bw * chip.ici_links)
    t_dci = dci / chip.dci_bw
    t_coll = t_ici + t_dci
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll,
             "collective_ici": t_ici, "collective_dci": t_dci}
    dom = max(("compute", "memory", "collective"), key=lambda k: terms[k])
    bound = max(terms["compute"], terms["memory"], terms["collective"])
    return {
        **terms,
        "dominant": dom,
        "step_time_lower_bound_s": bound,
        "roofline_fraction": t_comp / bound if bound > 0 else 0.0,
    }


def model_flops(n_active_params: int, tokens: int, *, train: bool) -> float:
    """6·N·D for train, 2·N·D for forward-only (MoE: N = active params)."""
    return (6.0 if train else 2.0) * n_active_params * tokens
