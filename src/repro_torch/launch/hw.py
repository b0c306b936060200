"""Hardware constants for the roofline analysis: the JAX package's TPU
v5e spec, copied field for field, and the NVIDIA cards the port runs on.

``ChipSpec`` is the JAX package's record with one field added,
``peak_flops_f32``: the f32 rate without tensor cores, which the plain
CUDA-core kernels' bounds use (the TPU spec leaves it unset).  Every
H100-class number is from NVIDIA's data sheets, dense (no sparsity):

* ``peak_flops_bf16``: bf16 tensor-core FLOP/s;
* ``hbm_bw`` and ``hbm_bytes``: the card's HBM rate and size;
* ``ici_link_bw`` and ``ici_links``: the card's NVLink 4 links in the
  place of the TPU's ICI, one direction (25 GB/s a link: 18 links on
  an SXM card, 900 GB/s both ways; 12 on a card joined by NVLink
  bridges, 600 GB/s both ways);
* ``dci_bw``: stays at the JAX package's 6.25e9 B/s a chip.  It models
  the paper's cluster <-> cloud link, which no card has, so the
  cross-pod term reads the same link on either spec.

``spec_for`` picks the spec of a card by the name ``nvidia-smi`` (or
``torch.cuda.get_device_name``) reports.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float     # FLOP/s
    hbm_bw: float              # bytes/s
    hbm_bytes: int             # capacity
    ici_link_bw: float         # bytes/s per link per direction
    ici_links: int             # links per chip participating in a collective
    dci_bw: float              # inter-pod (data-center interconnect) bytes/s/chip
    peak_flops_f32: float | None = None   # FLOP/s without tensor cores


TPU_V5E = ChipSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,    # 197 TFLOP/s bf16
    hbm_bw=819e9,              # 819 GB/s
    hbm_bytes=16 * 1024**3,    # 16 GiB
    ici_link_bw=50e9,          # ~50 GB/s per link (brief-provided constant)
    ici_links=2,               # 2D torus on v5e: 2 axes usable per transfer
    dci_bw=6.25e9,             # ~50 Gbit/s/chip-equivalent across pods
)

#: the paper's cluster <-> cloud link, as the JAX package models it
DCI_BW = TPU_V5E.dci_bw

H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80 * 10**9,
    ici_link_bw=25e9,
    ici_links=18,
    dci_bw=DCI_BW,
    peak_flops_f32=67e12,
)

H100_PCIE = ChipSpec(
    name="h100_pcie",
    peak_flops_bf16=756e12,
    hbm_bw=2.0e12,
    hbm_bytes=80 * 10**9,
    ici_link_bw=25e9,
    ici_links=12,
    dci_bw=DCI_BW,
    peak_flops_f32=51e12,
)

H100_NVL = ChipSpec(
    name="h100_nvl",
    peak_flops_bf16=835e12,
    hbm_bw=3.9e12,
    hbm_bytes=94 * 10**9,
    ici_link_bw=25e9,
    ici_links=12,
    dci_bw=DCI_BW,
    peak_flops_f32=60e12,
)

H200 = ChipSpec(
    name="h200",
    peak_flops_bf16=989e12,
    hbm_bw=4.8e12,
    hbm_bytes=141 * 10**9,
    ici_link_bw=25e9,
    ici_links=18,
    dci_bw=DCI_BW,
    peak_flops_f32=67e12,
)

#: (substring of the reported card name, spec), the first match wins:
#: "H100 PCIe" and "H100 NVL" before the SXM card's plain "H100"
CARDS = (
    ("H100 PCIe", H100_PCIE),
    ("H100 NVL", H100_NVL),
    ("H100", H100_SXM),
    ("H200", H200),
)


def spec_for(name: str) -> ChipSpec:
    """The spec of the card ``name`` (as ``nvidia-smi`` reports it, e.g.
    "NVIDIA H100 80GB HBM3"); raises ``KeyError`` for a card not in
    ``CARDS``."""
    for key, spec in CARDS:
        if key in name:
            return spec
    raise KeyError(f"no peak rates known for card {name!r}")


def pod_flops(chips: int, spec: ChipSpec = TPU_V5E) -> float:
    return chips * spec.peak_flops_bf16


def pod_hbm_bw(chips: int, spec: ChipSpec = TPU_V5E) -> float:
    return chips * spec.hbm_bw


def pod_ici_bw(chips: int, spec: ChipSpec = TPU_V5E) -> float:
    return chips * spec.ici_link_bw
