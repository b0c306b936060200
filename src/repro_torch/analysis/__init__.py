"""repro-lint for the port: AST static analysis of ``src/repro_torch``.

The JAX package's ``repro.analysis`` (DESIGN.md §18) for the port's own
idiom.  Framework (``core``, a copy): ``Rule`` protocol, per-file and
cross-file passes, structured ``Finding``s, ``# lint: disable=<rule>``
suppressions, human/JSON output.  ``csrc`` reads the kernels' CUDA
sources, where ``// lint: disable=<rule> -- why`` suppresses.  Rules:

* ``smem-budget``      — each CUDA launch's dynamic shared memory vs
                         its Python formula, plus the kernel's static
                         ``__shared__`` arrays vs ``MAX_SMEM_BYTES``
                         (the port's ``vmem-budget``)
* ``async-pairing``    — the TMA rings' mbarrier init / arrive / wait
                         pairing, phase parity and stages (the port's
                         ``dma-pairing``)
* ``sim-determinism``  — unordered iteration / entropy sources in
                         ``repro_torch.sim`` (a copy)
* ``host-sync``        — calls that make the host wait for the card,
                         reachable from the hot path (the port's
                         ``tracer-hygiene``)
* ``design-citations`` — docstring section citations resolve against
                         DESIGN.md's headings (a copy)

Import-light on purpose: neither torch nor jax, so ``python -m
repro_torch.analysis`` pays only the package's own ``import torch``.
"""
from repro_torch.analysis.async_pairing import AsyncPairingRule
from repro_torch.analysis.core import (
    Analyzer,
    FileContext,
    Finding,
    PerFileRule,
    Rule,
    analyze_source,
    iter_py_files,
    render_human,
    to_json,
)
from repro_torch.analysis.design_citations import DesignCitationsRule
from repro_torch.analysis.host_sync import HostSyncRule
from repro_torch.analysis.sim_determinism import SimDeterminismRule
from repro_torch.analysis.smem_budget import SmemBudgetRule
from repro_torch.analysis.symeval import SymEval, SymEvalError

ALL_RULES = (
    SmemBudgetRule,
    AsyncPairingRule,
    SimDeterminismRule,
    HostSyncRule,
    DesignCitationsRule,
)


def default_rules() -> list[Rule]:
    """One instance of every registered rule."""
    return [cls() for cls in ALL_RULES]


__all__ = [
    "ALL_RULES",
    "Analyzer",
    "AsyncPairingRule",
    "DesignCitationsRule",
    "FileContext",
    "Finding",
    "HostSyncRule",
    "PerFileRule",
    "Rule",
    "SimDeterminismRule",
    "SmemBudgetRule",
    "SymEval",
    "SymEvalError",
    "analyze_source",
    "default_rules",
    "iter_py_files",
    "render_human",
    "to_json",
]
