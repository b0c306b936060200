# The paper's primary contribution: self-adaptive deadline-driven
# auto-scaling (cloud bursting) — monitoring, capacity models (eqs 1-3,
# 6-7), γ domain split (eqs 4-5, 8), burst planning (Fig. 1) and the
# elastic orchestrator that executes it on TPU multi-pod meshes.
from repro_torch.core.allocator import (
    HeterogeneousPlan,
    PodShare,
    conservation_ok,
    heterogeneous_split,
    max_min_fair_allocation,
    min_weighted_share,
    proportional_shares,
)
from repro_torch.core.capacity import (
    LogCapacityModel,
    ThroughputModel,
    burst_cores,
    correction_factor,
    floor_to_legal_slice,
    legal_step_down,
    legal_step_up,
    round_to_legal_slice,
)
from repro_torch.core.deadline import DeadlineEstimate, DeadlinePredictor
from repro_torch.core.gamma import GammaModel, split_gamma
from repro_torch.core.monitor import StepTimeMonitor
from repro_torch.core.orchestrator import (
    AutoscalerPolicy,
    BurstDecision,
    ElasticOrchestrator,
    PodFailure,
    PodSpec,
    Resources,
    RunRecord,
    ScaleAction,
    ScaleContext,
    elastic_chips,
)
from repro_torch.core.planner import BurstPlanner, OverheadModel

__all__ = [
    "AutoscalerPolicy",
    "BurstDecision",
    "BurstPlanner",
    "DeadlineEstimate",
    "DeadlinePredictor",
    "ElasticOrchestrator",
    "GammaModel",
    "HeterogeneousPlan",
    "LogCapacityModel",
    "OverheadModel",
    "PodFailure",
    "PodShare",
    "PodSpec",
    "Resources",
    "RunRecord",
    "ScaleAction",
    "ScaleContext",
    "StepTimeMonitor",
    "ThroughputModel",
    "burst_cores",
    "conservation_ok",
    "correction_factor",
    "elastic_chips",
    "floor_to_legal_slice",
    "heterogeneous_split",
    "legal_step_down",
    "legal_step_up",
    "max_min_fair_allocation",
    "min_weighted_share",
    "proportional_shares",
    "round_to_legal_slice",
    "split_gamma",
]
