"""Checkpoints in the JAX package's on-disk layout."""
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    NoIntactCheckpointError,
    install_preemption_hook,
)

__all__ = ["CheckpointManager", "NoIntactCheckpointError",
           "install_preemption_hook"]
