"""LR schedules, as the JAX package's: functions of the step (an int or
an int tensor) returning an f32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _device(step):
    return step.device if isinstance(step, torch.Tensor) else None


def warmup_cosine(
    peak_lr: float = 3e-4,
    warmup_steps: int = 200,
    total_steps: int = 10_000,
    min_ratio: float = 0.1,
):
    def lr(step):
        # lint: disable=host-sync -- the train steps pass the state's step,
        # a tensor on the card already: as_tensor copies nothing
        step = torch.as_tensor(step, dtype=torch.float32,
                               device=_device(step))
        warm = step / max(warmup_steps, 1)
        frac = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0,
        )
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return peak_lr * torch.where(step < warmup_steps, warm, cos)

    return lr


def constant(peak_lr: float = 1e-4):
    return lambda step: torch.full((), peak_lr, dtype=torch.float32,
                                   device=_device(step))
