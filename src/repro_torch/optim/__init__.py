"""Optimizers: AdamW (+int8 moments), Adafactor, schedules — the JAX
package's ``optim``, on plain tensors or DTensors; ``compression.py`` is
the cross-pod int8 gradient exchange."""
from repro_torch.optim.adafactor import make_adafactor
from repro_torch.optim.adamw import Optimizer, make_adamw
from repro_torch.optim.schedule import constant, warmup_cosine


def make_optimizer(name: str, lr_fn=None) -> Optimizer:
    if name == "adamw":
        return make_adamw(lr_fn=lr_fn)
    if name == "adamw8bit":
        return make_adamw(lr_fn=lr_fn, int8=True)
    if name == "adafactor":
        return make_adafactor(lr_fn=lr_fn)
    raise ValueError(f"unknown optimizer {name!r}")


__all__ = [
    "Optimizer",
    "constant",
    "make_adafactor",
    "make_adamw",
    "make_optimizer",
    "warmup_cosine",
]
