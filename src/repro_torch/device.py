"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
request for CUDA on a machine without one raises, and nothing picks the
CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``, with an index on CUDA.

    Raises ``RuntimeError`` when CUDA is asked for and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but no CUDA device is "
                f"available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
