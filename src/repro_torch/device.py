"""Default-device rule of the port.

Entry points that create tensors from nothing (graph constructors, modulation
and hyperparameter initialisers, the interop converters) run on the card
unless the caller asks for the CPU.  Everything downstream works on the
device of its inputs.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a torch.device; ``None`` means the CUDA card.

    Raises instead of falling back to the CPU when no card is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
