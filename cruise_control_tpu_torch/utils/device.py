"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when CUDA is asked for
    and no card is present (never a silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run on the CPU"
        )
    return dev
