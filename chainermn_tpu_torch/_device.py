"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The ``torch.device`` an entry point runs on.  The entry points
    default to ``"cuda"``; without a card that raises instead of
    quietly running on the CPU, which only an explicit ``"cpu"`` asks
    for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
