"""Device resolution shared by the port's entry points.

Entry points run on the card by default.  Without one they raise rather
than carry on quietly on the CPU; the CPU runs only when asked for.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the CPU"
        )
    return dev


def synchronize(device) -> None:
    """Fence for host-clock timing: wait for the queued work of a card, or
    of every card of a sequence of devices (a scenario mesh)."""
    devices = device if isinstance(device, (tuple, list)) else (device,)
    for d in dict.fromkeys(torch.device(x) for x in devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
