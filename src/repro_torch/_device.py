"""Where the port's entry points put their tensors."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card.

    Never falls back to the CPU on its own: with no card and no explicit
    device it raises, so a run that was meant for the card cannot quietly
    measure the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
