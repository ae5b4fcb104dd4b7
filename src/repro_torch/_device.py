"""Where the port's entry points put their tensors, and what the card has."""
from __future__ import annotations

import contextlib
import functools

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


def draw_device(gen: torch.Generator, device: torch.device) -> torch.device:
    """Where an init draws from `gen`: on the generator's device, or on the
    meta device when the tensors go there (shapes only: nothing is drawn
    or allocated, and the generator does not move)."""
    return device if device.type == "meta" else gen.device


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of CUDA `device` (the kernels' launch
    plans fill the card by it)."""
    index = torch.device(device).index
    return _sms(torch.cuda.current_device() if index is None else index)


def on_device(device: torch.device):
    """The context that makes CUDA `device` current for the calling thread
    (the kernels launch on the current device); nothing for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
