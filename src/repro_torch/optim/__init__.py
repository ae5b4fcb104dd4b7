"""Optimizers: the paper's shift-based AdaMax and its exact baseline (port
of `repro.optim`; AdamW and EF-signSGD wait for the LM training slice)."""
from repro_torch.optim.base import Optimizer, OptState, apply_updates
from repro_torch.optim.shift_adamax import adamax, shift_adamax

__all__ = ["Optimizer", "OptState", "apply_updates", "shift_adamax", "adamax"]
