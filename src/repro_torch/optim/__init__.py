"""Optimizers (port of `repro.optim`): the paper's shift-based AdaMax and its
exact baseline, AdamW and SGD for quant='none', and EF-SignSGD's
compression numerics (`optim.ef_signsgd`)."""
from repro_torch.optim.adamw import adamw, sgd
from repro_torch.optim.base import Optimizer, OptState, apply_updates
from repro_torch.optim.shift_adamax import adamax, shift_adamax

__all__ = ["Optimizer", "OptState", "apply_updates", "shift_adamax", "adamax",
           "adamw", "sgd"]
