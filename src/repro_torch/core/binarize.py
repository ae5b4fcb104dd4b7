"""Binarization primitives, forward semantics (port of `repro.core.binarize`).

  * hard tanh HT(x)                          (Eq. 4)
  * hard sigmoid sigma(x) = (HT(x)+1)/2
  * deterministic binarization, sign(0) := +1 (Eq. 1 / 5)
  * the STE mask dHT/dx = 1[|x| <= 1]        (Eq. 6)

Inference only: the STE autograd Functions and stochastic binarization come
with the training slice of the port.
"""
from __future__ import annotations

import torch


def hard_tanh(x: torch.Tensor) -> torch.Tensor:
    """HT(x), Eq. (4)."""
    return x.clamp(-1.0, 1.0)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigma(x) = (HT(x)+1)/2 in [0, 1]."""
    return ((x + 1.0) * 0.5).clamp(0.0, 1.0)


def ste_mask(x: torch.Tensor) -> torch.Tensor:
    """Eq. (6): where the straight-through gradient passes."""
    return (x.abs() <= 1.0).to(x.dtype)


def binarize(x: torch.Tensor) -> torch.Tensor:
    """Deterministic sign with sign(0) := +1, in x's dtype (Eq. 1 / 5)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def binary_act(x: torch.Tensor) -> torch.Tensor:
    """Binarized activation: HT then sign (paper §3.2 forward pass)."""
    return binarize(hard_tanh(x))


def clip_weights(w: torch.Tensor) -> torch.Tensor:
    """Post-update weight clipping to [-1, 1] (paper §2.1 / Algorithm 1)."""
    return w.clamp(-1.0, 1.0)
