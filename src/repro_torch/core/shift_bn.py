"""Shift-based Batch Normalization (paper §3.3, Eqs. 7-10; port of
`repro.core.shift_bn`).

    C(x)        = x - <x>
    var_p2      = < C(x) << AP2(C(x)) >                         (self-shift)
    inv_std_p2  = AP2( 1/sqrt(var_p2 + eps) )                   (Eq. 9)
    BN_AP2(x)   = (C(x) << inv_std_p2) << AP2(gamma) + beta     (Eq. 10)

Training mode (`train=True`) normalizes by the batch moments over every axis
but the last and updates the running statistics (momentum 0.9, count + 1);
inference reads them. The op order mirrors the JAX package exactly; every
shift-BN factor is an exact power of two, and AP2 has zero gradient (its
round and sign), as in JAX, so no gradient flows through a shift factor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core.ap2 import ap2, shift_mul


class BNParams(NamedTuple):
    gamma: torch.Tensor
    beta: torch.Tensor


class BNState(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # scalar step counter for the running average


def init_bn(dim: int, dtype=torch.float32, *, device=None
            ) -> tuple[BNParams, BNState]:
    dev = resolve_device(device)
    return (
        BNParams(gamma=torch.ones(dim, dtype=dtype, device=dev),
                 beta=torch.zeros(dim, dtype=dtype, device=dev)),
        BNState(mean=torch.zeros(dim, dtype=dtype, device=dev),
                var=torch.ones(dim, dtype=dtype, device=dev),
                count=torch.zeros((), dtype=torch.int32, device=dev)),
    )


def _moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    axes = tuple(range(x.ndim - 1))
    mean = x.mean(dim=axes)
    return mean, x - mean, axes


def _update(state: BNState, mean: torch.Tensor, var: torch.Tensor,
            momentum: float) -> BNState:
    return BNState(mean=momentum * state.mean + (1 - momentum) * mean,
                   var=momentum * state.var + (1 - momentum) * var,
                   count=state.count + 1)


def batch_norm(params: BNParams, state: BNState, x: torch.Tensor, *,
               train: bool = False, eps: float = 1e-4, momentum: float = 0.9
               ) -> tuple[torch.Tensor, BNState]:
    """Exact BN baseline (Ioffe & Szegedy): batch moments at train time,
    running statistics at inference."""
    if train:
        mean, cent, axes = _moments(x)
        var = (cent * cent).mean(dim=axes)
        new_state = _update(state, mean.detach(), var.detach(), momentum)
    else:
        var, cent, new_state = state.var, x - state.mean, state
    inv = torch.rsqrt(var + eps)
    return cent * inv * params.gamma + params.beta, new_state


def shift_batch_norm(params: BNParams, state: BNState, x: torch.Tensor, *,
                     train: bool = False, eps: float = 1e-4,
                     momentum: float = 0.9) -> tuple[torch.Tensor, BNState]:
    """Shift-based BN (Eqs. 9-10): every multiply is an AP2 shift proxy."""
    if train:
        mean, cent, axes = _moments(x)
        # Eq. 9: C(x)^2 replaced by C(x) << AP2(C(x)) (self-shift square)
        var_p2 = shift_mul(cent, cent).mean(dim=axes).abs()
        new_state = _update(state, mean.detach(), var_p2.detach(), momentum)
    else:
        var_p2, cent, new_state = state.var, x - state.mean, state
    inv_p2 = ap2(torch.rsqrt(var_p2 + eps))       # Eq. 9 outer AP2
    # Eq. 10: two chained shifts + add
    out = shift_mul(cent * inv_p2, params.gamma) + params.beta
    return out, new_state
