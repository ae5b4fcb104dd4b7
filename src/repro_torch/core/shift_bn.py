"""Shift-based Batch Normalization at inference (port of `repro.core.shift_bn`).

    inv_std_p2  = AP2( 1/sqrt(var + eps) )                    (Eq. 9)
    BN_AP2(x)   = ((x - mean) * inv_std_p2) * AP2(gamma) + beta (Eq. 10)

The op order mirrors the JAX package exactly; every shift-BN factor is an
exact power of two, which is what lets the port match it bit for bit.
Running statistics are only read here: the training-mode update comes with
the training slice.
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


def batch_norm(params: BNParams, state: BNState, x: torch.Tensor, *,
               eps: float = 1e-4) -> tuple[torch.Tensor, BNState]:
    """Exact BN baseline (Ioffe & Szegedy) from running statistics."""
    cent = x - state.mean
    inv = torch.rsqrt(state.var + eps)
    return cent * inv * params.gamma + params.beta, state


def shift_batch_norm(params: BNParams, state: BNState, x: torch.Tensor, *,
                     eps: float = 1e-4) -> tuple[torch.Tensor, BNState]:
    """Shift-based BN (Eqs. 9-10) from running statistics."""
    cent = x - state.mean
    inv_p2 = ap2(torch.rsqrt(state.var + eps))
    out = shift_mul(cent * inv_p2, params.gamma) + params.beta
    return out, state
