"""Binarization primitives for Binarized Back-Propagation (port of
`repro.core.binarize`).

  * hard tanh HT(x)                                   (Eq. 4)
  * hard sigmoid sigma(x) = (HT(x)+1)/2
  * deterministic binarization, sign(0) := +1         (Eq. 1 / 5)
  * stochastic binarization, P(+1) = sigma(x)         (Eq. 2 / 3)
  * straight-through estimator dHT/dx = 1[|x| <= 1]   (Eq. 6)

The binarizers return {-1, +1} in x's dtype and are `torch.autograd.
Function`s whose backward is the STE, as the JAX package's `custom_vjp`s.

Stochastic draws u ~ U[0, 1) come from an explicit `torch.Generator` on x's
device, or are passed in as `noise` (a tensor of x's shape); the result is
where(u < sigma(x), +1, -1). The draws differ from JAX's PRNG for the same
seed: the parity tests feed JAX's own draws in as `noise`.

`hard_tanh` has the gradient of `jnp.clip`, not of `torch.clamp`: 1/2 at
exactly +-1 (JAX's clip is max then min, and JAX splits the gradient of a
tie of max / min evenly). Activations that are already +-1 meet that tie on
every element, so it is part of the gradient the port reproduces.
"""
from __future__ import annotations

import torch


class _HardTanh(torch.autograd.Function):
    """clamp(x, -1, 1) with jnp.clip's gradient: 1 inside, 1/2 at +-1, 0
    outside."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(-1.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        a = x.abs()
        return torch.where(a < 1.0, g, torch.where(a == 1.0, g * 0.5,
                                                   torch.zeros_like(g)))


def hard_tanh(x: torch.Tensor) -> torch.Tensor:
    """HT(x), Eq. (4)."""
    return _HardTanh.apply(x)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigma(x) = (HT(x)+1)/2 in [0, 1]."""
    return ((x + 1.0) * 0.5).clamp(0.0, 1.0)


def ste_mask(x: torch.Tensor) -> torch.Tensor:
    """Eq. (6): where the straight-through gradient passes."""
    return (x.abs() <= 1.0).to(x.dtype)


class _BinarizeDet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ste_mask(x)


class _BinarizeStoch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, u):
        ctx.save_for_backward(x)
        return torch.where(u < hard_sigmoid(x), 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ste_mask(x), None


def binarize_det(x: torch.Tensor) -> torch.Tensor:
    """sign(x), sign(0) := +1, with the STE backward g * 1[|x| <= 1]."""
    return _BinarizeDet.apply(x)


def uniform_noise(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """u ~ U[0, 1) of x's shape and dtype, drawn from `gen` on x's device."""
    return torch.rand(x.shape, generator=gen, dtype=x.dtype, device=x.device)


def binarize_stoch(x: torch.Tensor, gen: torch.Generator | None = None,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """+1 with probability hard_sigmoid(x), else -1 (Eq. 2), with the STE
    backward. u is `noise` when given, else a fresh draw from `gen`."""
    if noise is None:
        if gen is None:
            raise ValueError("stochastic binarization needs a generator or "
                             "a noise tensor")
        noise = uniform_noise(x, gen)
    if noise.shape != x.shape:
        raise ValueError(f"noise of shape {tuple(noise.shape)} for x of "
                         f"shape {tuple(x.shape)}")
    return _BinarizeStoch.apply(x, noise)


def binarize(x: torch.Tensor, *, stochastic: bool = False,
             gen: torch.Generator | None = None,
             noise: torch.Tensor | None = None) -> torch.Tensor:
    """Unified entry point. Train phase: stochastic=True with `gen` or
    `noise` (Eq. 3); test phase and deterministic modes: stochastic=False
    (Eq. 1 / 5). Both carry the STE."""
    if stochastic:
        return binarize_stoch(x, gen, noise)
    return binarize_det(x)


def binary_act(x: torch.Tensor, *, stochastic: bool = False,
               gen: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
    """Binarized activation: HT then binarize (paper §3.2 forward pass).
    Its STE is Eq. (6), HT's derivative."""
    return binarize(hard_tanh(x), stochastic=stochastic, gen=gen, noise=noise)


def clip_weights(w: torch.Tensor) -> torch.Tensor:
    """Post-update weight clipping to [-1, 1] (paper §2.1 / Algorithm 1)."""
    return w.clamp(-1.0, 1.0)


def saturation_fraction(w: torch.Tensor, tol: float = 1e-3) -> torch.Tensor:
    """Fraction of weights at the clipping edges (paper Fig. 4 metric)."""
    return (w.abs() >= 1.0 - tol).to(torch.float32).mean()
