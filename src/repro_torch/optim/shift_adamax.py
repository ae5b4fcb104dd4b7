"""AdaMax and the paper's shift-based AdaMax (S-AdaMax, §3.4; port of
`repro.optim.shift_adamax`).

AdaMax (Kingma & Ba):
    m_t = b1 m + (1-b1) g
    u_t = max(b2 u, |g|)
    w  -= (lr / (1 - b1^t)) * m_t / u_t

S-AdaMax constrains every multiplicative factor to a power of two: the
learning rate with its bias correction is snapped to AP2 (and decayed by
right-shifts), and 1/u_t is replaced by AP2(1/u_t), a shift. No weight
decay, no classic momentum (paper). The op order is the JAX package's; the
step count and every factor stay on the params' device (no host sync).
`donate=True` writes the new moments into the old ones and the updates into
the gradients, with the same rounding (`optim.base`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.ap2 import pow2, ap2
from repro_torch.optim.base import Optimizer, slices, tree_leaves, tree_map


class AdaMaxState(NamedTuple):
    m: Any
    u: Any
    step: torch.Tensor         # int32 scalar


def _init_like(params) -> AdaMaxState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = (lambda p: torch.zeros_like(p, dtype=torch.float32))
    return AdaMaxState(m=tree_map(zeros, params), u=tree_map(zeros, params),
                       step=torch.zeros((), dtype=torch.int32, device=dev))


def _lr_fn(lr) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def _moments(grads, state: AdaMaxState, b1: float, b2: float):
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                 state.m, grads)
    u = tree_map(lambda u_, g: torch.maximum(b2 * u_,
                                             g.to(torch.float32).abs()),
                 state.u, grads)
    return m, u


def _corr(step: torch.Tensor, b1: float) -> torch.Tensor:
    """The bias correction 1 - b1^t in float32, as the JAX package takes
    it."""
    return 1 - torch.pow(torch.full((), b1, dtype=torch.float32,
                                    device=step.device),
                         step.to(torch.float32))


def _donated(grads, state: AdaMaxState, b1: float, b2: float, upd):
    """The moments and updates written into state.m, state.u and the
    gradients, slice by slice: m = b1 m + (1 - b1) g, u = max(b2 u, |g|),
    g = upd(m, u). Returns (updates, new state)."""
    def leaf(m_, u_, g):
        g = g.contiguous()
        for m, u, gs in slices(m_, u_, g):
            g32 = gs.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g32)
            torch.maximum(u.mul_(b2), g32.abs(), out=u)
            gs.copy_(upd(m, u))
        return g
    updates = tree_map(leaf, state.m, state.u, grads)
    return updates, AdaMaxState(m=state.m, u=state.u, step=state.step + 1)


def adamax(lr: float | Callable[[torch.Tensor], torch.Tensor], b1: float = 0.9,
           b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Exact AdaMax baseline."""
    lr_fn = _lr_fn(lr)

    def update(grads, state, params=None, donate: bool = False):
        step = state.step + 1
        scale = lr_fn(step) / _corr(step, b1)

        def upd(m_, u_):
            return -scale * m_ / (u_ + eps)
        if donate:
            return _donated(grads, state, b1, b2, upd)
        m, u = _moments(grads, state, b1, b2)
        return tree_map(upd, m, u), AdaMaxState(m=m, u=u, step=step)

    return Optimizer(init=_init_like, update=update)


def shift_adamax(lr: float | Callable[[torch.Tensor], torch.Tensor],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                 ) -> Optimizer:
    """The paper's S-AdaMax: all scalings are AP2 power-of-2 shifts."""
    lr_fn = _lr_fn(lr)

    def update(grads, state, params=None, donate: bool = False):
        step = state.step + 1
        # lr (incl. bias correction) snapped to a single power-of-2 shift
        scale = ap2(lr_fn(step) / _corr(step, b1))

        def upd(m_, u_):
            # 1/u replaced by its AP2 proxy: a per-parameter shift
            return -scale * m_ * ap2(1.0 / (u_ + eps))
        if donate:
            return _donated(grads, state, b1, b2, upd)
        m, u = _moments(grads, state, b1, b2)
        return tree_map(upd, m, u), AdaMaxState(m=m, u=u, step=step)

    return Optimizer(init=_init_like, update=update)


def shift_lr_schedule(base_lr: float, halve_every: int
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Paper §5: lr starts at an AP2-rounded Glorot value and is shifted
    right (x0.5) every `halve_every` steps: always an exact power of two.
    (The JAX package builds 2^-shifts with jnp.exp2, which is not exact for
    shifts >= 13 on the CPU; the port builds it from the exponent bits.)"""
    import math
    exp = round(math.log2(base_lr))       # half to even, as np.round

    def schedule(step: torch.Tensor) -> torch.Tensor:
        shifts = torch.div(step, halve_every, rounding_mode="floor")
        return pow2((exp - shifts).to(torch.int32))

    return schedule
