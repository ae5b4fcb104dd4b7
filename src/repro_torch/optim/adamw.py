"""AdamW and SGD baselines for the LM configs with quant='none' (port of
`repro.optim.adamw`). The op order is the JAX package's, in float32; the
step count and every factor stay on the params' device. `donate=True`
writes the new state into the old one and the updates into the gradients,
with the same rounding (`optim.base`)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.optim.base import Optimizer, slices, tree_leaves, tree_map
from repro_torch.optim.shift_adamax import _lr_fn

_F32 = torch.float32


class AdamWState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor         # int32 scalar


def _device(params):
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else None


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=_F32), params)


def adamw(lr: float | Callable[[torch.Tensor], torch.Tensor], b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return AdamWState(m=_zeros(params), v=_zeros(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=_device(params)))

    def update(grads, state, params, donate: bool = False):
        step = state.step + 1
        t = step.to(_F32)
        lr_t = lr_fn(step)
        mc = 1 - torch.pow(torch.full((), b1, dtype=_F32, device=t.device), t)
        vc = 1 - torch.pow(torch.full((), b2, dtype=_F32, device=t.device), t)

        def upd(m_, v_, p):
            adam = (m_ / mc) / (torch.sqrt(v_ / vc) + eps)
            return -lr_t * (adam + weight_decay * p.to(_F32))

        if donate:
            def leaf(m_, v_, p, g):
                g = g.contiguous()
                for m, v, ps, gs in slices(m_, v_, p, g):
                    g32 = gs.to(_F32)
                    m.mul_(b1).add_((1 - b1) * g32)
                    v.mul_(b2).add_((1 - b2) * torch.square(g32))
                    gs.copy_(upd(m, v, ps))
                return g
            updates = tree_map(leaf, state.m, state.v, params, grads)
            return updates, AdamWState(m=state.m, v=state.v, step=step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(_F32),
                     state.m, grads)
        v = tree_map(lambda v_, g: b2 * v_
                     + (1 - b2) * torch.square(g.to(_F32)), state.v, grads)
        return tree_map(upd, m, v, params), AdamWState(m=m, v=v, step=step)

    return Optimizer(init=init, update=update)


def sgd(lr: float | Callable[[torch.Tensor], torch.Tensor],
        momentum: float = 0.0) -> Optimizer:
    """State (momentum buffers or None, step)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return (_zeros(params) if momentum else None,
                torch.zeros((), dtype=torch.int32, device=_device(params)))

    def update(grads, state, params=None, donate: bool = False):
        mom, step = state
        step = step + 1
        lr_t = lr_fn(step)
        if momentum:
            mom = tree_map(
                (lambda b, g: b.mul_(momentum).add_(g.to(_F32))) if donate
                else (lambda b, g: momentum * b + g.to(_F32)), mom, grads)
            eff = mom
        else:
            eff = grads
        updates = tree_map(lambda e, g: torch.mul(
            -lr_t, e.to(_F32), out=g if donate else None), eff, grads)
        return updates, (mom, step)

    return Optimizer(init=init, update=update)
