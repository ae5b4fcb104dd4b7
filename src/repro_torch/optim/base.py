"""Minimal functional optimizer interface (port of `repro.optim.base`).

An Optimizer is (init, update):
    state = init(params)
    updates, state = update(grads, state, params)
    params = apply_updates(params, updates)

Trees are the port's param trees: dicts, lists, tuples and NamedTuples
(`BNParams`, `AdaMaxState`) with tensors at the leaves, walked in a fixed
order (dict insertion order; `jax.tree_util` sorts dict keys, which
`checkpoint.manager` reproduces where the order is written down). None
is an empty subtree, as in JAX (sgd's state without momentum). A leaf's
path is the tuple of dict keys, sequence indices and NamedTuple field names
above it. The functions run under the caller's grad mode; the train step
calls them under `torch.no_grad()`.

`update(grads, state, params, donate=False)`: with donate=True the port's
optimizers write the new state into `state`'s tensors and the updates into
`grads`' (the inputs are consumed, as a jitted JAX step donates them), a
slice of each leaf at a time (`slices`), so that neither a second
optimizer state nor an update tree nor a whole leaf's temporaries are ever
resident; the values are the same bit for bit (every op is elementwise).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

OptState = Any


class Optimizer(NamedTuple):
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], tuple[Any, OptState]]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map_with_path(fn: Callable, tree, *rest, path: tuple = ()):
    """fn(path, leaf, *leaves of `rest` at the same place) over every leaf;
    `rest` trees have `tree`'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map_with_path(fn, v, *(getattr(r, f) for r in rest),
                               path=path + (f,))
            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten_like(tree, leaves):
    """`tree`'s structure with `leaves` in its leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


SLICE = 1 << 24          # elements of a donated update's slice


def slices(*tensors: torch.Tensor):
    """Matching flat slices (views) of SLICE elements of contiguous
    tensors of one shape."""
    flat = [t.view(-1) for t in tensors]
    for lo in range(0, flat[0].numel(), SLICE):
        yield [f[lo:lo + SLICE] for f in flat]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


def chain_weight_clip(opt: Optimizer, lo: float = -1.0, hi: float = 1.0,
                      predicate: Callable[[tuple], bool] | None = None
                      ) -> Optimizer:
    """Wrap an optimizer so updated params are clipped into [lo, hi] (paper
    Algorithm 1's clip(W - dW)). `predicate(path)` may restrict the clip to
    binarized weight leaves."""
    def update(grads, state, params, donate: bool = False):
        updates, state = opt.update(grads, state, params, donate=donate)

        def clip_update(path, p, u):
            if predicate is not None and not predicate(path):
                return u
            return torch.clamp(p + u, lo, hi) - p

        return tree_map_with_path(clip_update, params, updates), state

    return Optimizer(init=opt.init, update=update)
