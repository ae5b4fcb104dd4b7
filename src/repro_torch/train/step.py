"""The LM train and eval steps (port of `repro.train.step`).

The train step is Algorithm 1 at LM scale: the gradient of every fp32
master through the binarized forward (the STE; `torch.autograd.grad`), the
optimizer's update (S-AdaMax by default for the binary modes, AdamW for
quant='none'), `apply_updates`, then clip(W) on every binarized
projection weight.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.binarize import clip_weights
from repro_torch.models.api import Model
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import (
    Optimizer, tree_leaves, tree_map, tree_unflatten_like,
)
from repro_torch.optim.shift_adamax import shift_adamax

# dict keys of binarized projection weights (clipped to [-1, 1] per Alg. 1).
# Not the same as core.packed.BINARY_WEIGHT_KEYS (the freeze / serve set):
# w_input_gate and w_rec_gate are clipped here but consumed at full
# precision in the RG-LRU recurrence, so they are never frozen to 1-bit.
_CLIP_KEYS = {
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "in_proj",
    "out_proj", "w_x", "w_out", "w_input_gate", "w_rec_gate", "w",
}


def _clip_tree(node, clip: bool, inplace: bool):
    if isinstance(node, dict):
        return {k: _clip_tree(v, clip or k in _CLIP_KEYS, inplace)
                for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_clip_tree(v, clip, inplace) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_clip_tree(v, clip, inplace) for v in node)
    if not clip:
        return node
    return node.clamp_(-1.0, 1.0) if inplace else clip_weights(node)


def clip_binary_weights(params, *, inplace: bool = False):
    """Clip every leaf with a dict key of `_CLIP_KEYS` on its path to [-1,
    1] (in place with `inplace`)."""
    return _clip_tree(params, False, inplace)


def default_optimizer(cfg: ModelConfig, lr: float = 1e-3) -> Optimizer:
    if cfg.quant == "none":
        return adamw(lr, weight_decay=0.1)
    return shift_adamax(lr)          # the paper's optimizer (AP2 shifts)


def _split(batch: dict, accum: int) -> list[dict]:
    """`accum` microbatches of consecutive rows of every batch leaf."""
    def part(x, i):
        n = x.shape[0] // accum
        return x[i * n:(i + 1) * n]
    return [{k: part(v, i) for k, v in batch.items()} for i in range(accum)]


def make_train_step(model: Model, opt: Optimizer, *,
                    accum: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch, gen=None) -> (params,
    opt_state, metrics {nll, [lb_loss], loss}).

    `gen` draws the stochastic binarization and is used in mode 'bbp' only
    (the JAX step passes its key in that mode only). accum > 1: gradient
    accumulation over `accum` microbatches of the batch, run in turn
    (activation memory scales with the microbatch), their gradients summed
    in float32 from zeros and divided by `accum`; loss and metrics are the
    microbatches' means. The step consumes params and opt_state: it writes
    the new values into their tensors (the optimizer's `donate`, the
    update and the clip in place), so that one copy of each is resident,
    as the JAX trainer's jitted step donates them."""
    cfg = model.cfg
    needs_gen = cfg.quant == "bbp"

    def grads_of(masters, leaves, batch, gen):
        loss, metrics = model.loss(masters, batch,
                                   gen=gen if needs_gen else None)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]

    def train_step(params, opt_state, batch, gen=None):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        masters = tree_unflatten_like(params, leaves)
        if accum == 1:
            loss, metrics, grads = grads_of(masters, leaves, batch, gen)
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            losses, mets = [], []
            for mb in _split(batch, accum):
                loss, m, g = grads_of(masters, leaves, mb, gen)
                acc = [a + b.to(torch.float32) for a, b in zip(acc, g)]
                losses.append(loss)
                mets.append(m)
            grads = [a / accum for a in acc]
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        del masters, leaves
        with torch.no_grad():
            updates, opt_state = opt.update(tree_unflatten_like(params, grads),
                                            opt_state, params, donate=True)
            del grads
            tree_map(lambda p, u: p.add_(u), params, updates)
            del updates
            if cfg.quant != "none":
                params = clip_binary_weights(params, inplace=True)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def make_eval_step(model: Model) -> Callable:
    """eval_step(params, batch) -> metrics {nll, [lb_loss], loss} of the
    training loss, deterministic binarization, no gradient."""
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch)
        return dict(metrics, loss=loss)
    return eval_step
