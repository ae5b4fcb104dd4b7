"""The LM train and eval steps (port of `repro.train.step`).

The train step is Algorithm 1 at LM scale: the gradient of every fp32
master through the binarized forward (the STE; `torch.autograd.grad`), the
optimizer's update (S-AdaMax by default for the binary modes, AdamW for
quant='none'), `apply_updates`, then clip(W) on every binarized
projection weight.

`make_train_step(..., mesh=)` is the data-parallel step over a
`launch.mesh.Mesh`: the JAX package's sharded step is GSPMD over its
param shardings, which computes the single-device step's function; the
port computes that function with one process driving every shard, as its
serving mesh does (a device may repeat). The batch axes ('pod', 'data')
split the batch's rows; 'model' holds nothing in training (tensor
parallelism inside the model is ROADMAP Queue A item 6c). See
`_mesh_train_step`.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.binarize import clip_weights
from repro_torch.core.layers import BatchShard
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shardings import batch_shards, devices_of
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


def make_train_step(model: Model, opt: Optimizer, *, accum: int = 1,
                    mesh: Mesh | None = None) -> Callable:
    """Returns train_step(params, opt_state, batch, gen=None) -> (params,
    opt_state, metrics {nll, [lb_loss], loss}); over `mesh` the
    data-parallel step (`_mesh_train_step`).

    `gen` draws the stochastic binarization and is used in mode 'bbp' only
    (the JAX step passes its key in that mode only). accum > 1: gradient
    accumulation over `accum` microbatches of the batch, run in turn
    (activation memory scales with the microbatch), their gradients summed
    in float32 from zeros and divided by `accum`; loss and metrics are the
    microbatches' means. The step consumes params and opt_state: it writes
    the new values into their tensors (the optimizer's `donate`, the
    update and the clip in place), so that one copy of each is resident,
    as the JAX trainer's jitted step donates them."""
    if mesh is not None:
        return _mesh_train_step(model, opt, accum, mesh)
    cfg = model.cfg
    grads_of = _grads_of(model)

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
        params, opt_state = apply_step(opt, cfg.quant != "none", params,
                                       opt_state, grads)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def apply_step(opt: Optimizer, clip: bool, params, opt_state, grads):
    """The optimizer's donated update from `grads` (leaves in params'
    order, consumed), added to params in place, then the clip where
    `clip`: (params, opt_state)."""
    with torch.no_grad():
        updates, opt_state = opt.update(tree_unflatten_like(params, grads),
                                        opt_state, params, donate=True)
        tree_map(lambda p, u: p.add_(u), params, updates)
        del updates
        if clip:
            params = clip_binary_weights(params, inplace=True)
    return params, opt_state


def update_replicas(opt: Optimizer, clip: bool, mesh: Mesh, params,
                    opt_state, grads):
    """`apply_step` once per distinct device of `mesh`, on its replica of
    the placed params and state, from `grads` (leaves on the mesh's first
    device, consumed; copied to the other devices first). Returns the
    placed (params, opt_state)."""
    devices = devices_of(mesh)
    per = {d: grads if i == 0 else [g.to(d, copy=True) for g in grads]
           for i, d in enumerate(devices)}
    new_p, new_s = {}, {}
    for d in devices:
        ix = next(i for i in np.ndindex(*mesh.devices.shape)
                  if mesh.devices[i] == d)
        new_p[d], new_s[d] = apply_step(opt, clip, piece_at(params, ix),
                                        piece_at(opt_state, ix), per.pop(d))
    return gather_pieces(new_p, mesh), gather_pieces(new_s, mesh)


def _grads_of(model: Model) -> Callable:
    """grads_of(masters, leaves, batch, gen, shard=None) -> (loss, metrics,
    the gradient of every leaf, zeros where the loss does not reach it)."""
    needs_gen = model.cfg.quant == "bbp"

    def grads_of(masters, leaves, batch, gen, shard=None):
        loss, metrics = model.loss(masters, batch,
                                   gen=gen if needs_gen else None,
                                   shard=shard)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]
    return grads_of


def piece_at(tree, index: tuple[int, ...]):
    """The tree of the pieces at mesh `index` of a placed tree (leaves
    object ndarrays of the mesh's shape, `launch.shardings.place`)."""
    return tree_map(lambda a: a[index], tree)


def gather_pieces(trees: dict, mesh: Mesh):
    """The placed tree whose pieces at each mesh index are the leaves of
    `trees[that index's device]` (one tree per distinct device)."""
    flat = {d: tree_leaves(t) for d, t in trees.items()}
    first = next(iter(trees.values()))
    out = []
    for j in range(len(flat[next(iter(flat))])):
        arr = np.empty(mesh.devices.shape, dtype=object)
        for index in np.ndindex(*mesh.devices.shape):
            arr[index] = flat[mesh.devices[index]][j]
        out.append(arr)
    return tree_unflatten_like(first, out)


def split_rows(mesh: Mesh, batch: dict, accum: int = 1) -> list[list]:
    """The global batch cut for the data-parallel step: per microbatch
    (rows [i B / accum, (i + 1) B / accum), as the JAX step splits them),
    per batch shard (`launch.shardings.batch_shards`, in batch order), the
    shard's consecutive rows of every leaf on the shard's device. Raises
    ValueError where a microbatch's rows do not divide over the shards."""
    shards = batch_shards(mesh)
    rows = next(iter(batch.values())).shape[0]
    if rows % accum or (rows // accum) % len(shards):
        raise ValueError(f"a global batch of {rows} rows in {accum} "
                         f"microbatches does not split over {len(shards)} "
                         f"batch shards of the mesh {mesh.shape}")
    mb = rows // accum
    b = mb // len(shards)
    return [[{k: v[i * mb + j * b:i * mb + (j + 1) * b]
              .to(mesh.devices[index]) for k, v in batch.items()}
             for j, index in enumerate(shards)] for i in range(accum)]


def _clone(gen: torch.Generator | None, device) -> torch.Generator | None:
    """A generator on `device` at `gen`'s state (None for None)."""
    if gen is None:
        return None
    g = torch.Generator(device=device)
    g.set_state(gen.get_state())
    return g


def _mesh_train_step(model: Model, opt: Optimizer, accum: int,
                     mesh: Mesh) -> Callable:
    """The data-parallel train step over `mesh`: train_step(params,
    opt_state, batch, gen=None) -> (params, opt_state, metrics), params and
    opt_state placed trees replicated over the mesh (every leaf the object
    ndarray `launch.shardings.place(x, mesh, ())` gives: one replica per
    distinct device, which shards on that device share), batch the global
    batch's whole tensors on any device.

    Per microbatch (`split_rows`), each batch shard runs `grads_of` on its
    rows on its own device (the mesh index of its batch axes at 'model'
    0) as a `core.layers.BatchShard`: its draws are its rows of the global
    batch's (each shard draws from its own copy of `gen`, so each draws
    the global sequence), and a MoE model first routes the whole
    microbatch (a forward without gradient on the first shard's device),
    whose routes the shards take (`models.common.moe_ffn`). A shard's loss,
    metrics and gradients are weighted by its share of the microbatch's
    rows (the loss is a mean over tokens, and over rows of equal length);
    the gradients are summed in float32 in shard order on the first
    shard's device (then as the single-device step sums microbatches).
    The sum is copied to each distinct device, where the optimizer's
    update, apply_updates and the clip run once on that device's replica,
    in place. On a one-shard mesh the step is the single-device step bit
    for bit; over more shards it computes its function, the gradients'
    sums taken in another order. `gen` ends where the single-device step
    leaves it."""
    cfg = model.cfg
    grads_of = _grads_of(model)
    shards = batch_shards(mesh)
    dev0 = mesh.devices[shards[0]]
    one = len(shards) == 1
    routes_first = bool(cfg.n_experts) and not one

    def train_step(params, opt_state, batch, gen=None):
        parts = split_rows(mesh, batch, accum)
        b = parts[0][0][next(iter(batch))].shape[0]
        mb, weight = b * len(shards), 1.0 / len(shards)
        gens = [_clone(gen, mesh.devices[ix]) for ix in shards]
        route_gen = _clone(gen, dev0) if routes_first else None
        trees = []
        for ix in shards:
            tree = piece_at(params, ix)
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(tree)]
            trees.append((tree_unflatten_like(tree, leaves), leaves))
        acc, losses, mets = None, [], []
        for i, rows in enumerate(parts):
            routes = {}
            if routes_first:
                whole = {k: torch.cat([r[k].to(dev0) for r in rows])
                         for k in rows[0]}
                with torch.no_grad():
                    model.loss(trees[0][0], whole, gen=route_gen,
                               shard=BatchShard(0, mb, mb, routes, True))
            loss_i, met_i = None, None
            for j, (masters, leaves) in enumerate(trees):
                shard = None if one else BatchShard(j * b, (j + 1) * b, mb,
                                                    routes)
                loss, m, g = grads_of(masters, leaves, rows[j], gens[j],
                                      shard)
                g = [x.to(dev0, torch.float32) for x in g]
                if weight != 1.0:
                    g = [x.mul_(weight) for x in g]
                    loss = loss * weight
                    m = {k: v * weight for k, v in m.items()}
                loss, m = loss.to(dev0), {k: v.to(dev0) for k, v in m.items()}
                if acc is None and accum == 1:
                    acc = g
                else:
                    if acc is None:
                        acc = [torch.zeros_like(x) for x in g]
                    acc = [a.add_(x) for a, x in zip(acc, g)]
                del g
                loss_i = loss if loss_i is None else loss_i + loss
                met_i = m if met_i is None else {
                    k: met_i[k] + v for k, v in m.items()}
            losses.append(loss_i)
            mets.append(met_i)
        del trees
        if accum > 1:
            acc = [a / accum for a in acc]
        loss = losses[0] if accum == 1 else torch.stack(losses).mean()
        metrics = mets[0] if accum == 1 else {
            k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        if gen is not None:
            gen.set_state(gens[0].get_state())
        params, opt_state = update_replicas(opt, cfg.quant != "none", mesh,
                                            params, opt_state, acc)
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
