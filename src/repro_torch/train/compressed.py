"""The EF-SignSGD data-parallel train step (port of
`repro.train.compressed`, the JAX package's shard_map step).

The paper's binarization thesis applied to the gradient all-reduce: each
data shard computes its local gradients and sends sign(g + e) (int8 on the
wire, as the JAX step sums them) and one float32 scale per tensor, and
keeps the residual e on its own device (`optim.ef_signsgd`); the reduction
is a sum of the signs in int32 and a mean of the scales, g_hat = scale_mean
x sign_sum / n. Only the projections' gradients are compressed (leaves of
two or more dims off an `embed` / `lm_head` path): embedding and head
gradients are token-sparse, and biases and norm scales tiny, so those are
averaged in float32. The update is replicated.

As the port's mesh train step (`train.step`), one process drives every
shard over a `launch.mesh.Mesh` whose devices may repeat: params and
optimizer state are placed trees replicated over the mesh
(`launch.shardings.place(x, mesh, ())`), the residuals a placed tree of
(n_shards, *shape) float32 leaves split over `axis` (`init_ef_sharded`:
each shard's piece (1, *shape) on its device, as JAX's P(axis)). Each
shard's loss is its own rows' mean, as the JAX step's local loss, with
no binarization noise (JAX passes key=None) and a MoE routing its own
rows. The Trainer does not use this step, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shardings import place
from repro_torch.models.api import Model
from repro_torch.optim.base import (
    Optimizer, tree_leaves, tree_map, tree_map_with_path,
    tree_unflatten_like,
)
from repro_torch.optim.ef_signsgd import compress_leaf
from repro_torch.train.step import piece_at, update_replicas

_F32 = torch.float32


def compressed_leaf(path: tuple, leaf: torch.Tensor) -> bool:
    """Whether the leaf at `path` is sent as signs: two or more dims, and
    no `embed` / `lm_head` key on its path."""
    return leaf.ndim >= 2 and not {str(k) for k in path} & {"embed",
                                                            "lm_head"}


def init_ef_sharded(params, mesh: Mesh, axis: str = "data"):
    """Per-shard EF residuals: for each leaf of `params` (tensors, or a
    placed tree), zeros (n_shards, *shape) float32 placed over `axis`."""
    n = mesh.shape[axis]

    def one(p):
        p = p.flat[0] if isinstance(p, np.ndarray) else p
        return place(torch.zeros((n,) + tuple(p.shape), dtype=_F32,
                                 device=p.device), mesh, (axis,))
    return tree_map(one, params)


def make_compressed_train_step(model: Model, opt: Optimizer, mesh: Mesh,
                               axis: str = "data") -> Callable:
    """Returns step(params, opt_state, ef_err, batch) -> (params, opt_state,
    ef_err, {"loss"}): batch the global batch's whole tensors, its rows
    split over `axis` (at index 0 of the mesh's other axes); the loss the
    mean of the shards' losses."""
    cfg = model.cfg
    n = mesh.shape[axis]
    where = mesh.axis_names.index(axis)
    shards = [tuple(i if a == where else 0
                    for a in range(len(mesh.axis_names))) for i in range(n)]
    dev0 = mesh.devices[shards[0]]

    def step(params, opt_state, ef_err, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} shards of {axis!r}")
        b = rows // n
        paths: list = []
        tree_map_with_path(lambda path, _: paths.append(path),
                           piece_at(params, shards[0]))
        # the residuals in the params' leaf order
        new_err = tree_map(lambda _, e: e.copy(), params, ef_err)
        sums, loss_sum = None, 0.0
        for i, ix in enumerate(shards):
            dev = mesh.devices[ix]
            tree = piece_at(params, ix)
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(tree)]
            part = {k: v[i * b:(i + 1) * b].to(dev) for k, v in batch.items()}
            loss, _ = model.loss(tree_unflatten_like(tree, leaves), part)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            # per leaf: (int32 signs, scale) sent as signs, else (float32,)
            sent = []
            for path, p, g, e in zip(paths, leaves, grads,
                                     tree_leaves(new_err)):
                g = torch.zeros_like(p) if g is None else g.detach()
                if not compressed_leaf(path, p):
                    sent.append((g.to(dev0, _F32),))
                    continue
                sign, scale, residual = compress_leaf(g, e[ix][0])
                sent.append((sign.to(dev0, torch.int32), scale.to(dev0)))
                for index in np.ndindex(*mesh.devices.shape):
                    if index[where] == i:
                        e[index] = residual[None].to(mesh.devices[index])
            del grads, leaves
            sums = sent if sums is None else [
                tuple(x + y for x, y in zip(a, s)) for a, s in zip(sums, sent)]
            loss_sum = loss_sum + loss.detach().to(dev0)
        ghat = [t[0] / n if len(t) == 1 else (t[1] / n) * t[0].to(_F32) / n
                for t in sums]
        params, opt_state = update_replicas(opt, cfg.quant != "none", mesh,
                                            params, opt_state, ghat)
        return params, opt_state, new_err, {"loss": loss_sum / n}

    return step
