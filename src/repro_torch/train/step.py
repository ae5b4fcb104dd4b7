"""The LM train and eval steps (port of `repro.train.step`).

The train step is Algorithm 1 at LM scale: the gradient of every fp32
master through the binarized forward (the STE; `torch.autograd.grad`), the
optimizer's update (S-AdaMax by default for the binary modes, AdamW for
quant='none'), `apply_updates`, then clip(W) on every binarized
projection weight.

`make_train_step(..., mesh=, specs=)` is the step over a
`launch.mesh.Mesh`: the JAX package's sharded step is GSPMD over its
param shardings, which computes the single-device step's function; the
port computes that function with one process driving every shard, as its
serving mesh does (a device may repeat). The batch axes ('pod', 'data')
split the batch's rows. The params and the optimizer state are placed by
`specs` (`launch.shardings.param_specs`: rows over 'data', ZeRO-3;
columns, rows or experts over 'model'), or replicated where `specs` is
None. Each batch shard's forward gathers a weight only while it uses it
and computes its 'model' parts on the 'model' devices of its row
(`core.layers`); each piece's gradient comes back to it and the batch
shards' are summed there (the reduce-scatter); the optimizer updates each
piece once, on its device. See `_mesh_train_step`. No optimizer path of
the step reaches `optim.base.global_norm` (S-AdaMax, AdaMax, AdamW and SGD
are elementwise), so the update of a piece is the update of its slice of
the whole leaf.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.binarize import clip_weights
from repro_torch.core.layers import BatchShard
from repro_torch.core.placed import (
    Placed, _axes, _slices, slice_key, whole_shape,
)
from repro_torch.launch.mesh import Mesh, batch_axes
from repro_torch.launch.shardings import (
    batch_shards, cache_shardings, devices_of, div_batch_axes,
)
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


def clipped_leaves(params) -> list[bool]:
    """Whether `clip_binary_weights` clips each leaf, in leaf order."""
    out: list[bool] = []

    def walk(node, clip: bool):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, clip or k in _CLIP_KEYS)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, clip)
        elif node is not None:
            out.append(clip)
    walk(params, False)
    return out


# The dry run's hook on work that repeats one shape per unit (a batch
# shard's forward and backward, a device's optimizer update):
# `roofline.count` sets it while it counts a step (it may trace one unit
# and replay the rest); None otherwise, where every unit runs as it is.
repeat_hook = None


def _repeat(kind: str, j, fn: Callable, *args):
    """Unit j's fn(*args) (through `repeat_hook` while counted): a batch
    shard's ("shard", j its number) or a device's ("device", j its
    name)."""
    return fn(*args) if repeat_hook is None else repeat_hook(kind, j, fn,
                                                             args)


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
                    mesh: Mesh | None = None, specs=None) -> Callable:
    """Returns train_step(params, opt_state, batch, gen=None) -> (params,
    opt_state, metrics {nll, [lb_loss], loss}); over `mesh` the step of
    params and state placed by `specs` (a tree of specs matching params,
    `launch.shardings.param_specs`; None: replicated), `_mesh_train_step`.

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
        return _mesh_train_step(model, opt, accum, mesh, specs)
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


def apply_step(opt: Optimizer, clip: bool, params, opt_state, grads,
               clipped: list[bool] | None = None):
    """The optimizer's donated update from `grads` (leaves in params'
    order, consumed), added to params in place, then the clip where
    `clip`: (params, opt_state). `clipped`: which leaves the clip takes
    (default `clipped_leaves(params)`; a flat list of pieces has no keys
    to read)."""
    with torch.no_grad():
        updates, opt_state = opt.update(tree_unflatten_like(params, grads),
                                        opt_state, params, donate=True)
        tree_map(lambda p, u: p.add_(u), params, updates)
        del updates
        if clip:
            flags = clipped_leaves(params) if clipped is None else clipped
            for p, f in zip(tree_leaves(params), flags, strict=True):
                if f:
                    p.clamp_(-1.0, 1.0)
    return params, opt_state


def update_replicas(opt: Optimizer, clip: bool, mesh: Mesh, params,
                    opt_state, grads):
    """`update_placed` of params and state replicated over `mesh` (spec
    ()), from `grads` (leaves in params' order on the mesh's first
    device, consumed)."""
    specs = [()] * len(grads)
    keys = _slice_keys(tree_leaves(params), specs, mesh)
    first = (0,) * mesh.devices.ndim
    return update_placed(opt, clip, mesh, params, opt_state, {
        (i, keys[i][first]): g for i, g in enumerate(grads)}, keys)


def _skeleton(tree):
    return tree_map(lambda _: 0, tree)


def _device_state(state, pskel, pick, one):
    """state's structure with each params-shaped subtree a list,
    pick(its leaves), and every other leaf one(leaf)."""
    if state is None:
        return None
    if _skeleton(state) == pskel:
        return pick(tree_leaves(state))
    if isinstance(state, dict):
        return {k: _device_state(v, pskel, pick, one)
                for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_device_state(v, pskel, pick, one)
                             for v in state))
    if isinstance(state, (list, tuple)):
        return type(state)(_device_state(v, pskel, pick, one)
                           for v in state)
    return one(state)


def _merge(nodes: dict, entries: dict, where: dict, params, mesh: Mesh):
    """The placed tree of per-device trees `nodes` ({device: tree}, one
    structure): a list of the device's distinct pieces (`entries[d]`, the
    skeleton of its flat param list) becomes a params-shaped subtree whose
    arrays hold at each mesh index the entry of the piece params hold
    there (shared where the pieces are); any other leaf is the device's at
    every index of the device (`where[d]`)."""
    first = next(iter(nodes.values()))
    if first is None:
        return None
    if all(_skeleton(n) == [0] * len(entries[d]) for d, n in nodes.items()):
        flat = tree_leaves(params)
        arrays = [np.empty(mesh.devices.shape, dtype=object) for _ in flat]
        for d, lst in nodes.items():
            mine = {id(flat[i][ix]): t for (i, ix), t in zip(entries[d], lst)}
            for i, arr in enumerate(arrays):
                for ix in where[d]:
                    arr[ix] = mine[id(flat[i][ix])]
        return tree_unflatten_like(params, arrays)
    if isinstance(first, dict):
        return {k: _merge({d: n[k] for d, n in nodes.items()}, entries,
                          where, params, mesh) for k in first}
    if isinstance(first, (list, tuple)):
        kids = [_merge({d: n[j] for d, n in nodes.items()}, entries, where,
                       params, mesh) for j in range(len(first))]
        return type(first)(*kids) if hasattr(first, "_fields") \
            else type(first)(kids)
    arr = np.empty(mesh.devices.shape, dtype=object)
    for d, n in nodes.items():
        for ix in where[d]:
            arr[ix] = n
    return arr


def _placement(params, mesh: Mesh):
    """({device: [(leaf i, mesh index)] of the distinct pieces on it, in
    leaf then mesh order (shards on one device may share a piece)},
    {device: its mesh indices})."""
    owned = {d: [] for d in devices_of(mesh)}
    seen = set()
    for i, arr in enumerate(tree_leaves(params)):
        for index in np.ndindex(*mesh.devices.shape):
            if id(arr[index]) not in seen:
                seen.add(id(arr[index]))
                owned[mesh.devices[index]].append((i, index))
    where = {d: [ix for ix in np.ndindex(*mesh.devices.shape)
                 if mesh.devices[ix] == d] for d in owned}
    return owned, where


def update_placed(opt: Optimizer, clip: bool, mesh: Mesh, params, opt_state,
                  grads: dict, keys: list[dict]):
    """The optimizer's update of placed params and state: per distinct
    device, one `apply_step` over the flat list of the distinct pieces it
    holds, each with its slice's gradient (`grads[(leaf i, slice key)]`,
    float32 on the first device holding that slice, consumed; copied to
    the other devices holding it first) and its moments' pieces; the
    counters update once per device. `keys[i]`: leaf i's slice key at
    each mesh index. Returns the placed (params, opt_state), new object
    arrays holding the updated pieces (pieces shared before stay
    shared). The optimizer sees flat lists of pieces: it must update each
    leaf on its own (every optimizer of `optim` does; `chain_weight_clip`'s
    path predicate would see list indices)."""
    flat, pskel = tree_leaves(params), _skeleton(params)
    clipped = clipped_leaves(params)
    owned, where = _placement(params, mesh)
    per = {}                   # every copy is made before any update
    for d, entries in owned.items():
        per[d] = []
        for i, index in entries:
            g = grads[(i, keys[i][index])]
            per[d].append(g if g.device == d else g.to(d, copy=True))
    new_p, new_s = {}, {}
    for d, entries in owned.items():
        ps = [flat[i][ix] for i, ix in entries]
        st = _device_state(opt_state, pskel,
                           lambda ls: [ls[i][ix] for i, ix in entries],
                           lambda a: a[where[d][0]])
        new_p[d], new_s[d] = _repeat("device", str(d), apply_step, opt,
                                     clip, ps, st, per.pop(d),
                                     [clipped[i] for i, _ in entries])
    return (_merge(new_p, owned, where, params, mesh),
            _merge(new_s, owned, where, params, mesh))


def state_shardings(opt_state, params, shardings, replicate):
    """The shardings of an optimizer state: each subtree shaped as params
    (the moments) takes `shardings` (params'), any other leaf (a counter)
    `replicate`."""
    return _device_state(opt_state, _skeleton(params),
                         lambda _: shardings, lambda _: replicate)


def init_placed_state(opt: Optimizer, params, mesh: Mesh):
    """The optimizer's state of placed params, placed as they are: per
    distinct device, `opt.init` of the flat list of the distinct pieces
    it holds (the moments mirror their pieces, shared where the pieces
    are; a counter per device). No whole state is made."""
    owned, where = _placement(params, mesh)
    flat = tree_leaves(params)
    return _merge({d: opt.init([flat[i][ix] for i, ix in e])
                   for d, e in owned.items()}, owned, where, params, mesh)


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


def _slice_keys(flat: list, specs: list, mesh: Mesh) -> list[dict]:
    """Per leaf, {mesh index: the slice it holds} (`launch.shardings.
    slice_key`): equal keys are replicas of one piece."""
    return [{ix: slice_key(whole_shape(a, mesh, sp), mesh, sp, ix)
             for ix in np.ndindex(*mesh.devices.shape)}
            for a, sp in zip(flat, specs)]


def _shard_view(flat: list, specs: list, keys: list[dict], mesh: Mesh,
                row: tuple[int, ...]):
    """The leaves the batch shard at mesh index `row` gives `model.loss`:
    where a spec names a mesh axis of more than one device, a
    `core.placed.Placed` over the pieces the shard reads; else the
    shard's own piece (the whole leaf). Returns (those leaves, the
    autograd leaves (one per distinct piece read), each one's gradient key
    (leaf i, slice key))."""
    out, leaves, grad_keys = [], [], []
    for i, (arr, spec) in enumerate(zip(flat, specs)):
        if all(mesh.shape.get(a, 1) == 1 for e in spec for a in _axes(e)):
            t = arr[row].detach().requires_grad_(True)
            out.append(t)
            leaves.append(t)
            grad_keys.append((i, keys[i][row]))
            continue
        handle = Placed.of(arr, mesh, spec, row)
        pieces, mine = np.empty(arr.shape, dtype=object), {}
        for ix in handle.order:
            src = arr[ix]
            if id(src) not in mine:
                mine[id(src)] = src.detach().requires_grad_(True)
                leaves.append(mine[id(src)])
                grad_keys.append((i, keys[i][ix]))
            pieces[ix] = mine[id(src)]
        out.append(Placed(pieces, mesh, handle.spec, row))
    return out, leaves, grad_keys


def _mesh_train_step(model: Model, opt: Optimizer, accum: int,
                     mesh: Mesh, specs) -> Callable:
    """The train step over `mesh`: train_step(params, opt_state, batch,
    gen=None) -> (params, opt_state, metrics), params and opt_state placed
    trees (every leaf the object ndarray `launch.shardings.place` gives:
    the params by `specs`, or replicated where it is None; the state's
    moments as their params, its counters replicated: `Trainer`,
    `init_placed_state`), batch the global batch's whole tensors on any
    device.

    Per microbatch (`split_rows`), each batch shard runs `grads_of` on its
    rows on its own device (the mesh index of its batch axes at 'model'
    0) as a `core.layers.BatchShard`, over its view of the params
    (`_shard_view`): a placed master is gathered by the ops that use it
    and its 'model' parts run on the row's 'model' devices; a replicated
    one is the shard's replica. Its draws are its rows of the global
    batch's (each shard draws from its own copy of `gen`, so each draws
    the global sequence; a weight's draw is its whole shape), and a MoE
    model first routes the whole microbatch (a forward without gradient
    on the first shard's device), whose routes the shards take
    (`models.common.moe_ffn`). A shard's loss, metrics and gradients are
    weighted by its share of the microbatch's rows (the loss is a mean
    over tokens, and over rows of equal length); each piece's gradient is
    summed in float32 in shard order on the first device that holds its
    slice (the reduce-scatter; then as the single-device step sums
    microbatches). `update_placed` updates each distinct piece once, on
    its device, in place. On a one-shard mesh the step is the
    single-device step bit for bit, and on a mesh whose 'model' axis is 1
    the placed step is the replicated one bit for bit (a gather is a copy,
    a piece's gradient a slice of the shard's, the sums in one order);
    over more shards it computes its function, the gradients' sums (and
    over 'model' the split products') taken in another order. `gen` ends
    where the single-device step leaves it."""
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
        flat = tree_leaves(params)
        sp = [()] * len(flat) if specs is None else _spec_leaves(params,
                                                                 specs)
        keys = _slice_keys(flat, sp, mesh)
        home = {}
        for i, by_ix in enumerate(keys):
            for ix, key in by_ix.items():
                home.setdefault((i, key), mesh.devices[ix])
        views: dict = {}

        def view(j):
            """Batch shard j's view (`_shard_view`), made at its first use
            and kept for the step."""
            if j not in views:
                out, leaves, gkeys = _shard_view(flat, sp, keys, mesh,
                                                 shards[j])
                views[j] = (tree_unflatten_like(params, out), leaves, gkeys)
            return views[j]

        def sum_into(acc, key, x):
            x = x.to(home[key], torch.float32)
            if weight != 1.0:
                x = x.mul_(weight)
            if key not in acc and accum == 1:
                acc[key] = x
            else:
                if key not in acc:
                    acc[key] = torch.zeros_like(x)
                acc[key] = acc[key].add_(x)

        def shard_unit(j, rows_j, gen_j, shard, acc):
            """Batch shard j's loss and metrics (weighted), its weighted
            gradients summed into `acc` where they lie on their piece's
            home device, and the others' (key, gradient) to be summed
            there. Each key's sum runs in shard order either way."""
            masters, leaves, gkeys = view(j)
            loss, m, g = grads_of(masters, leaves, rows_j, gen_j, shard)
            if weight != 1.0:
                loss = loss * weight
                m = {k: v * weight for k, v in m.items()}
            rest = []
            for key, x in zip(gkeys, g):
                if x.device == home[key]:
                    sum_into(acc, key, x)
                else:
                    rest.append((key, x))
            del g
            return loss, m, rest

        acc, losses, mets = {}, [], []
        for i, rows in enumerate(parts):
            routes = {}
            if routes_first:
                whole = {k: torch.cat([r[k].to(dev0) for r in rows])
                         for k in rows[0]}
                with torch.no_grad():
                    model.loss(view(0)[0], whole, gen=route_gen,
                               shard=BatchShard(0, mb, mb, routes, True))
            loss_i, met_i = None, None
            for j in range(len(shards)):
                shard = None if one else BatchShard(j * b, (j + 1) * b, mb,
                                                    routes)
                loss, m, rest = _repeat("shard", j, shard_unit, j, rows[j],
                                        gens[j], shard, acc)
                for key, x in rest:
                    sum_into(acc, key, x)
                del rest
                loss, m = loss.to(dev0), {k: v.to(dev0) for k, v in m.items()}
                loss_i = loss if loss_i is None else loss_i + loss
                met_i = m if met_i is None else {
                    k: met_i[k] + v for k, v in m.items()}
            losses.append(loss_i)
            mets.append(met_i)
        views.clear()
        if accum > 1:
            acc = {k: a / accum for k, a in acc.items()}
        loss = losses[0] if accum == 1 else torch.stack(losses).mean()
        metrics = mets[0] if accum == 1 else {
            k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        if gen is not None:
            gen.set_state(gens[0].get_state())
        params, opt_state = update_placed(opt, cfg.quant != "none", mesh,
                                          params, opt_state, acc, keys)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def _spec_leaves(params, specs) -> list[tuple]:
    """Each leaf's spec, in params' leaf order (a spec is a tuple: walked
    along params, not flattened)."""
    out: list = []
    tree_map(lambda _, sp: out.append(tuple(sp)), params, specs)
    return out


def _prefill_kw(model: Model, batch: dict, max_len: int | None) -> dict:
    kw: dict = {}
    if model.cfg.family == "vlm":
        kw["img_emb"] = batch["img_emb"]
    if model.cfg.family in ("dense", "moe", "audio", "vlm") and max_len:
        kw["max_len"] = max_len
    return kw


def make_prefill_step(model: Model, max_len: int | None = None, *,
                      mesh: Mesh | None = None, specs=None) -> Callable:
    """prefill_step(params, batch {"tokens" (B, S), vlm "img_emb"}) ->
    (logits (B, V) at the last position, the new cache of max_len
    positions (attention families; default S)), no gradient: the JAX
    package's `make_prefill_step`. Over `mesh`, params placed by `specs`
    (None: replicated) and the cache returned placed by
    `launch.shardings.cache_shardings` (`_mesh_infer_step`)."""
    if mesh is not None:
        return _mesh_infer_step(model, mesh, specs, max_len, prefill=True)

    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch["tokens"],
                                 **_prefill_kw(model, batch, max_len))
    return prefill_step


def make_decode_step(model: Model, *, mesh: Mesh | None = None,
                     specs=None) -> Callable:
    """decode_step(params, token (B,), cache, pos (B,)) -> (logits (B, V),
    the cache, updated in place), no gradient: the JAX package's
    `make_decode_step`. Over `mesh`, params placed by `specs` and the
    cache placed by `launch.shardings.cache_shardings`
    (`_mesh_infer_step`)."""
    if mesh is not None:
        return _mesh_infer_step(model, mesh, specs, None, prefill=False)

    def decode_step(params, token, cache, pos):
        with torch.no_grad():
            return model.decode(params, token, cache, pos)
    return decode_step


def _row_shards(mesh: Mesh, b: int) -> list[tuple[int, ...]]:
    """The batch shards of an inference batch of b rows: the mesh indices
    of the batch axes that divide b (`div_batch_axes`) row-major, 0 on
    every other axis (one shard where none divides)."""
    axes = div_batch_axes(mesh, b)
    at = [i for i, a in enumerate(mesh.axis_names) if a in axes]
    out = []
    for sub in np.ndindex(*[mesh.devices.shape[i] for i in at]):
        index = [0] * mesh.devices.ndim
        for i, j in zip(at, sub):
            index[i] = j
        out.append(tuple(index))
    return out


def _row_spec(mesh: Mesh, spec: tuple) -> tuple:
    """A spec with the batch axes taken out: how one batch shard's rows
    are cut over the other axes."""
    drop = set(batch_axes(mesh))
    out = []
    for e in spec:
        keep = tuple(a for a in _axes(e) if a not in drop)
        out.append(None if not keep else keep[0] if len(keep) == 1 else keep)
    return tuple(out)


def _infer_view(flat: list, specs: list, mesh: Mesh, row: tuple[int, ...]):
    """The leaves the batch shard at `row` gives the model at inference:
    `_shard_view`'s, over the pieces themselves (no gradient)."""
    return [arr[row] if all(mesh.shape.get(a, 1) == 1
                            for e in spec for a in _axes(e))
            else Placed.of(arr, mesh, spec, row)
            for arr, spec in zip(flat, specs)]


def _place_rows(mesh: Mesh, shards: list, caches: list[dict], family: str,
                b: int) -> dict:
    """The placed cache (per leaf an object ndarray of the mesh's shape)
    of the shards' caches, each its rows' whole cache on its row's
    device: each mesh index holds its shard's rows cut as
    `cache_shardings` cuts them over the other axes, a copy on its device
    (shared by the indices of one device and slice)."""
    specs = cache_shardings(mesh, caches[0], family, b)
    kept = [i for i, a in enumerate(mesh.axis_names)
            if a in div_batch_axes(mesh, b)]
    owner = {tuple(r[i] for i in kept): j for j, r in enumerate(shards)}
    out = {}
    for name in caches[0]:
        spec = _row_spec(mesh, specs[name].spec)
        arr = np.empty(mesh.devices.shape, dtype=object)
        memo: dict = {}
        for index in np.ndindex(*mesh.devices.shape):
            j = owner[tuple(index[i] for i in kept)]
            x = caches[j][name]
            cut = _slices(x.shape, mesh, spec, index)
            key = (j, mesh.devices[index], slice_key(x.shape, mesh, spec,
                                                     index))
            if key not in memo:
                memo[key] = x[cut].to(mesh.devices[index], copy=True) \
                    .contiguous()
            arr[index] = memo[key]
        out[name] = arr
    return out


def _gather_rows(mesh: Mesh, cache: dict, row: tuple[int, ...], family: str,
                 b: int, whole: bool = False) -> dict:
    """One batch shard's cache (its rows, every other axis joined) on its
    row's device from a placed cache, or with `whole` every row of it."""
    specs = cache_shardings(mesh, {k: a.flat[0] for k, a in cache.items()},
                            family, b)
    out = {}
    for name, arr in cache.items():
        spec = specs[name].spec if whole else _row_spec(mesh,
                                                        specs[name].spec)
        out[name] = Placed.of(arr, mesh, spec, row).gather()
    return out


def _put_rows(mesh: Mesh, cache: dict, rows: dict, row: tuple[int, ...],
              family: str, b: int) -> None:
    """Write one batch shard's updated cache back into the placed cache's
    pieces (a piece that is the shard's own tensor is already written)."""
    specs = cache_shardings(mesh, {k: a.flat[0] for k, a in cache.items()},
                            family, b)
    for name, arr in cache.items():
        spec = _row_spec(mesh, specs[name].spec)
        handle = Placed.of(arr, mesh, spec, row)
        lay = handle.layout()
        for k, cut in zip(lay.take, lay.cuts):
            piece = handle.pieces[handle.order[k]]
            if piece is not rows[name]:
                piece.copy_(rows[name][cut])


def _on_device(tree, device):
    """A MoE routes dict with every tensor moved to `device`."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


def _mesh_infer_step(model: Model, mesh: Mesh, specs, max_len: int | None,
                     prefill: bool) -> Callable:
    """The prefill (decode) step over `mesh`, as the JAX package's dry run
    places it: params placed by `specs` (`param_specs`; None replicated),
    the cache by `cache_shardings`, the batch's rows over the batch axes
    that divide it (`_row_shards`). Each batch shard runs its rows, in
    turn, through `model.prefill` (`model.decode`) on its row's device
    over the same `core.placed.Placed` handles the train step gives its
    shards, without gradient: a weight gathered per use, its 'model'
    parts computed on the row's 'model' devices (`core.layers`). A decode
    shard joins its rows' cache pieces on its device and writes them
    back after the step. A MoE model first runs the whole batch on the
    first shard's device, whose routes the shards take
    (`models.common.moe_ffn`), each on its own device. Logits are
    concatenated on the first shard's device; the prefill's cache comes
    back placed (`_place_rows`). On a mesh whose 'model' axis is 1 the
    outputs are the single-device step's bit for bit (a gather is a copy);
    over 'model' the split products sum in another order."""
    cfg = model.cfg
    moe = bool(cfg.n_experts)

    def shards_of(params, b):
        shards = _row_shards(mesh, b)
        flat = tree_leaves(params)
        sp = [()] * len(flat) if specs is None else _spec_leaves(params,
                                                                 specs)
        views = [tree_unflatten_like(params, _infer_view(flat, sp, mesh, ix))
                 for ix in shards]
        return shards, views

    def run(shards, views, fn, parts, whole):
        """Each shard's fn(view, rows, batch shard) in turn (the MoE
        routing run first on the whole batch)."""
        n, b = len(shards), next(iter(parts[0].values())).shape[0]
        routes: dict = {}
        if moe and n > 1:
            fn(views[0], whole, BatchShard(0, n * b, n * b, routes, True))
        outs = []
        for j, (ix, view, rows) in enumerate(zip(shards, views, parts)):
            sh = None
            if moe and n > 1:
                sh = BatchShard(j * b, (j + 1) * b, n * b,
                                _on_device(routes, mesh.devices[ix]))
            outs.append(_repeat("shard", j, fn, view, rows, sh))
        return outs

    def cut(batch, shards):
        n = len(shards)
        return [{k: v[j * (v.shape[0] // n):(j + 1) * (v.shape[0] // n)]
                 .to(mesh.devices[ix]) for k, v in batch.items()}
                for j, ix in enumerate(shards)]

    def prefill_step(params, batch):
        b = batch["tokens"].shape[0]
        shards, views = shards_of(params, b)
        dev0 = mesh.devices[shards[0]]

        def one(view, rows, sh):
            kw = _prefill_kw(model, rows, max_len)
            if sh is not None:
                kw["shard"] = sh
            return model.prefill(view, rows["tokens"], **kw)
        with torch.no_grad():
            outs = run(shards, views, one, cut(batch, shards),
                       {k: v.to(dev0) for k, v in batch.items()})
            logits = torch.cat([lg.to(dev0) for lg, _ in outs])
            cache = _place_rows(mesh, shards, [c for _, c in outs],
                                cfg.family, b)
        return logits, cache

    def decode_step(params, token, cache, pos):
        b = token.shape[0]
        shards, views = shards_of(params, b)
        dev0 = mesh.devices[shards[0]]
        parts = cut({"token": token, "pos": pos}, shards)

        def one(view, rows, sh):
            kw = {} if sh is None else {"shard": sh}
            c = rows["cache"] if "cache" in rows else _gather_rows(
                mesh, cache, rows["row"], cfg.family, b)
            logits, c = model.decode(view, rows["token"], c, rows["pos"],
                                     **kw)
            if "cache" not in rows:
                _put_rows(mesh, cache, c, rows["row"], cfg.family, b)
            return logits
        for rows, ix in zip(parts, shards):
            rows["row"] = ix
        whole = {"token": token.to(dev0), "pos": pos.to(dev0),
                 "cache": None}
        with torch.no_grad():
            if moe and len(shards) > 1:
                whole["cache"] = _gather_rows(mesh, cache, shards[0],
                                              cfg.family, b, whole=True)
            outs = run(shards, views, one, parts, whole)
            del whole
            logits = torch.cat([lg.to(dev0) for lg in outs])
        return logits, cache

    return prefill_step if prefill else decode_step


def make_eval_step(model: Model) -> Callable:
    """eval_step(params, batch) -> metrics {nll, [lb_loss], loss} of the
    training loss, deterministic binarization, no gradient."""
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch)
        return dict(metrics, loss=loss)
    return eval_step
