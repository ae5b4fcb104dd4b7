"""Parameter / batch / cache sharding specs and placement on a `Mesh`
(port of `repro.launch.shardings`).

A spec is a tuple with one entry per leading dim of a tensor, as a JAX
`PartitionSpec` iterates: None (replicated), an axis name, or a tuple of
two or more axis names (split over their product, row-major); dims past
the tuple replicate. `()` replicates the whole tensor.

Scheme (the JAX package's, DESIGN.md §5): 2-D "FSDP x TP" --
  * weight matrices: rows over 'data' (ZeRO-3 gather), cols over 'model'
    (Megatron) -- or the transpose for row-parallel (contracting) matrices;
  * embeddings vocab-parallel over 'model', FSDP over 'data';
  * MoE expert stacks: experts over 'model' (EP), FSDP over 'data';
  * small vectors (biases, norms, gates) replicated.

Rules match the leaf's path in the param tree ("blocks/attn/wq", the JAX
package's path strings), most-specific first; a leading scan axis is
padded with None. A frozen `PackedWeight` gets the specs of its children
in the JAX package's pytree order (packed words, thresh, flip; None for a
child it lacks), each matched as the path plus "/0", "/1", "/2".

`place` cuts a tensor into its per-shard pieces by a spec and puts each on
its shard's device; `join` puts the pieces back together. A spec that does
not divide a dim raises ValueError, as JAX's `device_put` and `jit(...,
out_shardings=)` do for such a `NamedSharding`.
The slicing itself (`_slices`) and the train step's handle on a placed
master (`Placed`) live in `core.placed`, which the model's ops import.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.packed import PackedWeight
from repro_torch.core.placed import _axes, _slices
from repro_torch.launch.mesh import Mesh, batch_axes
from repro_torch.optim.base import tree_leaves, tree_map, tree_map_with_path

# (regex on path, spec for the *trailing* dims of the leaf)
_RULES: list[tuple[str, tuple | None]] = [
    # --- embeddings / head ---
    (r"\bembed\b", ("model", "data")),
    (r"\blm_head\b", ("data", "model")),
    # --- attention (column-parallel in, row-parallel out) ---
    (r"attn.*\bwq\b|\bwq\b", ("data", "model")),
    (r"\bwk\b", ("data", "model")),
    (r"\bwv\b", ("data", "model")),
    (r"\bwo\b", ("model", "data")),
    (r"\bbq\b|\bbk\b|\bbv\b", ("model",)),
    # --- MoE ---
    (r"experts.*w_gate", ("model", "data", None)),
    (r"experts.*w_up", ("model", "data", None)),
    (r"experts.*w_down", ("model", None, "data")),
    (r"\brouter\b", (None, None)),
    # --- dense FFN ---
    (r"\bw_gate\b", ("data", "model")),
    (r"\bw_up\b", ("data", "model")),
    (r"\bw_down\b", ("model", "data")),
    # --- mamba ---
    (r"\bin_proj\b", ("data", "model")),
    (r"\bconv_w\b", (None, "model")),
    (r"\bconv_b\b", ("model",)),
    (r"\bx_proj\b", ("model", None)),
    (r"\bdt_w\b", (None, "model")),
    (r"\bdt_b\b", ("model",)),
    (r"\bA_log\b", ("model", None)),
    (r"\bD\b", ("model",)),
    (r"\bout_proj\b", ("model", "data")),
    # --- RG-LRU ---
    (r"\bw_x\b", ("data", "model")),
    (r"\bw_input_gate\b|\bw_rec_gate\b", ("model", None)),
    (r"\bb_input_gate\b|\bb_rec_gate\b|\blam\b", (None,)),
    (r"\bw_out\b", ("model", "data")),
    # --- catch-alls ---
    (r"\bscale\b|\bbias\b|\bgate\b|\bb\b", None),   # replicate small leaves
]


def _path_str(path) -> str:
    return path if isinstance(path, str) else "/".join(str(k) for k in path)


def _spec(path: str, ndim: int) -> tuple:
    for pat, trailing in _RULES:
        if re.search(pat, path):
            if trailing is None:
                return ()
            pad = ndim - len(trailing)
            if pad < 0:      # leaf smaller than the rule
                return ()
            return (None,) * pad + tuple(trailing)
    return ()                # default: replicate


def spec_for(path, leaf) -> tuple | None:
    """The spec of one param leaf at `path` (a key tuple or a string); a
    PackedWeight's is the tuple of its children's (module docstring)."""
    s = _path_str(path)
    if isinstance(leaf, PackedWeight):
        kids = (leaf.packed, leaf.thresh, leaf.flip)
        return tuple(None if t is None else _spec(f"{s}/{i}", t.ndim)
                     for i, t in enumerate(kids))
    if leaf is None:
        return None
    return _spec(s, leaf.ndim)


def param_specs(params) -> Any:
    """The tree of specs matching `params` (meta tensors work too)."""
    return tree_map_with_path(spec_for, params)


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (a JAX `NamedSharding`)."""
    mesh: Mesh
    spec: tuple


def param_shardings(mesh: Mesh, params) -> Any:
    return tree_map_with_path(
        lambda path, leaf: Sharding(mesh, spec_for(path, leaf)), params)


def _entry(axes: tuple[str, ...]):
    """A spec entry over `axes`, as a PartitionSpec normalizes it."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def batch_spec(mesh: Mesh) -> tuple:
    return (_entry(batch_axes(mesh)),)


def div_batch_axes(mesh: Mesh, b: int) -> tuple[str, ...]:
    """Batch axes usable for a global batch of size b (drop axes until the
    product divides b -- a batch of 1 must replicate)."""
    axes = list(batch_axes(mesh))
    while axes:
        if b % math.prod(mesh.shape[a] for a in axes) == 0:
            return tuple(axes)
        axes.pop(0)
    return ()


def batch_shardings(mesh: Mesh, batch) -> Any:
    """Shard the leading (batch) dim of every batch leaf."""
    ax = _entry(batch_axes(mesh))
    return tree_map(lambda x: Sharding(mesh, (ax,) + (None,) * (x.ndim - 1)),
                    batch)


def cache_shardings(mesh: Mesh, cache: dict, family: str,
                    global_batch: int | None = None) -> dict:
    """KV caches / SSM states (the port's flat cache dicts, the JAX
    package's leaf names): the batch dim over the data axes, the head (or
    channel) dim over 'model'. Layouts:
      transformer: (L, B, T, kv, hd)   [+ vlm group variants]
      mamba:  conv (L, B, K-1, di) / h (L, B, di, N)
      rg: rec_conv (G, R, B, K-1, W), rec_h (G, R, B, W), attn_k (G, B, W,
          kv, hd)
    Paged pools (no batch axis: every slot reaches every page) replicate,
    splitting only a float pool's head_dim; the page table shards its slot
    rows; packed int32 word axes never split. Returns {name: Sharding}."""
    ba = _entry(batch_axes(mesh) if global_batch is None
                else div_batch_axes(mesh, global_batch))
    paged = "page_table" in cache
    attn = family in ("dense", "moe", "audio", "vlm")

    def one(name: str, leaf) -> tuple:
        nd = leaf.ndim
        spec: list = [None] * nd
        if name.endswith("scale"):
            # per-head V scales (..., B, kv): shard batch, replicate heads
            spec[-2] = ba
            return tuple(spec)
        if name.endswith("page_table"):
            return (ba, None)                      # (B, n_pages)
        packed = leaf.dtype == torch.int32
        if attn and paged and name in ("k", "v"):
            if not packed:                         # pool (..., P, ps, kv, hd)
                spec[-1] = "model"
            return tuple(spec)
        if attn:
            spec[-4] = ba                          # (..., B, T, kv, hd)
            if not packed:
                spec[-1] = "model"
            return tuple(spec)
        if family == "ssm":
            spec[-3] = ba
            spec[-1 if name.endswith("conv") else -2] = "model"
            return tuple(spec)
        if family == "hybrid":
            if "attn" in name:                     # (G, B, W, kv, hd|words)
                spec[-4] = ba
                if not packed:
                    spec[-1] = "model"
            elif "conv" in name:                   # (..., B, K-1, W)
                spec[-3] = ba
                spec[-1] = "model"
            else:                                  # h (..., B, W)
                spec[-2] = ba
                spec[-1] = "model"
            return tuple(spec)
        return ()

    return {name: Sharding(mesh, one(name, leaf))
            for name, leaf in cache.items()}


# -- placement --------------------------------------------------------------
def place(x: torch.Tensor, mesh: Mesh, spec: tuple) -> np.ndarray:
    """x cut by `spec`: an object ndarray of the mesh's shape holding each
    shard's piece, contiguous on its shard's device. A piece is moved to a
    device once: shards on one device that hold the same slice share one
    tensor (on a device x already lies on, a replicated piece is x
    itself), so a mesh that repeats a device holds one replica there, as
    a JAX array is one buffer per device."""
    out = np.empty(mesh.devices.shape, dtype=object)
    memo: dict = {}
    for index in np.ndindex(*mesh.devices.shape):
        cut = _slices(x.shape, mesh, spec, index)
        key = (mesh.devices[index], tuple((c.start, c.stop) for c in cut))
        if key not in memo:
            memo[key] = x[cut].to(mesh.devices[index]).contiguous()
        out[index] = memo[key]
    return out


def join(pieces: np.ndarray, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """The tensor whose `place` gives `pieces` (replicated copies taken
    from the first shard holding them), on the first piece's device."""
    first = pieces.flat[0]
    shape = [n * math.prod(mesh.shape[a] for a in _axes(spec[d]))
             if d < len(spec) else n for d, n in enumerate(first.shape)]
    out = torch.empty(shape, dtype=first.dtype, device=first.device)
    used = {a for e in spec for a in _axes(e)}
    for index in np.ndindex(*mesh.devices.shape):
        if any(i and a not in used for a, i in zip(mesh.axis_names, index)):
            continue                       # a replica of a piece already in
        out[_slices(shape, mesh, spec, index)] = pieces[index]
    return out


# -- trees ------------------------------------------------------------------
def _words_spec(sh: Sharding, w: PackedWeight) -> tuple:
    """The spec of a PackedWeight's words: the Sharding's spec, or the
    first of its children's specs where the Sharding is param_shardings'
    (the tuple `spec_for` gives a PackedWeight)."""
    sp = sh.spec
    kids = (len(sp) == 3 and isinstance(sp[0], tuple)
            and len(sp[0]) == w.packed.ndim
            and all(k is None or isinstance(k, tuple) for k in sp[1:]))
    return sp[0] if kids else sp


def place_leaf(x, sh: Sharding | None):
    """`place` of one tree leaf: a tensor by its spec; a PackedWeight's
    words by its words' spec (`_words_spec`), its threshold and flip
    replicated, as the JAX package's restore puts them (an object ndarray
    of PackedWeights); None (no sharding) gives the leaf back."""
    if sh is None:
        return x
    if not isinstance(x, PackedWeight):
        return place(x, sh.mesh, sh.spec)
    words = place(x.packed, sh.mesh, _words_spec(sh, x))
    rep = [None if t is None else place(t, sh.mesh, ())
           for t in (x.thresh, x.flip)]
    out = np.empty(words.shape, dtype=object)
    for index in np.ndindex(*words.shape):
        t, f = (None if r is None else r[index] for r in rep)
        out[index] = PackedWeight(words[index], x.k, x.kind, x.conv_shape,
                                  x.orig_dtype, thresh=t, flip=f, fold=x.fold)
    return out


def join_leaf(pieces, sh: Sharding | None):
    """The leaf whose `place_leaf` gives `pieces` (a leaf that is not an
    object ndarray is returned as it is)."""
    if sh is None or not isinstance(pieces, np.ndarray):
        return pieces
    first = pieces.flat[0]
    if not isinstance(first, PackedWeight):
        return join(pieces, sh.mesh, sh.spec)
    words = np.empty(pieces.shape, dtype=object)
    for index in np.ndindex(*pieces.shape):
        words[index] = pieces[index].packed
    return PackedWeight(join(words, sh.mesh, _words_spec(sh, first)),
                        first.k, first.kind, first.conv_shape,
                        first.orig_dtype, thresh=first.thresh,
                        flip=first.flip, fold=first.fold)


def replicated(mesh: Mesh, tree) -> Any:
    """The tree of Shardings that replicate every leaf of `tree` over
    `mesh` (spec ())."""
    return tree_map(lambda _: Sharding(mesh, ()), tree)


def devices_of(mesh: Mesh) -> list[torch.device]:
    """The mesh's distinct devices, in mesh order."""
    return list(dict.fromkeys(mesh.devices.flat))


def batch_shards(mesh: Mesh) -> list[tuple[int, ...]]:
    """The mesh index of each batch shard in batch order: the batch axes'
    indices row-major in mesh axis order (as a spec entry ('pod', 'data')
    splits rows), at index 0 of every other axis."""
    axes = mesh.axis_names
    ba = [i for i, a in enumerate(axes) if a in batch_axes(mesh)]
    sizes = [mesh.devices.shape[i] for i in ba]
    out = []
    for sub in np.ndindex(*sizes):
        index = [0] * len(axes)
        for i, j in zip(ba, sub):
            index[i] = j
        out.append(tuple(index))
    return out


def resident_bytes(tree, mesh: Mesh) -> dict:
    """{shard name: bytes of the pieces it holds} of a placed tree (every
    leaf an object ndarray of the mesh's shape); shards on one device that
    share a piece count it each."""
    out = {}
    for index in np.ndindex(*mesh.devices.shape):
        out[mesh.shard_name(index)] = sum(
            a[index].numel() * a[index].element_size()
            for a in tree_leaves(tree))
    return out
