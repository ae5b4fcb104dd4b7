"""A master placed over a mesh: the slice of each dim a shard holds, and one
batch shard's handle on the pieces (the train step's, `train.step`).

A spec is a tuple with one entry per leading dim (`launch.shardings`): None,
an axis name, or a tuple of axis names split over their product row-major.
A dim that does not divide over its shards raises ValueError, as JAX's
`NamedSharding` does.

`Placed` is one batch shard's handle on a master placed by its spec: the
model's ops take it where they take a master tensor. `gather` joins its
pieces over the axes the spec names onto a compute device as an autograd
node, whose backward hands each piece its slice of the gradient on the
piece's device (ZeRO-3's gather; the weight is gathered per use and never
kept). With `model=m` it gathers only the pieces of 'model' index m, onto
that 'model' device: the slice a tensor-parallel matmul computes there
(`core.layers`). The mesh is a `launch.mesh.Mesh`; this module reads only
its `shape`, `axis_names` and `devices`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.roofline.count import charge_copies, counting


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _slices(shape, mesh, spec: tuple, index: tuple[int, ...]):
    """The slice of each dim that the shard at mesh `index` holds."""
    out = []
    for dim, size in enumerate(shape):
        names = _axes(spec[dim]) if dim < len(spec) else ()
        parts, rank = 1, 0
        for name in names:
            if name not in mesh.axis_names:
                raise ValueError(f"axis {name!r} is not one of the mesh's "
                                 f"{mesh.axis_names}")
            n = mesh.shape[name]
            parts, rank = parts * n, rank * n + index[
                mesh.axis_names.index(name)]
        if size % parts:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {parts} shards ({names})")
        local = size // parts
        out.append(slice(rank * local, (rank + 1) * local))
    return tuple(out)


def whole_shape(pieces: np.ndarray, mesh, spec: tuple) -> tuple:
    """The shape of the tensor whose `place` by `spec` gives `pieces`."""
    first = next(p for p in pieces.flat if p is not None)
    return tuple(n * math.prod(mesh.shape[a] for a in _axes(spec[d]))
                 if d < len(spec) else n for d, n in enumerate(first.shape))


def slice_key(shape, mesh, spec: tuple, index: tuple[int, ...]):
    """The piece at mesh `index` as (start, stop) per dim: equal for the
    shards that hold the same slice (replicas)."""
    return tuple((c.start, c.stop) for c in _slices(shape, mesh, spec, index))


# -- placed masters: one shard's handle, the gather -------------------------
@dataclass(frozen=True)
class Layout:
    """One gather of a Placed: the pieces it joins (indices into the
    Placed's `order`) and each one's slice of the output, the output's
    shape (the stored orientation) and device."""
    take: tuple[int, ...]
    cuts: tuple[tuple[slice, ...], ...]
    shape: tuple[int, ...]
    device: torch.device


def join_pieces(lay: Layout, pieces) -> torch.Tensor:
    """The gathered tensor of `lay` from the Placed's pieces (its order).
    Inside the dry run's count (`roofline.count`) each piece's copy is
    charged as its copy op would be, not dispatched."""
    chosen = [pieces[k] for k in lay.take]
    if len(chosen) == 1 and chosen[0].device == lay.device:
        return chosen[0]
    out = torch.empty(lay.shape, dtype=chosen[0].dtype, device=lay.device)
    if counting(lay.device):
        charge_copies([(p, lay.device, p.numel() * p.element_size())
                       for p in chosen], "gather")
        return out
    for cut, p in zip(lay.cuts, chosen):
        out[cut] = p
    return out


def split_grad(lay: Layout, g: torch.Tensor, devices: list) -> dict:
    """{piece index: its slice of g (the gathered gradient), on its
    device (`devices`, by piece index)}. Inside the dry run's count the
    copy of each slice to another device is charged, not dispatched
    (`join_pieces`)."""
    if counting(g.device):
        out = {}
        for k, cut in zip(lay.take, lay.cuts):
            if devices[k] == g.device:
                out[k] = g[cut].contiguous()
                continue
            shape = [len(range(*c.indices(n))) for c, n in zip(cut, g.shape)]
            out[k] = torch.empty(shape + list(g.shape[len(cut):]),
                                 dtype=g.dtype, device=devices[k])
            charge_copies([(g, devices[k],
                            out[k].numel() * out[k].element_size())],
                          "reduce")
        return out
    return {k: g[cut].to(devices[k]).contiguous()
            for k, cut in zip(lay.take, lay.cuts)}


class _Gather(torch.autograd.Function):
    """The pieces of a Layout joined (a new tensor: `Placed.gather` takes a
    lone piece on the device as it is); the backward hands each piece its
    slice of the gradient, on its device."""

    @staticmethod
    def forward(ctx, lay: Layout, *pieces):
        ctx.lay, ctx.devices = lay, [p.device for p in pieces]
        return join_pieces(lay, pieces)

    @staticmethod
    def backward(ctx, g):
        grads = [None] * len(ctx.devices)
        for k, t in split_grad(ctx.lay, g, ctx.devices).items():
            grads[k] = t
        return (None, *grads)


@dataclass(frozen=True, eq=False)
class Placed:
    """One batch shard's handle on a master placed by `spec` over `mesh`:
    `pieces` the object ndarray of the mesh's shape holding the pieces this
    shard reads (None elsewhere), `row` the shard's mesh index ('model'
    0), `spec` one entry per dim. `transposed`: a 2-D master seen as its
    transpose (the tied head). A layer axis (an entry None) is never cut,
    so `unbind(0)` and `[i]` give the layers' handles; `shape`, `ndim` and
    `device` (the row's) are the whole master's, as the consumer sees
    it."""
    pieces: np.ndarray
    mesh: Any
    spec: tuple
    row: tuple[int, ...]
    transposed: bool = False

    @classmethod
    def of(cls, pieces: np.ndarray, mesh, spec: tuple,
           row: tuple[int, ...]) -> "Placed":
        """The handle of the batch shard at `row` on a placed leaf: the
        pieces at every mesh index that agrees with `row` on each axis the
        spec does not name."""
        ndim = pieces.flat[0].ndim
        spec = tuple(spec) + (None,) * (ndim - len(spec))
        named = {a for e in spec for a in _axes(e)}
        keep = np.empty(pieces.shape, dtype=object)
        for index in reads(mesh, named, row):
            keep[index] = pieces[index]
        return cls(keep, mesh, spec, row)

    # -- what the consumer sees ---------------------------------------------
    @property
    def order(self) -> list[tuple[int, ...]]:
        """The mesh indices of the pieces, in mesh order."""
        return [i for i in np.ndindex(*self.pieces.shape)
                if self.pieces[i] is not None]

    def tensors(self) -> list[torch.Tensor]:
        return [self.pieces[i] for i in self.order]

    @property
    def stored_shape(self) -> tuple:
        return whole_shape(self.pieces, self.mesh, self.spec)

    @property
    def shape(self) -> tuple:
        s = self.stored_shape
        return s[::-1] if self.transposed else s

    @property
    def ndim(self) -> int:
        return len(self.spec)

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[self.row]

    @property
    def T(self) -> "Placed":
        if self.ndim != 2:
            raise ValueError("only a 2-D master transposes")
        return Placed(self.pieces, self.mesh, self.spec, self.row,
                      not self.transposed)

    @property
    def view_spec(self) -> tuple:
        """The spec in the orientation the consumer sees."""
        return self.spec[::-1] if self.transposed else self.spec

    def __getitem__(self, idx) -> "Placed":
        """Leading integer indices (layers; their entries must be None),
        or None for a new leading axis of 1, as `models.transformer.pick`
        indexes a stacked leaf."""
        idx = idx if isinstance(idx, tuple) else (idx,)
        if self.transposed:
            raise ValueError("index a placed master before transposing it")
        spec = list(self.spec)
        out = []
        for i in idx:
            if i is None:
                out.append(None)
                continue
            if spec and spec[0] is not None:
                raise ValueError(f"dim 0 of spec {self.spec} is cut: a "
                                 f"layer axis must replicate")
            spec.pop(0)
        pieces = np.empty(self.pieces.shape, dtype=object)
        for i in self.order:
            pieces[i] = self.pieces[i][idx]
        return Placed(pieces, self.mesh, tuple(out) + tuple(spec), self.row)

    def unbind(self, dim: int = 0) -> list["Placed"]:
        if dim != 0:
            raise ValueError("a placed master unbinds its layer axis only")
        n = self.stored_shape[0]
        return [self[i] for i in range(n)]

    # -- the gathers ----------------------------------------------------------
    def model_dim(self) -> int | None:
        """The dim (as the consumer sees it) the spec splits over a
        'model' axis of more than one device, else None."""
        if self.mesh.shape.get("model", 1) == 1:
            return None
        hits = [d for d, e in enumerate(self.view_spec) if e == "model"]
        return hits[0] if hits else None

    def layout(self, model: int | None = None) -> Layout:
        """The whole master on the row's device (model None), or the
        pieces of 'model' index `model` joined over the spec's other axes
        on that 'model' device."""
        pos = {ix: k for k, ix in enumerate(self.order)}
        named = {a for e in self.spec for a in _axes(e)}
        row, spec, shape = list(self.row), self.spec, list(self.stored_shape)
        if model is not None:
            row[self.mesh.axis_names.index("model")] = model
            named.discard("model")
            spec = tuple(None if e == "model" else e for e in spec)
            shape[self.spec.index("model")] //= self.mesh.shape["model"]
        take, cuts = [], []
        for index in reads(self.mesh, named, tuple(row)):
            take.append(pos[index])
            cuts.append(_slices(shape, self.mesh, spec, index))
        return Layout(tuple(take), tuple(cuts), tuple(shape),
                      self.mesh.devices[tuple(row)])

    def gather(self, model: int | None = None) -> torch.Tensor:
        """`layout(model)`'s tensor as an autograd node over the pieces (a
        lone piece already on the device is itself), in the consumer's
        orientation."""
        lay = self.layout(model)
        pieces = self.tensors()
        if len(lay.take) == 1 and pieces[lay.take[0]].device == lay.device:
            out = pieces[lay.take[0]]
        else:
            out = _Gather.apply(lay, *pieces)
        return out.transpose(-1, -2) if self.transposed else out


def reads(mesh, named: set, row: tuple[int, ...]):
    """The mesh indices that agree with `row` on every axis not in
    `named`, in mesh order."""
    for index in np.ndindex(*mesh.devices.shape):
        if all(i == r for a, i, r in zip(mesh.axis_names, index, row)
               if a not in named):
            yield index


def whole(x):
    """A Placed's whole master on its row's device (`Placed.gather`); any
    other leaf as it is."""
    return x.gather() if isinstance(x, Placed) else x
