"""Carry the JAX package's parameters across to the port.

Input is a tree of nested dicts, lists and tuples of numpy arrays, the
form any JAX param tree takes after `np.asarray` on its leaves, with these
records written as dicts:

  * BN params   {"gamma", "beta"}           -> shift_bn.BNParams
  * BN state    {"mean", "var", "count"}    -> shift_bn.BNState
  * a frozen weight {"packed", "k", "kind", "conv_shape", "orig_dtype",
    "thresh", "flip", "fold"} -> core.packed.PackedWeight (uint32 words
    become int32 tensors holding the same bits)

Every other dict, list and tuple keeps its shape; numpy arrays become
tensors on `device` (None: the CUDA card). Stacked transformer trees carry
across as they are: a frozen weight's words keep their leading L axis.
`to_numpy_tree` is the way back. KV caches carry across with
`cache_from_numpy` / `cache_to_numpy` (packed K/V words uint32 <-> int32).
This module imports no jax: turning JAX arrays into numpy is the caller's
step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.packed import PackedWeight
from repro_torch.core.shift_bn import BNParams, BNState

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def tensor(a, device=None) -> torch.Tensor:
    """numpy -> torch on `device`; uint32 words -> int32 with the same bits."""
    a = np.array(a, copy=True, order="C")       # writable, contiguous
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(resolve_device(device))


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 wire-format words -> the JAX package's uint32 words."""
    return t.detach().cpu().numpy().view(np.uint32)


def _dtype(name) -> torch.dtype:
    return _DTYPES[str(name)]


def from_numpy_tree(tree, device=None):
    """Convert a numpy param tree (see the module doc) to the port's tree."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            keys = set(node)
            if keys == {"gamma", "beta"}:
                return BNParams(tensor(node["gamma"], dev),
                                tensor(node["beta"], dev))
            if keys == {"mean", "var", "count"}:
                return BNState(tensor(node["mean"], dev),
                               tensor(node["var"], dev),
                               tensor(node["count"], dev))
            if "packed" in keys:
                opt = (lambda v: None if v is None else tensor(v, dev))
                return PackedWeight(
                    tensor(node["packed"], dev), node["k"], node["kind"],
                    node.get("conv_shape"), _dtype(node.get("orig_dtype",
                                                            "float32")),
                    thresh=opt(node.get("thresh")),
                    flip=opt(node.get("flip")), fold=node.get("fold"))
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, (np.ndarray, np.generic)):
            return tensor(node, dev)
        return node

    return walk(tree)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:      # numpy has no bfloat16
        t = t.to(torch.float32)
    return t.numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    return {v: k for k, v in _DTYPES.items()}[dtype]


def to_numpy_tree(tree):
    """The port's tree -> the numpy form `from_numpy_tree` reads (BN
    records and frozen weights as dicts, words as uint32)."""
    if isinstance(tree, PackedWeight):
        opt = (lambda v: None if v is None else _array(v))
        return {"packed": words_to_numpy(tree.packed), "k": tree.k,
                "kind": tree.kind, "conv_shape": tree.conv_shape,
                "orig_dtype": _dtype_name(tree.orig_dtype),
                "thresh": opt(tree.thresh), "flip": opt(tree.flip),
                "fold": tree.fold}
    if isinstance(tree, BNParams):
        return {"gamma": _array(tree.gamma), "beta": _array(tree.beta)}
    if isinstance(tree, BNState):
        return {"mean": _array(tree.mean), "var": _array(tree.var),
                "count": _array(tree.count)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _array(tree)
    return tree


# cache leaves holding packed sign words (uint32 in the JAX package)
_CACHE_WORDS = ("k", "v")


def cache_from_numpy(cache: dict, device=None) -> dict:
    """A JAX cache (as numpy) -> the port's: uint32 K/V words become int32
    tensors with the same bits, float leaves stay float."""
    return {name: tensor(a, device) for name, a in cache.items()}


def cache_to_numpy(cache: dict) -> dict:
    """The port's cache -> the JAX package's numpy form (K/V words uint32)."""
    return {name: words_to_numpy(t) if name in _CACHE_WORDS else _array(t)
            for name, t in cache.items()}
