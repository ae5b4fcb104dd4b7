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
tensors on `device` (None: the CUDA card). This module imports no jax:
turning JAX arrays into numpy is the caller's step.
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
