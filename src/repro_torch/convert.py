"""Carry the JAX package's parameters across to the port.

Input is a tree of nested dicts, lists and tuples of numpy arrays, the
form any JAX param tree takes after `np.asarray` on its leaves, with these
records written as dicts:

  * BN params   {"gamma", "beta"}           -> shift_bn.BNParams
  * BN state    {"mean", "var", "count"}    -> shift_bn.BNState
  * optimizer state {"m", "u", "step"}      -> optim.shift_adamax.AdaMaxState
    (m and u are trees shaped like the params, BN records included)
  * a frozen weight {"packed", "k", "kind", "conv_shape", "orig_dtype",
    "thresh", "flip", "fold"} -> core.packed.PackedWeight (uint32 words
    become int32 tensors holding the same bits)

Every other dict, list and tuple keeps its shape; numpy arrays become
tensors on `device` (None: the CUDA card). The fp32-master training trees of
the paper nets (params with BN params, BN running state, S-AdaMax state)
carry across this way, so a JAX (params, bn_state, opt_state) becomes the
port's and back. Stacked transformer trees carry
across as they are: a frozen weight's words keep their leading L axis
(the transformer's and the Mamba stack's alike).
`to_numpy_tree` is the way back. KV caches carry across with
`cache_from_numpy` / `cache_to_numpy`, contiguous or paged: packed K/V
words (or page pools) uint32 <-> int32, float K/V (kv_bits=0) in their
dtype, the page table as int32, V scales as float32; so does the Mamba
stack's recurrent state {"conv", "h"}, and the hybrid's state (its rec
layers' conv histories and h, stacked (g, n_rec, ...) and (tail, ...), and
its attention layers' rings "attn_k" / "attn_v", packed words or float
rows). bfloat16 leaves (float K/V, the conv history) come back from
`cache_to_numpy` as float32, which holds them exactly.
This module imports no jax: turning JAX arrays into numpy is the caller's
step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.packed import PackedWeight
from repro_torch.core.shift_bn import BNParams, BNState
from repro_torch.models.transformer import new_pool
from repro_torch.optim.shift_adamax import AdaMaxState

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def tensor(a, device=None) -> torch.Tensor:
    """numpy -> torch on `device`; uint32 words -> int32 with the same bits;
    a bfloat16 array (JAX's, numpy's extension type) -> torch.bfloat16."""
    a = np.array(a, copy=True, order="C")       # writable, contiguous
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(resolve_device(device))
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
            if keys == {"m", "u", "step"}:
                return AdaMaxState(walk(node["m"]), walk(node["u"]),
                                   tensor(node["step"], dev))
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
    if isinstance(tree, AdaMaxState):
        return {"m": to_numpy_tree(tree.m), "u": to_numpy_tree(tree.u),
                "step": _array(tree.step)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _array(tree)
    return tree


# cache leaves holding K/V: packed sign words (uint32 in the JAX package)
# at kv_bits=1, float rows at kv_bits=0 (the hybrid's rings: attn_k/v; the
# vlm family's image rows: xk/xv)
_CACHE_KV = ("k", "v", "attn_k", "attn_v", "xk", "xv")


def cache_from_numpy(cache: dict, device=None) -> dict:
    """A JAX cache (as numpy) -> the port's: uint32 K/V words become int32
    tensors with the same bits, float leaves (float K/V included) keep
    their dtype. A paged cache's (L, P, ps, Hkv, w) pools (the vlm
    family's (g, xattn_group - 1, P, ...)) land in the port's pools, whose storage has each layer's sink page behind them
    (`models.transformer.new_pool`)."""
    out = {name: tensor(a, device) for name, a in cache.items()}
    if "page_table" in cache:
        for name in ("k", "v"):
            kv = out[name]
            pool = new_pool(*kv.shape, device=kv.device, dtype=kv.dtype)
            pool.copy_(kv)
            out[name] = pool
    return out


def cache_to_numpy(cache: dict) -> dict:
    """The port's cache -> the JAX package's numpy form (K/V words uint32;
    float K/V as float32 arrays, bfloat16 widened exactly)."""
    return {name: words_to_numpy(t)
            if name in _CACHE_KV and t.dtype == torch.int32 else _array(t)
            for name, t in cache.items()}
