"""Kernel-repetition analysis (paper §4.2; port of `repro.core.kernel_dedup`).

Binary k x k kernels live in a 2^(k*k) universe, so conv layers repeat 2D
kernels heavily (paper: ~37% unique on their CIFAR-10 net). An *inverse*
kernel (-K) counts as a repetition too (a popcount negation). The analysis
is a static one on the weights (numpy, as in the JAX package): it feeds the
energy model (`core.energy`) and gives a dedup plan for frozen inference
weights, which `apply_dedup` expands on the tensor's device.

The layout rule is the JAX package's: a 4-D weight whose first two dims
are both <= 16 is read as (kh, kw, cin, cout), the layout of both
packages' conv weights (`models.paper_nets`); any other as (cout, cin, kh,
kw). A (cout, cin, kh, kw) weight with cout, cin <= 16 is read by the first
rule in both packages.
"""
from __future__ import annotations

import numpy as np
import torch


def _flat(w: np.ndarray) -> np.ndarray:
    """The 2D kernels of w as rows (n2d, kh*kw), by the layout rule."""
    if w.shape[0] <= 16 and w.shape[1] <= 16:  # (kh, kw, cin, cout)
        return w.reshape(w.shape[0] * w.shape[1], -1).T
    return w.reshape(w.shape[0] * w.shape[1], -1)  # (cout, cin, kh, kw)


def kernel_signatures(w) -> np.ndarray:
    """w: (kh, kw, cin, cout) or (cout, cin, kh, kw) binary conv weights.
    Returns an int64 signature per 2D kernel slice (cin*cout of them),
    canonicalized so K and -K share a signature."""
    w = np.asarray(w)
    if w.ndim != 4:
        raise ValueError("expected 4D conv weights")
    bits = (_flat(w) >= 0).astype(np.int64)
    # canonical form: ensure first bit is 1 (fold K / -K together)
    invert = bits[:, :1] == 0
    bits = np.where(invert, 1 - bits, bits)
    weights = (1 << np.arange(bits.shape[1], dtype=np.int64))
    return bits @ weights


def unique_kernel_fraction(w) -> float:
    """Fraction of unique 2D kernels (inverse pairs folded), per §4.2."""
    sig = kernel_signatures(w)
    return float(len(np.unique(sig))) / float(len(sig))


def dedup_plan(w) -> dict:
    """Compile-time dedup plan for frozen inference weights: for each 2D
    kernel slice, the index of its canonical representative and a +-1 sign.

    Returns {'rep_index': (n2d,), 'first': (n_unique,), 'sign': (n2d,),
    'n_unique': int}."""
    sig = kernel_signatures(w)
    flat = _flat(np.asarray(w)) >= 0
    uniq, rep_index = np.unique(sig, return_inverse=True)
    # representative = first occurrence per signature
    first = np.zeros(len(uniq), dtype=np.int64)
    seen = {}
    for i, s in enumerate(sig):
        if s not in seen:
            seen[s] = i
    for j, s in enumerate(uniq):
        first[j] = seen[s]
    sign = np.where(
        (flat == flat[first[rep_index]]).all(axis=1), 1, -1
    ).astype(np.int32)
    return {"rep_index": rep_index, "first": first, "sign": sign,
            "n_unique": int(len(uniq))}


def apply_dedup(x_convolved_unique: torch.Tensor, plan: dict) -> torch.Tensor:
    """Given conv results for the unique kernels only (..., n_unique),
    expand back to all kernels with signs: a gather along the last dim and
    a sign multiply, on the tensor's device."""
    x = x_convolved_unique
    idx = torch.as_tensor(np.asarray(plan["rep_index"]), dtype=torch.long,
                          device=x.device)
    sign = torch.as_tensor(np.asarray(plan["sign"]), device=x.device)
    return x.index_select(-1, idx) * sign.to(x.dtype)
