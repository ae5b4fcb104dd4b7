"""EF-SignSGD: 1-bit gradient compression with error feedback (port of
`repro.optim.ef_signsgd`; the data-parallel step that reduces the signs
is `train.compressed`).

Each worker sends sign(g + e) (1 bit per parameter) and one float32 scale
per tensor, mean |g + e|, and keeps the residual e = (g + e) - scale *
sign(g + e) for the next step (Karimireddy et al., 2019): the paper's
thesis, binarization noise tolerated when a float reference accumulates the
corrections, applied to the gradient all-reduce. Wire format per tensor:
packed 32-bit words (`core.bitpack`) and the scale.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.bitpack import packed_nbytes
from repro_torch.optim.base import tree_leaves, tree_map, tree_unflatten_like

_F32 = torch.float32


class EFState(NamedTuple):
    error: Any  # residual tree, float32


def init_ef(params) -> EFState:
    return EFState(error=tree_map(
        lambda p: torch.zeros_like(p, dtype=_F32), params))


def compress_leaf(g: torch.Tensor, e: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (sign in {-1, +1} int8, scale scalar, new residual)."""
    corr = g.to(_F32) + e
    scale = corr.abs().mean()
    sign = torch.where(corr >= 0, 1, -1).to(torch.int8)
    new_e = corr - scale * sign.to(_F32)
    return sign, scale, new_e


def ef_signsgd_compress(grads, state: EFState):
    """Compress a gradient tree. Returns (signs int8 tree, scales tree, new
    EFState). The caller reduces `signs` across data parallelism (a sum of
    int8) and `scales` (a mean), then calls decompress."""
    parts = [compress_leaf(g, e) for g, e in
             zip(tree_leaves(grads), tree_leaves(state.error), strict=True)]
    signs, scales, errors = (tree_unflatten_like(grads, [p[i] for p in parts])
                             for i in range(3))
    return signs, scales, EFState(error=errors)


def ef_signsgd_decompress(sign_sums, scale_means, n_workers: int):
    """The averaged gradient from reduced signs and scales:
    g_hat = scale_mean * (sum of signs) / n_workers."""
    return tree_map(lambda s, sc: sc * s.to(_F32) / float(n_workers),
                    sign_sums, scale_means)


def compressed_bytes(params) -> int:
    """Wire bytes per worker per step under EF-SignSGD (packed words and a
    float32 scale per tensor)."""
    return sum(packed_nbytes(tuple(p.shape) if p.ndim else (1,)) + 4
               for p in tree_leaves(params))
