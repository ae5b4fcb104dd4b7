"""Packed-weight inference ops around the binary GEMM kernels (port of the
inference half of `repro.kernels.ops`).

Weights are frozen to wire-format words at load time (`core.packed`); per
call only the activations are sign-packed, inside the kernel. Inference
only: `binary_matmul` with its STE backward comes with the training slice.

`path` selects the realization of every binary GEMM here: 'auto' goes
through `dispatch_binary_gemm{,_fused}` (the Hopper kernels on CUDA tensors,
their plain versions on CPU tensors), 'ref' through the plain versions on
any device (the oracles of `kernels.ref`, taken in row chunks). Both are
bit-exact.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.bitpack import packed_width
from repro_torch.core.packed import PackedActivation, PackedWeight
from repro_torch.kernels import ref
from repro_torch.kernels.binary_gemm import (
    binary_gemm_fused_plain, binary_gemm_packed_plain,
    binary_gemm_packed_rhs_plain, dispatch_binary_gemm,
    dispatch_binary_gemm_fused,
)


def _lhs_rows(x: torch.Tensor | PackedActivation, w: PackedWeight):
    """(rows, lead shape, dtype) of a GEMM lhs: the words of a
    PackedActivation or a float tensor, flattened to (M, KW | K)."""
    if w.packed.ndim != 2:
        raise ValueError(f"binary GEMMs take a 2-D wire matrix, got {w}")
    packed = isinstance(x, PackedActivation)
    a, k = (x.packed, x.k) if packed else (x, x.shape[-1])
    if k != w.k:
        raise ValueError(f"K mismatch: {k} vs {w.k}")
    return a.reshape(-1, a.shape[-1]).contiguous(), a.shape[:-1], x.dtype


def packed_matmul(x: torch.Tensor | PackedActivation, w: PackedWeight, *,
                  path: str = "auto") -> torch.Tensor:
    """sign(x) @ frozen-sign(w) from pre-packed weights.

    x: (..., K) float, or a PackedActivation already in the wire format;
    w: a PackedWeight whose wire matrix is (N, KW). Returns (..., N) int32.
    """
    a2, lead, _ = _lhs_rows(x, w)
    if path == "auto":
        out = dispatch_binary_gemm(a2, w.packed, w.k)
    elif path == "ref":
        plain = binary_gemm_packed_plain if a2.dtype == torch.int32 \
            else binary_gemm_packed_rhs_plain
        out = plain(a2, w.packed, w.k)
    else:
        raise ValueError(path)
    return out.reshape(lead + (w.packed.shape[0],))


def packed_matmul_fused(x: torch.Tensor | PackedActivation, w: PackedWeight,
                        *, thresh: torch.Tensor | None = None,
                        flip: torch.Tensor | None = None,
                        path: str = "auto") -> PackedActivation:
    """One bit-resident chain step: popcount GEMM + fused epilogue.

    The layer's epilogue is a per-channel (thresh, flip) pair on the integer
    dot: w's freeze-time fold, or passed explicitly (e.g. re-folded from the
    running BN statistics in effect). Returns the next layer's packed lhs,
    (..., ceil(N/32)) words. x: float (chain entry) or a PackedActivation.
    """
    if thresh is None:
        if not w.has_threshold:
            raise ValueError(f"{w} carries no folded threshold")
        thresh, flip = w.thresh, w.flip
    elif flip is None:
        flip = torch.zeros_like(thresh)   # plain (dot >= t), no inversion
    thresh = thresh.to(torch.int32)
    flip = flip.to(torch.int32)
    a2, lead, dtype = _lhs_rows(x, w)
    if path == "auto":
        out = dispatch_binary_gemm_fused(a2, w.packed, thresh, flip, w.k)
    elif path == "ref":
        out = binary_gemm_fused_plain(a2, w.packed, thresh, flip, w.k)
    else:
        raise ValueError(path)
    n = w.packed.shape[0]
    return PackedActivation(out.reshape(lead + (packed_width(n),)), k=n,
                            dtype=dtype)


def im2col(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*H*W, C*kh*kw) patches, SAME zero padding, stride
    1. Features run (c, kh, kw): the order of JAX's
    conv_general_dilated_patches and of the im2col PackedWeight. One gather
    copy from a strided view of the padded NHWC tensor."""
    b, h, wd, c = x.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    patches = xp.unfold(1, kh, 1).unfold(2, kw, 1)      # (B, H, W, C, kh, kw)
    return patches.reshape(b * h * wd, c * kh * kw).contiguous()


def packed_conv2d(x: torch.Tensor, w: PackedWeight, *,
                  path: str = "auto") -> torch.Tensor:
    """Binary conv from a pre-packed im2col weight (SAME padding, stride 1).

    x: (B, H, W, Cin) float; w: conv PackedWeight frozen from a (kh, kw,
    Cin, Cout) kernel. Returns (B, H, W, Cout) float32, bit-exact with
    binary_conv2d on the unpacked weight. x is signed before the patches are
    taken, so the zero border packs as +1 (sign(0) := +1).
    """
    if w.kind != "conv":
        raise ValueError(f"packed_conv2d takes a conv PackedWeight, got {w}")
    kh, kw, _, cout = w.conv_shape
    b, h, wd, _ = x.shape
    cols = im2col(ref.sign_pm1(x), kh, kw)
    out = packed_matmul(cols, w, path=path).to(torch.float32)
    return out.reshape(b, h, wd, cout)


def binary_conv2d(x: torch.Tensor, w: torch.Tensor | PackedWeight, *,
                  path: str = "auto") -> torch.Tensor:
    """Binary conv (SAME padding, stride 1): conv(sign(x), sign(w)).

    x: (B, H, W, Cin) float; w: a frozen conv PackedWeight (the packed
    runtime path, realized by `path`) or a (kh, kw, Cin, Cout) float master
    (im2col + the float sign-matmul oracle, the JAX package's 'ref' path).
    Returns (B, H, W, Cout) float32.
    """
    if isinstance(w, PackedWeight):
        return packed_conv2d(x, w, path=path)
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = x.shape
    cols = im2col(ref.sign_pm1(x), kh, kw)
    wmat = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return ref.binary_matmul_ref(cols, wmat).reshape(b, h, wd, cout)
