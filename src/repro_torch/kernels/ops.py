"""Ops around the binary GEMM kernels (port of `repro.kernels.ops`).

Training: `binary_matmul(x, w, path)` is sign(x) @ sign(w) for float
masters, a `torch.autograd.Function` whose backward is the paper's STE
(Eq. 6), as the JAX package's `custom_vjp`. Its forward routes:
  * 'mxu'  — `binary_gemm_mxu`, signs both operands to +-1 int8 and
             multiplies them on the tensor cores (plain version on the CPU)
  * 'vpu'  — sign-pack x and w.T (`pack_bits_kernel`), then the XNOR +
             popcount kernel `binary_gemm_packed`
  * 'ref'  — the plain float oracle on any device
  * 'auto' — 'mxu': the tensor-core kernel on CUDA tensors, its plain
             version on CPU tensors
All four give the same exact integers as float32. The backward products are
float32 `torch.matmul`s outside any kernel, as the JAX package leaves them
to XLA (TF32 stays off, torch's default, so they are float32 on the card).

Inference: weights frozen to wire-format words at load time
(`core.packed`); per call only the activations are sign-packed, inside the
kernel. There `path` is 'auto' (`dispatch_binary_gemm{,_fused}`: the Hopper
kernels on CUDA tensors, their plain versions on CPU tensors) or 'ref' (the
plain versions on any device, in row chunks). Both are bit-exact.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.binarize import binarize_det, ste_mask
from repro_torch.core.bitpack import packed_width
from repro_torch.core.packed import PackedActivation, PackedWeight
from repro_torch.kernels import ref
from repro_torch.kernels.binary_gemm import (
    binary_gemm_fused_plain, binary_gemm_mxu, binary_gemm_packed,
    binary_gemm_packed_plain, binary_gemm_packed_rhs_plain,
    dispatch_binary_gemm, dispatch_binary_gemm_fused,
)
from repro_torch.kernels.pack import pack_bits_kernel

MATMUL_PATHS = ("auto", "mxu", "vpu", "ref")


def _forward(x: torch.Tensor, w: torch.Tensor, path: str) -> torch.Tensor:
    """sign(x) @ sign(w) as float32 over x's leading dims, by `path`."""
    k, n = w.shape
    x2 = x.reshape(-1, k).contiguous()
    if path in ("auto", "mxu"):
        out = binary_gemm_mxu(x2, w.contiguous())
    elif path == "vpu":
        out = binary_gemm_packed(pack_bits_kernel(x2),
                                 pack_bits_kernel(w.t().contiguous()),
                                 k).to(torch.float32)
    elif path == "ref":
        out = ref.binary_matmul_ref(x2, w)
    else:
        raise ValueError(f"binary_matmul path {path!r} not in {MATMUL_PATHS}")
    return out.reshape(x.shape[:-1] + (n,))


class _BinaryMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, path):
        ctx.save_for_backward(x, w)
        return _forward(x, w, path)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        wb = ref.sign_pm1(w)
        # STE: the gradient flows through each operand's sign() where the
        # operand is unsaturated (JAX ops.py `_bwd`, the same op order)
        gx = torch.matmul(g, wb.t()) * ste_mask(x)
        xb = ref.sign_pm1(x).reshape(-1, x.shape[-1])
        gw = torch.matmul(xb.t(), g.reshape(-1, g.shape[-1])) * ste_mask(w)
        return gx.to(x.dtype), gw.to(w.dtype), None


def binary_matmul(x: torch.Tensor, w: torch.Tensor,
                  path: str = "auto") -> torch.Tensor:
    """sign(x) @ sign(w) with STE gradients (paper Eq. 6). x: (..., K)
    float32 or bf16, w: (K, N) float32. Returns (..., N) float32."""
    return _BinaryMatmul.apply(x, w, path)


def binary_matmul_vpu(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return binary_matmul(x, w, "vpu")


def binary_matmul_mxu(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return binary_matmul(x, w, "mxu")


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


def packed_matmul_experts(x: torch.Tensor | PackedActivation,
                          w: PackedWeight, *, path: str = "auto"
                          ) -> torch.Tensor:
    """sign(x_e) @ frozen-sign(w_e) for every expert e: x (E, C, K) float,
    or a PackedActivation of its (E, C, KW) words; w a PackedWeight whose
    wire matrices are (E, N, KW). Returns (E, C, N) int32 from one batched
    launch of kernel 1 ('auto'), or its plain version ('ref'). A float x is
    sign-packed first (`PackedActivation.pack`: kernel 5 on 'auto')."""
    if w.packed.ndim != 3:
        raise ValueError(f"expert GEMMs take (E, N, KW) wire matrices, got "
                         f"{w}")
    if not isinstance(x, PackedActivation):
        x = PackedActivation.pack(x, path=path)
    if x.k != w.k:
        raise ValueError(f"K mismatch: {x.k} vs {w.k}")
    a = x.packed.contiguous()
    if path == "auto":
        return binary_gemm_packed(a, w.packed, w.k)
    if path == "ref":
        return binary_gemm_packed_plain(a, w.packed, w.k)
    raise ValueError(path)


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
    runtime path: `path` 'ref' takes the plain versions, any other the
    kernels) or a (kh, kw, Cin, Cout) float master (im2col + `binary_matmul`
    by `path`, with its STE backward). Returns (B, H, W, Cout) float32.

    x is signed before the patches are taken, so the zero border reads as
    +1 (sign(0) := +1). For float masters that sign is straight-through
    (`binarize_det`), so the gradient reaches x, as Algorithm 1 has it; the
    JAX package signs with the zero-gradient `ref.sign_pm1` there, which
    stops the gradient at every binary conv (ROADMAP Queue C).
    """
    if isinstance(w, PackedWeight):
        return packed_conv2d(x, w, path="ref" if path == "ref" else "auto")
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = x.shape
    cols = im2col(binarize_det(x), kh, kw)
    wmat = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return binary_matmul(cols, wmat, path).reshape(b, h, wd, cout)
