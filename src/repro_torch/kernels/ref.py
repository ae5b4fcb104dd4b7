"""Plain PyTorch oracles for the binary GEMM kernels (port of the GEMM part
of `repro.kernels.ref`).

They define the semantics the kernels match bit for bit:
    binary_matmul(x, w) == sign(x) @ sign(w),  sign(0) := +1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.bitpack import pack_bool, packed_dot


def sign_pm1(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0).to(torch.float32)


def binary_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense float oracle: sign(x) @ sign(w). x: (M, K), w: (K, N). Exact
    in float32 while K < 2^24."""
    return torch.matmul(sign_pm1(x), sign_pm1(w))


def binary_matmul_packed_ref(a_packed: torch.Tensor, b_packed: torch.Tensor,
                             k: int) -> torch.Tensor:
    """Packed oracle. a_packed: (M, KW) int32, b_packed: (N, KW) int32 (rhs
    packed along K after transpose). Returns (M, N) int32."""
    return packed_dot(a_packed[:, None, :], b_packed[None, :, :], k)


def binary_matmul_fused_ref(a_packed: torch.Tensor, b_packed: torch.Tensor,
                            thresh: torch.Tensor, flip: torch.Tensor,
                            k: int) -> torch.Tensor:
    """Oracle for the fused packed-I/O epilogue: popcount dot -> per-channel
    threshold bit -> wire-format repack along N. Returns (M, ceil(N/32))
    int32, pad bits 1."""
    ints = binary_matmul_packed_ref(a_packed, b_packed, k)       # (M, N)
    return pack_bool((ints >= thresh[None, :]) != (flip[None, :] != 0))


def binary_conv2d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Oracle for ops.binary_conv2d: conv(sign(x), sign(w)) with SAME-size
    output and +1-valued border padding (sign(0) := +1, so the binary
    pipeline pads with +1, not 0). x: (B, H, W, Cin), w: (kh, kw, Cin, Cout)
    HWIO; returns NHWC float32."""
    kh, kw, _, _ = w.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(sign_pm1(x).permute(0, 3, 1, 2),
               (pw, kw - 1 - pw, ph, kh - 1 - ph), value=1.0)
    out = F.conv2d(xp, sign_pm1(w).permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1)
