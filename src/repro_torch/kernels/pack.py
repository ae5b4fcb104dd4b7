"""Sign-pack: the hand-written Hopper kernel, its plain PyTorch version, and
the wrapper (port of `repro.kernels.pack`).

`pack_bits_kernel(x)` turns a float32 or bf16 (..., K) tensor into its
(..., ceil(K/32)) int32 wire-format words (bit = x >= 0, little-endian, pad
bits 1; `core.bitpack`). Replaces the TPU kernel `pack_bits_kernel`
(src/repro/kernels/pack.py:35). On CUDA tensors it launches the kernel of
`csrc/pack.cu`, or raises; it runs the plain version only because its input
lies on the CPU. `launches["pack_bits"]` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitpack import pack_bits, packed_width
from repro_torch.kernels import _build

launches = {"pack_bits": 0}
_X_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    launches["pack_bits"] = 0


def pack_bits_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (`core.bitpack.pack_bits`)."""
    return pack_bits(x)


def pack_bits_kernel(x: torch.Tensor) -> torch.Tensor:
    """(..., K) float32 | bf16 -> (..., ceil(K/32)) int32 words, pad bits 1;
    -0.0 packs to 1, NaN to 0."""
    if x.dtype not in _X_BF16:
        raise TypeError(f"pack_bits_kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.device.type == "cpu":
        return pack_bits_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no pack kernel for device {x.device}")
    k = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    out = torch.empty(lead + (packed_width(k),), dtype=torch.int32,
                      device=x.device)
    if x2.shape[0] and k:
        fn = _build.library("pack").pack_bits
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check("pack", fn(x2.data_ptr(), _X_BF16[x.dtype],
                                out.data_ptr(), x2.shape[0], k, stream),
                     "pack_bits")
        launches["pack_bits"] += 1
    return out
