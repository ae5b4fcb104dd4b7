"""Bit-packing for {-1,+1} tensors (port of `repro.core.bitpack`).

Convention: bit 1 <-> +1, bit 0 <-> -1, packed little-endian along the last
axis into 32-bit words (K -> ceil(K/32) words). A K-length +-1 dot is

    dot(a, b) = K - 2 * popcount(xor(a_bits, b_bits))

The last word is padded with 1-bits in both operands, so the pad cancels in
the xor; the true K is passed to the dot formula.

torch supports few operations on uint32, so words are int32 tensors holding
the same 32 bits. `words.numpy().view(np.uint32)` gives the JAX package's
uint32 words and `np_words.view(np.int32)` goes back.
"""
from __future__ import annotations

import numpy as np
import torch

WORD = 32


def packed_width(k: int) -> int:
    return (k + WORD - 1) // WORD


def pack_bool(bits: torch.Tensor) -> torch.Tensor:
    """(..., K) bool -> (..., ceil(K/32)) int32 words, pad bits 1."""
    k = bits.shape[-1]
    kw = packed_width(k)
    pad = kw * WORD - k
    if pad:
        bits = torch.cat([bits, bits.new_ones(bits.shape[:-1] + (pad,))], -1)
    bits = bits.reshape(bits.shape[:-1] + (kw, WORD)).to(torch.int64)
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits.device)
    words = (bits << shifts).sum(-1)                  # in [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack a sign-carrying tensor along its last axis: bit = (x >= 0).

    (..., K) float -> (..., ceil(K/32)) int32. Pad bits are 1 (+1); -0.0
    packs to 1 and NaN to 0, as in the JAX package."""
    return pack_bool(x >= 0)


def unpack_bits(p: torch.Tensor, k: int, dtype=torch.float32) -> torch.Tensor:
    """Inverse of pack_bits: (..., ceil(K/32)) int32 -> (..., K) +-1."""
    kw = p.shape[-1]
    shifts = torch.arange(WORD, dtype=torch.int32, device=p.device)
    bits = (p.unsqueeze(-1) >> shifts) & 1
    flat = bits.reshape(p.shape[:-1] + (kw * WORD,))[..., :k]
    return flat.to(dtype) * 2 - 1


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 in, int32 out): SWAR on int64,
    since torch has no popcount op."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def packed_dot(a_p: torch.Tensor, b_p: torch.Tensor, k: int) -> torch.Tensor:
    """dot over the packed word axis (last axis of both): K - 2*popcount(xor).

    a_p, b_p: (..., KW) int32 words with broadcastable prefixes. Returns
    int32."""
    x = popcount(torch.bitwise_xor(a_p, b_p))
    return k - 2 * x.sum(-1, dtype=torch.int32)


def packed_nbytes(shape: tuple[int, ...]) -> int:
    """Bytes needed to store a +-1 tensor of `shape` packed (last axis)."""
    return int(np.prod(shape[:-1], dtype=np.int64)) * packed_width(shape[-1]) * 4
