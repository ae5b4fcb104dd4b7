"""Plain PyTorch oracles for the binary GEMM and packed-attention kernels
(port of the GEMM and attention parts of `repro.kernels.ref`).

They define the semantics the kernels match:
    binary_matmul(x, w) == sign(x) @ sign(w),  sign(0) := +1
bit for bit, and for attention over a bit-resident KV cache the op order of
the JAX oracles (integer dots, scale, mask, max, exp, sum, +-1 V, v_scale),
with the softmax and V sums taken exactly (see
`packed_masked_attention_ref`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.bitpack import pack_bits, pack_bool, packed_dot, unpack_bits

NEG_INF = -1e30


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


# ---------------------------------------------------------------------------
# Attention over a bit-resident KV cache
# ---------------------------------------------------------------------------
def _per_row(x, b: int, device) -> torch.Tensor:
    """scalar or (B,) int -> (B,) int32 tensor."""
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1) \
        .expand(b)


def packed_attention_dots(q: torch.Tensor, k_packed: torch.Tensor
                          ) -> torch.Tensor:
    """Integer score dots hd - 2*popcount(q_bits ^ k_bits) of every query
    row against every cache row. q: (B, S, Hq, hd) float (sign-packed
    here); k_packed: (B, T, Hkv, hdw) int32 words. Returns (B, Hkv, S, G, T)
    int32, head h = kv_head * G + g."""
    b, t, hkv, _ = k_packed.shape
    s, hd = q.shape[1], q.shape[-1]
    g = q.shape[2] // hkv
    qb = pack_bits(q.reshape(b, s, hkv, g, hd).transpose(1, 2))  # B,Hkv,S,G,w
    kb = k_packed.transpose(1, 2)                                # B,Hkv,T,w
    return packed_dot(qb[:, :, :, :, None, :], kb[:, :, None, None, :, :], hd)


def packed_masked_attention_ref(q: torch.Tensor, k_packed: torch.Tensor,
                                v_packed: torch.Tensor, v_scale: torch.Tensor,
                                valid: torch.Tensor) -> torch.Tensor:
    """Quantized multi-query attention core with an explicit (B, S, T)
    validity mask: pack -> popcount dot -> 1/sqrt(hd) -> NEG_INF mask ->
    max/exp/sum softmax -> +-1 V accumulated under v_scale.

    Two points where it defines what the JAX oracle leaves open:
      * the softmax sum l and the V sum acc are taken in float64 and
        rounded once to float32. Their terms are float32 values e_t in
        (2^-33, 1] (|s| <= sqrt(hd) for hd <= 128), so the sums are exact
        or within one float64 rounding of exact whatever their order: the
        CUDA kernel, which sums in another order, gets the same bits, and
        where +-e_t cancel exactly the output is exactly 0 (a +1 bit for
        the next projection). The JAX oracle sums in float32, and there
        keeps a residue whose sign depends on XLA's fusion order (ROADMAP
        Queue C);
      * a row with no valid position outputs 0 (the JAX oracle averages
        every V row there; the scheduler's inactive rows are such rows and
        their outputs are discarded).
    q: (B, S, Hq, hd) float; k_packed/v_packed: (B, T, Hkv, hdw) int32;
    v_scale: (B, Hkv) float. Returns (B, S, Hq, hd) in q.dtype."""
    b, t, hkv, _ = k_packed.shape
    s, hd = q.shape[1], q.shape[-1]
    g = q.shape[2] // hkv
    dots = packed_attention_dots(q, k_packed)                 # B,Hkv,S,G,T
    sc = dots.to(torch.float32) * torch.tensor(1.0 / float(hd) ** 0.5,
                                               dtype=torch.float32)
    vmask = valid[:, None, :, None, :]
    sc = torch.where(vmask, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.where(vmask, torch.exp(sc - m), torch.zeros_like(sc))
    # both sums in float64, where they are exact (see the docstring), then
    # rounded once to float32: the result does not depend on their order
    e64 = e.to(torch.float64)
    l = e64.sum(dim=-1, keepdim=True).to(torch.float32)       # B,Hkv,S,G,1
    sgn = unpack_bits(v_packed.transpose(1, 2), hd, dtype=torch.float64)
    acc = torch.einsum("bhsgt,bhtd->bhsgd", e64, sgn).to(torch.float32)
    vs = v_scale.to(torch.float32)[:, :, None, None, None]
    out = torch.where(l > 0, vs * (acc / l), torch.zeros_like(acc))
    return out.permute(0, 2, 1, 3, 4).reshape(b, s, hkv * g, hd).to(q.dtype)


def chunk_valid_mask(b: int, s: int, t: int, kv_len, q_pos, window: int,
                     causal: bool, device=None) -> torch.Tensor:
    """(B, S, T) validity mask for a chunk at global positions
    q_pos..q_pos+S-1 against a T-row cache with kv_len valid rows:
    t < kv_len [& t <= q_pos+i] [& t > q_pos+i-window]."""
    kpos = torch.arange(t, dtype=torch.int32, device=device)[None, None, :]
    length = _per_row(kv_len, b, device)[:, None, None]
    qp = _per_row(q_pos, b, device)[:, None, None] + \
        torch.arange(s, dtype=torch.int32, device=device)[None, :, None]
    valid = (kpos < length).expand(b, s, t)
    if causal:
        valid = valid & (kpos <= qp)
    if window > 0:
        valid = valid & (kpos > qp - window)
    return valid


def prefill_attention_packed_ref(q: torch.Tensor, k_packed: torch.Tensor,
                                 v_packed: torch.Tensor, v_scale: torch.Tensor,
                                 kv_len, q_pos, *, window: int = 0,
                                 causal: bool = True) -> torch.Tensor:
    """Oracle for kernels.prefill_attention.prefill_attention_packed: S
    float queries at global positions q_pos..q_pos+S-1 against the packed
    cache (their own rows already written), causal triangle and optional
    window fused into the mask. q: (B, S, Hq, hd); k/v: (B, T, Hkv, hdw)
    int32; v_scale: (B, Hkv); kv_len, q_pos: int or (B,). With S == 1 and
    q_pos == kv_len - 1 this is decode_attention_packed_ref."""
    b, t = k_packed.shape[0], k_packed.shape[1]
    valid = chunk_valid_mask(b, q.shape[1], t, kv_len, q_pos, window, causal,
                             device=q.device)
    return packed_masked_attention_ref(q, k_packed, v_packed, v_scale, valid)


def decode_attention_packed_ref(q: torch.Tensor, k_packed: torch.Tensor,
                                v_packed: torch.Tensor, v_scale: torch.Tensor,
                                cache_len, *, window: int = 0) -> torch.Tensor:
    """Oracle for kernels.decode_attention.decode_attention_packed:

        score_t = (hd - 2*popcount(xor(q_bits, k_bits_t))) / sqrt(hd)
        out     = v_scale * softmax(score)_t . sign(v_t)

    over positions t < cache_len (and t >= cache_len - window when
    window > 0). q: (B, 1, Hq, hd) float; k/v: (B, T, Hkv, hdw) int32;
    v_scale: (B, Hkv); cache_len: int or (B,)."""
    b = k_packed.shape[0]
    lens = _per_row(cache_len, b, q.device)
    return prefill_attention_packed_ref(q, k_packed, v_packed, v_scale, lens,
                                        lens - 1, window=window, causal=True)
