"""Plain PyTorch oracles for the binary GEMM, packed-attention and
selective-scan kernels (port of the GEMM and attention parts of
`repro.kernels.ref`, the paged attention oracles included, and of the scan
the JAX package's Mamba block runs, `repro.models.ssm._mamba_chunk_scan`).

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
    """scalar or (B,) int -> (B,) int32 tensor. A host int is filled on the
    device (no host-to-device copy, which would wait for the stream)."""
    if isinstance(x, int):
        return torch.full((b,), x, dtype=torch.int32, device=device)
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
                                valid: torch.Tensor,
                                flat: torch.Tensor | None = None
                                ) -> torch.Tensor:
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
      * a row with no valid position outputs 0, except the rows of batch
        rows that `flat` (B,) marks: every position of those weighs 1, as
        in the JAX oracle's softmax over all-masked scores (exp(NEG_INF -
        NEG_INF) = 1), so out = v_scale * (sum_t sign(v_t) / T). Decode
        marks its rows of cache_len 0, the scheduler's inactive rows: a
        MoE's inactive rows take expert capacity, so their values count.
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
    if flat is not None:
        every = flat.reshape(b, 1, 1, 1, 1)
        sc = torch.where(every, torch.zeros_like(sc), sc)
        vmask = vmask | every
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
                                 causal: bool = True,
                                 flat: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Oracle for kernels.prefill_attention.prefill_attention_packed: S
    float queries at global positions q_pos..q_pos+S-1 against the packed
    cache (their own rows already written), causal triangle and optional
    window fused into the mask. q: (B, S, Hq, hd); k/v: (B, T, Hkv, hdw)
    int32; v_scale: (B, Hkv); kv_len, q_pos: int or (B,). With S == 1 and
    q_pos == kv_len - 1 (and `flat` the rows of kv_len 0) this is
    decode_attention_packed_ref."""
    b, t = k_packed.shape[0], k_packed.shape[1]
    valid = chunk_valid_mask(b, q.shape[1], t, kv_len, q_pos, window, causal,
                             device=q.device)
    return packed_masked_attention_ref(q, k_packed, v_packed, v_scale, valid,
                                       flat)


def decode_attention_packed_ref(q: torch.Tensor, k_packed: torch.Tensor,
                                v_packed: torch.Tensor, v_scale: torch.Tensor,
                                cache_len, *, window: int = 0) -> torch.Tensor:
    """Oracle for kernels.decode_attention.decode_attention_packed:

        score_t = (hd - 2*popcount(xor(q_bits, k_bits_t))) / sqrt(hd)
        out     = v_scale * softmax(score)_t . sign(v_t)

    over positions t < cache_len (and t >= cache_len - window when
    window > 0); a row of cache_len 0 over all T positions, each weighing
    1 (the JAX oracle's all-masked softmax). q: (B, 1, Hq, hd) float; k/v:
    (B, T, Hkv, hdw) int32; v_scale: (B, Hkv); cache_len: int or (B,)."""
    b = k_packed.shape[0]
    lens = _per_row(cache_len, b, q.device)
    return prefill_attention_packed_ref(q, k_packed, v_packed, v_scale, lens,
                                        lens - 1, window=window, causal=True,
                                        flat=lens == 0)


# ---------------------------------------------------------------------------
# Paged cache: gather the page-table rows, then the contiguous oracles
# ---------------------------------------------------------------------------
def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """A paged cache as its contiguous equivalent.

    pool: (P, ps, Hkv, d) pages shared by every slot; page_table: (B, NP)
    int32, row b mapping positions [i*ps, (i+1)*ps) to pool page
    page_table[b, i]. Returns (B, NP*ps, Hkv, d). Unallocated entries hold
    the sentinel P: they clip to page P-1 here, and the rows they bring are
    masked by the length masks downstream (the contiguous kernels' t >=
    kv_len convention), so paged attention is contiguous attention on the
    gathered panel, bit for bit."""
    p, ps = pool.shape[0], pool.shape[1]
    b, n_pages = page_table.shape
    idx = page_table.clamp(max=p - 1).reshape(-1).long()
    return pool[idx].reshape((b, n_pages * ps) + tuple(pool.shape[2:]))


def decode_attention_packed_paged_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                      v_pool: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      page_table: torch.Tensor, cache_len, *,
                                      window: int = 0) -> torch.Tensor:
    """Oracle for kernels.decode_attention.decode_attention_packed_paged:
    gather the page-table rows into a (B, NP*ps, Hkv, hdw) panel, then the
    contiguous decode oracle unchanged."""
    return decode_attention_packed_ref(
        q, gather_pages(k_pool, page_table), gather_pages(v_pool, page_table),
        v_scale, cache_len, window=window)


def prefill_attention_packed_paged_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                       v_pool: torch.Tensor,
                                       v_scale: torch.Tensor,
                                       page_table: torch.Tensor, kv_len,
                                       q_pos, *, window: int = 0,
                                       causal: bool = True) -> torch.Tensor:
    """Oracle for kernels.prefill_attention.prefill_attention_packed_paged
    (gather, then the contiguous chunk oracle unchanged)."""
    return prefill_attention_packed_ref(
        q, gather_pages(k_pool, page_table), gather_pages(v_pool, page_table),
        v_scale, kv_len, q_pos, window=window, causal=causal)


# ---------------------------------------------------------------------------
# Selective scan (the Mamba-1 recurrence)
# ---------------------------------------------------------------------------
# time steps whose states are stacked before their outputs are summed
_SCAN_Y_STEPS = 64


def selective_scan_ref(dt: torch.Tensor, xi: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor, a_mat: torch.Tensor,
                       h0: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle for kernels.selective_scan.selective_scan:

        h_t = exp(dt_t * A) * h_{t-1} + (dt_t * xi_t) * B_t
        y_t = sum_n h_t[:, n] * C_t[n]

    dt: (B, T, D) float32; xi: (B, T, D) float32 | bf16; bmat, cmat: (B, T,
    N) float32; a_mat: (D, N) float32 (negative); h0: (B, D, N) float32 or
    None (zeros). Returns y (B, T, D) and h_final (B, D, N), float32.

    One fixed order of operations, the CUDA kernel's: dt * A rounded to
    float32, its exp taken in float64 and rounded once to float32 (the CUDA
    math library's float exp and torch's can part by an ulp, its double exp
    is the one both sides call on the card); each product and sum of the
    update rounded on its own (no fused multiply-add); y summed over n = 0,
    1, ..., N-1 in sequence. With dt = 0 at a step, a = 1 and the input term
    is 0, so h passes through the step unchanged."""
    b, t, d = dt.shape
    n = bmat.shape[-1]
    dev = dt.device
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=dev)
         if h0 is None else h0.to(torch.float32).clone())
    dt, xi = dt.to(torch.float32), xi.to(torch.float32)
    bmat, cmat = bmat.to(torch.float32), cmat.to(torch.float32)
    a_mat = a_mat.to(torch.float32)
    y = torch.empty((b, t, d), dtype=torch.float32, device=dev)
    hist: list[torch.Tensor] = []
    for i in range(t):
        dti = dt[:, i]                                          # (B, D)
        a = torch.exp((dti[:, :, None] * a_mat).to(torch.float64)) \
            .to(torch.float32)                                  # (B, D, N)
        dx = dti * xi[:, i]
        h = a * h + dx[:, :, None] * bmat[:, i, None, :]
        hist.append(h)
        if len(hist) == _SCAN_Y_STEPS or i == t - 1:
            lo = i + 1 - len(hist)
            hs = torch.stack(hist, dim=1)                       # (B, S, D, N)
            c = cmat[:, lo:i + 1, None, :]                      # (B, S, 1, N)
            acc = hs[..., 0] * c[..., 0]
            for k in range(1, n):
                acc = acc + hs[..., k] * c[..., k]
            y[:, lo:i + 1] = acc
            hist = []
    return y, h
