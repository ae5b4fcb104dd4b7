"""Attention entry points the model code imports (port of
`repro.models.attention`): the float attention over float K/V, plain
PyTorch as in the JAX package (jnp there, no Pallas kernel), and, re-
exported from the kernels, attention over a bit-resident KV cache in the
contiguous and the paged layout, with its V scale.

Float attention keeps the JAX package's order of operations: the flash
forward scales q in float32 and casts it back to the activation dtype,
takes scores and softmax statistics in float32 (masked entries NEG_INF =
-1e30), casts p to the activation dtype before the PV product, and divides
by l where l > 0 (`l_safe`). Products of activation-dtype operands are
taken on float32 copies (exact products, float32 sums), as JAX's
`preferred_element_type=float32`; the cache-side functions (chunk, decode,
`attention_ref`) are float32 throughout, as there. TF32 is never used.

Shapes: q (B, S, Hq, d); k, v (B, T, Hkv, d); Hq = Hkv * G, head h =
kv_head * G + g.

Training: where q, k or v requires a gradient, `flash_attention` is a
`torch.autograd.Function` whose backward is the JAX package's custom VJP
(`_fa_bwd`): it recomputes each chunk's probabilities from the saved
(out, lse), takes delta = sum(do * o) per row, casts p to the activation
dtype for dv and ds = p * (dp - delta) to it too, with float32 products,
chunk by chunk in order. Autograd never sees the forward's chunk loop, so
no chunk's (S, C) scores are kept for the backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (
    decode_attention_packed, decode_attention_packed_paged, v_cache_scale,
)
from repro_torch.kernels.prefill_attention import (
    prefill_attention_packed, prefill_attention_packed_paged,
)
from repro_torch.kernels.ref import chunk_valid_mask, gather_pages

__all__ = ["attention_ref", "chunk_attention", "chunk_attention_paged",
           "decode_attention", "decode_attention_packed",
           "decode_attention_packed_paged", "decode_attention_paged",
           "flash_attention", "masked_chunk_attention",
           "prefill_attention_packed", "prefill_attention_packed_paged",
           "v_cache_scale"]

NEG_INF = -1e30
_F32 = torch.float32


def _scale(d: int) -> float:
    """1 / sqrt(d) rounded as `1.0 / jnp.sqrt(float32(d))` in float32, as a
    host float (a device scalar would cost a host-to-device copy, which
    waits for the stream, on every call); a float32 tensor times it takes
    exactly this float32 value."""
    return float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=_F32)))


def _chunk_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                window: int) -> torch.Tensor:
    """(S, C) validity of key positions kpos for query positions qpos."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def _heads(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, S, Hq, d) -> (B, Hkv, G, S, d)."""
    b, s, hq, d = x.shape
    return x.transpose(1, 2).reshape(b, hkv, hq // hkv, s, d)


def _merge(out: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, G, S, d) -> (B, S, Hq, d)."""
    b, hkv, g, s, d = out.shape
    return out.reshape(b, hkv * g, s, d).transpose(1, 2)


def _dots(qf: torch.Tensor, kf: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, G, S, d) queries . (B, Hkv, T, d) keys -> (B, Hkv, G, S, T),
    one batched product per KV head with its G query heads as rows (a
    broadcast over G would copy K G times)."""
    b, hkv, g, s, d = qf.shape
    return torch.matmul(qf.reshape(b, hkv, g * s, d), kf.transpose(-1, -2)) \
        .view(b, hkv, g, s, -1)


def _pv(p: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, G, S, T) weights . (B, Hkv, T, d) values -> (B, Hkv, G, S,
    d), as `_dots`."""
    b, hkv, g, s, t = p.shape
    return torch.matmul(p.reshape(b, hkv, g * s, t), vf) \
        .view(b, hkv, g, s, -1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, chunk: int = 512,
                    q_offset: int = 0) -> torch.Tensor:
    """Blockwise attention with an online softmax over `chunk`-position K/V
    blocks (the JAX package's forward, `_attn_fwd_impl`): no (S, T) score
    matrix beyond one block. Queries sit at positions q_offset..; causal
    masks t > q position, window masks t <= q position - window.
    Differentiable in q, k and v (`_FlashAttention`)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, chunk, q_offset)
    return _attn_fwd(q, k, v, causal, window, chunk, q_offset)[0]


def _attn_fwd(q, k, v, causal, window, chunk, q_offset):
    """(out (B, S, Hq, d) in q's dtype, lse (B, Hkv, G, S) float32)."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    dt = q.dtype
    qf = _heads((q.to(_F32) * _scale(d)).to(dt), hkv).to(_F32)
    kc = k.transpose(1, 2)                                   # (B, Hkv, T, d)
    vc = v.transpose(1, 2)
    qpos = torch.arange(s, device=q.device) + q_offset
    g = hq // hkv
    m_run = torch.full((b, hkv, g, s), NEG_INF, dtype=_F32, device=q.device)
    l_run = torch.zeros((b, hkv, g, s), dtype=_F32, device=q.device)
    acc = torch.zeros((b, hkv, g, s, d), dtype=_F32, device=q.device)
    for lo in range(0, t, chunk):
        kj = kc[:, :, lo:lo + chunk].to(_F32)                # (B, Hkv, C, d)
        vj = vc[:, :, lo:lo + chunk].to(_F32)
        kpos = torch.arange(lo, lo + kj.shape[2], device=q.device)
        valid = _chunk_mask(qpos, kpos, causal, window)
        sc = _dots(qf, kj)
        sc = torch.where(valid, sc, NEG_INF)
        m_new = torch.maximum(m_run, sc.amax(-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(sc - m_new[..., None])
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _pv(p.to(dt).to(_F32), vj)
        m_run = m_new
    l_safe = torch.where(l_run > 0, l_run, 1.0)
    return (_merge(acc / l_safe[..., None]).to(q.dtype),
            m_run + torch.log(l_safe))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, q_offset):
        out, lse = _attn_fwd(q, k, v, causal, window, chunk, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, chunk, q_offset = ctx.args
        b, s, hq, d = q.shape
        t, hkv = k.shape[1], k.shape[2]
        dt, scale = q.dtype, _scale(d)
        qf = _heads(q, hkv).to(_F32)                         # (B,Hkv,G,S,d)
        do = _heads(dout.to(dt), hkv).to(_F32)
        delta = (do * _heads(out, hkv).to(_F32)).sum(-1)     # (B,Hkv,G,S)
        kc, vc = k.transpose(1, 2), v.transpose(1, 2)        # (B, Hkv, T, d)
        qpos = torch.arange(s, device=q.device) + q_offset
        g = hq // hkv
        dq = torch.zeros((b, hkv, g, s, d), dtype=_F32, device=q.device)
        dks, dvs = [], []
        for lo in range(0, t, chunk):
            kj = kc[:, :, lo:lo + chunk].to(_F32)            # (B, Hkv, C, d)
            vj = vc[:, :, lo:lo + chunk].to(_F32)
            c = kj.shape[2]
            kpos = torch.arange(lo, lo + c, device=q.device)
            valid = _chunk_mask(qpos, kpos, causal, window)
            sc = _dots(qf, kj) * scale
            p = torch.where(valid, torch.exp(sc - lse[..., None]), 0.0)
            pb = p.to(dt).to(_F32).reshape(b, hkv, g * s, c)
            dv_j = torch.matmul(pb.transpose(-1, -2),
                                do.reshape(b, hkv, g * s, d))
            dp = _dots(do, vj)
            ds = (p * (dp - delta[..., None])).to(dt).to(_F32)
            dq = dq + _pv(ds, kj) * scale
            dk_j = torch.matmul(ds.reshape(b, hkv, g * s, c).transpose(-1, -2),
                                qf.reshape(b, hkv, g * s, d)) * scale
            dks.append(dk_j)
            dvs.append(dv_j)
        dk = torch.cat(dks, 2).transpose(1, 2).to(k.dtype)
        dv = torch.cat(dvs, 2).transpose(1, 2).to(v.dtype)
        return _merge(dq).to(q.dtype), dk, dv, None, None, None, None


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """Naive O(S*T) attention in float32: the oracle of `flash_attention`."""
    s, d, hkv, t = q.shape[1], q.shape[3], k.shape[2], k.shape[1]
    qf = _heads(q.to(_F32), hkv)
    kf = k.to(_F32).transpose(1, 2)                          # (B, Hkv, T, d)
    vf = v.to(_F32).transpose(1, 2)
    sc = _dots(qf, kf) * _scale(d)
    qpos = torch.arange(s, device=q.device) + q_offset
    m = _chunk_mask(qpos, torch.arange(t, device=q.device), causal, window)
    p = torch.softmax(torch.where(m, sc, NEG_INF), dim=-1)
    return _merge(_pv(p, vf)).to(q.dtype)


def masked_chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Float multi-query attention with an explicit (B, S, T) validity mask,
    float32 throughout. q: (B, S, Hq, d); caches: (B, T, Hkv, d)."""
    d, hkv = q.shape[3], k_cache.shape[2]
    qf = _heads(q.to(_F32), hkv)                             # (B,Hkv,G,S,d)
    kf = k_cache.to(_F32).transpose(1, 2)                    # (B, Hkv, T, d)
    vf = v_cache.to(_F32).transpose(1, 2)
    sc = _dots(qf, kf) * _scale(d)
    sc = torch.where(valid[:, None, None], sc, NEG_INF)      # (B,Hkv,G,S,T)
    p = torch.softmax(sc, dim=-1)
    return _merge(_pv(p, vf)).to(q.dtype)


def chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, kv_len, q_pos, *, window: int = 0,
                    causal: bool = True) -> torch.Tensor:
    """Chunked-prefill attention against a float cache: S queries at
    positions q_pos..q_pos+S-1 against (B, T, Hkv, d) caches holding the
    chunk's own rows; masks t >= kv_len, the causal triangle and the
    window. kv_len, q_pos: int or (B,)."""
    b, t = k_cache.shape[0], k_cache.shape[1]
    valid = chunk_valid_mask(b, q.shape[1], t, kv_len, q_pos, window, causal,
                             device=q.device)
    return masked_chunk_attention(q, k_cache, v_cache, valid)


def chunk_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          kv_len, q_pos, *, window: int = 0,
                          causal: bool = True) -> torch.Tensor:
    """`chunk_attention` against a paged float cache: the slot's pages
    gathered into the contiguous panel, then the contiguous op sequence
    (paging never changes numerics). Pools: (P, ps, Hkv, d); page_table:
    (B, NP) int32, P the unallocated sentinel."""
    return chunk_attention(q, gather_pages(k_pool, page_table),
                           gather_pages(v_pool, page_table), kv_len, q_pos,
                           window=window, causal=causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int = 0) -> torch.Tensor:
    """One query row per batch row against a float cache. q: (B, 1, Hq, d);
    caches: (B, T, Hkv, d); cache_len: int or (B,) valid positions (the new
    row already written at cache_len - 1); window > 0 keeps the last
    `window` positions."""
    b, t, hkv, d = k_cache.shape
    qf = _heads(q.to(_F32), hkv)                             # (B,Hkv,G,1,d)
    kf = k_cache.to(_F32).transpose(1, 2)                    # (B, Hkv, T, d)
    vf = v_cache.to(_F32).transpose(1, 2)
    sc = _dots(qf, kf) * _scale(d)
    pos = torch.arange(t, device=q.device)
    length = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < length                            # (B or 1, T)
    if window > 0:
        valid = valid & (pos[None, :] >= length - window)
    sc = torch.where(valid[:, None, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return _merge(_pv(p, vf)).to(q.dtype)


def decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           cache_len, *, window: int = 0) -> torch.Tensor:
    """`decode_attention` against a paged float cache (gather, then the
    contiguous op sequence)."""
    return decode_attention(q, gather_pages(k_pool, page_table),
                            gather_pages(v_pool, page_table), cache_len,
                            window=window)
