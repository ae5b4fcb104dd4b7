"""Chunked-prefill attention over a bit-resident KV cache: the hand-written
Hopper kernel, its plain PyTorch version, and the wrapper (port of
`repro.kernels.prefill_attention`).

A chunk of S float queries at global positions q_pos..q_pos+S-1 scores
against the packed cache, the chunk's own K/V rows already written, with the
causal triangle t <= q_pos+i, the window and each row's kv_len fused into
the mask (semantics: `ref.prefill_attention_packed_ref`; with S == 1 and
q_pos == kv_len - 1 it is decode attention). Replaces the TPU kernel
`prefill_attention_packed` (src/repro/kernels/prefill_attention.py:131). On
CUDA tensors it launches the kernel of `csrc/attention.cu`, or raises; it
runs the plain version only because its inputs lie on the CPU.
`launches["prefill_attention_packed"]` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.decode_attention import (
    SMEM_LIMIT, _Q_BF16, check_operands, row_lengths, smem_bytes,
)

launches = {"prefill_attention_packed": 0}
# query rows (chunk rows x grouped heads) one block takes at most
_MAX_ROWS = 32


def reset_launches() -> None:
    launches["prefill_attention_packed"] = 0


def block_rows(s: int, g: int, t: int, hd: int) -> int:
    """Chunk rows per block: as many as keep bq*G <= 32 query rows and the
    block's score panel inside shared memory."""
    bq = max(1, min(s, _MAX_ROWS // g))
    while bq > 1 and smem_bytes(bq * g, t, hd) > SMEM_LIMIT:
        bq //= 2
    if smem_bytes(bq * g, t, hd) > SMEM_LIMIT:
        raise ValueError(f"a (G={g}, T={t}) score panel does not fit one "
                         "block's shared memory (no T-tiled kernel yet)")
    return bq


def prefill_attention_packed_plain(q, k_packed, v_packed, v_scale, kv_len,
                                   q_pos, *, window: int = 0,
                                   causal: bool = True,
                                   return_dots: bool = False):
    """The kernel's arithmetic in plain PyTorch (`ref`); with `return_dots`
    also its (B, Hkv, S, G, T) int32 score dots."""
    out = ref.prefill_attention_packed_ref(q, k_packed, v_packed, v_scale,
                                           kv_len, q_pos, window=window,
                                           causal=causal)
    if not return_dots:
        return out
    return out, ref.packed_attention_dots(q, k_packed)


def prefill_attention_packed(q: torch.Tensor, k_packed: torch.Tensor,
                             v_packed: torch.Tensor, v_scale: torch.Tensor,
                             kv_len, q_pos, *, window: int = 0,
                             causal: bool = True, return_dots: bool = False):
    """Chunked-prefill attention against a bit-resident KV cache.

    q: (B, S, Hq, hd) float32 | bf16 query chunk (sign-packed in the
    kernel); k_packed, v_packed: (B, T, Hkv, ceil(hd/32)) int32 words;
    v_scale: (B, Hkv) float32; kv_len: int or (B,) valid cache positions
    (the chunk's rows included); q_pos: int or (B,) global position of
    q[:, 0]. Masks t >= kv_len, t > q_pos + i (when `causal`) and, when
    window > 0, t <= q_pos + i - window. Returns (B, S, Hq, hd) in q.dtype,
    and with `return_dots` also the (B, Hkv, S, G, T) int32 score dots."""
    check_operands(q, k_packed, v_packed, v_scale)
    if q.device.type == "cpu":
        return prefill_attention_packed_plain(
            q, k_packed, v_packed, v_scale, kv_len, q_pos, window=window,
            causal=causal, return_dots=return_dots)
    b, t, hkv, _ = k_packed.shape
    s, hd = q.shape[1], q.shape[-1]
    g = q.shape[2] // hkv
    bq = block_rows(s, g, t, hd)
    # scalar lengths and positions go by value: no tensor to copy per chunk
    lens = row_lengths(kv_len, b, q.device) \
        if isinstance(kv_len, torch.Tensor) else None
    qpos = row_lengths(q_pos, b, q.device) \
        if isinstance(q_pos, torch.Tensor) else None
    out = torch.empty_like(q)
    dots = (torch.empty((b, hkv, s, g, t), dtype=torch.int32, device=q.device)
            if return_dots else None)
    fn = _build.library("attention").prefill_attention_packed
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check("attention", fn(
        q.data_ptr(), _Q_BF16[q.dtype], k_packed.data_ptr(),
        v_packed.data_ptr(), v_scale.data_ptr(),
        None if lens is None else lens.data_ptr(),
        0 if lens is not None else int(kv_len),
        None if qpos is None else qpos.data_ptr(),
        0 if qpos is not None else int(q_pos),
        out.data_ptr(), None if dots is None else dots.data_ptr(),
        b, s, t, hkv, g, hd, bq, int(window), int(bool(causal)),
        1.0 / float(hd) ** 0.5, stream), "prefill_attention_packed")
    launches["prefill_attention_packed"] += 1
    return (out, dots) if return_dots else out
