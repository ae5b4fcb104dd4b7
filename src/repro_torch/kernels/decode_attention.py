"""Decode attention over a bit-resident KV cache: the wrappers of the
hand-written Hopper kernel, their plain PyTorch versions (port of
`repro.kernels.decode_attention`).

With `kv_bits=1` the cache holds K and V as sign bitplanes packed along
head_dim, (B, T, Hkv, ceil(hd/32)) int32 words, plus one float32 V scale per
(batch row, KV head). `decode_attention_packed` scores the sign-packed query
against every K row by XOR+popcount, masks by each row's cache length (and
window), takes an fp32 softmax and accumulates the +-1 V rows under it,
scaled by `v_scale` (semantics: `ref.decode_attention_packed_ref`). Replaces
the TPU kernel `decode_attention_packed`
(src/repro/kernels/decode_attention.py:137). On CUDA tensors it launches the
attention body of `csrc/attention.cu` on a one-row chunk at q_pos =
cache_len - 1 (the kernel reads that position from the length), with the
launch the route table gives its shape (`prefill_attention.routed_plan`:
a tuned `split`, else `attention_plan`'s), or raises; it runs the plain
version only because its inputs lie on the CPU. Any T is taken.
`launches["decode_attention_packed"]` counts kernel launches.

`decode_attention_packed_paged` is its paged twin (replaces
src/repro/kernels/decode_attention.py:214): K/V rows live in a (P, ps, Hkv,
ceil(hd/32)) pool shared by every slot, addressed through a (B, NP) page
table whose entries equal to P mark unallocated pages. The kernel reads the
pool in place through the table; its plain version gathers the table's rows
(`ref.gather_pages`) and runs the contiguous plain version.
`launches["decode_attention_packed_paged"]` counts its launches.
"""
from __future__ import annotations

import torch

from repro_torch._device import sm_count
from repro_torch.kernels import _build, ref, tune
from repro_torch.kernels.prefill_attention import (
    _Q_BF16, check_operands, routed_plan, row_lengths,
)

launches = {"decode_attention_packed": 0, "decode_attention_packed_paged": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def v_cache_scale(v: torch.Tensor) -> torch.Tensor:
    """Per-(row, kv-head) V magnitude for a packed cache: mean |v| over
    (positions, head_dim) of a (B, S, Hkv, hd) float V, in float32."""
    return v.to(torch.float32).abs().mean(dim=(1, 3))


def decode_attention_packed_plain(q, k_packed, v_packed, v_scale, cache_len,
                                  *, window: int = 0, return_dots: bool = False):
    """The kernel's arithmetic in plain PyTorch (`ref`); with `return_dots`
    also its (B, Hkv, G, T) int32 score dots."""
    out = ref.decode_attention_packed_ref(q, k_packed, v_packed, v_scale,
                                          cache_len, window=window)
    if not return_dots:
        return out
    return out, ref.packed_attention_dots(q, k_packed)[:, :, 0]


def decode_attention_packed(q: torch.Tensor, k_packed: torch.Tensor,
                            v_packed: torch.Tensor, v_scale: torch.Tensor,
                            cache_len, *, window: int = 0,
                            return_dots: bool = False,
                            route: str | None = None, **params):
    """Single-token decode attention against a bit-resident KV cache.

    q: (B, 1, Hq, hd) float32 | bf16 (sign-packed in the kernel);
    k_packed, v_packed: (B, T, Hkv, ceil(hd/32)) int32 words (pad bits 1);
    v_scale: (B, Hkv) float32; cache_len: int or (B,) valid positions (the
    new token already written at cache_len-1). Masks positions >= cache_len
    and, when window > 0, positions < cache_len - window; a row with
    cache_len 0 weighs all T positions alike, as the JAX oracle does
    (`ref.packed_masked_attention_ref`). Returns (B, 1, Hq, hd) in q.dtype,
    and with
    `return_dots` also the kernel's (B, Hkv, G, T) int32 score dots.
    route=None launches the route table's `split` for the shape
    (`tune.get_route('decode_attention', b, t, hkv, g, hd)`); an explicit
    route (+ `split`) bypasses it."""
    check_operands(q, k_packed, v_packed, v_scale)
    if q.shape[1] != 1:
        raise ValueError(f"decode takes one query row, got S={q.shape[1]}")
    if q.device.type == "cpu":
        tune.check_route("decode_attention", route)
        return decode_attention_packed_plain(q, k_packed, v_packed, v_scale,
                                             cache_len, window=window,
                                             return_dots=return_dots)
    b, t, hkv, _ = k_packed.shape
    hd = q.shape[-1]
    g = q.shape[2] // hkv
    plan = routed_plan("decode_attention", b, 1, t, hkv, g, hd,
                       sm_count(q.device), route, params)
    lens = row_lengths(cache_len, b, q.device)
    out = torch.empty_like(q)
    dots = (torch.empty((b, hkv, g, t), dtype=torch.int32, device=q.device)
            if return_dots else None)
    fn = _build.library("attention").decode_attention_packed
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check("attention", fn(
        q.data_ptr(), _Q_BF16[q.dtype], k_packed.data_ptr(),
        v_packed.data_ptr(), v_scale.data_ptr(),
        None if lens is None else lens.data_ptr(),
        0 if lens is not None else int(cache_len),
        out.data_ptr(), None if dots is None else dots.data_ptr(),
        b, t, hkv, g, hd, plan.split, int(window), 1.0 / float(hd) ** 0.5,
        stream), "decode_attention_packed")
    _build.count(launches, "decode_attention_packed")
    return (out, dots) if return_dots else out


def decode_attention_packed_paged_plain(q, k_pool, v_pool, v_scale,
                                        page_table, cache_len, *,
                                        window: int = 0,
                                        return_dots: bool = False):
    """The paged kernel's arithmetic in plain PyTorch: gather the table's
    rows (`ref.gather_pages`), then the contiguous plain version."""
    return decode_attention_packed_plain(
        q, ref.gather_pages(k_pool, page_table),
        ref.gather_pages(v_pool, page_table), v_scale, cache_len,
        window=window, return_dots=return_dots)


def decode_attention_packed_paged(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor, v_scale: torch.Tensor,
                                  page_table: torch.Tensor, cache_len, *,
                                  window: int = 0, return_dots: bool = False,
                                  route: str | None = None, **params):
    """Single-token decode attention against a paged bit-resident cache.

    q: (B, 1, Hq, hd) float32 | bf16; k_pool, v_pool: (P, ps, Hkv,
    ceil(hd/32)) int32 pools shared by every slot; page_table: (B, NP)
    int32, entry i of row b the page holding positions [i*ps, (i+1)*ps)
    (P: unallocated, clipped to page P-1 and masked by the length);
    v_scale: (B, Hkv) float32; cache_len: int or (B,). Returns (B, 1, Hq,
    hd) in q.dtype, and with `return_dots` the (B, Hkv, G, NP*ps) int32
    dots: those of `decode_attention_packed` on the gathered pages.
    Routes as `decode_attention_packed`'s, keyed also by ps and the pool's
    P ('decode_attention_paged')."""
    check_operands(q, k_pool, v_pool, v_scale, page_table)
    if q.shape[1] != 1:
        raise ValueError(f"decode takes one query row, got S={q.shape[1]}")
    if q.device.type == "cpu":
        tune.check_route("decode_attention_paged", route)
        return decode_attention_packed_paged_plain(
            q, k_pool, v_pool, v_scale, page_table, cache_len, window=window,
            return_dots=return_dots)
    pool, ps, hkv, _ = k_pool.shape
    b, n_pages = page_table.shape
    t = n_pages * ps
    hd = q.shape[-1]
    g = q.shape[2] // hkv
    plan = routed_plan("decode_attention_paged", b, 1, t, hkv, g, hd,
                       sm_count(q.device), route, params, ps, pool)
    lens = row_lengths(cache_len, b, q.device)
    out = torch.empty_like(q)
    dots = (torch.empty((b, hkv, g, t), dtype=torch.int32, device=q.device)
            if return_dots else None)
    fn = _build.library("attention").decode_attention_packed_paged
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check("attention", fn(
        q.data_ptr(), _Q_BF16[q.dtype], k_pool.data_ptr(), v_pool.data_ptr(),
        v_scale.data_ptr(), page_table.data_ptr(),
        None if lens is None else lens.data_ptr(),
        0 if lens is not None else int(cache_len),
        out.data_ptr(), None if dots is None else dots.data_ptr(),
        b, n_pages, ps, pool, hkv, g, hd, plan.split, int(window),
        1.0 / float(hd) ** 0.5, stream), "decode_attention_packed_paged")
    _build.count(launches, "decode_attention_packed_paged")
    return (out, dots) if return_dots else out
