"""Decode attention over a bit-resident KV cache: the hand-written Hopper
kernel, its plain PyTorch version, and the wrapper (port of
`repro.kernels.decode_attention`).

With `kv_bits=1` the cache holds K and V as sign bitplanes packed along
head_dim, (B, T, Hkv, ceil(hd/32)) int32 words, plus one float32 V scale per
(batch row, KV head). `decode_attention_packed` scores the sign-packed query
against every K row by XOR+popcount, masks by each row's cache length (and
window), takes an fp32 softmax and accumulates the +-1 V rows under it,
scaled by `v_scale` (semantics: `ref.decode_attention_packed_ref`). Replaces
the TPU kernel `decode_attention_packed`
(src/repro/kernels/decode_attention.py:137). On CUDA tensors it launches the
kernel of `csrc/attention.cu`, or raises; it runs the plain version only
because its inputs lie on the CPU. There is no route table: the device
decides. `launches["decode_attention_packed"]` counts kernel launches.

`decode_attention_packed_paged` is its paged twin (replaces
src/repro/kernels/decode_attention.py:214): K/V rows live in a (P, ps, Hkv,
ceil(hd/32)) pool shared by every slot, addressed through a (B, NP) page
table whose entries equal to P mark unallocated pages. The kernel reads the
pool in place through the table (the same kernel body, templated on the
layout); its plain version gathers the table's rows (`ref.gather_pages`)
and runs the contiguous plain version.
`launches["decode_attention_packed_paged"]` counts its launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitpack import packed_width
from repro_torch.kernels import _build, ref

launches = {"decode_attention_packed": 0, "decode_attention_packed_paged": 0}
_Q_BF16 = {torch.float32: 0, torch.bfloat16: 1}
# shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT = 232448


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def v_cache_scale(v: torch.Tensor) -> torch.Tensor:
    """Per-(row, kv-head) V magnitude for a packed cache: mean |v| over
    (positions, head_dim) of a (B, S, Hkv, hd) float V, in float32."""
    return v.to(torch.float32).abs().mean(dim=(1, 3))


def smem_bytes(rows: int, t: int, hd: int) -> int:
    """Shared memory of one attention block holding `rows` query rows:
    their packed words, their (rows, T) score panel and their sums."""
    return rows * (packed_width(hd) + t + 1) * 4


def check_operands(q: torch.Tensor, k_packed: torch.Tensor,
                   v_packed: torch.Tensor, v_scale: torch.Tensor,
                   page_table: torch.Tensor | None = None) -> None:
    """Raise unless q (B, S, Hkv*G, hd) float32|bf16, K/V (B, T, Hkv,
    ceil(hd/32)) int32 and v_scale (B, Hkv) float32 agree, lie on one
    device and are contiguous. With a `page_table`, K/V are (P, ps, Hkv,
    ceil(hd/32)) pools and the table is (B, NP) int32."""
    if q.dtype not in _Q_BF16 or q.ndim != 4:
        raise TypeError(f"q must be (B, S, Hq, hd) float32 or bfloat16, got "
                        f"{q.dtype} {tuple(q.shape)}")
    b, _, hq, hd = q.shape
    if k_packed.ndim != 4:
        raise ValueError(f"K must be 4-D words, got {tuple(k_packed.shape)}")
    hkv = k_packed.shape[2]
    lead = (b, k_packed.shape[1]) if page_table is None \
        else tuple(k_packed.shape[:2])
    want = lead + (hkv, packed_width(hd))
    for name, c in (("K", k_packed), ("V", v_packed)):
        if c.dtype != torch.int32 or tuple(c.shape) != want:
            raise ValueError(f"{name} must be {want} int32 words, got "
                             f"{c.dtype} {tuple(c.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    if v_scale.dtype != torch.float32 or tuple(v_scale.shape) != (b, hkv):
        raise ValueError(f"v_scale must be ({b}, {hkv}) float32, got "
                         f"{v_scale.dtype} {tuple(v_scale.shape)}")
    tensors = [q, k_packed, v_packed, v_scale]
    if page_table is not None:
        if page_table.dtype != torch.int32 or page_table.ndim != 2 \
                or page_table.shape[0] != b:
            raise ValueError(f"page_table must be ({b}, NP) int32, got "
                             f"{page_table.dtype} {tuple(page_table.shape)}")
        tensors.append(page_table)
    for x in tensors[1:]:
        if x.device != q.device:
            raise ValueError(f"operands on {q.device} and {x.device}")
    for x in tensors:
        if not x.is_contiguous():
            raise ValueError("operands must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")


def row_lengths(x, b: int, device) -> torch.Tensor:
    """int or (B,) tensor -> (B,) int32 contiguous on `device` (no host
    sync for a tensor already there)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(-1) \
            .expand(b).contiguous()
    return torch.full((b,), int(x), dtype=torch.int32, device=device)


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
                            return_dots: bool = False):
    """Single-token decode attention against a bit-resident KV cache.

    q: (B, 1, Hq, hd) float32 | bf16 (sign-packed in the kernel);
    k_packed, v_packed: (B, T, Hkv, ceil(hd/32)) int32 words (pad bits 1);
    v_scale: (B, Hkv) float32; cache_len: int or (B,) valid positions (the
    new token already written at cache_len-1). Masks positions >= cache_len
    and, when window > 0, positions < cache_len - window; a row with
    cache_len 0 outputs 0. Returns (B, 1, Hq, hd) in q.dtype, and with
    `return_dots` also the kernel's (B, Hkv, G, T) int32 score dots."""
    check_operands(q, k_packed, v_packed, v_scale)
    if q.shape[1] != 1:
        raise ValueError(f"decode takes one query row, got S={q.shape[1]}")
    if q.device.type == "cpu":
        return decode_attention_packed_plain(q, k_packed, v_packed, v_scale,
                                             cache_len, window=window,
                                             return_dots=return_dots)
    b, t, hkv, _ = k_packed.shape
    hd = q.shape[-1]
    g = q.shape[2] // hkv
    if smem_bytes(g, t, hd) > SMEM_LIMIT:
        raise ValueError(f"a (G={g}, T={t}) score panel does not fit one "
                         "block's shared memory (the decode body keeps one)")
    lens = row_lengths(cache_len, b, q.device)
    out = torch.empty_like(q)
    dots = (torch.empty((b, hkv, g, t), dtype=torch.int32, device=q.device)
            if return_dots else None)
    fn = _build.library("attention").decode_attention_packed
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check("attention", fn(
        q.data_ptr(), _Q_BF16[q.dtype], k_packed.data_ptr(),
        v_packed.data_ptr(), v_scale.data_ptr(), lens.data_ptr(),
        out.data_ptr(), None if dots is None else dots.data_ptr(),
        b, t, hkv, g, hd, int(window), 1.0 / float(hd) ** 0.5, stream),
        "decode_attention_packed")
    launches["decode_attention_packed"] += 1
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
                                  window: int = 0, return_dots: bool = False):
    """Single-token decode attention against a paged bit-resident cache.

    q: (B, 1, Hq, hd) float32 | bf16; k_pool, v_pool: (P, ps, Hkv,
    ceil(hd/32)) int32 pools shared by every slot; page_table: (B, NP)
    int32, entry i of row b the page holding positions [i*ps, (i+1)*ps)
    (P: unallocated, clipped to page P-1 and masked by the length);
    v_scale: (B, Hkv) float32; cache_len: int or (B,). Returns (B, 1, Hq,
    hd) in q.dtype, and with `return_dots` the (B, Hkv, G, NP*ps) int32
    dots: those of `decode_attention_packed` on the gathered panel."""
    check_operands(q, k_pool, v_pool, v_scale, page_table)
    if q.shape[1] != 1:
        raise ValueError(f"decode takes one query row, got S={q.shape[1]}")
    if q.device.type == "cpu":
        return decode_attention_packed_paged_plain(
            q, k_pool, v_pool, v_scale, page_table, cache_len, window=window,
            return_dots=return_dots)
    pool, ps, hkv, _ = k_pool.shape
    b, n_pages = page_table.shape
    t = n_pages * ps
    hd = q.shape[-1]
    g = q.shape[2] // hkv
    if smem_bytes(g, t, hd) > SMEM_LIMIT:
        raise ValueError(f"a (G={g}, T={t}) score panel does not fit one "
                         "block's shared memory (the decode body keeps one)")
    lens = row_lengths(cache_len, b, q.device)
    out = torch.empty_like(q)
    dots = (torch.empty((b, hkv, g, t), dtype=torch.int32, device=q.device)
            if return_dots else None)
    fn = _build.library("attention").decode_attention_packed_paged
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check("attention", fn(
        q.data_ptr(), _Q_BF16[q.dtype], k_pool.data_ptr(), v_pool.data_ptr(),
        v_scale.data_ptr(), page_table.data_ptr(), lens.data_ptr(),
        out.data_ptr(), None if dots is None else dots.data_ptr(),
        b, n_pages, ps, pool, hkv, g, hd, int(window),
        1.0 / float(hd) ** 0.5, stream), "decode_attention_packed_paged")
    launches["decode_attention_packed_paged"] += 1
    return (out, dots) if return_dots else out
