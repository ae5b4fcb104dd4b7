"""Sign-pack: the hand-written Hopper kernel, its plain PyTorch version, and
the wrappers (port of `repro.kernels.pack`).

`pack_bits_kernel(x)` turns a float32 or bf16 (..., K) tensor into its
(..., ceil(K/32)) int32 wire-format words (bit = x >= 0, little-endian, pad
bits 1; `core.bitpack`). Replaces the TPU kernel `pack_bits_kernel`
(src/repro/kernels/pack.py:35).

`pack_rows_into(srcs, dst_pools, dst_rows)` packs the new K and V rows of
a step and stores their words at their cache rows in the same launch: the
JAX package's `kc.at[rows, wpos].set(pack_bits(k), mode="drop")`
(src/repro/models/transformer.py:496-528, :640-671) as one kernel, with no
gather, where or index_put after it.

On CUDA tensors both launch the kernels of `csrc/pack.cu`, or raise (a
layout the kernel cannot read included: nothing is copied quietly); they
run the plain versions only because their inputs lie on the CPU.
`launches["pack_bits"]` counts launches of either entry.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.bitpack import pack_bits, packed_width
from repro_torch.kernels import _build

launches = {"pack_bits": 0}
_X_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_entries: dict = {}       # C entry name -> ctypes function, resolved once


def reset_launches() -> None:
    launches["pack_bits"] = 0


def _entry(name: str):
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(_build.library("pack"), name)
    return fn


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on CUDA tensor t's device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check_src(x: torch.Tensor, what: str) -> None:
    if x.dtype not in _X_BF16:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no pack kernel for device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{what}: the kernel reads contiguous rows; got "
                         f"strides {x.stride()} for shape {tuple(x.shape)}")


def pack_bits_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (`core.bitpack.pack_bits`)."""
    return pack_bits(x)


def pack_bits_kernel(x: torch.Tensor) -> torch.Tensor:
    """(..., K) float32 | bf16 -> (..., ceil(K/32)) int32 words, pad bits 1;
    -0.0 packs to 1, NaN to 0. A CUDA input must be contiguous."""
    _check_src(x, "pack_bits_kernel")
    if x.device.type == "cpu":
        return pack_bits_plain(x)
    k = x.shape[-1]
    out = torch.empty(x.shape[:-1] + (packed_width(k),), dtype=torch.int32,
                      device=x.device)
    m = x.numel() // k if k else 0
    if m and k:
        code = _entry("pack_bits")(x.data_ptr(), _X_BF16[x.dtype],
                                   out.data_ptr(), m, k, _stream(x))
        if code:
            _build.check("pack", code, "pack_bits")
        _build.count(launches, "pack_bits")
    return out


def _rows_geometry(srcs, dst_pools, dst_rows):
    """Check the operands of `pack_rows_into`; returns (per, K, pool rows):
    each source is (n, ..., K), its middle dims `per` sub-rows of K values,
    and each destination a pool of `pool rows` rows of per * ceil(K/32)
    words."""
    if not 1 <= len(srcs) <= 2 or len(dst_pools) != len(srcs):
        raise ValueError("pack_rows_into takes one or two sources, one "
                         "destination each")
    x0 = srcs[0]
    for x in srcs:
        _check_src(x, "pack_rows_into")
        if x.shape != x0.shape or x.dtype != x0.dtype or \
                x.device != x0.device:
            raise ValueError("pack_rows_into's sources must agree in shape, "
                             "dtype and device")
    if x0.ndim < 2:
        raise ValueError(f"sources are (n, ..., K), got {tuple(x0.shape)}")
    n, k = x0.shape[0], x0.shape[-1]
    per = math.prod(x0.shape[1:-1])
    if dst_rows.dtype != torch.int64 or tuple(dst_rows.shape) != (n,) or \
            dst_rows.device != x0.device:
        raise ValueError(f"dst_rows must be ({n},) int64 on {x0.device}, got "
                         f"{dst_rows.dtype} {tuple(dst_rows.shape)} on "
                         f"{dst_rows.device}")
    width = per * packed_width(k)
    rows = None
    for dst in dst_pools:
        if dst.dtype != torch.int32 or dst.device != x0.device:
            raise ValueError(f"destinations must be int32 on {x0.device}")
        if not dst.is_contiguous() or not width or dst.numel() % width:
            raise ValueError(f"a destination must be contiguous rows of "
                             f"{width} words, got shape {tuple(dst.shape)}")
        if rows is None:
            rows = dst.numel() // width
        elif dst.numel() // width != rows:
            raise ValueError("the destinations must hold equal rows")
    return per, k, rows


def pack_rows_into_plain(srcs, dst_pools, dst_rows) -> None:
    """The kernel's arithmetic in plain PyTorch: `core.bitpack.pack_bits`
    then an indexed store of the rows whose destination lies in the pool."""
    for x, dst in zip(srcs, dst_pools):
        words = pack_bits(x).reshape(x.shape[0], -1)
        flat = dst.view(-1, words.shape[1])
        keep = (dst_rows >= 0) & (dst_rows < flat.shape[0])
        flat[dst_rows[keep]] = words[keep]


def pack_rows_into(srcs, dst_pools, dst_rows: torch.Tensor) -> None:
    """Pack rows and store their words at their destination rows, in place.

    srcs: one or two float32 | bf16 tensors of one shape (n, ..., K) (the
    new K rows and V rows); dst_pools: one int32 tensor per source, seen as
    (rows, ..., ceil(K/32)) words with the source's middle dims (a cache's
    (B, T, Hkv, hdw) panel or a paged pool seen with its sink page);
    dst_rows: (n,) int64, source row i's row in that view. A row whose
    destination lies outside [0, rows) is dropped (-1: write nothing), as
    JAX's mode="drop". Distinct in-range destinations are the caller's to
    give (two rows to one place race). Both sources in one launch."""
    srcs, dst_pools = tuple(srcs), tuple(dst_pools)
    per, k, rows = _rows_geometry(srcs, dst_pools, dst_rows)
    x0 = srcs[0]
    if x0.device.type == "cpu":
        return pack_rows_into_plain(srcs, dst_pools, dst_rows)
    n = x0.shape[0]
    if not (n and per and k):
        return None
    two = len(srcs) == 2
    code = _entry("pack_rows_into")(
        x0.data_ptr(), srcs[1].data_ptr() if two else None, _X_BF16[x0.dtype],
        dst_pools[0].data_ptr(), dst_pools[1].data_ptr() if two else None,
        dst_rows.data_ptr(), n, per, k, rows, _stream(x0))
    if code:
        _build.check("pack", code, "pack_rows_into")
    _build.count(launches, "pack_bits")
    return None
