"""Tensor-parallel wrappers over the packed kernel dispatchers (port of
`repro.kernels.sharded`).

Each wrapper splits one kernel axis over a mesh axis and runs the port's
own dispatcher once per shard, on that shard's device (made current), at
the shard's *local* shape: on the card one kernel launch per shard, its
launch taken from the route table at the local shape (a shard owning
Hkv/4 heads is routed like a 4x-smaller kernel, which is what it is). The shards of a
mesh axis are the devices along it at index 0 of every other axis; the
wrapper returns the global value on the input's device.

Layout contract (the JAX package's, `launch.shardings.cache_shardings`):

  * GEMMs are column-parallel: the weight words (N, KW) split their
    output-feature axis N; the word axis KW is never split (a word is the
    kernels' indivisible popcount unit). The fused GEMM also needs each N
    shard to be a multiple of 32, so that the shards' output words
    concatenate into the unsharded wire format. A K split is not offered:
    the fused epilogue needs the complete integer dot.
  * Attention splits the Hkv axis: each shard owns Hkv/parts kv heads,
    their GQA query group (q heads are kv-major, so the split is a
    contiguous reshape) and their slice of `v_scale`; K/V words split Hkv
    and keep the word axis whole; the paged pools split Hkv the same way,
    while the page table is replicated.

Every wrapper returns its unsharded dispatcher's value bit for bit on the
CPU. On the card the integer dots and words are equal bit for bit; an
attention output is the same float sum, but the route table may give a
shard's local Hkv another T split than the global Hkv's, and the order of
the split's partial sums moves the last bits (pinned to one split, the
outputs are equal too).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch._device import on_device
from repro_torch.core.bitpack import WORD
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import prefill_attention as PA
from repro_torch.kernels.binary_gemm import (dispatch_binary_gemm,
                                             dispatch_binary_gemm_fused)
from repro_torch.launch.mesh import Mesh


class ShardGeometry(NamedTuple):
    """One tensor-parallel axis split: `dim` rows over `parts` devices."""
    dim: int
    parts: int
    local: int       # rows per device


@functools.lru_cache(maxsize=None)
def shard_geometry(dim: int, parts: int, *, name: str = "dim",
                   multiple: int = 1) -> ShardGeometry:
    """Validated geometry for splitting one kernel axis over a mesh axis:
    the split must be exact (`dim % parts == 0`) and each local extent a
    multiple of `multiple` (the fused GEMM's output words repack 32
    N-columns each). Raises ValueError otherwise."""
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    if dim % parts:
        raise ValueError(f"{name}={dim} does not divide over {parts} mesh "
                         f"devices")
    local = dim // parts
    if local % multiple:
        raise ValueError(f"{name} shard of {local} rows breaks the required "
                         f"multiple of {multiple} (dim={dim}, parts={parts})")
    return ShardGeometry(dim, parts, local)


def shard_devices(mesh: Mesh, axis: str) -> list[torch.device]:
    """The device of each shard along `axis` (index 0 of the other axes)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not one of the mesh's "
                         f"{mesh.axis_names}")
    return [mesh.device(**{axis: i}) for i in range(mesh.shape[axis])]


def _on(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x.to(dev).contiguous()


def _gather(outs, dim: int, device) -> torch.Tensor:
    """Concatenate the shards' outputs on `dim`, on `device`."""
    return torch.cat([o.to(device) for o in outs], dim=dim)


def binary_gemm_tp(a: torch.Tensor, b_packed: torch.Tensor, k_true: int, *,
                   mesh: Mesh, axis: str = "model", route: str | None = None,
                   **params) -> torch.Tensor:
    """Column-parallel `dispatch_binary_gemm`: b_packed (N, KW) split on N
    over `axis`, the lhs replicated; returns the (M, N) int32 dots."""
    devs = shard_devices(mesh, axis)
    g = shard_geometry(b_packed.shape[0], len(devs), name="n")
    outs = []
    for i, dev in enumerate(devs):
        with on_device(dev):
            outs.append(dispatch_binary_gemm(
                _on(a, dev), _on(b_packed[i * g.local:(i + 1) * g.local], dev),
                k_true, route=route, **params))
    return _gather(outs, 1, a.device)


def binary_gemm_fused_tp(a: torch.Tensor, b_packed: torch.Tensor,
                         thresh: torch.Tensor, flip: torch.Tensor,
                         k_true: int, *, mesh: Mesh, axis: str = "model",
                         route: str | None = None, **params) -> torch.Tensor:
    """Column-parallel fused GEMM: b_packed / thresh / flip split N over
    `axis` (each shard a multiple of 32), every shard runs the whole
    popcount + threshold + repack on its N slice, and the (M, ceil(N/32))
    output words concatenate along the word axis."""
    devs = shard_devices(mesh, axis)
    g = shard_geometry(b_packed.shape[0], len(devs), name="n", multiple=WORD)
    outs = []
    for i, dev in enumerate(devs):
        cols = slice(i * g.local, (i + 1) * g.local)
        with on_device(dev):
            outs.append(dispatch_binary_gemm_fused(
                _on(a, dev), _on(b_packed[cols], dev),
                _on(thresh[cols], dev), _on(flip[cols], dev), k_true,
                route=route, **params))
    return _gather(outs, 1, a.device)


def _head_shards(q: torch.Tensor, hkv: int, mesh: Mesh, axis: str):
    """(device, kv-head slice, q-head slice) of each shard along `axis`."""
    devs = shard_devices(mesh, axis)
    g = shard_geometry(hkv, len(devs), name="hkv")
    grp = q.shape[2] // hkv
    return [(dev, slice(i * g.local, (i + 1) * g.local),
             slice(i * g.local * grp, (i + 1) * g.local * grp))
            for i, dev in enumerate(devs)]


def _whole(x, dev):
    """A replicated operand (the page table, per-row lengths or positions):
    a tensor moves to the shard whole, an int stays an int."""
    return _on(x, dev) if isinstance(x, torch.Tensor) else x


def _attention_tp(kernel, q, k, v, v_scale, rest, kw, *, mesh, axis
                  ) -> torch.Tensor | tuple:
    """Run attention wrapper `kernel` once per Hkv shard: q heads, K / V
    (or pools) and v_scale cut by head, `rest` (the page table, lengths,
    positions) passed whole. Outputs join on the head axis, and with
    `return_dots` the (B, Hkv, ...) dots on theirs."""
    outs = []
    for dev, kv_heads, q_heads in _head_shards(q, k.shape[2], mesh, axis):
        with on_device(dev):
            outs.append(kernel(_on(q[:, :, q_heads], dev),
                               _on(k[:, :, kv_heads], dev),
                               _on(v[:, :, kv_heads], dev),
                               _on(v_scale[:, kv_heads], dev),
                               *(_whole(x, dev) for x in rest), **kw))
    if isinstance(outs[0], tuple):
        return (_gather([o[0] for o in outs], 2, q.device),
                _gather([o[1] for o in outs], 1, q.device))
    return _gather(outs, 2, q.device)


def decode_attention_packed_tp(q: torch.Tensor, k_packed: torch.Tensor,
                               v_packed: torch.Tensor, v_scale: torch.Tensor,
                               cache_len, *, mesh: Mesh, axis: str = "model",
                               **kw):
    """Hkv-split `decode_attention_packed`: each shard attends its own kv
    heads (all T, the word axis whole) for the whole batch. `kw`: the
    wrapper's window / return_dots / route / params."""
    return _attention_tp(DA.decode_attention_packed, q, k_packed, v_packed,
                         v_scale, (cache_len,), kw, mesh=mesh, axis=axis)


def decode_attention_packed_paged_tp(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     v_scale: torch.Tensor,
                                     page_table: torch.Tensor, cache_len, *,
                                     mesh: Mesh, axis: str = "model", **kw):
    """Paged twin: the pools (P, ps, Hkv, w) split Hkv, the page table is
    replicated (every shard walks the same table for its own heads)."""
    return _attention_tp(DA.decode_attention_packed_paged, q, k_pool, v_pool,
                         v_scale, (page_table, cache_len), kw, mesh=mesh,
                         axis=axis)


def prefill_attention_packed_tp(q: torch.Tensor, k_packed: torch.Tensor,
                                v_packed: torch.Tensor, v_scale: torch.Tensor,
                                kv_len, q_pos, *, mesh: Mesh,
                                axis: str = "model", **kw):
    """Hkv-split `prefill_attention_packed` (chunked prefill, S >= 1).
    `kw`: window / causal / return_dots / route / params."""
    return _attention_tp(PA.prefill_attention_packed, q, k_packed, v_packed,
                         v_scale, (kv_len, q_pos), kw, mesh=mesh, axis=axis)


def prefill_attention_packed_paged_tp(q: torch.Tensor, k_pool: torch.Tensor,
                                      v_pool: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      page_table: torch.Tensor, kv_len,
                                      q_pos, *, mesh: Mesh,
                                      axis: str = "model", **kw):
    """Paged twin of the prefill wrapper: pools split Hkv, table
    replicated."""
    return _attention_tp(PA.prefill_attention_packed_paged, q, k_pool,
                         v_pool, v_scale, (page_table, kv_len, q_pos), kw,
                         mesh=mesh, axis=axis)
