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

`prefill_attention_packed_paged` is its paged twin (replaces
src/repro/kernels/prefill_attention.py:225): the same chunk against K/V
pools addressed through a page table (see
`decode_attention.decode_attention_packed_paged`).
`launches["prefill_attention_packed_paged"]` counts its launches.

All four attention wrappers (these and `decode_attention`'s) launch one
kernel body. It splits a block's positions over a thread-block cluster and
keeps no (rows, T) score panel, so any T is taken. `attention_plan` is the
fixed rule of its launch (chunk rows per block, split); `block_positions`
and `rank_positions` are the positions a block reads, as the kernel
computes them. The operand checks the wrappers share live here too.

Each wrapper takes `route=None, **params`, as the JAX package's entry
points do: `route=None` asks the route table (`kernels.tune.get_route`,
keyed by b, s, t, hkv, g, hd and, paged, ps and p) and launches its
entry's `split` and `block_rows` where `attention_plan`'s own checks hold
at the real shape (`plan_from_params`), else `attention_plan`; an explicit
route bypasses the table. `routed_plan` keeps the plan per exact call
shape.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch._device import sm_count
from repro_torch.core.bitpack import packed_width
from repro_torch.kernels import _build, ref, tune

launches = {"prefill_attention_packed": 0, "prefill_attention_packed_paged": 0}
_Q_BF16 = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's block: at most 32 query rows (chunk rows x grouped heads) and
# head_dim up to 256 (4 n8 tensor-core tiles per warp); a block of at most
# 8 rows (a decode step's G heads) takes the narrow body
_MAX_ROWS, _MAX_HD, _NARROW_ROWS = 32, 256, 8
# attention_plan's rule: the largest portable cluster; per body (narrow:
# True), the blocks an SM keeps resident (80 registers a thread, or 128)
# and the least table positions per block of a split (one 64-position
# tile, or 256)
_CLUSTER_MAX = 8
_RESIDENT = {True: 3, False: 2}
_MIN_SPLIT_POSITIONS = {True: 64, False: 256}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def row_lengths(x, b: int, device) -> torch.Tensor | None:
    """A (B,) tensor of lengths or positions -> (B,) int32 contiguous on
    `device` (no host sync for a tensor already there); an int -> None,
    for the kernel takes a scalar by value (no tensor to copy per call)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(-1) \
            .expand(b).contiguous()
    return None


@dataclass(frozen=True)
class AttentionPlan:
    """How one attention call runs: `bq` chunk rows per block (bq * G query
    rows), `split` blocks per cluster along T, `blocks` in the grid, and
    always one launch."""
    bq: int
    split: int
    blocks: int
    launches: int = 1


def block_rows(s: int, g: int, hd: int) -> int:
    """Chunk rows per block: as many as keep bq*G <= 32 query rows. Any T:
    the kernel keeps no score panel."""
    if g > _MAX_ROWS or hd > _MAX_HD:
        raise ValueError(f"no prefill kernel for G={g} query heads per KV "
                         f"head at hd={hd} (G <= {_MAX_ROWS}, hd <= "
                         f"{_MAX_HD})")
    return max(1, min(s, _MAX_ROWS // g))


def attention_plan(b: int, s: int, t: int, hkv: int, g: int, hd: int,
                   sms: int) -> AttentionPlan:
    """The fixed rule of a launch: `block_rows` chunk rows per block, then
    T split over a cluster, doubled (up to 8) while the doubled grid stays
    within one wave of resident blocks (2 per SM for the wide body, 3 for
    the narrow one of <= 8 query rows, a decode step's) and each block
    keeps at least 256 of the T table positions (narrow: 64). On the H100
    a second wave cost more than a shorter share saved (one 32-row phi3
    chunk, 40 blocks: split 8 twice as slow as 2), and a wide block's
    split pays only where its share's V sums outweigh the cluster's fixed
    costs (T 512: split 2 best; T 4,096: 4 to 8). A decode block's 4 rows
    cost little per position, so its split pays down to one tile a block
    (4 slots at T 512: split 8 0.0150 ms, 2 0.0191; T 4,096: 8 0.0338, 2
    0.1075; `chip_smoke.decode_split_sweep`)."""
    bq = block_rows(s, g, hd)
    narrow = bq * g <= _NARROW_ROWS
    base = b * hkv * -(-s // bq)
    split = 1
    while (split < _CLUSTER_MAX
           and 2 * base * split <= _RESIDENT[narrow] * sms
           and t >= 2 * split * _MIN_SPLIT_POSITIONS[narrow]):
        split *= 2
    return AttentionPlan(bq, split, base * split)


def plan_from_params(b: int, s: int, t: int, hkv: int, g: int, hd: int,
                     params: dict, *, clamp: bool = True
                     ) -> AttentionPlan | None:
    """The launch `params` (`split`, and `block_rows` for a chunk; a route
    table's fields) name, or None where the kernel cannot take them: a
    split of 1, 2, 4 or 8, at most 32 query rows a block (block_rows is cut
    to S, as `block_rows` cuts it). With `clamp` (a table entry, tuned at
    its bucket's shape) also `attention_plan`'s check that a split leaves
    each block at least its body's least positions (64 narrow, 256 wide).
    The fields of `attention_plan`'s plan give that plan."""
    split = int(params["split"])
    bq = min(int(params.get("block_rows", 1)), s)
    if split not in (1, 2, 4, 8) or bq < 1 or bq * g > _MAX_ROWS \
            or hd > _MAX_HD:
        return None
    if clamp and split > 1 and \
            t < split * _MIN_SPLIT_POSITIONS[bq * g <= _NARROW_ROWS]:
        return None
    return AttentionPlan(bq, split, b * hkv * -(-s // bq) * split)


def plan_params(plan: AttentionPlan, s: int) -> dict:
    """A plan's launch fields, as a route table holds them (a decode step
    has no block_rows)."""
    return {"split": plan.split} if s == 1 and plan.bq == 1 else \
        {"block_rows": plan.bq, "split": plan.split}


# the plan of each exact call shape that the wrappers have resolved:
# (table kernel, B, S, T, Hkv, G, hd, ps, P, SMs) -> AttentionPlan; `tune`
# empties it when the table or a route override changes
_ROUTED: dict[tuple, AttentionPlan] = {}
tune.PLAN_MEMOS.append(_ROUTED)


def routed_plan(kernel: str, b: int, s: int, t: int, hkv: int, g: int,
                hd: int, sms: int, route: str | None, params: dict,
                ps: int = 0, pool: int = 0) -> AttentionPlan:
    """The plan an attention wrapper launches for table kernel `kernel`
    ('decode_attention', 'prefill_attention' or a '_paged' twin): with
    `route` None the table's entry where `plan_from_params` takes it, else
    `attention_plan`; an explicit route bypasses the table ('cuda' with no
    params: `attention_plan`) and its params must name a launch the kernel
    takes. A route that names no kernel raises."""
    if route is None:
        key = (kernel, b, s, t, hkv, g, hd, ps, pool, sms)
        plan = _ROUTED.get(key)
        if plan is not None:
            return plan
        with tune.LOCK:           # a miss resolves under the current pins
            shape = dict(b=b, t=t, hkv=hkv, g=g, hd=hd)
            if kernel.startswith("prefill"):
                shape["s"] = s
            if ps:
                shape.update(ps=ps, p=pool)
            tune.note_dispatch(kernel, shape)
            route, params = tune.get_route(kernel, **shape)
            tune.check_card_route(kernel, route)
            plan = (params and plan_from_params(b, s, t, hkv, g, hd, params)) \
                or attention_plan(b, s, t, hkv, g, hd, sms)
            _ROUTED[key] = plan
        return plan
    tune.check_card_route(kernel, route)
    if not params:
        return attention_plan(b, s, t, hkv, g, hd, sms)
    plan = plan_from_params(b, s, t, hkv, g, hd, params, clamp=False)
    if plan is None:
        raise ValueError(f"{kernel} cannot launch {params} at B={b} S={s} "
                         f"T={t} G={g} hd={hd}")
    return plan


def block_positions(kv_len: int, q_pos: int, i0: int, i1: int, t: int, *,
                    window: int = 0, causal: bool = True) -> tuple[int, int]:
    """[lo, hi): the positions chunk rows [i0, i1) of one cache row can
    see, as the kernel bounds a block's reads: below kv_len and T, up to
    q_pos + i1 - 1 when causal, from q_pos + i0 - window + 1 with a
    window."""
    hi = min(t, kv_len)
    if causal:
        hi = min(hi, q_pos + i1)
    lo = max(0, q_pos + i0 - window + 1) if window > 0 else 0
    return lo, max(lo, hi)


def rank_positions(lo: int, hi: int, split: int, rank: int) -> tuple[int, int]:
    """Block `rank`'s share of [lo, hi): `split` contiguous shares."""
    per = -(-(hi - lo) // split)
    start = min(hi, lo + rank * per)
    return start, min(hi, start + per)


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
                             causal: bool = True, return_dots: bool = False,
                             route: str | None = None, **params):
    """Chunked-prefill attention against a bit-resident KV cache.

    q: (B, S, Hq, hd) float32 | bf16 query chunk (sign-packed in the
    kernel); k_packed, v_packed: (B, T, Hkv, ceil(hd/32)) int32 words;
    v_scale: (B, Hkv) float32; kv_len: int or (B,) valid cache positions
    (the chunk's rows included); q_pos: int or (B,) global position of
    q[:, 0]. Masks t >= kv_len, t > q_pos + i (when `causal`) and, when
    window > 0, t <= q_pos + i - window. Returns (B, S, Hq, hd) in q.dtype,
    and with `return_dots` also the (B, Hkv, S, G, T) int32 score dots.
    `route`, `params`: the launch (module docstring)."""
    check_operands(q, k_packed, v_packed, v_scale)
    if q.device.type == "cpu":
        tune.check_route("prefill_attention", route)
        return prefill_attention_packed_plain(
            q, k_packed, v_packed, v_scale, kv_len, q_pos, window=window,
            causal=causal, return_dots=return_dots)
    b, t, hkv, _ = k_packed.shape
    s, hd = q.shape[1], q.shape[-1]
    g = q.shape[2] // hkv
    plan = routed_plan("prefill_attention", b, s, t, hkv, g, hd,
                       sm_count(q.device), route, params)
    lens = row_lengths(kv_len, b, q.device)
    qpos = row_lengths(q_pos, b, q.device)
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
        b, s, t, hkv, g, hd, plan.bq, plan.split, int(window),
        int(bool(causal)), 1.0 / float(hd) ** 0.5, stream),
        "prefill_attention_packed")
    _build.count(launches, "prefill_attention_packed")
    return (out, dots) if return_dots else out


def prefill_attention_packed_paged_plain(q, k_pool, v_pool, v_scale,
                                         page_table, kv_len, q_pos, *,
                                         window: int = 0, causal: bool = True,
                                         return_dots: bool = False):
    """The paged kernel's arithmetic in plain PyTorch: gather the table's
    rows (`ref.gather_pages`), then the contiguous plain version."""
    return prefill_attention_packed_plain(
        q, ref.gather_pages(k_pool, page_table),
        ref.gather_pages(v_pool, page_table), v_scale, kv_len, q_pos,
        window=window, causal=causal, return_dots=return_dots)


def prefill_attention_packed_paged(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   v_scale: torch.Tensor,
                                   page_table: torch.Tensor, kv_len, q_pos, *,
                                   window: int = 0, causal: bool = True,
                                   return_dots: bool = False,
                                   route: str | None = None, **params):
    """Chunked-prefill attention against a paged bit-resident cache.

    q: (B, S, Hq, hd) float32 | bf16; k_pool, v_pool: (P, ps, Hkv,
    ceil(hd/32)) int32 pools; page_table: (B, NP) int32 (entries equal to
    P unallocated); v_scale, kv_len, q_pos, window, causal as in
    `prefill_attention_packed`, over T = NP*ps positions. Returns (B, S,
    Hq, hd) in q.dtype, and with `return_dots` the (B, Hkv, S, G, T) int32
    dots: those of the contiguous kernel on the gathered panel. `route`,
    `params`: the launch (module docstring)."""
    check_operands(q, k_pool, v_pool, v_scale, page_table)
    if q.device.type == "cpu":
        tune.check_route("prefill_attention_paged", route)
        return prefill_attention_packed_paged_plain(
            q, k_pool, v_pool, v_scale, page_table, kv_len, q_pos,
            window=window, causal=causal, return_dots=return_dots)
    pool, ps, hkv, _ = k_pool.shape
    b, n_pages = page_table.shape
    t = n_pages * ps
    s, hd = q.shape[1], q.shape[-1]
    g = q.shape[2] // hkv
    plan = routed_plan("prefill_attention_paged", b, s, t, hkv, g, hd,
                       sm_count(q.device), route, params, ps, pool)
    lens = row_lengths(kv_len, b, q.device)
    qpos = row_lengths(q_pos, b, q.device)
    out = torch.empty_like(q)
    dots = (torch.empty((b, hkv, s, g, t), dtype=torch.int32, device=q.device)
            if return_dots else None)
    fn = _build.library("attention").prefill_attention_packed_paged
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check("attention", fn(
        q.data_ptr(), _Q_BF16[q.dtype], k_pool.data_ptr(), v_pool.data_ptr(),
        v_scale.data_ptr(), page_table.data_ptr(),
        None if lens is None else lens.data_ptr(),
        0 if lens is not None else int(kv_len),
        None if qpos is None else qpos.data_ptr(),
        0 if qpos is not None else int(q_pos),
        out.data_ptr(), None if dots is None else dots.data_ptr(),
        b, s, n_pages, ps, pool, hkv, g, hd, plan.bq, plan.split,
        int(window), int(bool(causal)), 1.0 / float(hd) ** 0.5, stream),
        "prefill_attention_packed_paged")
    _build.count(launches, "prefill_attention_packed_paged")
    return (out, dots) if return_dots else out
