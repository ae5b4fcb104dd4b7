"""Binary GEMMs: hand-written Hopper kernels, their plain PyTorch versions,
and the dispatch the ops call (port of `repro.kernels.binary_gemm`).

  * `binary_gemm_packed` — packed (M, KW) lhs x packed (N, KW) rhs -> (M, N)
    int32 dots, or batched over a leading expert axis, (E, M, KW) x (E, N,
    KW) -> (E, M, N) in one launch (the MoE FFN's experts). Replaces the
    TPU kernel `binary_gemm_vpu`.
  * `binary_gemm_packed_rhs` — float32 or bf16 (M, K) lhs, signed inside
    the kernel, x packed rhs -> (M, N) int32. Replaces
    `binary_gemm_vpu_packed`.
  * `binary_gemm_fused` — packed or float lhs x packed rhs, with the
    bit-resident epilogue: bit_n = (dot_n >= thresh_n) XOR flip_n, repacked
    along N -> (M, ceil(N/32)) int32 words, pad bits 1. Replaces
    `binary_gemm_vpu_packed_io`.
  * `binary_gemm_mxu` — float32 or bf16 (M, K) x float32 (K, N) -> (M, N)
    float32 = sign(x) @ sign(w): the GEMM of the training path's binary
    convs. Replaces `binary_gemm_mxu`. A pass sign-packs w along K into the
    wire format once per call, then `binary_gemm_packed_rhs`'s kernels run x
    against those words with a float32 store (the dots are exact).

The kernels are CUDA C++ for sm_90a in `csrc/binary_gemm.cu`, with the
tensor-core tile code in `csrc/mma_tile.cuh`; the header says what bounds
the kernels and what the design does about it. Each wrapper runs one of
its kernels, chosen by `gemm_plan`, a fixed rule of M, N, K and the card's
SM count:

  * small M, packed lhs (`binary_gemm_packed` at M <= 32, the LM's q, K, V,
    gate and up at decode and chunk rows): a block copies the M rows of its
    K slice once and streams its channels' weight words past them into the
    single-bit tensor cores (AND-popcounts, no unpacking);
  * small M, float lhs (`binary_gemm_packed_rhs` and `binary_gemm_mxu` at
    M <= 32, the LM's wo, w_down and projections; `binary_gemm_fused` at M
    <= FUSED_SMALL_M_ROWS, nemotron's up-projection, with a packed lhs
    too): a block packs the M real rows of its K slice once and streams
    its channels' weight words past them (popcounts);
  * otherwise (the convs, the output layers, `binary_gemm_fused` past its
    small-M rows): int8 tensor-core tiles of 64 rows and 128 or 256
    channels, the packed words expanded to +-1 bytes in shared memory.

A batched call's grid holds E times a GEMM's blocks (the y axis is the
expert): the plan counts them all. Where any would launch too few blocks
for the card, K is split over a thread-block cluster and the partial dots
are summed through distributed shared memory, inside the same launch:
every call is one launch. There is no fallback: a launch that fails raises.

The dispatch entry points (`dispatch_binary_gemm{,_fused}`, which the ops
call) take each launch from the route table of `kernels.tune`, as the JAX
package's do: `route=None` asks `tune.get_route` for the call's shape, and
a table entry's `small_m`, `block_n` and `split` become the plan
(`plan_from_params`) where the fixed rule's own checks hold at the real
shape; where they do not, or the table has no entry, the call takes
`gemm_plan`. The plan is kept per exact call shape (`_ROUTED`), so a hit
costs one dict lookup. The wrappers called directly, the batched expert
GEMM and `binary_gemm_mxu` keep `gemm_plan`.

A wrapper launches its kernel on CUDA tensors, or raises; it runs the plain
version only because its inputs lie on the CPU. `launches[name]` counts the
wrapper's kernel launches, so a run can show that it went through them.
Words are int32 tensors holding the uint32 bits of the JAX package's wire
format.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch._device import sm_count
from repro_torch.core.bitpack import pack_bits, packed_width
from repro_torch.kernels import _build, ref, tune

launches = {"binary_gemm_packed": 0, "binary_gemm_packed_rhs": 0,
            "binary_gemm_fused": 0, "binary_gemm_mxu": 0}

# the plain versions reduce over (rows, N, KW) int64 temporaries; rows are
# taken in chunks of at most this many elements so a full-width layer fits
_PLAIN_CHUNK = 1 << 24
# float lhs types the kernels read, by the code the C interface takes (the
# sign of a bf16 activation is exact, so it is read as it is, not cast)
_LHS_KIND = {torch.float32: 1, torch.bfloat16: 2}
# gemm_plan's rule: the small-M kernels' rows and shared memory, the tensor-
# core tile and its K stage, the largest portable cluster, and the least K
# per block of a split (in 4-word groups, in tensor-core stages); the packed
# small-M kernel's channels per warp and K words per warp step
SMALL_M_ROWS = 32
# rows up to which kernel 3 runs the small-M kernel (its fused epilogue):
# on an H100 it beat the tiles at every M <= 16 of nemotron's up-projection
# (K 6,144, N 24,576: 0.0162 against 0.0962 ms at M = 4) and of K|N 4,096
# and 8,192|288; past 16 the tiles win at K|N 1,024, past 24 at nemotron's
FUSED_SMALL_M_ROWS = 16
_SMEM_BYTES = 227 * 1024
_TC_BM, _TC_BN, _TC_WIDE_BN, _TC_BK = 64, 128, 256, 128
_CLUSTER_MAX = 8
_MIN_SMALL_M_UNITS, _MIN_TC_STAGES = 8, 2
_PK_WARP_N, _PK_GROUP = 32, 16
# the kernels whose launch `gemm_plan` decides
PLANNED = ("binary_gemm_packed", "binary_gemm_packed_rhs", "binary_gemm_mxu",
           "binary_gemm_fused")


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclass(frozen=True)
class GemmPlan:
    """How one binary GEMM call runs: a small-M kernel or tensor-core
    tiles, `split` blocks per cluster along K, `block_n` channels per block,
    `blocks` in the grid, and always one launch."""
    small_m: bool
    split: int
    block_n: int
    blocks: int
    launches: int = 1


def _split(blocks: int, units: int, min_units: int, sms: int) -> int:
    """Blocks per cluster along K: doubled while the grid has fewer than
    1.5 blocks per SM and each block keeps at least `min_units` of K."""
    split = 1
    while (split < _CLUSTER_MAX and 2 * blocks * split < 3 * sms
           and units >= 2 * split * min_units):
        split *= 2
    return split


def _packed_lhs_stride(ks: int) -> int:
    """The packed small-M kernel's lhs row stride in shared memory (words):
    whole 16-word groups, 16 mod 32 (csrc/binary_gemm.cu)."""
    whole = -(-ks // _PK_GROUP) * _PK_GROUP
    return whole if whole % 32 == 16 else whole + 16


def gemm_plan(kernel: str, m: int, n: int, k: int, sms: int,
              aligned: bool = True, batch: int = 1) -> GemmPlan:
    """The fixed rule that picks each binary GEMM's kernel and its split.

    `binary_gemm_packed` at M <= SMALL_M_ROWS runs the packed small-M
    kernel where its operands are 16-byte aligned words (KW % 4 == 0,
    `aligned`: both operands' base) and the lhs slice fits in shared
    memory: the most channels per block (256, 128, 64 or 32) that still
    give every SM a block, and where even 32 do not, K split over a cluster
    (doubled while the grid has fewer blocks than half the SMs and each
    block keeps at least one 16-word group: a split adds a reduction
    through distributed shared memory, and on phi3's K|V 80 blocks beat
    160, `chip_smoke.py --gemm-scan-times`). Everything else runs the
    tensor-core tiles as kernel 2's dots do (below). A batched call
    (`batch` experts, kernel 1 only) counts the blocks of all its GEMMs:
    `blocks` is the whole grid.

    `binary_gemm_packed_rhs`, and `binary_gemm_mxu` against its signed w
    (the same kernels with a float32 store), at M <= SMALL_M_ROWS, and
    `binary_gemm_fused` (the same kernel with the threshold epilogue) at M
    <= FUSED_SMALL_M_ROWS, run the
    small-M kernel where the weight rows are 16-byte aligned words (KW % 4
    == 0, `aligned`) and the packed lhs slice fits in shared memory,
    with 32 channels per block, or 64 where N / 32 is at least 3 blocks per
    SM (fewer packs of the same lhs); everything else runs tensor-core tiles
    of 64 rows, 256 channels for the two where N > 128 and such tiles fill
    the card without a split (the float lhs read by half as many N tiles),
    else 128. Either splits K over a cluster (`_split`) where its blocks
    are fewer than 1.5 per SM."""
    if kernel not in PLANNED:
        raise ValueError(f"no plan for {kernel}")
    if batch != 1 and kernel != "binary_gemm_packed":
        raise ValueError(f"{kernel} has no batched entry")
    dots = kernel != "binary_gemm_fused"
    kw = packed_width(k)
    if kernel == "binary_gemm_packed":
        if m <= SMALL_M_ROWS and kw % 4 == 0 and aligned:
            block_n = next((bn for bn in (256, 128, 64)
                            if batch * -(-n // bn) >= sms), _PK_WARP_N)
            blocks = batch * -(-n // block_n)
            split, groups = 1, -(-kw // _PK_GROUP)
            while (split < _CLUSTER_MAX and 2 * blocks * split < sms
                   and groups >= 2 * split):
                split *= 2
            ks = -(-kw // (4 * split)) * 4
            if 4 * m * (_packed_lhs_stride(ks) + block_n) <= _SMEM_BYTES:
                return GemmPlan(True, split, block_n, blocks * split)
    elif (m <= (SMALL_M_ROWS if dots else FUSED_SMALL_M_ROWS)
          and kw % 4 == 0 and aligned):
        block_n = 64 if -(-n // 32) >= 3 * sms else 32
        blocks = -(-n // block_n)
        split = _split(blocks, kw // 4, _MIN_SMALL_M_UNITS, sms)
        ks = -(-kw // (4 * split)) * 4
        if 4 * m * (ks + block_n) <= _SMEM_BYTES:
            return GemmPlan(True, split, block_n, blocks * split)
    m_tiles = batch * -(-m // _TC_BM)
    wide = m_tiles * -(-n // _TC_WIDE_BN)
    if dots and n > _TC_BN and 2 * wide >= 3 * sms:
        return GemmPlan(False, 1, _TC_WIDE_BN, wide)
    tiles = m_tiles * -(-n // _TC_BN)
    split = _split(tiles, -(-k // _TC_BK), _MIN_TC_STAGES, sms)
    return GemmPlan(False, split, _TC_BN, tiles * split)


def _aligned(kernel: str, a: torch.Tensor, b: torch.Tensor) -> bool:
    return b.data_ptr() % 16 == 0 and (
        kernel != "binary_gemm_packed" or a.data_ptr() % 16 == 0)


def _plan(kernel: str, a: torch.Tensor, b: torch.Tensor, k: int) -> GemmPlan:
    """The plan of a call: a (M, ·) or (E, M, ·), b (N, KW) or (E, N, KW)."""
    batch = a.shape[0] if a.ndim == 3 else 1
    return gemm_plan(kernel, a.shape[-2], b.shape[-2], k, sm_count(a.device),
                     _aligned(kernel, a, b), batch)


def _k_shares(units: int, split: int) -> bool:
    """Every block of a `split` cluster keeps at least one of `units`."""
    return (split - 1) * -(-units // split) < units


def plan_from_params(kernel: str, m: int, n: int, k: int, sms: int,
                     aligned: bool, params: dict, *,
                     clamp: bool = True) -> GemmPlan | None:
    """The launch that `params` (`small_m`, `block_n`, `split`: a route
    table's fields) name for one call, or None where the kernel cannot take
    them at this shape: a split of 1, 2, 4 or 8 that leaves every block of
    the cluster some K (4-word units for the small-M kernels, tensor-core
    stages for the tiles); small-M only at M <= SMALL_M_ROWS on 16-byte
    aligned words (KW % 4 == 0) whose slice fits in shared memory, 32 to 256
    channels a block for kernel 1's and 32 or 64 for the float lhs's; tiles
    of 128 channels, or 256 for the dots without a split. With `clamp`
    (a table entry, tuned at its bucket's shape), kernel 3 takes the
    small-M kernel only at M <= FUSED_SMALL_M_ROWS, as `gemm_plan` does.
    The same fields as `gemm_plan`'s give `gemm_plan`'s plan."""
    if kernel not in PLANNED:
        raise ValueError(f"no plan for {kernel}")
    small_m, block_n, split = (bool(params["small_m"]), int(params["block_n"]),
                               int(params["split"]))
    if split not in (1, 2, 4, 8):
        return None
    kw = packed_width(k)
    dots = kernel != "binary_gemm_fused"
    if small_m:
        rows = SMALL_M_ROWS if dots or not clamp else FUSED_SMALL_M_ROWS
        widths = (32, 64, 128, 256) if kernel == "binary_gemm_packed" \
            else (32, 64)
        if (m > rows or kw % 4 or not aligned or block_n not in widths
                or not _k_shares(kw // 4, split)):
            return None
        ks = -(-kw // (4 * split)) * 4
        lhs = _packed_lhs_stride(ks) if kernel == "binary_gemm_packed" else ks
        if 4 * m * (lhs + block_n) > _SMEM_BYTES:
            return None
        return GemmPlan(True, split, block_n, -(-n // block_n) * split)
    if block_n not in (_TC_BN, _TC_WIDE_BN) or (
            block_n == _TC_WIDE_BN and (split != 1 or not dots)):
        return None
    if not _k_shares(-(-k // _TC_BK), split):
        return None
    return GemmPlan(False, split, block_n,
                    -(-m // _TC_BM) * -(-n // block_n) * split)


def plan_params(plan: GemmPlan) -> dict:
    """A plan's launch fields, as a route table holds them."""
    return {"small_m": int(plan.small_m), "block_n": plan.block_n,
            "split": plan.split}


# the plan of each exact call shape that dispatch has resolved: (kernel, M,
# N, K, aligned, SMs, lhs dtype) -> GemmPlan (kernel 3 takes both lhs forms,
# which the table keys apart); `tune` empties it when the table or a route
# override changes
_ROUTED: dict[tuple, GemmPlan] = {}
tune.PLAN_MEMOS.append(_ROUTED)
# the table's name of each kernel and the lhs form it is keyed by (pl)
_TABLE = {"binary_gemm_packed": ("binary_gemm", 1),
          "binary_gemm_packed_rhs": ("binary_gemm", 0),
          "binary_gemm_fused": ("binary_gemm_fused", None)}


def routed_plan(kernel: str, m: int, n: int, k: int, sms: int, aligned: bool,
                lhs: torch.dtype, route: str | None = None,
                params: dict | None = None) -> GemmPlan:
    """The plan dispatch launches: with `route` None, the route table's
    entry for the shape (`tune.get_route`; `pl` 1 for an int32 `lhs`, the
    packed words, else 0) where `plan_from_params` takes it, else
    `gemm_plan`; an explicit route bypasses the table, and its
    params must name a launch the kernel takes ('cuda' with no params:
    `gemm_plan`). A route that names no kernel ('xla', 'float', ...)
    raises: on the card every route is a kernel launch."""
    from repro_torch.kernels import tune
    if route is None:
        key = (kernel, m, n, k, aligned, sms, lhs)
        plan = _ROUTED.get(key)
        if plan is not None:
            return plan
        with tune.LOCK:           # a miss resolves under the current pins
            name, pl = _TABLE[kernel]
            shape = dict(m=m, n=n, kw=packed_width(k),
                         pl=int(lhs == torch.int32) if pl is None else pl)
            tune.note_dispatch(name, shape, lhs)
            route, params = tune.get_route(name, **shape)
            tune.check_card_route(name, route)
            plan = (params and plan_from_params(kernel, m, n, k, sms, aligned,
                                                params)) \
                or gemm_plan(kernel, m, n, k, sms, aligned)
            _ROUTED[key] = plan
        return plan
    tune.check_card_route(_TABLE[kernel][0], route)
    if not params:
        return gemm_plan(kernel, m, n, k, sms, aligned)
    plan = plan_from_params(kernel, m, n, k, sms, aligned, params,
                            clamp=False)
    if plan is None:
        raise ValueError(f"{kernel} cannot launch {params} at M={m} N={n} "
                         f"K={k} (aligned {aligned})")
    return plan


def _vec(a: torch.Tensor, k: int) -> int:
    """A float lhs whose rows the tensor-core tiles read 16 bytes at a time."""
    return int(a.dtype != torch.int32 and k % 4 == 0 and a.data_ptr() % 16 == 0)


def _row_chunks(m: int, n: int, kw: int):
    step = max(1, _PLAIN_CHUNK // max(1, n * kw))
    return range(0, m, step), step


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the kernels' arithmetic, with the ref oracles, in
# row chunks. The CPU path and the yardstick the kernels are held to.
# ---------------------------------------------------------------------------
def binary_gemm_packed_plain(a: torch.Tensor, b: torch.Tensor,
                             k: int) -> torch.Tensor:
    """(M, KW) x (N, KW) -> (M, N), or batched (E, M, KW) x (E, N, KW) ->
    (E, M, N), expert by expert, each in row chunks."""
    if a.ndim == 3:
        out = torch.empty((a.shape[0], a.shape[1], b.shape[1]),
                          dtype=torch.int32, device=a.device)
        for e in range(a.shape[0]):
            out[e] = binary_gemm_packed_plain(a[e], b[e], k)
        return out
    starts, step = _row_chunks(a.shape[0], b.shape[0], b.shape[1])
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                      device=a.device)
    for s in starts:
        out[s:s + step] = ref.binary_matmul_packed_ref(a[s:s + step], b, k)
    return out


def binary_gemm_packed_rhs_plain(a: torch.Tensor, b: torch.Tensor,
                                 k: int) -> torch.Tensor:
    starts, step = _row_chunks(a.shape[0], b.shape[0], b.shape[1])
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                      device=a.device)
    for s in starts:
        out[s:s + step] = ref.binary_matmul_packed_ref(
            pack_bits(a[s:s + step]), b, k)
    return out


def binary_gemm_fused_plain(a: torch.Tensor, b: torch.Tensor,
                            thresh: torch.Tensor, flip: torch.Tensor,
                            k: int) -> torch.Tensor:
    starts, step = _row_chunks(a.shape[0], b.shape[0], b.shape[1])
    out = torch.empty((a.shape[0], packed_width(b.shape[0])),
                      dtype=torch.int32, device=a.device)
    for s in starts:
        aw = a[s:s + step]
        if aw.dtype != torch.int32:
            aw = pack_bits(aw)
        out[s:s + step] = ref.binary_matmul_fused_ref(aw, b, thresh, flip, k)
    return out


def binary_gemm_mxu_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sign(x) @ sign(w) in float32 (`ref.binary_matmul_ref`): exact, since
    every partial sum of +-1 products is an integer below 2^24."""
    return ref.binary_matmul_ref(x, w)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def _check_operands(a: torch.Tensor, b: torch.Tensor, k: int,
                    packed_lhs: bool, *extra: torch.Tensor) -> None:
    if b.dtype != torch.int32 or b.ndim != 2:
        raise TypeError(f"rhs must be (N, KW) int32 words, got {b.dtype} "
                        f"{tuple(b.shape)}")
    kw = b.shape[1]
    if kw != packed_width(k):
        raise ValueError(f"rhs has {kw} words for K={k}")
    if packed_lhs:
        if a.dtype != torch.int32 or a.ndim != 2 or a.shape[1] != kw:
            raise ValueError(f"packed lhs must be (M, {kw}) int32, got "
                             f"{a.dtype} {tuple(a.shape)}")
    elif a.dtype not in _LHS_KIND or a.ndim != 2 or a.shape[1] != k:
        raise ValueError(f"float lhs must be (M, {k}) float32 or bfloat16, "
                         f"got {a.dtype} {tuple(a.shape)}")
    for t in (a, b, *extra):
        if t.device != a.device:
            raise ValueError(f"operands on {a.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no binary GEMM for device {a.device}")


def _launch(name: str, a: torch.Tensor, *args) -> None:
    """Launch kernel `name` on a's device and current stream, raise on a
    CUDA error, and count the launch."""
    fn = getattr(_build.library("binary_gemm"), name)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.check("binary_gemm", fn(*args, stream), name)
    _build.count(launches, name)


def binary_gemm_packed(a: torch.Tensor, b: torch.Tensor, k: int, *,
                       plan: GemmPlan | None = None) -> torch.Tensor:
    """a: (M, KW) int32 words, b: (N, KW) int32 words -> (M, N) int32
    sign-dot over the original K (pad bits cancel in the xor). Batched: a
    (E, M, KW), b (E, N, KW) -> (E, M, N), expert e's rows against expert
    e's weights, every expert in one launch. `plan` (dispatch's) replaces
    `gemm_plan`'s."""
    if a.ndim == 3 or b.ndim == 3:
        if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]:
            raise ValueError(f"a batched call takes (E, M, KW) and (E, N, KW)"
                             f" words, got {tuple(a.shape)} and "
                             f"{tuple(b.shape)}")
        _check_operands(a.flatten(0, 1), b.flatten(0, 1), k, True, a, b)
    else:
        _check_operands(a, b, k, True)
    if a.device.type == "cpu":
        return binary_gemm_packed_plain(a, b, k)
    batch = a.shape[0] if a.ndim == 3 else 1
    m, (n, kw) = a.shape[-2], b.shape[-2:]
    out = torch.empty(a.shape[:-1] + (n,), dtype=torch.int32, device=a.device)
    if batch and m and n:
        plan = plan or _plan("binary_gemm_packed", a, b, k)
        _launch("binary_gemm_packed", a, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), batch, m, n, kw, k, int(plan.small_m),
                plan.split, plan.block_n)
    return out


def binary_gemm_packed_rhs(a: torch.Tensor, b: torch.Tensor, k: int, *,
                           plan: GemmPlan | None = None) -> torch.Tensor:
    """a: (M, K) float32 or bf16 activations, b: (N, KW) int32 frozen weights ->
    (M, N) int32 = sign(a) . sign-rows(b). a is signed inside the kernel
    that `gemm_plan` picks (+1 where a >= 0; NaN is -1)."""
    _check_operands(a, b, k, False)
    if a.device.type == "cpu":
        return binary_gemm_packed_rhs_plain(a, b, k)
    m, (n, kw) = a.shape[0], b.shape
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m and n:
        plan = plan or _plan("binary_gemm_packed_rhs", a, b, k)
        _launch("binary_gemm_packed_rhs", a, a.data_ptr(), _LHS_KIND[a.dtype],
                _vec(a, k), b.data_ptr(), out.data_ptr(), m, n, kw, k,
                int(plan.small_m), plan.split, plan.block_n)
    return out


def binary_gemm_fused(a: torch.Tensor, b: torch.Tensor, thresh: torch.Tensor,
                      flip: torch.Tensor, k: int, *,
                      plan: GemmPlan | None = None) -> torch.Tensor:
    """a: (M, KW) int32 words or (M, K) float32 / bf16; b: (N, KW) int32 words;
    thresh/flip: (N,) int32. Returns (M, ceil(N/32)) int32 words with
    bit_n = (dot_n >= thresh_n) XOR flip_n and pad bits 1, i.e. the lhs of
    the next binary layer."""
    packed_lhs = a.dtype == torch.int32
    _check_operands(a, b, k, packed_lhs, thresh, flip)
    n = b.shape[0]
    if thresh.shape != (n,) or flip.shape != (n,) \
            or thresh.dtype != torch.int32 or flip.dtype != torch.int32:
        raise ValueError(f"thresh/flip must be ({n},) int32")
    if a.device.type == "cpu":
        return binary_gemm_fused_plain(a, b, thresh, flip, k)
    m, kw = a.shape[0], b.shape[1]
    out = torch.empty((m, packed_width(n)), dtype=torch.int32, device=a.device)
    if m and n:
        plan = plan or _plan("binary_gemm_fused", a, b, k)
        _launch("binary_gemm_fused", a, a.data_ptr(),
                0 if packed_lhs else _LHS_KIND[a.dtype], _vec(a, k),
                b.data_ptr(), thresh.data_ptr(), flip.data_ptr(),
                out.data_ptr(), m, n, kw, k, int(plan.small_m), plan.split,
                plan.block_n)
    return out


def binary_gemm_mxu(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) float32 or bf16, w: (K, N) float32 -> (M, N) float32 =
    sign(x) @ sign(w), sign(v) = +1 where v >= 0 (-0.0 is +1, NaN -1). Any
    floats: the kernel signs them (w once per call, into packed words,
    then x against them in the kernel `gemm_plan` picks)."""
    if x.dtype not in _LHS_KIND or x.ndim != 2:
        raise ValueError(f"x must be (M, K) float32 or bfloat16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if w.dtype != torch.float32 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"w must be ({x.shape[1]}, N) float32, got "
                         f"{w.dtype} {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if x.device.type == "cpu":
        return binary_gemm_mxu_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no binary GEMM for device {x.device}")
    (m, k), n = x.shape, w.shape[1]
    if not m or not n or not k:
        return torch.zeros((m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    # scratch for sign(w) packed along K: (N, KW) words, 16-byte aligned
    wp = torch.empty((n, packed_width(k)), dtype=torch.int32, device=x.device)
    plan = gemm_plan("binary_gemm_mxu", m, n, k, sm_count(x.device))
    _launch("binary_gemm_mxu", x, x.data_ptr(), _LHS_KIND[x.dtype], _vec(x, k),
            w.data_ptr(), wp.data_ptr(), out.data_ptr(), m, n, k,
            int(plan.small_m), plan.split, plan.block_n)
    return out


# ---------------------------------------------------------------------------
# Dispatch: the entry points the ops call, with the JAX package's argument
# order and route arguments. The lhs form picks the kernel; the device picks
# kernel or plain; the route table picks the launch.
# ---------------------------------------------------------------------------
def _dispatch_plan(kernel: str, a: torch.Tensor, b: torch.Tensor, k: int,
                   route: str | None, params: dict) -> GemmPlan | None:
    """The routed plan of a call on the card; None on the CPU, where every
    route runs the plain version (`tune.check_route` still names it)."""
    if a.device.type != "cuda":
        tune.check_route(_TABLE[kernel][0], route)
        return None
    return routed_plan(kernel, a.shape[0], b.shape[0], k, sm_count(a.device),
                       _aligned(kernel, a, b), a.dtype, route, params)


def dispatch_binary_gemm(a: torch.Tensor, b_packed: torch.Tensor,
                         k_true: int, *, route: str | None = None,
                         **params) -> torch.Tensor:
    """Packed-rhs binary GEMM with per-shape routes. a: (M, K) float32 /
    bf16 or (M, KW) int32 words; b_packed: (N, KW) int32. Returns (M, N)
    int32, the exact sign-dot, whichever route runs. route=None consults
    the route table (`tune.get_route('binary_gemm', m, n, kw, pl)`); an
    explicit route (+ `small_m`, `block_n`, `split`) bypasses it."""
    if a.dtype == torch.int32:
        return binary_gemm_packed(a, b_packed, k_true, plan=_dispatch_plan(
            "binary_gemm_packed", a, b_packed, k_true, route, params))
    return binary_gemm_packed_rhs(a, b_packed, k_true, plan=_dispatch_plan(
        "binary_gemm_packed_rhs", a, b_packed, k_true, route, params))


def dispatch_binary_gemm_fused(a: torch.Tensor, b_packed: torch.Tensor,
                               thresh: torch.Tensor, flip: torch.Tensor,
                               k_true: int, *, route: str | None = None,
                               **params) -> torch.Tensor:
    """Fused-epilogue binary GEMM (bit-resident chain step) with per-shape
    routes; same contract as `binary_gemm_fused`, routes as
    `dispatch_binary_gemm`'s (`tune.get_route('binary_gemm_fused', ...)`)."""
    return binary_gemm_fused(a, b_packed, thresh, flip, k_true,
                             plan=_dispatch_plan("binary_gemm_fused", a,
                                                 b_packed, k_true, route,
                                                 params))
