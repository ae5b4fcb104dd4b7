"""Binary (XNOR+popcount) GEMMs: hand-written Hopper kernels, their plain
PyTorch versions, and the dispatch the ops call (port of
`repro.kernels.binary_gemm`).

  * `binary_gemm_packed` — packed (M, KW) lhs x packed (N, KW) rhs -> (M, N)
    int32 dots. Replaces the TPU kernel `binary_gemm_vpu`.
  * `binary_gemm_packed_rhs` — float32 or bf16 (M, K) lhs, sign-packed
    inside the kernel, x packed rhs -> (M, N) int32. Replaces
    `binary_gemm_vpu_packed`.
  * `binary_gemm_fused` — packed or float lhs x packed rhs, with the
    bit-resident epilogue: bit_n = (dot_n >= thresh_n) XOR flip_n, repacked
    along N -> (M, ceil(N/32)) int32 words, pad bits 1. Replaces
    `binary_gemm_vpu_packed_io`.

The kernels are CUDA C++ for sm_90a in `csrc/binary_gemm.cu` (its header
says what bounds them and what the design does about it). A wrapper
launches its kernel on CUDA tensors, or raises; it runs the plain version
only because its inputs lie on the CPU. `launches[name]` counts the
wrapper's kernel launches, so a run can show that it went through them.

Words are int32 tensors holding the uint32 bits of the JAX package's wire
format. There is no tuning cache and no route choice: the device decides.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitpack import pack_bits, packed_width
from repro_torch.kernels import _build, ref

launches = {"binary_gemm_packed": 0, "binary_gemm_packed_rhs": 0,
            "binary_gemm_fused": 0}

# the plain versions reduce over (rows, N, KW) int64 temporaries; rows are
# taken in chunks of at most this many elements so a full-width layer fits
_PLAIN_CHUNK = 1 << 24
# float lhs types the kernels read, by the code the C interface takes (the
# sign of a bf16 activation is exact, so it is read as it is, not cast)
_LHS_KIND = {torch.float32: 1, torch.bfloat16: 2}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _row_chunks(m: int, n: int, kw: int):
    step = max(1, _PLAIN_CHUNK // max(1, n * kw))
    return range(0, m, step), step


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the kernels' arithmetic, with the ref oracles, in
# row chunks. The CPU path and the yardstick the kernels are held to.
# ---------------------------------------------------------------------------
def binary_gemm_packed_plain(a: torch.Tensor, b: torch.Tensor,
                             k: int) -> torch.Tensor:
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
    launches[name] += 1


def binary_gemm_packed(a: torch.Tensor, b: torch.Tensor,
                       k: int) -> torch.Tensor:
    """a: (M, KW) int32 words, b: (N, KW) int32 words -> (M, N) int32
    sign-dot over the original K (pad bits cancel in the xor)."""
    _check_operands(a, b, k, True)
    if a.device.type == "cpu":
        return binary_gemm_packed_plain(a, b, k)
    m, (n, kw) = a.shape[0], b.shape
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m and n:
        _launch("binary_gemm_packed", a, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, n, kw, k)
    return out


def binary_gemm_packed_rhs(a: torch.Tensor, b: torch.Tensor,
                           k: int) -> torch.Tensor:
    """a: (M, K) float32 or bf16 activations, b: (N, KW) int32 frozen weights ->
    (M, N) int32 = sign(a) . sign-rows(b). a is sign-packed in the kernel
    (bit = a >= 0; K positions past the end read as +1)."""
    _check_operands(a, b, k, False)
    if a.device.type == "cpu":
        return binary_gemm_packed_rhs_plain(a, b, k)
    m, (n, kw) = a.shape[0], b.shape
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m and n:
        _launch("binary_gemm_packed_rhs", a, a.data_ptr(), _LHS_KIND[a.dtype],
                b.data_ptr(), out.data_ptr(), m, n, kw, k)
    return out


def binary_gemm_fused(a: torch.Tensor, b: torch.Tensor, thresh: torch.Tensor,
                      flip: torch.Tensor, k: int) -> torch.Tensor:
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
        _launch("binary_gemm_fused", a, a.data_ptr(),
                0 if packed_lhs else _LHS_KIND[a.dtype],
                b.data_ptr(), thresh.data_ptr(), flip.data_ptr(),
                out.data_ptr(), m, n, kw, k)
    return out


# ---------------------------------------------------------------------------
# Dispatch: the entry points the ops call, with the JAX package's argument
# order. The lhs form picks the kernel; the device picks kernel or plain.
# ---------------------------------------------------------------------------
def dispatch_binary_gemm(a: torch.Tensor, b_packed: torch.Tensor,
                         k_true: int) -> torch.Tensor:
    """Packed-rhs binary GEMM. a: (M, K) float32 / bf16 or (M, KW) int32 words;
    b_packed: (N, KW) int32. Returns (M, N) int32, the exact sign-dot."""
    if a.dtype == torch.int32:
        return binary_gemm_packed(a, b_packed, k_true)
    return binary_gemm_packed_rhs(a, b_packed, k_true)


def dispatch_binary_gemm_fused(a: torch.Tensor, b_packed: torch.Tensor,
                               thresh: torch.Tensor, flip: torch.Tensor,
                               k_true: int) -> torch.Tensor:
    """Fused-epilogue binary GEMM (bit-resident chain step); same contract
    as `binary_gemm_fused`."""
    return binary_gemm_fused(a, b_packed, thresh, flip, k_true)

