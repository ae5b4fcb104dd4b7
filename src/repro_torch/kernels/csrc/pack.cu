// Sign-pack for Hopper (sm_90a): float rows -> wire-format words, with a
// plain C interface for ctypes. Two entries share one pair of kernels:
//   pack_bits       (M, K) -> (M, ceil(K/32)) words, row for row;
//   pack_rows_into  up to two sources (the new K and V rows) packed and
//                   stored straight at their destination rows of the cache
//                   (rows outside the destination are dropped), one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pack.py:pack_bits_kernel
// and, for the cache, the JAX package's `kc.at[rows, wpos].set(pack_bits(
// k), mode="drop")` (src/repro/models/transformer.py:_decode_self_block,
// _chunk_self_block). On the LM's path it packs the normed residual once
// for Q/K/V and once for gate/up (PackedActivation.pack), and the new K/V
// rows of a decode step, a prefill chunk or a whole prompt into the cache.
//
// What bounds it on the card: bytes in principle (M*K values read, M*K/8
// bytes written, one compare a value), but the LM's calls move a few KB:
// a launch and one dependent load and store are the floor, so the design
// spends as few launches as it can (K and V in one, no gather, where or
// index_put after it) and keeps every word's loads in flight together.
//
// What the design does about it. Where a sub-row of K values is a whole
// number of 16-byte loads and 16-byte aligned (K % 8 == 0 in bf16, % 4 in
// float32), one thread packs one word from 4 (bf16) or 8 (float32) 16-byte
// loads (common.cuh `pack_own_word`), as the small-M GEMM packs its lhs
// (there a ballot per word left too few loads in flight for short rows).
// Other rows take the warp-ballot body (`pack_word`): lane i reads element
// 32w + i, coalesced, and __ballot_sync is the word. Positions >= K read as
// +1. No shared memory; a skipped row reads nothing.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Destination sub-row of source sub-row `row` (sub-rows of length k, `per`
// of them to a destination row of a `rows`-row pool), or -1 where the
// destination row lies outside [0, rows): dropped. dst == nullptr: row.
__device__ __forceinline__ long long dest_row(const long long* dst,
                                              long long row, int per,
                                              long long rows) {
  if (dst == nullptr) return row;
  const long long d = __ldg(dst + row / per);
  return (d < 0 || d >= rows) ? -1 : d * per + row % per;
}

// One thread packs one word (16-byte loads). Threads [0, m*kw) pack source
// 0, [m*kw, 2*m*kw) source 1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_words_kernel(const T* x0, const T* x1, uint32_t* out0, uint32_t* out1,
                  const long long* dst, long long m, int k, int kw, int per,
                  long long rows) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long words = m * kw;
  if (t >= (x1 == nullptr ? words : 2 * words)) return;
  const bool second = t >= words;
  const long long w = second ? t - words : t;
  const long long row = w / kw;
  const int j = static_cast<int>(w % kw);
  const long long d = dest_row(dst, row, per, rows);
  if (d < 0) return;
  const T* x = (second ? x1 : x0) + row * k;
  (second ? out1 : out0)[d * kw + j] =
      bnn::pack_own_word<T, true>(x, static_cast<long long>(j) * 32, k);
}

// One warp packs one word (ballot), for rows not made of 16-byte loads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_ballot_kernel(const T* x0, const T* x1, uint32_t* out0, uint32_t* out1,
                   const long long* dst, long long m, int k, int kw, int per,
                   long long rows) {
  const long long word =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long words = m * kw;
  // word, row and destination are uniform across the warp: the returns
  // leave no lane of a ballot behind
  if (word >= (x1 == nullptr ? words : 2 * words)) return;
  const bool second = word >= words;
  const long long w = second ? word - words : word;
  const long long row = w / kw;
  const long long d = dest_row(dst, row, per, rows);
  if (d < 0) return;
  const long long j = w % kw;
  const uint32_t bits =
      bnn::pack_word((second ? x1 : x0) + row * k, j * 32 + lane, k);
  if (lane == 0) (second ? out1 : out0)[d * kw + j] = bits;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* x0, const void* x1, void* out0, void* out1,
           const long long* dst, long long m, int k, int per, long long rows,
           void* stream) {
  if (m <= 0 || k <= 0 || per <= 0 || x0 == nullptr || out0 == nullptr ||
      (x1 == nullptr) != (out1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kw = (k + 31) / 32;
  const long long words = m * kw * (x1 == nullptr ? 1 : 2);
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const bool vec = k % kPer == 0 && aligned16(x0) &&
                   (x1 == nullptr || aligned16(x1));
  const long long threads = vec ? words : words * 32;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const T*>(x0);
  const auto* b = static_cast<const T*>(x1);
  auto* o0 = static_cast<uint32_t*>(out0);
  auto* o1 = static_cast<uint32_t*>(out1);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    pack_words_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a, b, o0, o1, dst, m, k, kw, per, rows);
  else
    pack_ballot_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a, b, o0, o1, dst, m, k, kw, per, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (m, k) float32 (x_bf16 == 0) or bfloat16 (x_bf16 != 0) -> out
// (m, ceil(k/32)) int32 words, pad bits 1.
int pack_bits(const void* x, int x_bf16, void* out, int m, int k,
              void* stream) {
  if (x_bf16)
    return launch<__nv_bfloat16>(x, nullptr, out, nullptr, nullptr, m, k, 1,
                                 0, stream);
  return launch<float>(x, nullptr, out, nullptr, nullptr, m, k, 1, 0, stream);
}

// Sources x0 and x1 (x1 may be null), each (n, per, k) float32 or bfloat16,
// packed along k and stored at out0 / out1 viewed as (rows, per,
// ceil(k/32)) int32: source row i goes to row dst[i] (int64), or nowhere
// where dst[i] lies outside [0, rows). One launch for both sources.
int pack_rows_into(const void* x0, const void* x1, int x_bf16, void* out0,
                   void* out1, const void* dst, int n, int per, int k,
                   long long rows, void* stream) {
  if (n <= 0 || dst == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = static_cast<const long long*>(dst);
  const long long m = static_cast<long long>(n) * per;
  if (x_bf16)
    return launch<__nv_bfloat16>(x0, x1, out0, out1, d, m, k, per, rows,
                                 stream);
  return launch<float>(x0, x1, out0, out1, d, m, k, per, rows, stream);
}

const char* pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
