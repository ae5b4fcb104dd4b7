// Shared device helpers of the port's kernels: the wire format's sign-pack.
//
// Wire format (src/repro_torch/core/bitpack.py): bit 1 is +1 (x >= 0, so
// -0.0 packs to 1 and NaN to 0), 32 values per word, little-endian along the
// packed axis, positions past the end are pad bits 1. One warp makes one
// word: lane i reads element 32w+i and __ballot_sync sets bit i, which is the
// wire format itself. pack.cu (kernel 5) and attention.cu (the query) pack
// through `pack_word`; binary_gemm.cu's small-M kernel packs a word per
// thread from 16-byte loads instead (its rows are few and short, so a
// ballot per word leaves too few loads in flight).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bnn {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float from_float(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_float(float x, __nv_bfloat16*) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Word `col / 32` of `row` (length k), called by all 32 lanes of a warp with
// col = 32 * word + lane. Positions >= k, and every position of a row with
// `in_range` false (a row past the end, never read), are +1. The bit is a
// predicated load and the ballot is taken outside any branch: callers must
// not put the call itself under a condition, or an unrolled loop of calls
// no longer keeps its loads in flight together (the float-lhs GEMMs ran
// 2.2x slower that way).
template <typename T>
__device__ __forceinline__ uint32_t pack_word(const T* row, long long col,
                                              long long k,
                                              bool in_range = true) {
  const bool bit = (in_range && col < k) ? to_float(row[col]) >= 0.f : true;
  return __ballot_sync(0xffffffffu, bit);
}

}  // namespace bnn
