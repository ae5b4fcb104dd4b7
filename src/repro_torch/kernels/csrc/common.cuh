// Shared helpers of the port's kernels: the wire format's sign-pack, and the
// launch of a grid in thread-block clusters.
//
// Wire format (src/repro_torch/core/bitpack.py): bit 1 is +1 (x >= 0, so
// -0.0 packs to 1 and NaN to 0), 32 values per word, little-endian along the
// packed axis, positions past the end are pad bits 1. One warp makes one
// word: lane i reads element 32w+i and __ballot_sync sets bit i, which is the
// wire format itself. Where rows are few and short, a ballot per word
// leaves too few loads in flight: binary_gemm.cu's small-M kernel,
// attention.cu's body and pack.cu (kernel 5, wherever a row is made of
// whole 16-byte loads) pack a word per thread from 16-byte loads instead
// (`pack_own_word`); pack.cu's other rows take `pack_word`.
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

// Word col0 / 32 of a row of length k, packed by one thread (no ballot):
// bit i = row[col0 + i] >= 0, positions >= k are +1 (the wire format's pad).
// kVec: the row is 16-byte aligned and k a multiple of a 16-byte load, so
// each load is all in range or all out, and the 32 values come in 8
// (float32) or 4 (bf16) loads in flight together.
template <typename TA, bool kVec>
__device__ __forceinline__ uint32_t pack_own_word(const TA* __restrict__ row,
                                                  long long col0, int k) {
  uint32_t word = 0;
  if constexpr (kVec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(TA));
    uint4 raw[32 / kPer];
#pragma unroll
    for (int j = 0; j < 32 / kPer; ++j)
      raw[j] = col0 + j * kPer < k
                   ? __ldg(reinterpret_cast<const uint4*>(row + col0) + j)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < 32 / kPer; ++j) {
      const TA* v = reinterpret_cast<const TA*>(&raw[j]);
      const bool in = col0 + j * kPer < k;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        word |= static_cast<uint32_t>(!in || to_float(v[i]) >= 0.f)
                << (j * kPer + i);
    }
  } else {
    float v[32];                // positions >= k read as 0: pad bits 1
#pragma unroll
    for (int i = 0; i < 32; ++i)
      v[i] = col0 + i < k ? to_float(row[col0 + i]) : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      word |= static_cast<uint32_t>(v[i] >= 0.f) << i;
  }
  return word;
}

constexpr int kMaxSplit = 8;       // portable cluster size, a power of 2
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;

// One launch of `blocks` x `batch` blocks of `threads` in clusters of
// `split` along x (split 1, 2, 4 or 8), with `smem` bytes of dynamic shared
// memory; blockIdx.y is the batch index (a batched GEMM's expert); returns
// the launch's CUDA error code
template <typename... Params, typename... Args>
int launch_cluster_batched(void (*kernel)(Params...), long long blocks,
                           int batch, int threads, int split, int smem,
                           void* stream, Args... args) {
  if (blocks <= 0 || blocks > 0x7fffffffLL || batch < 1 || batch > 65535 ||
      split < 1 || split > kMaxSplit || (split & (split - 1)) != 0 ||
      smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks),
                     static_cast<unsigned>(batch));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// One launch of `blocks` blocks (a batch of 1), as above
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), long long blocks, int threads,
                   int split, int smem, void* stream, Args... args) {
  return launch_cluster_batched(kernel, blocks, 1, threads, split, smem,
                                stream, args...);
}

}  // namespace bnn
