// Sign-pack for Hopper (sm_90a): float (M, K) -> (M, ceil(K/32)) wire-format
// words, with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pack.py:pack_bits_kernel.
// On the LM's path it packs the normed residual once for Q/K/V and once for
// gate/up (PackedActivation.pack) and the new K/V cache rows.
//
// What bounds it on the card: bytes. It reads M*K values (4 or 2 bytes each)
// and writes M*K/8 bytes; per value there is one compare, so the card's
// memory rate is the limit by a wide margin.
//
// What the design does about it. One warp makes one word: lane i reads
// element 32w+i, so a warp reads 128 (float32) or 64 (bf16) consecutive
// bytes, coalesced, and __ballot_sync(x >= 0) is the word itself
// (common.cuh, shared with attention.cu's query pack). Positions
// >= K read as +1. Nothing is padded or copied; no shared memory.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ x, uint32_t* __restrict__ out, long long m,
            int k, int kw) {
  const long long word =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (word >= m * kw) return;            // uniform across the warp
  const long long row = word / kw;
  const long long col = (word % kw) * 32 + lane;
  const uint32_t w = bnn::pack_word(x + row * k, col, k);
  if (lane == 0) out[word] = w;
}

template <typename T>
int launch(const void* x, void* out, int m, int k, void* stream) {
  if (m <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int kw = (k + 31) / 32;
  const long long threads = static_cast<long long>(m) * kw * 32;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pack_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<uint32_t*>(out), m, k, kw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (m, k) float32 (x_bf16 == 0) or bfloat16 (x_bf16 != 0) -> out
// (m, ceil(k/32)) int32 words, pad bits 1.
int pack_bits(const void* x, int x_bf16, void* out, int m, int k,
              void* stream) {
  if (x_bf16) return launch<__nv_bfloat16>(x, out, m, k, stream);
  return launch<float>(x, out, m, k, stream);
}

const char* pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
