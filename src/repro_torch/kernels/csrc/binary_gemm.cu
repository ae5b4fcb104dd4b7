// XNOR-popcount GEMMs for Hopper (sm_90a): the binary GEMM kernels of the
// bit-resident forward pass, with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/binary_gemm.py:
//   binary_gemm_packed      <- binary_gemm_vpu            (packed lhs, int32 dots)
//   binary_gemm_packed_rhs  <- binary_gemm_vpu_packed     (float lhs packed here)
//   binary_gemm_fused       <- binary_gemm_vpu_packed_io  (threshold + repack)
//
// Wire format (src/repro_torch/core/bitpack.py): bit 1 is +1, words are
// little-endian along K, pad bits are 1, so dot = K - 2 * popcount(a ^ b).
//
// What bounds them on the card. Per output the work is ceil(K/32) xor +
// popc + add, and the integer pipe issues 16 popc per clock per SM (a quarter
// of the fp32 rate), so with packed operands these GEMMs are bound by popc
// issue, not by bytes: a (M,KW) x (N,KW) product reads 4*(M+N)*KW bytes but
// does M*N*KW popcs. With a float lhs (the chain entry and the im2col'd
// convolutions) the float operand is 32x wider than its bits; where N is
// small against M (the CNN's second conv: M = B*H*W, N = 128) the bytes
// of A bound the kernel instead.
//
// What the design does about it. One 64x64 output tile per block of 8 warps;
// each warp owns 8 rows and each lane 2 channels 32 apart, so one thread
// keeps 16 int32 accumulators in registers and the K loop runs inside the
// block (on the TPU the K grid axis carried the sum between grid steps;
// Hopper blocks run in no order, so nothing carries between them). Each
// K step stages a 64x16-word tile of A and of B in shared memory: A reads
// are warp-uniform (broadcast), B rows are padded to an odd stride so the
// 32 lanes hit 32 banks. A float lhs is read once, coalesced, and packed
// on the fly: lane i loads element 32w+i of a row and __ballot_sync(x >= 0)
// makes bit i of word w, which is the wire format itself. Positions >= K
// read as +1 (bit 1, matching the weights' pad bits). Blocks walk the N
// tiles of one M tile next to each other, so a float A tile is fetched from
// device memory once and read again from L2. The M and N edges are masked
// in the kernel; nothing is padded or copied. The fused epilogue computes
// dot, bit = (dot >= t) != flip, and one ballot over the 32 channels of a
// lane group emits the output word; channels >= N emit bit 1.
// A float lhs is float32 or bf16 (the LM's activations); the ballot pack is
// the one every kernel of the port shares (common.cuh).
// No tensor cores, TMA or software pipelining yet: simple and exact first.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;                 // rows per block
constexpr int kTM = kBM / kWarps;       // rows per warp
constexpr int kBN = 64;                 // channels per block
constexpr int kTN = kBN / 32;           // channels per lane, 32 apart
constexpr int kKC = 16;                 // K words staged per step

// TA: uint32_t (packed lhs words), float or __nv_bfloat16 (float lhs)
template <typename TA, bool kFused>
__global__ void __launch_bounds__(kThreads)
popc_gemm_kernel(const TA* __restrict__ a,
                 const uint32_t* __restrict__ b,
                 const int32_t* __restrict__ thresh,
                 const int32_t* __restrict__ flip,
                 int32_t* __restrict__ out,
                 int m, int n, int kw, int k, int n_tiles) {
  __shared__ uint32_t sa[kBM][kKC];
  __shared__ uint32_t sb[kBN][kKC + 1];  // odd stride: conflict-free columns

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int kc0 = 0; kc0 < kw; kc0 += kKC) {
    if constexpr (!std::is_same_v<TA, uint32_t>) {
#pragma unroll 8
      for (int q = 0; q < kBM * kKC / kWarps; ++q) {
        const int e = warp + q * kWarps;
        const int r = e / kKC, c = e % kKC;
        const int row = m0 + r, word = kc0 + c;
        const long long col = static_cast<long long>(word) * 32 + lane;
        // rows past M read as +1 like the K pad; they are never stored
        const uint32_t w = bnn::pack_word(
            a + static_cast<long long>(row) * k, col, k, row < m);
        if (lane == 0) sa[r][c] = word < kw ? w : 0u;
      }
    } else {
      for (int e = tid; e < kBM * kKC; e += kThreads) {
        const int r = e / kKC, c = e % kKC;
        const int row = m0 + r, word = kc0 + c;
        sa[r][c] = (row < m && word < kw)
                       ? a[static_cast<long long>(row) * kw + word] : 0u;
      }
    }
    for (int e = tid; e < kBN * kKC; e += kThreads) {
      const int r = e / kKC, c = e % kKC;
      const int ch = n0 + r, word = kc0 + c;
      sb[r][c] = (ch < n && word < kw)
                     ? b[static_cast<long long>(ch) * kw + word] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kKC; ++c) {
      uint32_t av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = sa[warp * kTM + i][c];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = sb[lane + 32 * j][c];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += __popc(av[i] ^ bv[j]);
    }
    __syncthreads();
  }

  if constexpr (kFused) {
    const int nw = (n + 31) / 32;
    int t[kTN];
    bool f[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int ch = n0 + 32 * j + lane;
      t[j] = ch < n ? thresh[ch] : 0;
      f[j] = ch < n ? flip[ch] != 0 : false;
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = m0 + warp * kTM + i;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int ch = n0 + 32 * j + lane;
        const int dot = k - 2 * acc[i][j];
        const bool bit = ch < n ? ((dot >= t[j]) != f[j]) : true;
        const uint32_t word = __ballot_sync(0xffffffffu, bit);
        const int wc = n0 / 32 + j;
        if (lane == 0 && row < m && wc < nw)
          out[static_cast<long long>(row) * nw + wc] = static_cast<int32_t>(word);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = m0 + warp * kTM + i;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int ch = n0 + 32 * j + lane;
        if (row < m && ch < n)
          out[static_cast<long long>(row) * n + ch] = k - 2 * acc[i][j];
      }
    }
  }
}

template <typename TA, bool kFused>
int launch(const void* a, const void* b, const void* thresh, const void* flip,
           void* out, int m, int n, int kw, int k, void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + kBN - 1) / kBN;
  const long long blocks = static_cast<long long>((m + kBM - 1) / kBM) * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  popc_gemm_kernel<TA, kFused>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const TA*>(a), static_cast<const uint32_t*>(b),
          static_cast<const int32_t*>(thresh), static_cast<const int32_t*>(flip),
          static_cast<int32_t*>(out), m, n, kw, k, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// lhs_kind: 0 packed int32 words, 1 float32, 2 bfloat16
template <bool kFused>
int launch_lhs(int lhs_kind, const void* a, const void* b, const void* thresh,
               const void* flip, void* out, int m, int n, int kw, int k,
               void* stream) {
  switch (lhs_kind) {
    case 0: return launch<uint32_t, kFused>(a, b, thresh, flip, out, m, n, kw, k, stream);
    case 1: return launch<float, kFused>(a, b, thresh, flip, out, m, n, kw, k, stream);
    case 2: return launch<__nv_bfloat16, kFused>(a, b, thresh, flip, out, m, n, kw, k, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// a (m, kw) int32 words, b (n, kw) int32 words -> out (m, n) int32 dots.
int binary_gemm_packed(const void* a, const void* b, void* out, int m, int n,
                       int kw, int k, void* stream) {
  return launch_lhs<false>(0, a, b, nullptr, nullptr, out, m, n, kw, k, stream);
}

// a (m, k) float32 (lhs_kind 1) or bfloat16 (lhs_kind 2), b (n, kw) int32
// words -> out (m, n) int32 dots.
int binary_gemm_packed_rhs(const void* a, int lhs_kind, const void* b,
                           void* out, int m, int n, int kw, int k,
                           void* stream) {
  if (lhs_kind == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_lhs<false>(lhs_kind, a, b, nullptr, nullptr, out, m, n, kw, k,
                           stream);
}

// a (m, kw) int32 words (lhs_kind 0) or (m, k) float32 / bfloat16 (lhs_kind
// 1 / 2), b (n, kw) int32 words, thresh/flip (n,) int32 -> out
// (m, ceil(n/32)) words.
int binary_gemm_fused(const void* a, int lhs_kind, const void* b,
                      const void* thresh, const void* flip, void* out, int m,
                      int n, int kw, int k, void* stream) {
  return launch_lhs<true>(lhs_kind, a, b, thresh, flip, out, m, n, kw, k,
                          stream);
}

const char* binary_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
