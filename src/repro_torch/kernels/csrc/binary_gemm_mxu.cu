// Sign-quantize + tensor-core GEMM for Hopper (sm_90a): the binary GEMM of
// the training path, out = sign(x) @ sign(w) in float32, with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel binary_gemm_mxu
// (src/repro/kernels/binary_gemm.py:318), which signs (128, 512) x (512,
// 128) blocks to +-1 bf16 and multiplies them on the MXU.
//
// What it computes. x (M, K) float32 or bfloat16, w (K, N) float32, both
// row-major; out (M, N) float32 = sign(x) @ sign(w), sign(v) = +1 where
// v >= 0 (so -0.0 is +1 and NaN is -1), else -1. Every dot is an integer of
// magnitude <= K < 2^24, summed in int32 and stored exactly as a float. The
// inputs may hold any floats: the kernel signs them, it does not assume +-1.
//
// What bounds it on the card. Per output the work is K int8 multiply-adds,
// which the tensor cores do at 1,979 TOP/s; the float operands are read once
// at 4 (or 2) bytes per value. At the CNN's conv shapes (M = B*H*W rows of
// im2col columns, K = 9*Cin, N = Cout <= 512) the bytes of x dominate, so
// the kernel is bound by device memory (~0.34 ms per train step against
// ~0.06 ms of int8 tensor-core time).
//
// What the design does about it. Two launches from one entry point. A small
// pass signs w once into wt, (N, Kp) int8 +-1 with K padded by zeros to Kp
// (a multiple of 32), in a scratch buffer the caller allocates: w is read by
// every row tile, so it is signed and transposed once instead of in every
// block. The GEMM then gives each block of 8 warps one 128x128 output tile
// (4 warps along M x 2 along N, each warp 32x64: 2 x 8 tiles of
// mma.sync m16n8k32, int8 x int8 -> int32 accumulators in registers); K
// runs inside the block in steps of 32. Each step's wt tile comes by 16-byte
// cp.async into a two-stage ring in shared memory, already in the (column,
// k) layout of the mma's B fragments. Each thread loads its share of the
// next step's x tile (16 values, 16-byte loads where K % 4 == 0, 8-byte for
// bf16, else one value at a time) into registers while the tensor cores
// work on the current step, then signs it to +-1 int8, four values to a
// 32-bit word, into shared memory in (row, k) layout. Every fragment
// register is then one 32-bit shared load; rows are padded to 12 words so
// the 8 x 4 words of a fragment load hit 32 distinct banks. Positions past
// M, N or K stage as 0, which adds nothing: the TPU kernel's +1 padding of
// K and the subtraction of the pad count are not needed. ~120 registers
// leave room for two blocks on an SM. Blocks walk the N tiles of one M tile
// next to each other, so an x tile read by several N tiles comes from L2
// after the first. The x staging, the sign bytes, the fragment loads and
// the mma are mma_tile.cuh's, shared with binary_gemm.cu's tensor-core
// tiles. No wgmma, TMA or x ring in shared memory yet.
#include <cstdint>

#include "mma_tile.cuh"

namespace {

using bnn::kTcStride;
constexpr int kThreads = 256;              // 8 warps
constexpr int kBM = 128;                   // rows per block
constexpr int kBN = 128;                   // columns per block
constexpr int kBK = bnn::kTcBK;            // K values per step: one k32 mma
constexpr int kWarpM = 32;                 // rows per warp
constexpr int kWarpN = 64;                 // columns per warp
constexpr int kMI = kWarpM / 16;           // m16 tiles per warp
constexpr int kNI = kWarpN / 8;            // n8 tiles per warp
constexpr int kSignThreads = 256;

// wt (n, kp) int8 <- sign(w (k, n) float32), zero for k <= position < kp:
// word c of column col holds positions 4c..4c+3; neighbouring threads take
// neighbouring columns, so each of the four reads of w is coalesced.
__global__ void __launch_bounds__(kSignThreads)
sign_w_kernel(const float* __restrict__ w, uint32_t* __restrict__ wt, int k,
              int n, int kp) {
  const long long i = static_cast<long long>(blockIdx.x) * kSignThreads +
                      threadIdx.x;
  const int words = kp / 4;
  if (i >= static_cast<long long>(n) * words) return;
  const int col = static_cast<int>(i % n);
  const int c = static_cast<int>(i / n);
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = 4 * c + j;
    const bool ok = kk < k;
    word |= bnn::sign_byte(ok ? w[static_cast<long long>(kk) * n + col] : 0.f,
                           ok) << (8 * j);
  }
  wt[static_cast<long long>(col) * words + c] = word;
}

// one K step of wt into stage `dst`: thread tid copies 16 bytes, half a
// column's 32 positions; columns past n are zero-filled (nothing is read)
__device__ __forceinline__ void copy_w_step(uint32_t (*dst)[kTcStride],
                                            const int8_t* __restrict__ wt,
                                            int n, int kp, int n0, int k0,
                                            int tid) {
  const int c = tid >> 1, half = tid & 1;
  const bool ok = n0 + c < n;
  const int8_t* src = ok ? wt + static_cast<long long>(n0 + c) * kp + k0 +
                               16 * half
                         : wt;
  const unsigned dst_addr = static_cast<unsigned>(
      __cvta_generic_to_shared(&dst[c][4 * half]));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst_addr), "l"(src), "r"(ok ? 16 : 0));
}

template <typename TA, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
mxu_gemm_kernel(const TA* __restrict__ x, const int8_t* __restrict__ wt,
                float* __restrict__ out, int m, int n, int k, int kp,
                int n_tiles) {
  __shared__ uint32_t sa[kBM][kTcStride];        // sign(x) step, (row, k words)
  __shared__ uint32_t sb[2][kBN][kTcStride];     // wt steps, (column, k words)
  static_assert(kBN * 2 == kThreads, "one 16-byte wt copy per thread");

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;                 // mma group: row / column in tile
  const int t = lane & 3;                  // thread in group: k word
  const int wm = warp >> 1;                // warp's 32-row slab
  const int wn = warp & 1;                 // warp's 64-column slab
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;

  int acc[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  bnn::XStep<TA, kVec, kBM, kThreads> xs;
  xs.load(x, m, k, m0, 0, tid);
  copy_w_step(sb[0], wt, n, kp, n0, 0, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  int stage = 0;
  for (int k0 = 0; k0 < k; k0 += kBK) {
    xs.store(sa, m, k, m0, k0, tid);
    if (k0 + kBK < k) {                    // the next step, in flight
      copy_w_step(sb[stage ^ 1], wt, n, kp, n0, k0 + kBK, tid);
      asm volatile("cp.async.commit_group;\n" ::);
      xs.load(x, m, k, m0, k0 + kBK, tid);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    uint32_t a[kMI][4], b[kNI][2];
#pragma unroll
    for (int i = 0; i < kMI; ++i)
      bnn::frag_a(a[i], sa, wm * kWarpM + i * 16, 0, g, t);
#pragma unroll
    for (int j = 0; j < kNI; ++j)
      bnn::frag_b(b[j], sb[stage], wn * kWarpN + j * 8, 0, g, t);
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNI; ++j) bnn::mma_s8(acc[i][j], a[i], b[j]);
    __syncthreads();
    stage ^= 1;
  }

  // accumulator c of tile (i, j): row g (+8 for c >= 2), column 2t + (c & 1)
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
#pragma unroll
    for (int j = 0; j < kNI; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm * kWarpM + i * 16 + g + (c >= 2 ? 8 : 0);
        const int col = n0 + wn * kWarpN + j * 8 + 2 * t + (c & 1);
        if (row < m && col < n)
          out[static_cast<long long>(row) * n + col] =
              static_cast<float>(acc[i][j][c]);
      }
    }
  }
}

template <typename TA>
int launch(const void* x, bool vec, const void* w, void* wt, void* out, int m,
           int n, int k, int kp, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const long long words = static_cast<long long>(n) * (kp / 4);
  const long long sign_blocks = (words + kSignThreads - 1) / kSignThreads;
  const int n_tiles = (n + kBN - 1) / kBN;
  const long long blocks = static_cast<long long>((m + kBM - 1) / kBM) * n_tiles;
  if (blocks > 0x7fffffffLL || sign_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  sign_w_kernel<<<static_cast<unsigned>(sign_blocks), kSignThreads, 0, s>>>(
      static_cast<const float*>(w), static_cast<uint32_t*>(wt), k, n, kp);
  const auto xt = static_cast<const TA*>(x);
  const auto wq = static_cast<const int8_t*>(wt);
  const auto ot = static_cast<float*>(out);
  if (vec)
    mxu_gemm_kernel<TA, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xt, wq, ot, m, n, k, kp, n_tiles);
  else
    mxu_gemm_kernel<TA, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xt, wq, ot, m, n, k, kp, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (m, k) float32 (x_kind 1) or bfloat16 (x_kind 2), w (k, n) float32 ->
// out (m, n) float32 = sign(x) @ sign(w). wt: scratch of n * kp bytes, kp a
// multiple of 32 >= k, 16-byte aligned (the signed, transposed w). vec: x's
// pointer is 16-byte aligned and k % 4 == 0, so rows are read as vectors.
int binary_gemm_mxu(const void* x, int x_kind, int vec, const void* w,
                    void* wt, void* out, int m, int n, int k, int kp,
                    void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || kp < k || kp % kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (x_kind) {
    case 1: return launch<float>(x, vec != 0, w, wt, out, m, n, k, kp, stream);
    case 2:
      return launch<__nv_bfloat16>(x, vec != 0, w, wt, out, m, n, k, kp, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* binary_gemm_mxu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
