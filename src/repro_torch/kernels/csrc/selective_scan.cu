// Selective scan (the Mamba-1 recurrence) for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * xi_t) * B_t,  y_t = sum_n h_t C_t
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py:
// selective_scan, and takes an initial state h0 besides (a slot's later
// prefill chunks and its decode steps start from its state). On the
// falcon-mamba serving path it runs once per layer in every prefill chunk
// and every decode step (T = 1).
//
// What bounds it on the card: operations. Per (row, step, channel) it reads
// dt, xi and writes y (12 bytes or 10 for bf16 xi), per (row, step) 2N
// floats of B and C shared by every channel, but it takes N exps: at N = 16
// the exps outweigh the bytes some 20 times over (the SFU issues 16 per
// clock per SM). Here each exp is a float64 exp rounded to float32, so that
// the kernel equals its plain version bit for bit (ref.selective_scan_ref
// calls the same CUDA double exp through torch): that costs float64 pipe
// time a float exp would not.
//
// What the design does about it: a simple kernel that is right first. One
// thread per channel d holds its N states and its row of A in registers for
// the whole time loop (the TPU kernel's VMEM scratch), so the state never
// leaves the SM between steps: it is read once (h0) and written once
// (h_final). Consecutive threads take consecutive channels, so the dt, xi
// and y accesses of a warp are coalesced along the (B, T, D) rows. A tile of
// kTileT steps of B and C is staged in shared memory once for all channels
// of the block. The loop bound is T (no padding) and the channel edge is
// masked. No fused multiply-add anywhere (__fmul_rn / __fadd_rn), and y is
// summed over n = 0..N-1 in sequence: the plain version's order. Blocks of
// 64 channels, so that a D = 8192 row makes 128 blocks for 132 SMs.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kTileT = 64;     // steps of B and C staged per tile
constexpr int kMaxN = 16;

template <int N, typename X>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ dt, const X* __restrict__ xi,
            const float* __restrict__ bmat, const float* __restrict__ cmat,
            const float* __restrict__ a_mat, const float* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ h_out, int t_len,
            int d) {
  __shared__ float bs[kTileT * N];
  __shared__ float cs[kTileT * N];
  const long long b = blockIdx.x;
  const int ch = blockIdx.y * kThreads + threadIdx.x;
  const bool live = ch < d;
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? a_mat[static_cast<long long>(ch) * N + n] : 0.f;
    h[n] = (live && h0 != nullptr) ? h0[(b * d + ch) * N + n] : 0.f;
  }
  const long long row0 = b * t_len;        // first (b, t) row of this batch
  for (int t0 = 0; t0 < t_len; t0 += kTileT) {
    const int tt = min(kTileT, t_len - t0);
    __syncthreads();                         // the last tile is read
    const float* bsrc = bmat + (row0 + t0) * N;
    const float* csrc = cmat + (row0 + t0) * N;
    for (int i = threadIdx.x; i < tt * N; i += kThreads) {
      bs[i] = bsrc[i];
      cs[i] = csrc[i];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < tt; ++j) {
      const long long idx = (row0 + t0 + j) * d + ch;
      const float dtv = dt[idx];
      const float dx = __fmul_rn(dtv, bnn::to_float(xi[idx]));
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const double e = exp(static_cast<double>(__fmul_rn(dtv, a[n])));
        const float an = static_cast<float>(e);
        h[n] = __fadd_rn(__fmul_rn(an, h[n]), __fmul_rn(dx, bs[j * N + n]));
        const float p = __fmul_rn(h[n], cs[j * N + n]);
        acc = n == 0 ? p : __fadd_rn(acc, p);
      }
      y[idx] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[(b * d + ch) * N + n] = h[n];
  }
}

template <int N, typename X>
int launch_n(const void* dt, const void* xi, const void* bmat,
             const void* cmat, const void* a_mat, const void* h0, void* y,
             void* h_out, int b, int t, int d, cudaStream_t stream) {
  const dim3 grid(b, (d + kThreads - 1) / kThreads);
  scan_kernel<N, X><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const X*>(xi),
      static_cast<const float*>(bmat), static_cast<const float*>(cmat),
      static_cast<const float*>(a_mat), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), t, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename X>
int launch(const void* dt, const void* xi, const void* bmat, const void* cmat,
           const void* a_mat, const void* h0, void* y, void* h_out, int b,
           int t, int d, int n, cudaStream_t s) {
  switch (n) {
#define SCAN_CASE(NN) \
    case NN: return launch_n<NN, X>(dt, xi, bmat, cmat, a_mat, h0, y, h_out, \
                                    b, t, d, s);
    SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3) SCAN_CASE(4)
    SCAN_CASE(5) SCAN_CASE(6) SCAN_CASE(7) SCAN_CASE(8)
    SCAN_CASE(9) SCAN_CASE(10) SCAN_CASE(11) SCAN_CASE(12)
    SCAN_CASE(13) SCAN_CASE(14) SCAN_CASE(15) SCAN_CASE(16)
#undef SCAN_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dt (b, t, d) float32; xi (b, t, d) float32 (xi_bf16 == 0) or bfloat16;
// bmat, cmat (b, t, n) float32; a_mat (d, n) float32; h0 (b, d, n) float32
// or null (zeros) -> y (b, t, d) float32, h_out (b, d, n) float32. 1 <= n
// <= 16; every array contiguous.
int selective_scan(const void* dt, const void* xi, int xi_bf16,
                   const void* bmat, const void* cmat, const void* a_mat,
                   const void* h0, void* y, void* h_out, int b, int t, int d,
                   int n, void* stream) {
  if (b <= 0 || t < 0 || d <= 0 || n < 1 || n > kMaxN ||
      (d + kThreads - 1) / kThreads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (xi_bf16)
    return launch<__nv_bfloat16>(dt, xi, bmat, cmat, a_mat, h0, y, h_out, b,
                                 t, d, n, s);
  return launch<float>(dt, xi, bmat, cmat, a_mat, h0, y, h_out, b, t, d, n,
                       s);
}

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
