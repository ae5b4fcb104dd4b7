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
// calls the same CUDA double exp through torch): 17 float64 instructions
// an exp (its sm_90a SASS) on the card's 64 float64 lanes an SM, the floor.
//
// What the design does about it: it spreads a channel's N states over L
// lanes, so that many more warps run independent float64 work. A launch
// that walks whole runs of kRun steps (a prefill chunk, a long prefill)
// takes L = 8 lanes of S = 2 states at N = 16: a warp holds 4 channels and
// a falcon-mamba chunk (1, 32, 8192, 16) runs 2,048 warps, where one
// thread per channel ran 256. Shorter launches (T < kRun: decode) take 4
// lanes of 4 states and runs of one step: they have no chain to hide, and
// fewer lanes and registers a channel let the grid in at once. The exps do
// not depend on h: a
// block stages a tile of kTileT steps of dt, xi, B and C in shared memory
// (every load of the tile in flight together), and each lane takes the
// kRun x S exps of a run before the h chain walks those steps. y keeps the
// plain order, summed over n = 0..N-1 in sequence: lane 0 sums its states'
// products, hands the running sum to lane 1 with a shuffle, and so on (L -
// 1 dependent shuffles); a whole run is straight-line code (`run_steps`
// with kFull), so the kRun steps' chains interleave. Each state lives in
// one lane's registers for the whole time loop (the TPU kernel's VMEM
// scratch), read once (h0) and written once (h_final). No fused
// multiply-add anywhere (__fmul_rn / __fadd_rn). Blocks of 32 channels (32
// L threads): D = 8192 makes 256 blocks a batch row.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChannels = 32;  // channels per block
constexpr int kTileT = 64;     // steps of dt, xi, B and C staged per tile
constexpr int kRun = 8;        // steps whose exps are taken ahead of h
                               // (1 where a launch walks fewer steps)
constexpr int kMaxN = 16;

// Lanes a channel's N states are spread over: at most 8 where a launch
// walks whole runs of kRun steps, at most 4 where it walks fewer (decode:
// T = 1 takes no chain to hide, and 4 lanes make half the warps)
constexpr int lanes_for(int n, bool short_t) {
  const int cap = short_t ? 4 : 8;
  return n >= cap ? cap : n >= 4 ? 4 : n >= 2 ? 2 : 1;
}

// Steps r0 .. r0 + nr - 1 of the staged tile (nr = R where kFull: the loops
// are straight-line code, so the R chains interleave): their exps, the h
// chain, and y. Lane j holds states n = j S + s (past N: idle).
template <int N, int L, int R, bool kFull>
__device__ __forceinline__ void run_steps(
    const float (&dts)[kTileT][kChannels],
    const float (&xis)[kTileT][kChannels], const float* bs, const float* cs, const float (&a)[(N + L - 1) / L],
    float (&h)[(N + L - 1) / L], float* __restrict__ y, long long yrow,
    long long d, int r0, int nr, int cl, int j, bool live) {
  constexpr int S = (N + L - 1) / L;
  // the run's exps, off the h chain
  float e[R][S];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (kFull || r < nr) {
      const float dtv = dts[r0 + r][cl];
#pragma unroll
      for (int s = 0; s < S; ++s)
        e[r][s] = static_cast<float>(
            exp(static_cast<double>(__fmul_rn(dtv, a[s]))));
    }
  }
  // the h chain, and each state's product with C
  float p[R][S];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (kFull || r < nr) {
      const float dx = __fmul_rn(dts[r0 + r][cl], xis[r0 + r][cl]);
      const float* bt = bs + (r0 + r) * N + j * S;
      const float* ct = cs + (r0 + r) * N + j * S;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (j * S + s < N) {
          h[s] = __fadd_rn(__fmul_rn(e[r][s], h[s]), __fmul_rn(dx, bt[s]));
          p[r][s] = __fmul_rn(h[s], ct[s]);
        }
      }
    }
  }
  // y = ((p_0 + p_1) + p_2) + ... in n order: lane q adds its states'
  // products to the running sum lane q - 1 hands it
  float run[R];
#pragma unroll
  for (int q = 0; q < L; ++q) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (kFull || r < nr) {
        const float inc =
            q > 0 ? __shfl_up_sync(0xffffffffu, run[r], 1, L) : 0.f;
        if (j == q) {
          float v = inc;
          if (q * S < N) {
            v = q == 0 ? p[r][0] : __fadd_rn(inc, p[r][0]);
#pragma unroll
            for (int s = 1; s < S; ++s)
              if (q * S + s < N) v = __fadd_rn(v, p[r][s]);
          }
          run[r] = v;
        }
      }
    }
  }
  if (j == L - 1 && live) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (kFull || r < nr) y[(yrow + r0 + r) * d] = run[r];
  }
}

template <int N, int L, int R, typename X>
__global__ void __launch_bounds__(kChannels * L, 16 / L)
scan_kernel(const float* __restrict__ dt, const X* __restrict__ xi,
            const float* __restrict__ bmat, const float* __restrict__ cmat,
            const float* __restrict__ a_mat, const float* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ h_out, int t_len,
            int d) {
  constexpr int S = (N + L - 1) / L;
  constexpr int kThreads = kChannels * L;
  __shared__ float dts[kTileT][kChannels];
  __shared__ float xis[kTileT][kChannels];
  __shared__ float bs[kTileT * N];
  __shared__ float cs[kTileT * N];
  const long long b = blockIdx.x;
  const int j = threadIdx.x % L;             // this lane's share of states
  const int cl = threadIdx.x / L;            // its channel in the block
  const int ch0 = blockIdx.y * kChannels;
  const int ch = ch0 + cl;
  const bool live = ch < d;
  // states n = j S + s; a state past N (or a channel past D) stays 0 and is
  // neither summed nor stored. Lanes past the D edge still run the steps:
  // the shuffles take the whole warp.
  float a[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = j * S + s;
    const bool ok = live && n < N;
    a[s] = ok ? a_mat[static_cast<long long>(ch) * N + n] : 0.f;
    h[s] = (ok && h0 != nullptr) ? h0[(b * d + ch) * N + n] : 0.f;
  }
  const long long row0 = b * t_len;          // first (b, t) row of this batch
  for (int t0 = 0; t0 < t_len; t0 += kTileT) {
    const int tt = min(kTileT, t_len - t0);
    __syncthreads();                         // the last tile is read
    for (int e = threadIdx.x; e < tt * kChannels; e += kThreads) {
      const int r = e / kChannels, c = e % kChannels;
      const long long idx = (row0 + t0 + r) * d + ch0 + c;
      const bool ok = ch0 + c < d;
      dts[r][c] = ok ? dt[idx] : 0.f;
      xis[r][c] = ok ? bnn::to_float(xi[idx]) : 0.f;
    }
    const float* bsrc = bmat + (row0 + t0) * N;
    const float* csrc = cmat + (row0 + t0) * N;
    for (int i = threadIdx.x; i < tt * N; i += kThreads) {
      bs[i] = bsrc[i];
      cs[i] = csrc[i];
    }
    __syncthreads();
    float* yc = y + ch;
    for (int r0 = 0; r0 < tt; r0 += R) {
      if (r0 + R <= tt)
        run_steps<N, L, R, true>(dts, xis, bs, cs, a, h, yc, row0 + t0, d,
                                 r0, R, cl, j, live);
      else
        run_steps<N, L, R, false>(dts, xis, bs, cs, a, h, yc, row0 + t0, d,
                                  r0, tt - r0, cl, j, live);
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (j * S + s < N) h_out[(b * d + ch) * N + j * S + s] = h[s];
  }
}

template <int N, int L, int R, typename X>
int launch_n(const void* dt, const void* xi, const void* bmat,
             const void* cmat, const void* a_mat, const void* h0, void* y,
             void* h_out, int b, int t, int d, cudaStream_t stream) {
  const dim3 grid(b, (d + kChannels - 1) / kChannels);
  scan_kernel<N, L, R, X><<<grid, kChannels * L, 0, stream>>>(
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
  const bool short_t = t < kRun;
  switch (n) {
#define SCAN_CASE(NN)                                                        \
    case NN:                                                                 \
      return short_t ? launch_n<NN, lanes_for(NN, true), 1, X>(              \
                           dt, xi, bmat, cmat, a_mat, h0, y, h_out, b, t, d, \
                           s)                                                \
                     : launch_n<NN, lanes_for(NN, false), kRun, X>(          \
                           dt, xi, bmat, cmat, a_mat, h0, y, h_out, b, t, d, \
                           s);
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
      (d + kChannels - 1) / kChannels > 65535)
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
