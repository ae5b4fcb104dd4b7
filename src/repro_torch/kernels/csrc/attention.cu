// Attention over a bit-resident KV cache for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels
//   decode_attention_packed   <- src/repro/kernels/decode_attention.py:137
//   prefill_attention_packed  <- src/repro/kernels/prefill_attention.py:131
// Both entry points run one kernel (a decode step is a one-row chunk at
// q_pos = cache_len - 1), so the two share every float operation.
//
// Semantics (src/repro_torch/kernels/ref.py): K and V are sign bitplanes,
// (B, T, Hkv, ceil(hd/32)) words packed along head_dim, pad bits 1.
//   dot_t   = hd - 2 * popcount(q_bits ^ k_bits_t)          (integer, exact)
//   s_t     = float(dot_t) * (1/sqrt(hd))
//   valid_t = t < kv_len [& t <= q_pos + i] [& t > q_pos + i - window]
//   m = max_t s_t,  e_t = valid_t ? exp(s_t - m) : 0,  l = sum_t e_t
//   acc_d   = sum_t e_t * sign(v_t,d)
//   out_d   = l > 0 ? v_scale * (acc_d / l) : 0
// l and acc are summed in double and rounded once to float: their float
// terms lie in (2^-33, 1], so the sums are exact (or one double rounding
// from it) in any order, and the kernel gets the plain version's bits even
// though it sums in another order; where +-e_t cancel exactly the output is
// exactly 0. A row with no valid position (cache_len 0: the scheduler's
// inactive rows) outputs 0, never NaN.
//
// What bounds it on the card. Per (query row, position) the work is hd/32
// xor+popc words for the score and hd adds for V. A decode step reads
// 2 * T * Hkv * hd / 8 bytes of cache for B * Hq * T * (hd/32) popcs and
// B * Hq * T * hd adds: at G = 4 query heads per KV head that is 32 adds per
// cache byte (fp64 here, at half the card's fp32 rate), so the V
// accumulation, not the bytes, bounds it; the TPU kernel unpacked V to +-1
// floats in VMEM for the same reason.
//
// What the design does about it (simple first). One block per (batch row,
// KV head, sub-block of bq query rows); its bq * G query rows are sign-packed
// in the block with the shared ballot (common.cuh), the whole (rows, T) score
// panel lives in shared memory (the TPU kernel held the whole (T, hdw) panel
// in VMEM the same way; the wrapper checks that it fits), one warp per row
// does the softmax, and one thread per (row, d) accumulates V over t reading
// one word per 32 lanes (a broadcast). Positions >= kv_len are never read for
// V. No T tiling, no tensor cores: a later PR makes it fast.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Geometry {
  int b, s, t, hkv, g, hd, hdw, bq, n_qb, window, causal, decode;
  float scale;
};

__device__ __forceinline__ bool is_valid(int t, int len, int qi, int causal,
                                         int window) {
  return t < len && (!causal || t <= qi) && (window <= 0 || t > qi - window);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
packed_attention_kernel(const T* __restrict__ q,          // (B, S, Hq, hd)
                        const uint32_t* __restrict__ kc,  // (B, T, Hkv, hdw)
                        const uint32_t* __restrict__ vc,
                        const float* __restrict__ v_scale,  // (B, Hkv)
                        const int* __restrict__ kv_len, int kv_len0,
                        const int* __restrict__ q_pos, int q_pos0,
                        T* __restrict__ out,               // (B, S, Hq, hd)
                        int* __restrict__ dots,            // (B,Hkv,S,G,T) | null
                        Geometry geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = geo.g, hd = geo.hd, hdw = geo.hdw, tl = geo.t;
  const int rows = geo.bq * g;
  uint32_t* qw = reinterpret_cast<uint32_t*>(smem);           // rows * hdw
  float* sc = reinterpret_cast<float*>(qw + rows * hdw);      // rows * T
  float* lsum = sc + static_cast<long long>(rows) * tl;       // rows

  const int qb = blockIdx.x % geo.n_qb;
  const int h = (blockIdx.x / geo.n_qb) % geo.hkv;
  const int b = blockIdx.x / (geo.n_qb * geo.hkv);
  const int i0 = qb * geo.bq;
  const int hq = geo.hkv * g;
  const int len = kv_len ? kv_len[b] : kv_len0;
  const int qp = geo.decode ? len - 1 : (q_pos ? q_pos[b] : q_pos0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const long long kv_row = static_cast<long long>(geo.hkv) * hdw;  // words per t
  const uint32_t* kb = kc + static_cast<long long>(b) * tl * kv_row + h * hdw;
  const uint32_t* vb = vc + static_cast<long long>(b) * tl * kv_row + h * hdw;

  // 1. sign-pack the block's query rows; row r = (i, gg) reads head h*G+gg
  for (int e = warp; e < rows * hdw; e += nwarps) {
    const int r = e / hdw, w = e % hdw;
    const int i = i0 + r / g;
    // rows past S pack to all-ones; their scores are never used
    const T* qrow = q + ((static_cast<long long>(b) * geo.s + i) * hq +
                         h * g + r % g) * hd;
    const uint32_t word = bnn::pack_word(
        qrow, static_cast<long long>(w) * 32 + lane, hd, i < geo.s);
    if (lane == 0) qw[e] = word;
  }
  __syncthreads();

  // 2. integer dots and scaled, masked scores
  for (long long e = threadIdx.x; e < static_cast<long long>(rows) * tl;
       e += blockDim.x) {
    const int r = static_cast<int>(e / tl), t = static_cast<int>(e % tl);
    const int i = i0 + r / g;
    const bool valid = i < geo.s && is_valid(t, len, qp + i, geo.causal,
                                             geo.window);
    float s = kNegInf;
    if (i < geo.s && (valid || dots)) {
      const uint32_t* kt = kb + static_cast<long long>(t) * kv_row;
      int pop = 0;
      for (int w = 0; w < hdw; ++w) pop += __popc(qw[r * hdw + w] ^ kt[w]);
      const int dot = hd - 2 * pop;
      if (dots)
        dots[(((static_cast<long long>(b) * geo.hkv + h) * geo.s + i) * g +
              r % g) * tl + t] = dot;
      if (valid) s = static_cast<float>(dot) * geo.scale;
    }
    sc[e] = s;
  }
  __syncthreads();

  // 3. softmax weights, one warp per row: e_t in place of s_t, l in lsum
  for (int r = warp; r < rows; r += nwarps) {
    const int i = i0 + r / g;
    if (i >= geo.s) continue;  // uniform across the warp
    float* sr = sc + static_cast<long long>(r) * tl;
    float m = kNegInf;
    for (int t = lane; t < tl; t += 32) m = fmaxf(m, sr[t]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    double l = 0.0;
    for (int t = lane; t < tl; t += 32) {
      const float e = is_valid(t, len, qp + i, geo.causal, geo.window)
                          ? expf(sr[t] - m) : 0.f;
      sr[t] = e;
      l += e;
    }
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) lsum[r] = static_cast<float>(l);
  }
  __syncthreads();

  // 4. V: one thread per (row, d), over the written positions
  const int t_hi = min(tl, max(len, 0));
  const float vs = v_scale[b * geo.hkv + h];
  for (int o = threadIdx.x; o < rows * hd; o += blockDim.x) {
    const int r = o / hd, d = o % hd;
    const int i = i0 + r / g;
    if (i >= geo.s) continue;
    const float* er = sc + static_cast<long long>(r) * tl;
    const uint32_t* vd = vb + (d >> 5);
    const int bit = d & 31;
    double acc = 0.0;
    for (int t = 0; t < t_hi; ++t) {
      const double e = er[t];
      acc += ((vd[static_cast<long long>(t) * kv_row] >> bit) & 1u) ? e : -e;
    }
    const float l = lsum[r];
    const float y = l > 0.f ? vs * (static_cast<float>(acc) / l) : 0.f;
    out[((static_cast<long long>(b) * geo.s + i) * hq + h * g + r % g) * hd + d] =
        bnn::from_float(y, static_cast<T*>(nullptr));
  }
}

size_t smem_bytes(const Geometry& geo) {
  const size_t rows = static_cast<size_t>(geo.bq) * geo.g;
  return rows * geo.hdw * 4 + rows * geo.t * 4 + rows * 4;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* v_scale,
           const void* kv_len, int kv_len0, const void* q_pos, int q_pos0,
           void* out, void* dots, Geometry geo, void* stream) {
  if (geo.b <= 0 || geo.s <= 0 || geo.t <= 0 || geo.hkv <= 0 || geo.g <= 0 ||
      geo.hd <= 0 || geo.bq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(geo);
  auto kernel = packed_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(geo.b) * geo.hkv * geo.n_qb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const uint32_t*>(k),
      static_cast<const uint32_t*>(v), static_cast<const float*>(v_scale),
      static_cast<const int*>(kv_len), kv_len0,
      static_cast<const int*>(q_pos), q_pos0, static_cast<T*>(out),
      static_cast<int*>(dots), geo);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int q_bf16, const void* q, const void* k, const void* v,
             const void* v_scale, const void* kv_len, int kv_len0,
             const void* q_pos, int q_pos0, void* out, void* dots,
             Geometry geo, void* stream) {
  geo.hdw = (geo.hd + 31) / 32;
  geo.n_qb = (geo.s + geo.bq - 1) / geo.bq;
  if (q_bf16)
    return launch<__nv_bfloat16>(q, k, v, v_scale, kv_len, kv_len0, q_pos,
                                 q_pos0, out, dots, geo, stream);
  return launch<float>(q, k, v, v_scale, kv_len, kv_len0, q_pos, q_pos0, out,
                       dots, geo, stream);
}

}  // namespace

extern "C" {

// q (b, 1, hkv*g, hd) float32 | bfloat16; k, v (b, t, hkv, ceil(hd/32))
// int32 words; v_scale (b, hkv) float32; cache_len (b,) int32 -> out
// (b, 1, hkv*g, hd) in q's type. dots (b, hkv, g, t) int32 or null.
int decode_attention_packed(const void* q, int q_bf16, const void* k,
                            const void* v, const void* v_scale,
                            const void* cache_len, void* out, void* dots,
                            int b, int t, int hkv, int g, int hd, int window,
                            float scale, void* stream) {
  Geometry geo{b, 1, t, hkv, g, hd, 0, 1, 0, window, 1, 1, scale};
  return dispatch(q_bf16, q, k, v, v_scale, cache_len, 0, nullptr, 0, out,
                  dots, geo, stream);
}

// q (b, s, hkv*g, hd); k, v, v_scale as above; kv_len and q_pos (b,) int32,
// or null with the scalar kv_len0 / q_pos0 for every row -> out
// (b, s, hkv*g, hd). bq query rows per block; dots (b, hkv, s, g, t) or null.
int prefill_attention_packed(const void* q, int q_bf16, const void* k,
                             const void* v, const void* v_scale,
                             const void* kv_len, int kv_len0,
                             const void* q_pos, int q_pos0, void* out,
                             void* dots, int b, int s, int t, int hkv, int g,
                             int hd, int bq, int window, int causal,
                             float scale, void* stream) {
  Geometry geo{b, s, t, hkv, g, hd, 0, bq, 0, window, causal, 0, scale};
  return dispatch(q_bf16, q, k, v, v_scale, kv_len, kv_len0, q_pos, q_pos0,
                  out, dots, geo, stream);
}

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
