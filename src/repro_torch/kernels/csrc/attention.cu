// Attention over a bit-resident KV cache for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels
//   decode_attention_packed         <- src/repro/kernels/decode_attention.py:137
//   prefill_attention_packed        <- src/repro/kernels/prefill_attention.py:131
//   decode_attention_packed_paged   <- src/repro/kernels/decode_attention.py:214
//   prefill_attention_packed_paged  <- src/repro/kernels/prefill_attention.py:225
// Two kernel bodies: the decode entry points run the panel body
// (`packed_attention_kernel`, a decode step as a one-row chunk at q_pos =
// cache_len - 1), the prefill entry points the T-split body
// (`prefill_kernel`). Each is a template on the cache layout.
//
// Paging is addressing only. The layout maps (batch row b, position t) to
// the cache row holding its (Hkv, hdw) words:
//   Contiguous  (B, T, Hkv, hdw):         row = b*T + t
//   Paged       (P, ps, Hkv, hdw) pool and (B, NP) page table, T = NP*ps:
//               row = min(pt[b*NP + t/ps], P-1)*ps + t%ps
// The word of KV head h is then (row*Hkv + h)*hdw. A sentinel entry (P, an
// unallocated page) clips to page P-1, and the length mask drops its rows,
// as `ref.gather_pages` does: the paged kernels give the contiguous kernels'
// bits on the gathered panel, dots at every position included. They read
// the pool in place, only the rows the table names (V up to the length),
// never a copy of it.
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
// from it) in any order, and the kernels get the plain version's bits
// though they sum in another order; where +-e_t cancel exactly the output
// is exactly 0. A row with no valid position (cache_len 0: the scheduler's
// inactive rows) outputs 0, never NaN.
//
// What bounds it on the card. Per (query row, position) the work is hd/32
// xor+popc words for the score and hd adds for V. A decode step reads
// 2 * T * Hkv * hd / 8 bytes of cache for B * Hq * T * (hd/32) popcs and
// B * Hq * T * hd adds: at G = 4 query heads per KV head that is 32 adds per
// cache byte (fp64 here, at half the card's fp32 rate), so the V
// accumulation, not the bytes, bounds it; the TPU kernel unpacked V to +-1
// floats in VMEM for the same reason. At the LM's sizes both are far below
// a launch, so what a kernel pays for is latency: blocks too few to fill
// the card and chains of dependent loads.
//
// The decode body (simple first). One block per (batch row, KV head); its G
// query rows are sign-packed with the shared ballot (common.cuh), the
// whole (G, T) score panel lives in shared memory (the wrapper checks that
// it fits), one warp per row does the softmax, and one thread per (row, d)
// accumulates V over t from device memory. A later slice moves decode onto
// the prefill body.
//
// The prefill body. The grid is (batch row, KV head, block of bq chunk
// rows, T split); the bq * G <= 32 query rows of a block are a lane each.
//  - Only positions that can be valid: the block's rows see
//    [max(0, q_pos + i0 - window + 1), min(kv_len, q_pos + i1)) (causal; T
//    and kv_len alone bound it otherwise); nothing is read or staged
//    outside it, and shared memory does not grow with T.
//  - The T split: where (row, head, query block) blocks leave the card
//    idle, that range is cut into `split` contiguous shares, one per block
//    of a thread-block cluster (up to 8, within one wave of resident
//    blocks; the rule is the wrapper's `attention_plan`).
//  - The max first, exactly. Every score is dot * scale of an integer dot,
//    so the row max is the max integer dot: pass 1 takes each block's max
//    over its share and the cluster takes the max of those through
//    distributed shared memory. Pass 2 recomputes the dots and takes
//    e_t = exp(dot * scale - m) with that m, as the plain version does (no
//    FMA contraction: the products and differences are rounded apart). An
//    online softmax rescaled by exp(m_old - m_new) would not give these
//    e_t.
//  - V from shared memory, on the fp64 tensor cores. A tile of 64
//    positions' K and V words of head h is staged by cp.async, the next
//    tile's copies in flight while this one is computed. Each lane computes
//    its row's e_t for the tile into shared memory; then acc = E x S, E the
//    (rows, positions) e tile and S the (positions, hd) +-1 signs of V, runs
//    as mma.sync m8n8k4 in double: e_t * (+-1) is exact, so each step is a
//    double addition of +-e_t, as in the plain version. The V adds bound a
//    long context; a 4,096-position chunk ran 1.5x faster this way than
//    with a thread's scalar adds of +-e_t. The blocks' sums meet in the
//    cluster's shared memory, summed in rank order by the block that
//    writes each output. The order of every sum depends on positions only,
//    never on the layout: paged and contiguous give the same bits.
// A prefill call with dots (a check, not the serving path) also has pass 1
// cover every table position, so the dots the kernel uses are returned at
// every position.
#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Geometry {
  int b, s, t, hkv, g, hd, hdw, bq, n_qb, window, causal, decode;
  float scale;
};

// (B, T, Hkv, hdw) cache rows, one panel per batch row
struct Contiguous {
  static constexpr bool kPaged = false;
  int t;
  __device__ __forceinline__ long long row(int b, int pos) const {
    return static_cast<long long>(b) * t + pos;
  }
};

// (P, ps, Hkv, hdw) pool addressed through a (B, NP) page table
struct Paged {
  static constexpr bool kPaged = true;
  const int* __restrict__ table;
  int n_pages, page_size, pool;
  __device__ __forceinline__ long long row(int b, int pos) const {
    const int page = min(table[b * n_pages + pos / page_size], pool - 1);
    return static_cast<long long>(page) * page_size + pos % page_size;
  }
};

__device__ __forceinline__ bool is_valid(int t, int len, int qi, int causal,
                                         int window) {
  return t < len && (!causal || t <= qi) && (window <= 0 || t > qi - window);
}

template <typename T, typename Layout>
__global__ void __launch_bounds__(kThreads)
packed_attention_kernel(const T* __restrict__ q,          // (B, S, Hq, hd)
                        const uint32_t* __restrict__ kc,  // cache or pool
                        const uint32_t* __restrict__ vc,
                        const float* __restrict__ v_scale,  // (B, Hkv)
                        const int* __restrict__ kv_len, int kv_len0,
                        const int* __restrict__ q_pos, int q_pos0,
                        T* __restrict__ out,               // (B, S, Hq, hd)
                        int* __restrict__ dots,            // (B,Hkv,S,G,T) | null
                        Geometry geo, Layout lay) {
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
  const long long kv_row = static_cast<long long>(geo.hkv) * hdw;  // words per row
  // head h's words at this batch row's first position (contiguous), or at
  // the pool's first row (paged: positions go through the page table)
  const long long panel = Layout::kPaged ? 0 : lay.row(b, 0) * kv_row;
  const uint32_t* kb = kc + panel + h * hdw;
  const uint32_t* vb = vc + panel + h * hdw;

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
      const uint32_t* kt = kb + (Layout::kPaged ? lay.row(b, t)
                                                : static_cast<long long>(t)) *
                                                    kv_row;
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

  // 4. V: one thread per (row, d), over the written positions (contiguous:
  //    one pass down the panel; paged: one page at a time, one table read
  //    per page)
  const int t_hi = min(tl, max(len, 0));
  const float vs = v_scale[b * geo.hkv + h];
  for (int o = threadIdx.x; o < rows * hd; o += blockDim.x) {
    const int r = o / hd, d = o % hd;
    const int i = i0 + r / g;
    if (i >= geo.s) continue;
    const float* er = sc + static_cast<long long>(r) * tl;
    const int bit = d & 31;
    double acc = 0.0;
    if constexpr (Layout::kPaged) {
      for (int t0 = 0; t0 < t_hi; t0 += lay.page_size) {
        const int n = min(lay.page_size, t_hi - t0);
        const uint32_t* vd = vb + lay.row(b, t0) * kv_row + (d >> 5);
        for (int j = 0; j < n; ++j) {
          const double e = er[t0 + j];
          acc += ((vd[static_cast<long long>(j) * kv_row] >> bit) & 1u) ? e
                                                                         : -e;
        }
      }
    } else {
      const uint32_t* vd = vb + (d >> 5);
      for (int t = 0; t < t_hi; ++t) {
        const double e = er[t];
        acc += ((vd[static_cast<long long>(t) * kv_row] >> bit) & 1u) ? e : -e;
      }
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

template <typename T, typename Layout>
int launch(const void* q, const void* k, const void* v, const void* v_scale,
           const void* kv_len, int kv_len0, const void* q_pos, int q_pos0,
           void* out, void* dots, Geometry geo, Layout lay, void* stream) {
  if (geo.b <= 0 || geo.s <= 0 || geo.t <= 0 || geo.hkv <= 0 || geo.g <= 0 ||
      geo.hd <= 0 || geo.bq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(geo);
  auto kernel = packed_attention_kernel<T, Layout>;
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
      static_cast<int*>(dots), geo, lay);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The prefill body: T split over a cluster, no score panel
// ---------------------------------------------------------------------------
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;              // query rows of a block at most: a lane each
constexpr int kMaxHd = 256;            // head_dim at most: 4 n8 tiles a warp
constexpr int kMT = kRows / 8;         // m8 tiles of query rows
constexpr int kNT = kMaxHd / 8 / kWarps;  // n8 tiles of head_dim per warp
constexpr int kTile = 64;              // positions per staged K/V tile
constexpr int kEStride = kRows + 8;    // e tile row stride: conflict-free A loads
constexpr int kNoDot = INT_MIN;        // the max of no valid position

// Positions [lo, hi) of a cache row that chunk rows [i0, i1) can see
struct Span {
  int lo, hi;
};

__device__ __forceinline__ Span block_span(int len, int qp, int i0, int i1,
                                           int t, int causal, int window) {
  int hi = min(t, len);
  if (causal) hi = min(hi, qp + i1);
  const int lo = window > 0 ? max(0, qp + i0 - window + 1) : 0;
  return {lo, max(lo, hi)};
}

// Share `rank` of `split` contiguous shares of a span
__device__ __forceinline__ Span rank_span(Span s, int split, int rank) {
  const int per = (s.hi - s.lo + split - 1) / split;
  const int lo = min(s.hi, s.lo + rank * per);
  return {lo, min(s.hi, lo + per)};
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// c += a (8x4, row) x b (4x8, col) on the fp64 tensor cores. Lane l holds
// a[l/4][l%4], b[l%4][l/4] and c[l/4][2(l%4) .. + 1]. Products of e and +-1
// are exact; the sums are double additions, as the plain version's.
__device__ __forceinline__ void mma_f64(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// Shared memory of one block (in this order): V sums (ceil(hd/8)*8, kRows)
// double, l per warp (kWarps, kRows) and per block (kRows) double, an e
// tile (kTile, kEStride) float, max dots per warp and per block int, q words
// (kRows, hdw | 1), K and V tiles (2 stages, kTile, hdw) words.
size_t prefill_smem_bytes(const Geometry& geo) {
  const size_t hdw = static_cast<size_t>(geo.hdw);
  const size_t hd8 = static_cast<size_t>(geo.hd + 7) / 8 * 8;
  return hd8 * kRows * 8 + (kWarps + 1) * kRows * 8 + kTile * kEStride * 4 +
         (kWarps + 1) * kRows * 4 + kRows * (hdw | 1) * 4 +
         4 * kTile * hdw * 4;
}

template <typename T, typename Layout>
__global__ void __launch_bounds__(kThreads, 2)
prefill_kernel(const T* __restrict__ q,           // (B, S, Hq, hd)
               const uint32_t* __restrict__ kc,   // cache or pool
               const uint32_t* __restrict__ vc,
               const float* __restrict__ v_scale,  // (B, Hkv)
               const int* __restrict__ kv_len, int kv_len0,
               const int* __restrict__ q_pos, int q_pos0,
               T* __restrict__ out,               // (B, S, Hq, hd)
               int* __restrict__ dots,            // (B, Hkv, S, G, T) | null
               Geometry geo, Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = geo.g, hd = geo.hd, hdw = geo.hdw;
  const int rows = geo.bq * g;
  const int n_tiles = (hd + 7) / 8;        // n8 tiles of head_dim
  const int qs = hdw | 1;                  // odd q row stride: no conflicts
  double* part = reinterpret_cast<double*>(smem);        // 8 n_tiles * kRows
  double* lw = part + 8 * n_tiles * kRows;               // kWarps * kRows
  double* lrow = lw + kWarps * kRows;                    // kRows
  float* et = reinterpret_cast<float*>(lrow + kRows);    // kTile * kEStride
  int* mw = reinterpret_cast<int*>(et + kTile * kEStride);  // kWarps * kRows
  int* mrow = mw + kWarps * kRows;                       // kRows
  uint32_t* qw = reinterpret_cast<uint32_t*>(mrow + kRows);  // kRows * qs
  uint32_t* kt = qw + kRows * qs;                        // 2 * kTile * hdw
  uint32_t* vt = kt + 2 * kTile * hdw;                   // 2 * kTile * hdw

  const int blk = static_cast<int>(blockIdx.x) / split;
  const int qb = blk % geo.n_qb;
  const int h = (blk / geo.n_qb) % geo.hkv;
  const int b = blk / (geo.n_qb * geo.hkv);
  const int i0 = qb * geo.bq, i1 = min(geo.s, i0 + geo.bq);
  const int hq = geo.hkv * g;
  const int len = kv_len ? kv_len[b] : kv_len0;
  const int qp = q_pos ? q_pos[b] : q_pos0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long kv_row = static_cast<long long>(geo.hkv) * hdw;
  // lane r's query row: chunk row i, query head h * G + r % G
  const int i = i0 + lane / g;
  const bool live = lane < rows && i < i1;

  // the block's query rows, sign-packed a word per thread, all loads in
  // flight together (16-byte loads where hd and q allow; rows past S are
  // never read)
  const bool qvec = hd % (16 / static_cast<int>(sizeof(T))) == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0;
  for (int e = tid; e < rows * hdw; e += kThreads) {
    const int r = e / hdw, w = e % hdw;
    const int ii = i0 + r / g;
    const T* qrow = q + ((static_cast<long long>(b) * geo.s + ii) * hq +
                         h * g + r % g) * hd;
    uint32_t word = 0xFFFFFFFFu;
    if (ii < geo.s)
      word = qvec ? bnn::pack_own_word<T, true>(qrow, 32LL * w, hd)
                  : bnn::pack_own_word<T, false>(qrow, 32LL * w, hd);
    qw[r * qs + w] = word;
  }

  // positions [p, p + n) of head h's K (and V) words into tile stage `st`
  auto stage = [&](int st, int p, int n, bool with_v) {
    uint32_t* kd = kt + st * kTile * hdw;
    uint32_t* vd = vt + st * kTile * hdw;
    for (int e = tid; e < n * hdw; e += kThreads) {
      const int j = e / hdw, w = e % hdw;
      const long long src = lay.row(b, p + j) * kv_row + h * hdw + w;
      cp_async4(kd + e, kc + src);
      if (with_v) cp_async4(vd + e, vc + src);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // lane's dot against the position at `kw` (hdw staged words)
  auto dot_at = [&](const uint32_t* kw) {
    int pop = 0;
    for (int w = 0; w < hdw; ++w) pop += __popc(qw[lane * qs + w] ^ kw[w]);
    return hd - 2 * pop;
  };
  // body(st, p, n) over the tiles of [lo, hi), the next tile's copies in
  // flight while this one is computed; `staged`: the first is in stage 0
  auto tiles = [&](Span sp, bool with_v, bool staged, auto&& body) {
    if (sp.lo < sp.hi && !staged) stage(0, sp.lo, min(kTile, sp.hi - sp.lo),
                                        with_v);
    for (int p = sp.lo, st = 0; p < sp.hi; p += kTile, st ^= 1) {
      if (p + kTile < sp.hi) {
        stage(st ^ 1, p + kTile, min(kTile, sp.hi - p - kTile), with_v);
        cp_async_wait_one();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      body(st, p, min(kTile, sp.hi - p));
      __syncthreads();
    }
  };

  const Span mine = rank_span(
      block_span(len, qp, i0, i1, geo.t, geo.causal, geo.window), split, rank);
  // pass 2 reuses pass 1's tile where its share is one tile and no dots
  // widen pass 1
  const bool keep = !dots && mine.hi - mine.lo <= kTile;

  // 1. this block's max dot per row over its share (with dots: over its
  //    share of every table position, all written out)
  const Span scan = dots ? rank_span(Span{0, geo.t}, split, rank) : mine;
  int mx = kNoDot;
  tiles(scan, keep, false, [&](int st, int p, int n) {
    for (int j = warp; j < n; j += kWarps) {
      if (!live) continue;
      const int t = p + j;
      const int d = dot_at(kt + (st * kTile + j) * hdw);
      if (dots)
        dots[(((static_cast<long long>(b) * geo.hkv + h) * geo.s + i) * g +
              lane % g) * geo.t + t] = d;
      if (is_valid(t, len, qp + i, geo.causal, geo.window)) mx = max(mx, d);
    }
  });
  mw[warp * kRows + lane] = mx;
  __syncthreads();
  if (warp == 0) {
    int m = kNoDot;
    for (int w = 0; w < kWarps; ++w) m = max(m, mw[w * kRows + lane]);
    mrow[lane] = m;
  }
  cluster.sync();
  int gm = kNoDot;                         // the row's max over the cluster
#pragma unroll
  for (int r = 0; r < bnn::kMaxSplit; ++r)
    if (r < split) gm = max(gm, cluster.map_shared_rank(mrow, r)[lane]);
  const float m = gm == kNoDot ? 0.f
                               : __fmul_rn(static_cast<float>(gm), geo.scale);

  // 2. e_t and the sums: per tile, lane r's e_t into the e tile (0 past
  //    the share and for invalid positions), then acc[row][d] += e x +-1
  //    on the fp64 tensor cores, 4 positions a step; warp w holds the n8
  //    tiles w, w + 8, ... of head_dim for every m8 tile of rows
  const int gq = lane >> 2, tq = lane & 3;  // mma group, thread in group
  double acc[kMT][kNT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int s = 0; s < kNT; ++s) acc[mt][s][0] = acc[mt][s][1] = 0.0;
  double lacc = 0.0;
  tiles(mine, true, keep, [&](int st, int p, int n) {
    const int n4 = (n + 3) & ~3;
    for (int j = warp; j < n4; j += kWarps) {
      const int t = p + j;
      float e = 0.f;
      if (live && j < n && is_valid(t, len, qp + i, geo.causal, geo.window)) {
        const float sc = __fmul_rn(
            static_cast<float>(dot_at(kt + (st * kTile + j) * hdw)), geo.scale);
        e = expf(__fsub_rn(sc, m));
      }
      et[j * kEStride + lane] = e;
      lacc += e;
    }
    __syncthreads();
    const uint32_t* vtile = vt + st * kTile * hdw;
    for (int k0 = 0; k0 < n4; k0 += 4) {
      double a[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        a[mt] = et[(k0 + tq) * kEStride + mt * 8 + gq];
      const uint32_t* vrow = vtile + (k0 + tq) * hdw;
#pragma unroll
      for (int s = 0; s < kNT; ++s) {
        const int d = (warp + kWarps * s) * 8 + gq;
        if (d >= 8 * n_tiles) break;           // uniform across the warp
        const double b = (vrow[d >> 5] >> (d & 31)) & 1u ? 1.0 : -1.0;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          if (8 * mt < rows) mma_f64(acc[mt][s], a[mt], b);
      }
    }
  });
#pragma unroll
  for (int s = 0; s < kNT; ++s) {
    const int d = (warp + kWarps * s) * 8 + 2 * tq;
    if (d >= 8 * n_tiles) break;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      part[d * kRows + mt * 8 + gq] = acc[mt][s][0];
      part[(d + 1) * kRows + mt * 8 + gq] = acc[mt][s][1];
    }
  }
  lw[warp * kRows + lane] = lacc;
  __syncthreads();
  if (warp == 0) {
    double l = 0.0;
    for (int w = 0; w < kWarps; ++w) l += lw[w * kRows + lane];
    lrow[lane] = l;
  }
  cluster.sync();

  // 3. block `rank` writes outputs rank, rank + split, ... (in 256-wide
  //    runs), summing the blocks' sums in rank order
  const float vs = v_scale[b * geo.hkv + h];
  for (int e = rank * kThreads + tid; e < rows * hd; e += split * kThreads) {
    const int r = e / hd, d = e % hd;
    const int ii = i0 + r / g;
    if (ii >= i1) continue;
    const int at = d * kRows + r;
    double a = 0.0, l = 0.0;
#pragma unroll
    for (int q2 = 0; q2 < bnn::kMaxSplit; ++q2) {
      if (q2 < split) {
        a += cluster.map_shared_rank(part, q2)[at];
        l += cluster.map_shared_rank(lrow, q2)[r];
      }
    }
    const float lf = static_cast<float>(l);
    const float y = lf > 0.f ? vs * (static_cast<float>(a) / lf) : 0.f;
    out[((static_cast<long long>(b) * geo.s + ii) * hq + h * g + r % g) * hd +
        d] = bnn::from_float(y, static_cast<T*>(nullptr));
  }
  cluster.sync();              // keep this block's sums alive for the others
}

template <typename T, typename Layout>
int launch_prefill(const void* q, const void* k, const void* v,
                   const void* v_scale, const void* kv_len, int kv_len0,
                   const void* q_pos, int q_pos0, void* out, void* dots,
                   Geometry geo, Layout lay, int split, void* stream) {
  const int rows = geo.bq * geo.g;
  if (geo.b <= 0 || geo.s <= 0 || geo.t <= 0 || geo.hkv <= 0 || geo.g <= 0 ||
      geo.hd <= 0 || geo.hd > kMaxHd || geo.bq <= 0 || rows > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>(geo.b) * geo.hkv * geo.n_qb * split;
  return bnn::launch_cluster(
      prefill_kernel<T, Layout>, blocks, kThreads, split,
      static_cast<int>(prefill_smem_bytes(geo)), stream,
      static_cast<const T*>(q), static_cast<const uint32_t*>(k),
      static_cast<const uint32_t*>(v), static_cast<const float*>(v_scale),
      static_cast<const int*>(kv_len), kv_len0,
      static_cast<const int*>(q_pos), q_pos0, static_cast<T*>(out),
      static_cast<int*>(dots), geo, lay);
}

// split 0: the decode body; 1, 2, 4 or 8: the prefill body, in clusters of
// that many blocks along T
template <typename Layout>
int dispatch(int q_bf16, const void* q, const void* k, const void* v,
             const void* v_scale, const void* kv_len, int kv_len0,
             const void* q_pos, int q_pos0, void* out, void* dots,
             Geometry geo, Layout lay, int split, void* stream) {
  geo.hdw = (geo.hd + 31) / 32;
  geo.n_qb = (geo.s + geo.bq - 1) / geo.bq;
  if (split > 0) {
    if (q_bf16)
      return launch_prefill<__nv_bfloat16>(q, k, v, v_scale, kv_len, kv_len0,
                                           q_pos, q_pos0, out, dots, geo, lay,
                                           split, stream);
    return launch_prefill<float>(q, k, v, v_scale, kv_len, kv_len0, q_pos,
                                 q_pos0, out, dots, geo, lay, split, stream);
  }
  if (q_bf16)
    return launch<__nv_bfloat16>(q, k, v, v_scale, kv_len, kv_len0, q_pos,
                                 q_pos0, out, dots, geo, lay, stream);
  return launch<float>(q, k, v, v_scale, kv_len, kv_len0, q_pos, q_pos0, out,
                       dots, geo, lay, stream);
}

Paged paged_layout(const void* page_table, int n_pages, int page_size,
                   int pool) {
  return Paged{static_cast<const int*>(page_table), n_pages, page_size, pool};
}

bool paged_ok(const void* page_table, int n_pages, int page_size, int pool) {
  return page_table && n_pages > 0 && page_size > 0 && pool > 0 &&
         static_cast<long long>(n_pages) * page_size <= 0x7fffffffLL;
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
                  dots, geo, Contiguous{t}, 0, stream);
}

// q (b, s, hkv*g, hd); k, v, v_scale as above; kv_len and q_pos (b,) int32,
// or null with the scalar kv_len0 / q_pos0 for every row -> out
// (b, s, hkv*g, hd). bq chunk rows per block (bq * g <= 32, bq * g *
// ceil(hd/32) <= 256), split blocks per cluster along T (1, 2, 4 or 8);
// dots (b, hkv, s, g, t) or null.
int prefill_attention_packed(const void* q, int q_bf16, const void* k,
                             const void* v, const void* v_scale,
                             const void* kv_len, int kv_len0,
                             const void* q_pos, int q_pos0, void* out,
                             void* dots, int b, int s, int t, int hkv, int g,
                             int hd, int bq, int split, int window,
                             int causal, float scale, void* stream) {
  if (split < 1) return static_cast<int>(cudaErrorInvalidValue);
  Geometry geo{b, s, t, hkv, g, hd, 0, bq, 0, window, causal, 0, scale};
  return dispatch(q_bf16, q, k, v, v_scale, kv_len, kv_len0, q_pos, q_pos0,
                  out, dots, geo, Contiguous{t}, split, stream);
}

// The paged twins. k_pool, v_pool (pool, page_size, hkv, ceil(hd/32)) int32
// words; page_table (b, n_pages) int32, entries in [0, pool] (pool: the
// unallocated sentinel); the rest as in the contiguous entry points with
// t = n_pages * page_size (dots are (b, hkv, g, t) / (b, hkv, s, g, t)).
int decode_attention_packed_paged(const void* q, int q_bf16,
                                  const void* k_pool, const void* v_pool,
                                  const void* v_scale, const void* page_table,
                                  const void* cache_len, void* out,
                                  void* dots, int b, int n_pages,
                                  int page_size, int pool, int hkv, int g,
                                  int hd, int window, float scale,
                                  void* stream) {
  if (!paged_ok(page_table, n_pages, page_size, pool))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry geo{b, 1, n_pages * page_size, hkv, g, hd, 0, 1, 0, window, 1, 1,
               scale};
  return dispatch(q_bf16, q, k_pool, v_pool, v_scale, cache_len, 0, nullptr,
                  0, out, dots, geo,
                  paged_layout(page_table, n_pages, page_size, pool), 0,
                  stream);
}

int prefill_attention_packed_paged(const void* q, int q_bf16,
                                   const void* k_pool, const void* v_pool,
                                   const void* v_scale, const void* page_table,
                                   const void* kv_len, int kv_len0,
                                   const void* q_pos, int q_pos0, void* out,
                                   void* dots, int b, int s, int n_pages,
                                   int page_size, int pool, int hkv, int g,
                                   int hd, int bq, int split, int window,
                                   int causal, float scale, void* stream) {
  if (!paged_ok(page_table, n_pages, page_size, pool) || split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry geo{b, s, n_pages * page_size, hkv, g, hd, 0, bq, 0, window,
               causal, 0, scale};
  return dispatch(q_bf16, q, k_pool, v_pool, v_scale, kv_len, kv_len0, q_pos,
                  q_pos0, out, dots, geo,
                  paged_layout(page_table, n_pages, page_size, pool), split,
                  stream);
}

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
