// Attention over a bit-resident KV cache for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels
//   decode_attention_packed         <- src/repro/kernels/decode_attention.py:137
//   prefill_attention_packed        <- src/repro/kernels/prefill_attention.py:131
//   decode_attention_packed_paged   <- src/repro/kernels/decode_attention.py:214
//   prefill_attention_packed_paged  <- src/repro/kernels/prefill_attention.py:225
// One kernel body (`attention_kernel`) serves all four entry points: a
// decode step is a one-row chunk at q_pos = cache_len - 1, which the body
// reads from the length itself. It is a template on the cache layout and on
// the query rows a block holds (8 or 32).
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
// is exactly 0. A decode row of cache_len 0 (the scheduler's inactive rows)
// weighs every position of its row alike, as the JAX oracle's softmax over
// all-masked scores does (e_t = exp(NEG_INF - NEG_INF) = 1 for all t < T):
// out_d = v_scale * (sum_t sign(v_t,d) / T), over the whole row (paged:
// through the table, sentinels clipped to page P-1). A MoE's inactive rows
// take expert capacity, so their values reach the active rows. Any other
// row with no valid position (a chunk's pad rows under a window) outputs
// 0, never NaN.
//
// What bounds it on the card. Per (query row, position) the work is hd/32
// xor+popc words for the score and hd adds for V. A decode step reads
// 2 * T * Hkv * hd / 8 bytes of cache for B * Hq * T * (hd/32) popcs and
// B * Hq * T * hd adds: at G = 4 query heads per KV head that is 32 adds per
// cache byte (fp64 here), so the V accumulation, not the bytes, bounds it;
// the TPU kernel unpacked V to +-1 floats in VMEM for the same reason. At
// the LM's sizes both are far below a launch, so what a kernel pays for is
// latency: blocks too few to fill the card and chains of dependent loads.
//
// The body. The grid is (batch row, KV head, block of bq chunk rows, T
// split); a block holds bq * G <= 32 query rows, a decode block G of them.
//  - Lanes on (row, position) pairs: in a block of at most 8 rows a warp's
//    lanes are cut into groups of `rl` (rows rounded up to a power of 2),
//    one position per group, so a decode block of 4 rows takes 8 positions
//    a warp at once; in a 32-row block each lane takes a row.
//  - Only positions that can be valid: the block's rows see
//    [max(0, q_pos + i0 - window + 1), min(kv_len, q_pos + i1)) (causal; T
//    and kv_len alone bound it otherwise); nothing is read or staged
//    outside it, and shared memory does not grow with T.
//  - The T split: where (row, head, query block) blocks leave the card
//    idle, that range is cut into `split` contiguous shares, one per block
//    of a thread-block cluster (up to 8, within one wave of resident
//    blocks; the rule is the wrapper's `attention_plan`). A block of at
//    most 8 rows keeps fewer sums in registers and shared memory, so 3 fit
//    an SM where 2 of 32 rows do.
//  - A share held whole: where its K and V words fit `hold` positions
//    (32 KB), they are copied in at once and both passes read them from
//    shared memory: one round trip to device memory, not one per tile and
//    pass (a 32-row chunk at T 4,096 ran 9% faster so). A longer share
//    streams through a ring of two 64-position tiles, the next tile's
//    copies in flight while this one is computed.
//  - The max first, exactly. Every score is dot * scale of an integer dot,
//    so the row max is the max integer dot: pass 1 takes each block's max
//    over its share and the cluster takes the max of those through
//    distributed shared memory. Pass 2 recomputes the dots and takes
//    e_t = exp(dot * scale - m) with that m, as the plain version does (no
//    FMA contraction: the products and differences are rounded apart). An
//    online softmax rescaled by exp(m_old - m_new) would not give these
//    e_t.
//  - V on the fp64 tensor cores. Per 64-position tile the lanes write their
//    e_t into an e tile in shared memory; then acc = E x S, E the (rows,
//    positions) e tile and S the (positions, hd) +-1 signs of V, runs as
//    mma.sync m8n8k4 in double: e_t * (+-1) is exact, so each step is a
//    double addition of +-e_t, as in the plain version. The blocks' sums
//    meet in the cluster's shared memory, summed in rank order by the block
//    that writes each output. The order of every sum depends on positions
//    only, never on the layout or on whether a share is held or streamed:
//    paged and contiguous give the same bits.
// A call with dots (a check, not the serving path) streams, and pass 1
// covers every table position, so the dots the kernel uses are returned at
// every position.
#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;           // query rows of a block at most
constexpr int kMaxHd = 256;            // head_dim at most: 4 n8 tiles a warp
constexpr int kNT = kMaxHd / 8 / kWarps;  // n8 tiles of head_dim per warp
constexpr int kTile = 64;              // positions per e tile and ring stage
constexpr int kHoldBytes = 32 * 1024;  // K and V words of a share held whole
constexpr int kNoDot = INT_MIN;        // the max of no valid position

struct Geometry {
  int b, s, t, hkv, g, hd, hdw, bq, n_qb, window, causal, decode, hold;
  float scale;
};

// (B, T, Hkv, hdw) cache rows, one panel per batch row
struct Contiguous {
  int t;
  __device__ __forceinline__ long long row(int b, int pos) const {
    return static_cast<long long>(b) * t + pos;
  }
};

// (P, ps, Hkv, hdw) pool addressed through a (B, NP) page table
struct Paged {
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
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

// e tile row stride of a block of kRows rows: conflict-free A loads
template <int kRows>
__host__ __device__ constexpr int e_stride() {
  return kRows > 8 ? kRows + 8 : kRows;
}

// Shared memory of one block of kRows rows (in this order): K and V words
// (a held share of `hold` positions, or a ring of 2 tiles), V sums
// (ceil(hd/8)*8, kRows) double, l per lane (kWarps, 32) and per row (kRows)
// double, an e tile (kTile, e_stride) float, max dots per lane and per row
// int, q words (kRows, hdw | 1).
template <int kRows>
size_t smem_bytes(const Geometry& geo) {
  const size_t hdw = static_cast<size_t>(geo.hdw);
  const size_t hd8 = static_cast<size_t>(geo.hd + 7) / 8 * 8;
  const size_t kv = static_cast<size_t>(max(2 * geo.hold, 4 * kTile)) * hdw;
  return kv * 4 + hd8 * kRows * 8 + (kWarps * 32 + kRows) * 8 +
         kTile * e_stride<kRows>() * 4 + (kWarps * 32 + kRows) * 4 +
         kRows * (hdw | 1) * 4;
}

template <typename T, typename Layout, int kRows>
__global__ void __launch_bounds__(kThreads, kRows == 8 ? 3 : 2)
attention_kernel(const T* __restrict__ q,           // (B, S, Hq, hd)
                 const uint32_t* __restrict__ kc,   // cache or pool
                 const uint32_t* __restrict__ vc,
                 const float* __restrict__ v_scale,  // (B, Hkv)
                 const int* __restrict__ kv_len, int kv_len0,
                 const int* __restrict__ q_pos, int q_pos0,
                 T* __restrict__ out,               // (B, S, Hq, hd)
                 int* __restrict__ dots,            // (B, Hkv, S, G, T) | null
                 Geometry geo, Layout lay) {
  constexpr int kMT = kRows / 8;           // m8 tiles of query rows
  constexpr int kES = e_stride<kRows>();
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = geo.g, hd = geo.hd, hdw = geo.hdw;
  const int rows = geo.bq * g;
  const int n_tiles = (hd + 7) / 8;        // n8 tiles of head_dim
  const int qs = hdw | 1;                  // odd q row stride: no conflicts
  const int kv_words = max(2 * geo.hold, 4 * kTile) * hdw;
  uint32_t* kvw = reinterpret_cast<uint32_t*>(smem);          // kv_words
  double* part = reinterpret_cast<double*>(kvw + kv_words);   // 8 n_tiles * kRows
  double* lw = part + 8 * n_tiles * kRows;                    // kWarps * 32
  double* lrow = lw + kWarps * 32;                            // kRows
  float* et = reinterpret_cast<float*>(lrow + kRows);         // kTile * kES
  int* mw = reinterpret_cast<int*>(et + kTile * kES);         // kWarps * 32
  int* mrow = mw + kWarps * 32;                               // kRows
  uint32_t* qw = reinterpret_cast<uint32_t*>(mrow + kRows);   // kRows * qs

  const int blk = static_cast<int>(blockIdx.x) / split;
  const int qb = blk % geo.n_qb;
  const int h = (blk / geo.n_qb) % geo.hkv;
  const int b = blk / (geo.n_qb * geo.hkv);
  const int i0 = qb * geo.bq, i1 = min(geo.s, i0 + geo.bq);
  const int hq = geo.hkv * g;
  const int len0 = kv_len ? kv_len[b] : kv_len0;
  // a decode row of length 0 reads its whole row, every position weighing 1
  const bool flat = geo.decode && len0 == 0;
  const int len = flat ? geo.t : len0;
  const int window = flat ? 0 : geo.window;
  const int qp = geo.decode ? len - 1 : (q_pos ? q_pos[b] : q_pos0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long kv_row = static_cast<long long>(geo.hkv) * hdw;
  // lanes in groups of rl, one position per group: lane = sub * rl + r
  // takes query row r (chunk row i, query head h * G + r % G); in a 32-row
  // block each lane takes a row (pairs ran slower there)
  const int rl = kRows == kMaxRows ? 32
                                   : rows <= 1 ? 1 : 1 << (32 - __clz(rows - 1));
  const int pp = 32 / rl;                  // positions a warp takes at once
  const int r = lane & (rl - 1), sub = lane / rl;
  const int i = i0 + r / g;
  const bool live = r < rows && i < i1;

  // the block's query rows, sign-packed a word per thread, all loads in
  // flight together (16-byte loads where hd and q allow; rows past S are
  // never read)
  const bool qvec = hd % (16 / static_cast<int>(sizeof(T))) == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0;
  for (int e = tid; e < rows * hdw; e += kThreads) {
    const int rr = e / hdw, w = e % hdw;
    const int ii = i0 + rr / g;
    const T* qrow = q + ((static_cast<long long>(b) * geo.s + ii) * hq +
                         h * g + rr % g) * hd;
    uint32_t word = 0xFFFFFFFFu;
    if (ii < geo.s)
      word = qvec ? bnn::pack_own_word<T, true>(qrow, 32LL * w, hd)
                  : bnn::pack_own_word<T, false>(qrow, 32LL * w, hd);
    qw[rr * qs + w] = word;
  }
  // e tile rows no lane writes (rows rl..7 of an 8-row block) stay 0
  for (int e = tid; e < kTile * kES; e += kThreads) et[e] = 0.f;

  // positions [p, p + n) of head h's K (or V) words to `dst` (4-byte
  // copies: 16-byte ones ran no faster)
  auto copy = [&](uint32_t* dst, const uint32_t* src, int p, int n) {
    for (int e = tid; e < n * hdw; e += kThreads) {
      const int j = e / hdw, w = e % hdw;
      cp_async4(dst + e, src + lay.row(b, p + j) * kv_row + h * hdw + w);
    }
  };
  // ring stage st: K words at kvw + st * kTile * hdw, V 2 tiles further
  auto stage = [&](int st, int p, int n, bool with_v) {
    copy(kvw + st * kTile * hdw, kc, p, n);
    if (with_v) copy(kvw + (2 + st) * kTile * hdw, vc, p, n);
    cp_async_commit();
  };
  // body(kw, vw, p, n) over the tiles of [lo, hi) streamed through the
  // ring, the next tile's copies in flight while this one is computed
  auto stream = [&](Span sp, bool with_v, auto&& body) {
    if (sp.lo < sp.hi) stage(0, sp.lo, min(kTile, sp.hi - sp.lo), with_v);
    for (int p = sp.lo, st = 0; p < sp.hi; p += kTile, st ^= 1) {
      if (p + kTile < sp.hi) {
        stage(st ^ 1, p + kTile, min(kTile, sp.hi - p - kTile), with_v);
        cp_async_wait_one();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      body(kvw + st * kTile * hdw, kvw + (2 + st) * kTile * hdw, p,
           min(kTile, sp.hi - p));
      __syncthreads();
    }
  };
  // lane's dot against the position at `kw` (hdw staged words)
  auto dot_at = [&](const uint32_t* kw) {
    int pop = 0;
    for (int w = 0; w < hdw; ++w) pop += __popc(qw[r * qs + w] ^ kw[w]);
    return hd - 2 * pop;
  };

  const Span mine = rank_span(
      block_span(len, qp, i0, i1, geo.t, geo.causal, window), split, rank);
  // the share held whole: K and V words of position lo + j at j * hdw
  const bool held = !dots && mine.hi - mine.lo <= geo.hold;
  uint32_t* kh = kvw;
  uint32_t* vh = kvw + geo.hold * hdw;
  if (held) {
    copy(kh, kc, mine.lo, mine.hi - mine.lo);
    copy(vh, vc, mine.lo, mine.hi - mine.lo);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();

  // 1. this block's max dot per row over its share (with dots: over its
  //    share of every table position, all written out)
  int mx = kNoDot;
  auto max_tile = [&](const uint32_t* kw, const uint32_t*, int p, int n) {
    if (!live) return;
    for (int j = warp * pp + sub; j < n; j += kWarps * pp) {
      const int t = p + j;
      const int d = dot_at(kw + j * hdw);
      if (dots)
        dots[(((static_cast<long long>(b) * geo.hkv + h) * geo.s + i) * g +
              r % g) * geo.t + t] = d;
      if (is_valid(t, len, qp + i, geo.causal, window)) mx = max(mx, d);
    }
  };
  if (held) {
    for (int p = mine.lo; p < mine.hi; p += kTile)
      max_tile(kh + (p - mine.lo) * hdw, nullptr, p, min(kTile, mine.hi - p));
  } else {
    stream(dots ? rank_span(Span{0, geo.t}, split, rank) : mine, false,
           max_tile);
  }
  mw[warp * 32 + lane] = mx;
  __syncthreads();
  if (tid < kRows) {
    int m = kNoDot;
    if (tid < rl)
      for (int w = 0; w < kWarps; ++w)
        for (int u = 0; u < pp; ++u) m = max(m, mw[w * 32 + u * rl + tid]);
    mrow[tid] = m;
  }
  cluster.sync();
  int gm = kNoDot;                         // the row's max over the cluster
#pragma unroll
  for (int rk = 0; rk < bnn::kMaxSplit; ++rk)
    if (rk < split) gm = max(gm, cluster.map_shared_rank(mrow, rk)[r]);
  const float m = gm == kNoDot ? 0.f
                               : __fmul_rn(static_cast<float>(gm), geo.scale);

  // 2. e_t and the sums: per tile, each lane's e_t into the e tile (0 past
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
  auto sum_tile = [&](const uint32_t* kw, const uint32_t* vw, int p, int n) {
    const int n4 = (n + 3) & ~3;
    for (int j = warp * pp + sub; j < n4; j += kWarps * pp) {
      const int t = p + j;
      float e = 0.f;
      if (live && j < n && is_valid(t, len, qp + i, geo.causal, window)) {
        const float sc =
            flat ? m
                 : __fmul_rn(static_cast<float>(dot_at(kw + j * hdw)),
                             geo.scale);
        e = expf(__fsub_rn(sc, m));
      }
      et[j * kES + r] = e;
      lacc += e;
    }
    __syncthreads();
    for (int k0 = 0; k0 < n4; k0 += 4) {
      double a[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        a[mt] = et[(k0 + tq) * kES + mt * 8 + gq];
      const uint32_t* vrow = vw + (k0 + tq) * hdw;
#pragma unroll
      for (int s = 0; s < kNT; ++s) {
        const int d = (warp + kWarps * s) * 8 + gq;
        if (d >= 8 * n_tiles) break;           // uniform across the warp
        const double bv = (vrow[d >> 5] >> (d & 31)) & 1u ? 1.0 : -1.0;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          if (8 * mt < rows) mma_f64(acc[mt][s], a[mt], bv);
      }
    }
  };
  if (held) {
    for (int p = mine.lo; p < mine.hi; p += kTile) {
      sum_tile(kh + (p - mine.lo) * hdw, vh + (p - mine.lo) * hdw, p,
               min(kTile, mine.hi - p));
      __syncthreads();
    }
  } else {
    stream(mine, true, sum_tile);
  }
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
  lw[warp * 32 + lane] = lacc;
  __syncthreads();
  if (tid < kRows) {
    double l = 0.0;
    if (tid < rl)
      for (int w = 0; w < kWarps; ++w)
        for (int u = 0; u < pp; ++u) l += lw[w * 32 + u * rl + tid];
    lrow[tid] = l;
  }
  cluster.sync();

  // 3. block `rank` writes outputs rank, rank + split, ... (in 256-wide
  //    runs), summing the blocks' sums in rank order
  const float vs = v_scale[b * geo.hkv + h];
  for (int e = rank * kThreads + tid; e < rows * hd; e += split * kThreads) {
    const int rr = e / hd, d = e % hd;
    const int ii = i0 + rr / g;
    if (ii >= i1) continue;
    const int at = d * kRows + rr;
    double a = 0.0, l = 0.0;
#pragma unroll
    for (int q2 = 0; q2 < bnn::kMaxSplit; ++q2) {
      if (q2 < split) {
        a += cluster.map_shared_rank(part, q2)[at];
        l += cluster.map_shared_rank(lrow, q2)[rr];
      }
    }
    const float lf = static_cast<float>(l);
    const float y = lf > 0.f ? vs * (static_cast<float>(a) / lf) : 0.f;
    out[((static_cast<long long>(b) * geo.s + ii) * hq + h * g + rr % g) * hd +
        d] = bnn::from_float(y, static_cast<T*>(nullptr));
  }
  cluster.sync();              // keep this block's sums alive for the others
}

template <typename T, typename Layout, int kRows>
int launch_rows(const void* q, const void* k, const void* v,
                const void* v_scale, const void* kv_len, int kv_len0,
                const void* q_pos, int q_pos0, void* out, void* dots,
                const Geometry& geo, Layout lay, int split, void* stream) {
  const long long blocks =
      static_cast<long long>(geo.b) * geo.hkv * geo.n_qb * split;
  return bnn::launch_cluster(
      attention_kernel<T, Layout, kRows>, blocks, kThreads, split,
      static_cast<int>(smem_bytes<kRows>(geo)), stream,
      static_cast<const T*>(q), static_cast<const uint32_t*>(k),
      static_cast<const uint32_t*>(v), static_cast<const float*>(v_scale),
      static_cast<const int*>(kv_len), kv_len0,
      static_cast<const int*>(q_pos), q_pos0, static_cast<T*>(out),
      static_cast<int*>(dots), geo, lay);
}

// split 1, 2, 4 or 8 blocks per cluster along T; blocks of up to 8 query
// rows take the 8-row body, others the 32-row one
template <typename T, typename Layout>
int launch(const void* q, const void* k, const void* v, const void* v_scale,
           const void* kv_len, int kv_len0, const void* q_pos, int q_pos0,
           void* out, void* dots, Geometry geo, Layout lay, int split,
           void* stream) {
  const int rows = geo.bq * geo.g;
  if (geo.b <= 0 || geo.s <= 0 || geo.t <= 0 || geo.hkv <= 0 || geo.g <= 0 ||
      geo.hd <= 0 || geo.hd > kMaxHd || geo.bq <= 0 || rows > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  geo.hdw = (geo.hd + 31) / 32;
  geo.n_qb = (geo.s + geo.bq - 1) / geo.bq;
  geo.hold = kHoldBytes / (8 * geo.hdw) / kTile * kTile;
  if (rows <= 8)
    return launch_rows<T, Layout, 8>(q, k, v, v_scale, kv_len, kv_len0, q_pos,
                                     q_pos0, out, dots, geo, lay, split,
                                     stream);
  return launch_rows<T, Layout, kMaxRows>(q, k, v, v_scale, kv_len, kv_len0,
                                          q_pos, q_pos0, out, dots, geo, lay,
                                          split, stream);
}

template <typename Layout>
int dispatch(int q_bf16, const void* q, const void* k, const void* v,
             const void* v_scale, const void* kv_len, int kv_len0,
             const void* q_pos, int q_pos0, void* out, void* dots,
             const Geometry& geo, Layout lay, int split, void* stream) {
  if (q_bf16)
    return launch<__nv_bfloat16>(q, k, v, v_scale, kv_len, kv_len0, q_pos,
                                 q_pos0, out, dots, geo, lay, split, stream);
  return launch<float>(q, k, v, v_scale, kv_len, kv_len0, q_pos, q_pos0, out,
                       dots, geo, lay, split, stream);
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
// int32 words; v_scale (b, hkv) float32; cache_len (b,) int32, or null with
// the scalar cache_len0 for every row -> out (b, 1, hkv*g, hd) in q's type:
// the body on a one-row chunk at q_pos = cache_len - 1, split blocks per
// cluster along T (1, 2, 4 or 8). dots (b, hkv, g, t) int32 or null.
int decode_attention_packed(const void* q, int q_bf16, const void* k,
                            const void* v, const void* v_scale,
                            const void* cache_len, int cache_len0, void* out,
                            void* dots, int b, int t, int hkv, int g, int hd,
                            int split, int window, float scale, void* stream) {
  const Geometry geo{b, 1, t, hkv, g, hd, 0, 1, 0, window, 1, 1, 0, scale};
  return dispatch(q_bf16, q, k, v, v_scale, cache_len, cache_len0, nullptr, 0,
                  out, dots, geo, Contiguous{t}, split, stream);
}

// q (b, s, hkv*g, hd); k, v, v_scale as above; kv_len and q_pos (b,) int32,
// or null with the scalar kv_len0 / q_pos0 for every row -> out
// (b, s, hkv*g, hd). bq chunk rows per block (bq * g <= 32), split blocks
// per cluster along T (1, 2, 4 or 8); dots (b, hkv, s, g, t) or null.
int prefill_attention_packed(const void* q, int q_bf16, const void* k,
                             const void* v, const void* v_scale,
                             const void* kv_len, int kv_len0,
                             const void* q_pos, int q_pos0, void* out,
                             void* dots, int b, int s, int t, int hkv, int g,
                             int hd, int bq, int split, int window,
                             int causal, float scale, void* stream) {
  const Geometry geo{b, s, t, hkv, g, hd, 0, bq, 0, window, causal, 0, 0,
                     scale};
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
                                  const void* cache_len, int cache_len0,
                                  void* out, void* dots, int b, int n_pages,
                                  int page_size, int pool, int hkv, int g,
                                  int hd, int split, int window, float scale,
                                  void* stream) {
  if (!paged_ok(page_table, n_pages, page_size, pool))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{b, 1, n_pages * page_size, hkv, g, hd, 0, 1, 0, window,
                     1, 1, 0, scale};
  return dispatch(q_bf16, q, k_pool, v_pool, v_scale, cache_len, cache_len0,
                  nullptr, 0, out, dots, geo,
                  paged_layout(page_table, n_pages, page_size, pool), split,
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
  if (!paged_ok(page_table, n_pages, page_size, pool))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{b, s, n_pages * page_size, hkv, g, hd, 0, bq, 0, window,
                     causal, 0, 0, scale};
  return dispatch(q_bf16, q, k_pool, v_pool, v_scale, kv_len, kv_len0, q_pos,
                  q_pos0, out, dots, geo,
                  paged_layout(page_table, n_pages, page_size, pool), split,
                  stream);
}

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
