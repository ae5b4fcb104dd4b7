// XNOR-popcount and +-1 GEMMs for Hopper (sm_90a): the binary GEMM kernels
// of the bit-resident forward pass and of training, with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/binary_gemm.py:
//   binary_gemm_packed      <- binary_gemm_vpu            (packed lhs, int32 dots)
//   binary_gemm_packed_rhs  <- binary_gemm_vpu_packed     (float lhs, int32 dots)
//   binary_gemm_fused       <- binary_gemm_vpu_packed_io  (threshold + repack)
//   binary_gemm_mxu         <- binary_gemm_mxu            (float x float, f32 out)
//
// Wire format (src/repro_torch/core/bitpack.py): bit 1 is +1, words are
// little-endian along K, pad bits are 1, so dot = K - 2 * popcount(a ^ b).
// A float lhs is float32 or bf16 and signs as the wire format does: +1
// where x >= 0 (so -0.0 is +1), -1 below 0 and for NaN.
//
// Three kernels; the wrapper (kernels/binary_gemm.py, `gemm_plan`) picks the
// kernel and the split of K by a fixed rule from M, N, K and the SM count.
// Every call is one launch (kernel 4: its signing pass, then one).
//
// Kernel 4 (binary_gemm_mxu, the training path's binary convs: sign(x) @
// sign(w) with a float32 (K, N) w) is binary_gemm_packed_rhs with a float32
// store: a pass packs sign(w) once along K into the wire format (N, KW),
// an eighth of the bytes of w as +-1 int8, then the small-M kernel or the
// tensor-core tiles run x against those words as they run kernel 2. The
// dots are integers of magnitude <= K < 2^24, so float32 holds them exactly.
//
// Small M, packed lhs (binary_gemm_packed at M <= 32: the LM's q, K, V,
// gate and up at decode and chunk rows, 200 launches a 40-layer phi3 decode
// step). The weights bound it: (N, KW) words streamed once against M rows.
// Popcounts do not keep up with that stream (M per weight word, on a pipe
// that issues 16 a clock per SM), nor do int8 tensor cores, whose operands
// must first be expanded from bits to bytes (8 integer ops per weight
// word). The single-bit tensor cores (mma m16n8k256 b1, AND-popc) take the
// words as they are: a block owns 32 to 256 channels and a slice of K,
// copies the M real rows of its slice into shared memory once, and each
// warp streams two 16-channel tiles of weight rows with 16-byte loads (the
// first ones issued before the lhs copy), one mma per 16 channels, 8 lhs
// rows and 256 positions; the xor count follows from popc(a) + popc(b) - 2
// popc(a & b). Where N gives fewer blocks than half the SMs, K is split
// over a cluster and the partial counts are summed through distributed
// shared memory, as below.
//
// Batched (binary_gemm_packed over E experts: the MoE FFN's gate, up and
// down, a (E, C, KW) lhs of capacity rows against (E, N, KW) expert
// weights). One launch for all experts: the grid's y axis is the expert,
// and each block offsets a, b and out by its expert's matrices; the kernel
// and split are the ones `gemm_plan` picks for the E x blocks of the grid
// (small M at C <= 32, the tensor-core tiles above).
//
// Small M (binary_gemm_packed_rhs and binary_gemm_mxu at M <= 32, and
// binary_gemm_fused at the few rows `gemm_plan` gives it: the LM's decode
// and chunk rows, nemotron's up-projection). The weights bound it: (N, KW)
// words read once against M rows of activations, so at M = 4 a 64-row
// popcount tile wastes its rows, and a lhs packed by a warp ballot per
// word waits on one load after another.
// Here a block owns a slice of K and 32 or 64 channels. It sign-packs the
// M real rows of its K slice into shared memory once, a word per thread
// from 16-byte loads all in flight together, then each warp streams weight
// rows with 16-byte loads, two channels at a time, popcounts them against
// the M packed rows and reduces across the warp with a butterfly of
// shuffles that leaves row r's sum in lane r (M = 32). Where N gives too
// few blocks for the card, K is split over a thread-block cluster of up to
// 8 blocks: each keeps its partial popcounts in shared memory and, after a
// cluster barrier, each block sums a share of the outputs from all blocks'
// shared memory (distributed shared memory) and writes it. The sums are
// exact integers; no workspace, no atomics, one launch. Every block still
// packs the lhs of its own K slice, so N / channels-per-block blocks read
// the same rows (from L2). A packed lhs (the fused kernel's chain steps) is
// copied in as it is. The fused epilogue takes the summed dots a warp per
// 32 channels of a row: bit = (dot >= t) != flip, one ballot per word.
//
// Tensor-core tiles (binary_gemm_packed, binary_gemm_packed_rhs and
// binary_gemm_mxu at M > 32: the CNN's convs, the MLP and CNN output
// layers; binary_gemm_fused past the small-M rows). With a float lhs the float
// operand is 32x wider than its bits and bytes bound the convs;
// popcounts would bound them at ~0.5 ms on the integer pipe, the int8
// tensor cores do the same +-1 dots in ~0.06 ms. Each block of 8 warps
// computes a 64-row tile of 128 channels, or of 256 where N > 128 and such
// tiles fill the card (the float lhs is then read by half as many N tiles),
// with mma.sync m16n8k32 s8 x s8 -> s32 (the tile code of mma_tile.cuh), K
// in stages of 128 values (four mma steps). A float lhs is loaded with
// 16-byte loads and signed to +-1 int8 as it is staged; a packed lhs and
// the packed weight words are expanded from bits to +-1 bytes in shared
// memory in the mma's fragment layout (a multiply spreads four bits to four
// bytes), so the int8 form never goes to device memory. Positions >= K
// expand to 0 (the pad bits would add +1 each as products). The next
// stage's raw loads are in flight while the tensor cores work on this one.
// K is split over a cluster as above where the tiles are too few (the
// fused chain steps have 16-64, the output layers 8-16). Without a split,
// dots go from the accumulators to device memory in 32-byte row pieces
// (int32, or float32 for kernel 4); with one, and for the fused epilogue,
// they go through shared memory (the stages' space): each block of the
// cluster sums a share of the rows over all blocks, then writes dots
// coalesced, or, fused, bit = (dot >= t) != flip for 32 channels of a row
// in one warp and one ballot per output word (channels >= N emit 1).
// Not yet: wgmma, TMA, a ring of stages in shared memory, one read of the
// float lhs for all N tiles (each re-reads it from L2 where N > 256).
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;           // 8 warps, every kernel here
constexpr int kWarps = kThreads / 32;
using bnn::kMaxSplit;                   // portable cluster size

// ---------------------------------------------------------------------------
// Small M: binary_gemm_packed_rhs at M <= 32
// ---------------------------------------------------------------------------
constexpr int kSmallMaxRows = 32;

__device__ __forceinline__ int popc4(uint4 a, uint4 b) {
  return __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
         __popc(a.w ^ b.w);
}

// One halving step of `reduce_rows` and the ones after it: of its 2 kH live
// rows a lane keeps the upper or lower kH, by its lane bit o, and adds its
// partner's (the recursion keeps every index a constant: acc stays in
// registers)
template <int kRows, int kH>
__device__ __forceinline__ void halve_rows(int (&acc)[kRows], int lane) {
  if constexpr (kH >= 1) {
    constexpr int o = kH * (32 / kRows);
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      const int send = upper ? acc[i] : acc[i + kH];
      const int keep = upper ? acc[i + kH] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    halve_rows<kRows, kH / 2>(acc, lane);
  }
}

// Sum of acc[r] over the warp's 32 lanes, for row r = lane / (32 / kRows):
// log2(kRows) halving steps, then a plain butterfly over the lanes that
// share a row
template <int kRows>
__device__ __forceinline__ int reduce_rows(int (&acc)[kRows], int lane) {
  halve_rows<kRows, kRows / 2>(acc, lane);
  int s = acc[0];
#pragma unroll
  for (int o = 16 / kRows; o >= 1; o /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// One cluster of `split` blocks per `block_n` channels; block rank r owns
// words [r ks, r ks + ks) of K. kRows >= m rows are computed, m stored:
// dots (m, n) as TO, or, kFused, (m, ceil(n / 32)) words of the threshold
// bits. TA uint32_t: a packed lhs (m, kw), else float rows (m, k).
// Shared memory: sa (m, ks) packed lhs words, part (m, block_n) popcounts.
template <typename TA, int kRows, bool kVec, bool kFused, typename TO>
__global__ void __launch_bounds__(kThreads)
small_m_kernel(const TA* __restrict__ a, const uint32_t* __restrict__ b,
               const int32_t* __restrict__ thresh,
               const int32_t* __restrict__ flip, TO* __restrict__ out, int m,
               int n, int kw, int k, int ks, int block_n) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* sa = smem;
  int32_t* part = reinterpret_cast<int32_t*>(smem + m * ks);
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = static_cast<int>(blockIdx.x / split) * block_n;
  const int w0 = rank * ks;
  const int nwords = max(0, min(ks, kw - w0));   // a multiple of 4

  // the m real rows of this K slice, packed once, a word per thread
#pragma unroll 2
  for (int e = tid; e < m * ks; e += kThreads) {
    const int r = e / ks, c = e % ks;
    if constexpr (std::is_same_v<TA, uint32_t>)
      sa[e] = c < nwords ? __ldg(a + static_cast<long long>(r) * kw + w0 + c)
                         : 0u;
    else
      sa[e] = c < nwords ? bnn::pack_own_word<TA, kVec>(
                               a + static_cast<long long>(r) * k,
                               32LL * (w0 + c), k)
                         : 0u;
  }
  __syncthreads();

  // two channels per warp at a time: their weight loads in flight together
  for (int c = warp; c < block_n; c += 2 * kWarps) {
    const int ch0 = n0 + c, ch1 = ch0 + kWarps;
    const bool ok0 = ch0 < n, ok1 = ch1 < n && c + kWarps < block_n;
    const uint32_t* b0 = b + static_cast<long long>(ok0 ? ch0 : 0) * kw + w0;
    const uint32_t* b1 = b + static_cast<long long>(ok1 ? ch1 : 0) * kw + w0;
    int acc0[kRows], acc1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc0[r] = acc1[r] = 0;
    for (int w = 4 * lane; w < nwords; w += 128) {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4 bv0 = ok0 ? __ldg(reinterpret_cast<const uint4*>(b0 + w))
                            : zero;
      const uint4 bv1 = ok1 ? __ldg(reinterpret_cast<const uint4*>(b1 + w))
                            : zero;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < m) {
          const uint4 av = *reinterpret_cast<const uint4*>(sa + r * ks + w);
          acc0[r] += popc4(av, bv0);
          acc1[r] += popc4(av, bv1);
        }
      }
    }
    const int s0 = reduce_rows<kRows>(acc0, lane);
    const int s1 = reduce_rows<kRows>(acc1, lane);
    const int row = lane / (32 / kRows);
    if (lane % (32 / kRows) == 0 && row < m) {
      if (ok0) part[row * block_n + c] = s0;
      if (ok1) part[row * block_n + c + kWarps] = s1;
    }
  }
  cluster.sync();

  // block `rank` sums outputs rank, rank + split, ... (in 256-wide runs)
  // over the cluster's blocks, in rank order. block_n is a multiple of 32,
  // so a warp's 32 outputs are 32 channels of one row, word-aligned: the
  // fused epilogue ballots them into that row's word (channels >= n emit 1)
  const int nw = (n + 31) / 32;
  for (int e = rank * kThreads + tid; e < m * block_n; e += split * kThreads) {
    const int row = e / block_n, c = e % block_n;
    const int ch = n0 + c;
    if (!kFused && ch >= n) continue;
    int popc = 0;
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < split && ch < n) popc += cluster.map_shared_rank(part, q)[e];
    if constexpr (kFused) {
      const bool bit = ch < n ? (k - 2 * popc >= __ldg(thresh + ch)) !=
                                    (__ldg(flip + ch) != 0)
                              : true;
      const uint32_t word = __ballot_sync(0xffffffffu, bit);
      if (lane == 0 && ch / 32 < nw)
        out[static_cast<long long>(row) * nw + ch / 32] =
            static_cast<TO>(word);
    } else {
      out[static_cast<long long>(row) * n + ch] =
          static_cast<TO>(k - 2 * popc);
    }
  }
  cluster.sync();              // keep this block's part alive for the others
}

// ---------------------------------------------------------------------------
// Small M, packed lhs: binary_gemm_packed at M <= 32
// ---------------------------------------------------------------------------
constexpr int kPkTiles = 2;                 // 16-channel tiles per warp
constexpr int kPkWarpN = 16 * kPkTiles;     // channels per warp
constexpr int kPkGroup = 16;                // K words per warp step (4 a lane)

// Row stride of the lhs slice in shared memory: whole groups of 16 words,
// = 16 mod 32 words, so that the 16-byte reads of two rows by a quarter
// warp (8 lanes: 2 rows x 16 words) hit 32 distinct banks
__host__ __device__ constexpr int packed_lhs_stride(int ks) {
  const int whole = (ks + kPkGroup - 1) / kPkGroup * kPkGroup;
  return whole % 32 == 16 ? whole : whole + 16;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// One cluster of `split` blocks per block_n = 32 (8 / kp) channels; block
// rank r owns words [r ks, r ks + ks) of K. Warp w takes the 32 channels
// 32 (w / kp) .. + 31 (two 16-channel tiles) and every kp-th 16-word group
// of the slice from w % kp on. Lane (g, t) = (lane / 4, lane % 4) streams
// words 4t .. 4t + 3 of each group of channels g and g + 8 of each tile, one
// 16-byte load per channel, the next group's loads in flight while this one
// is computed (the first ones while the lhs is copied in).
// The dots run on the single-bit tensor cores: mma m16n8k256 b1 AND-popc,
// a tile's 16 channels as A's rows, lhs rows as B's columns (kRows / 8 n8
// tiles). A lane's k slots are 32t .. 32t + 31 and 128 + 32t .. 159 + 32t
// in A and in B alike, so a step fills them with words q and q + 1 of the
// lane's four (channels g, g + 8 in A, its lhs row in B): A and B pair the
// same K position in every slot, and two steps cover the group's 512
// positions once. popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b): each
// lane adds its channels' word popcounts, the block its lhs rows' over the
// slice. Words past the slice are 0 in both operands (the lhs slice is
// zero-padded to whole groups), so they add nothing; the wire format's pad
// bits past K are 1 in both and cancel as in the xor.
// Shared memory: sa (m, packed_lhs_stride(ks)) lhs words, part (m, block_n)
// the block's popc(a ^ b), added by the warps with shared atomics and
// summed over the cluster as in small_m_kernel: dot = K - 2 sum.
template <int kRows>
__global__ void __launch_bounds__(kThreads, 2)
small_m_packed_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b,
                      int32_t* __restrict__ out, int m, int n, int kw, int k,
                      int ks, int kp) {
  constexpr int kNI = kRows / 8;                // n8 tiles of lhs rows
  extern __shared__ __align__(16) uint32_t smem[];
  const int stride = packed_lhs_stride(ks);
  const int block_n = kPkWarpN * (kWarps / kp);
  uint32_t* sa = smem;
  int32_t* part = reinterpret_cast<int32_t*>(smem + m * stride);
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = static_cast<int>(blockIdx.x / split) * block_n;
  const int w0 = rank * ks;
  const int nwords = max(0, min(ks, kw - w0));   // a multiple of 4
  const int groups = (nwords + kPkGroup - 1) / kPkGroup;

  // the batch's matrices (blockIdx.y: a batched call's expert)
  const long long eb = blockIdx.y;
  a += eb * m * kw;
  b += eb * n * kw;
  out += eb * m * n;
  const int c_loc = (warp / kp) * kPkWarpN;     // the warp's first channel
  const int kpart = warp % kp;
  const uint32_t* bp[kPkTiles][2];
  bool ok[kPkTiles][2];
#pragma unroll
  for (int j = 0; j < kPkTiles; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = n0 + c_loc + 16 * j + 8 * h + g;
      ok[j][h] = ch < n;
      bp[j][h] = b + static_cast<long long>(ok[j][h] ? ch : 0) * kw + w0 +
                 4 * t;
    }
  uint4 wv[kPkTiles][2], wn[kPkTiles][2];
  auto load = [&](uint4 (&w)[kPkTiles][2], int grp) {
    const bool in = kPkGroup * grp + 4 * t < nwords;
#pragma unroll
    for (int j = 0; j < kPkTiles; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w[j][h] = in && ok[j][h]
                      ? __ldg(reinterpret_cast<const uint4*>(
                            bp[j][h] + kPkGroup * grp))
                      : make_uint4(0u, 0u, 0u, 0u);
  };
  if (kpart < groups) load(wv, kpart);     // in flight while the lhs comes

  // the m lhs rows of this slice, whole groups (0 past the slice), and the
  // block's sums zeroed
  const int row4 = groups * (kPkGroup / 4);
  for (int e = tid; e < m * row4; e += kThreads) {
    const int r = e / row4, c = 4 * (e % row4);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c < nwords)
      v = __ldg(reinterpret_cast<const uint4*>(
          a + static_cast<long long>(r) * kw + w0 + c));
    *reinterpret_cast<uint4*>(sa + r * stride + c) = v;
  }
  for (int e = tid; e < m * block_n; e += kThreads) part[e] = 0;
  __syncthreads();

  int acc[kPkTiles][kNI][4];                    // popc(a & b)
  int pb[kPkTiles][2];                          // popc(b), this lane's words
#pragma unroll
  for (int j = 0; j < kPkTiles; ++j) {
    pb[j][0] = pb[j][1] = 0;
#pragma unroll
    for (int i = 0; i < kNI; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][i][c] = 0;
  }
  for (int grp = kpart; grp < groups; grp += kp) {
    if (grp + kp < groups) load(wn, grp + kp);
    uint4 bv[kNI];
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      const int row = 8 * i + g;
      bv[i] = row < m ? *reinterpret_cast<const uint4*>(
                            sa + row * stride + kPkGroup * grp + 4 * t)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kPkTiles; ++j) {
      pb[j][0] += popc4(wv[j][0]);
      pb[j][1] += popc4(wv[j][1]);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t af[4] = {
            word_of(wv[j][0], 2 * s), word_of(wv[j][1], 2 * s),
            word_of(wv[j][0], 2 * s + 1), word_of(wv[j][1], 2 * s + 1)};
#pragma unroll
        for (int i = 0; i < kNI; ++i) {
          const uint32_t bf[2] = {word_of(bv[i], 2 * s),
                                  word_of(bv[i], 2 * s + 1)};
          bnn::mma_b1(acc[j][i], af, bf);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPkTiles; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) wv[j][h] = wn[j][h];
  }
  // accumulator c of tile (j, i): channel g (+8 for c >= 2), lhs row
  // 8i + 2t + (c & 1); a channel's popc(b) sums over its four lanes
#pragma unroll
  for (int j = 0; j < kPkTiles; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pb[j][h] += __shfl_xor_sync(0xffffffffu, pb[j][h], 1);
      pb[j][h] += __shfl_xor_sync(0xffffffffu, pb[j][h], 2);
    }
#pragma unroll
  for (int j = 0; j < kPkTiles; ++j)
#pragma unroll
    for (int i = 0; i < kNI; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = 8 * i + 2 * t + (c & 1);
        if (row < m)
          atomicAdd(&part[row * block_n + c_loc + 16 * j + 8 * (c >> 1) + g],
                    pb[j][c >> 1] - 2 * acc[j][i][c]);
      }
  // popc(a) of each lhs row over the slice, added once to its outputs
  for (int r = warp; r < m; r += kWarps) {
    int v = 0;
    for (int c = 4 * lane; c < nwords; c += 128)
      v += popc4(*reinterpret_cast<const uint4*>(sa + r * stride + c));
#pragma unroll
    for (int o = 16; o >= 1; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    for (int c = lane; c < block_n; c += 32)
      atomicAdd(&part[r * block_n + c], v);
  }
  cluster.sync();

  // block `rank` sums outputs rank, rank + split, ... (in 256-wide runs)
  // over the cluster's blocks, in rank order
  for (int e = rank * kThreads + tid; e < m * block_n; e += split * kThreads) {
    const int row = e / block_n, c = e % block_n;
    if (n0 + c >= n) continue;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < split) sum += cluster.map_shared_rank(part, q)[e];
    out[static_cast<long long>(row) * n + n0 + c] = k - 2 * sum;
  }
  cluster.sync();              // keep this block's part alive for the others
}

// ---------------------------------------------------------------------------
// Tensor-core tiles: binary_gemm_packed_rhs at M > 32, binary_gemm_fused
// ---------------------------------------------------------------------------
constexpr int kTcBM = 64;                  // rows per block
constexpr int kTcBN = 128;                 // channels per block (fused, split)
constexpr int kTcWideBN = 256;             // channels per block (wide N)
constexpr int kTcSW = 4;                   // packed words (k32 mmas) a stage
constexpr int kTcRowWords = 8 * kTcSW;    // staged int8 words of a row
constexpr int kTcRowStride = kTcRowWords + 4;  // padded: no bank conflicts
constexpr int kTcWarpM = 32;               // rows per warp (2 warps along M)
constexpr int kTcMI = kTcWarpM / 16;       // m16 tiles per warp
constexpr int kPartStride = kTcBN + 8;     // int2 stores hit 2 wavefronts
static_assert(kTcBM * kTcSW == kThreads, "one lhs word a stage per thread");

// `n` packed words of one stage, raw: words w0 .. w0 + n - 1 of row r (none
// past `rows` or KW), with the bits of each that lie below K
template <int kN>
struct Words {
  uint32_t bits[kN], valid[kN];

  __device__ __forceinline__ void load(const uint32_t* __restrict__ p, int r,
                                       int rows, int kw, int k, int w0) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const bool ok = r < rows && w0 + j < kw;
      bits[j] = ok ? __ldg(p + static_cast<long long>(r) * kw + w0 + j) : 0u;
      valid[j] = ok ? bnn::valid_bits(w0 + j, k) : 0u;
    }
  }

  // as +-1 bytes into a staged row from word w of the stage on
  __device__ __forceinline__ void store(uint32_t* row, int w) const {
#pragma unroll
    for (int j = 0; j < kN; ++j) bnn::expand_word(row + 8 * (w + j), bits[j],
                                                  valid[j]);
  }
};

// Two dots of a row into out[0..1] (8-byte aligned), as int32 or float32
template <typename TO>
__device__ __forceinline__ void store_pair(TO* o, int d0, int d1) {
  if constexpr (std::is_same_v<TO, float>)
    *reinterpret_cast<float2*>(o) =
        make_float2(static_cast<float>(d0), static_cast<float>(d1));
  else
    *reinterpret_cast<int2*>(o) = make_int2(d0, d1);
}

// kFused: bit-resident epilogue, else dots stored as TO: int32, or float32
// for kernel 4 (|dot| <= K < 2^24, so exactly). TA uint32_t is a packed
// lhs; float / __nv_bfloat16 a float lhs (kVec: 16-byte row loads). kBN:
// channels per block, 128 (4 warps along N, 32 channels each) or 256 (64
// each; dots without a split only). A stage is kTcSW packed words (128
// values) of K; with a split or the fused epilogue the shared stages are
// reused for the partial dots once the K loop is done, else the dots go
// from registers to device memory.
template <typename TA, bool kVec, bool kFused, int kBN, typename TO>
__global__ void __launch_bounds__(kThreads, 2)
tc_gemm_kernel(const TA* __restrict__ a, const uint32_t* __restrict__ b,
               const int32_t* __restrict__ thresh,
               const int32_t* __restrict__ flip, TO* __restrict__ out,
               int m, int n, int kw, int k, int n_tiles, int split_stages) {
  constexpr bool kPackedLhs = std::is_same_v<TA, uint32_t>;
  static_assert(!kFused || std::is_same_v<TO, int32_t>, "fused: int32 words");
  constexpr int kWarpN = kBN / 4;          // channels per warp (4 along N)
  constexpr int kNI = kWarpN / 8;          // n8 tiles per warp
  constexpr int kRhsWords = kTcSW * kBN / kThreads;   // per thread a stage
  constexpr bool kViaShared = kBN == kTcBN;
  static_assert(kViaShared || !kFused, "the fused epilogue has 128 channels");
  struct Stages {
    uint32_t a[kTcBM][kTcRowStride];       // lhs stage, (row, k words)
    uint32_t b[kBN][kTcRowStride];         // rhs stage, (channel, k words)
  };
  union Smem {
    Stages st;
    int32_t part[kViaShared ? kTcBM : 1][kPartStride];   // this block's dots
  };
  __shared__ __align__(16) Smem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;                 // mma group: row / column in tile
  const int t = lane & 3;                  // thread in group: k word
  const int wm = warp >> 2;                // warp's 32-row slab
  const int wn = warp & 3;                 // warp's 32-channel slab
  // the batch's matrices (blockIdx.y: a batched call's expert)
  const long long eb = blockIdx.y;
  a += eb * m * (kPackedLhs ? kw : k);
  b += eb * n * kw;
  out += eb * m * (kFused ? (n + 31) / 32 : n);
  const int tile = static_cast<int>(blockIdx.x / split);
  const int m0 = (tile / n_tiles) * kTcBM;
  const int n0 = (tile % n_tiles) * kBN;
  const int stages = (kw + kTcSW - 1) / kTcSW;
  const int s0 = min(stages, rank * split_stages);
  const int s1 = min(stages, s0 + split_stages);

  int acc[kTcMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kTcMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  // thread tid stages kRhsWords words of channel tid / (kTcSW / kRhsWords)'s
  // stage and, for a packed lhs, word tid % 4 of row tid / 4's
  const uint32_t* bp = b + static_cast<long long>(n0) * kw;
  const int wch = tid / (kTcSW / kRhsWords);
  const int wword = tid % (kTcSW / kRhsWords) * kRhsWords;
  Words<kRhsWords> ws;
  Words<1> as;
  bnn::XStep<std::conditional_t<kPackedLhs, float, TA>, kVec, kTcBM, kThreads,
             kTcRowWords> xs;
  auto load = [&](int s) {
    ws.load(bp, wch, n - n0, kw, k, kTcSW * s + wword);
    if constexpr (kPackedLhs) {
      as.load(a + static_cast<long long>(m0) * kw, tid >> 2, m - m0, kw, k,
              kTcSW * s + (tid & 3));
    } else {
      xs.load(a, m, k, m0, 32 * kTcSW * s, tid);
    }
  };
  if (s0 < s1) load(s0);
  for (int s = s0; s < s1; ++s) {
    ws.store(sm.st.b[wch], wword);
    if constexpr (kPackedLhs) {
      as.store(sm.st.a[tid >> 2], tid & 3);
    } else {
      xs.store(sm.st.a, m, k, m0, 32 * kTcSW * s, tid);
    }
    if (s + 1 < s1) load(s + 1);           // the next stage, in flight
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTcSW; ++kk) {
      uint32_t af[kTcMI][4], bf[kNI][2];
#pragma unroll
      for (int i = 0; i < kTcMI; ++i)
        bnn::frag_a(af[i], sm.st.a, wm * kTcWarpM + i * 16, 8 * kk, g, t);
#pragma unroll
      for (int j = 0; j < kNI; ++j)
        bnn::frag_b(bf[j], sm.st.b, wn * kWarpN + j * 8, 8 * kk, g, t);
#pragma unroll
      for (int i = 0; i < kTcMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j) bnn::mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // accumulator c of tile (i, j): row g (+8 for c >= 2), column 2t + (c & 1)
  if (!kFused && split == 1) {             // dots, 32-byte row pieces
#pragma unroll
    for (int i = 0; i < kTcMI; ++i) {
#pragma unroll
      for (int j = 0; j < kNI; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * kTcWarpM + i * 16 + g + 8 * h;
          const int col = n0 + wn * kWarpN + j * 8 + 2 * t;
          TO* o = out + static_cast<long long>(row) * n + col;
          if (row < m && col + 1 < n && n % 2 == 0)
            store_pair(o, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          else if (row < m) {
            if (col < n) o[0] = static_cast<TO>(acc[i][j][2 * h]);
            if (col + 1 < n) o[1] = static_cast<TO>(acc[i][j][2 * h + 1]);
          }
        }
      }
    }
    return;
  }
  if constexpr (kViaShared) {
#pragma unroll
    for (int i = 0; i < kTcMI; ++i) {
#pragma unroll
      for (int j = 0; j < kNI; ++j) {
        const int r = wm * kTcWarpM + i * 16 + g;
        const int c = wn * kWarpN + j * 8 + 2 * t;
        *reinterpret_cast<int2*>(&sm.part[r][c]) =
            make_int2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<int2*>(&sm.part[r + 8][c]) =
            make_int2(acc[i][j][2], acc[i][j][3]);
      }
    }
    // this lane's channels' thresholds, read while the cluster gathers
    constexpr int kCW = kBN / 32;          // channel words of the tile
    int th[kCW];
    bool fl[kCW];
#pragma unroll
    for (int c = 0; c < kCW; ++c) {
      const int ch = n0 + 32 * c + lane;
      th[c] = kFused && ch < n ? __ldg(thresh + ch) : 0;
      fl[c] = kFused && ch < n ? __ldg(flip + ch) != 0 : false;
    }
    cluster.sync();

    // block `rank` finishes rows [rank rows, (rank + 1) rows) of the tile,
    // summing them over the cluster's blocks in rank order (the loads from
    // all blocks in flight together); a warp per row, a lane per channel
    const int rows = kTcBM / split;
    const int nw = (n + 31) / 32;
    for (int rr = warp; rr < rows; rr += kWarps) {
      const int r = rank * rows + rr;
      const int row = m0 + r;
      if (row >= m) break;
      int dot[kCW] = {};
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q) {
        if (q < split) {
          const int32_t* src = cluster.map_shared_rank(&sm.part[0][0], q) +
                               r * kPartStride + lane;
#pragma unroll
          for (int c = 0; c < kCW; ++c) dot[c] += src[32 * c];
        }
      }
#pragma unroll
      for (int c = 0; c < kCW; ++c) {
        const int ch = n0 + 32 * c + lane;
        if constexpr (kFused) {
          const bool bit = ch < n ? (dot[c] >= th[c]) != fl[c] : true;
          const uint32_t word = __ballot_sync(0xffffffffu, bit);
          const int wc = n0 / 32 + c;
          if (lane == 0 && wc < nw)
            out[static_cast<long long>(row) * nw + wc] =
                static_cast<int32_t>(word);
        } else {
          if (ch < n)
            out[static_cast<long long>(row) * n + ch] = static_cast<TO>(dot[c]);
        }
      }
    }
    cluster.sync();            // keep this block's part alive for the others
  }
}

// ---------------------------------------------------------------------------
// Kernel 4's signing pass
// ---------------------------------------------------------------------------
// wp (n, kw) words <- sign(w (k, n) float32) packed along K in the wire
// format: bit 1 where w >= 0 (so -0.0 is +1 and NaN is -1), pad bits 1.
// Thread i packs word i / n of column i % n: neighbouring threads take
// neighbouring columns, so each of a word's 32 reads of w is coalesced.
__global__ void __launch_bounds__(kThreads)
sign_pack_cols_kernel(const float* __restrict__ w, uint32_t* __restrict__ wp,
                      int k, int n, int kw) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= static_cast<long long>(n) * kw) return;
  const int col = static_cast<int>(i % n);
  const int c = static_cast<int>(i / n);
  float v[32];                  // positions >= k read as 0: pad bits 1
#pragma unroll
  for (int j = 0; j < 32; ++j)
    v[j] = 32 * c + j < k ? w[static_cast<long long>(32 * c + j) * n + col]
                          : 0.f;
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) word |= static_cast<uint32_t>(v[j] >= 0.f) << j;
  wp[static_cast<long long>(col) * kw + c] = word;
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------
template <typename TA, int kRows, bool kFused, typename TO>
int launch_small_m(const void* a, bool vec, const void* b, const void* thresh,
                   const void* flip, void* out, int m, int n, int kw, int k,
                   int split, int block_n, void* stream) {
  const int ks = (kw + 4 * split - 1) / (4 * split) * 4;
  const int smem = (m * ks + m * block_n) * 4;
  const long long blocks =
      static_cast<long long>((n + block_n - 1) / block_n) * split;
  const auto at = static_cast<const TA*>(a);
  const auto bt = static_cast<const uint32_t*>(b);
  const auto tt = static_cast<const int32_t*>(thresh);
  const auto ft = static_cast<const int32_t*>(flip);
  const auto ot = static_cast<TO*>(out);
  // a 16-byte load holds 4 float32 or 8 bf16 values: k must be a multiple
  if constexpr (!std::is_same_v<TA, uint32_t>) {
    if (vec && k % (16 / static_cast<int>(sizeof(TA))) == 0)
      return bnn::launch_cluster(small_m_kernel<TA, kRows, true, kFused, TO>,
                                 blocks, kThreads, split, smem, stream, at,
                                 bt, tt, ft, ot, m, n, kw, k, ks, block_n);
  }
  return bnn::launch_cluster(small_m_kernel<TA, kRows, false, kFused, TO>,
                             blocks, kThreads, split, smem, stream, at, bt,
                             tt, ft, ot, m, n, kw, k, ks, block_n);
}

template <typename TA, bool kFused, typename TO>
int small_m_rows(const void* a, bool vec, const void* b, const void* thresh,
                 const void* flip, void* out, int m, int n, int kw, int k,
                 int split, int block_n, void* stream) {
  if (m > kSmallMaxRows || kw % 4 != 0 || (block_n != 32 && block_n != 64) ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 4)
    return launch_small_m<TA, 4, kFused, TO>(a, vec, b, thresh, flip, out, m,
                                             n, kw, k, split, block_n, stream);
  if (m <= 8)
    return launch_small_m<TA, 8, kFused, TO>(a, vec, b, thresh, flip, out, m,
                                             n, kw, k, split, block_n, stream);
  if (m <= 16)
    return launch_small_m<TA, 16, kFused, TO>(a, vec, b, thresh, flip, out,
                                              m, n, kw, k, split, block_n,
                                              stream);
  return launch_small_m<TA, 32, kFused, TO>(a, vec, b, thresh, flip, out, m,
                                            n, kw, k, split, block_n, stream);
}

template <int kRows>
int launch_small_m_packed(const void* a, const void* b, void* out, int batch,
                          int m, int n, int kw, int k, int split, int block_n,
                          void* stream) {
  const int ks = (kw + 4 * split - 1) / (4 * split) * 4;
  const int smem = (m * packed_lhs_stride(ks) + m * block_n) * 4;
  const long long blocks =
      static_cast<long long>((n + block_n - 1) / block_n) * split;
  return bnn::launch_cluster_batched(small_m_packed_kernel<kRows>, blocks,
                                     batch, kThreads, split, smem, stream,
                             static_cast<const uint32_t*>(a),
                             static_cast<const uint32_t*>(b),
                             static_cast<int32_t*>(out), m, n, kw, k, ks,
                             kWarps * kPkWarpN / block_n);
}

// the small-M packed kernel at m <= 32 (1 to 4 n8 tiles of lhs rows)
int small_m_packed(const void* a, const void* b, void* out, int batch, int m,
                   int n, int kw, int k, int split, int block_n,
                   void* stream) {
  if (m > kSmallMaxRows || kw % 4 != 0 || block_n % kPkWarpN != 0 ||
      kWarps * kPkWarpN % block_n != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((m + 7) / 8) {
    case 1: return launch_small_m_packed<8>(a, b, out, batch, m, n, kw, k,
                                            split, block_n, stream);
    case 2: return launch_small_m_packed<16>(a, b, out, batch, m, n, kw, k,
                                             split, block_n, stream);
    case 3: return launch_small_m_packed<24>(a, b, out, batch, m, n, kw, k,
                                             split, block_n, stream);
    default: return launch_small_m_packed<32>(a, b, out, batch, m, n, kw, k,
                                              split, block_n, stream);
  }
}

template <typename TA, bool kVec, bool kFused, typename TO>
int launch_tc(const void* a, const void* b, const void* thresh,
              const void* flip, void* out, int m, int n, int kw, int k,
              int split, int block_n, void* stream, int batch = 1) {
  const int n_tiles = (n + block_n - 1) / block_n;
  const long long blocks =
      static_cast<long long>((m + kTcBM - 1) / kTcBM) * n_tiles * split;
  const int stages = (kw + kTcSW - 1) / kTcSW;
  const int split_stages = (stages + split - 1) / split;
  const auto args = [&](auto kernel) {
    return bnn::launch_cluster_batched(kernel, blocks, batch, kThreads, split,
                                       0, stream, static_cast<const TA*>(a),
                                       static_cast<const uint32_t*>(b),
                                       static_cast<const int32_t*>(thresh),
                                       static_cast<const int32_t*>(flip),
                                       static_cast<TO*>(out), m, n, kw, k,
                                       n_tiles, split_stages);
  };
  if (block_n == kTcBN)
    return args(tc_gemm_kernel<TA, kVec, kFused, kTcBN, TO>);
  if constexpr (!kFused) {
    if (block_n == kTcWideBN && split == 1)
      return args(tc_gemm_kernel<TA, kVec, false, kTcWideBN, TO>);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// lhs_kind: 0 packed int32 words, 1 float32, 2 bfloat16
template <bool kFused, typename TO = int32_t>
int tc_lhs(int lhs_kind, bool vec, const void* a, const void* b,
           const void* thresh, const void* flip, void* out, int m, int n,
           int kw, int k, int split, int block_n, void* stream) {
  switch (lhs_kind) {
    case 0:
      return launch_tc<uint32_t, false, kFused, TO>(
          a, b, thresh, flip, out, m, n, kw, k, split, block_n, stream);
    case 1:
      return vec ? launch_tc<float, true, kFused, TO>(
                       a, b, thresh, flip, out, m, n, kw, k, split, block_n,
                       stream)
                 : launch_tc<float, false, kFused, TO>(
                       a, b, thresh, flip, out, m, n, kw, k, split, block_n,
                       stream);
    case 2:
      return vec ? launch_tc<__nv_bfloat16, true, kFused, TO>(
                       a, b, thresh, flip, out, m, n, kw, k, split, block_n,
                       stream)
                 : launch_tc<__nv_bfloat16, false, kFused, TO>(
                       a, b, thresh, flip, out, m, n, kw, k, split, block_n,
                       stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A float lhs (lhs_kind 1 float32, 2 bfloat16) against packed words: the
// small-M kernel or tensor-core tiles, dots stored as TO
template <typename TO>
int float_lhs(const void* a, int lhs_kind, bool vec, const void* b, void* out,
              int m, int n, int kw, int k, int small_m, int split,
              int block_n, void* stream) {
  if (small_m) {
    switch (lhs_kind) {
      case 1: return small_m_rows<float, false, TO>(
                  a, vec, b, nullptr, nullptr, out, m, n, kw, k, split,
                  block_n, stream);
      case 2: return small_m_rows<__nv_bfloat16, false, TO>(
                  a, vec, b, nullptr, nullptr, out, m, n, kw, k, split,
                  block_n, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (lhs_kind != 1 && lhs_kind != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc_lhs<false, TO>(lhs_kind, vec, a, b, nullptr, nullptr, out, m, n,
                           kw, k, split, block_n, stream);
}

}  // namespace

extern "C" {

// a (batch, m, kw) int32 words, b (batch, n, kw) int32 words -> out
// (batch, m, n) int32 dots: matrix e of a against matrix e of b, every e in
// one launch (batch 1: one GEMM). small_m 1: the small-M kernel with
// block_n channels per block (32, 64, 128 or 256; m <= 32, kw % 4 == 0, a
// and b 16-byte aligned); small_m 0: tensor-core tiles of block_n channels
// (128, or 256 with split 1). split: blocks per cluster along K, 1, 2, 4
// or 8.
int binary_gemm_packed(const void* a, const void* b, void* out, int batch,
                       int m, int n, int kw, int k, int small_m, int split,
                       int block_n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (small_m)
    return small_m_packed(a, b, out, batch, m, n, kw, k, split, block_n,
                          stream);
  return launch_tc<uint32_t, false, false, int32_t>(
      a, b, nullptr, nullptr, out, m, n, kw, k, split, block_n, stream, batch);
}

// a (m, k) float32 (lhs_kind 1) or bfloat16 (lhs_kind 2), b (n, kw) int32
// words -> out (m, n) int32 dots. small_m 1: the small-M kernel with
// block_n channels per block (32 or 64; m <= 32, kw % 4 == 0, b 16-byte
// aligned); small_m 0: tensor-core tiles of block_n channels (128, or 256
// with split 1; vec: a's rows are read 16 bytes at a time, k % 4 == 0 and a
// 16-byte aligned). split: blocks per cluster along K, 1, 2, 4 or 8.
int binary_gemm_packed_rhs(const void* a, int lhs_kind, int vec,
                           const void* b, void* out, int m, int n, int kw,
                           int k, int small_m, int split, int block_n,
                           void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  return float_lhs<int32_t>(a, lhs_kind, vec != 0, b, out, m, n, kw, k,
                            small_m, split, block_n, stream);
}

// a (m, kw) int32 words (lhs_kind 0) or (m, k) float32 / bfloat16 (lhs_kind
// 1 / 2), b (n, kw) int32 words, thresh/flip (n,) int32 -> out
// (m, ceil(n/32)) words. small_m 1: the small-M kernel with block_n
// channels per block (32 or 64; m <= 32, kw % 4 == 0, b 16-byte aligned);
// small_m 0: tensor-core tiles of 128 channels. vec and split as above.
int binary_gemm_fused(const void* a, int lhs_kind, int vec, const void* b,
                      const void* thresh, const void* flip, void* out, int m,
                      int n, int kw, int k, int small_m, int split,
                      int block_n, void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (small_m) {
    switch (lhs_kind) {
      case 0: return small_m_rows<uint32_t, true, int32_t>(
                  a, false, b, thresh, flip, out, m, n, kw, k, split,
                  block_n, stream);
      case 1: return small_m_rows<float, true, int32_t>(
                  a, vec != 0, b, thresh, flip, out, m, n, kw, k, split,
                  block_n, stream);
      case 2: return small_m_rows<__nv_bfloat16, true, int32_t>(
                  a, vec != 0, b, thresh, flip, out, m, n, kw, k, split,
                  block_n, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (block_n != kTcBN) return static_cast<int>(cudaErrorInvalidValue);
  return tc_lhs<true>(lhs_kind, vec != 0, a, b, thresh, flip, out, m, n, kw,
                      k, split, kTcBN, stream);
}

// Kernel 4: x (m, k) float32 (x_kind 1) or bfloat16 (x_kind 2), w (k, n)
// float32 -> out (m, n) float32 = sign(x) @ sign(w). wp: scratch of
// n * ceil(k/32) words, 16-byte aligned, that w is sign-packed into first;
// then binary_gemm_packed_rhs's kernels (small_m, split, block_n and vec as
// there) run x against it with a float32 store.
int binary_gemm_mxu(const void* x, int x_kind, int vec, const void* w,
                    void* wp, void* out, int m, int n, int k, int small_m,
                    int split, int block_n, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int kw = (k + 31) / 32;
  const long long words = static_cast<long long>(n) * kw;
  const long long sign_blocks = (words + kThreads - 1) / kThreads;
  if (sign_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sign_pack_cols_kernel<<<static_cast<unsigned>(sign_blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<uint32_t*>(wp), k, n, kw);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return float_lhs<float>(x, x_kind, vec != 0, wp, out, m, n, kw, k, small_m,
                          split, block_n, stream);
}

const char* binary_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
