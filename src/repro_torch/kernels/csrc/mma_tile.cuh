// Tile code of the port's tensor-core GEMMs (binary_gemm.cu): the int8
// tiles, which run kernels 1 to 4 past 32 rows: +-1 operands as int8 bytes
// in shared memory, multiplied by mma.sync m16n8k32 s8 x s8 -> s32; and the
// single-bit mma of kernel 1's small-M kernel (`mma_b1`), which takes the
// packed words as they are.
//
// Layout. A staged row (of the lhs, or a column of the rhs) holds one K
// stage as 32-bit words of four int8 values each, 8 words per k32 mma,
// padded by 4 words (a stride of 36 for a stage of four mma steps), so the
// 8 x 4 words of an mma fragment load (row g = lane / 4, word t = lane % 4)
// hit 32 distinct banks. Every fragment register is one 32-bit shared load.
//
// +-1 as int8: +1 is 0x01, -1 is 0xFF, and a position that is out of range
// (past M, N or K) stages as 0, which adds nothing to a dot. The wire
// format's pad bits are 1 on both sides of a packed product; they cancel
// under XOR, but as +-1 products each would add +1, so an expanded word
// zeroes its positions >= K.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace bnn {

// +-1 as an int8 byte (0x01 / 0xFF), 0 where the position is out of range;
// sign(v) = +1 where v >= 0, so -0.0 is +1 and NaN is -1
__device__ __forceinline__ uint32_t sign_byte(float v, bool in_range) {
  return in_range ? (v >= 0.f ? 0x01u : 0xFFu) : 0u;
}

// Bits 4q..4q+3 of `bits` as four int8 bytes: bit 1 -> 0x01, bit 0 -> 0xFF.
// The multiply by 0x00204081 places bit i at bit 8i (the 16 products i + 7j
// are distinct: no carries); a byte b in {0, 1} becomes 0xFF ^ (0xFE b).
__device__ __forceinline__ uint32_t expand_nibble(uint32_t bits, int q) {
  const uint32_t x = (((bits >> (4 * q)) & 0xFu) * 0x00204081u) & 0x01010101u;
  return ~(x * 0xFEu);
}

// The same with 0 in the bytes whose bit of `valid` is 0
__device__ __forceinline__ uint32_t expand_nibble(uint32_t bits,
                                                  uint32_t valid, int q) {
  const uint32_t v = (((valid >> (4 * q)) & 0xFu) * 0x00204081u) & 0x01010101u;
  return expand_nibble(bits, q) & (v * 0xFFu);
}

// The bits of word `word` (positions 32 word ..) that lie below k
__device__ __forceinline__ uint32_t valid_bits(int word, int k) {
  const int left = k - 32 * word;
  return left >= 32 ? 0xFFFFFFFFu : left <= 0 ? 0u : (1u << left) - 1u;
}

// A packed word expanded into eight staged words dst[0..7], as two 16-byte
// shared stores (dst 16-byte aligned); positions whose bit of `valid` is 0
// (past K or past the rows) stage as 0
__device__ __forceinline__ void expand_word(uint32_t* dst, uint32_t bits,
                                            uint32_t valid) {
  uint32_t e[8];
  if (valid == 0xFFFFFFFFu) {
#pragma unroll
    for (int q = 0; q < 8; ++q) e[q] = expand_nibble(bits, q);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) e[q] = expand_nibble(bits, valid, q);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(e[0], e[1], e[2], e[3]);
  *reinterpret_cast<uint4*>(dst + 4) = make_uint4(e[4], e[5], e[6], e[7]);
}

// One thread's share of one K step (kKW words, 4 kKW values) of a float
// lhs tile of kRows rows, raw: word q is row e / kKW and positions
// 4 (e % kKW) .. + 3 of the step (e = tid + q * kThreads), so the kKW
// threads of a row read its values side by side. With kVec (k % 4 == 0,
// 16-byte aligned rows) all four values of a word are in range or none, and
// they come in one 16-byte (float32) or 8-byte (bf16) load.
template <typename TA, bool kVec, int kRows, int kThreads, int kKW>
struct XStep {
  static constexpr int kStride = kKW + 4;               // staged row stride
  static constexpr int kXW = kRows * kKW / kThreads;    // words per thread
  static_assert(kXW * kThreads == kRows * kKW, "whole words per thread");
  float v[kXW][4];

  __device__ __forceinline__ void load(const TA* __restrict__ x, int m, int k,
                                       int m0, int k0, int tid) {
#pragma unroll
    for (int q = 0; q < kXW; ++q) {
      const int e = tid + q * kThreads;
      const int row = m0 + e / kKW, col = k0 + 4 * (e % kKW);
      const TA* p = x + static_cast<long long>(row) * k + col;
      if constexpr (kVec) {
        const bool ok = row < m && col < k;
        if constexpr (std::is_same_v<TA, float>) {
          float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ok) f = *reinterpret_cast<const float4*>(p);
          v[q][0] = f.x; v[q][1] = f.y; v[q][2] = f.z; v[q][3] = f.w;
        } else {
          uint2 raw = make_uint2(0u, 0u);
          if (ok) raw = *reinterpret_cast<const uint2*>(p);
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[q][j] = to_float(h[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[q][j] = (row < m && col + j < k) ? to_float(p[j]) : 0.f;
      }
    }
  }

  // word q as four +-1 bytes, 0 past the M or K edge
  __device__ __forceinline__ uint32_t word(int q, int m, int k, int m0,
                                           int k0, int tid) const {
    const int e = tid + q * kThreads;
    const bool row_ok = m0 + e / kKW < m;
    const int col = k0 + 4 * (e % kKW);
    uint32_t out = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out |= sign_byte(v[q][j], row_ok && col + j < k) << (8 * j);
    return out;
  }

  // the step into a (row, k word) stage of kRows rows
  __device__ __forceinline__ void store(uint32_t (*sa)[kStride], int m,
                                        int k, int m0, int k0, int tid) const {
#pragma unroll
    for (int q = 0; q < kXW; ++q) {
      const int e = tid + q * kThreads;
      sa[e / kKW][e % kKW] = word(q, m, k, m0, k0, tid);
    }
  }
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += popc(A_row & B_col) over 256 one-bit positions: mma.sync m16n8k256
// b1 AND-popc. Fragments: a0 / a2 row g, a1 / a3 row g + 8, b0 / b1 column
// g (g = lane / 4); a0, a1, b0 hold k 32t .. 32t + 31 (t = lane % 4), a2,
// a3, b1 k 128 + 32t .. 159 + 32t
__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of the m16 tile at stage row r0, k words w0.. w0 + 7 (g =
// lane / 4, t = lane % 4)
template <int kStride>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       uint32_t (*sa)[kStride], int r0, int w0,
                                       int g, int t) {
  a[0] = sa[r0 + g][w0 + t];
  a[1] = sa[r0 + g + 8][w0 + t];
  a[2] = sa[r0 + g][w0 + 4 + t];
  a[3] = sa[r0 + g + 8][w0 + 4 + t];
}

// The B fragment of the n8 tile at stage column c0, k words w0.. w0 + 7
template <int kStride>
__device__ __forceinline__ void frag_b(uint32_t (&b)[2],
                                       uint32_t (*sb)[kStride], int c0, int w0,
                                       int g, int t) {
  b[0] = sb[c0 + g][w0 + t];
  b[1] = sb[c0 + g][w0 + 4 + t];
}

}  // namespace bnn
