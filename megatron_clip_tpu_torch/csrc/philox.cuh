// Attention dropout inside the kernels: Philox4x32-10 and the keep mask it
// draws, shared by flash_attention.cu and fused_mha.cu.
//
// Replaces the TPU's on-core PRNG of ops/pallas/flash_attention.py::
// _drop_keep and the [B, H, S, S] mask that ops/pallas/fused_mha.py::
// _dropout_mask draws with jax.random and reads from device memory: here no
// mask is stored, every kernel draws the bits it needs from the indices of
// the score.
//
// The mask (one layout, also written in ops/dropout.py, whose plain
// PyTorch Philox the kernels are checked against bit for bit): score (row,
// col) of head bh keeps its probability when
//   philox4x32_10(counter = (col >> 1, row & ~8, bh, offset),
//                 key = (seed_lo, seed_hi))[(col & 1) | ((row >> 3) & 1) << 1]
//     < threshold,
// threshold = min(floor((1 - rate) 2^32), 2^32 - 1). The bits depend on the
// global indices alone, so kernels that tile differently draw the same mask.
// One call gives rows {r, r + 8} x columns {c, c + 1} (r with bit 3 clear,
// c even), the four values one thread holds of an m16n8 mma accumulator.
//
// What it costs: a call is 10 rounds of two 32x32->64 multiplies and a few
// xors, some 100 integer instructions, for four scores (two in the kernels
// that hold scores transposed, keys as rows, unless two lanes share their
// calls: bits_t2_pair). It adds integer work beside
// the tensor-core products; PERF.md has each kernel's time with and
// without it.
//
// MCT_DROPOUT_FAULT (0 unless set) builds a wrong draw for the checks that
// must catch one: 1 draws per 64 x 64 tile (the tile's local indices, the
// tile index in the offset), 2 shifts the column by one.
#pragma once

#include <stdint.h>

#ifndef MCT_DROPOUT_FAULT
#define MCT_DROPOUT_FAULT 0
#endif

namespace mct {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// One launch's dropout: the seed's two words, the offset of the site, the
// keep threshold and the multiplier a kept probability takes.
struct Dropout {
  uint32_t seed_lo, seed_hi, offset, threshold;
  float mult;

  // The four words of the call that holds (row, col): rows {row & ~8,
  // row | 8} x columns {col & ~1, col | 1}, word (col & 1) | (row & 8) >> 2.
  __device__ __forceinline__ uint4 words(long bh, int row, int col) const {
    uint32_t off = offset;
#if MCT_DROPOUT_FAULT == 1
    off ^= ((uint32_t)(row >> 6) << 16) ^ (uint32_t)(col >> 6);
    row &= 63;
    col &= 63;
#elif MCT_DROPOUT_FAULT == 2
    col += 1;
#endif
    return philox4x32_10(
        make_uint4((uint32_t)col >> 1, (uint32_t)(row & ~8), (uint32_t)bh, off),
        seed_lo, seed_hi);
  }

  static __device__ __forceinline__ uint32_t word(uint4 w, int i) {
    return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
  }

  // mult where the word keeps, else 0
  __device__ __forceinline__ float scale(uint32_t w) const {
    return w < threshold ? mult : 0.f;
  }

  // The multiplier of one score (row, col), one call each.
  __device__ __forceinline__ float at(long bh, int row, int col) const {
#if MCT_DROPOUT_FAULT == 2
    const int c = col + 1;
#else
    const int c = col;
#endif
    return scale(word(words(bh, row, col), (c & 1) | ((row >> 3) & 1) << 1));
  }

  // The multipliers of a forward accumulator's four values: rows {row,
  // row + 8} (row with bit 3 clear) x columns {col, col + 1} (col even), in
  // the m16n8 order (row, col), (row, col + 1), (row + 8, col),
  // (row + 8, col + 1). One call.
  __device__ __forceinline__ void quad(float (&m)[4], long bh, int row,
                                       int col) const {
#if MCT_DROPOUT_FAULT == 0
    const uint4 w = words(bh, row, col);
    m[0] = scale(w.x);
    m[1] = scale(w.y);
    m[2] = scale(w.z);
    m[3] = scale(w.w);
#else
    m[0] = at(bh, row, col);
    m[1] = at(bh, row, col + 1);
    m[2] = at(bh, row + 8, col);
    m[3] = at(bh, row + 8, col + 1);
#endif
  }

  // The multipliers of two accumulators n, n + 1 that hold scores
  // transposed (keys as rows): keys {key, key + 8} (key with bit 3 clear)
  // x queries {q, q + 1} in m0 and {q + 8, q + 9} in m1 (q even, bit 3
  // clear), element j of each being (key + 8 (j >> 1), query + (j & 1)).
  // Four calls for the eight values.
  __device__ __forceinline__ void quad_t2(float (&m0)[4], float (&m1)[4],
                                          long bh, int q, int key) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = key + 8 * (j >> 1), qj = q + (j & 1);
#if MCT_DROPOUT_FAULT == 0
      const uint4 w = words(bh, qj, kj);
      m0[j] = scale(word(w, kj & 1));
      m1[j] = scale(word(w, (kj & 1) | 2));
#else
      m0[j] = at(bh, qj, kj);
      m1[j] = at(bh, qj + 8, kj);
#endif
    }
  }

  // quad_t2's eight multipliers as keep bits: bit j (m0[j]) and bit 4 + j
  // (m1[j]), 1 where the probability is kept (times mult).
  __device__ __forceinline__ uint32_t bits_t2(long bh, int q, int key) const {
    float m0[4], m1[4];
    quad_t2(m0, m1, bh, q, key);
    uint32_t r = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r |= (uint32_t)(m0[j] != 0.f) << j | (uint32_t)(m1[j] != 0.f) << (4 + j);
    return r;
  }

  // bits_t2 for two lanes, `partner` = lane ^ mask, that hold the same
  // queries and the keys {key, key + 8} and {key ^ 1, (key ^ 1) + 8}: the
  // four Philox calls of each lane are the other's too (a call covers a
  // pair of adjacent keys), so each lane draws two of them, the lane with
  // the even key the pair at key, the other the pair at key + 8, and they
  // trade the bits of each other's keys. Every lane of the warp calls it.
  __device__ __forceinline__ uint32_t bits_t2_pair(long bh, int q, int key,
                                                   int mask) const {
#if MCT_DROPOUT_FAULT == 0
    const bool even = (key & 1) == 0;
    const int col = (key & ~1) + (even ? 0 : 8);
    uint32_t mine = 0, theirs = 0;
#pragma unroll
    for (int t = 0; t < 2; ++t) {  // queries q + t and q + t + 8
      const uint4 w = words(bh, q + t, col);
      // the even key's bits (words x, z) are the even lane's j = t (its
      // key) or j = 2 + t (its key + 8), the odd key's (y, w) the odd
      // lane's; bit j: query q + t, bit 4 + j: query q + t + 8
      const uint32_t ev = (uint32_t)(w.x < threshold) << t |
                          (uint32_t)(w.z < threshold) << (4 + t);
      const uint32_t od = (uint32_t)(w.y < threshold) << t |
                          (uint32_t)(w.w < threshold) << (4 + t);
      if (even) {
        mine |= ev;
        theirs |= od;
      } else {
        mine |= od << 2;
        theirs |= ev << 2;
      }
    }
    return mine | __shfl_xor_sync(0xffffffffu, theirs, mask);
#else
    return bits_t2(bh, q, key);
#endif
  }
};

// The keep bits (1 keep, 0 drop) of rows [0, R) x columns [0, C) of heads
// [0, BH) into keep [BH, R, C], as the kernels draw them.
__global__ void dropout_mask_kernel(Dropout drop, uint8_t* keep, int BH, int R,
                                    int C) {
  const long n = (long)BH * R * C;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int col = (int)(i % C);
    const long rest = i / C;
    const int row = (int)(rest % R), bh = (int)(rest / R);
    keep[i] = drop.at(bh, row, col) != 0.f;
  }
}

}  // namespace mct

// The C entry point each kernel library exports: the mask its kernels draw.
#define MCT_DROPOUT_MASK_EXPORT                                              \
  extern "C" int mct_dropout_mask(void* keep, int BH, int R, int C,          \
                                  unsigned long long seed,                   \
                                  unsigned int offset,                       \
                                  unsigned int threshold, void* stream) {    \
    if (BH < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;        \
    const mct::Dropout drop{(uint32_t)seed, (uint32_t)(seed >> 32), offset,  \
                            threshold, 1.f};                                 \
    mct::dropout_mask_kernel<<<1024, 256, 0,                                 \
                               static_cast<cudaStream_t>(stream)>>>(         \
        drop, static_cast<uint8_t*>(keep), BH, R, C);                        \
    return (int)cudaGetLastError();                                          \
  }
