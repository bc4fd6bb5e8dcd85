// Tile helpers shared by the attention kernels (fused_mha.cu,
// flash_attention.cu): shared-memory staging of 16-byte bf16 rows, ldmatrix,
// mma.sync m16n8k16 with fp32 accumulation, and the quad reductions of the
// m16n8 accumulator layout. A block has kBlockThreads threads (4 warps).
#pragma once

#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace mct {

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB it must
// opt in).
template <typename K>
cudaError_t allow_smem(K* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBlockThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major), fp32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0+n) of one head's q, k or v (columns col..col+D) into a
// [ROWS][DP+8] shared tile, zero-filled past n and past D. D % 8 == 0.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long row_pitch, int col, int r0,
                                          int n, int D) {
  constexpr int kChunks = DP / 8, kPitch = DP + 8;
  static_assert(ROWS * kChunks % kBlockThreads == 0, "whole rounds of chunks");
  // a fixed trip count, unrolled: every load of the tile is in flight at once
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kBlockThreads; ++it) {
    const int i = it * kBlockThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n && c * 8 < D)
      v = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * row_pitch +
                                          col + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kPitch + c * 8) = v;
  }
}

// The products of the warp's 16 A rows staged in shared memory at a_s
// (pitch DP+8) with the NT*8 B rows at b_s: s[n] is the m16n8 accumulator
// of B rows 8n..8n+7, one ldmatrix per k-chunk for A.
template <int DP, int NT>
__device__ __forceinline__ void score_tile_s(float (&s)[NT][4],
                                             const bf16* a_s,
                                             const bf16* b_s, int lane) {
  constexpr int kPitch = DP + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    uint32_t a[4];
    ldmatrix_x4(a, a_s + (lane & 15) * kPitch + kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      const int key = np * 16 + (lane & 7) + (lane >> 4) * 8;
      const int col = kc * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(r, b_s + key * kPitch + col);
      mma(s[2 * np], a, r[0], r[1]);
      mma(s[2 * np + 1], a, r[2], r[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Takes bf16 rows whose head slices start on 16-byte boundaries: D a
// multiple of 8, every base pointer and every pitch a multiple of 16 bytes.
inline bool eligible(int D, std::initializer_list<const void*> ptrs,
                     std::initializer_list<long> pitches) {
  if (D % 8 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (long pitch : pitches)
    if (pitch % 8 != 0) return false;
  return true;
}

}  // namespace tc
}  // namespace mct

// Calls FN<DP>(args...) for the smallest multiple of 16 that holds D.
#define MCT_TC_DISPATCH(FN, D, ...)                          \
  switch (((D) + 15) / 16) {                                 \
    case 1: return FN<16>(__VA_ARGS__);                      \
    case 2: return FN<32>(__VA_ARGS__);                      \
    case 3: return FN<48>(__VA_ARGS__);                      \
    case 4: return FN<64>(__VA_ARGS__);                      \
    case 5: return FN<80>(__VA_ARGS__);                      \
    case 6: return FN<96>(__VA_ARGS__);                      \
    case 7: return FN<112>(__VA_ARGS__);                     \
    case 8: return FN<128>(__VA_ARGS__);                     \
    default: return cudaErrorInvalidValue;                   \
  }
