// Hopper (sm_90a) building blocks shared by the kernels that run on wgmma:
// the fused CE forward and backward (fused_ce.cu), the fused flash backward
// (flash_attention.cu), the attention forwards (attn_fwd_sm90.cuh, in
// flash_attention.cu and fused_mha.cu) and the fused-MHA backwards past
// S = 128, recomputing P or from saved P (attn_bwd_sm90.cuh, in
// fused_mha.cu).
//
// - wgmma: the warpgroup's 64-row product D[64 x N] += A[64 x 16] B[16 x N]
//   in bf16 with fp32 accumulation (N = 64, 128, 256), A and B read from
//   shared memory through matrix descriptors (wgmma_ss) or A from registers
//   (wgmma_rs, N = 64 and 128), with the fence, commit and wait that order
//   them; fence_regs keeps the compiler from touching an accumulator while a
//   product is in flight. wgmma_ss_at / wgmma_rs_at (N = 64 or 16) write
//   columns of a wider accumulator: at D = 80 an m64n80 sum is an n64
//   product into its first 32 floats and an n16 product into its last 8,
//   which is the m64n80 layout.
// - setmaxnreg: a warp-specialised block hands registers from its producer
//   warpgroup to its consumers.
// - Operand tiles in shared memory use the 128-byte swizzle: a panel of
//   rows of 64 bf16 (128 bytes), 16-byte chunk c of row r stored at chunk
//   c ^ (r % 8), panels 1024-byte aligned. The same panel is a K-major
//   operand (rows are M or N, columns K: desc_k) or an MN-major one (rows
//   are K, columns M or N: desc_mn); a wider operand is several panels.
//   A row of 80 (ViT-H/14's head) is 160 bytes, no whole number of
//   128-byte rows: its last 16 columns form a panel of their own under the
//   32-byte swizzle (rows of 32 bytes, chunk c of row r at c ^ (r / 4 % 2):
//   swz32, desc_k32, desc_mn32). Tile<D, R> is the layout of R rows of D
//   (64, 80 or 128) columns: D / 64 wide panels, then at D = 80 the tail.
// - TMA: tensor maps encoded on the host (make_map), tiles loaded by one
//   thread into a panel, completion counted on an mbarrier; TMA fills rows
//   and columns past the tensor's extent with zeros. probs_map: the saved
//   P of the fused MHA as a 3-D map, its rows a multiple of 8 elements
//   apart (TMA's 16-byte strides).
// - The TMA reduce-add: an fp32 box of shared memory added into device
//   memory by the copy engine (cp.reduce.async.bulk.tensor), with the bulk
//   group's commit and waits.
// - view_map / load_view_rows: a 4-D map of a strided [B, H, S, D] view
//   (a packed projection's head, an S-major tensor) and the load of a box
//   of its rows; View / view_maps / load_tile: the map of its wide panels
//   and (D = 80) the 16-column map of its tail, and a Tile's load.
// - tile_check: one wgmma tile product for each operand layout and shape
//   the kernels use (N = 64, 80, 128 or 256, K = 64, 80 or 128: at 80 the
//   wide panel and the tail), exported by each
//   library that includes this header, so that a descriptor or swizzle
//   fault shows on its own line (chip_smoke.py phase 3) before any kernel
//   is checked.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tiles.cuh"

// "+f" operands d[i..i+N) of an accumulator array d
#define MCT_D8(i)                                                       \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),   \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]),             \
      "+f"(d[(i) + 7])
#define MCT_D32(i) \
  MCT_D8(i), MCT_D8((i) + 8), MCT_D8((i) + 16), MCT_D8((i) + 24)
#define MCT_D64(i) MCT_D32(i), MCT_D32((i) + 32)
#define MCT_D128(i) MCT_D64(i), MCT_D64((i) + 64)

namespace mct {
namespace sm90 {

using bf16 = __nv_bfloat16;
using tc::pack_bf16;
constexpr int kPanelCols = 64;     // bf16 columns of a 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 1024;   // 8 rows: the swizzle's period
constexpr int kKStepBytes = 32;    // 16 bf16: one k-step along a K-major row
constexpr int kMnStepBytes = 2048; // 16 rows: one k-step down an MN-major panel
// the 32-byte swizzle of a 16-column tail panel
constexpr int kTailCols = 16;
constexpr int kTailRowBytes = 32;
constexpr int kTailAtomBytes = 256;    // 8 rows
constexpr int kTailMnStepBytes = 512;  // 16 rows

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the MUFU, without exp2f's scaling of results below 2^-126 (they
// flush to 0, as masked scores do); at most 2 ulps off (the PTX ISA).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The first 1024-byte aligned address at or after p (shared memory); a
// kernel asks for 1024 bytes more than its layout for it.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Byte offset of element (r, c) (c < 64) in a swizzled panel.
__host__ __device__ constexpr int swz(int r, int c) {
  return r * kRowBytes + (((c >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}
// ... (c < 16) in a tail panel (32-byte swizzle).
__host__ __device__ constexpr int swz32(int r, int c) {
  return r * kTailRowBytes + (((c >> 3) ^ ((r >> 2) & 1)) << 4) +
         ((c & 7) << 1);
}
// Byte offset of element (r, c) in a tile of `rows` rows of d columns (d
// a multiple of 64, or 64 k + 16): the d / 64 wide panels, then the tail.
__host__ __device__ constexpr int tile_at(int d, int rows, int r, int c) {
  return c < (d & ~63) ? (c >> 6) * rows * kRowBytes + swz(r, c & 63)
                       : (d >> 6) * rows * kRowBytes + swz32(r, c & 15);
}

// ---------------------------------------------------------------------------
// wgmma

// A matrix descriptor: start address, leading and stride byte offsets, and
// the layout (1: the 128-byte swizzle, 3: the 32-byte one).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout = 1) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}
// K-major: rows of the panel are M (or N), 8-row groups 1024 bytes apart;
// k-step kk of a row starts kk * 32 bytes in (kk < 4 within a panel).
__device__ __forceinline__ uint64_t desc_k(const void* panel, int kk) {
  return desc(static_cast<const char*>(panel) + kk * kKStepBytes, 16,
              kAtomBytes);
}
// MN-major: rows of the panel are K; k-step kk starts 16 rows down; the
// 64-column panels along M (or N) lie `panel_bytes` apart.
__device__ __forceinline__ uint64_t desc_mn(const void* panel, int kk,
                                            uint32_t panel_bytes) {
  return desc(static_cast<const char*>(panel) + kk * kMnStepBytes,
              panel_bytes, kAtomBytes);
}

// A tail panel (32-byte swizzle, 8-row groups 256 bytes apart). K-major:
// its 16 columns are one k-step. MN-major: its 16 columns are one N (or M)
// atom; k-step kk starts 16 rows down.
__device__ __forceinline__ uint64_t desc_k32(const void* panel) {
  return desc(panel, 16, kTailAtomBytes, 3);
}
__device__ __forceinline__ uint64_t desc_mn32(const void* panel, int kk) {
  return desc(static_cast<const char*>(panel) + kk * kTailMnStepBytes, 16,
              kTailAtomBytes, 3);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders the compiler's accesses to the registers of x around wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// Accumulator layout (m64nN, fp32): thread t of the warpgroup, warp w =
// t / 32, lane l, holds d[4 j + e] = D(16 w + l / 4 + 8 (e >> 1),
// 8 j + 2 (l % 4) + (e & 1)). The register A fragment of k-step kk holds
// A(16 w + l / 4 + 8 (i & 1), 16 kk + 2 (l % 4) + 8 (i >> 1) + {0, 1}) in
// a[i]: an accumulator's columns 16 kk.. rounded to bf16 pairs are that
// fragment.
// TA / TB: 0 K-major, 1 MN-major.
//
// m64nNk16 (N = 64 or 16) into columns of a wider accumulator, d[O, O +
// N / 2), in the layout of d's own width (8-column group j of the product
// is group O / 4 + j of d); the m64n64 overloads below are its O = 0.
template <int TA, int TB, int N, int O, int M>
__device__ __forceinline__ void wgmma_ss_at(float (&d)[M], uint64_t da,
                                            uint64_t db, int acc) {
  static_assert((N == 64 || N == 16) && O + N / 2 <= M, "n64 or n16 in d");
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : MCT_D32(O)
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : MCT_D8(O)
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TB, int N, int O, int M>
__device__ __forceinline__ void wgmma_rs_at(float (&d)[M],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  static_assert((N == 64 || N == 16) && O + N / 2 <= M, "n64 or n16 in d");
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : MCT_D32(O)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(TB));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : MCT_D8(O)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  wgmma_ss_at<TA, TB, 64, 0>(d, da, db, acc);
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : MCT_D64(0)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : MCT_D128(0)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
  wgmma_rs_at<TB, 64, 0>(d, a, db, acc);
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : MCT_D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

// ---------------------------------------------------------------------------
// Tiles of rows of D columns

// R rows of D bf16 columns (D = 64, 80 or 128): D / 64 wide panels of
// [R][64] (128-byte swizzle), then at D = 80 a tail panel of [R][16]
// (32-byte swizzle); R * 2 D bytes, every panel 1024-byte aligned when R is
// a multiple of 32.
template <int D, int R>
struct Tile {
  static_assert(D == 64 || D == 80 || D == 128, "D = 64, 80 or 128");
  static constexpr int kWide = D / 64;
  static constexpr bool kTail = D % 64 != 0;
  static constexpr int kPanel = R * kRowBytes;  // one wide panel
  static constexpr int kTailAt = kWide * kPanel;
  static constexpr int kBytes = R * 2 * D;
  // byte offset of element (r, c), and of 16-byte chunk ch of row r
  __host__ __device__ static constexpr int at(int r, int c) {
    return tile_at(D, R, r, c);
  }
  __host__ __device__ static constexpr int chunk(int r, int ch) {
    return at(r, 8 * ch);
  }
  // K-major (rows M or N, columns K = D): k-step kk of the 64 (or N) rows
  // from row r0 (a multiple of 8)
  __device__ static uint64_t desc_k(const unsigned char* t, int r0, int kk) {
    if (kTail && kk == D / 16 - 1) return desc_k32(t + kTailAt + r0 * 32);
    return sm90::desc_k(t + (kk >> 2) * kPanel + r0 * kRowBytes, kk & 3);
  }
};

// d (m64nN) = A B over K = D, both K-major: A the 64 rows from row a0 of a
// Tile<D, RA> at a, B every row of a Tile<D, N> at b; issued, not
// committed. At D = 80 four k-steps on the wide panels and one on the
// tails.
template <int D, int RA, int N>
__device__ __forceinline__ void wgmma_kd(float (&d)[N / 2],
                                         const unsigned char* a, int a0,
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0, 0>(d, Tile<D, RA>::desc_k(a, a0, kk),
                   Tile<D, N>::desc_k(b, 0, kk), kk > 0);
}

// d (m64nD) += A B for k-step kk, B MN-major: a Tile<D, K> at b (rows K,
// columns N = D); A from registers (a) or, K-major, from shared memory
// (da). One m64nD product at D = 64 and 128; at D = 80 an n64 on the wide
// panel and an n16 on the tail.
template <int D, int K>
__device__ __forceinline__ void wgmma_rs_nd(float (&d)[D / 2],
                                            const uint32_t (&a)[4],
                                            const unsigned char* b, int kk) {
  using T = Tile<D, K>;
  if constexpr (T::kTail) {
    wgmma_rs_at<1, 64, 0>(d, a, desc_mn(b, kk, T::kPanel), 1);
    wgmma_rs_at<1, 16, 32>(d, a, desc_mn32(b + T::kTailAt, kk), 1);
  } else {
    wgmma_rs<1>(d, a, desc_mn(b, kk, T::kPanel), 1);
  }
}
// TA: A K-major (0) or MN-major (1), as da describes it.
template <int D, int K, int TA = 0>
__device__ __forceinline__ void wgmma_ss_nd(float (&d)[D / 2], uint64_t da,
                                            const unsigned char* b, int kk) {
  using T = Tile<D, K>;
  if constexpr (T::kTail) {
    wgmma_ss_at<TA, 1, 64, 0>(d, da, desc_mn(b, kk, T::kPanel), 1);
    wgmma_ss_at<TA, 1, 16, 32>(d, da, desc_mn32(b + T::kTailAt, kk), 1);
  } else {
    wgmma_ss<TA, 1>(d, da, desc_mn(b, kk, T::kPanel), 1);
  }
}

// The registers a thread of this warpgroup may hold from here on (every
// warp of the warpgroup executes it): dec hands them back to the SM, inc
// takes them, up to the block's budget.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier `id` (1..15) of `threads` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// mbarrier, fences, TMA loads and the TMA reduce-add

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// Makes this thread's generic-proxy writes to shared memory visible to
// the async proxy (wgmma operands, bulk copies) after a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t map_addr(const CUtensorMap* m) {
  return reinterpret_cast<uint64_t>(m);
}
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* m,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map_addr(m)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* m,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map_addr(m)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* m,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map_addr(m)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* m,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map_addr(m)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The box of an fp32 map at the coordinates += the tile at src (in the
// map's box layout), in this thread's current bulk group; elements out of
// the tensor's range are left out.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* m,
                                                  const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(map_addr(m)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's bulk groups but N have read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Tensor maps (host)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query (no link against libcuda); null where libcuda has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tiled map of a `rank`-dimensional bf16 or fp32 tensor at p: dims
// innermost first (elements), strides of dims 1.. in bytes (multiples of
// 16), box in elements, boxes of rows swizzled in `swizzle`-byte spans
// (128: 128-byte rows; 32: the 32-byte rows of a tail panel; 0: none).
// Out-of-range elements load as zeros and are left out of stores and
// reductions. False if the encoding is refused.
inline bool make_map(CUtensorMap* m, bool bf16, int swizzle, int rank,
                     const void* p, const uint64_t* dims,
                     const uint64_t* strides, const uint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  return encode(m,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                rank, const_cast<void*>(p), d, s, b, e,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D map of a bf16 [B, H, S, D] view (D contiguous, strides in
// elements), its other axes in the order of their strides, boxes of
// `cols` columns (64: a wide panel, 128-byte swizzle; 16: a tail panel,
// 32-byte swizzle) x `rows` of one head; perm receives the map dimensions
// of (s, h, b): bits 0-1, 2-3 and 4-5.
inline bool view_map(CUtensorMap* m, int& perm, const void* p, long sb,
                     long sh, long ss, int B, int H, int S, int D, int rows,
                     int cols = kPanelCols) {
  struct Axis {
    long stride;
    int n, box, id;
  } ax[3] = {{ss, S, rows, 0}, {sh, H, 1, 1}, {sb, B, 1, 2}};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && ax[j].stride < ax[j - 1].stride; --j) {
      const Axis t = ax[j];
      ax[j] = ax[j - 1];
      ax[j - 1] = t;
    }
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)ax[0].n, (uint64_t)ax[1].n,
                            (uint64_t)ax[2].n};
  const uint64_t strides[3] = {(uint64_t)ax[0].stride * 2,
                               (uint64_t)ax[1].stride * 2,
                               (uint64_t)ax[2].stride * 2};
  const uint32_t box[4] = {(uint32_t)cols, (uint32_t)ax[0].box,
                           (uint32_t)ax[1].box, (uint32_t)ax[2].box};
  perm = 0;
  for (int i = 0; i < 3; ++i) perm |= (i + 1) << (2 * ax[i].id);
  return make_map(m, true, cols == kTailCols ? 32 : 128, 4, p, dims, strides,
                  box);
}

// Columns [col, col + box columns) of rows [s, s + box rows) of head
// (b, h) of a view_map into a panel, counted on `bar`.
__device__ __forceinline__ void load_view_rows(void* dst, const CUtensorMap* m,
                                               uint64_t* bar, int perm,
                                               int col, int s, int h, int b) {
  const int ps = perm & 3, ph = (perm >> 2) & 3;
  const int c1 = ps == 1 ? s : ph == 1 ? h : b;
  const int c2 = ps == 2 ? s : ph == 2 ? h : b;
  const int c3 = ps == 3 ? s : ph == 3 ? h : b;
  tma_load_4d(dst, m, bar, col, c1, c2, c3);
}

// A [B, H, S, D] view's maps: its wide panels' and, at D = 80, its tail's.
struct View {
  CUtensorMap wide, tail;
};

inline bool view_maps(View* v, int& perm, const void* p, long sb, long sh,
                      long ss, int B, int H, int S, int D, int rows) {
  return view_map(&v->wide, perm, p, sb, sh, ss, B, H, S, D, rows) &&
         (D % 64 == 0 || view_map(&v->tail, perm, p, sb, sh, ss, B, H, S, D,
                                  rows, kTailCols));
}

// Rows [s, s + R) of head (b, h) of a view into a Tile<D, R> at dst, counted
// on `bar` (R * 2 D bytes).
template <int D, int R>
__device__ __forceinline__ void load_tile(unsigned char* dst, const View& v,
                                          uint64_t* bar, int perm, int s,
                                          int h, int b) {
  using T = Tile<D, R>;
#pragma unroll
  for (int p = 0; p < T::kWide; ++p)
    load_view_rows(dst + p * T::kPanel, &v.wide, bar, perm, 64 * p, s, h, b);
  if constexpr (T::kTail)
    load_view_rows(dst + T::kTailAt, &v.tail, bar, perm, 64 * T::kWide, s, h,
                   b);
}

// The saved probabilities P of the fused MHA, [BH, S, S] rows `pitch`
// elements apart (a multiple of 8), as a 3-D map of boxes of 64 keys x
// `rows` query rows of one head (128-byte swizzle: a [rows][64] panel).
inline bool probs_map(CUtensorMap* m, const void* p, long bh, int S,
                      long pitch, int rows) {
  const uint64_t dims[3] = {(uint64_t)S, (uint64_t)S, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)pitch * 2,
                               (uint64_t)S * pitch * 2};
  const uint32_t box[3] = {kPanelCols, (uint32_t)rows, 1};
  return make_map(m, true, 128, 3, p, dims, strides, box);
}

// A row-major bf16 [rows, cols] matrix as a 2-D map of (64 x box_rows)
// boxes (cols % 8 == 0).
inline bool matrix_map(CUtensorMap* m, const void* p, long rows, long cols,
                       int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {kPanelCols, (uint32_t)box_rows};
  return make_map(m, true, 128, 2, p, dims, strides, box);
}

// ---------------------------------------------------------------------------
// The tile check: C[64 x N] = A[64 x K] B[K x N] in one warpgroup, K / 16
// k-steps, (N, K) in {64, 128, 256} x {64} or {64, 128} x {128}, and the
// shapes of ViT-H/14's head of 80: (128, 80), (64, 80) (both operands
// K-major), (80, 128), (80, 64) (B MN-major). a: [M][K] row-major, or [K][M]
// if ta (A MN-major); b: [N][K] (K-major) or, if tb, [K][N]; a_regs: A from
// registers (K-major, N <= 128). The operands reach shared memory by TMA
// (via_tma) or by the threads' own swizzled stores, in the kernels' tiles:
// A K-major as Tile<K, 64>, MN-major as one panel of [K][64]; B K-major as
// Tile<K, N>, MN-major as Tile<N, K> (rows K). At K = 80 the fifth k-step
// reads the tails (desc_k32); at N = 80 each k-step is an n64 product on
// the wide panel and an n16 on the tail (wgmma_rs_nd, wgmma_ss_nd).
struct TileCheck {
  CUtensorMap a, b, a_tail, b_tail;
};
constexpr int kCheckA = 16384;  // A: up to 64 x 128 bf16
constexpr int kCheckB = 32768;  // B: up to 256 x 64 or 128 x 128

// The K / 16 k-steps in the layout (ta, tb, a_regs) into d (N / 2 floats).
template <int N, int K>
__device__ __forceinline__ void tile_check_product(float (&d)[N / 2],
                                                   const bf16* a,
                                                   const unsigned char* as,
                                                   const unsigned char* bs,
                                                   int ta, int tb,
                                                   int a_regs) {
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  uint32_t af[K / 16][4];
  if (N <= 128 && a_regs) {  // the fragment layout, read from a [M][K]
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * w + (l >> 2) + 8 * (i & 1);
        const int k = 16 * kk + 2 * (l & 3) + 8 * (i >> 1);
        __nv_bfloat162 v;
        v.x = a[r * K + k];
        v.y = a[r * K + k + 1];
        af[kk][i] = *reinterpret_cast<uint32_t*>(&v);
      }
  }
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    // A's 64 rows: K-major from its tile, MN-major k-step kk of its one
    // panel
    const uint64_t da = ta ? desc_mn(as, kk, 8192)
                           : Tile<K, 64>::desc_k(as, 0, kk);
    if constexpr (N == 80) {  // B MN-major only
      if (a_regs) {
        wgmma_rs_nd<N, K>(d, af[kk], bs, kk);
      } else if (ta) {
        wgmma_ss_at<1, 1, 64, 0>(d, da, desc_mn(bs, kk, K * kRowBytes), 1);
        wgmma_ss_at<1, 1, 16, 32>(
            d, da, desc_mn32(bs + Tile<N, K>::kTailAt, kk), 1);
      } else {
        wgmma_ss_nd<N, K>(d, da, bs, kk);
      }
    } else {
      const uint64_t db = tb ? desc_mn(bs, kk, K * kRowBytes)
                             : Tile<K, N>::desc_k(bs, 0, kk);
      if constexpr (N <= 128) {
        if (a_regs) {
          if (tb)
            wgmma_rs<1>(d, af[kk], db, 1);
          else
            wgmma_rs<0>(d, af[kk], db, 1);
          continue;
        }
      }
      if (ta && tb)
        wgmma_ss<1, 1>(d, da, db, 1);
      else if (ta)
        wgmma_ss<1, 0>(d, da, db, 1);
      else if (tb)
        wgmma_ss<0, 1>(d, da, db, 1);
      else
        wgmma_ss<0, 0>(d, da, db, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  if (N <= 128 && a_regs) fence_regs(af);
}

template <int N, int K>
__device__ __forceinline__ void tile_check_run(const bf16* a,
                                               const unsigned char* as,
                                               const unsigned char* bs,
                                               float* c, int ta, int tb,
                                               int a_regs) {
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  tile_check_product<N, K>(d, a, as, bs, ta, tb, a_regs);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = 16 * w + (l >> 2) + 8 * ((i & 3) >> 1);
    const int col = 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
    c[r * N + col] = d[i];
  }
}

// Whether the tile check takes (n, k) in the layout (ta, tb, a_regs).
__host__ __device__ inline bool tile_check_shape(int n, int k, int ta, int tb,
                                                 int a_regs) {
  const bool shape =
      k == 64 ? (n == 64 || n == 80 || n == 128 || n == 256)
      : k == 128 ? (n == 64 || n == 80 || n == 128)
                 : k == 80 && (n == 64 || n == 128);
  return shape && (n != 80 || tb) && !(a_regs && (ta || n > 128));
}

__global__ void __launch_bounds__(128)
tile_check_kernel(const __grid_constant__ TileCheck maps, const bf16* a,
                  const bf16* b, float* c, int n, int k, int ta, int tb,
                  int a_regs, int via_tma) {
  extern __shared__ __align__(1024) unsigned char check_smem[];
  unsigned char* as = align_1024(check_smem);
  unsigned char* bs = as + kCheckA;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bs + kCheckB);
  const int t = threadIdx.x;
  // the panels along A's and B's contiguous axes: A K-major Tile<k, 64>, B
  // K-major Tile<k, n> (wide panels along K) or MN-major Tile<n, k> (along
  // N); `rows` each, a tail past the last 64-column panel
  const int a_rows = 64, b_rows = tb ? k : n, b_cols = tb ? n : k;
  if (via_tma) {
    if (t == 0) {
      mbar_init(bar, 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (t == 0) {
      mbar_expect_tx(bar, (64 + n) * k * 2);
      if (ta) {  // one [k K][64 M] panel
        tma_load_2d(as, &maps.a, bar, 0, 0);
      } else {
        for (int p = 0; p < k / 64; ++p)
          tma_load_2d(as + p * a_rows * kRowBytes, &maps.a, bar, 64 * p, 0);
        if (k % 64)
          tma_load_2d(as + (k / 64) * a_rows * kRowBytes, &maps.a_tail, bar,
                      64 * (k / 64), 0);
      }
      for (int p = 0; p < b_cols / 64; ++p)
        tma_load_2d(bs + p * b_rows * kRowBytes, &maps.b, bar, 64 * p, 0);
      if (b_cols % 64)
        tma_load_2d(bs + (b_cols / 64) * b_rows * kRowBytes, &maps.b_tail,
                    bar, 64 * (b_cols / 64), 0);
    }
    mbar_wait(bar, 0);
  } else {
    for (int i = t; i < 64 * k; i += 128) {
      if (ta) {  // a [k K][64 M]
        const int r = i / 64, col = i % 64;
        *reinterpret_cast<bf16*>(as + swz(r, col)) = a[i];
      } else {  // a [64 M][k K]
        const int r = i / k, col = i % k;
        *reinterpret_cast<bf16*>(as + tile_at(k, a_rows, r, col)) = a[i];
      }
    }
    for (int i = t; i < n * k; i += 128) {  // b [b_rows][b_cols]
      const int r = i / b_cols, col = i % b_cols;
      *reinterpret_cast<bf16*>(bs + tile_at(b_cols, b_rows, r, col)) = b[i];
    }
    fence_async_smem();
    __syncthreads();
  }
  __syncwarp();
  if (k == 64) {
    if (n == 64)
      tile_check_run<64, 64>(a, as, bs, c, ta, tb, a_regs);
    else if (n == 80)
      tile_check_run<80, 64>(a, as, bs, c, ta, tb, a_regs);
    else if (n == 128)
      tile_check_run<128, 64>(a, as, bs, c, ta, tb, a_regs);
    else
      tile_check_run<256, 64>(a, as, bs, c, ta, tb, a_regs);
  } else if (k == 80) {
    if (n == 64)
      tile_check_run<64, 80>(a, as, bs, c, ta, tb, a_regs);
    else
      tile_check_run<128, 80>(a, as, bs, c, ta, tb, a_regs);
  } else if (n == 64) {
    tile_check_run<64, 128>(a, as, bs, c, ta, tb, a_regs);
  } else if (n == 80) {
    tile_check_run<80, 128>(a, as, bs, c, ta, tb, a_regs);
  } else {
    tile_check_run<128, 128>(a, as, bs, c, ta, tb, a_regs);
  }
}

// The 2-D maps of a row-major bf16 [rows][cols] operand at p: boxes of 64
// columns x box_rows (128-byte swizzle) and, where cols % 64 = 16, of its
// last 16 columns (32-byte swizzle).
inline bool tile_check_maps(CUtensorMap* wide, CUtensorMap* tail,
                            const void* p, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, (uint32_t)box_rows};
  const uint32_t box_tail[2] = {kTailCols, (uint32_t)box_rows};
  return make_map(wide, true, 128, 2, p, dims, strides, box) &&
         (cols % 64 == 0 ||
          make_map(tail, true, 32, 2, p, dims, strides, box_tail));
}

}  // namespace sm90
}  // namespace mct

// The C entry point each library that includes this header exports: the
// tile check above at (N, K) = (n, k) (0 on success, else the launch's or
// the map's error).
#define MCT_SM90_TILE_CHECK_EXPORT                                            \
  extern "C" int mct_sm90_tile_check(const void* a, const void* b, float* c,  \
                                     int n, int k, int ta, int tb,            \
                                     int a_regs, int via_tma, void* stream) { \
    using namespace mct::sm90;                                                \
    if (!tile_check_shape(n, k, ta, tb, a_regs))                              \
      return (int)cudaErrorInvalidValue;                                      \
    TileCheck maps{};                                                         \
    /* a [64][k] or, if ta, [k][64]; b [n][k] or, if tb, [k][n] */            \
    if (via_tma &&                                                            \
        !(ta ? tile_check_maps(&maps.a, &maps.a_tail, a, k, 64, k)            \
             : tile_check_maps(&maps.a, &maps.a_tail, a, 64, k, 64)) ||       \
        via_tma &&                                                            \
        !(tb ? tile_check_maps(&maps.b, &maps.b_tail, b, k, n, k)             \
             : tile_check_maps(&maps.b, &maps.b_tail, b, n, k, n)))           \
      return (int)cudaErrorInvalidValue;                                      \
    const int smem = 1024 + kCheckA + kCheckB + 64;                           \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        tile_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
    if (e != cudaSuccess) return (int)e;                                      \
    tile_check_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(   \
        maps, static_cast<const __nv_bfloat16*>(a),                           \
        static_cast<const __nv_bfloat16*>(b), c, n, k, ta, tb, a_regs,        \
        via_tma);                                                             \
    return (int)cudaGetLastError();                                           \
  }
