// Hopper (sm_90a) building blocks shared by the kernels that run on wgmma:
// the fused CE backward (fused_ce.cu) and the fused flash backward
// (flash_attention.cu).
//
// - wgmma: the warpgroup's 64-row product D[64 x N] += A[64 x 16] B[16 x N]
//   in bf16 with fp32 accumulation (N = 64, 128, 256), A and B read from
//   shared memory through matrix descriptors (wgmma_ss) or A from registers
//   (wgmma_rs, N = 128), with the fence, commit and wait that order them;
//   fence_regs keeps the compiler from touching an accumulator while a
//   product is in flight.
// - Operand tiles in shared memory use the 128-byte swizzle: a panel of
//   rows of 64 bf16 (128 bytes), 16-byte chunk c of row r stored at chunk
//   c ^ (r % 8), panels 1024-byte aligned. The same panel is a K-major
//   operand (rows are M or N, columns K: desc_k) or an MN-major one (rows
//   are K, columns M or N: desc_mn); a wider operand is several panels.
// - TMA: tensor maps encoded on the host (make_map), tiles loaded by one
//   thread into a panel, completion counted on an mbarrier; TMA fills rows
//   and columns past the tensor's extent with zeros.
// - The TMA reduce-add: an fp32 box of shared memory added into device
//   memory by the copy engine (cp.reduce.async.bulk.tensor), with the bulk
//   group's commit and waits.
// - tile_check: one wgmma tile product for each operand layout the kernels
//   use, exported by each library that includes this header, so that a
//   descriptor or swizzle fault shows on its own line (chip_smoke.py phase
//   3) before any kernel is checked.
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

// ---------------------------------------------------------------------------
// wgmma

// A matrix descriptor for the 128-byte swizzle: start address, leading and
// stride byte offsets.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : MCT_D32(0)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
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
// 16), box in elements, boxes of 128-byte rows swizzled or not.
// Out-of-range elements load as zeros and are left out of stores and
// reductions. False if the encoding is refused.
inline bool make_map(CUtensorMap* m, bool bf16, bool swizzled, int rank,
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
                swizzled ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major bf16 [rows, cols] matrix as a 2-D map of (64 x box_rows)
// boxes (cols % 8 == 0).
inline bool matrix_map(CUtensorMap* m, const void* p, long rows, long cols,
                       int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {kPanelCols, (uint32_t)box_rows};
  return make_map(m, true, true, 2, p, dims, strides, box);
}

// ---------------------------------------------------------------------------
// The tile check: C[64 x 128] = A[64 x 64] B[64 x 128] in one warpgroup,
// four k-steps of m64n128k16. a: [M][K] row-major, or [K][M] if ta (A
// MN-major); b: [N][K] (K-major) or, if tb, [K][N]; a_regs: A from
// registers (K-major only). The operands reach shared memory by TMA
// (via_tma) or by the threads' own swizzled stores.
struct TileCheck {
  CUtensorMap a, b;
};

__global__ void __launch_bounds__(128)
tile_check_kernel(const __grid_constant__ TileCheck maps, const bf16* a,
                  const bf16* b, float* c, int ta, int tb, int a_regs,
                  int via_tma) {
  extern __shared__ __align__(1024) unsigned char check_smem[];
  unsigned char* base = align_1024(check_smem);
  bf16* as = reinterpret_cast<bf16*>(base);          // 8 KB: one panel
  bf16* bs = reinterpret_cast<bf16*>(base + 8192);   // 16 KB
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + 8192 + 16384);
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  if (via_tma) {
    if (t == 0) {
      mbar_init(bar, 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (t == 0) {
      mbar_expect_tx(bar, 8192 + 16384);
      tma_load_2d(as, &maps.a, bar, 0, 0);
      if (tb) {  // two [64 K][64 N] panels
        tma_load_2d(bs, &maps.b, bar, 0, 0);
        tma_load_2d(bs + 4096, &maps.b, bar, 64, 0);
      } else {  // one [128 N][64 K] panel
        tma_load_2d(bs, &maps.b, bar, 0, 0);
      }
    }
    mbar_wait(bar, 0);
  } else {
    unsigned char* ab = reinterpret_cast<unsigned char*>(as);
    unsigned char* bb = reinterpret_cast<unsigned char*>(bs);
    for (int i = t; i < 64 * 64; i += 128) {
      const int r = i / 64, col = i % 64;  // a's storage row and column
      *reinterpret_cast<bf16*>(ab + swz(r, col)) = a[i];
    }
    for (int i = t; i < 64 * 128; i += 128) {
      if (tb) {  // b [64 K][128 N]: panel col / 64
        const int r = i / 128, col = i % 128;
        *reinterpret_cast<bf16*>(bb + (col / 64) * 8192 + swz(r, col % 64)) =
            b[i];
      } else {  // b [128 N][64 K]
        const int r = i / 64, col = i % 64;
        *reinterpret_cast<bf16*>(bb + swz(r, col)) = b[i];
      }
    }
    fence_async_smem();
    __syncthreads();
  }
  __syncwarp();
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  uint32_t af[4][4];
  if (a_regs) {  // the fragment layout, read from a [M][K]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * w + (l >> 2) + 8 * (i & 1);
        const int k = 16 * kk + 2 * (l & 3) + 8 * (i >> 1);
        __nv_bfloat162 v;
        v.x = a[r * 64 + k];
        v.y = a[r * 64 + k + 1];
        af[kk][i] = *reinterpret_cast<uint32_t*>(&v);
      }
  }
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = tb ? desc_mn(bs, kk, 8192) : desc_k(bs, kk);
    if (a_regs) {
      if (tb)
        wgmma_rs<1>(d, af[kk], db, 1);
      else
        wgmma_rs<0>(d, af[kk], db, 1);
    } else {
      // A's 64 rows from row 0 (K-major) or its one M panel (MN-major)
      const uint64_t da = ta ? desc_mn(as, kk, 8192) : desc_k(as, kk);
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
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = 16 * w + (l >> 2) + 8 * ((i & 3) >> 1);
    const int col = 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
    c[r * 128 + col] = d[i];
  }
}

}  // namespace sm90
}  // namespace mct

// The C entry point each library that includes this header exports: the
// tile check above (0 on success, else the launch's or the map's error).
#define MCT_SM90_TILE_CHECK_EXPORT                                            \
  extern "C" int mct_sm90_tile_check(const void* a, const void* b, float* c,  \
                                     int ta, int tb, int a_regs, int via_tma, \
                                     void* stream) {                          \
    using namespace mct::sm90;                                                \
    TileCheck maps{};                                                         \
    if (via_tma) {                                                            \
      const uint64_t sq[2] = {64, 64}, s64[1] = {128};                        \
      const uint32_t box_a[2] = {64, 64};                                     \
      if (!make_map(&maps.a, true, true, 2, a, sq, s64, box_a))               \
        return (int)cudaErrorInvalidValue;                                    \
      const uint64_t dims_b[2] = {tb ? 128u : 64u, tb ? 64u : 128u};          \
      const uint64_t str_b[1] = {tb ? 256u : 128u};                           \
      const uint32_t box_b[2] = {64, tb ? 64u : 128u};                        \
      if (!make_map(&maps.b, true, true, 2, b, dims_b, str_b, box_b))         \
        return (int)cudaErrorInvalidValue;                                    \
    }                                                                         \
    const int smem = 1024 + 8192 + 16384 + 64;                                \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        tile_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
    if (e != cudaSuccess) return (int)e;                                      \
    tile_check_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(   \
        maps, static_cast<const __nv_bfloat16*>(a),                           \
        static_cast<const __nv_bfloat16*>(b), c,                              \
        ta, tb, a_regs, via_tma);                                             \
    return (int)cudaGetLastError();                                           \
  }
