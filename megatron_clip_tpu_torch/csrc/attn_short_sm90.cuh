// The bf16 fused-MHA forward at S <= 128, D = 64 on Hopper (sm_90a): one
// pass over one key tile, a whole head per block, persistent blocks.
//
// Replaces, at those shapes, what tc::fwd (fused_mha.cu, mma.sync, two
// passes over 64-key tiles, two blocks a head at S = 77) ran for the TPU
// kernel megatron_clip_tpu/ops/pallas/fused_mha.py::_fwd_kernel (call :289),
// which forms each head's whole S x S score tile and takes an exact softmax
// in one pass (_softmax_rows). Its paths: both ViT-B/32 towers (vision
// S = 50, text S = 77 causal) in serving (plain) and training (with P), the
// ViT-L/14 and ViT-H/14 text towers (S = 77 causal, with row statistics).
//
// What bounds it. A head moves 4 S D elements (q, k, v in, o out), with P
// S^2 more, for 4 S^2 D FLOP: under 20 FLOP a byte, so device-memory bytes
// bound it (157 MB, 0.0470 ms at ViT-B/32's text tower with P, B = 384, on
// an H100's 3.35 TB/s). Its work per head is a few microseconds of products
// and exponentials; what costs is latency: loads that wait, stores that
// trickle. attn_fwd_sm90.cuh's two-pass wgmma mainloop lost here (0.0803
// ms against tc::'s 0.046-0.056 at ViT-L/14's text tower) because one
// block of 384 threads took 128 rows of one head, loaded K twice and
// walked the keys twice, with nothing to overlap its loads with.
//
// Design.
// - One pass: one block owns every query row of a head (S <= 128), so the
//   scores are formed once, in fp32 registers (the m16n8 accumulator
//   layout, which mma.sync and wgmma share per warp). Keys >= S, causal keys
//   past the row: -inf. Each row's exact max and sum come from quad
//   shuffles, no online rescaling: p = exp2((s scale - m) log2(e)), one
//   MUFU exp2 a score on the plain version's argument rounded as it
//   rounds it (m the max of the scaled scores), and P = p (1 / l), one
//   reciprocal a row and the quotient refined by two FMAs (no divide), as
//   attn_fwd_sm90.cuh's two-pass softmax forms it: its note has why the
//   folded exp2(s c - m c) rounded P the other way too often for the
//   bounds. P is rounded to bf16 in registers (the register A operand of
//   P V). Stats mode writes m and l, the recompute backward's statistics.
// - Each element read once: q, k and v of the head come in as TMA boxes of
//   the packed rows (the [B, H, S, D] views of fused_mha.cu's qkv, S-major
//   storage too), rows past S as zeros. Blocks are persistent, as many as
//   fit the SMs, and walk the (batch, head) pairs with a 2-stage ring: the
//   next head's loads fly while this head computes.
// - Stores through shared memory: O goes back into the head's Q slot and
//   leaves in 16-byte stores of 128-byte rows; P's [S, S] tile, contiguous
//   in [B, H, S, S], is staged whole (masked pairs 0) at the span's own
//   alignment and written with 16-byte stores, only the span's unaligned
//   ends narrower.
// - Products: at S <= 64 wgmma (Q K^T with both operands from shared
//   memory, P V with P from registers; one warpgroup, one m64 tile), past
//   it mma.sync m16n8k16 (a warp per 16 rows, rows padded to 16: 80 at
//   S = 77) on the same swizzled tiles by ldmatrix. wgmma past S = 64 pads
//   the rows to two m64 tiles (128 at S = 77) and lost the A/B to mma.sync
//   (PERF.md §6), so it was not kept. Everything around the products is
//   the same code.
// - Modes (plain, with P, with stats) are one template switch, so the three
//   give the same output bits.
//
// MCT_FWD_TILE_FAULT (0 unless set; the define attn_fwd_sm90.cuh reads)
// builds a wrong forward for the checks that must catch one: each row's
// last unmasked key (the diagonal when causal, key S - 1 otherwise) left
// out, in every row (1) or in the late half of the rows (2).
#pragma once

#include <math_constants.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "sm90.cuh"

#ifndef MCT_FWD_TILE_FAULT
#define MCT_FWD_TILE_FAULT 0
#endif

namespace mct {
namespace attn_short {

using namespace mct::sm90;
using mct::tc::ldmatrix_x4;
using mct::tc::ldmatrix_x4_trans;
using mct::tc::mma;
using mct::tc::quad_max;
using mct::tc::quad_sum;

constexpr int kD = 64;      // a row of q, k or v: one 128-byte swizzled panel
constexpr int kMaxS = 128;  // one key tile
constexpr int kStages = 2;  // heads in the ring
constexpr int kPlain = 0, kProbs = 1, kStats = 2;  // the modes

// An instantiation's block: kN keys (S rounded up: 64, 80 or 128) and as
// many query rows, a warp per 16 rows; the products on wgmma at kN = 64
// (one m64 tile), on mma.sync past it.
template <int kN>
struct Geo {
  static_assert(kN == 64 || kN == 80 || kN == 128, "kN = 64, 80 or 128");
  static constexpr bool kWg = kN == 64;
  static constexpr int kThreads = 2 * kN;  // a warp per 16 rows
  static constexpr int kTile = kN * kRowBytes;  // q's, k's or v's slot
  static constexpr int kStage = 3 * kTile;
  static constexpr int kBars = 64;
  // P's [S][S] bf16 tile shifted by up to 14 bytes to its span's alignment
  static constexpr int kPBytes = kN * kN * 2 + 16;
  static constexpr int smem(int mode) {
    return 1024 + kStages * kStage + kBars + (mode == kProbs ? kPBytes : 0);
  }
};

struct Maps {
  CUtensorMap q, k, v;  // view_map of each: boxes of kN rows
};

struct Args {
  bf16* o;  // row `row` of head (b, h): o + b ob + row os + h kD
  long ob, os;
  bf16* probs;      // P [B, H, S, S], or null
  float* row_max;   // [B, H, S] each, or null
  float* row_sum;
  int B, H, S, causal;
  int perm;  // the map dimensions of (s, h, b), the same in the three maps
  float scale;
};

// Whether MCT_FWD_TILE_FAULT leaves key `key` out of row `row`.
__device__ __forceinline__ bool fault_key(int row, int key, int S,
                                          int causal) {
#if MCT_FWD_TILE_FAULT
  const int last = causal ? min(row, S - 1) : S - 1;
  return key == last && (MCT_FWD_TILE_FAULT == 1 || row >= S / 2);
#else
  return false;
#endif
}

// The m16n8 accumulator chunk j of a flat accumulator (elements 4 j ..).
template <int N>
__device__ __forceinline__ auto chunk(float (&d)[N], int j) -> float (&)[4] {
  return *reinterpret_cast<float(*)[4]>(&d[4 * j]);
}

// S = Q K^T for the warp's 16 rows (wgmma: the warpgroup's 64): s[4 j + e]
// is row 16 w + lane / 4 + 8 (e >> 1), key 8 j + 2 (lane % 4) + (e & 1).
template <int kN>
__device__ __forceinline__ void scores(float (&s)[kN / 2],
                                       const unsigned char* q_s,
                                       const unsigned char* k_s, int warp,
                                       int lane) {
  if constexpr (Geo<kN>::kWg) {
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss<0, 0>(s, desc_k(q_s, kk), desc_k(k_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
  } else {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) {
      uint32_t a[4];
      const int row = 16 * warp + (lane & 15);
      ldmatrix_x4(a, reinterpret_cast<const bf16*>(
                         q_s + swz(row, 16 * kc + 8 * (lane >> 4))));
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        uint32_t r[4];
        const int key = 16 * np + (lane & 7) + 8 * (lane >> 4);
        ldmatrix_x4(r, reinterpret_cast<const bf16*>(
                           k_s + swz(key, 16 * kc + 8 * ((lane >> 3) & 1))));
        mma(chunk(s, 2 * np), a, r[0], r[1]);
        mma(chunk(s, 2 * np + 1), a, r[2], r[3]);
      }
    }
  }
}

// O (m16n8 chunks of 8 columns, 32 floats) = P V over the kN keys.
template <int kN>
__device__ __forceinline__ void pv(float (&o)[kD / 2],
                                   uint32_t (&pa)[kN / 16][4],
                                   const unsigned char* v_s, int lane) {
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  if constexpr (Geo<kN>::kWg) {
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_rs<1>(o, pa[kk], desc_mn(v_s, kk, kN * kRowBytes), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
  } else {
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int dc = 0; dc < kD / 16; ++dc) {
        uint32_t r[4];
        const int key = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4_trans(r, reinterpret_cast<const bf16*>(
                                 v_s + swz(key, 16 * dc + 8 * (lane >> 4))));
        mma(chunk(o, 2 * dc), pa[kk], r[0], r[1]);
        mma(chunk(o, 2 * dc + 1), pa[kk], r[2], r[3]);
      }
  }
}

template <int kN, int kMode>
__global__ void __launch_bounds__(Geo<kN>::kThreads)
fwd(const __grid_constant__ Maps maps, const Args g) {
  using G = Geo<kN>;
  extern __shared__ __align__(1024) unsigned char short_smem[];
  unsigned char* base = align_1024(short_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * G::kStage);
  unsigned char* p_s = base + kStages * G::kStage + G::kBars;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int heads = g.B * g.H, S = g.S;
  const int row_lo = 16 * warp + (lane >> 2);  // and row_lo + 8
  const bool idle = 16 * warp >= S;  // warp-uniform: no row of the warp

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // thread 0: head t's q, k and v into stage st
  auto load_head = [&](int t, int st) {
    const int b = t / g.H, h = t - b * g.H;
    unsigned char* q = base + st * G::kStage;
    mbar_expect_tx(full + st, G::kStage);
    load_view_rows(q, &maps.q, full + st, g.perm, 0, 0, h, b);
    load_view_rows(q + G::kTile, &maps.k, full + st, g.perm, 0, 0, h, b);
    load_view_rows(q + 2 * G::kTile, &maps.v, full + st, g.perm, 0, 0, h, b);
  };
  if (tid == 0)
    for (int i = 0; i < kStages; ++i)
      if (blockIdx.x + i * gridDim.x < heads)
        load_head(blockIdx.x + i * gridDim.x, i);

  int it = 0;
  for (int t = blockIdx.x; t < heads; t += gridDim.x, ++it) {
    const int st = it % kStages;
    unsigned char* q_s = base + st * G::kStage;
    const unsigned char* k_s = q_s + G::kTile;
    const unsigned char* v_s = k_s + G::kTile;
    const int b = t / g.H, h = t - b * g.H;
    mbar_wait(full + st, (it / kStages) & 1);

    float s[kN / 2];
    scores<kN>(s, q_s, k_s, warp, lane);
    uint32_t pa[kN / 16][4];
    if (idle) {  // rows past S: P 0, so the block's product adds 0
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
    } else {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * (lane & 3) + (e & 1);
          const int row = row_lo + 8 * (e >> 1);
          const bool ok = key < S && (!g.causal || key <= row) &&
                          !fault_key(row, key, S, g.causal);
          if (!ok) s[4 * j + e] = -CUDART_INF_F;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
        }
      // m: the max of the scaled scores; p = exp2((s scale - m) log2(e)),
      // the plain version's argument rounded as it rounds it
      float m[2], m0[2], l[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = quad_max(mx[r]) * g.scale;
        m0[r] = m[r] == -CUDART_INF_F ? 0.f : m[r];
      }
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = __fmul_rn(s[4 * j + e], g.scale) - m0[e >> 1];
          const float p = exp2_approx(d * kLog2e);
          s[4 * j + e] = p;
          l[e >> 1] += p;
        }
      // P = p / l: the product with 1 / l, refined by two FMAs to the
      // correctly rounded quotient (no divide)
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        inv[r] = l[r] > 0.f ? __frcp_rn(l[r]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int r = (i & 3) >> 1;
        const float q = s[i] * inv[r];
        s[i] = fmaf(fmaf(-q, l[r], s[i]), inv[r], q);
      }
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = 4 * (2 * kk + (i >> 1)) + 2 * (i & 1);
          pa[kk][i] = pack_bf16(s[idx], s[idx + 1]);
        }
      if constexpr (kMode == kStats) {
        if ((lane & 3) == 0)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row_lo + 8 * r;
            if (row >= S) continue;
            const long i = (long)t * S + row;
            g.row_max[i] = m[r];
            g.row_sum[i] = l[r];
          }
      }
      if constexpr (kMode == kProbs) {
        // P as P V takes it, at the span's alignment: element (row, key)
        // at byte shift + 2 (row S + key)
        const int shift =
            (int)(reinterpret_cast<uintptr_t>(g.probs + (long)t * S * S) & 15);
        bf16* p_t = reinterpret_cast<bf16*>(p_s + shift);
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = row_lo + 8 * (i & 1);
            const int key = 16 * kk + 8 * (i >> 1) + 2 * (lane & 3);
            if (row >= S) continue;
            const bf16* v = reinterpret_cast<const bf16*>(&pa[kk][i]);
            if (key < S) p_t[row * S + key] = v[0];
            if (key + 1 < S) p_t[row * S + key + 1] = v[1];
          }
      }
    }
    float o[kD / 2];
    pv<kN>(o, pa, v_s, lane);
    __syncthreads();  // every product has read the stage's q, k and v

    // O into the head's Q slot (swizzled), then out in 16-byte stores
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(
            q_s + swz(row_lo + 8 * r, 8 * j + 2 * (lane & 3))) =
            pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
    __syncthreads();
    bf16* o_head = g.o + (long)b * g.ob + (long)h * kD;
    for (int i = tid; i < S * (kD / 8); i += G::kThreads) {
      const int r = i >> 3, ch = i & 7;
      *reinterpret_cast<uint4*>(o_head + (long)r * g.os + 8 * ch) =
          *reinterpret_cast<const uint4*>(q_s + swz(r, 8 * ch));
    }
    if constexpr (kMode == kProbs) {
      // the span [t S^2, (t + 1) S^2) of P: 2-byte stores up to its first
      // 16-byte boundary and past its last, 16-byte ones between
      bf16* dst = g.probs + (long)t * S * S;
      const int n = S * S;
      const int shift = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
      const int head = shift ? min(n, (16 - shift) >> 1) : 0;
      const int body = (n - head) >> 3;  // 16-byte chunks
      const bf16* src = reinterpret_cast<const bf16*>(p_s + shift);
      for (int i = tid; i < body; i += G::kThreads)
        reinterpret_cast<uint4*>(dst + head)[i] =
            reinterpret_cast<const uint4*>(src + head)[i];
      for (int i = tid; i < head; i += G::kThreads) dst[i] = src[i];
      for (int i = head + 8 * body + tid; i < n; i += G::kThreads)
        dst[i] = src[i];
    }
    fence_async_smem();  // the generic accesses before the stage's next TMA
    __syncthreads();
    const int next = t + kStages * gridDim.x;
    if (tid == 0 && next < heads) load_head(next, st);
  }
}

inline int keys_for(int S) { return S <= 64 ? 64 : S <= 80 ? 80 : 128; }

// The SMs of the current device and the blocks of `kernel` one can hold.
template <typename K>
int grid_cap(K* kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// static: a function-local static of a function with external linkage is
// one object across every library that includes this header (the checks
// load a fault build beside the right one), so the cap stays per library
template <int kN, int kMode>
static cudaError_t launch_as(const Maps& maps, const Args& a,
                             cudaStream_t st) {
  using G = Geo<kN>;
  constexpr int kSmem = G::smem(kMode);
  const cudaError_t e = cudaFuncSetAttribute(
      fwd<kN, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  static const int cap = grid_cap(fwd<kN, kMode>, G::kThreads, kSmem);
  if (cap == 0) return cudaErrorInvalidConfiguration;
  const int grid = min(a.B * a.H, cap);
  fwd<kN, kMode><<<grid, G::kThreads, kSmem, st>>>(maps, a);
  return cudaGetLastError();
}

template <int kN>
cudaError_t launch_n(const void* q, const void* k, const void* v, long long sb,
                     long long ss, const Args& a, cudaStream_t st) {
  Maps maps;
  int perm = 0;
  // q, k and v as [B, H, S, D] views of the packed rows (head stride D)
  if (!view_map(&maps.q, perm, q, sb, kD, ss, a.B, a.H, a.S, kD, kN) ||
      !view_map(&maps.k, perm, k, sb, kD, ss, a.B, a.H, a.S, kD, kN) ||
      !view_map(&maps.v, perm, v, sb, kD, ss, a.B, a.H, a.S, kD, kN))
    return cudaErrorInvalidValue;
  Args args = a;
  args.perm = perm;
  if (a.probs != nullptr) return launch_as<kN, kProbs>(maps, args, st);
  if (a.row_max != nullptr) return launch_as<kN, kStats>(maps, args, st);
  return launch_as<kN, kPlain>(maps, args, st);
}

// The forward of qkv [B, S, 3 H 64] bf16, 1 <= S <= kMaxS (batch and
// sequence strides sb, ss: the `aligned` operands of attn_fwd_sm90.cuh);
// a.probs or a.row_max (with a.row_sum) pick the mode.
inline cudaError_t launch(const bf16* qkv, long long sb, long long ss,
                          const Args& a, cudaStream_t st) {
  if (a.S < 1 || a.S > kMaxS) return cudaErrorInvalidValue;
  const long long hd = (long long)a.H * kD;
  const bf16 *q = qkv, *k = qkv + hd, *v = qkv + 2 * hd;
  switch (keys_for(a.S)) {
    case 64:
      return launch_n<64>(q, k, v, sb, ss, a, st);
    case 80:
      return launch_n<80>(q, k, v, sb, ss, a, st);
    default:
      return launch_n<128>(q, k, v, sb, ss, a, st);
  }
}

}  // namespace attn_short
}  // namespace mct
