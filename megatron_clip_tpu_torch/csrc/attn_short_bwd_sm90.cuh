// The bf16 fused-MHA backward at S <= 128, D = 64 on Hopper (sm_90a), from
// saved P or recomputing P: one pass, a whole head per block, persistent
// blocks.
//
// Replaces, at those shapes, what tc::bwd_dq / tc::bwd_dkdv and
// tc::bwd_dq_rc / tc::bwd_dkdv_rc (fused_mha.cu, mma.sync, two launches, a
// delta scratch) ran for the TPU kernels
// megatron_clip_tpu/ops/pallas/fused_mha.py::_bwd_kernel (its math in
// _bwd_head) and _bwd_kernel_recompute (call :323). Their paths: ViT-B/32's
// training, both towers with saved P (vision S = 50, text S = 77 causal),
// and the ViT-L/14 and ViT-H/14 text towers with the recompute backward
// (S = 77 causal).
//
// Arithmetic (fused_mha.cu's note, kept). Saved mode: P as saved in bf16;
// dV = P^T dO, dP = dO V^T in fp32, delta_i = sum_j dP_ij P_ij over every
// key of the row, dS = P (dP - delta) scale rounded to bf16, dQ = dS K and
// dK = dS^T Q in fp32, each output rounded once. Recompute mode: P formed
// in fp32 as the one-pass forward's stats mode forms it (attn_short_sm90.cuh)
// from the forward's m and l: p = exp2((s scale - m) log2(e)) and P = p / l
// as the product with 1 / l refined by two FMAs, so P is the forward's own;
// delta and dS take that fp32 P, dV takes bf16(P). Masked pairs, keys >= S
// and rows >= S have P = 0 in both modes (set, never read: the statistics
// past a head's S rows belong to the next head, and P's bytes past its span
// to the next head's P).
//
// What bounds it. A head moves 7 S D elements (q, k, v and dO in, dq, dk
// and dv out) plus S^2 of P (saved) or 8 S bytes of statistics for 8-10
// S^2 D FLOP: under 20 FLOP a byte, so device-memory bytes bound it (248 MB,
// 0.0741 ms at ViT-B/32's text tower, B = 384, on an H100's 3.35 TB/s). A
// head's products are a few microseconds; what costs is latency: loads that
// wait, launches, a delta round trip through device memory, stores that
// trickle. tc::'s pair paid all four: two launches, 64-row blocks reading K
// and V in both, delta through a [B H S] fp32 scratch, 4-byte stores from
// the fragments.
//
// Design.
// - One launch, one block a head: q, k, v and dO come in as TMA boxes of the
//   [B, H, S, D] views (the packed projection's columns, S-major storage
//   too; rows past S zero); the saved P as one 1-D bulk copy of the
//   16-byte-aligned bytes around its span ([B, H, S, S] contiguous: a head's
//   span starts on any 2-byte boundary, 154-byte rows at S = 77), indexed
//   from the span's offset. That copy stays inside P's own 16-byte
//   granules: where P's first or last byte is off a 16-byte boundary (so in
//   the first or last head alone), the span's bytes in that granule are
//   plain loads, and no byte outside P's tensor is read. Blocks are
//   persistent over the (batch, head) pairs; where two stages and two
//   blocks fit an SM's shared memory (S <= 64, and the recompute mode at
//   S <= 80) the next head's loads fly while this one computes, else other
//   blocks on the SM hide them.
// - Phase A, a warp per 16 query rows (the forward's layout): dP = dO V^T
//   and, recomputing, S = Q K^T into fp32 m16n8 accumulators; P from the
//   staged span or from S; each row's delta a quad-shuffle sum in registers
//   (no scratch, no second kernel); dS rounded to bf16 in registers, the A
//   operand of dQ = dS K. bf16(P) and bf16(dS) go to two padded [kN][kN + 8]
//   tiles of shared memory.
// - Phase B, a warp per 16 keys: dV = P^T dO and dK = dS^T Q, their A
//   fragments from those tiles by ldmatrix.trans, dO and Q as the swizzled
//   TMA tiles.
// - Stores through shared memory: dq, dk and dv go into the head's q, k and
//   v slots and leave in 16-byte stores of 128-byte rows into the packed
//   dqkv columns (dq at h D, dk at (H + h) D, dv at (2 H + h) D), every
//   element of rows < S. Each output element has one owner: no atomics, the
//   same bits every run and on every view.
// - Products: at S <= 64 wgmma (one warpgroup, one m64 tile: dP and S from
//   shared memory, dQ, dV and dK with A from registers), past it mma.sync
//   m16n8k16 (rows padded to 16: 80 at S = 77) on the same swizzled tiles;
//   the product helpers, and that split, are the forward's. The A/B behind
//   it, this kernel built each way and timed in one call (NVIDIA H100 80GB
//   HBM3, 700 W, ViT-B/32's towers from saved P): at S = 50 a tie, wgmma
//   0.0953 / 0.0958 ms against mma.sync 0.0957 / 0.0948; at S = 77
//   mma.sync 0.1014 / 0.1012 against wgmma's 128 padded rows 0.1542 /
//   0.1535 (0.0323 against 0.0496 at ViT-L/14's text tower).
// - Measured (phase 6 of chip_smoke.py, same card): 0.0958 / 0.1020 ms at
//   ViT-B/32's towers from saved P, 72% / 73% of the byte bound; 0.0325 /
//   0.0160 ms at the ViT-L/14 / ViT-H/14 text towers recomputing, 49%;
//   tc::'s pairs 0.2907 / 0.4379 and 0.1006 / 0.0564 in the same call.
//
// MCT_BWD_TILE_FAULT (0 unless set; the define attn_bwd_sm90.cuh reads)
// builds a wrong backward for the checks that must catch one: each query
// row's last unmasked key (the diagonal when causal, key S - 1 otherwise)
// left out of its delta and dS (so of dQ, and of dK through dS), and each
// key's last query (S - 1) left out of its dK and dV; in every row (1) or
// in the late half of the rows (2).
#pragma once

#include <stdint.h>

#include "attn_short_sm90.cuh"
#include "mma_tiles.cuh"
#include "sm90.cuh"

#ifndef MCT_BWD_TILE_FAULT
#define MCT_BWD_TILE_FAULT 0
#endif

namespace mct {
namespace attn_short_bwd {

using namespace mct::sm90;
using mct::attn_short::kD;
using mct::attn_short::keys_for;
using mct::attn_short::kMaxS;
using mct::attn_short::pv;
using mct::attn_short::scores;
using mct::tc::ldmatrix_x4_trans;
using mct::tc::quad_sum;

constexpr int kSmemPerSm = 233472;  // 228 KB, of which 1 KB a block is kept

// An instantiation's block: kN keys (S rounded up: 64, 80 or 128, as the
// forward's) and as many query rows, a warp per 16 rows; saved (P read) or
// recompute mode.
template <int kN, bool kSaved>
struct Geo {
  static_assert(kN == 64 || kN == 80 || kN == 128, "kN = 64, 80 or 128");
  static constexpr int kThreads = 2 * kN;
  static constexpr int kTile = kN * kRowBytes;  // q's, k's, v's or dO's slot
  // P's span with the 16-byte-aligned bytes around it
  static constexpr int kPSpan = kSaved ? kN * kN * 2 + 32 : 0;
  static constexpr int kStage = (4 * kTile + kPSpan + 1023) / 1024 * 1024;
  static constexpr int kPitch = kN + 8;  // a staged row: 16 bytes of padding
  static constexpr int kStaged = kN * kPitch * 2;
  static constexpr int kBars = 64;
  static constexpr int smem(int stages) {
    return 1024 + stages * kStage + kBars + 2 * kStaged;
  }
  // two stages where two blocks still fit an SM, else one
  static constexpr int kStages =
      2 * (smem(2) + 1024) <= kSmemPerSm ? 2 : 1;
  static constexpr int kSmem = smem(kStages);
};

struct Maps {
  CUtensorMap q, k, v, g;  // view_map of each: boxes of kN rows
};

struct Args {
  bf16* dqkv;  // row `row` of head (b, h): dqkv + b db + row ds, dq at
               // column h D, dk at (H + h) D, dv at (2 H + h) D
  long db, ds;
  const bf16* probs;      // saved mode: P [B, H, S, S]
  const float* row_max;   // recompute mode: [B, H, S] each
  const float* row_sum;
  int B, H, S, causal;
  int perm_q, perm_g;  // the map dimensions of (s, h, b): q, k, v; dO
  float scale;
};

// Whether MCT_BWD_TILE_FAULT leaves key `key` out of row `row`'s delta and
// dS (phase A).
__device__ __forceinline__ bool fault_key(int row, int key, int S,
                                          int causal) {
#if MCT_BWD_TILE_FAULT
  const int last = causal ? min(row, S - 1) : S - 1;
  return key == last && (MCT_BWD_TILE_FAULT == 1 || row >= S / 2);
#else
  return false;
#endif
}

// ... and query `row` out of key `key`'s dK and dV (phase B).
__device__ __forceinline__ bool fault_query(int row, int key, int S) {
#if MCT_BWD_TILE_FAULT
  return row == S - 1 && key < S &&
         (MCT_BWD_TILE_FAULT == 1 || key >= S / 2);
#else
  return false;
#endif
}

// `bytes` (a multiple of 16) from the 16-byte aligned global address src
// into shared memory at dst, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The A fragments of the transpose of a staged [kN][kPitch] tile T (rows
// queries, columns keys) for the warp's 16 keys: k-step kk holds T^T's
// keys 16 w .., queries 16 kk .. (ldmatrix.trans of T's 8 x 8 blocks).
template <int kN, int kPitch>
__device__ __forceinline__ void transposed(uint32_t (&a)[kN / 16][4],
                                           const bf16* t, int warp,
                                           int lane) {
  const int key = 16 * warp + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
    ldmatrix_x4_trans(
        a[kk], t + (16 * kk + (lane & 7) + 8 * (lane >> 4)) * kPitch + key);
}

template <int kN, bool kSaved>
__global__ void __launch_bounds__(Geo<kN, kSaved>::kThreads)
bwd(const __grid_constant__ Maps maps, const Args g) {
  using G = Geo<kN, kSaved>;
  constexpr int kStages = G::kStages, kPitch = G::kPitch;
  extern __shared__ __align__(1024) unsigned char short_bwd_smem[];
  unsigned char* base = align_1024(short_bwd_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * G::kStage);
  bf16* p_t = reinterpret_cast<bf16*>(base + kStages * G::kStage + G::kBars);
  bf16* ds_t = p_t + kN * kPitch;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int heads = g.B * g.H, S = g.S;
  const int row_lo = 16 * warp + (lane >> 2);  // and row_lo + 8

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // P's span of head t: its first byte's offset from the 16-byte boundary
  // below it, and that boundary
  auto span = [&](int t, int& shift) {
    const uintptr_t at =
        reinterpret_cast<uintptr_t>(g.probs + (long)t * S * S);
    shift = (int)(at & 15);
    return at - shift;
  };
  // thread 0: head t's q, k, v, dO (and P) into stage st
  auto load_head = [&](int t, int st) {
    const int b = t / g.H, h = t - b * g.H;
    unsigned char* q = base + st * G::kStage;
    uintptr_t at = 0, a0 = 0, a1 = 0;
    if constexpr (kSaved) {
      // the bulk copy: the aligned bytes around the span [lo, hi) that lie
      // in P's own granules, [a0, a1); the span's bytes outside them (in
      // P's first or last granule, where P's ends are not 16-byte aligned)
      // are plain loads, made visible to the waiters by the arrive below
      int shift;
      at = span(t, shift);
      const uintptr_t lo = at + shift;
      const uintptr_t hi = lo + 2 * (uintptr_t)S * S;
      const uintptr_t p0 = reinterpret_cast<uintptr_t>(g.probs);
      const uintptr_t p1 = p0 + 2 * (uintptr_t)heads * S * S;
      const uintptr_t up = (p0 + 15) & ~uintptr_t(15);
      const uintptr_t end = (hi + 15) & ~uintptr_t(15);
      a0 = at > up ? at : up;
      a1 = end < (p1 & ~uintptr_t(15)) ? end : p1 & ~uintptr_t(15);
      if (a1 <= a0) a0 = a1 = hi;
      auto plain = [&](uintptr_t x0, uintptr_t x1) {
        for (uintptr_t x = x0; x < x1; x += 2)
          *reinterpret_cast<uint16_t*>(q + 4 * G::kTile + (x - at)) =
              *reinterpret_cast<const uint16_t*>(x);
      };
      plain(lo, a0 < hi ? a0 : hi);
      plain(a1 > lo ? a1 : lo, hi);
    }
    mbar_expect_tx(full + st, 4 * G::kTile + (uint32_t)(a1 - a0));
    load_view_rows(q, &maps.q, full + st, g.perm_q, 0, 0, h, b);
    load_view_rows(q + G::kTile, &maps.k, full + st, g.perm_q, 0, 0, h, b);
    load_view_rows(q + 2 * G::kTile, &maps.v, full + st, g.perm_q, 0, 0, h,
                   b);
    load_view_rows(q + 3 * G::kTile, &maps.g, full + st, g.perm_g, 0, 0, h,
                   b);
    if (a1 > a0)
      bulk_load(q + 4 * G::kTile + (a0 - at),
                reinterpret_cast<const void*>(a0), (uint32_t)(a1 - a0),
                full + st);
  };
  if (tid == 0)
    for (int i = 0; i < kStages; ++i)
      if (blockIdx.x + i * gridDim.x < heads)
        load_head(blockIdx.x + i * gridDim.x, i);

  int it = 0;
  for (int t = blockIdx.x; t < heads; t += gridDim.x, ++it) {
    const int st = it % kStages;
    unsigned char* q_s = base + st * G::kStage;
    unsigned char* k_s = q_s + G::kTile;
    unsigned char* v_s = k_s + G::kTile;
    unsigned char* do_s = v_s + G::kTile;
    const int b = t / g.H, h = t - b * g.H;
    // recompute: the forward's m and l of this thread's rows, read before
    // the wait; rows past S never read theirs
    float m[2] = {0.f, 0.f}, l[2] = {1.f, 1.f};
    if constexpr (!kSaved)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row_lo + 8 * r < S) {
          m[r] = __ldg(g.row_max + (long)t * S + row_lo + 8 * r);
          l[r] = __ldg(g.row_sum + (long)t * S + row_lo + 8 * r);
        }
    mbar_wait(full + st, (it / kStages) & 1);

    // phase A: the warp's 16 query rows
    float dp[kN / 2], p[kN / 2];
    scores<kN>(dp, do_s, v_s, warp, lane);  // dP = dO V^T
    auto kept = [&](int row, int key) {
      return row < S && key < S && (!g.causal || key <= row);
    };
    if constexpr (kSaved) {
      int shift;
      span(t, shift);
      const bf16* pr = reinterpret_cast<const bf16*>(q_s + 4 * G::kTile +
                                                      shift);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * (lane & 3) + (e & 1);
          const int row = row_lo + 8 * (e >> 1);
          p[4 * j + e] =
              kept(row, key) ? __bfloat162float(pr[row * S + key]) : 0.f;
        }
    } else {
      scores<kN>(p, q_s, k_s, warp, lane);  // S = Q K^T
      // the forward's P: p = exp2((s scale - m) log2(e)), the quotient by l
      // refined to the correctly rounded one (a row's key 0 is kept, so m is
      // finite and l >= 1)
      const float inv[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, r = e >> 1;
          const int key = 8 * j + 2 * (lane & 3) + (e & 1);
          const float d = __fmul_rn(p[i], g.scale) - m[r];
          const float x = exp2_approx(d * kLog2e);
          const float q = x * inv[r];
          p[i] = kept(row_lo + 8 * r, key)
                     ? fmaf(fmaf(-q, l[r], x), inv[r], q)
                     : 0.f;
        }
    }
    // delta, then dS = P (dP - delta) scale rounded to bf16: dQ's A
    // fragments, k-step kk holding keys 16 kk ..
    float dl[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * (lane & 3) + (e & 1);
        const int row = row_lo + 8 * (e >> 1);
        dl[e >> 1] = fmaf(fault_key(row, key, S, g.causal) ? 0.f
                                                            : p[4 * j + e],
                          dp[4 * j + e], dl[e >> 1]);
      }
    dl[0] = quad_sum(dl[0]);
    dl[1] = quad_sum(dl[1]);
    uint32_t pa[kN / 16][4], dsa[kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = 4 * (2 * kk + (i >> 1)) + 2 * (i & 1), r = i & 1;
        const int row = row_lo + 8 * r;
        const int key = 16 * kk + 8 * (i >> 1) + 2 * (lane & 3);
        float ds[2], pk[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float pc = p[idx + c];
          ds[c] = fault_key(row, key + c, S, g.causal)
                      ? 0.f
                      : pc * (dp[idx + c] - dl[r]) * g.scale;
          pk[c] = pc;
        }
        dsa[kk][i] = pack_bf16(ds[0], ds[1]);
        // for phase B, whose fault leaves query S - 1 out
        const bool f0 = fault_query(row, key, S);
        const bool f1 = fault_query(row, key + 1, S);
        pa[kk][i] = pack_bf16(f0 ? 0.f : pk[0], f1 ? 0.f : pk[1]);
        const uint32_t dsb = f0 || f1 ? pack_bf16(f0 ? 0.f : ds[0],
                                                  f1 ? 0.f : ds[1])
                                      : dsa[kk][i];
        *reinterpret_cast<uint32_t*>(p_t + row * kPitch + key) = pa[kk][i];
        *reinterpret_cast<uint32_t*>(ds_t + row * kPitch + key) = dsb;
      }
    float dq[kD / 2];
    pv<kN>(dq, dsa, k_s, lane);  // dQ = dS K
    __syncthreads();  // the staged tiles whole; k and v read for good

    // phase B: the warp's 16 keys
    float dv[kD / 2], dk[kD / 2];
    transposed<kN, kPitch>(pa, p_t, warp, lane);
    pv<kN>(dv, pa, do_s, lane);  // dV = P^T dO
    transposed<kN, kPitch>(dsa, ds_t, warp, lane);
    pv<kN>(dk, dsa, q_s, lane);  // dK = dS^T Q
    // dK and dV into the k and v slots (swizzled), dQ into q's once every
    // product has read it
    auto put = [&](unsigned char* slot, const float (&x)[kD / 2]) {
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(
              slot + swz(row_lo + 8 * r, 8 * j + 2 * (lane & 3))) =
              pack_bf16(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
    };
    put(k_s, dk);
    put(v_s, dv);
    __syncthreads();
    put(q_s, dq);
    __syncthreads();
    bf16* dst = g.dqkv + (long)b * g.db + (long)h * kD;
    const long part = (long)g.H * kD;  // dq -> dk -> dv columns
    for (int i = tid; i < 3 * S * (kD / 8); i += G::kThreads) {
      const int w = i / (S * (kD / 8)), rest = i - w * S * (kD / 8);
      const int r = rest >> 3, ch = rest & 7;
      *reinterpret_cast<uint4*>(dst + w * part + (long)r * g.ds + 8 * ch) =
          *reinterpret_cast<const uint4*>(q_s + w * G::kTile + swz(r, 8 * ch));
    }
    fence_async_smem();  // the generic accesses before the stage's next TMA
    __syncthreads();
    const int next = t + kStages * gridDim.x;
    if (tid == 0 && next < heads) load_head(next, st);
  }
}

// static: a function-local static of a function with external linkage is
// one object across every library that includes this header
template <int kN, bool kSaved>
static cudaError_t launch_as(const Maps& maps, const Args& a,
                             cudaStream_t st) {
  using G = Geo<kN, kSaved>;
  const cudaError_t e = cudaFuncSetAttribute(
      bwd<kN, kSaved>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (e != cudaSuccess) return e;
  static const int cap =
      attn_short::grid_cap(bwd<kN, kSaved>, G::kThreads, G::kSmem);
  if (cap == 0) return cudaErrorInvalidConfiguration;
  bwd<kN, kSaved><<<min(a.B * a.H, cap), G::kThreads, G::kSmem, st>>>(maps,
                                                                       a);
  return cudaGetLastError();
}

template <int kN>
cudaError_t launch_n(const bf16* qkv, long long sb, long long ss,
                     const bf16* dout, long long gb, long long gs,
                     const Args& a, cudaStream_t st) {
  Maps maps;
  Args args = a;
  const long long hd = (long long)a.H * kD;
  // q, k, v and dO as [B, H, S, D] views of the packed rows (head stride D)
  if (!view_map(&maps.q, args.perm_q, qkv, sb, kD, ss, a.B, a.H, a.S, kD,
                kN) ||
      !view_map(&maps.k, args.perm_q, qkv + hd, sb, kD, ss, a.B, a.H, a.S,
                kD, kN) ||
      !view_map(&maps.v, args.perm_q, qkv + 2 * hd, sb, kD, ss, a.B, a.H,
                a.S, kD, kN) ||
      !view_map(&maps.g, args.perm_g, dout, gb, kD, gs, a.B, a.H, a.S, kD,
                kN))
    return cudaErrorInvalidValue;
  return a.probs != nullptr ? launch_as<kN, true>(maps, args, st)
                            : launch_as<kN, false>(maps, args, st);
}

// The backward of qkv [B, S, 3 H 64] bf16 and dO [B, S, H 64], 1 <= S <=
// kMaxS (batch and sequence strides: the `aligned` operands of
// attn_fwd_sm90.cuh), into a.dqkv; a.probs (saved mode) or a.row_max and
// a.row_sum (recompute mode), exactly one of them.
inline cudaError_t launch(const bf16* qkv, long long sb, long long ss,
                          const bf16* dout, long long gb, long long gs,
                          const Args& a, cudaStream_t st) {
  if (a.S < 1 || a.S > kMaxS ||
      (a.probs == nullptr) == (a.row_max == nullptr || a.row_sum == nullptr))
    return cudaErrorInvalidValue;
  switch (keys_for(a.S)) {
    case 64:
      return launch_n<64>(qkv, sb, ss, dout, gb, gs, a, st);
    case 80:
      return launch_n<80>(qkv, sb, ss, dout, gb, gs, a, st);
    default:
      return launch_n<128>(qkv, sb, ss, dout, gb, gs, a, st);
  }
}

}  // namespace attn_short_bwd
}  // namespace mct
