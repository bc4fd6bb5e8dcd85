// The bf16 attention forward on Hopper (sm_90a), one mainloop for two
// kernels: the flash forward (flash_attention.cu; online softmax, lse) and
// the fused-MHA forward with row statistics (fused_mha.cu; two passes, the
// normalised P), each with its dropout twin.
//
// Replaces, at D = 64 and 128 (both kernels) and D = 80 (the fused forward:
// ViT-H/14's vision tower), what the mma.sync forwards of those files ran
// for the TPU kernels megatron_clip_tpu/ops/pallas/flash_attention.py::
// _fwd_kernel (call :135, with _drop_keep :31) and ops/pallas/fused_mha.py::
// _fwd_kernel (call :289) and _fwd_kernel_dropout (call :491).
//
// Block. One block per (128 queries, head, batch), 384 threads: warpgroup 0
// is the producer, whose first thread issues every TMA load and whose
// registers setmaxnreg hands to the two consumer warpgroups (24 / 240 a
// thread); each consumer takes 64 query rows. Causal grids launch each
// head's query tiles in descending order, so the diagonal's longest blocks
// run first and the tail is short ones.
//
// Loads. Q is loaded once by TMA into 128-byte swizzled panels ([128 rows]
// [64 columns] each, D / 64 of them); at D = 80 a row is 160 bytes, no
// whole number of 128-byte rows, so a tile is one such panel and a [128]
// [16] panel under the 32-byte swizzle, each from a map of its own box
// (sm90.cuh's Tile, View). K and V tiles of 128 keys stream through rings
// under mbarriers (full: the producer's expect_tx; empty: one arrival from
// each of the 256 consumer threads once its products have read the slot),
// K and V on separate barriers so that S = Q K^T starts before V lands: 3
// stages at D = 64 and 80 (113 and 141 KB of shared memory), 2 at D = 128
// (160 KB). The maps read strided [B, H, S, D] views in place: the packed
// [B, S, 3 H D] projection's heads, the flash wrappers' head views, S-major
// storage; rows past S load as zeros. The fused forward keeps a head's
// whole K resident across its two passes where it fits beside the V ring
// (S <= 1024 at D = 64, S <= 896 at D = 80, S <= 512 at D = 128: up to 224
// KB), so pass 2 streams V alone; past that, K goes through its ring twice,
// the second time from L2.
//
// Per key tile, in each consumer warpgroup: S = Q K^T on wgmma m64n128k16,
// both operands K-major from shared memory; the softmax in registers, masks
// (key past Sk, causal key past the row: -inf) tested only in tiles that
// cross the warpgroup's diagonal or the keys' end; P rounded to bf16 in
// registers is the register A operand of O += P V (wgmma m64nDk16, V
// MN-major). At D = 80 S takes five k-steps, the last on the 16-column
// panels, and each k-step of P V is an n64 product on V's wide panel and an
// n16 on its tail, which hold O in the m64n80 layout between them (40 fp32
// a thread). The residuals keep their meaning: m the max of the scaled
// scores, l its softmax sum, lse = m + log l.
//
// - Online (flash): a running max and sum per row on exp2 with scale
//   log2(e) folded into one FMA, p = exp2(s c - m c), c = scale log2(e), m
//   the row's max raw score (m scale is the max the plain version takes of
//   the scaled scores, bit for bit); the accumulator rescaled by
//   exp2((m_old - m_new) c) at each tile; the unnormalised p (times the
//   dropout multiplier; l keeps the undropped sum) rounded to bf16 for P V;
//   out = acc / l with l = 0 taken as 1 (a reciprocal, then products), lse
//   = m scale + log l. Each thread keeps its own share of l, summed across
//   the row's quad once at the end.
// - Two-pass (fused MHA): pass 1 runs Q K^T alone and gathers m and l;
//   pass 2 recomputes S and forms the normalised P = exp(s scale - m) / l,
//   times the dropout multiplier, and only then rounds it to bf16 for P V,
//   where the TPU kernel rounds. Here the check holds P V to one bf16 ulp
//   of P, so P's fp32 value must stay within an ulp or two of the plain
//   version's: both passes form the plain version's argument, d = fl(s
//   scale) - m, then exp2(d log2(e)), and divide by l correctly rounded (a
//   reciprocal per row, the quotient refined by two FMAs). The online
//   path's exp2(s c - m c) with a reciprocal rounded P the other way often
//   enough that one output exceeded its bound (1.12 of it at B = 32, S =
//   512, H = 16, D = 128, causal, rate 0.1, on the H100); this arithmetic
//   stayed at 0.72 or less over four seeds there, as expf and a division
//   did, in 0.29 ms where those took 0.34. With a probs buffer the
//   kernel also writes P [B, H, S, S] as P V took it (masked pairs 0), its
//   rows a multiple of 8 elements apart (264 at S = 257: whole 16-byte
//   rows, which the saved-P backward reads by TMA): each tile's P goes
//   from the A fragments into a stage of the warpgroup's ([64 rows][128
//   keys], the 128-byte swizzle, so that the quads' 4-byte writes and the
//   16-byte reads are free of bank conflicts) and leaves it in 16-byte
//   stores along the rows, 16 threads a row. The stage costs 32 KB beside
//   the rings, so K stays resident only where both fit.
//
// The dropout mask: wgmma's m64nN accumulator gives each warp the m16n8
// pattern per 8 columns (rows r, r + 8; columns c, c + 1), so
// Dropout::quad draws the same Philox words from global (row, col) as the
// other kernels. The output leaves through shared memory (each warpgroup's
// Q rows, bf16, swizzled) in 16-byte stores along the output's strided
// rows.
//
// MCT_FWD_TILE_FAULT (0 unless set) builds a wrong forward for the checks
// that must catch one: the last key of every key tile left out (masked: its
// p is 0) in the whole sequence (1) or in tiles of its late half (2).
#pragma once

#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>

#include "philox.cuh"
#include "sm90.cuh"

#ifndef MCT_FWD_TILE_FAULT
#define MCT_FWD_TILE_FAULT 0
#endif

namespace mct {
namespace attn_fwd {

using namespace mct::sm90;
using mct::tc::quad_max;
using mct::tc::quad_sum;

constexpr int kM = 128;          // queries of a block: 64 per consumer
constexpr int kN = 128;          // keys of a tile
constexpr int kThreads = 384;    // the producer warpgroup and two consumers
constexpr int kConsumers = 256;  // arrivals that free a ring slot
constexpr int kMaxKSlots = 8;
constexpr int kBarBytes = 512;
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

// The two-pass forward's P stage: each consumer warpgroup's 64 rows of a
// key tile, as a Tile<kN, 64> (two swizzled panels of [64][64]).
using PStage = Tile<kN, 64>;
constexpr int kPStage = 2 * PStage::kBytes;

template <int D>
struct Layout {
  using T = Tile<D, 128>;  // Q, or a K or V tile
  static constexpr int kTile = T::kBytes;
  static constexpr int kStages = D == 128 ? 2 : 3;  // V's ring, and K's
  // the most key tiles the fused forward keeps resident beside the V ring
  static constexpr int kMaxResident = D == 64 ? 8 : D == 80 ? 7 : 4;
  // the rings (K's k_slots) and, where P is written, the P stage
  static constexpr int smem(int k_slots, bool probs = false) {
    return 1024 + kTile + (k_slots + kStages) * kTile + kBarBytes +
           (probs ? kPStage : 0);
  }
  static_assert(smem(kMaxResident) <= kMaxSmem, "resident K fits");
  static_assert(kMaxResident <= kMaxKSlots, "one barrier pair a slot");
};

struct Maps {
  View q, k, v;
};

struct Args {
  bf16* o;  // row `row` of head (b, h): o + b ob + h oh + row os
  long ob, oh, os;
  float* lse;      // online: [B, H, Sq]
  float* row_max;  // two-pass: [B, H, S] each, or null (not written)
  float* row_sum;
  bf16* probs;  // two-pass: P [B, H, S, S] as P V took it, or null
  long pp;      // P's row pitch in elements, a multiple of 8
  int H, Sq, Sk, causal;
  int k_slots, k_resident;  // K's ring, or (two-pass) every key tile
  // the map dimensions (1..3) of the sequence, head and batch axes of q, k,
  // v (view_map)
  int perm_q, perm_k, perm_v;
  float scale;
};

// A ring's next slot and the parity of its barriers' current phase.
struct Ring {
  int slot = 0, phase = 0;
  __device__ __forceinline__ void next(int slots) {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The tile fault of MCT_FWD_TILE_FAULT: whether the tile at k0 leaves out
// its last key.
__device__ __forceinline__ bool fault_tile(int k0, int Sk) {
#if MCT_FWD_TILE_FAULT == 1
  return true;
#elif MCT_FWD_TILE_FAULT == 2
  return k0 >= Sk / 2;
#else
  return false;
#endif
}

// S = Q K^T for the 64 rows of Q from row q0 and the tile's 128 keys.
template <int D>
__device__ __forceinline__ void scores(float (&s)[kN / 2],
                                       const unsigned char* q_s, int q0,
                                       const unsigned char* k_t) {
  fence_regs(s);
  wgmma_fence();
  wgmma_kd<D, kM, kN>(s, q_s, q0, k_t);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// Element 4 j + e of s: row row_lo + 8 (e >> 1), key k0 + 8 j + 2 (lane %
// 4) + (e & 1). Keys past Sk and (causal) past the row: -inf.
__device__ __forceinline__ void mask(float (&s)[kN / 2], int k0, int row_lo,
                                     int lane, int Sk, int causal) {
  const bool fault = fault_tile(k0, Sk);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
      const int row = row_lo + 8 * (e >> 1);
      bool ok = key < Sk && (!causal || key <= row);
      if (fault && key == k0 + kN - 1) ok = false;
      if (!ok) s[4 * j + e] = -CUDART_INF_F;
    }
}

// The quad-reduced max of each of the thread's two rows in s.
__device__ __forceinline__ void row_max(const float (&s)[kN / 2],
                                        float (&mx)[2]) {
  mx[0] = mx[1] = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
}

// p (times its dropout multiplier) rounded to bf16 pairs: the A fragments
// of k-step kk hold keys 16 kk .. 16 kk + 15 (accumulator chunks 2 kk and
// 2 kk + 1).
template <bool kDrop>
__device__ __forceinline__ void to_frags(uint32_t (&pa)[kN / 16][4],
                                         float (&p)[kN / 2],
                                         const Dropout& drop, StepHead bh,
                                         int row_lo, int k0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    if (kDrop)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float keep[4];
        drop.quad(keep, bh, row_lo, k0 + 16 * kk + 8 * c + 2 * (lane & 3));
#pragma unroll
        for (int e = 0; e < 4; ++e) p[4 * (2 * kk + c) + e] *= keep[e];
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = 4 * (2 * kk + (i >> 1)) + 2 * (i & 1);
      pa[kk][i] = pack_bf16(p[idx], p[idx + 1]);
    }
  }
}

template <int D, bool kTwoPass, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
fwd(const __grid_constant__ Maps maps, const Args g, Dropout drop) {
  using L = Layout<D>;
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  unsigned char* base = align_1024(fwd_smem);
  unsigned char* q_s = base;
  unsigned char* k_s = base + L::kTile;
  unsigned char* v_s = k_s + g.k_slots * L::kTile;
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(v_s + L::kStages * L::kTile);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kMaxKSlots;
  uint64_t* v_full = k_empty + kMaxKSlots;
  uint64_t* v_empty = v_full + L::kStages;
  unsigned char* p_stage = reinterpret_cast<unsigned char*>(q_full) +
                           kBarBytes;  // where P is written

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int qt = g.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kM;
  const int nk = g.causal ? min(g.Sk, q0 + kM) : g.Sk;
  const int nt = (nk + kN - 1) / kN;
  const bool resident = kTwoPass && g.k_resident;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kMaxKSlots; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(k_empty + i, kConsumers);
    }
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(v_full + i, 1);
      mbar_init(v_empty + i, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(q_full, L::kTile);
      load_tile<D, kM>(q_s, maps.q, q_full, g.perm_q, q0, h, b);
      // the consumers' order: pass 1's K tiles (two-pass), then each
      // tile's K and V
      int ks = 0, kr = 0, vs = 0, vr = 0;
      const int items = kTwoPass ? 2 * nt : nt;
      for (int it = 0; it < items; ++it) {
        const bool second = kTwoPass && it >= nt;
        const int k0 = (second ? it - nt : it) * kN;
        if (!(second && resident)) {
          if (kr > 0) mbar_wait(k_empty + ks, (kr - 1) & 1);
          mbar_expect_tx(k_full + ks, L::kTile);
          load_tile<D, kN>(k_s + ks * L::kTile, maps.k, k_full + ks,
                           g.perm_k, k0, h, b);
          if (++ks == g.k_slots) {
            ks = 0;
            ++kr;
          }
        }
        if (!kTwoPass || second) {
          if (vr > 0) mbar_wait(v_empty + vs, (vr - 1) & 1);
          mbar_expect_tx(v_full + vs, L::kTile);
          load_tile<D, kN>(v_s + vs * L::kTile, maps.v, v_full + vs,
                           g.perm_v, k0, h, b);
          if (++vs == L::kStages) {
            vs = 0;
            ++vr;
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // the consumers: warpgroup c takes rows row0 .. row0 + 63; each thread
  // rows row_lo and row_lo + 8
  const int c = (tid >> 7) - 1, ct = tid & 127, lane = tid & 31;
  const int row0 = q0 + 64 * c;
  const bool idle = row0 >= g.Sq;  // warpgroup-uniform
  const int row_lo = row0 + 16 * (ct >> 5) + (lane >> 2);
  const long bh = (long)b * g.H + h;
  const StepHead dh = drop.step_head(bh);  // once, not a Philox call
  const float sl2 = g.scale * kLog2e;
  // warpgroup-uniform: the tile at k0 crosses the keys' end or the
  // warpgroup's diagonal
  auto masked = [&](int k0) {
    return k0 + kN > g.Sk || (g.causal && k0 + kN - 1 > row0) ||
           fault_tile(k0, g.Sk);
  };
  // the K ring's slot to wait on next and to free next (a resident K
  // waits in pass 1 only and frees nothing), and the V ring's
  Ring kw, kf, vr;
  auto k_tile = [&](int t, const Ring& at) {
    return k_s + (resident ? t : at.slot) * L::kTile;
  };
  auto k_wait = [&] {
    mbar_wait(k_full + kw.slot, kw.phase);
    kw.next(g.k_slots);
  };
  auto k_free = [&] {
    mbar_arrive(k_empty + kf.slot);
    kf.next(g.k_slots);
  };
  // m: each row's max score (online: raw; two-pass: scaled); l: its
  // softmax sum (online: this thread's share)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  if (idle) {  // no rows: only the barriers' arrivals
    for (int t = 0; t < (kTwoPass ? 2 * nt : nt); ++t) {
      const bool second = kTwoPass && t >= nt;
      if (!(second && resident)) {
        k_wait();
        if (!resident) k_free();
      }
      if (!kTwoPass || second) {
        mbar_wait(v_full + vr.slot, vr.phase);
        mbar_arrive(v_empty + vr.slot);
        vr.next(L::kStages);
      }
    }
    return;
  }

  if constexpr (kTwoPass) {  // pass 1: m and l of the scaled scores
    for (int t = 0; t < nt; ++t) {
      const int k0 = t * kN;
      const unsigned char* k_t = k_tile(t, kw);
      k_wait();
      float s[kN / 2];
      scores<D>(s, q_s, 64 * c, k_t);
      if (!resident) k_free();
      if (masked(k0)) mask(s, k0, row_lo, lane, g.Sk, g.causal);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) s[i] *= g.scale;
      float mx[2];
      row_max(s, mx);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], mx[r]);
        const float base = mn == -CUDART_INF_F ? 0.f : mn;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
          sum += exp2_approx((s[4 * j + 2 * r] - base) * kLog2e) +
                 exp2_approx((s[4 * j + 2 * r + 1] - base) * kLog2e);
        l[r] = l[r] * exp2_approx((m[r] - base) * kLog2e) + sum;
        m[r] = mn;
      }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
  }
  // two-pass: 1 / l, correctly rounded, for the division's refinement
  const float inv_l[2] = {kTwoPass ? __frcp_rn(l[0]) : 0.f,
                          kTwoPass ? __frcp_rn(l[1]) : 0.f};

  // The tile's scores s become its p (two-pass: normalised); corr: the
  // online accumulator's rescale factors.
  auto softmax = [&](float (&s)[kN / 2], int k0, float (&corr)[2]) {
    if (masked(k0)) mask(s, k0, row_lo, lane, g.Sk, g.causal);
    if constexpr (kTwoPass) {  // P = exp(s scale - m) / l
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float x =
              exp2_approx((s[4 * j + e] * g.scale - m[r]) * kLog2e);
          const float q = x * inv_l[r];
          s[4 * j + e] = fmaf(fmaf(-q, l[r], x), inv_l[r], q);
        }
    } else {
      float mx[2];
      row_max(s, mx);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], mx[r]);
        const float ms = mn == -CUDART_INF_F ? 0.f : mn * sl2;
        corr[r] = exp2_approx(fmaf(m[r], sl2, -ms));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], sl2, -ms));
            sum += s[4 * j + e];
          }
        l[r] = l[r] * corr[r] + sum;
        m[r] = mn;
      }
    }
  };

  // Tile 0's S, p and P; then per tile t: S(t) = Q K(t)^T and O +=
  // P(t - 1) V(t - 1) issued together, tile t's softmax on the CUDA cores
  // while P V runs on the tensor cores, O rescaled and P(t) formed once
  // P V is done.
  float o[D / 2], s[kN / 2], corr[2];
  uint32_t pa[kN / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // P, where the two-pass forward without dropout is asked for it
  constexpr bool kProbs = kTwoPass && !kDrop;
  bf16* p_bh = kProbs && g.probs != nullptr ? g.probs + bh * g.Sq * g.pp
                                            : nullptr;
  unsigned char* p_w = p_stage + c * PStage::kBytes;  // the warpgroup's
  // P of the tile at k0 (times the dropout multipliers) into pa; with
  // probs, also its bf16 values there: through the warpgroup's stage into
  // 16-byte stores (a chunk of 8 keys from k0 + 8 ch; a chunk at the keys'
  // end holds masked keys, 0, in the row's padding)
  auto frags = [&](int k0) {
    to_frags<kDrop>(pa, s, drop, dh, row_lo, k0, lane);
    if (!kProbs || p_bh == nullptr) return;
    named_sync(1 + c, 128);  // the last tile's stores have read the stage
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint32_t*>(
            p_w + PStage::at(row_lo - row0 + 8 * (i & 1),
                             16 * kk + 8 * (i >> 1) + 2 * (lane & 3))) =
            pa[kk][i];
    named_sync(1 + c, 128);
    constexpr int kChunks = kN / 8;
#pragma unroll 4
    for (int i = ct; i < 64 * kChunks; i += 128) {
      const int r = i / kChunks, ch = i % kChunks;
      const int key = k0 + 8 * ch;
      if (row0 + r < g.Sq && key < g.Sk)
        *reinterpret_cast<uint4*>(p_bh + (long)(row0 + r) * g.pp + key) =
            *reinterpret_cast<const uint4*>(p_w + PStage::chunk(r, ch));
    }
  };
  {
    const unsigned char* k_t = k_tile(0, kw);
    if (!resident) k_wait();
    scores<D>(s, q_s, 64 * c, k_t);
    if (!resident) k_free();
    softmax(s, 0, corr);
    frags(0);
  }
  // O += P V from the V ring's next slot, committed, not waited for
  auto issue_pv = [&] {
    mbar_wait(v_full + vr.slot, vr.phase);
    const unsigned char* v_t = v_s + vr.slot * L::kTile;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_rs_nd<D, kN>(o, pa[kk], v_t, kk);
    wgmma_commit();
  };
  auto pv_done = [&] {
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(v_empty + vr.slot);
    vr.next(L::kStages);
  };
  for (int t = 1; t < nt; ++t) {
    const int k0 = t * kN;
    const unsigned char* k_t = k_tile(t, kw);
    if (!resident) k_wait();
    fence_regs(o);
    fence_regs(s);
    wgmma_fence();
    wgmma_kd<D, kM, kN>(s, q_s, 64 * c, k_t);
    wgmma_commit();
    issue_pv();
    wgmma_wait<1>();  // S(t), the older group
    fence_regs(s);
    if (!resident) k_free();
    softmax(s, k0, corr);
    pv_done();
    if constexpr (!kTwoPass)
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
    frags(k0);
  }
  fence_regs(o);
  wgmma_fence();
  issue_pv();
  pv_done();

  // the residuals, then O through the warpgroup's Q rows to 16-byte stores
  float scale_o[2] = {1.f, 1.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const long i = bh * g.Sq + row;
    if constexpr (kTwoPass) {
      if (g.row_max != nullptr && (lane & 3) == 0 && row < g.Sq) {
        g.row_max[i] = m[r];
        g.row_sum[i] = l[r];
      }
    } else {
      const float lr = quad_sum(l[r]);
      const float ls = lr == 0.f ? 1.f : lr;
      scale_o[r] = 1.f / ls;
      if ((lane & 3) == 0 && row < g.Sq)
        g.lse[i] = m[r] == -CUDART_INF_F ? -1e30f
                                         : m[r] * g.scale + logf(ls);
    }
  }
  if (kProbs && p_bh != nullptr) {  // keys past the block's last row: 0
    // (nk = q0 + kM there, a whole chunk)
    const int zc = (g.Sk - nk + 7) / 8;
    for (int i = ct; i < 64 * zc; i += 128) {
      const int row = row0 + i / zc;
      if (row < g.Sq)
        *reinterpret_cast<uint4*>(p_bh + (long)row * g.pp + nk +
                                  8 * (i % zc)) = make_uint4(0, 0, 0, 0);
    }
  }
  named_sync(1 + c, 128);  // every product of the warpgroup has read Q
  using T = typename L::T;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * c + 16 * (ct >> 5) + (lane >> 2) + 8 * r;
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(q_s + T::at(row, col)) =
          pack_bf16(o[4 * j + 2 * r] * scale_o[r],
                    o[4 * j + 2 * r + 1] * scale_o[r]);
    }
  named_sync(1 + c, 128);
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  bf16* o_head = g.o + (long)b * g.ob + (long)h * g.oh;
#pragma unroll 4
  for (int i = ct; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, ch = i % kChunks;
    if (row0 + r >= g.Sq) continue;
    const uint4 v =
        *reinterpret_cast<const uint4*>(q_s + T::chunk(64 * c + r, ch));
    *reinterpret_cast<uint4*>(o_head + (long)(row0 + r) * g.os + 8 * ch) = v;
  }
}

// The head dims each route's kernels are built for: the flash forward's
// (online), and the fused-MHA forward's (two-pass; 80: ViT-H/14).
inline bool flash_d(int D) { return D == 64 || D == 128; }
inline bool fused_d(int D) { return D == 64 || D == 80 || D == 128; }

// Whether the kernels can read and write these bf16 operands: every base
// 16-byte aligned and every stride a multiple of 8 elements (TMA's 16-byte
// rule; the output's 16-byte stores).
inline bool aligned(std::initializer_list<const void*> ptrs,
                    std::initializer_list<long long> strides) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (long long s : strides)
    if (s % 8 != 0) return false;
  return true;
}

// A [B, H, S, D] operand: its pointer and the element strides of its
// batch, head and sequence axes.
struct Operand {
  const void* p;
  long long b, h, s;
};

template <int D, bool kTwoPass, bool kDrop>
cudaError_t launch_as(const Maps& maps, const Args& a, int B,
                      const Dropout& drop, cudaStream_t st) {
  const int smem = Layout<D>::smem(a.k_slots, a.probs != nullptr);
  const cudaError_t e = cudaFuncSetAttribute(
      fwd<D, kTwoPass, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  fwd<D, kTwoPass, kDrop>
      <<<dim3((a.Sq + kM - 1) / kM, a.H, B), kThreads, smem, st>>>(maps, a,
                                                                   drop);
  return cudaGetLastError();
}

template <bool kTwoPass, int D>
cudaError_t launch_d(Operand q, Operand k, Operand v, Args a, int B,
                     const Dropout* drop, cudaStream_t st) {
  const int tiles = (a.Sk + kN - 1) / kN;
  a.k_resident = kTwoPass && tiles <= Layout<D>::kMaxResident &&
                 Layout<D>::smem(tiles, a.probs != nullptr) <= kMaxSmem;
  a.k_slots = a.k_resident ? tiles : Layout<D>::kStages;
  Maps maps;
  if (!view_maps(&maps.q, a.perm_q, q.p, q.b, q.h, q.s, B, a.H, a.Sq, D, kM) ||
      !view_maps(&maps.k, a.perm_k, k.p, k.b, k.h, k.s, B, a.H, a.Sk, D, kN) ||
      !view_maps(&maps.v, a.perm_v, v.p, v.b, v.h, v.s, B, a.H, a.Sk, D, kN))
    return cudaErrorInvalidValue;
  return drop ? launch_as<D, kTwoPass, true>(maps, a, B, *drop, st)
              : launch_as<D, kTwoPass, false>(maps, a, B, Dropout{}, st);
}

// The forward of `aligned` operands: the online softmax (flash: a.lse, D
// in flash_d) or the two-pass one (fused MHA: a.row_max, a.row_sum, D in
// fused_d).
template <bool kTwoPass>
cudaError_t launch(int D, Operand q, Operand k, Operand v, const Args& a,
                   int B, const Dropout* drop, cudaStream_t st) {
  if (D == 64) return launch_d<kTwoPass, 64>(q, k, v, a, B, drop, st);
  if (D == 128) return launch_d<kTwoPass, 128>(q, k, v, a, B, drop, st);
  if constexpr (kTwoPass)
    if (D == 80) return launch_d<kTwoPass, 80>(q, k, v, a, B, drop, st);
  return cudaErrorInvalidValue;
}

}  // namespace attn_fwd
}  // namespace mct
