// The bf16 backwards of the fused MHA on Hopper (sm_90a) past S = 128: the
// recompute backward with its dropout twin, and (kSaved) the backward from
// saved P. Each is part 1 (dQ and delta) and part 2 (dK and dV), a
// warp-specialised wgmma kernel fed by TMA under mbarriers.
//
// Replaces, at D = 64, 80 and 128 past S = 128, what fused_mha.cu's mma.sync
// kernels tc::bwd_dq_rc and tc::bwd_dkdv_rc (tc::bwd_dq and tc::bwd_dkdv
// for saved P) ran for the TPU kernels
// megatron_clip_tpu/ops/pallas/fused_mha.py::_bwd_kernel_recompute (call
// :323), _bwd_kernel_sm (call :238, an S-major view here),
// _bwd_kernel_dropout (call :518) and _bwd_kernel (:118, math in _bwd_head
// :101, call :323: saved P, the JAX default).
//
// Arithmetic (fused_mha.cu's note, kept): P = exp(s scale - m) / l from the
// forward's row statistics, formed as exp2(s scale log2(e) - m log2(e))
// times 1 / l: one FMA, the MUFU's exp2 and a product, with m log2(e) and
// the reciprocal of l taken once per row (part 1, in registers) or per
// query of a tile (part 2, in shared memory). delta_i = sum_j (dP M)_ij
// P_ij over every key of the row with fp32 P (not rowsum(dO O)); dS =
// P (dP M - delta) scale rounded to bf16; dV = bf16(P M)^T dO; dQ = dS K
// and dK = dS^T Q summed in fp32 and rounded once. Each output element has
// one owner: no float atomics, no TMA reduce-adds, the same bits every run
// and on every view.
//
// What bounds it. The function needs 5 products a kept (query, key) pair
// (10 D FLOP) against 14 D bytes a row (q, k, v and dO read, dq, dk and dv
// written): below ~400 keys a row (ViT-L/14's S = 257, the pipeline GPT's
// causal S = 512) device-memory bytes bound it. This design runs 9
// products a pair (part 1 forms S and dP twice, for delta and for dS,
// then dQ; part 2 S^T, dP^T, dV and dK) so that no sum crosses blocks;
// with three exponentials a pair, the masks and the Philox draws (dropout)
// on the CUDA cores in turn with the products, its time is theirs, not
// the bytes'.
//
// Part 1: one block per (128 queries, head, batch); the last query
// tiles, which see the most keys under the causal mask, launch first. A
// producer warpgroup (its first thread issues every TMA load; setmaxnreg
// hands its registers to the consumers, 24 / 240 a thread)
// loads Q and dO once as 128-byte swizzled panels (at D = 80, ViT-H/14's
// head, a 64-column panel and a 16-column one under the 32-byte swizzle:
// sm90.cuh's Tile) and streams the K and V tiles (128 keys at D = 64 and
// 80, 64 at D = 128, which keeps dQ, S and dP in the registers) through a
// 3-stage ring twice, once a pass (pass 1 keeps its dropout keep bits in
// shared memory for pass 2); `view_map` reads the packed projection's
// heads and S-major views in place. Each
// consumer warpgroup owns 64 rows: S = Q K^T and dP = dO V^T (wgmma
// m64nN, both operands K-major; at D = 80 five k-steps, the last on the
// 16-column panels), P and dP M in registers; pass 1 sums delta, pass 2
// forms dS in registers, as the scores are read, as the A operand of
// dQ += dS K (wgmma m64nD, K MN-major; at D = 80 an n64 product on K's
// wide panel and an n16 on its tail). Masks (keys past S,
// causal keys past the row) are tested only in the tiles that cross
// them; tiles wholly past a warpgroup's diagonal are not computed.
//
// Part 2: one block per (128 keys, head, batch), heaviest (the first
// keys, under the causal mask) first. K and V are loaded once; 64-query
// tiles of Q and dO stream through a 3-stage ring with m, l and delta of
// their rows (1-D boxes that start 16-byte aligned). Per tile, each
// warpgroup transforms its tile's statistics into (m log2(e), 1 / l,
// delta) per query in shared memory, then: S^T = K Q^T and dP^T = V dO^T
// (m64n64, K-major), P^T and dS^T in registers rounded into A fragments,
// dV += bf16(P^T M^T) dO and dK += bf16(dS^T) Q (m64nD, A from registers,
// Q and dO MN-major; at D = 80 n64 + n16 products, dK and dV 80 fp32 a
// thread between them, at 0 spills; at D = 128 P^T and dS^T go through
// swizzled panels of the warpgroup's, K-major, as their fragments beside
// dK and dV spilled). The Philox counter comes from the global (query,
// key) in both parts, drawn while S and dP (S^T and dP^T) run; part 2's
// accumulators hold scores transposed, so lanes l and l ^ 4 share their
// calls (philox.cuh bits_t2_pair).
//
// Blocks are 128 rows (two consumer warpgroups), at S = 257 too. At
// ViT-L/14's ragged S = 257 (B = 64, H = 16), where a third of the 128-row
// blocks hold one row, 64-row blocks of one consumer warpgroup took 0.674 /
// 0.674 ms against 0.496 / 0.504 for 128-row blocks (tools/ab_backward.py,
// NVIDIA H100 80GB HBM3, 700.00 W): twice the blocks, each streaming K and
// V twice, cost more than the rows they leave out, so they were not kept.
//
// Saved P (kSaved). The arithmetic of fused_mha.cu's note: dV = P^T dO
// with P as saved, dP = dO V^T, delta_i = sum_j dP_ij P_ij over every key
// of the row with the saved P, dS = P (dP - delta) scale rounded to bf16,
// dQ and dK summed in fp32 and rounded once, one owner per output element.
// The forward writes P [B, H, S, S] with rows a multiple of 8 elements
// apart (264 at S = 257), so that TMA reads it as a 3-D map (sm90.cuh's
// probs_map) in [rows][64 keys] boxes under the 128-byte swizzle; at
// S = 257 rows 514 bytes apart, TMA could not. 6 products a pair against
// the recompute's 9 (part 1 dP twice and dQ; part 2 dP^T, dV and dK), no
// exponentials, no Q in part 1 and no K in part 2; P is read from device
// memory by both parts. Part 1's stage holds a K tile (pass 2 only), a V
// tile and the block's [128 rows][kN keys] of P; each thread reads P in
// its dP accumulators' layout as 4-byte pairs from the swizzled panels
// (the quads' rows fall on distinct 16-byte chunks: no bank conflict); the
// ring is 2 deep at D = 80, where 3 stages would not fit. Where a block's
// key tiles fill the ring exactly (S = 257 at D = 64) pass 2 finds each
// tile's P where pass 1 left it and loads none (0.4349 -> 0.4200 ms at
// ViT-L/14's vision tower, tools/ab_backward.py --rows saved, NVIDIA H100
// 80GB HBM3, 700 W). Up to S = kPersistMaxS (the CLIP vision towers'
// S = 257) part 1 runs one persistent block an SM over its (head, batch,
// 128 rows) items, dO in two buffers and the ring running on across items
// (part 1 203 -> 187 us there); past it (a GPT's saved-P backward at
// S = 512 to 1024 without attention dropout, which keeps the grid of one
// block an item) that lost (505 against 432 us at S = 512, D = 64), and so
// did part 2
// (217 -> 227 us at S = 257), which keeps a block an item; its ring runs
// 6 stages deep at D = 64 and 5 at D = 80 in the room K leaves (218 -> 211
// us). The time follows the tiles more than the rows: S = 257's 1-row
// block and 1-key tile cost half again S = 256's time (0.4069 against
// 0.2729 ms at B = 64, H = 16, D = 64), and splitting part 2's 1-key
// block's query tiles over both warpgroups changed nothing (PERF.md
// section 6). Part 2's stage holds
// Q, dO, delta and P's [64 queries][128 keys] as two panels, one a
// warpgroup: dV += P^T dO runs with dP^T = V dO^T in one group, A the
// panel read MN-major by its descriptor (no register copy of P^T); dS^T
// reads P^T in the accumulators' layout as 2-byte loads (a key's queries
// are a column there). P is 0 on masked pairs and TMA fills past S with
// 0, so no mask is tested; causal blocks still skip their empty tiles.
//
// MCT_BWD_TILE_FAULT (0 unless set) builds a wrong backward for the checks
// that must catch one: part 1 leaves the last key of every key tile out of
// dQ and delta, part 2 the last query of every query tile out of dK and
// dV (saved P: that query's row of the stage's P is zeroed), in the whole
// sequence (1) or in the tiles of its late half (2).
#pragma once

#include <stdint.h>

#include <algorithm>

#include "attn_fwd_sm90.cuh"
#include "philox.cuh"
#include "sm90.cuh"

#ifndef MCT_BWD_TILE_FAULT
#define MCT_BWD_TILE_FAULT 0
#endif

namespace mct {
namespace attn_bwd {

using namespace mct::sm90;
using mct::attn_fwd::Operand;
using mct::attn_fwd::Ring;
using mct::tc::quad_sum;

constexpr int kProducer = 128;  // the producer warpgroup's threads
constexpr int kStages = 3;      // the rings' depth (but DkvTile::kDepth)
constexpr int kMaxS = 1024;     // the fused route's longest sequence
constexpr int kGroups = 2;      // consumer warpgroups, 64 rows each
// saved P's part 1 runs persistent blocks up to this S (3 key tiles a pass)
constexpr int kPersistMaxS = 384;

// The tile fault of MCT_BWD_TILE_FAULT: whether the tile at t0 leaves out
// its last row (key in part 1, query in part 2).
__device__ __forceinline__ bool fault_tile(int t0, int S) {
#if MCT_BWD_TILE_FAULT == 1
  return true;
#elif MCT_BWD_TILE_FAULT == 2
  return t0 >= S / 2;
#else
  return false;
#endif
}

struct Maps {
  View q, k, v, g;
  CUtensorMap stats, delta;
  CUtensorMap p;  // saved P (probs_map): boxes of 128 rows (part 1), 64
};

struct Args {
  bf16* dqkv;  // row `row` of batch b: dqkv + b db + row ds; dq at column
               // h D, dk at (H + h) D, dv at (2 H + h) D
  long db, ds;
  const float* row_max;  // [B H S] each (part 1)
  const float* row_sum;
  float* delta;  // [B H S]: part 1 writes it, part 2 reads it (maps.delta)
  long bhs;      // B H S: l's offset in maps.stats ([2, B H S]: m, then l)
  int B, H, S, causal;
  // the map dimensions (1..3) of the sequence, head and batch axes of q, k,
  // v and dO (view_map)
  int perm_q, perm_k, perm_v, perm_g;
  float scale;
};

// ---------------------------------------------------------------------------
// Part 1: dQ and delta

template <int D, bool kSaved>
struct DqTile {
  static constexpr int kRows = 64 * kGroups;      // queries of a block
  static constexpr int kN = D == 128 ? 64 : 128;  // keys of a K or V tile
  static constexpr int kQTile = Tile<D, kRows>::kBytes;
  static constexpr int kKTile = Tile<D, kN>::kBytes;
  // saved P: a stage's P tile, [kRows rows][kN keys] as kN / 64 swizzled
  // panels of [kRows][64]; its ring is 2 deep at D = 80 (3 would not fit)
  static constexpr int kPPanel = kRows * kRowBytes;
  static constexpr int kPTile = kSaved ? kN / 64 * kPPanel : 0;
  static constexpr int kRing = kSaved && D == 80 ? 2 : kStages;
  // recompute: Q and dO of the block's one item; saved P (persistent
  // blocks): no Q, and dO in two buffers, the next item's loading while
  // this item's tiles run
  static constexpr int kQ = 0;
  static constexpr int kDO = kSaved ? 0 : kQTile;
  static constexpr int kDOBufs = kSaved ? 2 : 1;
  static constexpr int kK = 2 * kQTile;
  static constexpr int kV = kK + kRing * kKTile;
  static constexpr int kP = kV + kRing * kKTile;
  // dropout: pass 1's keep bits for pass 2, kN / 2 bits a thread and tile
  // (S <= kMaxS: the fused route's gate), [kGroups][tile][word][128] words
  static constexpr int kMaxTiles = kMaxS / kN;
  static constexpr int kKeepWords = kN / 64;
  static constexpr int kKeep = kP + kRing * kPTile;
  static constexpr int kBars =
      kKeep + (kSaved ? 0 : kGroups * kMaxTiles * kKeepWords * 512);
  static constexpr int kSmem = 1024 + kBars + 2 * (kDOBufs + kRing) * 8;
  static constexpr int kThreads = kProducer + 128 * kGroups;
};

template <int D, bool kDrop, bool kSaved>
__global__ void __launch_bounds__(DqTile<D, kSaved>::kThreads, 1)
bwd_dq(const __grid_constant__ Maps maps, const Args g, Dropout drop) {
  using L = DqTile<D, kSaved>;
  constexpr int kN = L::kN, kRows = L::kRows, kRing = L::kRing;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  unsigned char* base = align_1024(dq_smem);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* q_empty = q_full + L::kDOBufs;
  uint64_t* full = q_empty + L::kDOBufs;
  uint64_t* empty = full + kRing;
  const int tid = threadIdx.x;
  // The block's items, (head, batch, 128 queries) with heads fastest and
  // (causal) the last query tiles, which see the most keys, first: saved
  // P's persistent blocks (S <= kPersistMaxS) take every gridDim.x-th
  // item, the ring running on from one item to the next; otherwise a
  // block takes the one item of its (head, batch, query block) grid index.
  const bool persistent = kSaved && g.S <= kPersistMaxS;
  const int nqt = (g.S + kRows - 1) / kRows;
  const long items = (long)nqt * g.B * g.H;
  const long first =
      persistent ? (long)blockIdx.x
                 : ((long)blockIdx.z * g.B + blockIdx.y) * g.H + blockIdx.x;
  const long stride = persistent ? (long)gridDim.x : items;
  struct Item {
    int h, b, q0, nt;
    bool p_resident;
  };
  auto item_at = [&](long item) {
    Item w;
    w.h = (int)(item % g.H);
    w.b = (int)(item / g.H % g.B);
    const int z = (int)(item / ((long)g.H * g.B));
    w.q0 = (g.causal ? nqt - 1 - z : z) * kRows;
    const int nk = g.causal ? min(g.S, w.q0 + kRows) : g.S;
    w.nt = (nk + kN - 1) / kN;
    // saved P: where the item's key tiles fill the ring exactly (S = 257
    // at D = 64), pass 2's tile t lands in pass 1's stage of tile t, whose
    // P it reads there: pass 2 loads no P
    w.p_resident = kSaved && w.nt == kRing;
    return w;
  };

  if (tid == 0) {
    for (int i = 0; i < L::kDOBufs; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 128 * kGroups);
    }
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 128 * kGroups);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < kProducer) {
    setmaxnreg_dec<24>();
    if (tid == 0) {
      Ring r;
      long loads = 0;  // ring stages loaded, over every item
      int n = 0;       // items begun: dO's buffer and its barriers' phase
      for (long item = first; item < items; item += stride, ++n) {
        const Item w = item_at(item);
        const int h = w.h, b = w.b, q0 = w.q0, nt = w.nt;
        const int qb = n % L::kDOBufs;
        if (n >= L::kDOBufs)
          mbar_wait(q_empty + qb, (n / L::kDOBufs - 1) & 1);
        mbar_expect_tx(q_full + qb, (kSaved ? 1 : 2) * L::kQTile);
        if constexpr (!kSaved)
          load_tile<D, kRows>(base + L::kQ, maps.q, q_full, g.perm_q, q0, h,
                              b);
        load_tile<D, kRows>(base + L::kDO + qb * L::kQTile, maps.g,
                            q_full + qb, g.perm_g, q0, h, b);
        // every key tile twice: pass 1, then pass 2; saved P's pass 1
        // reads V and P, its pass 2 K, V and (unless resident) P
        for (int it = 0; it < 2 * nt; ++it, ++loads) {
          const int k0 = (it < nt ? it : it - nt) * kN;
          const bool with_k = !kSaved || it >= nt;
          const bool with_p = kSaved && !(w.p_resident && it >= nt);
          if (loads >= kRing) mbar_wait(empty + r.slot, r.phase ^ 1);
          mbar_expect_tx(full + r.slot, (with_k ? 2 : 1) * L::kKTile +
                                            (with_p ? L::kPTile : 0));
          if (with_k)
            load_tile<D, kN>(base + L::kK + r.slot * L::kKTile, maps.k,
                             full + r.slot, g.perm_k, k0, h, b);
          load_tile<D, kN>(base + L::kV + r.slot * L::kKTile, maps.v,
                           full + r.slot, g.perm_v, k0, h, b);
          if (with_p)
#pragma unroll
            for (int p = 0; p < kN / 64; ++p)
              tma_load_3d(base + L::kP + r.slot * L::kPTile +
                              p * L::kPPanel,
                          &maps.p, full + r.slot, k0 + 64 * p, q0,
                          b * g.H + h);
          r.next(kRing);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int c = (tid >> 7) - 1, ct = tid & 127, lane = tid & 31;
  const float sl2 = g.scale * kLog2e;
  float s[kN / 2], dp[kN / 2];
  // S = Q K^T (recompute) and dP = dO V^T of the stage's tile from the
  // item's dO, issued; finish() waits
  auto issue = [&](const unsigned char* do_t, const unsigned char* k_t,
                   const unsigned char* v_t) {
    if constexpr (!kSaved) fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    if constexpr (!kSaved)
      wgmma_kd<D, kRows, kN>(s, base + L::kQ, 64 * c, k_t);
    wgmma_kd<D, kRows, kN>(dp, do_t, 64 * c, v_t);
    wgmma_commit();
  };
  auto finish = [&] {
    wgmma_wait<0>();
    if constexpr (!kSaved) fence_regs(s);
    fence_regs(dp);
  };
  auto k_tile = [&](int slot) { return base + L::kK + slot * L::kKTile; };
  auto v_tile = [&](int slot) { return base + L::kV + slot * L::kKTile; };
  Ring r;
  int n = 0;
  for (long item = first; item < items; item += stride, ++n) {
    const Item w = item_at(item);
    const int h = w.h, b = w.b, q0 = w.q0, nt = w.nt;
    const int qb = n % L::kDOBufs;
    const unsigned char* do_t = base + L::kDO + qb * L::kQTile;
    // consumer warpgroup c owns rows row0 .. row0 + 63; each thread rows
    // row_lo and row_lo + 8
    const int row0 = q0 + 64 * c;
    const int row_lo = row0 + 16 * (ct >> 5) + (lane >> 2);
    const long bh = (long)b * g.H + h;
    const mct::StepHead dh = drop.step_head(bh);
    // (recompute) m log2(e) and 1 / l of the thread's rows; rows past S
    // take P = 0
    float mb[2], il[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      const bool ok = !kSaved && row < g.S;
      mb[r] = ok ? g.row_max[bh * g.S + row] * kLog2e : 0.f;
      il[r] = ok ? 1.f / g.row_sum[bh * g.S + row] : 0.f;
    }
    const bool idle = row0 >= g.S;  // warpgroup-uniform
    // warpgroup-uniform: the tile at k0 holds no key of the warpgroup's
    // rows
    auto skip = [&](int k0) { return idle || (g.causal && k0 > row0 + 63); };
    // warpgroup-uniform: the tile crosses the keys' end or the diagonal
    auto masked = [&](int k0) {
      return k0 + kN > g.S || (g.causal && k0 + kN - 1 > row0) ||
             fault_tile(k0, g.S);
    };
    // The dropout keep bits of tile t, bit 4 j + e of kb[j / 8] for element
    // 4 j + e: pass 1 draws them from Philox while the products run and
    // keeps them in shared memory for pass 2, which reads them back.
    uint32_t* keep_w = reinterpret_cast<uint32_t*>(base + L::kKeep) +
                       c * L::kMaxTiles * L::kKeepWords * 128 + ct;
    uint32_t kb[L::kKeepWords];
    auto keep_bits = [&](int t, bool second) {
      if constexpr (kDrop) {
        uint32_t* words = keep_w + t * L::kKeepWords * 128;
        if (second) {
#pragma unroll
          for (int w = 0; w < L::kKeepWords; ++w) kb[w] = words[w * 128];
          return;
        }
#pragma unroll
        for (int w = 0; w < L::kKeepWords; ++w) kb[w] = 0;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          float keep[4];
          drop.quad(keep, dh, row_lo, t * kN + 8 * j + 2 * (lane & 3));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            kb[j >> 3] |= (uint32_t)(keep[e] != 0.f) << (4 * (j & 7) + e);
        }
#pragma unroll
        for (int w = 0; w < L::kKeepWords; ++w) words[w * 128] = kb[w];
      }
    };
    // P of element i = 4 j + e (row row_lo + 8 (e >> 1), key k0 + 8 j +
    // 2 (lane % 4) + (e & 1)), masked pairs 0, and its dP M
    auto prob = [&](int i, int k0, bool msk, bool fault) {
      const int r = (i >> 1) & 1;
      float p = exp2_approx(fmaf(s[i], sl2, -mb[r])) * il[r];
      if (msk) {
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const bool ok = key < g.S && (!g.causal || key <= row_lo + 8 * r) &&
                        !(fault && key == k0 + kN - 1);
        if (!ok) p = 0.f;
      }
      return p;
    };
    auto keep_of = [&](int i) {
      if constexpr (kDrop)
        return (kb[i >> 5] >> (i & 31)) & 1 ? drop.mult : 0.f;
      else
        return 1.f;
    };
    // P of elements i and i + 1 (i even: two keys of one row): recomputed,
    // or read as one 4-byte word of the stage's swizzled P panels (saved;
    // P is 0 on masked pairs and TMA's fill past S, so no mask is tested)
    auto probs = [&](int i, int k0, bool msk, bool fault, int slot) {
      if constexpr (kSaved) {
        const int rl =
            64 * c + 16 * (ct >> 5) + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int kl = 8 * (i >> 2) + 2 * (lane & 3);
        float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            base + L::kP + slot * L::kPTile + (kl >> 6) * L::kPPanel +
            swz(rl, kl & 63)));
        if (fault && kl + 1 == kN - 1) p.y = 0.f;
        return p;
      } else {
        return make_float2(prob(i, k0, msk, fault),
                           prob(i + 1, k0, msk, fault));
      }
    };
    mbar_wait(q_full + qb, (n / L::kDOBufs) & 1);

    // pass 1: delta of rows row_lo and row_lo + 8
    float dl[2] = {0.f, 0.f};
    for (int t = 0; t < nt; ++t) {
      const int k0 = t * kN;
      mbar_wait(full + r.slot, r.phase);
      if (!skip(k0)) {
        issue(do_t, k_tile(r.slot), v_tile(r.slot));
        keep_bits(t, false);
        finish();
        if (!kSaved) mbar_arrive(empty + r.slot);  // saved: P is read below
        const bool msk = masked(k0), fault = fault_tile(k0, g.S);
#pragma unroll
        for (int i = 0; i < kN / 2; i += 2) {
          const float2 p = probs(i, k0, msk, fault, r.slot);
          float& d = dl[(i >> 1) & 1];
          d = fmaf(p.x, dp[i] * keep_of(i), d);
          d = fmaf(p.y, dp[i + 1] * keep_of(i + 1), d);
        }
        if (kSaved) mbar_arrive(empty + r.slot);
      } else {
        mbar_arrive(empty + r.slot);
      }
      r.next(kRing);
    }
    dl[0] = quad_sum(dl[0]);
    dl[1] = quad_sum(dl[1]);

    // pass 2: dQ += dS K, dS = P (dP M - delta) scale rounded to bf16 into
    // the A fragments of k-step kk (keys 16 kk ..: accumulator chunks 2 kk
    // and 2 kk + 1), each formed as its scores are read; a resident P is
    // in this stage's P slot since pass 1 (item_at)
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    for (int t = 0; t < nt; ++t) {
      const int k0 = t * kN;
      mbar_wait(full + r.slot, r.phase);
      if (!skip(k0)) {
        const unsigned char* k_t = k_tile(r.slot);
        issue(do_t, k_t, v_tile(r.slot));
        keep_bits(t, true);
        finish();
        const bool msk = masked(k0), fault = fault_tile(k0, g.S);
        uint32_t dsa[kN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 4 * (2 * kk + (q >> 1)) + 2 * (q & 1);
            const float d = dl[q & 1];
            const float2 p = probs(i, k0, msk, fault, r.slot);
            dsa[kk][q] =
                pack_bf16(p.x * (dp[i] * keep_of(i) - d) * g.scale,
                          p.y * (dp[i + 1] * keep_of(i + 1) - d) * g.scale);
          }
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          wgmma_rs_nd<D, kN>(dq, dsa[kk], k_t, kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(dsa);
      }
      mbar_arrive(empty + r.slot);
      r.next(kRing);
    }
    mbar_arrive(q_empty + qb);  // the item's products have read Q and dO
    if (idle) continue;

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row_lo + 8 * rr;
      if (row >= g.S) continue;
      if ((lane & 3) == 0) g.delta[bh * g.S + row] = dl[rr];
      bf16* dst = g.dqkv + (long)b * g.db + (long)row * g.ds + (long)h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * (lane & 3)) =
            pack_bf16(dq[4 * j + 2 * rr], dq[4 * j + 2 * rr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Part 2: dK and dV

template <int D, bool kSaved>
struct DkvTile {
  static constexpr int kKeys = 64 * kGroups;  // keys of a block
  static constexpr int kQ = 64;           // queries of a tile
  static constexpr int kKTile = Tile<D, kKeys>::kBytes;
  static constexpr int kQTile = Tile<D, kQ>::kBytes;
  // saved P: a stage's P tile, [kQ queries][kKeys keys] as two swizzled
  // panels of [kQ][64], one a warpgroup
  static constexpr int kPPanel = kQ * kRowBytes;
  static constexpr int kPTile = kSaved ? kGroups * kPPanel : 0;
  static constexpr int kStage = 2 * kQTile + kPTile;  // Q, dO, P
  // the ring's depth: saved P fills the shared memory that K leaves (6
  // stages at D = 64, 5 at D = 80); 3 otherwise
  static constexpr int kDepth = kSaved && D != 128 ? (D == 64 ? 6 : 5)
                                                   : kStages;
  // m, l and delta of a tile: kQ + 4 floats each (the box starts 16-byte
  // aligned, up to 3 floats before the tile), 384 bytes apart
  static constexpr int kRowBox = kQ + 4;
  static constexpr int kRowArea = 384;
  // At D = 128 the A operands of dK and dV, dS^T and P^T of each
  // warpgroup's [64 keys][64 queries], go through two swizzled panels of
  // shared memory: as register fragments beside dK, dV, S^T and dP^T they
  // spilled (with dropout's keep bits). At D = 64 and 80 they stay in
  // registers.
  static constexpr bool kSmemA = D == 128;
  static constexpr int kAPanels = kSaved ? 1 : 2;  // dS^T (and P^T)
  static constexpr int kK = 0;                     // K (recompute only)
  static constexpr int kV = kSaved ? 0 : kKTile;
  static constexpr int kRing = kV + kKTile;
  static constexpr int kA = kRing + kDepth * kStage;
  static constexpr int kRowsAt =
      kA + (kSmemA ? kGroups * kAPanels * 64 * kRowBytes : 0);
  // each warpgroup's (m log2(e), 1 / l, delta) per query, two buffers
  static constexpr int kTr = kRowsAt + kDepth * 3 * kRowArea;
  static constexpr int kBars = kTr + kGroups * 2 * kQ * 16;
  static constexpr int kSmem = 1024 + kBars + (1 + 2 * kDepth) * 8;
  static constexpr int kThreads = kProducer + 128 * kGroups;
  // per stage: Q, dO, P (saved) and m, l (recompute) and delta
  static constexpr int kTx = kStage + (kSaved ? 1 : 3) * kRowBox * 4;
};

template <int D, bool kDrop, bool kSaved>
__global__ void __launch_bounds__(DkvTile<D, kSaved>::kThreads, 1)
bwd_dkdv(const __grid_constant__ Maps maps, const Args g, Dropout drop) {
  using L = DkvTile<D, kSaved>;
  constexpr int kQ = L::kQ, kKeys = L::kKeys, kDepth = L::kDepth;
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  unsigned char* base = align_1024(dkv_smem);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kDepth;
  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * L::kKeys;
  const long bh = (long)b * g.H + h;
  const mct::StepHead dh = drop.step_head(bh);
  // causal: no query before the block's first key attends to its keys
  const int jt0 = g.causal ? k0 / kQ : 0;
  const int ntiles = (g.S + kQ - 1) / kQ - jt0;
  const long row_first = bh * g.S;  // the head's first row in m and delta

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < kDepth; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 128 * kGroups);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < kProducer) {
    setmaxnreg_dec<24>();
    if (tid == 0) {
      // saved P needs no K: its part 2 forms no S^T
      mbar_expect_tx(kv_full, (kSaved ? 1 : 2) * L::kKTile);
      if constexpr (!kSaved)
        load_tile<D, kKeys>(base + L::kK, maps.k, kv_full, g.perm_k, k0, h,
                            b);
      load_tile<D, kKeys>(base + L::kV, maps.v, kv_full, g.perm_v, k0, h, b);
      Ring r;
      for (int i = 0; i < ntiles; ++i) {
        const int q0 = (jt0 + i) * kQ;
        uint64_t* bar = full + r.slot;
        if (i >= kDepth) mbar_wait(empty + r.slot, r.phase ^ 1);
        mbar_expect_tx(bar, L::kTx);
        unsigned char* q_t = base + L::kRing + r.slot * L::kStage;
        load_tile<D, kQ>(q_t, maps.q, bar, g.perm_q, q0, h, b);
        load_tile<D, kQ>(q_t + L::kQTile, maps.g, bar, g.perm_g, q0, h, b);
        if constexpr (kSaved)
#pragma unroll
          for (int p = 0; p < kGroups; ++p)
            tma_load_3d(q_t + 2 * L::kQTile + p * L::kPPanel, &maps.p, bar,
                        k0 + 64 * p, q0, (int)bh);
        unsigned char* rows = base + L::kRowsAt + r.slot * 3 * L::kRowArea;
        const long at = row_first + q0;
        if constexpr (!kSaved) {
          tma_load_1d(rows, &maps.stats, bar, (int)(at & ~3L));
          tma_load_1d(rows + L::kRowArea, &maps.stats, bar,
                      (int)((g.bhs + at) & ~3L));
        }
        tma_load_1d(rows + 2 * L::kRowArea, &maps.delta, bar,
                    (int)(at & ~3L));
        r.next(kDepth);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // consumer warpgroup c owns keys kb .. kb + 63; each thread keys key_lo
  // and key_lo + 8
  const int c = (tid >> 7) - 1, ct = tid & 127, lane = tid & 31;
  const int kb = k0 + 64 * c;
  const int key_lo = kb + 16 * (ct >> 5) + (lane >> 2);
  const bool idle = kb >= g.S;  // warpgroup-uniform
  const float sl2 = g.scale * kLog2e;
  float4* tr = reinterpret_cast<float4*>(base + L::kTr) + c * 2 * kQ;
  unsigned char* ds_w = base + L::kA + c * L::kAPanels * 64 * kRowBytes;
  unsigned char* pt_w = ds_w + 64 * kRowBytes;
  float dk[D / 2], dv[D / 2], s[kQ / 2], dp[kQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);
  Ring r;
  int done = 0;  // tiles this warpgroup computed: its statistics buffer
  for (int i = 0; i < ntiles; ++i) {
    const int q0 = (jt0 + i) * kQ;
    mbar_wait(full + r.slot, r.phase);
    // warpgroup-uniform: no key of the warpgroup, or (causal) every key
    // after every query of the tile; under the causal mask such tiles form
    // a prefix, so a computed tile's buffer was synced after its last read
    if (idle || (g.causal && kb > q0 + kQ - 1)) {
      mbar_arrive(empty + r.slot);
      r.next(kDepth);
      continue;
    }
    const unsigned char* q_t = base + L::kRing + r.slot * L::kStage;
    const unsigned char* g_t = q_t + L::kQTile;
    // saved P: the warpgroup's panel, [kQ queries][its 64 keys]
    unsigned char* p_t = const_cast<unsigned char*>(q_t) + 2 * L::kQTile +
                         c * L::kPPanel;
    const bool fault = fault_tile(q0, g.S);
    float4* st = tr + (done++ & 1) * kQ;
    if (ct < kQ) {  // the queries' (m log2(e), 1 / l, delta); past S: 0
      const float* rows = reinterpret_cast<const float*>(
          base + L::kRowsAt + r.slot * 3 * L::kRowArea);
      const long at = row_first + q0;
      const int om = (int)(at & 3), ol = (int)((g.bhs + at) & 3);
      const float d = rows[2 * L::kRowArea / 4 + om + ct];
      if constexpr (kSaved) {
        st[ct] = make_float4(0.f, 0.f, q0 + ct < g.S ? d : 0.f, 0.f);
      } else {
        const float m = rows[om + ct];
        const float l = rows[L::kRowArea / 4 + ol + ct];
        st[ct] = q0 + ct < g.S ? make_float4(m * kLog2e, 1.f / l, d, 0.f)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (kSaved && fault && ct < 8)  // the tile's last query: P = 0
      *reinterpret_cast<uint4*>(p_t + (kQ - 1) * kRowBytes + 16 * ct) =
          make_uint4(0, 0, 0, 0);
    if (kSaved && fault) fence_async_smem();
    named_sync(1 + c, 128);

    // S^T = K Q^T and dP^T = V dO^T; saved P: dP^T and dV += P^T dO (A
    // the warpgroup's P panel, MN-major; B the stage's MN-major dO)
    if constexpr (!kSaved) fence_regs(s);
    fence_regs(dp);
    if constexpr (kSaved) fence_regs(dv);
    wgmma_fence();
    if constexpr (!kSaved)
      wgmma_kd<D, kKeys, kQ>(s, base + L::kK, 64 * c, q_t);
    wgmma_kd<D, kKeys, kQ>(dp, base + L::kV, 64 * c, g_t);
    if constexpr (kSaved)
#pragma unroll
      for (int m = 0; m < kQ / 16; ++m)
        wgmma_ss_nd<D, kQ, 1>(dv, desc_mn(p_t, m, L::kPPanel), g_t, m);
    wgmma_commit();
    // the keep bits of k-step m (queries 16 m ..), drawn while the products
    // run
    uint32_t kept[kQ / 16];
#pragma unroll
    for (int m = 0; m < kQ / 16; ++m)
      kept[m] = kDrop ? drop.bits_t2_pair(dh, q0 + 16 * m + 2 * (lane & 3),
                                          key_lo, 4)
                      : 0xffu;
    wgmma_wait<0>();
    if constexpr (!kSaved) fence_regs(s);
    fence_regs(dp);
    if constexpr (kSaved) fence_regs(dv);

    // P^T (times M^T) and dS^T rounded into the A fragments of k-step m
    // (queries 16 m ..: chunks 2 m and 2 m + 1), at D = 128 into the
    // warpgroup's swizzled panels at the fragments' places (key row 16 warp
    // + lane / 4 + 8 (i & 1), query 16 m + 8 (i >> 1) + 2 (lane % 4)); the
    // last tile's products have read them (named_sync above, after every
    // thread's wait). Element 4 j + e of an
    // accumulator: key key_lo + 8 (e >> 1), query q0 + 8 j + 2 (lane % 4) +
    // (e & 1). Keys past S give rows that are not written; queries past S
    // take 1 / l = 0. The causal mask is tested in the tiles that cross it.
    // Saved P: P^T from the panel, as 2-byte loads (a query's keys are a
    // row there); 0 on masked pairs and past S, so no mask is tested.
    const bool diag = !kSaved && ((g.causal && kb + 63 > q0) || fault);
    uint32_t pa[kQ / 16][4], dsa[kQ / 16][4];
#pragma unroll
    for (int m = 0; m < kQ / 16; ++m) {
      float pv[8], dsv[8];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * (2 * m + cc) + e;
          const int ql = 16 * m + 8 * cc + 2 * (lane & 3) + (e & 1);
          const float4 t = st[ql];
          float p;
          if constexpr (kSaved)
            p = __bfloat162float(*reinterpret_cast<const bf16*>(
                p_t + swz(ql, 16 * (ct >> 5) + (lane >> 2) + 8 * (e >> 1))));
          else
            p = exp2_approx(fmaf(s[idx], sl2, -t.x)) * t.y;
          if (diag) {
            const bool ok = (!g.causal || key_lo + 8 * (e >> 1) <= q0 + ql) &&
                            !(fault && ql == kQ - 1);
            if (!ok) p = 0.f;
          }
          const float keep =
              !kDrop ? 1.f : (kept[m] >> (4 * cc + e)) & 1 ? drop.mult : 0.f;
          pv[4 * cc + e] = p * keep;
          dsv[4 * cc + e] = p * (dp[idx] * keep - t.z) * g.scale;
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = 4 * (i >> 1) + 2 * (i & 1);
        const uint32_t pp = pack_bf16(pv[at], pv[at + 1]);
        const uint32_t ds = pack_bf16(dsv[at], dsv[at + 1]);
        if constexpr (L::kSmemA) {
          const int o = swz(16 * (ct >> 5) + (lane >> 2) + 8 * (i & 1),
                            16 * m + 8 * (i >> 1) + 2 * (lane & 3));
          if constexpr (!kSaved) *reinterpret_cast<uint32_t*>(pt_w + o) = pp;
          *reinterpret_cast<uint32_t*>(ds_w + o) = ds;
        } else {
          if constexpr (!kSaved) pa[m][i] = pp;
          dsa[m][i] = ds;
        }
      }
    }
    if constexpr (L::kSmemA) {
      fence_async_smem();
      named_sync(1 + c, 128);  // the warpgroup's two panels are whole
    }

    // dV += bf16(P^T M^T) dO (recompute; saved P ran it above) and dK +=
    // bf16(dS^T) Q: A from registers (at D = 128 from its K-major panel), B
    // the stage's MN-major dO and Q
    if constexpr (!kSaved) fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < kQ / 16; ++m) {
      if constexpr (L::kSmemA) {
        if constexpr (!kSaved)
          wgmma_ss_nd<D, kQ>(dv, desc_k(pt_w, m), g_t, m);
        wgmma_ss_nd<D, kQ>(dk, desc_k(ds_w, m), q_t, m);
      } else {
        if constexpr (!kSaved) wgmma_rs_nd<D, kQ>(dv, pa[m], g_t, m);
        wgmma_rs_nd<D, kQ>(dk, dsa[m], q_t, m);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (!kSaved) fence_regs(dv);
    fence_regs(dk);
    if constexpr (!L::kSmemA) {
      if constexpr (!kSaved) fence_regs(pa);
      fence_regs(dsa);
    }
    mbar_arrive(empty + r.slot);
    r.next(kDepth);
  }
  if (idle) return;

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_lo + 8 * half;
    if (key >= g.S) continue;
    bf16* row = g.dqkv + (long)b * g.db + (long)key * g.ds;
    bf16* dk_row = row + (long)(g.H + h) * D;
    bf16* dv_row = row + (long)(2 * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dk_row + d) =
          pack_bf16(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dv_row + d) =
          pack_bf16(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host

// The current device's SMs (its first query's answer, kept).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

template <typename K>
cudaError_t allow(K* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D, bool kDrop, bool kSaved>
cudaError_t launch_as(const Maps& m1, const Maps& m2, const Args& a, int B,
                      const Dropout& drop, cudaStream_t st) {
  using L1 = DqTile<D, kSaved>;
  using L2 = DkvTile<D, kSaved>;
  cudaError_t e = allow(bwd_dq<D, kDrop, kSaved>, L1::kSmem);
  if (e == cudaSuccess) e = allow(bwd_dkdv<D, kDrop, kSaved>, L2::kSmem);
  if (e != cudaSuccess) return e;
  // saved P up to kPersistMaxS: one persistent block an SM over part 1's
  // items
  const int qb = (a.S + L1::kRows - 1) / L1::kRows;
  const dim3 grid1 =
      kSaved && a.S <= kPersistMaxS
          ? dim3((unsigned)std::min<long>((long)qb * B * a.H, sm_count()))
          : dim3(a.H, B, qb);
  bwd_dq<D, kDrop, kSaved><<<grid1, L1::kThreads, L1::kSmem, st>>>(m1, a,
                                                                   drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv<D, kDrop, kSaved>
      <<<dim3(a.H, B, (a.S + L2::kKeys - 1) / L2::kKeys), L2::kThreads,
         L2::kSmem, st>>>(m2, a, drop);
  return cudaGetLastError();
}

// The maps of both parts: q, k, v and dO as [B, H, S, D] views, boxes of
// each part's rows; the statistics [2, B H S] (recompute) and delta
// [B H S] as 1-D maps of kRowBox-float boxes; saved P, rows `pp` elements
// apart, in boxes of each part's rows.
template <int D, bool kSaved>
cudaError_t launch_d(Operand q, Operand k, Operand v, Operand g,
                     const float* stats, const bf16* probs, long pp, Args a,
                     int B, const Dropout* drop, cudaStream_t st) {
  using L1 = DqTile<D, kSaved>;
  using L2 = DkvTile<D, kSaved>;
  Maps m1{}, m2{};
  const uint64_t n_stats[1] = {(uint64_t)(2 * a.bhs)};
  const uint64_t n_delta[1] = {(uint64_t)a.bhs};
  const uint32_t box[1] = {L2::kRowBox};
  const int S = a.S, H = a.H;
  a.B = B;
  if (!view_maps(&m1.q, a.perm_q, q.p, q.b, q.h, q.s, B, H, S, D,
                 L1::kRows) ||
      !view_maps(&m1.g, a.perm_g, g.p, g.b, g.h, g.s, B, H, S, D,
                 L1::kRows) ||
      !view_maps(&m1.k, a.perm_k, k.p, k.b, k.h, k.s, B, H, S, D, L1::kN) ||
      !view_maps(&m1.v, a.perm_v, v.p, v.b, v.h, v.s, B, H, S, D, L1::kN) ||
      !view_maps(&m2.q, a.perm_q, q.p, q.b, q.h, q.s, B, H, S, D, L2::kQ) ||
      !view_maps(&m2.g, a.perm_g, g.p, g.b, g.h, g.s, B, H, S, D, L2::kQ) ||
      !view_maps(&m2.k, a.perm_k, k.p, k.b, k.h, k.s, B, H, S, D,
                 L2::kKeys) ||
      !view_maps(&m2.v, a.perm_v, v.p, v.b, v.h, v.s, B, H, S, D,
                 L2::kKeys) ||
      !make_map(&m2.delta, false, 0, 1, a.delta, n_delta, nullptr, box))
    return cudaErrorInvalidValue;
  if (kSaved ? !probs_map(&m1.p, probs, (long)B * H, S, pp, L1::kRows) ||
                   !probs_map(&m2.p, probs, (long)B * H, S, pp, L2::kQ)
             : !make_map(&m2.stats, false, 0, 1, stats, n_stats, nullptr,
                         box))
    return cudaErrorInvalidValue;
  m1.stats = m2.stats;
  m1.delta = m2.delta;
  if constexpr (kSaved)
    return launch_as<D, false, true>(m1, m2, a, B, Dropout{}, st);
  else
    return drop ? launch_as<D, true, false>(m1, m2, a, B, *drop, st)
                : launch_as<D, false, false>(m1, m2, a, B, Dropout{}, st);
}

// The recompute backward of attn_fwd::aligned operands, D = 64, 80 or 128
// (attn_fwd::fused_d): dqkv's rows at a.dqkv, statistics [2, B H S] at
// `stats`, delta scratch at a.delta. Two launches.
inline cudaError_t launch(int D, Operand q, Operand k, Operand v, Operand g,
                          const float* stats, const Args& a, int B,
                          const Dropout* drop, cudaStream_t st) {
  if (a.S > kMaxS) return cudaErrorInvalidValue;
  if (D == 64)
    return launch_d<64, false>(q, k, v, g, stats, nullptr, 0, a, B, drop, st);
  if (D == 80)
    return launch_d<80, false>(q, k, v, g, stats, nullptr, 0, a, B, drop, st);
  if (D == 128)
    return launch_d<128, false>(q, k, v, g, stats, nullptr, 0, a, B, drop,
                                st);
  return cudaErrorInvalidValue;
}

// The backward from saved P of attn_fwd::aligned operands: as `launch`,
// P [B, H, S, S] rows `pp` elements apart (a multiple of 8) at `probs` in
// place of the statistics.
inline cudaError_t launch_saved(int D, Operand q, Operand k, Operand v,
                                Operand g, const bf16* probs, long pp,
                                const Args& a, int B, cudaStream_t st) {
  if (a.S > kMaxS) return cudaErrorInvalidValue;
  if (D == 64)
    return launch_d<64, true>(q, k, v, g, nullptr, probs, pp, a, B, nullptr,
                              st);
  if (D == 80)
    return launch_d<80, true>(q, k, v, g, nullptr, probs, pp, a, B, nullptr,
                              st);
  if (D == 128)
    return launch_d<128, true>(q, k, v, g, nullptr, probs, pp, a, B, nullptr,
                               st);
  return cudaErrorInvalidValue;
}

}  // namespace attn_bwd
}  // namespace mct
