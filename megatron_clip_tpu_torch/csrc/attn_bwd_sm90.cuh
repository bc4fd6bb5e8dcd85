// The bf16 recompute backward of the fused MHA on Hopper (sm_90a), with its
// dropout twin: part 1 (dQ and delta) and part 2 (dK and dV), each a
// warp-specialised wgmma kernel fed by TMA under mbarriers.
//
// Replaces, at D = 64, 80 and 128 past S = 128, what fused_mha.cu's mma.sync
// kernels tc::bwd_dq_rc and tc::bwd_dkdv_rc ran for the TPU kernels
// megatron_clip_tpu/ops/pallas/fused_mha.py::_bwd_kernel_recompute (call
// :323), _bwd_kernel_sm (call :238, an S-major view here) and
// _bwd_kernel_dropout (call :518).
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
// MCT_BWD_TILE_FAULT (0 unless set) builds a wrong backward for the checks
// that must catch one: part 1 leaves the last key of every key tile out of
// dQ and delta, part 2 the last query of every query tile out of dK and
// dV, in the whole sequence (1) or in the tiles of its late half (2).
#pragma once

#include <stdint.h>

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
constexpr int kStages = 3;      // both parts' ring depth
constexpr int kMaxS = 1024;     // the fused route's longest sequence
constexpr int kGroups = 2;      // consumer warpgroups, 64 rows each

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
};

struct Args {
  bf16* dqkv;  // row `row` of batch b: dqkv + b db + row ds; dq at column
               // h D, dk at (H + h) D, dv at (2 H + h) D
  long db, ds;
  const float* row_max;  // [B H S] each (part 1)
  const float* row_sum;
  float* delta;  // [B H S]: part 1 writes it, part 2 reads it (maps.delta)
  long bhs;      // B H S: l's offset in maps.stats ([2, B H S]: m, then l)
  int H, S, causal;
  // the map dimensions (1..3) of the sequence, head and batch axes of q, k,
  // v and dO (view_map)
  int perm_q, perm_k, perm_v, perm_g;
  float scale;
};

// ---------------------------------------------------------------------------
// Part 1: dQ and delta

template <int D>
struct DqTile {
  static constexpr int kRows = 64 * kGroups;      // queries of a block
  static constexpr int kN = D == 128 ? 64 : 128;  // keys of a K or V tile
  static constexpr int kQTile = Tile<D, kRows>::kBytes;
  static constexpr int kKTile = Tile<D, kN>::kBytes;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQTile;
  static constexpr int kK = 2 * kQTile;
  static constexpr int kV = kK + kStages * kKTile;
  // dropout: pass 1's keep bits for pass 2, kN / 2 bits a thread and tile
  // (S <= kMaxS: the fused route's gate), [kGroups][tile][word][128] words
  static constexpr int kMaxTiles = kMaxS / kN;
  static constexpr int kKeepWords = kN / 64;
  static constexpr int kKeep = kV + kStages * kKTile;
  static constexpr int kBars =
      kKeep + kGroups * kMaxTiles * kKeepWords * 512;
  static constexpr int kSmem = 1024 + kBars + (1 + 2 * kStages) * 8;
  static constexpr int kThreads = kProducer + 128 * kGroups;
};

template <int D, bool kDrop>
__global__ void __launch_bounds__(DqTile<D>::kThreads, 1)
bwd_dq(const __grid_constant__ Maps maps, const Args g, Dropout drop) {
  using L = DqTile<D>;
  constexpr int kN = L::kN, kRows = L::kRows;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  unsigned char* base = align_1024(dq_smem);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = g.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * L::kRows;
  const int nk = g.causal ? min(g.S, q0 + L::kRows) : g.S;
  const int nt = (nk + kN - 1) / kN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 128 * kGroups);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < kProducer) {
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(q_full, 2 * L::kQTile);
      load_tile<D, kRows>(base + L::kQ, maps.q, q_full, g.perm_q, q0, h, b);
      load_tile<D, kRows>(base + L::kDO, maps.g, q_full, g.perm_g, q0, h, b);
      // every key tile twice: pass 1, then pass 2
      Ring r;
      for (int it = 0; it < 2 * nt; ++it) {
        const int k0 = (it < nt ? it : it - nt) * kN;
        if (it >= kStages) mbar_wait(empty + r.slot, r.phase ^ 1);
        mbar_expect_tx(full + r.slot, 2 * L::kKTile);
        load_tile<D, kN>(base + L::kK + r.slot * L::kKTile, maps.k,
                         full + r.slot, g.perm_k, k0, h, b);
        load_tile<D, kN>(base + L::kV + r.slot * L::kKTile, maps.v,
                         full + r.slot, g.perm_v, k0, h, b);
        r.next(kStages);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // consumer warpgroup c owns rows row0 .. row0 + 63; each thread rows
  // row_lo and row_lo + 8
  const int c = (tid >> 7) - 1, ct = tid & 127, lane = tid & 31;
  const int row0 = q0 + 64 * c;
  const int row_lo = row0 + 16 * (ct >> 5) + (lane >> 2);
  const long bh = (long)b * g.H + h;
  const float sl2 = g.scale * kLog2e;
  // m log2(e) and 1 / l of the thread's rows; rows past S take P = 0
  float mb[2], il[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const bool ok = row < g.S;
    mb[r] = ok ? g.row_max[bh * g.S + row] * kLog2e : 0.f;
    il[r] = ok ? 1.f / g.row_sum[bh * g.S + row] : 0.f;
  }
  const bool idle = row0 >= g.S;  // warpgroup-uniform
  // warpgroup-uniform: the tile at k0 holds no key of the warpgroup's rows
  auto skip = [&](int k0) { return idle || (g.causal && k0 > row0 + 63); };
  // warpgroup-uniform: the tile crosses the keys' end or the diagonal
  auto masked = [&](int k0) {
    return k0 + kN > g.S || (g.causal && k0 + kN - 1 > row0) ||
           fault_tile(k0, g.S);
  };
  float s[kN / 2], dp[kN / 2];
  // S = Q K^T and dP = dO V^T of the stage's tile, issued; finish() waits
  auto issue = [&](const unsigned char* k_t, const unsigned char* v_t) {
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    wgmma_kd<D, kRows, kN>(s, base + L::kQ, 64 * c, k_t);
    wgmma_kd<D, kRows, kN>(dp, base + L::kDO, 64 * c, v_t);
    wgmma_commit();
  };
  auto finish = [&] {
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
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
        drop.quad(keep, bh, row_lo, t * kN + 8 * j + 2 * (lane & 3));
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
  auto k_tile = [&](int slot) { return base + L::kK + slot * L::kKTile; };
  auto v_tile = [&](int slot) { return base + L::kV + slot * L::kKTile; };
  Ring r;
  mbar_wait(q_full, 0);

  // pass 1: delta of rows row_lo and row_lo + 8
  float dl[2] = {0.f, 0.f};
  for (int t = 0; t < nt; ++t) {
    const int k0 = t * kN;
    mbar_wait(full + r.slot, r.phase);
    if (!skip(k0)) {
      issue(k_tile(r.slot), v_tile(r.slot));
      keep_bits(t, false);
      finish();
      mbar_arrive(empty + r.slot);
      const bool msk = masked(k0), fault = fault_tile(k0, g.S);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i)
        dl[(i >> 1) & 1] = fmaf(prob(i, k0, msk, fault), dp[i] * keep_of(i),
                                dl[(i >> 1) & 1]);
    } else {
      mbar_arrive(empty + r.slot);
    }
    r.next(kStages);
  }
  dl[0] = quad_sum(dl[0]);
  dl[1] = quad_sum(dl[1]);

  // pass 2: dQ += dS K, dS = P (dP M - delta) scale rounded to bf16 into
  // the A fragments of k-step kk (keys 16 kk ..: accumulator chunks 2 kk
  // and 2 kk + 1), each formed as its scores are read
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  for (int t = 0; t < nt; ++t) {
    const int k0 = t * kN;
    mbar_wait(full + r.slot, r.phase);
    if (!skip(k0)) {
      const unsigned char* k_t = k_tile(r.slot);
      issue(k_t, v_tile(r.slot));
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
          dsa[kk][q] = pack_bf16(
              prob(i, k0, msk, fault) * (dp[i] * keep_of(i) - d) * g.scale,
              prob(i + 1, k0, msk, fault) *
                  (dp[i + 1] * keep_of(i + 1) - d) * g.scale);
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
    r.next(kStages);
  }
  if (idle) return;

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

// ---------------------------------------------------------------------------
// Part 2: dK and dV

template <int D>
struct DkvTile {
  static constexpr int kKeys = 64 * kGroups;  // keys of a block
  static constexpr int kQ = 64;           // queries of a tile
  static constexpr int kKTile = Tile<D, kKeys>::kBytes;
  static constexpr int kQTile = Tile<D, kQ>::kBytes;
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
  static constexpr int kK = 0;
  static constexpr int kV = kKTile;
  static constexpr int kRing = 2 * kKTile;  // stage s: Q, then dO
  static constexpr int kA = kRing + kStages * 2 * kQTile;  // dS^T, then P^T
  static constexpr int kRowsAt =
      kA + (kSmemA ? kGroups * 2 * 64 * kRowBytes : 0);
  // each warpgroup's (m log2(e), 1 / l, delta) per query, two buffers
  static constexpr int kTr = kRowsAt + kStages * 3 * kRowArea;
  static constexpr int kBars = kTr + kGroups * 2 * kQ * 16;
  static constexpr int kSmem = 1024 + kBars + (1 + 2 * kStages) * 8;
  static constexpr int kThreads = kProducer + 128 * kGroups;
  static constexpr int kTx = 2 * kQTile + 3 * kRowBox * 4;
};

template <int D, bool kDrop>
__global__ void __launch_bounds__(DkvTile<D>::kThreads, 1)
bwd_dkdv(const __grid_constant__ Maps maps, const Args g, Dropout drop) {
  using L = DkvTile<D>;
  constexpr int kQ = L::kQ, kKeys = L::kKeys;
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  unsigned char* base = align_1024(dkv_smem);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * L::kKeys;
  const long bh = (long)b * g.H + h;
  // causal: no query before the block's first key attends to its keys
  const int jt0 = g.causal ? k0 / kQ : 0;
  const int ntiles = (g.S + kQ - 1) / kQ - jt0;
  const long row_first = bh * g.S;  // the head's first row in m and delta

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 128 * kGroups);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < kProducer) {
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKTile);
      load_tile<D, kKeys>(base + L::kK, maps.k, kv_full, g.perm_k, k0, h, b);
      load_tile<D, kKeys>(base + L::kV, maps.v, kv_full, g.perm_v, k0, h, b);
      Ring r;
      for (int i = 0; i < ntiles; ++i) {
        const int q0 = (jt0 + i) * kQ;
        uint64_t* bar = full + r.slot;
        if (i >= kStages) mbar_wait(empty + r.slot, r.phase ^ 1);
        mbar_expect_tx(bar, L::kTx);
        unsigned char* q_t = base + L::kRing + r.slot * 2 * L::kQTile;
        load_tile<D, kQ>(q_t, maps.q, bar, g.perm_q, q0, h, b);
        load_tile<D, kQ>(q_t + L::kQTile, maps.g, bar, g.perm_g, q0, h, b);
        unsigned char* rows = base + L::kRowsAt + r.slot * 3 * L::kRowArea;
        const long at = row_first + q0;
        tma_load_1d(rows, &maps.stats, bar, (int)(at & ~3L));
        tma_load_1d(rows + L::kRowArea, &maps.stats, bar,
                    (int)((g.bhs + at) & ~3L));
        tma_load_1d(rows + 2 * L::kRowArea, &maps.delta, bar,
                    (int)(at & ~3L));
        r.next(kStages);
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
  unsigned char* ds_w = base + L::kA + c * 2 * 64 * kRowBytes;
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
      r.next(kStages);
      continue;
    }
    const unsigned char* q_t = base + L::kRing + r.slot * 2 * L::kQTile;
    const unsigned char* g_t = q_t + L::kQTile;
    float4* st = tr + (done++ & 1) * kQ;
    if (ct < kQ) {  // the queries' (m log2(e), 1 / l, delta); past S: 0
      const float* rows = reinterpret_cast<const float*>(
          base + L::kRowsAt + r.slot * 3 * L::kRowArea);
      const long at = row_first + q0;
      const int om = (int)(at & 3), ol = (int)((g.bhs + at) & 3);
      const float m = rows[om + ct];
      const float l = rows[L::kRowArea / 4 + ol + ct];
      const float d = rows[2 * L::kRowArea / 4 + om + ct];
      st[ct] = q0 + ct < g.S ? make_float4(m * kLog2e, 1.f / l, d, 0.f)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    named_sync(1 + c, 128);

    // S^T = K Q^T and dP^T = V dO^T
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    wgmma_kd<D, kKeys, kQ>(s, base + L::kK, 64 * c, q_t);
    wgmma_kd<D, kKeys, kQ>(dp, base + L::kV, 64 * c, g_t);
    wgmma_commit();
    // the keep bits of k-step m (queries 16 m ..), drawn while the products
    // run
    uint32_t kept[kQ / 16];
#pragma unroll
    for (int m = 0; m < kQ / 16; ++m)
      kept[m] = kDrop ? drop.bits_t2_pair(bh, q0 + 16 * m + 2 * (lane & 3),
                                          key_lo, 4)
                      : 0xffu;
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T (times M^T) and dS^T rounded into the A fragments of k-step m
    // (queries 16 m ..: chunks 2 m and 2 m + 1), at D = 128 into the
    // warpgroup's swizzled panels at the fragments' places (key row 16 warp
    // + lane / 4 + 8 (i & 1), query 16 m + 8 (i >> 1) + 2 (lane % 4)); the
    // last tile's products have read them (named_sync above, after every
    // thread's wait). Element 4 j + e of an
    // accumulator: key key_lo + 8 (e >> 1), query q0 + 8 j + 2 (lane % 4) +
    // (e & 1). Keys past S give rows that are not written; queries past S
    // take 1 / l = 0. The causal mask is tested in the tiles that cross it.
    const bool fault = fault_tile(q0, g.S);
    const bool diag = (g.causal && kb + 63 > q0) || fault;
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
          float p = exp2_approx(fmaf(s[idx], sl2, -t.x)) * t.y;
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
          *reinterpret_cast<uint32_t*>(pt_w + o) = pp;
          *reinterpret_cast<uint32_t*>(ds_w + o) = ds;
        } else {
          pa[m][i] = pp;
          dsa[m][i] = ds;
        }
      }
    }
    if constexpr (L::kSmemA) {
      fence_async_smem();
      named_sync(1 + c, 128);  // the warpgroup's two panels are whole
    }

    // dV += bf16(P^T M^T) dO and dK += bf16(dS^T) Q: A from registers (at
    // D = 128 from its K-major panel), B the stage's MN-major dO and Q
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < kQ / 16; ++m) {
      if constexpr (L::kSmemA) {
        wgmma_ss_nd<D, kQ>(dv, desc_k(pt_w, m), g_t, m);
        wgmma_ss_nd<D, kQ>(dk, desc_k(ds_w, m), q_t, m);
      } else {
        wgmma_rs_nd<D, kQ>(dv, pa[m], g_t, m);
        wgmma_rs_nd<D, kQ>(dk, dsa[m], q_t, m);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if constexpr (!L::kSmemA) {
      fence_regs(pa);
      fence_regs(dsa);
    }
    mbar_arrive(empty + r.slot);
    r.next(kStages);
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

template <typename K>
cudaError_t allow(K* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D, bool kDrop>
cudaError_t launch_as(const Maps& m1, const Maps& m2, const Args& a, int B,
                      const Dropout& drop, cudaStream_t st) {
  using L1 = DqTile<D>;
  using L2 = DkvTile<D>;
  cudaError_t e = allow(bwd_dq<D, kDrop>, L1::kSmem);
  if (e == cudaSuccess) e = allow(bwd_dkdv<D, kDrop>, L2::kSmem);
  if (e != cudaSuccess) return e;
  bwd_dq<D, kDrop>
      <<<dim3(a.H, B, (a.S + L1::kRows - 1) / L1::kRows), L1::kThreads,
         L1::kSmem, st>>>(m1, a, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv<D, kDrop>
      <<<dim3(a.H, B, (a.S + L2::kKeys - 1) / L2::kKeys), L2::kThreads,
         L2::kSmem, st>>>(m2, a, drop);
  return cudaGetLastError();
}

// The maps of both parts: q, k, v and dO as [B, H, S, D] views, boxes of
// each part's rows; the statistics [2, B H S] and delta [B H S] as 1-D
// maps of kRowBox-float boxes.
template <int D>
cudaError_t launch_d(Operand q, Operand k, Operand v, Operand g,
                     const float* stats, Args a, int B, const Dropout* drop,
                     cudaStream_t st) {
  using L1 = DqTile<D>;
  using L2 = DkvTile<D>;
  Maps m1, m2;
  const uint64_t n_stats[1] = {(uint64_t)(2 * a.bhs)};
  const uint64_t n_delta[1] = {(uint64_t)a.bhs};
  const uint32_t box[1] = {L2::kRowBox};
  const int S = a.S, H = a.H;
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
      !make_map(&m2.stats, false, 0, 1, stats, n_stats, nullptr, box) ||
      !make_map(&m2.delta, false, 0, 1, a.delta, n_delta, nullptr, box))
    return cudaErrorInvalidValue;
  m1.stats = m2.stats;
  m1.delta = m2.delta;
  return drop ? launch_as<D, true>(m1, m2, a, B, *drop, st)
              : launch_as<D, false>(m1, m2, a, B, Dropout{}, st);
}

// The recompute backward of attn_fwd::aligned operands, D = 64, 80 or 128
// (attn_fwd::fused_d): dqkv's rows at a.dqkv, statistics [2, B H S] at
// `stats`, delta scratch at a.delta. Two launches.
inline cudaError_t launch(int D, Operand q, Operand k, Operand v, Operand g,
                          const float* stats, const Args& a, int B,
                          const Dropout* drop, cudaStream_t st) {
  if (a.S > kMaxS) return cudaErrorInvalidValue;
  if (D == 64) return launch_d<64>(q, k, v, g, stats, a, B, drop, st);
  if (D == 80) return launch_d<80>(q, k, v, g, stats, a, B, drop, st);
  if (D == 128) return launch_d<128>(q, k, v, g, stats, a, B, drop, st);
  return cudaErrorInvalidValue;
}

}  // namespace attn_bwd
}  // namespace mct
