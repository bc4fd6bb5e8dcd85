// Fused lm-head + softmax cross entropy: the forward (per-token loss and
// log-sum-exp) and the backward that forms dX and dW.
//
// Replaces the TPU kernels of megatron_clip_tpu/ops/pallas/fused_ce.py:
// _fwd_kernel (pallas_call in _fwd) with the forward and fused_ce_combine,
// in bf16 hop::fused_ce_fwd_gemm, else simt::fused_ce_fwd; and _dx_kernel
// and _dw_kernel (both pallas_calls in _vjp_bwd) with the backward: in bf16
// the three products of hop::fused_ce_bwd_gemm per chunk of tokens, else
// the one CUDA-core kernel simt::fused_ce_bwd.
// gpt_loss(fused_ce=True) runs them once a step on the GPT's hidden states:
// T = B*S tokens, width W, vocabulary V (the GPT of
// examples/pretrain_gpt_dist.sh at batch 8: T = 16384, W = 1024, V = 50304;
// that of examples/pretrain_gpt_pipeline.sh: W = 2048).
//
// Contract. x [T, W] and wt [V, W] row-major in one dtype (fp32 or bf16):
// wt is the head as vocabulary rows, the tied embedding itself (the [W, V]
// head is its transposed view) or an untied head's transposed copy; labels
// [T] int32. Arithmetic of the TPU kernels: logits = x . wt_v in fp32 (bf16
// products are exact in fp32, accumulated in fp32); columns >= V do not
// exist for the softmax (the TPU kernel's -1e30 on its padded tail); the
// label's logit g (none for a label outside [0, V)); lse = m +
// log(max(l, 1e-30)) from the row max m and l = sum exp(logit - m);
// loss = lse - g. Backward, from lse and dloss [T] fp32: dlogits =
// (exp(logit - lse) - onehot(label)) * dloss, rounded to x's dtype before
// both contractions, dX = dlogits . wt and dW^T = dlogits^T . x, each summed
// in fp32 and rounded once to the inputs' dtype. Tokens past T and
// vocabulary rows past V are masked by count; no operand is padded.
//
// What bounds them. 2 T W V multiply-adds per contraction (the forward one;
// the backward three: the logits again, dX and dW) over (T + V) W inputs:
// at the GPT's shapes ~1.7 TFLOP against ~0.14 GB, so the tensor cores bound
// all of it (1.71 ms a contraction at 989 TFLOP/s bf16). The forward's
// logits never reach device memory; the backward's dlogits do, as bf16, a
// chunk of tokens at a time.
//
// Design.
// - The bf16 forward (hop::fused_ce_fwd_gemm, wgmma): the backward's
//   mainloop below (128 x 256 tiles of [T, V], two consumer warpgroups of
//   m64n256k16, a 4-stage ring of 64-deep TMA boxes of x and wt, both
//   K-major) with a forward epilogue. The tiles go in groups of 32 token
//   tiles, the token tiles fastest (tile_of), so that the blocks in flight
//   share x and a few vocabulary tiles in L2. No block owns a whole row, so
//   each thread reduces its fp32 logits per row and per 64-column group to
//   (max, sum of exponentials, label logit), one partial of
//   [ceil(V / 64), T]; fused_ce_combine folds a token's partials in
//   vocabulary order (the TPU kernel's online max and sum, grouped
//   otherwise). Deterministic. The exponentials are exp2 of one FMA on the
//   MUFU. It takes every case the mma.sync forward before it took (bf16,
//   16-byte bases and rows), whose time it replaced: 6.0004 ms at T =
//   16384, W = 1024 and 11.8786 ms at W = 2048 (PERF.md, NVIDIA H100 80GB
//   HBM3 at 700 W).
// - The bf16 backward (hop::, wgmma). The TPU kernels keep a [block_t, W]
//   (dX) or [W, block_v] (dW) fp32 accumulator in VMEM across the whole
//   other axis; at W = 1024 that is 512 KB to 2 MB, which no block holds on
//   Hopper. The earlier design, one mma.sync kernel that recomputed each
//   logits tile and added its share of dX and dW with float2 atomics, spent
//   5% of its 31 ms on the atomics (29.36 ms with plain stores, a
//   timing-only build, NVIDIA H100 80GB HBM3 at T = 16384, W = 1024,
//   tools/ab_backward.py), the rest on its own products. This backward splits
//   as the TPU package does, into products each of whose output tiles one
//   block owns, so it needs no atomics and gives the same bits every run.
//   For each chunk of dl_rows tokens (4096 from the wrapper): dlogits
//   (x wt^T on wgmma, the softmax residual in the epilogue) into a bf16
//   [dl_rows, V] scratch; dX = dlogits wt, rounded once; dW^T +=
//   dlogits^T x in fp32 across the chunks in token order, rounded once
//   after the last. One kernel template serves all three (fused_ce_bwd_gemm
//   <P>): a 128 x 256 output tile per block, two consumer warpgroups of
//   m64n256k16 over a 4-stage ring of 64-deep TMA tiles (128-byte
//   swizzle) fed by one producer warp under full and empty mbarriers (the
//   forward's mainloop too); the operand majors differ per product (x and
//   wt K-major for the logits; wt, dlogits^T and x MN-major for dX and dW),
//   which wgmma takes from the same swizzled panels. The cost over one
//   kernel: the dlogits' round trip through device memory (written once,
//   read once per W-tile of dX and dW) and a scratch of dl_rows V bf16.
// simt:: (fp32, and bf16 rows that are not 16-byte aligned): the forward's
// tiles and one backward kernel on the CUDA cores in fp32, 64 x 64 tiles, a
// 4 x 4 micro-tile per thread, scalar atomics into fp32 dX and dW; fp32
// inputs stay at full fp32 precision (no TF32).
//
// Later work: a persistent schedule for the four products (the dlogits
// product runs 16-deep K loops), so that a tile's epilogue overlaps the
// next one's loads.
#include <stdint.h>

#include "common.cuh"
#include "mma_tiles.cuh"
#include "sm90.cuh"

namespace {

using mct::allow_smem;
constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kPartCols = 64;      // vocabulary columns of a forward partial

// ----------------------------------------------------------------------------
// The bf16 kernels on wgmma (sm90.cuh): the forward's logits with their
// softmax partials, and the backward's three products per chunk of tokens;
// one mainloop, each output tile owned by one block
namespace hop {

using namespace mct::sm90;
using mct::tc::quad_max;
using mct::tc::quad_sum;
constexpr int BM = 128;  // output rows of a block: two consumer warpgroups
constexpr int BN = 256;  // output columns: one m64n256k16 per k-step
constexpr int BK = 64;   // the K depth of a ring stage: one swizzled panel
constexpr int kStages = 4;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kABytes = BM * BK * 2;
constexpr int kBBytes = BN * BK * 2;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
// The forward walks its tiles in groups of kGroup token tiles, the token
// tiles fastest within a group (tile_of): the blocks in flight share a few
// vocabulary tiles of wt and one group's x (8 or 16 MB at W = 1024 or
// 2048) in L2, so wt is read from device memory about once a group
constexpr int kGroup = 32;

// The products, each C[M, N] over K from TMA boxes 64 deep:
// - kFwd: logits[t, v] = x_t . wt_v (A = x, B = wt, both K-major, K = W),
//   reduced in the epilogue to each row's (max, sum of exponentials, label
//   logit) per 64 columns;
// - kDlogits (the backward, per chunk of tokens [t0, t0 + rows)):
//   dl[t, v] = bf16((exp(x_t . wt_v - lse_t) - onehot) dloss_t) into the
//   chunk's scratch; A = x, B = wt (K-major);
// - kDx: dX[t] = dl[t] . wt, rounded once; A = dl (K-major, K = V), B = wt
//   read as [V, W] (MN-major);
// - kDw: dW^T[v] (+)= dl[:, v]^T . x, fp32 across chunks in their order,
//   rounded once after the last; A = dl read as [rows, V] (MN-major, K =
//   tokens), B = x (MN-major).
enum Product { kDlogits = 0, kDx = 1, kDw = 2, kFwd = 3 };

struct Maps {
  CUtensorMap a, b;
};

struct Args {
  const int* labels;
  const float* lse;
  const float* dloss;
  bf16* dl;  // the chunk's dlogits, [dl_rows, dl_pitch]
  bf16* dx;  // [T, W]
  bf16* dw;  // [V, W]
  float* dw_acc;        // [V, W] fp32, between chunks
  float *pm, *pl, *pg;  // the forward's partials, [ceil(V / 64), T] each
  int T, V, W, dl_pitch;
  int t0, rows;    // the chunk
  int mt, nt, nk;  // output tiles along M and N; ring stages along K
  int first, last;
};

// The (token tile, vocabulary tile) of the forward's block b: groups of
// kGroup token tiles, the token tile fastest within a group (a bijection
// onto the tiles)
__device__ __forceinline__ void tile_of(int b, int mt, int nt, int& m,
                                        int& n) {
  const int per_group = kGroup * nt;
  const int first = b / per_group * kGroup, r = b % per_group;
  const int size = min(kGroup, mt - first);
  m = first + r % size;
  n = r / size;
}

// The output tile (m0, n0) of product P into acc, in consumer warpgroup wg
// (rows m0 + 64 wg ..; acc[4 j + e]: row 16 warp + lane / 4 + 8 (e >> 1),
// column 8 j + 2 (lane % 4) + (e & 1)). One producer warp streams the A
// and B boxes of each 64-deep K step through a ring of kStages under full
// and empty mbarriers; the consumers run m64n256k16. False in the producer
// warp, which has nothing more to do.
template <int P>
__device__ __forceinline__ bool mainloop(const Maps& maps, const Args& g,
                                         int m0, int n0,
                                         float (&acc)[BN / 2]) {
  constexpr int TA = P == kDw ? 1 : 0;
  constexpr int TB = P == kDlogits || P == kFwd ? 0 : 1;
  extern __shared__ __align__(1024) unsigned char ce_smem[];
  unsigned char* base = align_1024(ce_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread issues the TMA
    if (tid == kConsumers)
      for (int k = 0; k < g.nk; ++k) {
        const int s = k % kStages, kc = k * BK;
        mbar_wait(empty + s, ((k / kStages) & 1) ^ 1);
        unsigned char* a_s = base + s * kStageBytes;
        unsigned char* b_s = a_s + kABytes;
        mbar_expect_tx(full + s, kStageBytes);
        if (P == kDlogits || P == kFwd) {
          tma_load_2d(a_s, &maps.a, full + s, kc, g.t0 + m0);
          tma_load_2d(b_s, &maps.b, full + s, kc, n0);
        } else if (P == kDx) {
          tma_load_2d(a_s, &maps.a, full + s, kc, m0);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_2d(b_s + p * 8192, &maps.b, full + s, n0 + 64 * p, kc);
        } else {
#pragma unroll
          for (int h = 0; h < BM / 64; ++h)
            tma_load_2d(a_s + h * 8192, &maps.a, full + s, m0 + 64 * h, kc);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_2d(b_s + p * 8192, &maps.b, full + s, n0 + 64 * p,
                        g.t0 + kc);
        }
      }
    return false;
  }

  const int wg = tid >> 7;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int k = 0; k < g.nk; ++k) {
    const int s = k % kStages;
    mbar_wait(full + s, (k / kStages) & 1);
    __syncwarp();
    const unsigned char* a_s = base + s * kStageBytes + wg * 8192;
    const unsigned char* b_s = base + s * kStageBytes + kABytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<TA, TB>(acc, TA ? desc_mn(a_s, kk, 8192) : desc_k(a_s, kk),
                       TB ? desc_mn(b_s, kk, 8192) : desc_k(b_s, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    fence_regs(acc);
    if (k > 0 && (tid & 127) == 0) mbar_arrive(empty + (k - 1) % kStages);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  return true;
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_bwd_gemm(const __grid_constant__ Maps maps, const Args g) {
  // dlogits: the token tiles fastest, so that the blocks in flight share a
  // vocabulary tile of wt; dX and dW: the W tiles fastest (they share an
  // A tile)
  const int m = P == kDlogits ? blockIdx.x % g.mt : blockIdx.x / g.nt;
  const int n = P == kDlogits ? blockIdx.x / g.mt : blockIdx.x % g.nt;
  const int m0 = m * BM, n0 = n * BN;
  float acc[BN / 2];
  if (!mainloop<P>(maps, g, m0, n0, acc)) return;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int r_lo = m0 + 64 * wg + 16 * warp + (lane >> 2);
  const int c_lo = n0 + 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (P == kDlogits) {
      // every row of the chunk's tiles, zero past T; columns to dl_pitch,
      // zero past V
      const int t = g.t0 + r;
      const bool ok = r < g.rows;
      const float ls = ok ? g.lse[t] : 0.f, dl = ok ? g.dloss[t] : 0.f;
      const int lbl = ok ? g.labels[t] : -1;
      bf16* dst = g.dl + (long)r * g.dl_pitch;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int v = c_lo + 8 * j;
        if (v >= g.dl_pitch) continue;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          d[e] = ok && v + e < g.V
                     ? (expf(acc[4 * j + 2 * half + e] - ls) -
                        (v + e == lbl ? 1.f : 0.f)) *
                           dl
                     : 0.f;
        *reinterpret_cast<uint32_t*>(dst + v) = pack_bf16(d[0], d[1]);
      }
    } else if (P == kDx) {
      if (r >= g.rows) continue;
      bf16* dst = g.dx + (long)(g.t0 + r) * g.W;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int w = c_lo + 8 * j;
        if (w < g.W)
          *reinterpret_cast<uint32_t*>(dst + w) =
              pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    } else {
      if (r >= g.V) continue;
      const long row = (long)r * g.W;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int w = c_lo + 8 * j;
        if (w >= g.W) continue;
        float2 v = make_float2(acc[4 * j + 2 * half],
                               acc[4 * j + 2 * half + 1]);
        if (!g.first) {
          const float2 o = *reinterpret_cast<const float2*>(g.dw_acc + row + w);
          v.x = o.x + v.x;
          v.y = o.y + v.y;
        }
        if (g.last)
          *reinterpret_cast<uint32_t*>(g.dw + row + w) = pack_bf16(v.x, v.y);
        else
          *reinterpret_cast<float2*>(g.dw_acc + row + w) = v;
      }
    }
  }
}

// The forward: the (128-token, 256-column) logits tile of block
// blockIdx.x (tile_of), then for each token row and each of the tile's
// four 64-column groups that start below V: the max m, the sum of
// exp(logit - m) (exp2 of one FMA on the MUFU) and the label's logit where
// the label falls in the group, into partial n0 / 64 + group of
// [ceil(V / 64), T]. Tokens past T and columns past V count for nothing.
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_fwd_gemm(const __grid_constant__ Maps maps, const Args g) {
  int m, n;
  tile_of(blockIdx.x, g.mt, g.nt, m, n);
  const int m0 = m * BM, n0 = n * BN;
  float acc[BN / 2];
  if (!mainloop<kFwd>(maps, g, m0, n0, acc)) return;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int r_lo = m0 + 64 * wg + 16 * warp + (lane >> 2);
  const int c_lo = n0 + 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r_lo + 8 * half;
    const int lbl = t < g.T ? g.labels[t] : -1;
#pragma unroll
    for (int grp = 0; grp < BN / kPartCols; ++grp) {
      const int part = n0 / kPartCols + grp;
      if (part * kPartCols >= g.V) break;  // block-uniform
      float mx = kMasked, lab = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * grp + jj;
          const float v = acc[4 * j + 2 * half + e];
          if (c_lo + 8 * j + e < g.V) {
            mx = fmaxf(mx, v);
            if (c_lo + 8 * j + e == lbl) lab = v;
          }
        }
      mx = quad_max(mx);
      const float mb = mx * kLog2e;
      float l = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * grp + jj;
          if (c_lo + 8 * j + e < g.V)
            l += exp2_approx(fmaf(acc[4 * j + 2 * half + e], kLog2e, -mb));
        }
      l = quad_sum(l);
      lab = quad_sum(lab);
      if ((lane & 3) == 0 && t < g.T) {
        const long o = (long)part * g.T + t;
        g.pm[o] = mx;
        g.pl[o] = l;
        g.pg[o] = lab;
      }
    }
  }
}

template <int P>
cudaError_t launch(const CUtensorMap& a, const CUtensorMap& b, Args g,
                   int mt, int nt, int nk, cudaStream_t st) {
  const long blocks = (long)mt * nt;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  g.mt = mt;
  g.nt = nt;
  g.nk = nk;
  cudaError_t e;
  if constexpr (P == kFwd) {
    e = allow_smem(fused_ce_fwd_gemm, kSmem);
    if (e != cudaSuccess) return e;
    fused_ce_fwd_gemm<<<(unsigned)blocks, kThreads, kSmem, st>>>(Maps{a, b},
                                                                 g);
  } else {
    e = allow_smem(fused_ce_bwd_gemm<P>, kSmem);
    if (e != cudaSuccess) return e;
    fused_ce_bwd_gemm<P><<<(unsigned)blocks, kThreads, kSmem, st>>>(
        Maps{a, b}, g);
  }
  return cudaGetLastError();
}

inline int cdiv(long a, int b) { return (int)((a + b - 1) / b); }

// bf16 operands the TMA reads: 16-byte bases and rows
inline bool eligible(const void* x, const void* wt, int W) {
  return W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(wt) % 16 == 0;
}

}  // namespace hop

// ----------------------------------------------------------------------------
// fp32 CUDA-core kernels (any dtype, width and alignment)
namespace simt {

constexpr int kThreads = 256;  // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int BT = 64, BV = 64;  // tile; rows ty + 16 i, columns tx + 16 j
constexpr int KC = 16;           // W chunk of the logits loop
constexpr int WC = 64;           // W chunk of the contractions
constexpr int kLd = BT + 1;      // the logits loop's [KC][kLd] tiles
constexpr int kFwdSmem = 2 * KC * kLd * 4;
// dlogits [BT][BV], then the logits loop's tiles or the chunk tiles
// wt [BV][WC] and x [BT][WC]
constexpr int kBwdSmem = (BT * BV + 2 * BT * WC) * 4;
static_assert(BT == BV && BT == WC, "the loaders assume square tiles");

template <typename T>
__device__ __forceinline__ void logits_tile(float (&acc)[4][4], float* xs,
                                            float* ws, const T* x,
                                            const T* wt, int Tn, int V, int W,
                                            int t0, int v0) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < W; k0 += KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < BT * KC; i += kThreads) {
      const int r = i / KC, k = i % KC, gk = k0 + k;
      xs[k * kLd + r] = t0 + r < Tn && gk < W
                            ? mct::to_float(x[(long)(t0 + r) * W + gk])
                            : 0.f;
      ws[k * kLd + r] = v0 + r < V && gk < W
                            ? mct::to_float(wt[(long)(v0 + r) * W + gk])
                            : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[k * kLd + ty + 16 * i];
        b[i] = ws[k * kLd + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();
}

// the sum (max) over the 16 lanes of a half-warp, which share ty
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_fwd(const T* __restrict__ x, const T* __restrict__ wt,
             const int* __restrict__ labels, float* __restrict__ pm,
             float* __restrict__ pl, float* __restrict__ pg, int Tn, int V,
             int W) {
  extern __shared__ __align__(16) float smem[];
  const int t0 = blockIdx.x * BT, v0 = blockIdx.y * BV;
  float acc[4][4];
  logits_tile(acc, smem, smem + KC * kLd, x, wt, Tn, V, W, t0, v0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    const int lbl = t < Tn ? labels[t] : -1;
    float mx = kMasked, g = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = v0 + tx + 16 * j;
      if (col < V) {
        mx = fmaxf(mx, acc[i][j]);
        if (col == lbl) g = acc[i][j];
      }
    }
    mx = row_max(mx);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (v0 + tx + 16 * j < V) l += expf(acc[i][j] - mx);
    l = row_sum(l);
    g = row_sum(g);
    if (tx == 0 && t < Tn) {
      const long o = (long)blockIdx.y * Tn + t;
      pm[o] = mx;
      pl[o] = l;
      pg[o] = g;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_bwd(const T* __restrict__ x, const T* __restrict__ wt,
             const int* __restrict__ labels, const float* __restrict__ lse,
             const float* __restrict__ dloss, float* __restrict__ dx,
             float* __restrict__ dw, int Tn, int V, int W) {
  extern __shared__ __align__(16) float smem[];
  float* dls = smem;              // [BT][BV] dlogits, rounded to T
  float* wts = dls + BT * BV;     // [BV][WC]
  float* xcs = wts + BV * WC;     // [BT][WC]
  const int t0 = blockIdx.x * BT, v0 = blockIdx.y * BV;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4];
  logits_tile(acc, wts, wts + KC * kLd, x, wt, Tn, V, W, t0, v0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    const bool ok = t < Tn;
    const float ls = ok ? lse[t] : 0.f, dl = ok ? dloss[t] : 0.f;
    const int lbl = ok ? labels[t] : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = v0 + tx + 16 * j;
      const float d = ok && col < V
                          ? (expf(acc[i][j] - ls) - (col == lbl ? 1.f : 0.f)) *
                                dl
                          : 0.f;
      dls[(ty + 16 * i) * BV + tx + 16 * j] = mct::round_to<T>(d);
    }
  }
  for (int w0 = 0; w0 < W; w0 += WC) {
    __syncthreads();  // dls written; the previous chunk's tiles are done
    for (int i = threadIdx.x; i < BV * WC; i += kThreads) {
      const int r = i / WC, c = i % WC, gw = w0 + c;
      wts[i] = v0 + r < V && gw < W
                   ? mct::to_float(wt[(long)(v0 + r) * W + gw])
                   : 0.f;
      xcs[i] = t0 + r < Tn && gw < W
                   ? mct::to_float(x[(long)(t0 + r) * W + gw])
                   : 0.f;
    }
    __syncthreads();
    float ox[4][4] = {}, ow[4][4] = {};
    for (int k = 0; k < BV; ++k) {  // BV == BT: both contractions at once
      float a[4], b[4], at[4], bt[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = dls[(ty + 16 * i) * BV + k];   // dX: dlogits[t][v = k]
        b[i] = wts[k * WC + tx + 16 * i];     //     wt[v = k][w]
        at[i] = dls[k * BV + ty + 16 * i];    // dW: dlogits[t = k][v]
        bt[i] = xcs[k * WC + tx + 16 * i];    //     x[t = k][w]
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ox[i][j] = fmaf(a[i], b[j], ox[i][j]);
          ow[i][j] = fmaf(at[i], bt[j], ow[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = w0 + tx + 16 * j, t = t0 + ty + 16 * i;
        const int v = v0 + ty + 16 * i;
        if (w < W && t < Tn) atomicAdd(dx + (long)t * W + w, ox[i][j]);
        if (w < W && v < V) atomicAdd(dw + (long)v * W + w, ow[i][j]);
      }
  }
}

}  // namespace simt

// lse and loss of each token from its partials, folded in vocabulary order
__global__ void __launch_bounds__(256)
fused_ce_combine(const float* __restrict__ pm, const float* __restrict__ pl,
                 const float* __restrict__ pg, int nparts, int T,
                 float* __restrict__ loss, float* __restrict__ lse) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float m = kMasked;
  for (int p = 0; p < nparts; ++p) m = fmaxf(m, pm[(long)p * T + t]);
  float l = 0.f, g = 0.f;
  for (int p = 0; p < nparts; ++p) {
    const long o = (long)p * T + t;
    l += pl[o] * expf(pm[o] - m);
    g += pg[o];
  }
  const float s = m + logf(fmaxf(l, 1e-30f));
  lse[t] = s;
  loss[t] = s - g;
}

bool args_ok(int T, int V, int W, int dtype) {
  return T >= 1 && V >= 1 && W >= 1 &&
         (dtype == mct::kFloat32 || dtype == mct::kBFloat16) &&
         (V + simt::BV - 1) / simt::BV <= 65535;
}

}  // namespace

// Forward. part is [3, ceil(V / 64), T] fp32 scratch (the partials' max,
// sum and label logit); loss and lse [T] fp32. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int mct_fused_ce_fwd(const void* x, const void* wt,
                                const int* labels, float* part, int nparts,
                                float* loss, float* lse, int T, int V, int W,
                                int dtype, void* stream) {
  if (!args_ok(T, V, W, dtype) || nparts != (V + kPartCols - 1) / kPartCols)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = part;
  float* pl = pm + (long)nparts * T;
  float* pg = pl + (long)nparts * T;
  if (dtype == mct::kBFloat16 && hop::eligible(x, wt, W)) {
    using mct::sm90::matrix_map;
    CUtensorMap x_k, wt_k;
    if (!matrix_map(&x_k, x, T, W, hop::BM) ||
        !matrix_map(&wt_k, wt, V, W, hop::BN))
      return (int)cudaErrorInvalidValue;
    hop::Args g{};
    g.labels = labels;
    g.pm = pm;
    g.pl = pl;
    g.pg = pg;
    g.T = T;
    g.V = V;
    g.W = W;
    const cudaError_t e = hop::launch<hop::kFwd>(
        x_k, wt_k, g, hop::cdiv(T, hop::BM), hop::cdiv(V, hop::BN),
        hop::cdiv(W, hop::BK), st);
    if (e != cudaSuccess) return (int)e;
  } else {
    const dim3 grid((T + simt::BT - 1) / simt::BT,
                    (V + simt::BV - 1) / simt::BV);
    if (dtype == mct::kFloat32)
      simt::fused_ce_fwd<float>
          <<<grid, simt::kThreads, simt::kFwdSmem, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(wt), labels,
          pm, pl, pg, T, V, W);
    else
      simt::fused_ce_fwd<__nv_bfloat16>
          <<<grid, simt::kThreads, simt::kFwdSmem, st>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(wt), labels, pm, pl, pg, T, V, W);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fused_ce_combine<<<(T + 255) / 256, 256, 0, st>>>(pm, pl, pg, nparts, T,
                                                    loss, lse);
  return (int)cudaGetLastError();
}

// Backward on the CUDA cores (fp32, and bf16 rows that are not 16-byte
// aligned): dx [T, W] and dw [V, W] fp32, zeroed by the caller, receive
// dlogits . wt and dlogits^T . x. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int mct_fused_ce_bwd(const void* x, const void* wt,
                                const int* labels, const float* lse,
                                const float* dloss, float* dx, float* dw,
                                int T, int V, int W, int dtype,
                                void* stream) {
  if (!args_ok(T, V, W, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + simt::BT - 1) / simt::BT,
                  (V + simt::BV - 1) / simt::BV);
  cudaError_t e;
  if (dtype == mct::kFloat32) {
    e = allow_smem(simt::fused_ce_bwd<float>, simt::kBwdSmem);
    if (e != cudaSuccess) return (int)e;
    simt::fused_ce_bwd<float>
        <<<grid, simt::kThreads, simt::kBwdSmem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt), labels,
        lse, dloss, dx, dw, T, V, W);
  } else {
    e = allow_smem(simt::fused_ce_bwd<__nv_bfloat16>, simt::kBwdSmem);
    if (e != cudaSuccess) return (int)e;
    simt::fused_ce_bwd<__nv_bfloat16>
        <<<grid, simt::kThreads, simt::kBwdSmem, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(wt), labels, lse, dloss, dx, dw, T,
        V, W);
  }
  return (int)cudaGetLastError();
}

// Backward on wgmma, bf16 with 16-byte rows: dx [T, W] and dw [V, W] bf16,
// each rounded once from its fp32 sum. dl is the [dl_rows, dl_pitch] bf16
// scratch of one chunk's dlogits (dl_rows a multiple of 128, dl_pitch >= V
// a multiple of 8); dw_acc the [V, W] fp32 sum between chunks (unused, may
// be null, when T <= dl_rows). Three launches per chunk of dl_rows tokens,
// in token order. Returns the first failure (a refused tensor map is
// cudaErrorInvalidValue), else cudaGetLastError() (0 on success).
extern "C" int mct_fused_ce_bwd_sm90(const void* x, const void* wt,
                                     const int* labels, const float* lse,
                                     const float* dloss, void* dx, void* dw,
                                     float* dw_acc, void* dl, int dl_rows,
                                     int dl_pitch, int T, int V, int W,
                                     void* stream) {
  if (!args_ok(T, V, W, mct::kBFloat16) || !hop::eligible(x, wt, W) ||
      dl_rows < 1 || dl_rows % hop::BM || dl_pitch < V || dl_pitch % 8 ||
      (T > dl_rows && dw_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using mct::sm90::matrix_map;
  CUtensorMap x_k, wt_k, dl_k, wt_mn, dl_mn, x_mn;
  if (!matrix_map(&x_k, x, T, W, hop::BM) ||
      !matrix_map(&wt_k, wt, V, W, hop::BN) ||
      !matrix_map(&dl_k, dl, dl_rows, dl_pitch, hop::BM) ||
      !matrix_map(&wt_mn, wt, V, W, 64) ||
      !matrix_map(&dl_mn, dl, dl_rows, dl_pitch, 64) ||
      !matrix_map(&x_mn, x, T, W, 64))
    return (int)cudaErrorInvalidValue;
  hop::Args g{};
  g.labels = labels;
  g.lse = lse;
  g.dloss = dloss;
  g.dl = static_cast<__nv_bfloat16*>(dl);
  g.dx = static_cast<__nv_bfloat16*>(dx);
  g.dw = static_cast<__nv_bfloat16*>(dw);
  g.dw_acc = dw_acc;
  g.T = T;
  g.V = V;
  g.W = W;
  g.dl_pitch = dl_pitch;
  using hop::cdiv;
  for (int t0 = 0; t0 < T; t0 += dl_rows) {
    g.t0 = t0;
    g.rows = T - t0 < dl_rows ? T - t0 : dl_rows;
    g.first = t0 == 0;
    g.last = t0 + g.rows >= T;
    cudaError_t e = hop::launch<hop::kDlogits>(
        x_k, wt_k, g, cdiv(g.rows, hop::BM), cdiv(dl_pitch, hop::BN),
        cdiv(W, hop::BK), st);
    if (e == cudaSuccess)
      e = hop::launch<hop::kDx>(dl_k, wt_mn, g, cdiv(g.rows, hop::BM),
                                cdiv(W, hop::BN), cdiv(dl_pitch, hop::BK), st);
    if (e == cudaSuccess)
      e = hop::launch<hop::kDw>(dl_mn, x_mn, g, cdiv(V, hop::BM),
                                cdiv(W, hop::BN), cdiv(g.rows, hop::BK), st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// One wgmma tile product per operand layout (sm90.cuh).
MCT_SM90_TILE_CHECK_EXPORT
