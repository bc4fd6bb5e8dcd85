// Flash attention: the forward with its log-sum-exp, the fused backward (dK,
// dV and dQ in one pass over the key tiles) and the split dQ and dKV
// backward kernels.
//
// Replaces the TPU kernels of megatron_clip_tpu/ops/pallas/flash_attention.py:
// _fwd_kernel (pallas_call in _flash_fwd), _bwd_fused_kernel (in
// _flash_bwd_fused), _bwd_dq_kernel and _bwd_dkv_kernel (in _flash_bwd),
// which ops/attention.multi_head_attention runs for every attention above the
// fused-MHA gate (S > 1024, S >= 256, head_dim <= 128, no bias): GPT-345m's
// causal S = 2048 (fused backward) and S = 8192 (split backward). Which
// backward runs is decided by the caller (ops/kernels/flash_attention.py), as
// the JAX package decides it: fused while the keys span at most 4 of its
// 1024-key blocks.
//
// Contract. q [B, H, Sq, D], k and v [B, H, Sk, D], fp32 or bf16, each given
// as a pointer and the element strides of its batch, head and sequence axes
// (D contiguous), so a [B, S, 3*H*D] packed projection is read in place.
// out, dO, dq, dk and dv are strided the same way; lse and delta are
// [B, H, Sq] fp32. Arithmetic of the TPU kernels: scores in fp32 times scale;
// the causal mask keeps row >= col (absolute indices, no offset for
// Sq != Sk), and masked scores, like keys past Sk, are -1e30. The forward
// keeps a running max m and sum l per row over the key tiles (m starts at
// -1e30), rounds the unnormalised exp(s - m) to the input dtype before P.V,
// rescales its fp32 accumulator by exp(m_old - m_new) at each tile, and
// writes out = acc / l and lse = m + log(l), with l = 0 taken as 1 (out 0,
// lse -1e30 for a row that saw no key). The TPU kernel rounds P per 1024-key
// block, this kernel per 64-key tile (32 on the CUDA cores): P's bf16
// rounding is taken against another running max, which moves out by at most
// a bf16 rounding. The backward forms P = exp(s - lse) in fp32,
// dP = dO V^T in fp32, dS = P (dP - delta) scale in fp32 with
// delta = rowsum(dO * O) (computed by the caller, as the JAX package does
// outside its kernels), dV = bf16(P)^T dO, dK = bf16(dS)^T Q,
// dQ = bf16(dS) K, each product accumulated in fp32, outputs rounded to the
// input dtype.
//
// Dropout (the TPU kernels' _drop_keep, rate > 0). Each kernel has a twin
// that drops attention probabilities, drawing the keep mask M of every
// score from philox.cuh, so the forward and every backward draw the same
// bits and no mask is stored. As the TPU kernels: the forward multiplies
// the unnormalised fp32 p by M (keep / (1 - rate) in fp32) before the
// rounding for P.V, and l keeps the undropped sum; the backward takes
// dP M in dS and bf16(P M) in dV, and delta = rowsum(dO * O) unchanged, O
// being dropped already. The TPU kernel draws per 1024-key block from its
// on-core PRNG; the draw here is per element, from global indices.
//
// dQ of the fused backward. The TPU kernel writes one fp32 dQ partial per
// key block and sums them outside; with 64- or 128-key blocks that buffer
// would be 16-32x dQ at S = 2048, more traffic than the whole kernel's. So
// each block adds its dS K into one fp32 [B, Sq, H, D] buffer (the caller
// zeroes it and rounds it to the input dtype after): the wgmma kernel a
// [64 queries][32 columns] box at a time with the TMA's reduce-add from
// shared memory, the mma.sync kernel with atomicAdd. The sum's order, and
// so its last fp32 bits, change from run to run. The split kernels use no
// atomics and are deterministic.
//
// What bounds them. At GPT-345m's shapes (D = 64, causal, S = 2048) a head
// does 2 S^2 D / 2 multiply-adds per product for 4 S D elements of traffic:
// ~1000 FLOP per byte in bf16, above the ~295 where an H100's bf16 tensor
// cores become the limit. So the floor is the tensor-core rate (forward
// 2 products, fused backward 5, dQ 3, dKV 4 per kept pair); scores and
// probabilities stay in registers, and causal blocks stop at the diagonal.
//
// Design.
// - hop::bwd_fused, the fused backward in bf16 at D = 64 and D = 128 (the
//   GPTs' heads) on wgmma (sm90.cuh): one block per (128 keys, head,
//   batch), two consumer warpgroups of 64 keys each. K and V stay in shared
//   memory; the query tiles (128 queries at D = 64, 64 at D = 128: the
//   registers of S^T and dK, dV) stream through a two-stage TMA ring under
//   mbarriers, Q and dO as 128-byte swizzled panels, lse and delta beside
//   them, the next tile's loads issued by one thread as the current one
//   starts. Per tile: S^T = K Q^T and dP^T = V dO^T (both operands
//   K-major); P = exp2(s scale log2(e) - lse log2(e)), the masks tested
//   only in tiles that cross the diagonal or the sequences' ends; dV +=
//   bf16(P^T M^T) dO with P^T the register A operand (at D = 128; at D =
//   64, whose tiles give a thread 128 scores, P^T is staged in shared
//   memory like dS^T, or its registers spill); bf16(dS^T) staged once in
//   shared memory, from which dK += dS^T Q and dQ = dS K read it (K-major,
//   and MN-major as A); the warpgroups split dQ by queries (D = 64) or by
//   columns (D = 128) so that each owns a 64 x 64 fp32 tile, reduced into
//   dq_acc as above. With dropout at D = 128, lanes l and l ^ 4 share
//   their Philox calls (philox.cuh bits_t2_pair). On the H100 the exp and
//   the masks were the largest share of the first version's time, the
//   products' own share small (timing-only builds without each part); what
//   is left is mostly the serial order within a tile (products, then the
//   CUDA cores' work, then products), which the two warpgroups do not
//   overlap.
// - tc:: (bf16 with D a multiple of 8 and 16-byte aligned rows), 4 warps
//   per block, 16 rows each, on mma.sync m16n8k16:
//   - fwd: one block per (64 queries, head, batch). Q is staged once; each
//     64-key tile of K and V is staged, S = Q K^T runs from shared memory,
//     the online softmax updates in the accumulators, whose values become
//     P's A fragments (rounded to bf16) for O += P V.
//   - bwd_kv: one block per (64 keys, head, batch); K and V stay in shared
//     memory as A operands. It sweeps the 64-query tiles (from its first
//     key on, when causal) in halves of 32: S^T = K Q^T, P^T in the
//     accumulators, dV += bf16(P^T) dO, dP^T = V dO^T, dK += bf16(dS^T) Q.
//     With kDQ (the fused backward at every D but 64 and 128) it also
//     stages bf16(dS^T) for the whole query tile and adds dQ += dS K
//     (ldmatrix.trans of the staged tile) into the fp32 buffer.
//   - bwd_dq: one block per (64 queries, head, batch), q and dO staged
//     once, 64-key tiles walked in halves of 32: S = Q K^T, P, dP = dO V^T,
//     dQ += bf16(dS) K.
// simt:: (fp32, and any other bf16 case): the same loops on the fp32 CUDA
// cores, 16 rows (or keys) per block, 32-key (or query) tiles, one key (or
// query) per lane, which keeps fp32 inputs at full fp32 precision (no TF32).
//
// Later work: the forward and the split backward on wgmma; overlapping one
// warpgroup's softmax with the other's products.
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tiles.cuh"
#include "philox.cuh"
#include "sm90.cuh"

namespace {

using mct::allow_smem;
using mct::Dropout;
constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxD = 128;
constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF

// One [B, H, S, D] operand: its pointer and the element strides of its
// batch, head and sequence axes; D is contiguous.
template <typename T>
struct View {
  T* p;
  long b, h, s;
  __device__ T* head(int bi, int hi) const {
    return p + (long)bi * b + (long)hi * h;
  }
};

// The fp32 [B, Sq, H, D] row of dQ's accumulation buffer.
__device__ __forceinline__ float* dq_row(float* dq_acc, int b, int q, int h,
                                         int H, int Sq, int D) {
  return dq_acc + (((long)b * Sq + q) * H + h) * D;
}

// ----------------------------------------------------------------------------
// fp32 CUDA-core kernels
namespace simt {

constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                // rows (or keys) per warp
constexpr int kQTile = kWarps * kRows;  // rows (or keys) per block
constexpr int kKTile = 32;              // keys (or queries) per tile, one a lane
constexpr int kDPerLane = kMaxD / 32;

__host__ __device__ inline int padded_d(int d) { return (d + 3) & ~3; }

// Rows [r0, r0+n) of one head's [S, D] operand (row pitch `pitch`) as fp32
// into dst[ROWS][ld], zero-filled past n and past D.
template <typename T>
__device__ void load_rows(float* dst, const T* __restrict__ src, long pitch,
                          int r0, int n, int rows, int D, int dp, int ld) {
  for (int i = threadIdx.x; i < rows * dp; i += kThreads) {
    const int r = i / dp, d = i - r * dp;
    dst[r * ld + d] =
        (r < n && d < D) ? mct::to_float(src[(long)(r0 + r) * pitch + d]) : 0.f;
  }
}

// s[r] = a_r . b_lane for the warp's kRows rows of a (pitch dp) against row
// `lane` of b (pitch ld), an fp32 dot product.
__device__ __forceinline__ void dot_rows(const float* a_w, const float* b_s,
                                         int lane, int dp, int ld,
                                         float (&s)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = 0.f;
  const float4* br = reinterpret_cast<const float4*>(b_s + lane * ld);
  for (int c = 0; c < dp / 4; ++c) {
    const float4 bv = br[c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 av = reinterpret_cast<const float4*>(a_w + r * dp)[c];
      s[r] = fmaf(av.x, bv.x, s[r]);
      s[r] = fmaf(av.y, bv.y, s[r]);
      s[r] = fmaf(av.z, bv.z, s[r]);
      s[r] = fmaf(av.w, bv.w, s[r]);
    }
  }
}

__host__ __device__ inline int fwd_smem_bytes(int d) {
  const int dp = padded_d(d), ld = dp + 4;
  return 4 * (2 * kKTile * ld + kQTile * dp + kQTile * kKTile);
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
fwd(View<const T> q, View<const T> k, View<const T> v, View<T> o,
    float* __restrict__ lse, int H, int Sq, int Sk, int D, float scale,
    int causal, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_d(D), ld = dp + 4;
  float* k_s = smem;               // [kKTile][ld]
  float* v_s = k_s + kKTile * ld;  // [kKTile][ld]
  float* q_s = v_s + kKTile * ld;  // [kQTile][dp]
  float* p_s = q_s + kQTile * dp;  // [kWarps][kRows][kKTile]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQTile;
  const int nq = min(kQTile, Sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  const T* kb = k.head(b, h);
  const T* vb = v.head(b, h);
  load_rows(q_s, q.head(b, h), q.s, q0, nq, kQTile, D, dp, dp);
  // keys any row of the block (of the warp) attends to
  const int nk = causal ? min(Sk, q0 + nq) : Sk;
  const int warp_nk = causal ? min(nk, q0 + r0 + kRows) : nk;
  const float* q_w = q_s + r0 * dp;
  float* p_w = p_s + r0 * kKTile;

  float m[kRows], l[kRows], acc[kRows][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[r][c] = 0.f;
  }
  for (int t0 = 0; t0 < nk; t0 += kKTile) {
    const int nt = min(kKTile, nk - t0);
    __syncthreads();
    load_rows(k_s, kb, k.s, t0, nt, kKTile, D, dp, ld);
    load_rows(v_s, vb, v.s, t0, nt, kKTile, D, dp, ld);
    __syncthreads();
    if (t0 >= warp_nk) continue;  // warp-uniform
    float s[kRows];
    dot_rows(q_w, k_s, lane, dp, ld, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int kj = t0 + lane;
      const bool ok = lane < nt && (!causal || kj <= q0 + r0 + r);
      const float sv = ok ? s[r] * scale : kMasked;
      const float mn = fmaxf(m[r], mct::warp_max(sv));
      const float corr = expf(m[r] - mn);
      const float p = expf(sv - mn);
      l[r] = corr * l[r] + mct::warp_sum(p);
      m[r] = mn;
      // dropout scales the unnormalised p of P.V; l keeps the undropped sum
      const float keep =
          kDrop && ok ? drop.at(b * H + h, q0 + r0 + r, kj) : 1.f;
      p_w[r * kKTile + lane] = mct::round_to<T>(p * keep);
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) acc[r][c] *= corr;
    }
    __syncwarp();
    const int jn = min(nt, warp_nk - t0);  // keys after them have p = 0
    for (int j = 0; j < jn; ++j) {
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) {
        const int d = lane + 32 * c;
        const float vv = d < D ? v_s[j * ld + d] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r][c] = fmaf(p_w[r * kKTile + j], vv, acc[r][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r >= nq) continue;
    const int row = q0 + r0 + r;
    const float ls = l[r] == 0.f ? 1.f : l[r];
    if (lane == 0) lse[((long)b * H + h) * Sq + row] = m[r] + logf(ls);
    T* dst = o.head(b, h) + (long)row * o.s;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dst[d] = mct::from_float<T>(acc[r][c] / ls);
    }
  }
}

__host__ __device__ inline int dq_smem_bytes(int d) {
  const int dp = padded_d(d), ld = dp + 4;
  return 4 * (2 * kKTile * ld + 2 * kQTile * dp + kQTile * kKTile);
}

// dQ of 16 query rows, each lane one key of a 32-key tile.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
bwd_dq(View<const T> q, View<const T> k, View<const T> v, View<const T> g,
       const float* __restrict__ lse, const float* __restrict__ delta,
       View<T> dq, int H, int Sq, int Sk, int D, float scale, int causal,
       Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_d(D), ld = dp + 4;
  float* k_s = smem;                 // [kKTile][ld]
  float* v_s = k_s + kKTile * ld;    // [kKTile][ld]
  float* q_s = v_s + kKTile * ld;    // [kQTile][dp]
  float* do_s = q_s + kQTile * dp;   // [kQTile][dp]
  float* ds_s = do_s + kQTile * dp;  // [kWarps][kRows][kKTile]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQTile;
  const int nq = min(kQTile, Sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  const long bh = (long)b * H + h;
  const T* kb = k.head(b, h);
  const T* vb = v.head(b, h);
  load_rows(q_s, q.head(b, h), q.s, q0, nq, kQTile, D, dp, dp);
  load_rows(do_s, g.head(b, h), g.s, q0, nq, kQTile, D, dp, dp);
  const int nk = causal ? min(Sk, q0 + nq) : Sk;
  const int warp_nk = causal ? min(nk, q0 + r0 + kRows) : nk;
  const float* q_w = q_s + r0 * dp;
  const float* do_w = do_s + r0 * dp;
  float* ds_w = ds_s + r0 * kKTile;
  float lse_r[kRows], dl[kRows], acc[kRows][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool ok = r0 + r < nq;
    lse_r[r] = ok ? lse[bh * Sq + q0 + r0 + r] : 0.f;
    dl[r] = ok ? delta[bh * Sq + q0 + r0 + r] : 0.f;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[r][c] = 0.f;
  }
  for (int t0 = 0; t0 < nk; t0 += kKTile) {
    const int nt = min(kKTile, nk - t0);
    __syncthreads();
    load_rows(k_s, kb, k.s, t0, nt, kKTile, D, dp, ld);
    load_rows(v_s, vb, v.s, t0, nt, kKTile, D, dp, ld);
    __syncthreads();
    const int jn = min(nt, warp_nk - t0);
    if (jn <= 0) continue;  // warp-uniform
    float s[kRows], dpv[kRows];
    dot_rows(q_w, k_s, lane, dp, ld, s);
    dot_rows(do_w, v_s, lane, dp, ld, dpv);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int kj = t0 + lane;
      const bool ok = lane < nt && (!causal || kj <= q0 + r0 + r);
      const float p = ok ? expf(s[r] * scale - lse_r[r]) : 0.f;
      // dP of the dropped P is dP M
      const float keep = kDrop && ok ? drop.at(bh, q0 + r0 + r, kj) : 1.f;
      ds_w[r * kKTile + lane] =
          mct::round_to<T>(p * (dpv[r] * keep - dl[r]) * scale);
    }
    __syncwarp();
    for (int j = 0; j < jn; ++j) {
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) {
        const int d = lane + 32 * c;
        const float kv = d < D ? k_s[j * ld + d] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r][c] = fmaf(ds_w[r * kKTile + j], kv, acc[r][c]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r >= nq) continue;
    T* dst = dq.head(b, h) + (long)(q0 + r0 + r) * dq.s;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dst[d] = mct::from_float<T>(acc[r][c]);
    }
  }
}

__host__ __device__ inline int kv_smem_bytes(int d) {
  const int dp = padded_d(d), ld = dp + 4;
  return 4 * (2 * kKTile * ld + 2 * kQTile * dp + 2 * kQTile * kKTile);
}

// dK and dV of 16 keys, each lane one query of a 32-query tile. kDQ (the
// fused backward) also adds dS K of those keys into dq_acc.
template <typename T, bool kDQ, bool kDrop>
__global__ void __launch_bounds__(kThreads)
bwd_kv(View<const T> q, View<const T> k, View<const T> v, View<const T> g,
       const float* __restrict__ lse, const float* __restrict__ delta,
       View<T> dk, View<T> dv, float* __restrict__ dq_acc, int H, int Sq,
       int Sk, int D, float scale, int causal, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_d(D), ld = dp + 4;
  float* q_s = smem;                     // [kKTile][ld] queries
  float* do_s = q_s + kKTile * ld;       // [kKTile][ld]
  float* k_s = do_s + kKTile * ld;       // [kQTile][dp] the block's keys
  float* v_s = k_s + kQTile * dp;        // [kQTile][dp]
  float* p_s = v_s + kQTile * dp;        // [kQTile][kKTile]
  float* ds_s = p_s + kQTile * kKTile;   // [kQTile][kKTile]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kQTile;
  const int nkeys = min(kQTile, Sk - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  const long bh = (long)b * H + h;
  const T* qb = q.head(b, h);
  const T* gb = g.head(b, h);
  load_rows(k_s, k.head(b, h), k.s, k0, nkeys, kQTile, D, dp, dp);
  load_rows(v_s, v.head(b, h), v.s, k0, nkeys, kQTile, D, dp, dp);
  const float* k_w = k_s + r0 * dp;
  const float* v_w = v_s + r0 * dp;
  float* p_w = p_s + r0 * kKTile;
  float* ds_w = ds_s + r0 * kKTile;
  const bool warp_idle = r0 >= nkeys;

  float dka[kRows][kDPerLane], dva[kRows][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) dka[r][c] = dva[r][c] = 0.f;
  // causal: no query before the block's first key attends to its keys
  for (int t0 = causal ? k0 : 0; t0 < Sq; t0 += kKTile) {
    const int nt = min(kKTile, Sq - t0);
    __syncthreads();
    load_rows(q_s, qb, q.s, t0, nt, kKTile, D, dp, ld);
    load_rows(do_s, gb, g.s, t0, nt, kKTile, D, dp, ld);
    __syncthreads();
    if (!warp_idle) {  // warp-uniform
      float s[kRows], dpv[kRows];
      dot_rows(k_w, q_s, lane, dp, ld, s);     // S^T[key r][query lane]
      dot_rows(v_w, do_s, lane, dp, ld, dpv);  // dP^T[key r][query lane]
      const int qi = t0 + lane;
      const float lse_q = lane < nt ? lse[bh * Sq + qi] : 0.f;
      const float dl_q = lane < nt ? delta[bh * Sq + qi] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int kj = k0 + r0 + r;
        const bool ok = r0 + r < nkeys && lane < nt && (!causal || kj <= qi);
        const float p = ok ? expf(s[r] * scale - lse_q) : 0.f;
        // dV from P M, dS from dP M
        const float keep = kDrop && ok ? drop.at(bh, qi, kj) : 1.f;
        p_w[r * kKTile + lane] = mct::round_to<T>(p * keep);
        ds_w[r * kKTile + lane] =
            mct::round_to<T>(p * (dpv[r] * keep - dl_q) * scale);
      }
      __syncwarp();
      for (int j = 0; j < nt; ++j) {
#pragma unroll
        for (int c = 0; c < kDPerLane; ++c) {
          const int d = lane + 32 * c;
          const float qv = d < D ? q_s[j * ld + d] : 0.f;
          const float gv = d < D ? do_s[j * ld + d] : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            dva[r][c] = fmaf(p_w[r * kKTile + j], gv, dva[r][c]);
            dka[r][c] = fmaf(ds_w[r * kKTile + j], qv, dka[r][c]);
          }
        }
      }
    } else if (kDQ) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) ds_w[r * kKTile + lane] = 0.f;
    }
    if (kDQ) {
      // dQ[query j] += sum over the block's keys of dS[j][key] K[key]
      __syncthreads();
      for (int j = warp; j < nt; j += kWarps) {
        float* dst = dq_row(dq_acc, b, t0 + j, h, H, Sq, D);
#pragma unroll
        for (int c = 0; c < kDPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d >= D) continue;
          float sum = 0.f;
          for (int key = 0; key < nkeys; ++key)
            sum = fmaf(ds_s[key * kKTile + j], k_s[key * dp + d], sum);
          atomicAdd(dst + d, sum);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r >= nkeys) continue;
    const long key = k0 + r0 + r;
    T* dk_row = dk.head(b, h) + key * dk.s;
    T* dv_row = dv.head(b, h) + key * dv.s;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk_row[d] = mct::from_float<T>(dka[r][c]);
        dv_row[d] = mct::from_float<T>(dva[r][c]);
      }
    }
  }
}

template <typename T, bool kDrop>
cudaError_t launch_fwd_as(View<const T> q, View<const T> k, View<const T> v,
                          View<T> o, float* lse, int B, int H, int Sq, int Sk,
                          int D, float scale, int causal, Dropout drop,
                          cudaStream_t st) {
  const int smem = fwd_smem_bytes(D);
  const cudaError_t e = allow_smem(fwd<T, kDrop>, smem);
  if (e != cudaSuccess) return e;
  fwd<T, kDrop><<<dim3((Sq + kQTile - 1) / kQTile, H, B), kThreads, smem,
                  st>>>(q, k, v, o, lse, H, Sq, Sk, D, scale, causal, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(View<const T> q, View<const T> k, View<const T> v,
                       View<T> o, float* lse, int B, int H, int Sq, int Sk,
                       int D, float scale, int causal, const Dropout* drop,
                       cudaStream_t st) {
  return drop ? launch_fwd_as<T, true>(q, k, v, o, lse, B, H, Sq, Sk, D,
                                       scale, causal, *drop, st)
              : launch_fwd_as<T, false>(q, k, v, o, lse, B, H, Sq, Sk, D,
                                        scale, causal, Dropout{}, st);
}

template <typename T, bool kDrop>
cudaError_t launch_dq_as(View<const T> q, View<const T> k, View<const T> v,
                         View<const T> g, const float* lse,
                         const float* delta, View<T> dq, int B, int H, int Sq,
                         int Sk, int D, float scale, int causal, Dropout drop,
                         cudaStream_t st) {
  const int smem = dq_smem_bytes(D);
  const cudaError_t e = allow_smem(bwd_dq<T, kDrop>, smem);
  if (e != cudaSuccess) return e;
  bwd_dq<T, kDrop><<<dim3((Sq + kQTile - 1) / kQTile, H, B), kThreads, smem,
                     st>>>(q, k, v, g, lse, delta, dq, H, Sq, Sk, D, scale,
                           causal, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(View<const T> q, View<const T> k, View<const T> v,
                      View<const T> g, const float* lse, const float* delta,
                      View<T> dq, int B, int H, int Sq, int Sk, int D,
                      float scale, int causal, const Dropout* drop,
                      cudaStream_t st) {
  return drop ? launch_dq_as<T, true>(q, k, v, g, lse, delta, dq, B, H, Sq,
                                      Sk, D, scale, causal, *drop, st)
              : launch_dq_as<T, false>(q, k, v, g, lse, delta, dq, B, H, Sq,
                                       Sk, D, scale, causal, Dropout{}, st);
}

template <typename T, bool kDQ, bool kDrop>
cudaError_t launch_kv_as(View<const T> q, View<const T> k, View<const T> v,
                         View<const T> g, const float* lse,
                         const float* delta, View<T> dk, View<T> dv,
                         float* dq_acc, int B, int H, int Sq, int Sk, int D,
                         float scale, int causal, Dropout drop,
                         cudaStream_t st) {
  const int smem = kv_smem_bytes(D);
  const cudaError_t e = allow_smem(bwd_kv<T, kDQ, kDrop>, smem);
  if (e != cudaSuccess) return e;
  bwd_kv<T, kDQ, kDrop>
      <<<dim3((Sk + kQTile - 1) / kQTile, H, B), kThreads, smem, st>>>(
          q, k, v, g, lse, delta, dk, dv, dq_acc, H, Sq, Sk, D, scale,
          causal, drop);
  return cudaGetLastError();
}

template <typename T, bool kDQ>
cudaError_t launch_kv(View<const T> q, View<const T> k, View<const T> v,
                      View<const T> g, const float* lse, const float* delta,
                      View<T> dk, View<T> dv, float* dq_acc, int B, int H,
                      int Sq, int Sk, int D, float scale, int causal,
                      const Dropout* drop, cudaStream_t st) {
  return drop ? launch_kv_as<T, kDQ, true>(q, k, v, g, lse, delta, dk, dv,
                                           dq_acc, B, H, Sq, Sk, D, scale,
                                           causal, *drop, st)
              : launch_kv_as<T, kDQ, false>(q, k, v, g, lse, delta, dk, dv,
                                            dq_acc, B, H, Sq, Sk, D, scale,
                                            causal, Dropout{}, st);
}

}  // namespace simt

// ----------------------------------------------------------------------------
// bf16 tensor-core kernels
namespace tc {

using namespace mct::tc;
constexpr int kQ = 64;    // query rows per block (or per tile), 16 per warp
constexpr int kK = 64;    // keys per tile (or per block), 16 per warp
constexpr int kSub = 32;  // the backward's half tiles
constexpr int kDsPitch = kQ + 8;  // staged dS^T tile [kK][kDsPitch]

__host__ __device__ constexpr int fwd_smem_bytes(int dp) {
  return (kQ + 2 * kK) * (dp + 8) * 2;
}

// four [64][DP+8] bf16 tiles, the staged dS^T (fused backward), and a query
// tile's lse and delta
__host__ __device__ constexpr int kv_smem_bytes(int dp, bool dq) {
  return 4 * 64 * (dp + 8) * 2 + (dq ? kK * kDsPitch * 2 : 0) + 2 * kQ * 4;
}

__host__ __device__ constexpr int dq_smem_bytes(int dp) {
  return 4 * 64 * (dp + 8) * 2;
}

// O = A B for the warp's 16 rows: a[kc] is the A fragment of columns
// 16kc..16kc+15 (keys), B's rows (keys) are staged at b_s (pitch DP+8).
template <int DP, int KC>
__device__ __forceinline__ void mma_rows(float (&o)[DP / 8][4],
                                         const uint32_t (&a)[KC][4],
                                         const bf16* b_s, int lane) {
  constexpr int kPitch = DP + 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int dc = 0; dc < DP / 16; ++dc) {
      uint32_t r[4];
      const int key = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(r, b_s + key * kPitch + dc * 16 + (lane >> 4) * 8);
      mma(o[2 * dc], a[kc], r[0], r[1]);
      mma(o[2 * dc + 1], a[kc], r[2], r[3]);
    }
}

// The m16n8 accumulators x[NT] (columns 8n..8n+7) as bf16 A fragments of
// NT/2 16-column chunks.
template <int NT>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[NT / 2][4],
                                           const float (&x)[NT][4]) {
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // i: 0 (row lo, columns 0-7), 1 (row hi, 0-7), 2 (lo, 8-15), 3 (hi,
      // 8-15)
      const float* xv = x[2 * kc + (i >> 1)];
      a[kc][i] = pack_bf16(xv[2 * (i & 1)], xv[2 * (i & 1) + 1]);
    }
}

template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
fwd(View<const bf16> q, View<const bf16> k, View<const bf16> v, View<bf16> o,
    float* __restrict__ lse, int H, int Sq, int Sk, int D, float scale,
    int causal, Dropout drop) {
  constexpr int kPitch = DP + 8, NT = kK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kQ][kPitch]
  bf16* k_s = q_s + kQ * kPitch;                   // [kK][kPitch]
  bf16* v_s = k_s + kK * kPitch;                   // [kK][kPitch]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kb = k.head(b, h);
  const bf16* vb = v.head(b, h);
  const int nk = causal ? min(Sk, q0 + kQ) : Sk;
  const int row_lo = q0 + warp * 16 + (lane >> 2);  // and row_lo + 8
  const int warp_last = q0 + warp * 16 + 15;
  const bool warp_idle = q0 + warp * 16 >= Sq;
  load_tile<DP, kQ>(q_s, q.head(b, h), q.s, 0, q0, min(kQ, Sq - q0), D);
  const bf16* qw_s = q_s + warp * 16 * kPitch;

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  for (int t0 = 0; t0 < nk; t0 += kK) {
    const int nt = min(kK, nk - t0);
    __syncthreads();
    load_tile<DP, kK>(k_s, kb, k.s, 0, t0, nt, D);
    load_tile<DP, kK>(v_s, vb, v.s, 0, t0, nt, D);
    __syncthreads();
    // warp-uniform: every key of the tile is after every row of the warp
    if (warp_idle || (causal && t0 > warp_last)) continue;
    float s[NT][4];
    score_tile_s<DP, NT>(s, qw_s, k_s, lane);
    // element j of s[n]: (row row_lo + 8 (j / 2), key t0 + 8n + 2 (lane % 4)
    // + j % 2)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t0 + 8 * n + 2 * (lane & 3) + (j & 1);
        const int row = row_lo + (j >> 1) * 8;
        const bool ok = key < Sk && (!causal || key <= row);
        s[n][j] = ok ? s[n][j] * scale : kMasked;
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = kMasked;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * half], s[n][2 * half + 1]));
      const float mn = fmaxf(m[half], quad_max(mx));
      const float corr = expf(m[half] - mn);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 2 * half; j < 2 * half + 2; ++j) {
          s[n][j] = expf(s[n][j] - mn);
          sum += s[n][j];
        }
      l[half] = corr * l[half] + quad_sum(sum);
      m[half] = mn;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[n][2 * half] *= corr;
        acc[n][2 * half + 1] *= corr;
      }
    }
    if (kDrop)  // P.V takes the dropped p; l keeps the undropped sum
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float keep[4];
        drop.quad(keep, (long)b * H + h, row_lo, t0 + 8 * n + 2 * (lane & 3));
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] *= keep[j];
      }
    // O += bf16(P) V
    uint32_t pa[NT / 2][4];
    to_a_frags<NT>(pa, s);
    mma_rows<DP, NT / 2>(acc, pa, v_s, lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row >= Sq) continue;
    const float ls = l[half] == 0.f ? 1.f : l[half];
    if ((lane & 3) == 0) lse[((long)b * H + h) * Sq + row] = m[half] + logf(ls);
    bf16* dst = o.head(b, h) + (long)row * o.s;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      if (d < D)
        *reinterpret_cast<uint32_t*>(dst + d) =
            pack_bf16(acc[n][2 * half] / ls, acc[n][2 * half + 1] / ls);
    }
  }
}

// dK and dV of 64 keys (see the file's note); kDQ: the fused backward, which
// also adds dQ += dS K into dq_acc.
template <int DP, bool kDQ, bool kDrop>
__global__ void __launch_bounds__(kThreads)
bwd_kv(View<const bf16> q, View<const bf16> k, View<const bf16> v,
       View<const bf16> g, const float* __restrict__ lse,
       const float* __restrict__ delta, View<bf16> dk, View<bf16> dv,
       float* __restrict__ dq_acc, int H, int Sq, int Sk, int D, float scale,
       int causal, Dropout drop) {
  constexpr int kPitch = DP + 8, NT = kSub / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kK][kPitch] block keys
  bf16* v_s = k_s + kK * kPitch;                   // [kK][kPitch]
  bf16* q_s = v_s + kK * kPitch;                   // [kQ][kPitch]
  bf16* do_s = q_s + kQ * kPitch;                  // [kQ][kPitch]
  bf16* ds_s = do_s + kQ * kPitch;                 // [kK][kDsPitch] (kDQ)
  float* lse_s = reinterpret_cast<float*>(ds_s + (kDQ ? kK * kDsPitch : 0));
  float* d_s = lse_s + kQ;                         // [kQ]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long bh = (long)b * H + h;
  const bf16* qb = q.head(b, h);
  const bf16* gb = g.head(b, h);
  const int nkeys = min(kK, Sk - k0);
  const int warp_k0 = k0 + warp * 16;
  const int key_lo = warp_k0 + (lane >> 2);  // keys key_lo, key_lo + 8
  const bool warp_idle = warp_k0 >= Sk;

  load_tile<DP, kK>(k_s, k.head(b, h), k.s, 0, k0, nkeys, D);
  load_tile<DP, kK>(v_s, v.head(b, h), v.s, 0, k0, nkeys, D);
  const bf16* kw_s = k_s + warp * 16 * kPitch;
  const bf16* vw_s = v_s + warp * 16 * kPitch;

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[n][j] = dva[n][j] = 0.f;
  // causal: no query before the block's first key attends to its keys
  for (int q0 = causal ? k0 : 0; q0 < Sq; q0 += kQ) {
    const int nq = min(kQ, Sq - q0);
    __syncthreads();
    load_tile<DP, kQ>(q_s, qb, q.s, 0, q0, nq, D);
    load_tile<DP, kQ>(do_s, gb, g.s, 0, q0, nq, D);
    for (int i = threadIdx.x; i < kQ; i += kThreads) {
      lse_s[i] = i < nq ? lse[bh * Sq + q0 + i] : 0.f;
      d_s[i] = i < nq ? delta[bh * Sq + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int qs = 0; qs < kQ; qs += kSub) {
      // warp-uniform: every query of the half is past Sq, or (causal)
      // before the warp's first key
      const bool skip = warp_idle || q0 + qs >= Sq ||
                        (causal && q0 + qs + kSub - 1 < warp_k0);
      if (skip) {
        if (kDQ)  // its dS^T is 0
          for (int i = lane; i < 16 * kSub / 2; i += 32)
            *reinterpret_cast<uint32_t*>(
                ds_s + (warp * 16 + i / (kSub / 2)) * kDsPitch + qs +
                2 * (i % (kSub / 2))) = 0u;
        continue;
      }
      // P^T: element j of s[n] is (key key_lo + 8 (j / 2), query qs + 8n +
      // 2 (lane % 4) + j % 2 of the tile)
      float s[NT][4];
      score_tile_s<DP, NT>(s, kw_s, q_s + qs * kPitch, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = key_lo + 8 * (j >> 1);
          const int qq = qs + 8 * n + 2 * (lane & 3) + (j & 1);
          const bool ok = key < Sk && q0 + qq < Sq &&
                          (!causal || key <= q0 + qq);
          s[n][j] = ok ? expf(s[n][j] * scale - lse_s[qq]) : 0.f;
        }
      // the keep multipliers M^T of the half: dV from P^T M^T, dS^T from
      // dP^T M^T
      float keep[NT][4];
      if (kDrop)
#pragma unroll
        for (int n = 0; n < NT; n += 2)
          drop.quad_t2(keep[n], keep[n + 1], bh,
                       q0 + qs + 8 * n + 2 * (lane & 3), key_lo);
      // dV += bf16(P^T M^T) dO
      uint32_t a[NT / 2][4];
      if (kDrop) {
        float pd[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) pd[n][j] = s[n][j] * keep[n][j];
        to_a_frags<NT>(a, pd);
      } else {
        to_a_frags<NT>(a, s);
      }
      mma_rows<DP, NT / 2>(dva, a, do_s + qs * kPitch, lane);
      // dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale, dK += bf16(dS^T) Q
      float dp[NT][4];
      score_tile_s<DP, NT>(dp, vw_s, do_s + qs * kPitch, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qq = qs + 8 * n + 2 * (lane & 3) + (j & 1);
          const float dpm = kDrop ? dp[n][j] * keep[n][j] : dp[n][j];
          dp[n][j] = s[n][j] * (dpm - d_s[qq]) * scale;
        }
      to_a_frags<NT>(a, dp);
      mma_rows<DP, NT / 2>(dka, a, q_s + qs * kPitch, lane);
      if (kDQ)
#pragma unroll
        for (int kc = 0; kc < NT / 2; ++kc)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = warp * 16 + (lane >> 2) + 8 * (i & 1);
            const int qq = qs + 16 * kc + 8 * (i >> 1) + 2 * (lane & 3);
            *reinterpret_cast<uint32_t*>(ds_s + key * kDsPitch + qq) =
                a[kc][i];
          }
    }
    if (kDQ) {
      // dQ of the tile's 64 queries, 16 a warp: dS (from the staged dS^T,
      // transposed by ldmatrix) times the block's keys
      __syncthreads();
      const int qw = warp * 16;
      if (q0 + qw < Sq) {  // warp-uniform
        uint32_t a[kK / 16][4];
#pragma unroll
        for (int kc = 0; kc < kK / 16; ++kc) {
          const int mat = lane >> 3;
          ldmatrix_x4_trans(a[kc], ds_s + (kc * 16 + (lane & 7) +
                                           (mat >> 1) * 8) * kDsPitch +
                                       qw + (mat & 1) * 8);
        }
        float dq[DP / 8][4];
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) dq[n][j] = 0.f;
        mma_rows<DP, kK / 16>(dq, a, k_s, lane);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = q0 + qw + (lane >> 2) + 8 * half;
          if (row >= Sq) continue;
          float* dst = dq_row(dq_acc, b, row, h, H, Sq, D);
#pragma unroll
          for (int n = 0; n < DP / 8; ++n) {
            const int d = 8 * n + 2 * (lane & 3);
            if (d < D) {
              atomicAdd(dst + d, dq[n][2 * half]);
              atomicAdd(dst + d + 1, dq[n][2 * half + 1]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_lo + 8 * half;
    if (key >= Sk) continue;
    bf16* dk_row = dk.head(b, h) + (long)key * dk.s;
    bf16* dv_row = dv.head(b, h) + (long)key * dv.s;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      if (d < D) {
        *reinterpret_cast<uint32_t*>(dk_row + d) =
            pack_bf16(dka[n][2 * half], dka[n][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(dv_row + d) =
            pack_bf16(dva[n][2 * half], dva[n][2 * half + 1]);
      }
    }
  }
}

// dQ of 64 queries (see the file's note).
template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
bwd_dq(View<const bf16> q, View<const bf16> k, View<const bf16> v,
       View<const bf16> g, const float* __restrict__ lse,
       const float* __restrict__ delta, View<bf16> dq, int H, int Sq, int Sk,
       int D, float scale, int causal, Dropout drop) {
  constexpr int kPitch = DP + 8, NT = kSub / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kQ][kPitch]
  bf16* do_s = q_s + kQ * kPitch;                  // [kQ][kPitch]
  bf16* k_s = do_s + kQ * kPitch;                  // [kK][kPitch]
  bf16* v_s = k_s + kK * kPitch;                   // [kK][kPitch]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long bh = (long)b * H + h;
  const bf16* kb = k.head(b, h);
  const bf16* vb = v.head(b, h);
  const int nq = min(kQ, Sq - q0);
  const int nk = causal ? min(Sk, q0 + kQ) : Sk;
  const int row_lo = q0 + warp * 16 + (lane >> 2);  // rows row_lo, row_lo + 8
  const int warp_last = q0 + warp * 16 + 15;
  const bool warp_idle = q0 + warp * 16 >= Sq;

  load_tile<DP, kQ>(q_s, q.head(b, h), q.s, 0, q0, nq, D);
  load_tile<DP, kQ>(do_s, g.head(b, h), g.s, 0, q0, nq, D);
  const bf16* qw_s = q_s + warp * 16 * kPitch;
  const bf16* dow_s = do_s + warp * 16 * kPitch;
  float lse_r[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    lse_r[half] = row < Sq ? lse[bh * Sq + row] : 0.f;
    dl[half] = row < Sq ? delta[bh * Sq + row] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  for (int t0 = 0; t0 < nk; t0 += kK) {
    const int nt = min(kK, nk - t0);
    __syncthreads();
    load_tile<DP, kK>(k_s, kb, k.s, 0, t0, nt, D);
    load_tile<DP, kK>(v_s, vb, v.s, 0, t0, nt, D);
    __syncthreads();
#pragma unroll
    for (int hk = 0; hk < kK; hk += kSub) {
      const int t = t0 + hk;
      // warp-uniform: keys [t, t + kSub) hold nothing the warp's rows see
      if (warp_idle || t >= nk || (causal && t > warp_last)) continue;
      float s[NT][4], dp[NT][4];
      score_tile_s<DP, NT>(s, qw_s, k_s + hk * kPitch, lane);
      score_tile_s<DP, NT>(dp, dow_s, v_s + hk * kPitch, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float keep[4] = {1.f, 1.f, 1.f, 1.f};
        if (kDrop)  // dS from dP M
          drop.quad(keep, bh, row_lo, t + 8 * n + 2 * (lane & 3));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = t + 8 * n + 2 * (lane & 3) + (j & 1);
          const int half = j >> 1;
          const bool ok = key < Sk && (!causal || key <= row_lo + 8 * half);
          const float p = ok ? expf(s[n][j] * scale - lse_r[half]) : 0.f;
          dp[n][j] = p * (dp[n][j] * keep[j] - dl[half]) * scale;
        }
      }
      uint32_t a[NT / 2][4];
      to_a_frags<NT>(a, dp);
      mma_rows<DP, NT / 2>(acc, a, k_s + hk * kPitch, lane);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row >= Sq) continue;
    bf16* dst = dq.head(b, h) + (long)row * dq.s;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      if (d < D)
        *reinterpret_cast<uint32_t*>(dst + d) =
            pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

}  // namespace tc

// ----------------------------------------------------------------------------
// The bf16 fused backward at D = 64 and D = 128 on wgmma (sm90.cuh)
namespace hop {

using namespace mct::sm90;
constexpr int kKeys = 128;  // keys of a block: two consumer warpgroups of 64
constexpr int kThreads = 256;
constexpr int kPanel = kKeys * kRowBytes;  // a [128][64] bf16 panel
constexpr int kDqBox = 64 * kRowBytes;     // a [64][32] fp32 dQ box: 8 KB

// Shared memory of the block (byte offsets, panels 1024-aligned): K and V
// [128 keys][D]; two ring stages of Q and dO [kQ][D]; dS^T [128][kQ]; the
// fp32 dQ tiles of the two warpgroups, [64 queries][64 columns] as two
// swizzled [64][32] boxes each; two stages of lse and delta [kQ]; the
// mbarriers (K and V, each stage).
template <int D>
struct Tile {
  static constexpr int kQ = D == 64 ? 128 : 64;  // queries of a tile
  // P^T staged in shared memory for dV (at D = 64, where a thread holds
  // 128 scores and the register A operand's 32 registers spill), else
  // dV's A operand from registers
  static constexpr bool kPSmem = D == 64;
  static constexpr int kP = D / 64;              // 64-column panels of a row
  static constexpr int kQPanel = kQ * kRowBytes;
  static constexpr int kQStage = kP * kQPanel;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kP * kPanel;
  static constexpr int kQs = kV + kP * kPanel;
  static constexpr int kDO = kQs + 2 * kQStage;
  static constexpr int kDS = kDO + 2 * kQStage;
  static constexpr int kPT = kDS + (kQ / 64) * kPanel;
  static constexpr int kDQ = kPT + (kPSmem ? (kQ / 64) * kPanel : 0);
  // lse and delta: kQ + 4 floats a stage (the box starts 16-byte aligned,
  // up to 3 floats before the tile), stages 128-byte aligned
  static constexpr int kRowBox = kQ + 4;
  static constexpr int kRowStage = kQ * 4 + 128;
  static constexpr int kLse = kDQ + 2 * 2 * kDqBox;
  static constexpr int kDelta = kLse + 2 * kRowStage;
  static constexpr int kBars = kDelta + 2 * kRowStage;
  static constexpr int kSmem = 1024 + kBars + 3 * 8;
};

struct Maps {
  CUtensorMap q, k, v, g, lse, delta, dq;
};

struct Args {
  View<bf16> dk, dv;
  float* dq_acc;
  int H, Sq, Sk, causal;
  // the map dimensions (1..3) of the sequence, head and batch axes of q, k,
  // v and dO: bits 0-1, 2-3 and 4-5 (view_map)
  int perm_q, perm_k, perm_v, perm_g;
  float scale;
};

// Columns [col, col + 64) of rows [s, s + box rows) of head (b, h) of a
// view's map into a panel.
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* m,
                                          uint64_t* bar, int perm, int col,
                                          int s, int h, int b) {
  const int ps = perm & 3, ph = (perm >> 2) & 3;
  const int c1 = ps == 1 ? s : ph == 1 ? h : b;
  const int c2 = ps == 2 ? s : ph == 2 ? h : b;
  const int c3 = ps == 3 ? s : ph == 3 ? h : b;
  tma_load_4d(dst, m, bar, col, c1, c2, c3);
}

// Barrier `id` (1, 2) of the 128 threads of one warpgroup.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// dK and dV of 128 keys and their share of dQ (see the file's note).
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
bwd_fused(const __grid_constant__ Maps maps, const Args g, Dropout drop) {
  using L = Tile<D>;
  constexpr int kQ = L::kQ, kP = L::kP;
  extern __shared__ __align__(1024) unsigned char fa_smem[];
  unsigned char* base = align_1024(fa_smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBars);
  const float* lse_s = reinterpret_cast<const float*>(base + L::kLse);
  const float* dl_s = reinterpret_cast<const float*>(base + L::kDelta);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kKeys;
  const long bh = (long)b * g.H + h;
  // causal: no query before the block's first key attends to its keys
  const int jt0 = g.causal ? k0 / kQ : 0;
  const int ntiles = (g.Sq + kQ - 1) / kQ - jt0;

  // thread 0: query tile jt0 + i (Q, dO, lse, delta) into stage i & 1
  auto issue = [&](int i) {
    const int st = i & 1, q0 = (jt0 + i) * kQ;
    uint64_t* bar = bars + 1 + st;
    mbar_expect_tx(bar, 2 * L::kQStage + 2 * L::kRowBox * 4);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      load_rows(base + L::kQs + st * L::kQStage + p * L::kQPanel, &maps.q,
                bar, g.perm_q, 64 * p, q0, h, b);
      load_rows(base + L::kDO + st * L::kQStage + p * L::kQPanel, &maps.g,
                bar, g.perm_g, 64 * p, q0, h, b);
    }
    const int row0 = (int)(bh * g.Sq + q0) & ~3;
    tma_load_1d(base + L::kLse + st * L::kRowStage, &maps.lse, bar, row0);
    tma_load_1d(base + L::kDelta + st * L::kRowStage, &maps.delta, bar,
                row0);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, 2 * kP * kPanel);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      load_rows(base + L::kK + p * kPanel, &maps.k, bars, g.perm_k, 64 * p,
                k0, h, b);
      load_rows(base + L::kV + p * kPanel, &maps.v, bars, g.perm_v, 64 * p,
                k0, h, b);
    }
    if (ntiles > 0) issue(0);
  }
  __syncwarp();

  // element 4 j + e of an S^T-shaped accumulator: key key_lo + 8 (e >> 1),
  // query q0 + 8 j + 2 (lane % 4) + (e & 1)
  const int key_lo = k0 + 64 * wg + 16 * warp + (lane >> 2);
  const unsigned char* k_w = base + L::kK + wg * 8192;  // the WG's 64 keys
  const unsigned char* v_w = base + L::kV + wg * 8192;
  float dk[D / 2], dv[D / 2], s[kQ / 2], dp[kQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kQ / 2; ++i) s[i] = dp[i] = 0.f;
  unsigned char* dq_stage = base + L::kDQ + wg * 2 * kDqBox;
  const bool dq_issuer = (tid & 127) == 0;
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale_log2 = g.scale * kLog2e;
  mbar_wait(bars, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i & 1, q0 = (jt0 + i) * kQ;
    if (i > 0) __syncthreads();  // tile i - 1 is done: its stage, dS^T
    if (tid == 0 && i + 1 < ntiles) issue(i + 1);
    __syncwarp();
    mbar_wait(bars + 1 + st, (i >> 1) & 1);
    __syncwarp();
    const unsigned char* q_s = base + L::kQs + st * L::kQStage;
    const unsigned char* g_s = base + L::kDO + st * L::kQStage;
    // the tile's lse and delta, from the box's 16-byte aligned start
    const int off = (int)(bh * g.Sq + q0) & 3;
    const float* ls = lse_s + st * L::kRowStage / 4 + off;
    const float* dl = dl_s + st * L::kRowStage / 4 + off;

    // S^T = K Q^T and dP^T = V dO^T
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(s, desc_k(k_w + (kk >> 2) * kPanel, kk & 3),
                     desc_k(q_s + (kk >> 2) * L::kQPanel, kk & 3), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(dp, desc_k(v_w + (kk >> 2) * kPanel, kk & 3),
                     desc_k(g_s + (kk >> 2) * L::kQPanel, kk & 3), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T (times the keep multipliers M^T) rounded into the A fragments of
    // k-step m (queries 16 m ..: accumulator chunks 2 m and 2 m + 1), and
    // dS^T = P^T (dP^T M^T - delta) scale rounded into shared memory, key
    // row 64 wg + 16 warp + lane / 4 + 8 (e >> 1), query 16 m + 8 c +
    // 2 (lane % 4) + (e & 1) of chunk 2 m + c. P = exp(s scale - lse) as
    // exp2(s scale log2(e) - lse log2(e)), one FMA and the MUFU's exp2; the
    // masks are tested only in the tiles that cross the warp's causal
    // diagonal or the sequences' ends (warp-uniform).
    const bool interior = key_lo - (lane >> 2) + 15 < g.Sk &&
                          q0 + kQ <= g.Sq &&
                          (!g.causal || key_lo - (lane >> 2) + 15 <= q0);
    uint32_t pa[kQ / 16][4];
    unsigned char* ds_s = base + L::kDS;
    unsigned char* pt_s = base + L::kPT;
#pragma unroll
    for (int m = 0; m < kQ / 16; ++m) {
      // lanes l and l ^ 4 hold keys key_lo and key_lo ^ 1 and share their
      // Philox calls at D = 128; at D = 64, whose tiles hold twice the
      // scores a thread, the trade's live registers spill, so each lane
      // draws its own
      const int qm = q0 + 16 * m + 2 * (lane & 3);
      const uint32_t kept =
          !kDrop      ? 0xffu
          : D == 128  ? drop.bits_t2_pair(bh, qm, key_lo, 4)
                      : drop.bits_t2(bh, qm, key_lo);
      float pv[8], dsv[8];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * (2 * m + c) + e;
          const int key = key_lo + 8 * (e >> 1);
          const int ql = 16 * m + 8 * c + 2 * (lane & 3) + (e & 1);
          float p = exp2f(fmaf(s[idx], scale_log2, -ls[ql] * kLog2e));
          if (!interior) {
            const int q = q0 + ql;
            if (!(key < g.Sk && q < g.Sq && (!g.causal || key <= q))) p = 0.f;
          }
          const float keep =
              !kDrop ? 1.f : (kept >> (4 * c + e)) & 1 ? drop.mult : 0.f;
          pv[4 * c + e] = p * keep;
          dsv[4 * c + e] = p * (dp[idx] * keep - dl[ql]) * g.scale;
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // i: chunk 2 m + (i >> 1), rows + 8 (i & 1)
        const int e = 2 * (i & 1);
        const int c = i >> 1;
        const int row = 64 * wg + 16 * warp + (lane >> 2) + 8 * (i & 1);
        const int col = 16 * m + 8 * c + 2 * (lane & 3);
        const int at = (col >> 6) * kPanel + swz(row, col & 63);
        const uint32_t pp = pack_bf16(pv[4 * c + e], pv[4 * c + e + 1]);
        if (L::kPSmem)
          *reinterpret_cast<uint32_t*>(pt_s + at) = pp;
        else
          pa[m][i] = pp;
        *reinterpret_cast<uint32_t*>(ds_s + at) =
            pack_bf16(dsv[4 * c + e], dsv[4 * c + e + 1]);
      }
    }

    // dV += bf16(P^T M^T) dO: A from registers, B the stage's MN-major dO
    if constexpr (!L::kPSmem) {
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < kQ / 16; ++m)
        wgmma_rs<1>(dv, pa[m], desc_mn(g_s, m, L::kQPanel), 1);
      wgmma_commit();
    }
    fence_async_smem();
    __syncthreads();  // dS^T (and P^T) of both warpgroups

    // dQ: at D = 64 warpgroup wg takes queries 64 wg .. (its dS panel),
    // every column; at D = 128 every query, columns 64 wg .. (its K panel)
    // and dK += bf16(dS^T) Q: A the WG's 64 key rows of dS^T (K-major), B
    // the stage's MN-major Q
    float dq[32];
    fence_regs(dq);
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
    if constexpr (L::kPSmem)  // dV += bf16(P^T M^T) dO from shared memory
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        wgmma_ss<0, 1>(dv,
                       desc_k(pt_s + (kk >> 2) * kPanel + wg * 8192, kk & 3),
                       desc_mn(g_s, kk, L::kQPanel), 1);
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
      wgmma_ss<0, 1>(dk,
                     desc_k(ds_s + (kk >> 2) * kPanel + wg * 8192, kk & 3),
                     desc_mn(q_s, kk, L::kQPanel), 1);
    const unsigned char* a_p = ds_s + (D == 64 ? wg * kPanel : 0);
    const unsigned char* b_p = base + L::kK + (D == 64 ? 0 : wg * kPanel);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_ss<1, 1>(dq, desc_mn(a_p, kk, kPanel), desc_mn(b_p, kk, kPanel),
                     kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dv);
    fence_regs(dk);
    if constexpr (!L::kPSmem) fence_regs(pa);

    // the fp32 partial of dQ staged in the warpgroup's two boxes, then
    // added into dq_acc by two TMA reduce-adds (rows past Sq left out)
    if (dq_issuer) bulk_wait_read<0>();  // the last tile's boxes are read
    named_sync(1 + wg);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * warp + (lane >> 2) + 8 * half;
        const int c = 8 * (j & 3) + 2 * (lane & 3);  // column in the box
        *reinterpret_cast<float2*>(dq_stage + (j >> 2) * kDqBox +
                                   row * kRowBytes +
                                   ((((c >> 2) ^ (row & 7))) << 4) +
                                   (c & 3) * 4) =
            make_float2(dq[4 * j + 2 * half], dq[4 * j + 2 * half + 1]);
      }
    fence_async_smem();
    named_sync(1 + wg);
    if (dq_issuer) {
      const int q = q0 + (D == 64 ? 64 * wg : 0);
      const int col = D == 64 ? 0 : 64 * wg;
      tma_reduce_add_4d(&maps.dq, dq_stage, col, h, q, b);
      tma_reduce_add_4d(&maps.dq, dq_stage + kDqBox, col + 32, h, q, b);
      bulk_commit();
    }
  }
  if (dq_issuer) bulk_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_lo + 8 * half;
    if (key >= g.Sk) continue;
    bf16* dk_row = g.dk.head(b, h) + (long)key * g.dk.s;
    bf16* dv_row = g.dv.head(b, h) + (long)key * g.dv.s;
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

// A 4-D map of a [B, H, S, D] view (D contiguous, strides in elements),
// its other axes in the order of their strides, boxes of 64 columns x
// `rows` of one head; perm receives the map dimensions of (s, h, b).
inline bool view_map(CUtensorMap* m, int& perm, const void* p, long sb,
                     long sh, long ss, int B, int H, int S, int D, int rows) {
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
  const uint32_t box[4] = {64, (uint32_t)ax[0].box, (uint32_t)ax[1].box,
                           (uint32_t)ax[2].box};
  perm = 0;
  for (int i = 0; i < 3; ++i) perm |= (i + 1) << (2 * ax[i].id);
  return make_map(m, true, true, 4, p, dims, strides, box);
}

template <int D, bool kDrop>
cudaError_t launch_as(const Maps& maps, const Args& a, int B, Dropout drop,
                      cudaStream_t st) {
  constexpr int kSmem = Tile<D>::kSmem;
  const cudaError_t e = allow_smem(bwd_fused<D, kDrop>, kSmem);
  if (e != cudaSuccess) return e;
  bwd_fused<D, kDrop>
      <<<dim3((a.Sk + kKeys - 1) / kKeys, a.H, B), kThreads, kSmem, st>>>(
          maps, a, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(View<const bf16> q, View<const bf16> k, View<const bf16> v,
                   View<const bf16> g, const float* lse, const float* delta,
                   View<bf16> dk, View<bf16> dv, float* dq_acc, int B, int H,
                   int Sq, int Sk, float scale, int causal,
                   const Dropout* drop, cudaStream_t st) {
  constexpr int kQ = Tile<D>::kQ;
  Maps maps;
  Args a{dk, dv, dq_acc, H, Sq, Sk, causal, 0, 0, 0, 0, scale};
  const uint64_t rows[1] = {(uint64_t)B * H * Sq};
  // dq_acc [B, Sq, H, D] fp32 as {D, H, Sq, B}, boxes of 32 columns (128
  // bytes, swizzled) x 64 queries of one head
  const uint64_t dq_dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)Sq,
                               (uint64_t)B};
  const uint64_t dq_strides[3] = {(uint64_t)D * 4, (uint64_t)H * D * 4,
                                  (uint64_t)Sq * H * D * 4};
  const uint32_t dq_box[4] = {32, 1, 64, 1};
  const uint32_t box[1] = {Tile<D>::kRowBox};
  if (!view_map(&maps.q, a.perm_q, q.p, q.b, q.h, q.s, B, H, Sq, D, kQ) ||
      !view_map(&maps.k, a.perm_k, k.p, k.b, k.h, k.s, B, H, Sk, D, kKeys) ||
      !view_map(&maps.v, a.perm_v, v.p, v.b, v.h, v.s, B, H, Sk, D, kKeys) ||
      !view_map(&maps.g, a.perm_g, g.p, g.b, g.h, g.s, B, H, Sq, D, kQ) ||
      !make_map(&maps.lse, false, false, 1, lse, rows, nullptr, box) ||
      !make_map(&maps.delta, false, false, 1, delta, rows, nullptr, box) ||
      !make_map(&maps.dq, false, true, 4, dq_acc, dq_dims, dq_strides,
                dq_box))
    return cudaErrorInvalidValue;
  return drop ? launch_as<D, true>(maps, a, B, *drop, st)
              : launch_as<D, false>(maps, a, B, Dropout{}, st);
}

}  // namespace hop

namespace tc {

template <int DP, bool kDrop>
cudaError_t launch_fwd_as(View<const bf16> q, View<const bf16> k,
                          View<const bf16> v, View<bf16> o, float* lse, int B,
                          int H, int Sq, int Sk, int D, float scale,
                          int causal, Dropout drop, cudaStream_t st) {
  constexpr int kSmem = fwd_smem_bytes(DP);
  const cudaError_t e = allow_smem(fwd<DP, kDrop>, kSmem);
  if (e != cudaSuccess) return e;
  fwd<DP, kDrop><<<dim3((Sq + kQ - 1) / kQ, H, B), kThreads, kSmem, st>>>(
      q, k, v, o, lse, H, Sq, Sk, D, scale, causal, drop);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_fwd(View<const bf16> q, View<const bf16> k,
                       View<const bf16> v, View<bf16> o, float* lse, int B,
                       int H, int Sq, int Sk, int D, float scale, int causal,
                       const Dropout* drop, cudaStream_t st) {
  return drop ? launch_fwd_as<DP, true>(q, k, v, o, lse, B, H, Sq, Sk, D,
                                        scale, causal, *drop, st)
              : launch_fwd_as<DP, false>(q, k, v, o, lse, B, H, Sq, Sk, D,
                                         scale, causal, Dropout{}, st);
}

template <int DP, bool kDQ, bool kDrop>
cudaError_t launch_kv_as(View<const bf16> q, View<const bf16> k,
                         View<const bf16> v, View<const bf16> g,
                         const float* lse, const float* delta, View<bf16> dk,
                         View<bf16> dv, float* dq_acc, int B, int H, int Sq,
                         int Sk, int D, float scale, int causal, Dropout drop,
                         cudaStream_t st) {
  constexpr int kSmem = kv_smem_bytes(DP, kDQ);
  const cudaError_t e = allow_smem(bwd_kv<DP, kDQ, kDrop>, kSmem);
  if (e != cudaSuccess) return e;
  bwd_kv<DP, kDQ, kDrop>
      <<<dim3((Sk + kK - 1) / kK, H, B), kThreads, kSmem, st>>>(
          q, k, v, g, lse, delta, dk, dv, dq_acc, H, Sq, Sk, D, scale, causal,
          drop);
  return cudaGetLastError();
}

template <int DP, bool kDQ>
cudaError_t launch_kv(View<const bf16> q, View<const bf16> k,
                      View<const bf16> v, View<const bf16> g,
                      const float* lse, const float* delta, View<bf16> dk,
                      View<bf16> dv, float* dq_acc, int B, int H, int Sq,
                      int Sk, int D, float scale, int causal,
                      const Dropout* drop, cudaStream_t st) {
  return drop ? launch_kv_as<DP, kDQ, true>(q, k, v, g, lse, delta, dk, dv,
                                            dq_acc, B, H, Sq, Sk, D, scale,
                                            causal, *drop, st)
              : launch_kv_as<DP, kDQ, false>(q, k, v, g, lse, delta, dk, dv,
                                             dq_acc, B, H, Sq, Sk, D, scale,
                                             causal, Dropout{}, st);
}

// The fused backward: hop:: on wgmma at D = 64 and D = 128, bwd_kv with
// kDQ at every other D.
template <int DP>
cudaError_t launch_fused(View<const bf16> q, View<const bf16> k,
                         View<const bf16> v, View<const bf16> g,
                         const float* lse, const float* delta, View<bf16> dk,
                         View<bf16> dv, float* dq_acc, int B, int H, int Sq,
                         int Sk, int D, float scale, int causal,
                         const Dropout* drop, cudaStream_t st) {
  if constexpr (DP == 64 || DP == 128)
    if (D == DP)
      return hop::launch<DP>(q, k, v, g, lse, delta, dk, dv, dq_acc, B, H, Sq,
                             Sk, scale, causal, drop, st);
  return launch_kv<DP, true>(q, k, v, g, lse, delta, dk, dv, dq_acc, B, H, Sq,
                             Sk, D, scale, causal, drop, st);
}

template <int DP>
cudaError_t launch_dkv(View<const bf16> q, View<const bf16> k,
                       View<const bf16> v, View<const bf16> g,
                       const float* lse, const float* delta, View<bf16> dk,
                       View<bf16> dv, float* dq_acc, int B, int H, int Sq,
                       int Sk, int D, float scale, int causal,
                       const Dropout* drop, cudaStream_t st) {
  return launch_kv<DP, false>(q, k, v, g, lse, delta, dk, dv, dq_acc, B, H,
                              Sq, Sk, D, scale, causal, drop, st);
}

template <int DP, bool kDrop>
cudaError_t launch_dq_as(View<const bf16> q, View<const bf16> k,
                         View<const bf16> v, View<const bf16> g,
                         const float* lse, const float* delta, View<bf16> dq,
                         int B, int H, int Sq, int Sk, int D, float scale,
                         int causal, Dropout drop, cudaStream_t st) {
  constexpr int kSmem = dq_smem_bytes(DP);
  const cudaError_t e = allow_smem(bwd_dq<DP, kDrop>, kSmem);
  if (e != cudaSuccess) return e;
  bwd_dq<DP, kDrop><<<dim3((Sq + kQ - 1) / kQ, H, B), kThreads, kSmem, st>>>(
      q, k, v, g, lse, delta, dq, H, Sq, Sk, D, scale, causal, drop);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(View<const bf16> q, View<const bf16> k,
                      View<const bf16> v, View<const bf16> g,
                      const float* lse, const float* delta, View<bf16> dq,
                      int B, int H, int Sq, int Sk, int D, float scale,
                      int causal, const Dropout* drop, cudaStream_t st) {
  return drop ? launch_dq_as<DP, true>(q, k, v, g, lse, delta, dq, B, H, Sq,
                                       Sk, D, scale, causal, *drop, st)
              : launch_dq_as<DP, false>(q, k, v, g, lse, delta, dq, B, H, Sq,
                                        Sk, D, scale, causal, Dropout{}, st);
}

cudaError_t dispatch_fwd(View<const bf16> q, View<const bf16> k,
                         View<const bf16> v, View<bf16> o, float* lse, int B,
                         int H, int Sq, int Sk, int D, float scale, int causal,
                         const Dropout* drop, cudaStream_t st) {
  MCT_TC_DISPATCH(launch_fwd, D, q, k, v, o, lse, B, H, Sq, Sk, D, scale,
                  causal, drop, st)
}

cudaError_t dispatch_fused(View<const bf16> q, View<const bf16> k,
                           View<const bf16> v, View<const bf16> g,
                           const float* lse, const float* delta,
                           View<bf16> dk, View<bf16> dv, float* dq_acc, int B,
                           int H, int Sq, int Sk, int D, float scale,
                           int causal, const Dropout* drop, cudaStream_t st) {
  MCT_TC_DISPATCH(launch_fused, D, q, k, v, g, lse, delta, dk, dv, dq_acc, B,
                  H, Sq, Sk, D, scale, causal, drop, st)
}

cudaError_t dispatch_dkv(View<const bf16> q, View<const bf16> k,
                         View<const bf16> v, View<const bf16> g,
                         const float* lse, const float* delta, View<bf16> dk,
                         View<bf16> dv, int B, int H, int Sq, int Sk, int D,
                         float scale, int causal, const Dropout* drop,
                         cudaStream_t st) {
  MCT_TC_DISPATCH(launch_dkv, D, q, k, v, g, lse, delta, dk, dv, nullptr, B,
                  H, Sq, Sk, D, scale, causal, drop, st)
}

cudaError_t dispatch_dq(View<const bf16> q, View<const bf16> k,
                        View<const bf16> v, View<const bf16> g,
                        const float* lse, const float* delta, View<bf16> dq,
                        int B, int H, int Sq, int Sk, int D, float scale,
                        int causal, const Dropout* drop, cudaStream_t st) {
  MCT_TC_DISPATCH(launch_dq, D, q, k, v, g, lse, delta, dq, B, H, Sq, Sk, D,
                  scale, causal, drop, st)
}

}  // namespace tc

bool valid_shape(int B, int H, int Sq, int Sk, int D) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && Sq >= 1 &&
         Sk >= 1 && D >= 1 && D <= kMaxD;
}

template <typename T>
View<T> view(const void* p, long long b, long long h, long long s) {
  return View<T>{static_cast<T*>(const_cast<void*>(p)), (long)b, (long)h,
                 (long)s};
}

// Whether the bf16 operands take the tensor-core kernels.
bool use_tc(int D, std::initializer_list<const void*> ptrs,
            std::initializer_list<long long> strides) {
  if (!mct::tc::eligible(D, ptrs, {})) return false;
  for (long long s : strides)
    if (s % 8 != 0) return false;
  return true;
}

using bf16 = __nv_bfloat16;

}  // namespace

// Each operand is a pointer and the element strides of its batch, head and
// sequence axes (D contiguous); lse, delta [B, H, Sq] fp32 contiguous. With
// `drop` the kernels drop attention probabilities as philox.cuh draws them
// (seed, offset, threshold; a kept probability times `mult`); without it
// they are the rate-0 kernels. Each function launches on `stream` and
// returns the launch's cudaError_t (0 on success).
#define MCT_VIEW_ARGS(x) \
  const void *x, long long x##_b, long long x##_h, long long x##_s
#define MCT_VIEW(T, x) view<T>(x, x##_b, x##_h, x##_s)
#define MCT_STRIDES(x) x##_b, x##_h, x##_s
#define MCT_DROP_ARGS                                                  \
  int drop, unsigned long long seed, unsigned int offset,              \
      unsigned int threshold, float mult
#define MCT_DROP                                                        \
  const Dropout drop_args{(uint32_t)seed, (uint32_t)(seed >> 32), offset, \
                          threshold, mult};                              \
  const Dropout* dr = drop ? &drop_args : nullptr

// Forward: out and lse.
extern "C" int mct_flash_fwd(MCT_VIEW_ARGS(q), MCT_VIEW_ARGS(k),
                             MCT_VIEW_ARGS(v), MCT_VIEW_ARGS(o), void* lse,
                             int B, int H, int Sq, int Sk, int D, float scale,
                             int causal, int dtype, MCT_DROP_ARGS,
                             void* stream) {
  if (!valid_shape(B, H, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  MCT_DROP;
  if (dtype == mct::kFloat32)
    return (int)simt::launch_fwd<float>(
        MCT_VIEW(const float, q), MCT_VIEW(const float, k),
        MCT_VIEW(const float, v), MCT_VIEW(float, o), l, B, H, Sq, Sk, D,
        scale, causal, dr, st);
  if (dtype != mct::kBFloat16) return (int)cudaErrorInvalidValue;
  if (use_tc(D, {q, k, v, o},
             {MCT_STRIDES(q), MCT_STRIDES(k), MCT_STRIDES(v), MCT_STRIDES(o)}))
    return (int)tc::dispatch_fwd(MCT_VIEW(const bf16, q),
                                 MCT_VIEW(const bf16, k),
                                 MCT_VIEW(const bf16, v), MCT_VIEW(bf16, o), l,
                                 B, H, Sq, Sk, D, scale, causal, dr, st);
  return (int)simt::launch_fwd<bf16>(
      MCT_VIEW(const bf16, q), MCT_VIEW(const bf16, k),
      MCT_VIEW(const bf16, v), MCT_VIEW(bf16, o), l, B, H, Sq, Sk, D, scale,
      causal, dr, st);
}

// Fused backward: dk and dv, and dQ added into dq_acc, an fp32 [B, Sq, H, D]
// buffer the caller has zeroed. One launch.
extern "C" int mct_flash_bwd_fused(MCT_VIEW_ARGS(q), MCT_VIEW_ARGS(k),
                                   MCT_VIEW_ARGS(v), MCT_VIEW_ARGS(g),
                                   const void* lse, const void* delta,
                                   MCT_VIEW_ARGS(dk), MCT_VIEW_ARGS(dv),
                                   void* dq_acc, int B, int H, int Sq, int Sk,
                                   int D, float scale, int causal, int dtype,
                                   MCT_DROP_ARGS, void* stream) {
  if (!valid_shape(B, H, Sq, Sk, D) || dq_acc == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  MCT_DROP;
  if (dtype == mct::kFloat32)
    return (int)simt::launch_kv<float, true>(
        MCT_VIEW(const float, q), MCT_VIEW(const float, k),
        MCT_VIEW(const float, v), MCT_VIEW(const float, g), l, dl,
        MCT_VIEW(float, dk), MCT_VIEW(float, dv), acc, B, H, Sq, Sk, D, scale,
        causal, dr, st);
  if (dtype != mct::kBFloat16) return (int)cudaErrorInvalidValue;
  if (use_tc(D, {q, k, v, g, dk, dv},
             {MCT_STRIDES(q), MCT_STRIDES(k), MCT_STRIDES(v), MCT_STRIDES(g),
              MCT_STRIDES(dk), MCT_STRIDES(dv)}))
    return (int)tc::dispatch_fused(
        MCT_VIEW(const bf16, q), MCT_VIEW(const bf16, k),
        MCT_VIEW(const bf16, v), MCT_VIEW(const bf16, g), l, dl,
        MCT_VIEW(bf16, dk), MCT_VIEW(bf16, dv), acc, B, H, Sq, Sk, D, scale,
        causal, dr, st);
  return (int)simt::launch_kv<bf16, true>(
      MCT_VIEW(const bf16, q), MCT_VIEW(const bf16, k),
      MCT_VIEW(const bf16, v), MCT_VIEW(const bf16, g), l, dl,
      MCT_VIEW(bf16, dk), MCT_VIEW(bf16, dv), acc, B, H, Sq, Sk, D, scale,
      causal, dr, st);
}

// Split backward, dQ: one launch, no atomics.
extern "C" int mct_flash_bwd_dq(MCT_VIEW_ARGS(q), MCT_VIEW_ARGS(k),
                                MCT_VIEW_ARGS(v), MCT_VIEW_ARGS(g),
                                const void* lse, const void* delta,
                                MCT_VIEW_ARGS(dq), int B, int H, int Sq,
                                int Sk, int D, float scale, int causal,
                                int dtype, MCT_DROP_ARGS, void* stream) {
  if (!valid_shape(B, H, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  MCT_DROP;
  if (dtype == mct::kFloat32)
    return (int)simt::launch_dq<float>(
        MCT_VIEW(const float, q), MCT_VIEW(const float, k),
        MCT_VIEW(const float, v), MCT_VIEW(const float, g), l, dl,
        MCT_VIEW(float, dq), B, H, Sq, Sk, D, scale, causal, dr, st);
  if (dtype != mct::kBFloat16) return (int)cudaErrorInvalidValue;
  if (use_tc(D, {q, k, v, g, dq},
             {MCT_STRIDES(q), MCT_STRIDES(k), MCT_STRIDES(v), MCT_STRIDES(g),
              MCT_STRIDES(dq)}))
    return (int)tc::dispatch_dq(MCT_VIEW(const bf16, q),
                                MCT_VIEW(const bf16, k),
                                MCT_VIEW(const bf16, v),
                                MCT_VIEW(const bf16, g), l, dl,
                                MCT_VIEW(bf16, dq), B, H, Sq, Sk, D, scale,
                                causal, dr, st);
  return (int)simt::launch_dq<bf16>(
      MCT_VIEW(const bf16, q), MCT_VIEW(const bf16, k),
      MCT_VIEW(const bf16, v), MCT_VIEW(const bf16, g), l, dl,
      MCT_VIEW(bf16, dq), B, H, Sq, Sk, D, scale, causal, dr, st);
}

// Split backward, dK and dV: one launch, no atomics.
extern "C" int mct_flash_bwd_dkv(MCT_VIEW_ARGS(q), MCT_VIEW_ARGS(k),
                                 MCT_VIEW_ARGS(v), MCT_VIEW_ARGS(g),
                                 const void* lse, const void* delta,
                                 MCT_VIEW_ARGS(dk), MCT_VIEW_ARGS(dv), int B,
                                 int H, int Sq, int Sk, int D, float scale,
                                 int causal, int dtype, MCT_DROP_ARGS,
                                 void* stream) {
  if (!valid_shape(B, H, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  MCT_DROP;
  if (dtype == mct::kFloat32)
    return (int)simt::launch_kv<float, false>(
        MCT_VIEW(const float, q), MCT_VIEW(const float, k),
        MCT_VIEW(const float, v), MCT_VIEW(const float, g), l, dl,
        MCT_VIEW(float, dk), MCT_VIEW(float, dv), nullptr, B, H, Sq, Sk, D,
        scale, causal, dr, st);
  if (dtype != mct::kBFloat16) return (int)cudaErrorInvalidValue;
  if (use_tc(D, {q, k, v, g, dk, dv},
             {MCT_STRIDES(q), MCT_STRIDES(k), MCT_STRIDES(v), MCT_STRIDES(g),
              MCT_STRIDES(dk), MCT_STRIDES(dv)}))
    return (int)tc::dispatch_dkv(
        MCT_VIEW(const bf16, q), MCT_VIEW(const bf16, k),
        MCT_VIEW(const bf16, v), MCT_VIEW(const bf16, g), l, dl,
        MCT_VIEW(bf16, dk), MCT_VIEW(bf16, dv), B, H, Sq, Sk, D, scale,
        causal, dr, st);
  return (int)simt::launch_kv<bf16, false>(
      MCT_VIEW(const bf16, q), MCT_VIEW(const bf16, k),
      MCT_VIEW(const bf16, v), MCT_VIEW(const bf16, g), l, dl,
      MCT_VIEW(bf16, dk), MCT_VIEW(bf16, dv), nullptr, B, H, Sq, Sk, D, scale,
      causal, dr, st);
}

// The keep bits the kernels above draw (philox.cuh).
MCT_DROPOUT_MASK_EXPORT

// One wgmma tile product per operand layout (sm90.cuh).
MCT_SM90_TILE_CHECK_EXPORT
