// Fused multi-head attention straight off the packed QKV GEMM output:
// forward (optionally writing the probabilities P, or each row's softmax
// statistics), backward from P, and backward recomputing P.
//
// Replaces the TPU kernels of megatron_clip_tpu/ops/pallas/fused_mha.py::
// fused_mha_packed: the forward _fwd_kernel (pallas_call in _fwd), the
// saved-P backward _bwd_kernel with its math in _bwd_head (pallas_call in
// _bwd) and the recompute backward _bwd_kernel_recompute (the same call
// under MCT_MHA_SAVE_PROBS=0), which ops/attention.multi_head_attention runs
// for every attention with S <= 1024, head_dim <= 128, no bias/rope/GQA:
// both CLIP towers (ViT S=50 or 257 full mask, text S=77 causal). Taking
// strides, the same kernels also stand for fused_mha_packed_sm's
// _fwd_kernel_sm and _bwd_kernel_sm (the S-major layout, whose backward
// recomputes P too): an [S, B, 3*H*D] tensor is a [B, S, 3*H*D] view with a
// batch stride of 3*H*D and a sequence stride of B*3*H*D.
//
// Contract. qkv [B, S, 3*H*D] fp32 or bf16 with contiguous rows, any batch
// and sequence strides (Pitch); out [B, S, H*D] in the same dtype, strided
// the same way. For head h the kernels read q at columns h*D, k at
// (H+h)*D and v at (2H+h)*D of each packed row, so no q/k/v split or head
// transpose is ever written to memory. Forward arithmetic follows the TPU
// kernel: fp32 scores, times D^-0.5 (the scale argument), causal mask
// row >= col (masked keys get probability exactly 0, as the -1e30 fill
// gives), fp32 softmax, probabilities rounded to the input dtype before
// P.V, fp32 accumulation, output rounded to the input dtype. With a probs
// buffer the forward also writes those rounded probabilities, P [B, H, S, S]
// (the TPU kernel's `pc`, in a [B, S, H*S] layout there; a residual, so the
// layout is this port's own), masked pairs as 0.
//
// The backward takes (qkv, dO [B, S, H*D], P) and writes dqkv [B, S, 3*H*D]
// with dq, dk and dv at q's, k's and v's columns, so the QKV GEMM's
// backward reads it as it is. Arithmetic of _bwd_head: dV = P^T dO with P as
// saved; dP = dO V^T in fp32; delta_i = sum_j dP_ij P_ij over every key of
// the row, with P as saved (not rowsum(dO * O), which equals it only in
// exact arithmetic); dS = P (dP - delta) scale rounded to the input dtype;
// dQ = dS K, dK = dS^T Q with fp32 accumulation; outputs rounded to the
// input dtype. Since P is 0 on every masked pair, the mask only bounds
// which tiles are visited.
//
// The recompute backward takes (qkv, dO, the forward's row statistics) and
// writes the same dqkv with the arithmetic of _bwd_kernel_recompute: P is
// formed again in fp32 from the scores, as exp(s * scale - m) / l with the
// max m and denominator l that the forward's pass 1 found and wrote
// ([2, B*H*S] fp32: m, then l), so P is the forward's own; delta and dS
// use that fp32 P, and only dV = bf16(P)^T dO takes P rounded to the input
// dtype. No [S, S] tensor is written or read. (The TPU kernel's residual is
// qkv alone: it recomputes the row max and sum inside its whole-row tile.)
//
// Dropout. With a Dropout argument the forward with row statistics and the
// recompute backward also stand for fused_mha_packed_dropout's
// _fwd_kernel_dropout and _bwd_kernel_dropout (pallas_calls in
// _fwd_dropout and _vjp_bwd_dropout), which multi_head_attention runs for
// attention dropout while dropout_kernel_eligible holds (GPT at S = 512,
// head_dim 128). The TPU kernels read a [B, H, S, S] mask of keep
// multipliers M from device memory, keep * (1 / (1 - rate)) rounded to the
// input dtype (1.109375 in bf16 at rate 0.1); here each kernel draws M from
// philox.cuh and no mask exists in memory. Arithmetic of the TPU kernels:
// the forward rounds P M (P the normalised fp32 probabilities) to the input
// dtype before P.V; the backward forms dP M, delta_i = sum_j (dP M)_ij P_ij,
// dS = P (dP M - delta) scale and dV = bf16(P M)^T dO.
//
// What bounds them. At CLIP shapes one (batch, head) of the forward moves
// S*4*D elements (q, k, v in, o out) plus S*S of P for 4*S*S*D FLOP, and the
// backward S*(3+1+3)*D elements plus S*S of P for 8*S*S*D FLOP: under
// 20 FLOP per byte in bf16, far below the ~295 FLOP/byte where an H100's
// bf16 tensor cores become the limit. So the floor is device-memory bytes
// (forward with P 141 MB, backward 230 MB for the ViT-B/32 vision tower at
// batch 384; the recompute backward, 10*S*S*D FLOP, 238 MB for ViT-L/14's
// vision tower at batch 64). Design for that: every qkv element is read from
// device memory by the blocks of its own (batch, head) only, and no [S, S]
// intermediate but P itself is written.
//
// Design. The TPU kernels hold whole S x S tiles of all heads in many MB of
// VMEM. A block here has at most 227 KB of shared memory, so the kernels
// are tiled over keys (forward, dQ) or queries (dK, dV). Past one key tile
// (and at S <= 128 where the one-pass kernel below does not run) the
// forward makes two passes over the key tiles: pass 1 finds each row's max and softmax
// denominator (online rescaling), pass 2 recomputes the scores, forms the
// normalised probabilities, rounds them exactly where the TPU kernel does,
// and accumulates P.V. A causal block stops at the key tile of its last row.
// Past S = 128 (and at S <= 128 where the one-pass backward below does not
// run) the backward is two kernels, so that no sum crosses blocks and no
// float atomics make dqkv differ from run to run: part 1 owns query rows,
// sums delta over all their key tiles and then accumulates dQ, and writes
// delta to a [B*H*S] fp32 scratch; part 2 owns keys and accumulates dK and
// dV over the query tiles (from its first key on, when causal), reading
// delta.
//
// - The forward in bf16 at S <= 128, D = 64 (every mode; the serving
//   forward, ViT-B/32's saved-P training, the text towers with row
//   statistics), replacing tc::fwd there: attn_short_sm90.cuh's one-pass
//   kernel. What bounds it is bytes (157 MB, 0.0470 ms at ViT-B/32's text
//   tower with P, B = 384: q, k, v and O once, P once); tc::fwd took 3.5x
//   that (0.1648 ms) with two passes over the keys (Q K^T and expf twice a
//   score, a divide a probability), two 64-row blocks a head at S = 77
//   (both reading K and V; the second loading K twice), P written as
//   unaligned 2-byte stores from the mma fragments and O as 4-byte ones.
//   The new kernel gives a whole head to one block: one TMA box each of q,
//   k and v (rows past S zero), scores once in registers, the exact row max
//   and sum by quad shuffles, one exp2 a score and a reciprocal a row; O
//   and P staged in shared memory and written in 16-byte stores; blocks
//   persistent over (batch, head) with a 2-stage ring, so the next head's
//   loads fly while this one computes. The two-pass wgmma mainloop below
//   lost at S = 77 (0.0803 ms against tc::'s 0.046-0.056 at ViT-L/14's text
//   tower, separate runs) because it kept the two passes and one 128-row
//   block of 384 threads per head with nothing to overlap its loads; this
//   one differs in the pass count, the block per head, the persistence
//   and the stores. Its products run on wgmma at S <= 64 and on mma.sync
//   past it (rows padded to 80 at S = 77; wgmma's 128 lost the A/B there,
//   PERF.md §6). The S-major views take it too (TMA reads strided rows;
//   bit-equal to the contiguous run). Dropout, fp32, other D and operands
//   TMA cannot read stay on tc:: / simt:: below.
// - Both backwards in bf16 at S <= 128, D = 64, without dropout (ViT-B/32's
//   training from saved P, the ViT-L/14 and ViT-H/14 text towers
//   recomputing P), replacing tc::'s pairs there: attn_short_bwd_sm90.cuh's
//   one-pass kernel, one template for both modes (they differ only in
//   where P comes from). What bounds it is bytes (248 MB, 0.0741 ms at
//   ViT-B/32's text tower, B = 384); tc::'s pairs took 4.2x-7.1x that
//   (0.2897 / 0.4351 ms at B/32's towers, PERF.md §6): two launches, K and
//   V read by both kernels, delta through a device-memory scratch, 4-byte
//   stores from the fragments. The one-pass kernel gives a head to one
//   persistent block: one launch, q, k, v and dO as TMA boxes and the saved
//   P as one bulk copy of its span's aligned bytes, delta a quad-shuffle sum
//   in registers, bf16(P) and dS staged in shared memory for dV = P^T dO
//   and dK = dS^T Q, dq, dk and dv out in 16-byte stores; no atomics.
//   Products on wgmma at S <= 64, mma.sync past it (that header's note has
//   the design and the A/B). route 1 asks for it, route 2 for tc::, and
//   mct_fused_mha_bwd_needs_delta tells the wrappers whether a call's
//   kernel keeps the delta scratch, so the choice lives here alone. Phase 6
//   of chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W): 0.0958 / 0.1020 ms at
//   ViT-B/32's towers from saved P (tc:: 0.2907 / 0.4379 in the same call,
//   SDPA's backward 0.2585 / 0.2602), 0.0325 / 0.0160 ms at the ViT-L/14 /
//   ViT-H/14 text towers recomputing P (tc:: 0.1006 / 0.0564).
// - The forward in bf16 at D = 64, 80 and 128 past S = 128 (ViT-L/14's
//   and ViT-H/14's vision towers, the pipeline GPT's S = 512 with dropout;
//   with row statistics on the recompute paths, with P or with neither
//   elsewhere): attn_fwd_sm90.cuh's warp-specialised wgmma kernel with the
//   two-pass softmax, one block per (128 rows, head, batch), K and V tiles
//   of 128 keys from TMA rings (K resident across both passes up to
//   S = 1024 at D = 64, 896 at D = 80 and 512 at D = 128; a row of 80 as a
//   64-column and a 16-column panel), the normalised P rounded to bf16 in
//   registers before P.V (that header's note has the design). One kernel
//   takes every mode there, so the saved-P and recompute modes give the
//   same output (phase 8 holds ViT-L/14's first loss equal in both).
//   Phase 6 of chip_smoke.py on the H100 (NVIDIA H100 80GB HBM3, 700 W),
//   with stats: 0.2162 ms at ViT-L/14's
//   B = 64, S = 257, D = 64 (tc::fwd 0.3462 before; SDPA 0.1175), 0.1963
//   and 0.2699 ms at the pipeline GPT's B = 32, S = 512, D = 128, causal,
//   rate 0 and 0.1 (tc::fwd 0.5637 and 0.6163; SDPA 0.1040 and 0.1859),
//   0.0992 ms at ViT-H/14's B = 24, S = 257, H = 16, D = 80 (tc::fwd
//   0.1646 before; SDPA 0.0646). Other D and operands TMA cannot read stay
//   on tc:: below.
// - tc:: (bf16, D a multiple of 8, 16-byte aligned rows): the saved-P
//   backward past S = 128 (ViT-L/14's vision tower, a comparison leg off
//   the main paths), and wherever the kernels above do not run: dropout at
//   S <= 128 (the forward and the recompute backward), D other than 64
//   there, operands TMA cannot read, and the A/Bs' route 2. One block per
//   (64 rows, head, batch), 4 warps of 16 rows. Tiles of 64 rows are
//   staged in shared memory with 16-byte loads (rows padded by 16 bytes so
//   ldmatrix is conflict-free), and every
//   product runs on the tensor cores as mma.sync m16n8k16 bf16 with fp32
//   accumulation. In the forward the score accumulators become P's
//   A-operand fragments in registers (rounded to bf16 there); pass 2 walks
//   each key tile in halves of 32 keys and takes Q's fragments from shared
//   memory, which keeps it at 128 registers at D = 64 (faster at S = 257
//   than holding Q's fragments and whole tiles, PERF.md, and the same
//   P, statistics and output bit for bit). In the saved-P
//   backward dS is formed in the dP accumulators the same way, and P^T
//   comes from a staged P tile. When one tile holds all the keys a block
//   sees (S <= 64, and the first query tile of a causal S <= 128) K and V
//   are loaded once: at S = 50 a block reads its head's q, k and v once.
//   Warps whose rows all lie past S only help load. Shared memory: forward
//   192 * (D+8) * 2 bytes, 52 KB at D = 128; backward 61 KB at D = 128.
// - simt:: (fp32, and any other bf16 case): one block per (16 rows, head,
//   batch), 4 warps of 4 rows, tiles of 32 keys (or queries) staged as
//   fp32; each lane takes one key (query) of the tile against the warp's
//   rows on the fp32 CUDA cores, which keeps fp32 inputs at full fp32
//   precision (no TF32). At most 46 KB of shared memory (D = 128).
//
// - The recompute backward in bf16 at D = 64, 80 and 128 past S = 128
//   (ViT-L/14's and ViT-H/14's vision towers, the pipeline GPT's S = 512
//   with dropout, the S-major views of those): attn_bwd_sm90.cuh's two
//   warp-specialised
//   wgmma kernels (part 1 dQ and delta over 128-query blocks, K and V
//   streamed twice through a TMA ring; part 2 dK and dV over 128-key
//   blocks, Q, dO and the row statistics streamed; that header's note has
//   the design). Phase 6 of chip_smoke.py on the H100 (NVIDIA H100 80GB
//   HBM3, 700 W): 0.4962 ms at ViT-L/14's B = 64, S = 257, D = 64
//   (tc:: 0.8717 before; SDPA 0.4108), 0.5571 and 0.7300 ms at the
//   pipeline GPT's B = 32, S = 512, D = 128, causal, rate 0 and 0.1
//   (tc:: 1.4166 and 1.7338; SDPA 0.5225 and 0.5234), 0.2332 ms at
//   ViT-H/14's B = 24, S = 257, D = 80 (tc:: 0.4674 before; SDPA's
//   backward 0.19 to 0.31 between runs). S <= 128 (the text towers) runs
//   the one-pass kernel above; other D and operands TMA cannot read stay
//   on tc:: below; fp32 and any other bf16 case on simt::.
// - tc::'s recompute backward keeps the saved-P backward's shape: part 1
//   stages q, dO, k and v tiles, takes every operand from shared memory
//   (one ldmatrix per k-chunk) and runs S = Q K^T and dP = dO V^T in both
//   passes over 32-key halves, which keeps it at 128 registers at D = 64,
//   four blocks per SM; part 2 keeps the block's 64 keys and values in
//   shared memory as A operands of S^T = K Q^T and dP^T = V dO^T, whose
//   accumulators become P^T's and dS^T's A fragments for dV and dK
//   directly, and walks each 64-query tile in two halves of 32 so that dK,
//   dV, P^T and dP^T fit the registers at D = 128. Shared memory 70 KB at
//   D = 128 for both parts. On the CUDA cores the saved-P kernels take the
//   recompute as a template switch.
#include <math_constants.h>
#include <stdint.h>

#include "attn_bwd_sm90.cuh"
#include "attn_fwd_sm90.cuh"
#include "attn_short_bwd_sm90.cuh"
#include "attn_short_sm90.cuh"
#include "common.cuh"
#include "mma_tiles.cuh"
#include "philox.cuh"
#include "sm90.cuh"

namespace {

using mct::allow_smem;
using mct::Dropout;
constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxD = 128;

// Element strides of a [B, S, cols] operand between batches and between
// sequence positions; its columns are contiguous.
struct Pitch {
  long b, s;
};

// ----------------------------------------------------------------------------
// fp32 CUDA-core kernel
namespace simt {

constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                  // query rows per warp
constexpr int kQTile = kWarps * kRows;    // query rows per block
constexpr int kKTile = 32;                // keys per shared-memory tile
constexpr int kDPerLane = kMaxD / 32;

__host__ __device__ inline int padded_d(int d) { return (d + 3) & ~3; }

__host__ __device__ inline int smem_bytes(int d) {
  const int dp = padded_d(d), ld = dp + 4;
  return 4 * (2 * kKTile * ld + kQTile * dp + kWarps * kRows * kKTile);
}

// Stage keys [t0, t0+nt) of head h (and their values when v_s != nullptr)
// as fp32, zero-filled past nt and past D.
template <typename T>
__device__ void load_kv_tile(const T* __restrict__ src, long row_pitch,
                             int kcol, int vcol, int t0, int nt, int D,
                             int dp, int ld, float* k_s, float* v_s) {
  for (int i = threadIdx.x; i < kKTile * dp; i += kThreads) {
    const int j = i / dp, d = i - j * dp;
    float kv = 0.f, vv = 0.f;
    if (j < nt && d < D) {
      const T* row = src + (long)(t0 + j) * row_pitch;
      kv = mct::to_float(row[kcol + d]);
      if (v_s != nullptr) vv = mct::to_float(row[vcol + d]);
    }
    k_s[j * ld + d] = kv;
    if (v_s != nullptr) v_s[j * ld + d] = vv;
  }
}

// s[r] = q_r . k_lane for the warp's kRows query rows (unscaled fp32 dot).
__device__ __forceinline__ void score_rows(const float* q_w, const float* k_s,
                                           int lane, int dp, int ld,
                                           float (&s)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = 0.f;
  const float4* kr = reinterpret_cast<const float4*>(k_s + lane * ld);
  for (int c = 0; c < dp / 4; ++c) {
    const float4 kv = kr[c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 qv = reinterpret_cast<const float4*>(q_w + r * dp)[c];
      s[r] = fmaf(qv.x, kv.x, s[r]);
      s[r] = fmaf(qv.y, kv.y, s[r]);
      s[r] = fmaf(qv.z, kv.z, s[r]);
      s[r] = fmaf(qv.w, kv.w, s[r]);
    }
  }
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
fwd(const T* __restrict__ qkv, Pitch pq, T* __restrict__ out, Pitch po,
    T* __restrict__ probs, float* __restrict__ row_max,
    float* __restrict__ row_sum, int S, int H, int D, float scale,
    int causal, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_d(D), ld = dp + 4;
  float* k_s = smem;                    // [kKTile][ld]
  float* v_s = k_s + kKTile * ld;       // [kKTile][ld]
  float* q_s = v_s + kKTile * ld;       // [kQTile][dp]
  float* p_s = q_s + kQTile * dp;       // [kWarps][kRows][kKTile]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kQTile;
  const int nq = min(kQTile, S - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;          // the warp's first row in the tile
  const long row_pitch = pq.s;
  const T* __restrict__ src = qkv + (long)b * pq.b;
  const int kcol = (H + h) * D, vcol = (2 * H + h) * D;

  for (int i = threadIdx.x; i < kQTile * dp; i += kThreads) {
    const int r = i / dp, d = i - r * dp;
    q_s[i] = (r < nq && d < D)
                 ? mct::to_float(src[(long)(q0 + r) * row_pitch + h * D + d])
                 : 0.f;
  }
  // keys any row of this block attends to
  const int nk = causal ? q0 + nq : S;
  // last key any row of this warp attends to, plus one
  const int warp_nk = causal ? min(nk, q0 + r0 + kRows) : nk;
  const float* q_w = q_s + r0 * dp;
  float* p_w = p_s + warp * kRows * kKTile;

  // pass 1: per-row max m and denominator l = sum exp(s - m)
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
  }
  for (int t0 = 0; t0 < nk; t0 += kKTile) {
    const int nt = min(kKTile, nk - t0);
    __syncthreads();
    load_kv_tile(src, row_pitch, kcol, vcol, t0, nt, D, dp, ld, k_s,
                 (float*)nullptr);
    __syncthreads();
    float s[kRows];
    score_rows(q_w, k_s, lane, dp, ld, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + r0 + r, kj = t0 + lane;
      const bool ok = r0 + r < nq && lane < nt && (!causal || kj <= qi);
      const float sv = ok ? s[r] * scale : -CUDART_INF_F;
      const float tmax = mct::warp_max(sv);
      if (tmax == -CUDART_INF_F) continue;  // warp-uniform
      const float mn = fmaxf(m[r], tmax);
      const float e = ok ? expf(sv - mn) : 0.f;
      l[r] = l[r] * expf(m[r] - mn) + mct::warp_sum(e);
      m[r] = mn;
    }
  }
  if (row_max != nullptr && lane == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r0 + r >= nq) continue;
      const long i = ((long)b * H + h) * S + q0 + r0 + r;
      row_max[i] = m[r];
      row_sum[i] = l[r];
    }
  }

  // pass 2: p = exp(s - m) / l rounded to T, out = p . V; with probs,
  // every p of the warp's rows is also written there (masked keys as 0)
  T* p_rows = probs == nullptr
                  ? nullptr
                  : probs + (((long)b * H + h) * S + q0 + r0) * S;
  float acc[kRows][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[r][c] = 0.f;
  for (int t0 = 0; t0 < nk; t0 += kKTile) {
    const int nt = min(kKTile, nk - t0);
    __syncthreads();
    load_kv_tile(src, row_pitch, kcol, vcol, t0, nt, D, dp, ld, k_s, v_s);
    __syncthreads();
    const int jn = min(nt, warp_nk - t0);  // keys of this tile the warp needs
    if (jn <= 0) continue;                 // warp-uniform
    float s[kRows];
    score_rows(q_w, k_s, lane, dp, ld, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + r0 + r, kj = t0 + lane;
      const bool ok = r0 + r < nq && lane < nt && (!causal || kj <= qi);
      // dropout: P M, M the keep multiplier in T's precision
      const float keep =
          kDrop && ok ? drop.at((long)b * H + h, qi, kj) : 1.f;
      p_w[r * kKTile + lane] =
          ok ? mct::round_to<T>(expf(s[r] * scale - m[r]) / l[r] * keep)
             : 0.f;
      if (p_rows != nullptr && r0 + r < nq && lane < nt)
        p_rows[(long)r * S + kj] = mct::from_float<T>(p_w[r * kKTile + lane]);
    }
    __syncwarp();
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
  if (p_rows != nullptr) {
    // keys of no tile the warp visited: past its last row (causal)
    const int written = min(nk, (warp_nk + kKTile - 1) / kKTile * kKTile);
    for (int r = 0; r < kRows && r0 + r < nq; ++r)
      for (int kj = written + lane; kj < S; kj += 32)
        p_rows[(long)r * S + kj] = mct::from_float<T>(0.f);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r >= nq) continue;
    T* dst = out + (long)b * po.b + (long)(q0 + r0 + r) * po.s + h * D;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dst[d] = mct::from_float<T>(acc[r][c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* qkv, Pitch pq, void* out, Pitch po,
                   void* probs, float* row_max, float* row_sum, int B, int S,
                   int H, int D, float scale, int causal, const Dropout* drop,
                   cudaStream_t st) {
  const dim3 grid((S + kQTile - 1) / kQTile, H, B);
  if (drop)
    fwd<T, true><<<grid, kThreads, smem_bytes(D), st>>>(
        static_cast<const T*>(qkv), pq, static_cast<T*>(out), po,
        static_cast<T*>(probs), row_max, row_sum, S, H, D, scale, causal,
        *drop);
  else
    fwd<T, false><<<grid, kThreads, smem_bytes(D), st>>>(
        static_cast<const T*>(qkv), pq, static_cast<T*>(out), po,
        static_cast<T*>(probs), row_max, row_sum, S, H, D, scale, causal,
        Dropout{});
  return cudaGetLastError();
}

// Stage rows [r0, r0+n) of one head's D columns at `col` (row pitch
// `pitch`) as fp32 in a [ROWS][ld] tile, zero-filled past n and past D.
template <typename T, int ROWS>
__device__ void load_rows(float* dst, const T* __restrict__ src, long pitch,
                          int col, int r0, int n, int D, int dp, int ld) {
  for (int i = threadIdx.x; i < ROWS * dp; i += kThreads) {
    const int r = i / dp, d = i - r * dp;
    dst[r * ld + d] = (r < n && d < D)
                          ? mct::to_float(src[(long)(r0 + r) * pitch + col + d])
                          : 0.f;
  }
}

__host__ __device__ inline int bwd_dq_smem_bytes(int d, bool recompute) {
  const int dp = padded_d(d), ld = dp + 4;
  return 4 * (2 * kKTile * ld + (recompute ? 2 : 1) * kQTile * dp +
              kWarps * kRows * kKTile);
}

// Backward, part 1: dQ and the row term delta_i = sum_j dP_ij P_ij, one
// block per (16 query rows, head, batch), 4 warps of 4 rows; each lane
// takes one key of a 32-key tile. Pass 1 sums delta over every key tile,
// pass 2 forms dS = P (dP - delta) scale rounded to T and accumulates dS.K.
// P is read from the forward's probs, or with kRecompute formed in fp32 from
// q.k and the forward's row statistics, exactly as the forward formed it.
template <typename T, bool kRecompute, bool kDrop>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ qkv, Pitch pq, const T* __restrict__ dout,
       Pitch pdo, const T* __restrict__ probs,
       const float* __restrict__ row_max, const float* __restrict__ row_sum,
       T* __restrict__ dqkv, Pitch pdq, float* __restrict__ delta, int S,
       int H, int D, float scale, int causal, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_d(D), ld = dp + 4;
  float* v_s = smem;                    // [kKTile][ld]
  float* k_s = v_s + kKTile * ld;       // [kKTile][ld]
  float* do_s = k_s + kKTile * ld;      // [kQTile][dp]
  float* ds_s = do_s + kQTile * dp;     // [kWarps][kRows][kKTile]
  float* q_s = ds_s + kWarps * kRows * kKTile;  // [kQTile][dp] (recompute)

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kQTile;
  const int nq = min(kQTile, S - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  const long bh = (long)b * H + h;
  const T* __restrict__ src = qkv + (long)b * pq.b;
  const T* __restrict__ p_bh = kRecompute ? nullptr : probs + bh * S * S;
  const int kcol = (H + h) * D, vcol = (2 * H + h) * D;

  // rows that score_rows takes as its queries have pitch dp
  load_rows<T, kQTile>(do_s, dout + (long)b * pdo.b, pdo.s, h * D, q0, nq,
                       D, dp, dp);
  if (kRecompute)
    load_rows<T, kQTile>(q_s, src, pq.s, h * D, q0, nq, D, dp, dp);
  // P is 0 on every masked pair, so the mask only bounds the key tiles
  const int nk = causal ? q0 + nq : S;
  const int warp_nk = causal ? min(nk, q0 + r0 + kRows) : nk;
  const float* do_w = do_s + r0 * dp;
  const float* q_w = q_s + r0 * dp;
  float* ds_w = ds_s + warp * kRows * kKTile;
  float m[kRows], l[kRows];  // the rows' softmax statistics (recompute)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool ok = kRecompute && r0 + r < nq;
    m[r] = ok ? row_max[bh * S + q0 + r0 + r] : 0.f;
    l[r] = ok ? row_sum[bh * S + q0 + r0 + r] : 1.f;
  }
  // P of row r and key t0 + lane; sc holds the raw scores when recomputing
  auto prob = [&](int r, int t0, int nt, const float (&sc)[kRows]) {
    const int qi = q0 + r0 + r, kj = t0 + lane;
    if (kRecompute) {
      const bool ok = r0 + r < nq && lane < nt && (!causal || kj <= qi);
      return ok ? expf(sc[r] * scale - m[r]) / l[r] : 0.f;
    }
    const bool ok = r0 + r < nq && lane < nt;
    return ok ? mct::to_float(p_bh[(long)qi * S + kj]) : 0.f;
  };
  // dropout: dP M in delta and dS
  auto drop_dp = [&](float (&s)[kRows], int t0) {
    if (kDrop)
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] *= drop.at(bh, q0 + r0 + r, t0 + lane);
  };

  float dl[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dl[r] = 0.f;
  for (int t0 = 0; t0 < nk; t0 += kKTile) {
    const int nt = min(kKTile, nk - t0);
    __syncthreads();
    load_rows<T, kKTile>(v_s, src, pq.s, vcol, t0, nt, D, dp, ld);
    if (kRecompute)
      load_rows<T, kKTile>(k_s, src, pq.s, kcol, t0, nt, D, dp, ld);
    __syncthreads();
    if (t0 >= warp_nk) continue;  // warp-uniform
    float s[kRows], sc[kRows] = {};
    score_rows(do_w, v_s, lane, dp, ld, s);  // dP = dO . V
    drop_dp(s, t0);
    if (kRecompute) score_rows(q_w, k_s, lane, dp, ld, sc);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      dl[r] = fmaf(prob(r, t0, nt, sc), s[r], dl[r]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) dl[r] = mct::warp_sum(dl[r]);

  float acc[kRows][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[r][c] = 0.f;
  for (int t0 = 0; t0 < nk; t0 += kKTile) {
    const int nt = min(kKTile, nk - t0);
    __syncthreads();
    load_rows<T, kKTile>(v_s, src, pq.s, vcol, t0, nt, D, dp, ld);
    load_rows<T, kKTile>(k_s, src, pq.s, kcol, t0, nt, D, dp, ld);
    __syncthreads();
    const int jn = min(nt, warp_nk - t0);
    if (jn <= 0) continue;  // warp-uniform
    float s[kRows], sc[kRows] = {};
    score_rows(do_w, v_s, lane, dp, ld, s);
    drop_dp(s, t0);
    if (kRecompute) score_rows(q_w, k_s, lane, dp, ld, sc);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      ds_w[r * kKTile + lane] =
          mct::round_to<T>(prob(r, t0, nt, sc) * (s[r] - dl[r]) * scale);
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
    const int qi = q0 + r0 + r;
    if (lane == 0) delta[bh * S + qi] = dl[r];
    T* dst = dqkv + (long)b * pdq.b + (long)qi * pdq.s + h * D;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dst[d] = mct::from_float<T>(acc[r][c]);
    }
  }
}

constexpr int kKeys = kWarps * kRows;  // keys per dK/dV block

__host__ __device__ inline int bwd_dkdv_smem_bytes(int d, bool recompute) {
  const int dp = padded_d(d), ld = dp + 4;
  return 4 * (2 * kKTile * ld + (recompute ? 2 : 1) * kKeys * dp +
              2 * kWarps * kRows * kKTile);
}

// Backward, part 2: dK and dV, one block per (16 keys, head, batch), 4 warps
// of 4 keys; each lane takes one query of a 32-query tile, reads delta from
// part 1, and the warp accumulates dV += P^T dO and dK += dS^T Q. With
// kRecompute, P^T comes from k.q and the query's row statistics, and dV
// takes it rounded to T.
template <typename T, bool kRecompute, bool kDrop>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const T* __restrict__ qkv, Pitch pq, const T* __restrict__ dout,
         Pitch pdo, const T* __restrict__ probs,
         const float* __restrict__ row_max,
         const float* __restrict__ row_sum, const float* __restrict__ delta,
         T* __restrict__ dqkv, Pitch pdq, int S, int H, int D, float scale,
         int causal, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_d(D), ld = dp + 4;
  float* q_s = smem;                      // [kKTile][ld] queries
  float* do_s = q_s + kKTile * ld;        // [kKTile][ld]
  float* v_s = do_s + kKTile * ld;        // [kKeys][dp] the block's keys
  float* p_s = v_s + kKeys * dp;          // [kWarps][kRows][kKTile]
  float* ds_s = p_s + kWarps * kRows * kKTile;
  float* k_s = ds_s + kWarps * kRows * kKTile;  // [kKeys][dp] (recompute)

  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * kKeys;
  const int nkeys = min(kKeys, S - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  const long bh = (long)b * H + h;
  const T* __restrict__ src = qkv + (long)b * pq.b;
  const T* __restrict__ dsrc = dout + (long)b * pdo.b;
  const T* __restrict__ p_bh = kRecompute ? nullptr : probs + bh * S * S;
  const float* __restrict__ d_bh = delta + bh * S;

  load_rows<T, kKeys>(v_s, src, pq.s, (2 * H + h) * D, k0, nkeys, D, dp, dp);
  if (kRecompute)
    load_rows<T, kKeys>(k_s, src, pq.s, (H + h) * D, k0, nkeys, D, dp, dp);
  const float* v_w = v_s + r0 * dp;
  const float* k_w = k_s + r0 * dp;
  float* p_w = p_s + warp * kRows * kKTile;
  float* ds_w = ds_s + warp * kRows * kKTile;
  const bool warp_idle = r0 >= nkeys;

  float dk[kRows][kDPerLane], dv[kRows][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) dk[r][c] = dv[r][c] = 0.f;
  // causal: no query before the block's first key attends to its keys
  for (int t0 = causal ? k0 : 0; t0 < S; t0 += kKTile) {
    const int nt = min(kKTile, S - t0);
    __syncthreads();
    load_rows<T, kKTile>(q_s, src, pq.s, h * D, t0, nt, D, dp, ld);
    load_rows<T, kKTile>(do_s, dsrc, pdo.s, h * D, t0, nt, D, dp, ld);
    __syncthreads();
    if (warp_idle) continue;  // warp-uniform
    float s[kRows], sc[kRows] = {};
    score_rows(v_w, do_s, lane, dp, ld, s);  // s[r] = dP[query lane][key r]
    if (kRecompute) score_rows(k_w, q_s, lane, dp, ld, sc);  // S^T
    const int qi = t0 + lane;
    const float dq_lane = lane < nt ? d_bh[qi] : 0.f;
    const float m_lane = kRecompute && lane < nt ? row_max[bh * S + qi] : 0.f;
    const float l_lane = kRecompute && lane < nt ? row_sum[bh * S + qi] : 1.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int kj = k0 + r0 + r;
      float p;
      if (kRecompute) {
        const bool ok = r0 + r < nkeys && lane < nt && (!causal || kj <= qi);
        p = ok ? expf(sc[r] * scale - m_lane) / l_lane : 0.f;
      } else {
        const bool ok = r0 + r < nkeys && lane < nt;
        p = ok ? mct::to_float(p_bh[(long)qi * S + kj]) : 0.f;
      }
      // dropout: dV from P M, dS from dP M
      const float keep = kDrop ? drop.at(bh, qi, kj) : 1.f;
      p_w[r * kKTile + lane] = mct::round_to<T>(p * keep);
      ds_w[r * kKTile + lane] =
          mct::round_to<T>(p * (s[r] * keep - dq_lane) * scale);
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
          dv[r][c] = fmaf(p_w[r * kKTile + j], gv, dv[r][c]);
          dk[r][c] = fmaf(ds_w[r * kKTile + j], qv, dk[r][c]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r >= nkeys) continue;
    T* dst = dqkv + (long)b * pdq.b + (long)(k0 + r0 + r) * pdq.s;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dst[(H + h) * D + d] = mct::from_float<T>(dk[r][c]);
        dst[(2 * H + h) * D + d] = mct::from_float<T>(dv[r][c]);
      }
    }
  }
}

// Both parts of the backward: from P (probs) or, with kRecompute, from the
// forward's row statistics.
template <typename T, bool kRecompute, bool kDrop>
cudaError_t launch_bwd_as(const void* qkv, Pitch pq, const void* dout,
                          Pitch pdo, const void* probs, const float* row_max,
                          const float* row_sum, void* dqkv, Pitch pdq,
                          float* delta, int B, int S, int H, int D,
                          float scale, int causal, Dropout drop,
                          cudaStream_t st) {
  const int smem_q = bwd_dq_smem_bytes(D, kRecompute);
  const int smem_k = bwd_dkdv_smem_bytes(D, kRecompute);
  cudaError_t e = allow_smem(bwd_dq<T, kRecompute, kDrop>, smem_q);
  if (e == cudaSuccess)
    e = allow_smem(bwd_dkdv<T, kRecompute, kDrop>, smem_k);
  if (e != cudaSuccess) return e;
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  const T* p = static_cast<const T*>(probs);
  T* dq = static_cast<T*>(dqkv);
  bwd_dq<T, kRecompute, kDrop>
      <<<dim3((S + kQTile - 1) / kQTile, H, B), kThreads, smem_q, st>>>(
          q, pq, g, pdo, p, row_max, row_sum, dq, pdq, delta, S, H, D, scale,
          causal, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv<T, kRecompute, kDrop>
      <<<dim3((S + kKeys - 1) / kKeys, H, B), kThreads, smem_k, st>>>(
          q, pq, g, pdo, p, row_max, row_sum, delta, dq, pdq, S, H, D, scale,
          causal, drop);
  return cudaGetLastError();
}

// Dropout takes the recompute backward only (the saved-P backward reads a
// P that would hold the mask already).
template <typename T, bool kRecompute>
cudaError_t launch_bwd(const void* qkv, Pitch pq, const void* dout, Pitch pdo,
                       const void* probs, const float* row_max,
                       const float* row_sum, void* dqkv, Pitch pdq,
                       float* delta, int B, int S, int H, int D, float scale,
                       int causal, const Dropout* drop, cudaStream_t st) {
  if constexpr (kRecompute) {
    if (drop)
      return launch_bwd_as<T, true, true>(qkv, pq, dout, pdo, probs, row_max,
                                          row_sum, dqkv, pdq, delta, B, S, H,
                                          D, scale, causal, *drop, st);
  } else if (drop) {
    return cudaErrorInvalidValue;
  }
  return launch_bwd_as<T, kRecompute, false>(
      qkv, pq, dout, pdo, probs, row_max, row_sum, dqkv, pdq, delta, B, S, H,
      D, scale, causal, Dropout{}, st);
}

}  // namespace simt

// ----------------------------------------------------------------------------
// bf16 tensor-core kernel
namespace tc {

using namespace mct::tc;
constexpr int kQ = 64;  // query rows per block, 16 per warp
// Keys per shared-memory tile. 128 was tried for D <= 64 (so S = 77 fits
// one tile): 189 registers, 2 blocks per SM and more padded keys made it
// 2.5x slower on the H100 (PERF.md).
constexpr int kK = 64;

__host__ __device__ constexpr int smem_bytes(int dp) {
  return (kQ + 2 * kK) * (dp + 8) * 2;
}

// Raw scores of the warp's 16 query rows against the keys of the tile:
// s[n] is the m16n8 accumulator of keys 8n..8n+7. score_tile_s
// (mma_tiles.cuh) takes the rows from shared memory instead and sums the
// k-chunks in the same order, so the two give the same scores.
template <int DP, int NT>
__device__ __forceinline__ void score_tile(float (&s)[NT][4],
                                           const uint32_t (&qa)[DP / 16][4],
                                           const bf16* k_s, int lane) {
  constexpr int kPitch = DP + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      uint32_t r[4];
      const int key = np * 16 + (lane & 7) + (lane >> 4) * 8;
      const int col = kc * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(r, k_s + key * kPitch + col);
      mma(s[2 * np], qa[kc], r[0], r[1]);
      mma(s[2 * np + 1], qa[kc], r[2], r[3]);
    }
  }
}

// Scale the scores and mask keys >= S and (causal) keys after the row with
// -inf. Element j of s[n] is (row_j, key t0 + 8n + 2*(lane%4) + j%2), with
// row_j = row_lo for j < 2 and row_lo + 8 otherwise.
template <int NT>
__device__ __forceinline__ void scale_mask(float (&s)[NT][4], int t0,
                                           int row_lo, int lane, int S,
                                           int causal, float scale) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = t0 + 8 * n + 2 * (lane & 3) + (j & 1);
      const int row = row_lo + (j >> 1) * 8;
      const bool ok = key < S && (!causal || key <= row);
      s[n][j] = ok ? s[n][j] * scale : -CUDART_INF_F;
    }
}

template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
fwd(const bf16* __restrict__ qkv, Pitch pq, bf16* __restrict__ out,
    Pitch po, bf16* __restrict__ probs, float* __restrict__ row_max,
    float* __restrict__ row_sum, int S, int H, int D, float scale,
    int causal, Dropout drop) {
  constexpr int kPitch = DP + 8, NT = kK / 8, kSub = 32, NS = kSub / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [kQ][kPitch]
  bf16* k_s = q_s + kQ * kPitch;                    // [kK][kPitch]
  bf16* v_s = k_s + kK * kPitch;                    // [kK][kPitch]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row_pitch = pq.s;
  const bf16* src = qkv + (long)b * pq.b;
  const int nk = causal ? min(S, q0 + kQ) : S;
  const int row_lo = q0 + warp * 16 + (lane >> 2);  // and row_lo + 8
  const int warp_last = q0 + warp * 16 + 15;
  // warp-uniform: key tile t0 holds nothing this warp's rows need
  const bool warp_idle = q0 + warp * 16 >= S;
  auto skip = [&](int t0) { return warp_idle || (causal && t0 > warp_last); };
  // all keys in one tile: K and V are loaded once, up front
  const bool one_tile = nk <= kK;

  load_tile<DP, kQ>(q_s, src, row_pitch, h * D, q0, min(kQ, S - q0), D);
  if (one_tile) {
    load_tile<DP, kK>(k_s, src, row_pitch, (H + h) * D, 0, nk, D);
    load_tile<DP, kK>(v_s, src, row_pitch, (2 * H + h) * D, 0, nk, D);
  }
  __syncthreads();
  const bf16* qw_s = q_s + warp * 16 * kPitch;

  // pass 1: row max m and denominator l (rows row_lo, row_lo + 8)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int t0 = 0; t0 < nk; t0 += kK) {
    if (!one_tile) {
      __syncthreads();
      load_tile<DP, kK>(k_s, src, row_pitch, (H + h) * D, t0,
                        min(kK, nk - t0), D);
      __syncthreads();
    }
    if (skip(t0)) continue;
    float s[NT][4];
    score_tile_s<DP, NT>(s, qw_s, k_s, lane);
    scale_mask(s, t0, row_lo, lane, S, causal, scale);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * half], s[n][2 * half + 1]));
      // every lane reaches the quad shuffles: no early exit for a row
      // whose keys are all masked so far (its sums stay exactly 0)
      const float mn = fmaxf(m[half], quad_max(mx));
      const float base = mn == -CUDART_INF_F ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        sum += expf(s[n][2 * half] - base) + expf(s[n][2 * half + 1] - base);
      l[half] = l[half] * expf(m[half] - base) + quad_sum(sum);
      m[half] = mn;
    }
  }
  if (row_max != nullptr && (lane & 3) == 0)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_lo + 8 * half;
      if (row >= S) continue;
      const long i = ((long)b * H + h) * S + row;
      row_max[i] = m[half];
      row_sum[i] = l[half];
    }

  // pass 2: P = exp(s - m) / l rounded to bf16 (as A fragments), O += P V,
  // each key tile in halves of 32 keys (fewer live registers); with probs,
  // P is also written there (masked keys as 0)
  bf16* p_bh = probs == nullptr ? nullptr
                                : probs + ((long)b * H + h) * S * S;
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.f;
  for (int t0 = 0; t0 < nk; t0 += kK) {
    if (!one_tile) {
      const int nt = min(kK, nk - t0);
      __syncthreads();
      load_tile<DP, kK>(k_s, src, row_pitch, (H + h) * D, t0, nt, D);
      load_tile<DP, kK>(v_s, src, row_pitch, (2 * H + h) * D, t0, nt, D);
      __syncthreads();
    }
#pragma unroll 1
    for (int hk = 0; hk < kK; hk += kSub) {
      const int t = t0 + hk;
      if (warp_idle || t >= nk) continue;  // warp-uniform
      if (causal && t > warp_last) {
        // keys after every row of the warp: their P is 0
        if (p_bh != nullptr)
          for (int r = 0; r < 16 && q0 + warp * 16 + r < S; ++r)
            for (int key = t + lane; key < min(t + kSub, nk); key += 32)
              p_bh[(long)(q0 + warp * 16 + r) * S + key] =
                  __float2bfloat16(0.f);
        continue;
      }
      float s[NS][4];
      score_tile_s<DP, NS>(s, qw_s, k_s + hk * kPitch, lane);
      scale_mask(s, t, row_lo, lane, S, causal, scale);
      // dropout: P M before the rounding, M the multiplier in bf16
      float keep[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        if (kDrop)
          drop.quad(keep[n], (long)b * H + h, row_lo,
                    t + 8 * n + 2 * (lane & 3));
        else
          keep[n][0] = keep[n][1] = keep[n][2] = keep[n][3] = 1.f;
      }
#pragma unroll
      for (int kc = 0; kc < NS / 2; ++kc) {
        uint32_t pa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // i: 0 (row lo, keys 0-7), 1 (row hi, 0-7), 2 (lo, 8-15), 3 (hi,
          // 8-15)
          const int c = 2 * kc + (i >> 1);
          const float* sv = s[c];
          const int half = i & 1;
          pa[i] = pack_bf16(
              expf(sv[2 * half] - m[half]) / l[half] * keep[c][2 * half],
              expf(sv[2 * half + 1] - m[half]) / l[half] *
                  keep[c][2 * half + 1]);
          const int row = row_lo + 8 * half;
          const int key = t + 16 * kc + 8 * (i >> 1) + 2 * (lane & 3);
          if (p_bh != nullptr && row < S) {
            const bf16* pv = reinterpret_cast<const bf16*>(&pa[i]);
            if (key < S) p_bh[(long)row * S + key] = pv[0];
            if (key + 1 < S) p_bh[(long)row * S + key + 1] = pv[1];
          }
        }
#pragma unroll
        for (int dc = 0; dc < DP / 16; ++dc) {
          uint32_t r[4];
          const int key = hk + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(r, v_s + key * kPitch + dc * 16 + (lane >> 4) * 8);
          mma(o[2 * dc], pa, r[0], r[1]);
          mma(o[2 * dc + 1], pa, r[2], r[3]);
        }
      }
    }
  }
  // every tile below nk was visited, so only keys past the block's last
  // row (causal) are left
  if (p_bh != nullptr && !warp_idle)
    for (int r = 0; r < 16 && q0 + warp * 16 + r < S; ++r)
      for (int key = nk + lane; key < S; key += 32)
        p_bh[(long)(q0 + warp * 16 + r) * S + key] = __float2bfloat16(0.f);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row >= S) continue;
    bf16* dst = out + (long)b * po.b + (long)row * po.s + h * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      if (d < D)
        *reinterpret_cast<uint32_t*>(dst + d) =
            pack_bf16(o[n][2 * half], o[n][2 * half + 1]);
    }
  }
}

template <int DP, bool kDrop>
cudaError_t launch_as(const void* qkv, Pitch pq, void* out, Pitch po,
                      void* probs, float* row_max, float* row_sum, int B,
                      int S, int H, int D, float scale, int causal,
                      Dropout drop, cudaStream_t st) {
  constexpr int kSmem = smem_bytes(DP);
  const cudaError_t e = allow_smem(fwd<DP, kDrop>, kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kQ - 1) / kQ, H, B);
  fwd<DP, kDrop><<<grid, kThreads, kSmem, st>>>(
      static_cast<const bf16*>(qkv), pq, static_cast<bf16*>(out), po,
      static_cast<bf16*>(probs), row_max, row_sum, S, H, D, scale, causal,
      drop);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const void* qkv, Pitch pq, void* out, Pitch po,
                   void* probs, float* row_max, float* row_sum, int B, int S,
                   int H, int D, float scale, int causal, const Dropout* drop,
                   cudaStream_t st) {
  return drop ? launch_as<DP, true>(qkv, pq, out, po, probs, row_max, row_sum,
                                    B, S, H, D, scale, causal, *drop, st)
              : launch_as<DP, false>(qkv, pq, out, po, probs, row_max,
                                     row_sum, B, S, H, D, scale, causal,
                                     Dropout{}, st);
}

// ---- backward ------------------------------------------------------------

constexpr int kPP = kK + 8;  // pitch of a staged P tile

__host__ __device__ constexpr int bwd_smem_bytes(int dp) {
  return 3 * 64 * (dp + 8) * 2 + kQ * kPP * 2 + kQ * 4;
}

// The pitches of contiguous qkv / dqkv [B, S, 3*H*D] and dO [B, S, H*D]. The
// saved-P kernels take them from here in the packed layout, not as
// arguments: with pitches the compiler cannot relate to S, H and D, ptxas
// gives part 2 220 registers instead of 171 at D = 64 and it runs about 1.3x
// slower at the ViT-B/32 shapes on the H100 (PERF.md).
__host__ __device__ __forceinline__ void packed_pitches(Pitch& pq, Pitch& pdo,
                                                        Pitch& pdq, int S,
                                                        int H, int D) {
  pq.s = 3L * H * D;
  pq.b = (long)S * pq.s;
  pdo.s = (long)H * D;
  pdo.b = (long)S * pdo.s;
  pdq = pq;
}

// Stage the saved probabilities P[q0 + r][t0 + c] of one (batch, head) in a
// [kQ][kPP] tile, zero past nq rows and nt keys.
__device__ __forceinline__ void load_p_tile(bf16* p_s,
                                            const bf16* __restrict__ P,
                                            int S, int q0, int nq, int t0,
                                            int nt) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < kQ * kK; i += kThreads) {
    const int r = i / kK, c = i - r * kK;
    p_s[r * kPP + c] =
        (r < nq && c < nt) ? P[(long)(q0 + r) * S + t0 + c] : zero;
  }
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Backward, part 1: dQ and the row term delta_i = sum_j dP_ij P_ij. One
// block per (64 query rows, head, batch), 4 warps of 16 rows. dP = dO V^T
// runs like the forward's Q K^T (dO rows as A fragments in registers), and
// dQ += dS K like its P V, with dS = P (dP - delta) scale rounded to bf16
// into A fragments. Pass 1 sums delta over every key tile, pass 2 forms dS;
// at S <= 64 the K, V and P tiles are loaded once. kPacked: see
// packed_pitches.
template <int DP, bool kPacked>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const bf16* __restrict__ qkv, Pitch pq, const bf16* __restrict__ dout,
       Pitch pdo, const bf16* __restrict__ probs, bf16* __restrict__ dqkv,
       Pitch pdq, float* __restrict__ delta, int S, int H, int D,
       float scale, int causal) {
  constexpr int kPitch = DP + 8, NT = kK / 8;
  if (kPacked) packed_pitches(pq, pdo, pdq, S, H, D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* do_s = reinterpret_cast<bf16*>(smem_raw);  // [kQ][kPitch]
  bf16* k_s = do_s + kQ * kPitch;                   // [kK][kPitch]
  bf16* v_s = k_s + kK * kPitch;                    // [kK][kPitch]
  bf16* p_s = v_s + kK * kPitch;                    // [kQ][kPP]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row_pitch = pq.s;
  const bf16* src = qkv + (long)b * pq.b;
  const bf16* P = probs + ((long)b * H + h) * S * S;
  const int nq = min(kQ, S - q0);
  // P is 0 on every masked pair, so the mask only bounds the key tiles
  const int nk = causal ? min(S, q0 + kQ) : S;
  const int row_lo = warp * 16 + (lane >> 2);  // tile rows row_lo, row_lo + 8
  const int warp_last = q0 + warp * 16 + 15;
  const bool warp_idle = q0 + warp * 16 >= S;
  auto skip = [&](int t0) { return warp_idle || (causal && t0 > warp_last); };
  const bool one_tile = nk <= kK;

  load_tile<DP, kQ>(do_s, dout + (long)b * pdo.b, pdo.s, h * D, q0, nq, D);
  if (one_tile) {
    load_tile<DP, kK>(k_s, src, row_pitch, (H + h) * D, 0, nk, D);
    load_tile<DP, kK>(v_s, src, row_pitch, (2 * H + h) * D, 0, nk, D);
    load_p_tile(p_s, P, S, q0, nq, 0, nk);
  }
  __syncthreads();
  uint32_t da[DP / 16][4];
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    ldmatrix_x4(da[kc], do_s + (warp * 16 + (lane & 15)) * kPitch + kc * 16 +
                            (lane >> 4) * 8);

  // pass 1: delta of rows row_lo and row_lo + 8
  float dl[2] = {0.f, 0.f};
  for (int t0 = 0; t0 < nk; t0 += kK) {
    if (!one_tile) {
      const int nt = min(kK, nk - t0);
      __syncthreads();
      load_tile<DP, kK>(v_s, src, row_pitch, (2 * H + h) * D, t0, nt, D);
      load_p_tile(p_s, P, S, q0, nq, t0, nt);
      __syncthreads();
    }
    if (skip(t0)) continue;
    float s[NT][4];
    score_tile<DP, NT>(s, da, v_s, lane);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = 8 * n + 2 * (lane & 3) + (j & 1);
        const int row = row_lo + (j >> 1) * 8;
        dl[j >> 1] =
            fmaf(__bfloat162float(p_s[row * kPP + key]), s[n][j], dl[j >> 1]);
      }
  }
  dl[0] = quad_sum(dl[0]);
  dl[1] = quad_sum(dl[1]);

  // pass 2: dQ += dS K
  float dq[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[n][j] = 0.f;
  for (int t0 = 0; t0 < nk; t0 += kK) {
    if (!one_tile) {
      const int nt = min(kK, nk - t0);
      __syncthreads();
      load_tile<DP, kK>(k_s, src, row_pitch, (H + h) * D, t0, nt, D);
      load_tile<DP, kK>(v_s, src, row_pitch, (2 * H + h) * D, t0, nt, D);
      load_p_tile(p_s, P, S, q0, nq, t0, nt);
      __syncthreads();
    }
    if (skip(t0)) continue;
    float s[NT][4];
    score_tile<DP, NT>(s, da, v_s, lane);
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      uint32_t dsa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* sv = s[2 * kc + (i >> 1)];
        const int half = i & 1;
        const int key = 16 * kc + 8 * (i >> 1) + 2 * (lane & 3);
        const bf16* pr = p_s + (row_lo + 8 * half) * kPP + key;
        dsa[i] = pack_bf16(
            __bfloat162float(pr[0]) * (sv[2 * half] - dl[half]) * scale,
            __bfloat162float(pr[1]) * (sv[2 * half + 1] - dl[half]) * scale);
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t r[4];
        const int key = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, k_s + key * kPitch + dp * 16 + (lane >> 4) * 8);
        mma(dq[2 * dp], dsa, r[0], r[1]);
        mma(dq[2 * dp + 1], dsa, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + row_lo + 8 * half;
    if (row >= S) continue;
    if ((lane & 3) == 0) delta[((long)b * H + h) * S + row] = dl[half];
    bf16* dst = dqkv + (long)b * pdq.b + (long)row * pdq.s + h * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      if (d < D)
        *reinterpret_cast<uint32_t*>(dst + d) =
            pack_bf16(dq[n][2 * half], dq[n][2 * half + 1]);
    }
  }
}

// Backward, part 2: dK and dV. One block per (64 keys, head, batch), 4
// warps of 16 keys, looping over 64-query tiles (from the block's first key
// on, when causal). With keys as rows: dV += P^T dO, dP^T = V dO^T (V rows
// as A fragments in registers), dK += dS^T Q with dS from part 1's delta.
template <int DP, bool kPacked>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const bf16* __restrict__ qkv, Pitch pq,
         const bf16* __restrict__ dout, Pitch pdo,
         const bf16* __restrict__ probs, const float* __restrict__ delta,
         bf16* __restrict__ dqkv, Pitch pdq, int S, int H, int D,
         float scale, int causal) {
  constexpr int kPitch = DP + 8, NT = kQ / 8;
  if (kPacked) packed_pitches(pq, pdo, pdq, S, H, D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kQ][kPitch]
  bf16* do_s = q_s + kQ * kPitch;                  // [kQ][kPitch]
  bf16* v_s = do_s + kQ * kPitch;                  // [kK][kPitch]
  bf16* p_s = v_s + kK * kPitch;                   // [kQ][kPP]
  float* d_s = reinterpret_cast<float*>(p_s + kQ * kPP);  // [kQ]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row_pitch = pq.s, o_pitch = pdo.s;
  const bf16* src = qkv + (long)b * pq.b;
  const bf16* dsrc = dout + (long)b * pdo.b;
  const bf16* P = probs + ((long)b * H + h) * S * S;
  const float* d_bh = delta + ((long)b * H + h) * S;
  const int nkeys = min(kK, S - k0);
  const int key_lo = warp * 16 + (lane >> 2);  // block keys key_lo, +8
  const bool warp_idle = k0 + warp * 16 >= S;

  load_tile<DP, kK>(v_s, src, row_pitch, (2 * H + h) * D, k0, nkeys, D);
  __syncthreads();
  uint32_t va[DP / 16][4];
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    ldmatrix_x4(va[kc], v_s + (warp * 16 + (lane & 15)) * kPitch + kc * 16 +
                            (lane >> 4) * 8);

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[n][j] = dv[n][j] = 0.f;
  // causal: no query before the block's first key attends to its keys
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += kQ) {
    const int nq = min(kQ, S - q0);
    __syncthreads();
    load_tile<DP, kQ>(q_s, src, row_pitch, h * D, q0, nq, D);
    load_tile<DP, kQ>(do_s, dsrc, o_pitch, h * D, q0, nq, D);
    load_p_tile(p_s, P, S, q0, nq, k0, nkeys);
    for (int i = threadIdx.x; i < kQ; i += kThreads)
      d_s[i] = i < nq ? d_bh[q0 + i] : 0.f;
    __syncthreads();
    if (warp_idle) continue;
    // dV += P^T dO: P^T fragments (keys x queries) read from the P tile
#pragma unroll
    for (int kc = 0; kc < kQ / 16; ++kc) {
      uint32_t pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key_lo + 8 * (i & 1);
        const int q = 16 * kc + 8 * (i >> 1) + 2 * (lane & 3);
        pa[i] = pack_raw(p_s[q * kPP + key], p_s[(q + 1) * kPP + key]);
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t r[4];
        const int q = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, do_s + q * kPitch + dp * 16 + (lane >> 4) * 8);
        mma(dv[2 * dp], pa, r[0], r[1]);
        mma(dv[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    // dP^T = V dO^T: element j of s[n] is (key key_lo + 8*(j/2), query
    // 8n + 2*(lane%4) + j%2)
    float s[NT][4];
    score_tile<DP, NT>(s, va, do_s, lane);
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      uint32_t dsa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* sv = s[2 * kc + (i >> 1)];
        const int half = i & 1;
        const int key = key_lo + 8 * half;
        const int q = 16 * kc + 8 * (i >> 1) + 2 * (lane & 3);
        dsa[i] = pack_bf16(__bfloat162float(p_s[q * kPP + key]) *
                               (sv[2 * half] - d_s[q]) * scale,
                           __bfloat162float(p_s[(q + 1) * kPP + key]) *
                               (sv[2 * half + 1] - d_s[q + 1]) * scale);
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t r[4];
        const int q = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, q_s + q * kPitch + dp * 16 + (lane >> 4) * 8);
        mma(dk[2 * dp], dsa, r[0], r[1]);
        mma(dk[2 * dp + 1], dsa, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + key_lo + 8 * half;
    if (key >= S) continue;
    bf16* dst = dqkv + (long)b * pdq.b + (long)key * pdq.s;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      if (d < D) {
        *reinterpret_cast<uint32_t*>(dst + (H + h) * D + d) =
            pack_bf16(dk[n][2 * half], dk[n][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(dst + (2 * H + h) * D + d) =
            pack_bf16(dv[n][2 * half], dv[n][2 * half + 1]);
      }
    }
  }
}

template <int DP, bool kPacked>
cudaError_t launch_bwd_as(const void* qkv, Pitch pq, const void* dout,
                          Pitch pdo, const void* probs, void* dqkv, Pitch pdq,
                          float* delta, int B, int S, int H, int D,
                          float scale, int causal, cudaStream_t st) {
  constexpr int kSmem = bwd_smem_bytes(DP);
  cudaError_t e = allow_smem(bwd_dq<DP, kPacked>, kSmem);
  if (e == cudaSuccess) e = allow_smem(bwd_dkdv<DP, kPacked>, kSmem);
  if (e != cudaSuccess) return e;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* g = static_cast<const bf16*>(dout);
  const bf16* p = static_cast<const bf16*>(probs);
  bf16* dq = static_cast<bf16*>(dqkv);
  bwd_dq<DP, kPacked>
      <<<dim3((S + kQ - 1) / kQ, H, B), kThreads, kSmem, st>>>(
          q, pq, g, pdo, p, dq, pdq, delta, S, H, D, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv<DP, kPacked>
      <<<dim3((S + kK - 1) / kK, H, B), kThreads, kSmem, st>>>(
          q, pq, g, pdo, p, delta, dq, pdq, S, H, D, scale, causal);
  return cudaGetLastError();
}

// The packed layout (every operand a contiguous [B, S, *] tensor) runs its
// own instantiation, whose pitches packed_pitches derives from S, H and D.
template <int DP>
cudaError_t launch_bwd(const void* qkv, Pitch pq, const void* dout, Pitch pdo,
                       const void* probs, void* dqkv, Pitch pdq, float* delta,
                       int B, int S, int H, int D, float scale, int causal,
                       cudaStream_t st) {
  Pitch q = pq, o = pdo, g = pdq;
  packed_pitches(q, o, g, S, H, D);
  const bool packed = pq.b == q.b && pq.s == q.s && pdo.b == o.b &&
                      pdo.s == o.s && pdq.b == g.b && pdq.s == g.s;
  return packed ? launch_bwd_as<DP, true>(qkv, pq, dout, pdo, probs, dqkv,
                                          pdq, delta, B, S, H, D, scale,
                                          causal, st)
                : launch_bwd_as<DP, false>(qkv, pq, dout, pdo, probs, dqkv,
                                           pdq, delta, B, S, H, D, scale,
                                           causal, st);
}

// ---- recompute backward --------------------------------------------------

// Four [64][DP+8] bf16 tiles, and part 2's m, l and delta of a query tile.
__host__ __device__ constexpr int bwd_rc_smem_bytes(int dp) {
  return 4 * 64 * (dp + 8) * 2 + 3 * kQ * 4;
}

// Recompute backward, part 1: dQ and delta_i = sum_j dP_ij P_ij with P
// formed in fp32 from the scores and the forward's row statistics. One
// block per (64 query rows, head, batch), 4 warps of 16 rows; q and dO are
// staged once, k and v per 64-key tile (once when one tile holds every key
// the block sees), and every operand is read from shared memory, so that
// the registers hold little more than dQ and the warps of several blocks
// per SM hide each other's latency. Both passes walk each key tile
// in halves of 32 keys (halves past the last key, or after the warp's last
// row when causal, are skipped) and form S = Q K^T, P = exp(S scale - m) /
// l (the forward's pass-2 arithmetic; masked pairs exactly 0) and dP =
// dO V^T; pass 1 sums delta, pass 2 forms dS = P (dP - delta) scale with
// fp32 P, rounded to bf16 as A fragments, and accumulates dQ += dS K.
template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
bwd_dq_rc(const bf16* __restrict__ qkv, Pitch pq,
          const bf16* __restrict__ dout, Pitch pdo,
          const float* __restrict__ row_max,
          const float* __restrict__ row_sum, bf16* __restrict__ dqkv,
          Pitch pdq, float* __restrict__ delta, int S, int H, int D,
          float scale, int causal, Dropout drop) {
  constexpr int kPitch = DP + 8, kSub = 32, NT = kSub / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kQ][kPitch]
  bf16* do_s = q_s + kQ * kPitch;                  // [kQ][kPitch]
  bf16* k_s = do_s + kQ * kPitch;                  // [kK][kPitch]
  bf16* v_s = k_s + kK * kPitch;                   // [kK][kPitch]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long bh = (long)b * H + h;
  const bf16* src = qkv + (long)b * pq.b;
  const int nq = min(kQ, S - q0);
  const int nk = causal ? min(S, q0 + kQ) : S;
  const int row_lo = q0 + warp * 16 + (lane >> 2);  // rows row_lo, row_lo + 8
  const int warp_last = q0 + warp * 16 + 15;
  const bool warp_idle = q0 + warp * 16 >= S;
  // warp-uniform: keys [t, t + kSub) hold nothing this warp's rows need
  auto skip = [&](int t) {
    return warp_idle || t >= nk || (causal && t > warp_last);
  };
  const bool one_tile = nk <= kK;
  auto load_kv = [&](int t0) {
    const int nt = min(kK, nk - t0);
    load_tile<DP, kK>(k_s, src, pq.s, (H + h) * D, t0, nt, D);
    load_tile<DP, kK>(v_s, src, pq.s, (2 * H + h) * D, t0, nt, D);
  };

  load_tile<DP, kQ>(q_s, src, pq.s, h * D, q0, nq, D);
  load_tile<DP, kQ>(do_s, dout + (long)b * pdo.b, pdo.s, h * D, q0, nq, D);
  if (one_tile) load_kv(0);
  __syncthreads();
  const bf16* qw_s = q_s + warp * 16 * kPitch;
  const bf16* dow_s = do_s + warp * 16 * kPitch;
  float m[2], l[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    m[half] = row < S ? row_max[bh * S + row] : 0.f;
    l[half] = row < S ? row_sum[bh * S + row] : 1.f;
  }
  // P of the warp's rows against keys [t, t + kSub) (at hk in the staged
  // tile) into s, dP into dp
  auto probs_and_dp = [&](float (&s)[NT][4], float (&dp)[NT][4], int t,
                          int hk) {
    score_tile_s<DP, NT>(s, qw_s, k_s + hk * kPitch, lane);
    scale_mask(s, t, row_lo, lane, S, causal, scale);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[n][j] = expf(s[n][j] - m[j >> 1]) / l[j >> 1];
    score_tile_s<DP, NT>(dp, dow_s, v_s + hk * kPitch, lane);
    if (kDrop)  // dP M, in delta and in dS
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float keep[4];
        drop.quad(keep, bh, row_lo, t + 8 * n + 2 * (lane & 3));
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[n][j] *= keep[j];
      }
  };

  // pass 1: delta of rows row_lo and row_lo + 8
  float dl[2] = {0.f, 0.f};
  for (int t0 = 0; t0 < nk; t0 += kK) {
    if (!one_tile) {
      __syncthreads();
      load_kv(t0);
      __syncthreads();
    }
#pragma unroll
    for (int hk = 0; hk < kK; hk += kSub) {
      if (skip(t0 + hk)) continue;
      float s[NT][4], dp[NT][4];
      probs_and_dp(s, dp, t0 + hk, hk);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dl[j >> 1] = fmaf(s[n][j], dp[n][j], dl[j >> 1]);
    }
  }
  dl[0] = quad_sum(dl[0]);
  dl[1] = quad_sum(dl[1]);

  // pass 2: dQ += dS K
  float dq[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[n][j] = 0.f;
  for (int t0 = 0; t0 < nk; t0 += kK) {
    if (!one_tile) {
      __syncthreads();
      load_kv(t0);
      __syncthreads();
    }
#pragma unroll
    for (int hk = 0; hk < kK; hk += kSub) {
      if (skip(t0 + hk)) continue;
      float s[NT][4], dp[NT][4];
      probs_and_dp(s, dp, t0 + hk, hk);
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        uint32_t dsa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 2 * kc + (i >> 1), half = i & 1;
          dsa[i] = pack_bf16(
              s[c][2 * half] * (dp[c][2 * half] - dl[half]) * scale,
              s[c][2 * half + 1] * (dp[c][2 * half + 1] - dl[half]) * scale);
        }
#pragma unroll
        for (int dc = 0; dc < DP / 16; ++dc) {
          uint32_t r[4];
          const int key = hk + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(r, k_s + key * kPitch + dc * 16 + (lane >> 4) * 8);
          mma(dq[2 * dc], dsa, r[0], r[1]);
          mma(dq[2 * dc + 1], dsa, r[2], r[3]);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row >= S) continue;
    if ((lane & 3) == 0) delta[bh * S + row] = dl[half];
    bf16* dst = dqkv + (long)b * pdq.b + (long)row * pdq.s + h * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      if (d < D)
        *reinterpret_cast<uint32_t*>(dst + d) =
            pack_bf16(dq[n][2 * half], dq[n][2 * half + 1]);
    }
  }
}

// Recompute backward, part 2: dK and dV. One block per (64 keys, head,
// batch), 4 warps of 16 keys, whose k and v rows stay in shared memory as A
// operands; it loops over 64-query tiles (from the block's first key on,
// when causal), each in two halves of 32 queries. With keys as rows: S^T =
// K Q^T, P^T = exp(S^T scale - m_q) / l_q in the accumulators, dV +=
// bf16(P^T) dO with P^T's A fragments taken straight from them, dP^T = V
// dO^T, and dK += dS^T Q with dS^T = P^T (dP^T - delta_q) scale in fp32,
// rounded to bf16.
template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_rc(const bf16* __restrict__ qkv, Pitch pq,
            const bf16* __restrict__ dout, Pitch pdo,
            const float* __restrict__ row_max,
            const float* __restrict__ row_sum,
            const float* __restrict__ delta, bf16* __restrict__ dqkv,
            Pitch pdq, int S, int H, int D, float scale, int causal,
            Dropout drop) {
  constexpr int kPitch = DP + 8, kSub = 32, NT = kSub / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kK][kPitch] block keys
  bf16* v_s = k_s + kK * kPitch;                   // [kK][kPitch]
  bf16* q_s = v_s + kK * kPitch;                   // [kQ][kPitch]
  bf16* do_s = q_s + kQ * kPitch;                  // [kQ][kPitch]
  float* m_s = reinterpret_cast<float*>(do_s + kQ * kPitch);  // [kQ]
  float* l_s = m_s + kQ;                                      // [kQ]
  float* d_s = l_s + kQ;                                      // [kQ]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long bh = (long)b * H + h;
  const bf16* src = qkv + (long)b * pq.b;
  const bf16* dsrc = dout + (long)b * pdo.b;
  const int nkeys = min(kK, S - k0);
  const int warp_k0 = k0 + warp * 16;
  const int key_lo = warp_k0 + (lane >> 2);  // keys key_lo, key_lo + 8
  const bool warp_idle = warp_k0 >= S;

  load_tile<DP, kK>(k_s, src, pq.s, (H + h) * D, k0, nkeys, D);
  load_tile<DP, kK>(v_s, src, pq.s, (2 * H + h) * D, k0, nkeys, D);
  const bf16* kw_s = k_s + warp * 16 * kPitch;
  const bf16* vw_s = v_s + warp * 16 * kPitch;

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[n][j] = dv[n][j] = 0.f;
  // causal: no query before the block's first key attends to its keys
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += kQ) {
    const int nq = min(kQ, S - q0);
    __syncthreads();
    load_tile<DP, kQ>(q_s, src, pq.s, h * D, q0, nq, D);
    load_tile<DP, kQ>(do_s, dsrc, pdo.s, h * D, q0, nq, D);
    for (int i = threadIdx.x; i < kQ; i += kThreads) {
      const bool ok = i < nq;
      m_s[i] = ok ? row_max[bh * S + q0 + i] : 0.f;
      l_s[i] = ok ? row_sum[bh * S + q0 + i] : 1.f;
      d_s[i] = ok ? delta[bh * S + q0 + i] : 0.f;
    }
    __syncthreads();
    if (warp_idle) continue;
#pragma unroll 1
    for (int qs = 0; qs < kQ; qs += kSub) {
      // warp-uniform: every query of the half is past S, or (causal)
      // before the warp's first key
      if (q0 + qs >= S || (causal && q0 + qs + kSub - 1 < warp_k0)) continue;
      // P^T: element j of s[n] is (key key_lo + 8*(j/2), query qs + 8n +
      // 2*(lane%4) + j%2 of the tile)
      float s[NT][4];
      score_tile_s<DP, NT>(s, kw_s, q_s + qs * kPitch, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = key_lo + 8 * (j >> 1);
          const int q = qs + 8 * n + 2 * (lane & 3) + (j & 1);
          const bool ok =
              key < S && q0 + q < S && (!causal || key <= q0 + q);
          s[n][j] = ok ? expf(s[n][j] * scale - m_s[q]) / l_s[q] : 0.f;
        }
      // dropout: the keep multipliers M^T of the half, for dV from
      // P^T M^T and dS^T from dP^T M^T
      float keep[NT][4];
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        if (kDrop)
          drop.quad_t2(keep[n], keep[n + 1], bh,
                       q0 + qs + 8 * n + 2 * (lane & 3), key_lo);
        else
#pragma unroll
          for (int j = 0; j < 4; ++j) keep[n][j] = keep[n + 1][j] = 1.f;
      }
      // dV += bf16(P^T M^T) dO
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        uint32_t pa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 2 * kc + (i >> 1), half = i & 1;
          pa[i] = pack_bf16(s[c][2 * half] * keep[c][2 * half],
                            s[c][2 * half + 1] * keep[c][2 * half + 1]);
        }
#pragma unroll
        for (int dc = 0; dc < DP / 16; ++dc) {
          uint32_t r[4];
          const int q = qs + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(r, do_s + q * kPitch + dc * 16 + (lane >> 4) * 8);
          mma(dv[2 * dc], pa, r[0], r[1]);
          mma(dv[2 * dc + 1], pa, r[2], r[3]);
        }
      }
      // dP^T = V dO^T, then dK += dS^T Q
      float dp[NT][4];
      score_tile_s<DP, NT>(dp, vw_s, do_s + qs * kPitch, lane);
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        uint32_t dsa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 2 * kc + (i >> 1), half = i & 1;
          const int q = qs + 8 * c + 2 * (lane & 3);
          dsa[i] = pack_bf16(
              s[c][2 * half] *
                  (dp[c][2 * half] * keep[c][2 * half] - d_s[q]) * scale,
              s[c][2 * half + 1] *
                  (dp[c][2 * half + 1] * keep[c][2 * half + 1] - d_s[q + 1]) *
                  scale);
        }
#pragma unroll
        for (int dc = 0; dc < DP / 16; ++dc) {
          uint32_t r[4];
          const int q = qs + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(r, q_s + q * kPitch + dc * 16 + (lane >> 4) * 8);
          mma(dk[2 * dc], dsa, r[0], r[1]);
          mma(dk[2 * dc + 1], dsa, r[2], r[3]);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_lo + 8 * half;
    if (key >= S) continue;
    bf16* dst = dqkv + (long)b * pdq.b + (long)key * pdq.s;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      if (d < D) {
        *reinterpret_cast<uint32_t*>(dst + (H + h) * D + d) =
            pack_bf16(dk[n][2 * half], dk[n][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(dst + (2 * H + h) * D + d) =
            pack_bf16(dv[n][2 * half], dv[n][2 * half + 1]);
      }
    }
  }
}

template <int DP, bool kDrop>
cudaError_t launch_bwd_rc_as(const void* qkv, Pitch pq, const void* dout,
                             Pitch pdo, const float* row_max,
                             const float* row_sum, void* dqkv, Pitch pdq,
                             float* delta, int B, int S, int H, int D,
                             float scale, int causal, Dropout drop,
                             cudaStream_t st) {
  constexpr int kSmem = bwd_rc_smem_bytes(DP);
  cudaError_t e = allow_smem(bwd_dq_rc<DP, kDrop>, kSmem);
  if (e == cudaSuccess) e = allow_smem(bwd_dkdv_rc<DP, kDrop>, kSmem);
  if (e != cudaSuccess) return e;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* g = static_cast<const bf16*>(dout);
  bf16* dq = static_cast<bf16*>(dqkv);
  bwd_dq_rc<DP, kDrop>
      <<<dim3((S + kQ - 1) / kQ, H, B), kThreads, kSmem, st>>>(
          q, pq, g, pdo, row_max, row_sum, dq, pdq, delta, S, H, D, scale,
          causal, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv_rc<DP, kDrop>
      <<<dim3((S + kK - 1) / kK, H, B), kThreads, kSmem, st>>>(
          q, pq, g, pdo, row_max, row_sum, delta, dq, pdq, S, H, D, scale,
          causal, drop);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_rc(const void* qkv, Pitch pq, const void* dout,
                          Pitch pdo, const float* row_max,
                          const float* row_sum, void* dqkv, Pitch pdq,
                          float* delta, int B, int S, int H, int D,
                          float scale, int causal, const Dropout* drop,
                          cudaStream_t st) {
  return drop ? launch_bwd_rc_as<DP, true>(qkv, pq, dout, pdo, row_max,
                                           row_sum, dqkv, pdq, delta, B, S, H,
                                           D, scale, causal, *drop, st)
              : launch_bwd_rc_as<DP, false>(qkv, pq, dout, pdo, row_max,
                                            row_sum, dqkv, pdq, delta, B, S,
                                            H, D, scale, causal, Dropout{},
                                            st);
}

cudaError_t dispatch(const void* qkv, Pitch pq, void* out, Pitch po,
                     void* probs, float* row_max, float* row_sum, int B,
                     int S, int H, int D, float scale, int causal,
                     const Dropout* drop, cudaStream_t st) {
  MCT_TC_DISPATCH(launch, D, qkv, pq, out, po, probs, row_max, row_sum, B, S,
                  H, D, scale, causal, drop, st)
}

cudaError_t dispatch_bwd(const void* qkv, Pitch pq, const void* dout,
                         Pitch pdo, const void* probs, void* dqkv, Pitch pdq,
                         float* delta, int B, int S, int H, int D,
                         float scale, int causal, cudaStream_t st) {
  MCT_TC_DISPATCH(launch_bwd, D, qkv, pq, dout, pdo, probs, dqkv, pdq, delta,
                  B, S, H, D, scale, causal, st)
}

cudaError_t dispatch_bwd_rc(const void* qkv, Pitch pq, const void* dout,
                            Pitch pdo, const float* row_max,
                            const float* row_sum, void* dqkv, Pitch pdq,
                            float* delta, int B, int S, int H, int D,
                            float scale, int causal, const Dropout* drop,
                            cudaStream_t st) {
  MCT_TC_DISPATCH(launch_bwd_rc, D, qkv, pq, dout, pdo, row_max, row_sum,
                  dqkv, pdq, delta, B, S, H, D, scale, causal, drop, st)
}

}  // namespace tc

bool valid_shape(int B, int S, int H, int D) {
  return B >= 1 && B <= 65535 && S >= 1 && H >= 1 && H <= 65535 && D >= 1 &&
         D <= kMaxD;
}

// Whether the one-pass backward (attn_short_bwd_sm90.cuh) takes a call:
// bf16 operands TMA can read, S <= 128, D = 64, no dropout.
bool one_pass_bwd(int dtype, int S, int D, const Dropout* drop,
                  std::initializer_list<const void*> ptrs,
                  std::initializer_list<long long> strides) {
  return dtype == mct::kBFloat16 && S <= mct::attn_short::kMaxS &&
         D == mct::attn_short::kD && drop == nullptr &&
         mct::attn_fwd::aligned(ptrs, strides);
}

// Its arguments but the mode's (probs, or row_max and row_sum).
mct::attn_short_bwd::Args one_pass_args(void* dqkv, long long dq_b,
                                        long long dq_s, int B, int S, int H,
                                        float scale, int causal) {
  mct::attn_short_bwd::Args a{};
  a.dqkv = static_cast<__nv_bfloat16*>(dqkv);
  a.db = dq_b;
  a.ds = dq_s;
  a.B = B;
  a.H = H;
  a.S = S;
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

// Pointers and (batch, sequence) element strides of the [B, S, *] operands;
// their rows are contiguous. Each function returns the launch's
// cudaError_t (0 on success) and launches on `stream`. With `drop` the
// forward and the recompute backward drop attention probabilities as
// philox.cuh draws them (seed, offset, threshold; a kept probability times
// `mult`, the multiplier rounded to the input dtype); without it they are
// the rate-0 kernels.
#define MCT_DROP_ARGS                                                  \
  int drop, unsigned long long seed, unsigned int offset,              \
      unsigned int threshold, float mult
#define MCT_DROP                                                        \
  const Dropout drop_args{(uint32_t)seed, (uint32_t)(seed >> 32), offset, \
                          threshold, mult};                              \
  const Dropout* dr = drop ? &drop_args : nullptr

// Forward. probs and stats may be null. probs receives P [B, H, S, S] in the
// input dtype, the probabilities exactly as P.V used them (masked pairs 0);
// stats [2, B*H*S] fp32 each row's max of the scaled scores, then its
// softmax denominator, for the recompute backward. Dropout takes no probs.
// route 0 takes the kernel the file's note gives the shape; 1 asks for the
// one-pass kernel at S <= 128 and 2 for tc::fwd (the A/Bs of chip_smoke.py
// and tools/ab_attention.py): an error where the kernel asked for cannot
// take the shape.
extern "C" int mct_fused_mha_fwd(const void* qkv, long long qkv_b,
                                 long long qkv_s, void* out, long long out_b,
                                 long long out_s, void* probs, void* stats,
                                 int B, int S, int H, int D, float scale,
                                 int causal, int dtype, MCT_DROP_ARGS,
                                 int route, void* stream) {
  if (!valid_shape(B, S, H, D) || (drop && probs != nullptr) || route < 0 ||
      route > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Pitch pq{qkv_b, qkv_s}, po{out_b, out_s};
  float* m = static_cast<float*>(stats);
  float* l = m == nullptr ? nullptr : m + (long)B * H * S;
  MCT_DROP;
  if (dtype == mct::kFloat32 && route == 0)
    return (int)simt::launch<float>(qkv, pq, out, po, probs, m, l, B, S, H, D,
                                    scale, causal, dr, st);
  if (dtype != mct::kBFloat16) return (int)cudaErrorInvalidValue;
  const bool one_pass =
      S <= mct::attn_short::kMaxS && D == mct::attn_short::kD && !dr &&
      mct::attn_fwd::aligned({qkv, out}, {qkv_b, qkv_s, out_b, out_s});
  if (route == 1 || (route == 0 && one_pass)) {
    if (!one_pass) return (int)cudaErrorInvalidValue;
    mct::attn_short::Args a{};
    a.o = static_cast<__nv_bfloat16*>(out);
    a.ob = out_b;
    a.os = out_s;
    a.probs = static_cast<__nv_bfloat16*>(probs);
    a.row_max = m;
    a.row_sum = l;
    a.B = B;
    a.H = H;
    a.S = S;
    a.causal = causal;
    a.scale = scale;
    return (int)mct::attn_short::launch(
        static_cast<const __nv_bfloat16*>(qkv), qkv_b, qkv_s, a, st);
  }
  const bool tc_ok = tc::eligible(D, {qkv, out}, {qkv_b, qkv_s, out_b, out_s});
  if (route == 2) {
    if (!tc_ok) return (int)cudaErrorInvalidValue;
    return (int)tc::dispatch(qkv, pq, out, po, probs, m, l, B, S, H, D, scale,
                             causal, dr, st);
  }
  if (S > mct::attn_fwd::kN && mct::attn_fwd::fused_d(D) &&
      mct::attn_fwd::aligned({qkv, out, probs},
                             {qkv_b, qkv_s, out_b, out_s})) {
    // past one key tile (the file's note): q, k and v as the [B, H, S, D]
    // views of qkv's columns
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(qkv);
    const long long hd = (long long)H * D;
    mct::attn_fwd::Args a{};
    a.o = static_cast<__nv_bfloat16*>(out);
    a.ob = out_b;
    a.oh = D;
    a.os = out_s;
    a.row_max = m;
    a.row_sum = l;
    a.probs = static_cast<__nv_bfloat16*>(probs);
    a.H = H;
    a.Sq = a.Sk = S;
    a.causal = causal;
    a.scale = scale;
    return (int)mct::attn_fwd::launch<true>(
        D, {x, qkv_b, D, qkv_s}, {x + hd, qkv_b, D, qkv_s},
        {x + 2 * hd, qkv_b, D, qkv_s}, a, B, dr, st);
  }
  if (tc_ok)
    return (int)tc::dispatch(qkv, pq, out, po, probs, m, l, B, S, H, D, scale,
                             causal, dr, st);
  return (int)simt::launch<__nv_bfloat16>(qkv, pq, out, po, probs, m, l, B, S,
                                          H, D, scale, causal, dr, st);
}


// Whether the backward below (either mode) keeps delta in a [B*H*S] fp32
// scratch on `route` for these operands: every kernel but the one-pass one,
// which the caller's delta may then be null for. The wrappers ask before
// they allocate one, so the kernel choice stays in this file.
extern "C" int mct_fused_mha_bwd_needs_delta(
    const void* qkv, long long qkv_b, long long qkv_s, const void* dout,
    long long do_b, long long do_s, const void* dqkv, long long dq_b,
    long long dq_s, int S, int D, int dtype, int drop, int route) {
  const Dropout any{};
  return !(route == 1 ||
           (route == 0 &&
            one_pass_bwd(dtype, S, D, drop ? &any : nullptr,
                         {qkv, dout, dqkv},
                         {qkv_b, qkv_s, do_b, do_s, dq_b, dq_s})));
}

// Backward from the forward's P: dqkv [B, S, 3*H*D] (every element
// written). route as the forward's: 0 the shape's kernel, 1 the one-pass
// kernel (bf16, S <= 128, D = 64: one launch, delta in registers, so delta
// may be null), 2 tc::'s pair; an error where the kernel asked for cannot
// take the shape. The other kernels keep delta in a [B*H*S] fp32 scratch
// (two launches).
extern "C" int mct_fused_mha_bwd(const void* qkv, long long qkv_b,
                                 long long qkv_s, const void* dout,
                                 long long do_b, long long do_s,
                                 const void* probs, void* dqkv,
                                 long long dq_b, long long dq_s, void* delta,
                                 int B, int S, int H, int D, float scale,
                                 int causal, int dtype, int route,
                                 void* stream) {
  if (!valid_shape(B, S, H, D) || probs == nullptr || route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Pitch pq{qkv_b, qkv_s}, pdo{do_b, do_s}, pdq{dq_b, dq_s};
  float* dl = static_cast<float*>(delta);
  const bool one_pass =
      one_pass_bwd(dtype, S, D, nullptr, {qkv, dout, dqkv},
                   {qkv_b, qkv_s, do_b, do_s, dq_b, dq_s});
  if (route == 1 || (route == 0 && one_pass)) {
    if (!one_pass) return (int)cudaErrorInvalidValue;
    mct::attn_short_bwd::Args a =
        one_pass_args(dqkv, dq_b, dq_s, B, S, H, scale, causal);
    a.probs = static_cast<const __nv_bfloat16*>(probs);
    return (int)mct::attn_short_bwd::launch(
        static_cast<const __nv_bfloat16*>(qkv), qkv_b, qkv_s,
        static_cast<const __nv_bfloat16*>(dout), do_b, do_s, a, st);
  }
  if (dl == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == mct::kFloat32 && route == 0)
    return (int)simt::launch_bwd<float, false>(qkv, pq, dout, pdo, probs,
                                               nullptr, nullptr, dqkv, pdq,
                                               dl, B, S, H, D, scale, causal,
                                               nullptr, st);
  if (dtype != mct::kBFloat16) return (int)cudaErrorInvalidValue;
  const bool tc_ok = tc::eligible(D, {qkv, dout, dqkv},
                                  {qkv_b, qkv_s, do_b, do_s, dq_b, dq_s});
  if (tc_ok)
    return (int)tc::dispatch_bwd(qkv, pq, dout, pdo, probs, dqkv, pdq, dl, B,
                                 S, H, D, scale, causal, st);
  if (route == 2) return (int)cudaErrorInvalidValue;
  return (int)simt::launch_bwd<__nv_bfloat16, false>(
      qkv, pq, dout, pdo, probs, nullptr, nullptr, dqkv, pdq, dl, B, S, H, D,
      scale, causal, nullptr, st);
}

// Backward recomputing P from qkv and the forward's stats [2, B*H*S]:
// dqkv, delta and route as above (the one-pass kernel takes no dropout).
extern "C" int mct_fused_mha_bwd_recompute(
    const void* qkv, long long qkv_b, long long qkv_s, const void* dout,
    long long do_b, long long do_s, const void* stats, void* dqkv,
    long long dq_b, long long dq_s, void* delta, int B, int S, int H, int D,
    float scale, int causal, int dtype, MCT_DROP_ARGS, int route,
    void* stream) {
  if (!valid_shape(B, S, H, D) || stats == nullptr || route < 0 ||
      route > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Pitch pq{qkv_b, qkv_s}, pdo{do_b, do_s}, pdq{dq_b, dq_s};
  const float* m = static_cast<const float*>(stats);
  const float* l = m + (long)B * H * S;
  float* dl = static_cast<float*>(delta);
  MCT_DROP;
  const bool one_pass = one_pass_bwd(dtype, S, D, dr, {qkv, dout, dqkv},
                                     {qkv_b, qkv_s, do_b, do_s, dq_b, dq_s});
  if (route == 1 || (route == 0 && one_pass)) {
    if (!one_pass) return (int)cudaErrorInvalidValue;
    mct::attn_short_bwd::Args a =
        one_pass_args(dqkv, dq_b, dq_s, B, S, H, scale, causal);
    a.row_max = m;
    a.row_sum = l;
    return (int)mct::attn_short_bwd::launch(
        static_cast<const __nv_bfloat16*>(qkv), qkv_b, qkv_s,
        static_cast<const __nv_bfloat16*>(dout), do_b, do_s, a, st);
  }
  if (dl == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == mct::kFloat32 && route == 0)
    return (int)simt::launch_bwd<float, true>(qkv, pq, dout, pdo, nullptr, m,
                                              l, dqkv, pdq, dl, B, S, H, D,
                                              scale, causal, dr, st);
  if (dtype != mct::kBFloat16) return (int)cudaErrorInvalidValue;
  if (route == 0 && S > mct::attn_fwd::kN && mct::attn_fwd::fused_d(D) &&
      mct::attn_fwd::aligned({qkv, dout, dqkv, stats, delta},
                             {qkv_b, qkv_s, do_b, do_s, dq_b, dq_s})) {
    // past one key tile (the file's note): q, k, v and dO as [B, H, S, D]
    // views
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(qkv);
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(dout);
    const long long hd = (long long)H * D;
    mct::attn_bwd::Args a{};
    a.dqkv = static_cast<__nv_bfloat16*>(dqkv);
    a.db = dq_b;
    a.ds = dq_s;
    a.row_max = m;
    a.row_sum = l;
    a.delta = dl;
    a.bhs = (long)B * H * S;
    a.H = H;
    a.S = S;
    a.causal = causal;
    a.scale = scale;
    return (int)mct::attn_bwd::launch(
        D, {x, qkv_b, D, qkv_s},
        {x + hd, qkv_b, D, qkv_s}, {x + 2 * hd, qkv_b, D, qkv_s},
        {g, do_b, D, do_s}, m, a, B, dr, st);
  }
  const bool tc_ok = tc::eligible(D, {qkv, dout, dqkv},
                                  {qkv_b, qkv_s, do_b, do_s, dq_b, dq_s});
  if (tc_ok)
    return (int)tc::dispatch_bwd_rc(qkv, pq, dout, pdo, m, l, dqkv, pdq, dl, B,
                                    S, H, D, scale, causal, dr, st);
  if (route == 2) return (int)cudaErrorInvalidValue;
  return (int)simt::launch_bwd<__nv_bfloat16, true>(
      qkv, pq, dout, pdo, nullptr, m, l, dqkv, pdq, dl, B, S, H, D, scale,
      causal, dr, st);
}

// The keep bits the kernels above draw (philox.cuh).
MCT_DROPOUT_MASK_EXPORT

// One wgmma tile product per operand layout (sm90.cuh).
MCT_SM90_TILE_CHECK_EXPORT
