// Fused multi-head attention straight off the packed QKV GEMM output:
// forward (optionally writing the probabilities P) and backward from P.
//
// Replaces the TPU kernels of megatron_clip_tpu/ops/pallas/fused_mha.py::
// fused_mha_packed: the forward _fwd_kernel (pallas_call in _fwd) and the
// saved-P backward _bwd_kernel with its math in _bwd_head (pallas_call in
// _bwd), which ops/attention.multi_head_attention runs for every attention
// with S <= 1024, head_dim <= 128, no bias/rope/GQA: both CLIP towers (ViT
// S=50 full mask, text S=77 causal).
//
// Contract. qkv [B, S, 3*H*D] contiguous, fp32 or bf16; out [B, S, H*D] in
// the same dtype. For head h the kernels read q at columns h*D, k at
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
// What bounds them. At CLIP shapes one (batch, head) of the forward moves
// S*4*D elements (q, k, v in, o out) plus S*S of P for 4*S*S*D FLOP, and the
// backward S*(3+1+3)*D elements plus S*S of P for 8*S*S*D FLOP: under
// 20 FLOP per byte in bf16, far below the ~295 FLOP/byte where an H100's
// bf16 tensor cores become the limit. So the floor is device-memory bytes
// (forward with P 141 MB, backward 230 MB for the ViT-B/32 vision tower at
// batch 384). Design for that: every qkv element is read from device memory
// by the blocks of its own (batch, head) only, and no [S, S] intermediate
// but P itself is written.
//
// Design. The TPU kernels hold whole S x S tiles of all heads in many MB of
// VMEM. A block here has at most 227 KB of shared memory, so the kernels
// are tiled over keys (forward, dQ) or queries (dK, dV). The forward makes
// two passes over the key tiles: pass 1 finds each row's max and softmax
// denominator (online rescaling), pass 2 recomputes the scores, forms the
// normalised probabilities, rounds them exactly where the TPU kernel does,
// and accumulates P.V. A causal block stops at the key tile of its last row.
// The backward is two kernels, so that no sum crosses blocks and no float
// atomics make dqkv differ from run to run: part 1 owns query rows, sums
// delta over all their key tiles and then accumulates dQ, and writes delta
// to a [B*H*S] fp32 scratch; part 2 owns keys and accumulates dK and dV over
// the query tiles (from its first key on, when causal), reading delta.
//
// - tc:: (bf16, D a multiple of 8, 16-byte aligned rows; the serving and
//   training paths): one block per (64 rows, head, batch), 4 warps of 16
//   rows. Tiles of 64 rows are staged in shared memory with 16-byte loads
//   (rows padded by 16 bytes so ldmatrix is conflict-free), and every
//   product runs on the tensor cores as mma.sync m16n8k16 bf16 with fp32
//   accumulation. In the forward the score accumulators become P's
//   A-operand fragments in registers (rounded to bf16 there); in the
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
// wgmma/TMA tiles, keeping several heads per block and one backward kernel
// for S <= 64 are later work.
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxD = 128;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd(const T* __restrict__ qkv, T* __restrict__ out, T* __restrict__ probs,
    int S, int H, int D, float scale, int causal) {
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
  const long row_pitch = 3L * H * D;
  const T* __restrict__ src = qkv + (long)b * S * row_pitch;
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
      p_w[r * kKTile + lane] =
          ok ? mct::round_to<T>(expf(s[r] * scale - m[r]) / l[r]) : 0.f;
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
    T* dst = out + ((long)b * S + q0 + r0 + r) * H * D + h * D;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dst[d] = mct::from_float<T>(acc[r][c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* out, void* probs, int B, int S,
                   int H, int D, float scale, int causal, cudaStream_t st) {
  const dim3 grid((S + kQTile - 1) / kQTile, H, B);
  fwd<T><<<grid, kThreads, smem_bytes(D), st>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out),
      static_cast<T*>(probs), S, H, D, scale, causal);
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

__host__ __device__ inline int bwd_dq_smem_bytes(int d) {
  const int dp = padded_d(d), ld = dp + 4;
  return 4 * (2 * kKTile * ld + kQTile * dp + kWarps * kRows * kKTile);
}

// Backward, part 1: dQ and the row term delta_i = sum_j dP_ij P_ij, one
// block per (16 query rows, head, batch), 4 warps of 4 rows; each lane
// takes one key of a 32-key tile. Pass 1 sums delta over every key tile,
// pass 2 forms dS = P (dP - delta) scale rounded to T and accumulates dS.K.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ qkv, const T* __restrict__ dout,
       const T* __restrict__ probs, T* __restrict__ dqkv,
       float* __restrict__ delta, int S, int H, int D, float scale,
       int causal) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_d(D), ld = dp + 4;
  float* v_s = smem;                    // [kKTile][ld]
  float* k_s = v_s + kKTile * ld;       // [kKTile][ld]
  float* do_s = k_s + kKTile * ld;      // [kQTile][dp]
  float* ds_s = do_s + kQTile * dp;     // [kWarps][kRows][kKTile]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kQTile;
  const int nq = min(kQTile, S - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  const long row_pitch = 3L * H * D, o_pitch = (long)H * D;
  const T* __restrict__ src = qkv + (long)b * S * row_pitch;
  const T* __restrict__ p_bh = probs + ((long)b * H + h) * S * S;
  const int kcol = (H + h) * D, vcol = (2 * H + h) * D;

  // rows that score_rows takes as its queries have pitch dp
  load_rows<T, kQTile>(do_s, dout + (long)b * S * o_pitch, o_pitch, h * D,
                       q0, nq, D, dp, dp);
  // P is 0 on every masked pair, so the mask only bounds the key tiles
  const int nk = causal ? q0 + nq : S;
  const int warp_nk = causal ? min(nk, q0 + r0 + kRows) : nk;
  const float* do_w = do_s + r0 * dp;
  float* ds_w = ds_s + warp * kRows * kKTile;

  float dl[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dl[r] = 0.f;
  for (int t0 = 0; t0 < nk; t0 += kKTile) {
    const int nt = min(kKTile, nk - t0);
    __syncthreads();
    load_rows<T, kKTile>(v_s, src, row_pitch, vcol, t0, nt, D, dp, ld);
    __syncthreads();
    if (t0 >= warp_nk) continue;  // warp-uniform
    float s[kRows];
    score_rows(do_w, v_s, lane, dp, ld, s);  // dP = dO . V
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = r0 + r < nq && lane < nt;
      const float p =
          ok ? mct::to_float(p_bh[(long)(q0 + r0 + r) * S + t0 + lane]) : 0.f;
      dl[r] = fmaf(p, s[r], dl[r]);
    }
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
    load_rows<T, kKTile>(v_s, src, row_pitch, vcol, t0, nt, D, dp, ld);
    load_rows<T, kKTile>(k_s, src, row_pitch, kcol, t0, nt, D, dp, ld);
    __syncthreads();
    const int jn = min(nt, warp_nk - t0);
    if (jn <= 0) continue;  // warp-uniform
    float s[kRows];
    score_rows(do_w, v_s, lane, dp, ld, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = r0 + r < nq && lane < nt;
      const float p =
          ok ? mct::to_float(p_bh[(long)(q0 + r0 + r) * S + t0 + lane]) : 0.f;
      ds_w[r * kKTile + lane] =
          ok ? mct::round_to<T>(p * (s[r] - dl[r]) * scale) : 0.f;
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
    const int qi = q0 + r0 + r;
    if (lane == 0) delta[((long)b * H + h) * S + qi] = dl[r];
    T* dst = dqkv + ((long)b * S + qi) * row_pitch + h * D;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dst[d] = mct::from_float<T>(acc[r][c]);
    }
  }
}

constexpr int kKeys = kWarps * kRows;  // keys per dK/dV block

__host__ __device__ inline int bwd_dkdv_smem_bytes(int d) {
  const int dp = padded_d(d), ld = dp + 4;
  return 4 * (2 * kKTile * ld + kKeys * dp + 2 * kWarps * kRows * kKTile);
}

// Backward, part 2: dK and dV, one block per (16 keys, head, batch), 4 warps
// of 4 keys; each lane takes one query of a 32-query tile, reads delta from
// part 1, and the warp accumulates dV += P^T dO and dK += dS^T Q.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const T* __restrict__ qkv, const T* __restrict__ dout,
         const T* __restrict__ probs, const float* __restrict__ delta,
         T* __restrict__ dqkv, int S, int H, int D, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_d(D), ld = dp + 4;
  float* q_s = smem;                      // [kKTile][ld] queries
  float* do_s = q_s + kKTile * ld;        // [kKTile][ld]
  float* v_s = do_s + kKTile * ld;        // [kKeys][dp] the block's keys
  float* p_s = v_s + kKeys * dp;          // [kWarps][kRows][kKTile]
  float* ds_s = p_s + kWarps * kRows * kKTile;

  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * kKeys;
  const int nkeys = min(kKeys, S - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  const long row_pitch = 3L * H * D, o_pitch = (long)H * D;
  const T* __restrict__ src = qkv + (long)b * S * row_pitch;
  const T* __restrict__ dsrc = dout + (long)b * S * o_pitch;
  const T* __restrict__ p_bh = probs + ((long)b * H + h) * S * S;
  const float* __restrict__ d_bh = delta + ((long)b * H + h) * S;

  load_rows<T, kKeys>(v_s, src, row_pitch, (2 * H + h) * D, k0, nkeys, D,
                      dp, dp);
  const float* v_w = v_s + r0 * dp;
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
    load_rows<T, kKTile>(q_s, src, row_pitch, h * D, t0, nt, D, dp, ld);
    load_rows<T, kKTile>(do_s, dsrc, o_pitch, h * D, t0, nt, D, dp, ld);
    __syncthreads();
    if (warp_idle) continue;  // warp-uniform
    float s[kRows];
    score_rows(v_w, do_s, lane, dp, ld, s);  // s[r] = dP[query lane][key r]
    const float dq_lane = lane < nt ? d_bh[t0 + lane] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = r0 + r < nkeys && lane < nt;
      const float p =
          ok ? mct::to_float(p_bh[(long)(t0 + lane) * S + k0 + r0 + r]) : 0.f;
      p_w[r * kKTile + lane] = p;
      ds_w[r * kKTile + lane] =
          ok ? mct::round_to<T>(p * (s[r] - dq_lane) * scale) : 0.f;
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
    T* dst = dqkv + ((long)b * S + k0 + r0 + r) * row_pitch;
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

template <typename T>
cudaError_t launch_bwd(const void* qkv, const void* dout, const void* probs,
                       void* dqkv, float* delta, int B, int S, int H, int D,
                       float scale, int causal, cudaStream_t st) {
  const dim3 grid_q((S + kQTile - 1) / kQTile, H, B);
  bwd_dq<T><<<grid_q, kThreads, bwd_dq_smem_bytes(D), st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const T*>(probs), static_cast<T*>(dqkv), delta, S, H, D,
      scale, causal);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_k((S + kKeys - 1) / kKeys, H, B);
  bwd_dkdv<T><<<grid_k, kThreads, bwd_dkdv_smem_bytes(D), st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const T*>(probs), delta, static_cast<T*>(dqkv), S, H, D,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace simt

// ----------------------------------------------------------------------------
// bf16 tensor-core kernel
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kQ = 64;  // query rows per block, 16 per warp
// Keys per shared-memory tile. 128 was tried for D <= 64 (so S = 77 fits
// one tile): 189 registers, 2 blocks per SM and more padded keys made it
// 2.5x slower on the H100 (PERF.md).
constexpr int kK = 64;

__host__ __device__ constexpr int smem_bytes(int dp) {
  return (kQ + 2 * kK) * (dp + 8) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major), fp32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0+n) of one head's q, k or v (columns col..col+D) into a
// [ROWS][DP+8] shared tile, zero-filled past n and past D. D % 8 == 0.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long row_pitch, int col, int r0,
                                          int n, int D) {
  constexpr int kChunks = DP / 8, kPitch = DP + 8;
  static_assert(ROWS * kChunks % kThreads == 0, "whole rounds of chunks");
  // a fixed trip count, unrolled: every load of the tile is in flight at once
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n && c * 8 < D)
      v = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * row_pitch +
                                          col + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kPitch + c * 8) = v;
  }
}

// Raw scores of the warp's 16 query rows against the keys of the tile:
// s[n] is the m16n8 accumulator of keys 8n..8n+7.
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
fwd(const bf16* __restrict__ qkv, bf16* __restrict__ out,
    bf16* __restrict__ probs, int S, int H, int D, float scale, int causal) {
  constexpr int kPitch = DP + 8, NT = kK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [kQ][kPitch]
  bf16* k_s = q_s + kQ * kPitch;                    // [kK][kPitch]
  bf16* v_s = k_s + kK * kPitch;                    // [kK][kPitch]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row_pitch = 3L * H * D;
  const bf16* src = qkv + (long)b * S * row_pitch;
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
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    ldmatrix_x4(qa[kc], q_s + (warp * 16 + (lane & 15)) * kPitch + kc * 16 +
                            (lane >> 4) * 8);

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
    score_tile<DP, NT>(s, qa, k_s, lane);
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

  // pass 2: P = exp(s - m) / l rounded to bf16 (as A fragments), O += P V;
  // with probs, P is also written there (masked keys as 0)
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
    if (skip(t0)) continue;
    float s[NT][4];
    score_tile<DP, NT>(s, qa, k_s, lane);
    scale_mask(s, t0, row_lo, lane, S, causal, scale);
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      uint32_t pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // i: 0 (row lo, keys 0-7), 1 (row hi, 0-7), 2 (lo, 8-15), 3 (hi, 8-15)
        const float* sv = s[2 * kc + (i >> 1)];
        const int half = i & 1;
        pa[i] = pack_bf16(expf(sv[2 * half] - m[half]) / l[half],
                          expf(sv[2 * half + 1] - m[half]) / l[half]);
        const int row = row_lo + 8 * half;
        const int key = t0 + 16 * kc + 8 * (i >> 1) + 2 * (lane & 3);
        if (p_bh != nullptr && row < S) {
          const bf16* pv = reinterpret_cast<const bf16*>(&pa[i]);
          if (key < S) p_bh[(long)row * S + key] = pv[0];
          if (key + 1 < S) p_bh[(long)row * S + key + 1] = pv[1];
        }
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t r[4];
        const int key = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, v_s + key * kPitch + dp * 16 + (lane >> 4) * 8);
        mma(o[2 * dp], pa, r[0], r[1]);
        mma(o[2 * dp + 1], pa, r[2], r[3]);
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
    bf16* dst = out + ((long)b * S + row) * H * D + h * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      if (d < D)
        *reinterpret_cast<uint32_t*>(dst + d) =
            pack_bf16(o[n][2 * half], o[n][2 * half + 1]);
    }
  }
}

template <int DP>
cudaError_t launch(const void* qkv, void* out, void* probs, int B, int S,
                   int H, int D, float scale, int causal, cudaStream_t st) {
  constexpr int kSmem = smem_bytes(DP);
  if (kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + kQ - 1) / kQ, H, B);
  fwd<DP><<<grid, kThreads, kSmem, st>>>(static_cast<const bf16*>(qkv),
                                         static_cast<bf16*>(out),
                                         static_cast<bf16*>(probs), S, H, D,
                                         scale, causal);
  return cudaGetLastError();
}

// ---- backward ------------------------------------------------------------

constexpr int kPP = kK + 8;  // pitch of a staged P tile

__host__ __device__ constexpr int bwd_smem_bytes(int dp) {
  return 3 * 64 * (dp + 8) * 2 + kQ * kPP * 2 + kQ * 4;
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
// at S <= 64 the K, V and P tiles are loaded once.
template <int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
       const bf16* __restrict__ probs, bf16* __restrict__ dqkv,
       float* __restrict__ delta, int S, int H, int D, float scale,
       int causal) {
  constexpr int kPitch = DP + 8, NT = kK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* do_s = reinterpret_cast<bf16*>(smem_raw);  // [kQ][kPitch]
  bf16* k_s = do_s + kQ * kPitch;                   // [kK][kPitch]
  bf16* v_s = k_s + kK * kPitch;                    // [kK][kPitch]
  bf16* p_s = v_s + kK * kPitch;                    // [kQ][kPP]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row_pitch = 3L * H * D, o_pitch = (long)H * D;
  const bf16* src = qkv + (long)b * S * row_pitch;
  const bf16* P = probs + ((long)b * H + h) * S * S;
  const int nq = min(kQ, S - q0);
  // P is 0 on every masked pair, so the mask only bounds the key tiles
  const int nk = causal ? min(S, q0 + kQ) : S;
  const int row_lo = warp * 16 + (lane >> 2);  // tile rows row_lo, row_lo + 8
  const int warp_last = q0 + warp * 16 + 15;
  const bool warp_idle = q0 + warp * 16 >= S;
  auto skip = [&](int t0) { return warp_idle || (causal && t0 > warp_last); };
  const bool one_tile = nk <= kK;

  load_tile<DP, kQ>(do_s, dout + (long)b * S * o_pitch, o_pitch, h * D, q0,
                    nq, D);
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
    bf16* dst = dqkv + ((long)b * S + row) * row_pitch + h * D;
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
template <int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
         const bf16* __restrict__ probs, const float* __restrict__ delta,
         bf16* __restrict__ dqkv, int S, int H, int D, float scale,
         int causal) {
  constexpr int kPitch = DP + 8, NT = kQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kQ][kPitch]
  bf16* do_s = q_s + kQ * kPitch;                  // [kQ][kPitch]
  bf16* v_s = do_s + kQ * kPitch;                  // [kK][kPitch]
  bf16* p_s = v_s + kK * kPitch;                   // [kQ][kPP]
  float* d_s = reinterpret_cast<float*>(p_s + kQ * kPP);  // [kQ]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row_pitch = 3L * H * D, o_pitch = (long)H * D;
  const bf16* src = qkv + (long)b * S * row_pitch;
  const bf16* dsrc = dout + (long)b * S * o_pitch;
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
    bf16* dst = dqkv + ((long)b * S + key) * row_pitch;
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

template <int DP>
cudaError_t launch_bwd(const void* qkv, const void* dout, const void* probs,
                       void* dqkv, float* delta, int B, int S, int H, int D,
                       float scale, int causal, cudaStream_t st) {
  constexpr int kSmem = bwd_smem_bytes(DP);
  if (kSmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dq<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dkdv<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (e != cudaSuccess) return e;
  }
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* g = static_cast<const bf16*>(dout);
  const bf16* p = static_cast<const bf16*>(probs);
  bf16* dq = static_cast<bf16*>(dqkv);
  bwd_dq<DP><<<dim3((S + kQ - 1) / kQ, H, B), kThreads, kSmem, st>>>(
      q, g, p, dq, delta, S, H, D, scale, causal);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv<DP><<<dim3((S + kK - 1) / kK, H, B), kThreads, kSmem, st>>>(
      q, g, p, delta, dq, S, H, D, scale, causal);
  return cudaGetLastError();
}

// Takes bf16 rows whose q/k/v slices start on 16-byte boundaries.
bool eligible(const void* a, const void* b, const void* c, int D) {
  return D % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

// Calls launch<DP>(args...) (forward) or launch_bwd<DP>(args...) for the
// smallest multiple of 16 that holds D.
#define MCT_TC_DISPATCH(FN, D, ...)                          \
  switch (((D) + 15) / 16) {                                 \
    case 1: return FN<16>(__VA_ARGS__);                      \
    case 2: return FN<32>(__VA_ARGS__);                      \
    case 3: return FN<48>(__VA_ARGS__);                      \
    case 4: return FN<64>(__VA_ARGS__);                      \
    case 5: return FN<80>(__VA_ARGS__);                      \
    case 6: return FN<96>(__VA_ARGS__);                      \
    case 7: return FN<112>(__VA_ARGS__);                     \
    case 8: return FN<128>(__VA_ARGS__);                     \
    default: return cudaErrorInvalidValue;                   \
  }

cudaError_t dispatch(const void* qkv, void* out, void* probs, int B, int S,
                     int H, int D, float scale, int causal, cudaStream_t st) {
  MCT_TC_DISPATCH(launch, D, qkv, out, probs, B, S, H, D, scale, causal, st)
}

cudaError_t dispatch_bwd(const void* qkv, const void* dout, const void* probs,
                         void* dqkv, float* delta, int B, int S, int H, int D,
                         float scale, int causal, cudaStream_t st) {
  MCT_TC_DISPATCH(launch_bwd, D, qkv, dout, probs, dqkv, delta, B, S, H, D,
                  scale, causal, st)
}

}  // namespace tc

bool valid_shape(int B, int S, int H, int D) {
  return B >= 1 && B <= 65535 && S >= 1 && H >= 1 && H <= 65535 && D >= 1 &&
         D <= kMaxD;
}

}  // namespace

// Forward. probs may be null; otherwise it receives P [B, H, S, S] in the
// input dtype, the probabilities exactly as P.V used them (masked pairs 0).
// Returns the launch's cudaError_t (0 on success).
extern "C" int mct_fused_mha_fwd(const void* qkv, void* out, void* probs,
                                 int B, int S, int H, int D, float scale,
                                 int causal, int dtype, void* stream) {
  if (!valid_shape(B, S, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mct::kFloat32)
    return (int)simt::launch<float>(qkv, out, probs, B, S, H, D, scale,
                                    causal, st);
  if (dtype != mct::kBFloat16) return (int)cudaErrorInvalidValue;
  if (tc::eligible(qkv, out, out, D))
    return (int)tc::dispatch(qkv, out, probs, B, S, H, D, scale, causal, st);
  return (int)simt::launch<__nv_bfloat16>(qkv, out, probs, B, S, H, D, scale,
                                          causal, st);
}

// Backward from the forward's P: dqkv [B, S, 3*H*D] (every element
// written), delta [B*H*S] fp32 scratch. Two launches on `stream`.
extern "C" int mct_fused_mha_bwd(const void* qkv, const void* dout,
                                 const void* probs, void* dqkv, void* delta,
                                 int B, int S, int H, int D, float scale,
                                 int causal, int dtype, void* stream) {
  if (!valid_shape(B, S, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  if (dtype == mct::kFloat32)
    return (int)simt::launch_bwd<float>(qkv, dout, probs, dqkv, dl, B, S, H,
                                        D, scale, causal, st);
  if (dtype != mct::kBFloat16) return (int)cudaErrorInvalidValue;
  if (tc::eligible(qkv, dout, dqkv, D))
    return (int)tc::dispatch_bwd(qkv, dout, probs, dqkv, dl, B, S, H, D,
                                 scale, causal, st);
  return (int)simt::launch_bwd<__nv_bfloat16>(qkv, dout, probs, dqkv, dl, B,
                                              S, H, D, scale, causal, st);
}
