// Fused multi-head attention, forward, straight off the packed QKV GEMM output.
//
// Replaces the TPU kernel megatron_clip_tpu/ops/pallas/fused_mha.py::
// fused_mha_packed (forward body _fwd_kernel, pallas_call in _fwd), which
// ops/attention.multi_head_attention runs for every attention with S <= 1024,
// head_dim <= 128, no bias/rope/GQA: both CLIP towers (ViT S=50 full mask,
// text S=77 causal).
//
// Contract. qkv [B, S, 3*H*D] contiguous, fp32 or bf16; out [B, S, H*D] in
// the same dtype. For head h the kernel reads q at columns h*D, k at
// (H+h)*D and v at (2H+h)*D of each packed row, so no q/k/v split or head
// transpose is ever written to memory. Arithmetic follows the TPU kernel:
// fp32 scores, times D^-0.5 (the scale argument), causal mask row >= col
// (masked keys get probability exactly 0, as the -1e30 fill gives), fp32
// softmax, probabilities rounded to the input dtype before P.V, fp32
// accumulation, output rounded to the input dtype.
//
// What bounds it. At CLIP shapes one (batch, head) moves S*4*D elements
// (q, k, v in, o out) for 4*S*S*D FLOP: S/2 FLOP per byte in bf16, 25 at
// S=50, far under the ~295 FLOP/byte where an H100's bf16 tensor cores
// become the limit. So the floor is device-memory bytes (~79 MB at ViT-B/32
// batch 256). Design for that: every qkv element is read from device memory
// by the blocks of its own (batch, head) only, and the probabilities
// [S, S] never leave the SM (the TPU kernel also wrote them out for its
// backward; this forward-only kernel does not).
//
// Design. The TPU kernel holds whole S x S tiles of all heads in many MB of
// VMEM. A block here has at most 227 KB of shared memory, so both kernels
// below are tiled over keys and make two passes over the key tiles: pass 1
// finds each row's max and softmax denominator (online rescaling), pass 2
// recomputes the scores, forms the normalised probabilities, rounds them to
// the input dtype exactly where the TPU kernel does, and accumulates P.V.
// A causal block stops at the key tile of its last row.
//
// - tc::fwd (bf16, D a multiple of 8, 16-byte aligned rows; the serving
//   path): one block per (64 query rows, head, batch), 4 warps of 16 rows.
//   Q, K and V tiles of 64 rows are staged in shared memory with 16-byte
//   loads (rows padded by 16 bytes so ldmatrix is conflict-free), and both
//   products run on the tensor cores as mma.sync m16n8k16 bf16 with fp32
//   accumulation. The score accumulators become P's A-operand fragments in
//   registers (rounded to bf16 there), so P never touches shared memory.
//   When one tile holds all the keys a block sees (S <= 64, and the first
//   query tile of a causal S <= 128) K and V are loaded once, with Q, and
//   both passes run on them: at S = 50 a block reads its head's q, k and v
//   once from device memory. Warps whose rows all lie past S only help
//   load. Shared memory: 192 * (D+8) * 2 bytes, 52 KB at D = 128.
// - simt::fwd (fp32, and any other bf16 case): one block per (16 query
//   rows, head, batch), 4 warps of 4 rows, key tiles of 32 staged as fp32;
//   each lane scores one key of the tile against the warp's rows on the
//   fp32 CUDA cores, which keeps fp32 inputs at full fp32 precision (no
//   TF32). At most 44 KB of shared memory (D = 128).
//
// wgmma/TMA tiles and keeping several heads per block are later work.
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
fwd(const T* __restrict__ qkv, T* __restrict__ out, int S, int H, int D,
    float scale, int causal) {
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

  // pass 2: p = exp(s - m) / l rounded to T, out = p . V
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
cudaError_t launch(const void* qkv, void* out, int B, int S, int H, int D,
                   float scale, int causal, cudaStream_t st) {
  const dim3 grid((S + kQTile - 1) / kQTile, H, B);
  fwd<T><<<grid, kThreads, smem_bytes(D), st>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), S, H, D, scale,
      causal);
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
fwd(const bf16* __restrict__ qkv, bf16* __restrict__ out, int S, int H,
    int D, float scale, int causal) {
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

  // pass 2: P = exp(s - m) / l rounded to bf16 (as A fragments), O += P V
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
cudaError_t launch(const void* qkv, void* out, int B, int S, int H, int D,
                   float scale, int causal, cudaStream_t st) {
  constexpr int kSmem = smem_bytes(DP);
  if (kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + kQ - 1) / kQ, H, B);
  fwd<DP><<<grid, kThreads, kSmem, st>>>(static_cast<const bf16*>(qkv),
                                         static_cast<bf16*>(out), S, H, D,
                                         scale, causal);
  return cudaGetLastError();
}

// Takes bf16 rows whose q/k/v slices start on 16-byte boundaries.
bool eligible(const void* qkv, const void* out, int D) {
  return D % 8 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

cudaError_t dispatch(const void* qkv, void* out, int B, int S, int H, int D,
                     float scale, int causal, cudaStream_t st) {
  switch ((D + 15) / 16) {
    case 1: return launch<16>(qkv, out, B, S, H, D, scale, causal, st);
    case 2: return launch<32>(qkv, out, B, S, H, D, scale, causal, st);
    case 3: return launch<48>(qkv, out, B, S, H, D, scale, causal, st);
    case 4: return launch<64>(qkv, out, B, S, H, D, scale, causal, st);
    case 5: return launch<80>(qkv, out, B, S, H, D, scale, causal, st);
    case 6: return launch<96>(qkv, out, B, S, H, D, scale, causal, st);
    case 7: return launch<112>(qkv, out, B, S, H, D, scale, causal, st);
    case 8: return launch<128>(qkv, out, B, S, H, D, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// Returns the launch's cudaError_t (0 on success).
extern "C" int mct_fused_mha_fwd(const void* qkv, void* out, int B, int S,
                                 int H, int D, float scale, int causal,
                                 int dtype, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535 || D < 1 ||
      D > kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mct::kFloat32)
    return (int)simt::launch<float>(qkv, out, B, S, H, D, scale, causal, st);
  if (dtype != mct::kBFloat16) return (int)cudaErrorInvalidValue;
  if (tc::eligible(qkv, out, D))
    return (int)tc::dispatch(qkv, out, B, S, H, D, scale, causal, st);
  return (int)simt::launch<__nv_bfloat16>(qkv, out, B, S, H, D, scale,
                                          causal, st);
}
