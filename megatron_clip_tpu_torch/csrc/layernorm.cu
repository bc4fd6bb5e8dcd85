// LayerNorm forward, y = (x - mean) * rsqrt(var + eps) * scale + bias, and
// its backward; RMSNorm, y = x * rsqrt(mean(x^2) + eps) * scale, and its
// backward, as variants of the same kernels (template flag RMS).
//
// Replaces the TPU kernel megatron_clip_tpu/ops/pallas/layernorm.py::
// fused_layer_norm (forward body _ln_kernel with rms=False, pallas_call in
// _ln_fwd) and its VJP rule _fln_bwd, which is jnp in the JAX package and a
// kernel here. On the CLIP path they carry ln_pre, ln_1, ln_2, ln_post and
// ln_final. The RMS variants replace fused_rms_norm (_ln_kernel with
// rms=True, the same pallas_call) and its rule _frms_bwd; they carry every
// norm of the rmsnorm GPT (ln_1, ln_2 of each block and ln_f).
//
// RMS variant. No mean and no bias: the row statistic is mean(x^2) of the
// uncentred row, y = x rstd scale; the backward is _frms_bwd's
// dx = rstd (g - xhat mean(g xhat)) with xhat = x rstd, g = dy scale, and
// only dscale = sum_rows dy xhat is summed over the rows (a [blocks, 1, W]
// scratch instead of [blocks, 2, W]).
//
// Forward contract. x [rows, W] contiguous, fp32 or bf16; scale and bias [W]
// in one parameter dtype P, fp32 or bf16 (read as it is: bf16 -> fp32 is
// exact); y [rows, W] in x's dtype. Mean and variance in fp32 (variance of
// the centred row, as the TPU kernel computes it), normalise, times scale
// plus bias in fp32, one rounding to x's dtype. Any row count: no padding of
// the rows to a block multiple as the TPU kernel does.
//
// Backward contract (_fln_bwd line by line). x and dy [rows, W] in x's
// dtype, scale [W] in P. Per row, in fp32: mean and rstd recomputed from x,
// xhat = (x - mean) rstd, g = dy scale, dx = rstd (g - mean(g) - xhat
// mean(g xhat)), rounded to x's dtype. dscale = sum_rows dy xhat and dbias =
// sum_rows dy, summed in fp32 and each rounded once to P (the value
// `.to(scale.dtype)` of the fp32 sums gives, as _fln_bwd's astype): each
// block writes its partial column sums to a [blocks, 2, W] fp32 scratch and
// a second kernel adds the partials of each column in a fixed order. No
// floating-point atomics, so the sums are the same from run to run.
//
// What bounds them. The forward does about 8 FLOP per element against 4
// bytes moved per element in bf16 (read once, write once), the backward
// about 16 against 6 (x and dy read, dx written): device-memory bytes bound
// both on an H100 by two orders of magnitude (the backward's bound 0.0264 /
// 0.0271 ms at ViT-B/32's 19200 x 768 and 29568 x 512 rows). Rows are read
// once with 16-byte loads into registers, the reductions are shuffles, and
// the output is written once with 16-byte stores. Rows too wide for
// registers, or not a multiple of 16 bytes, take plain per-element kernels
// that read the row several times (the re-reads hit L1/L2).
//
// The forward (ln_fwd). The grid is persistent (as many 128-thread blocks
// as the SMs hold) and each warp, or half-warp at W = 512 in bf16 (16 lanes
// of 4 chunks), walks rows with the grid's stride; a lane loads its
// columns' scale and bias once, as 16-byte vectors, into registers; the
// next row's 16-byte loads go into a second set of registers before this
// row's reductions (double-buffered registers rather than a cp.async.bulk
// ring in shared memory: a row is at most 32 chunks a warp, the loads need
// no barrier between warps, and the registers hold it at every path width);
// the chunk count is exact at the paths' bf16 widths 512, 768, 1024, 1280
// and 2048.
//
// The backward (ln_bwd) follows the forward's plan:
// - persistent grid: the blocks the SMs hold, and no more than give each
//   row group kMinIters rows (so that a block's partial row stays a small
//   share of its traffic at small row counts);
// - a row is G lanes: 16 at W = 512 in bf16, 32, or 64 (two warps) at
//   W = 2048 in bf16 and wherever a row needs more than 128 chunks; the two warps of a row add their row sums
//   through shared memory after a named barrier of 64 threads (registers
//   for a whole 2048 row a warp would be the current and next x and dy,
//   128, scale, 64, and the two column sums, 128: past the 255 a thread may
//   hold);
// - scale in registers, loaded once in its own dtype (a bf16 scale packed
//   two to a register; an fp32 scale at W = 1280 in bf16, 40 values a lane,
//   in shared memory instead, where the registers would spill); the next
//   row's x and dy in a second set of registers before this row's
//   reductions;
// - the column sums in fp32 registers: a lane keeps the same columns for
//   every row it takes, so no shared memory is touched per row (sums kept
//   in shared memory would be read and written for every element, with
//   8-way bank conflicts where a lane owns 8 consecutive columns); at the
//   end the block's row groups add theirs in group order through shared
//   memory and the block writes one partial row;
// - ln_bwd_sum adds the partial rows, 32 columns x 32 slices a block (so
//   that the scratch is read with many loads in flight), and writes dscale
//   and dbias in P: no cast kernel around the call. A second launch rather
//   than a last block that adds every partial row: one block alone would
//   read the whole scratch (1-3 MB) at one SM's share of the bandwidth.
//
// Rounding. Every product that could fuse into an FMA is written with the
// _rn intrinsics (a fused multiply-add where one is meant), so that nvcc's
// contraction cannot differ between instantiations: a bf16 scale and its
// fp32 values give the same bits, wherever the scale is kept.
//
// Fault builds (chip_smoke.py's ln_bwd_teeth; never the default):
// MCT_LN_BWD_FAULT=1 leaves each row group's last row out of the column
// sums; MCT_LN_BWD_FAULT=2 gives the last register chunk of each row the
// previous row's mean(g xhat), as a slip in the double-buffered registers
// would.
//
// Why CUDA C++ and not Triton: a row reduction and an elementwise pass are
// short in either; keeping every kernel of the port in CUDA C++ keeps one
// build route (nvcc + ctypes) and no dependency on the triton package.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

#ifndef MCT_LN_BWD_FAULT
#define MCT_LN_BWD_FAULT 0
#endif

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kThreads = kWarps * 32;

// 16 bytes of T from floats, each rounded once (in registers: a local
// array whose address is taken would live in local memory)
template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&o)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                      __float_as_uint(o[2]), __float_as_uint(o[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// the bf16 in the low (k even) or high (k odd) half of w, as fp32 (by its
// bits: exact)
__device__ __forceinline__ float bf16_half(uint32_t w, int k) {
  return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
}

// element k of 16 bytes of T, as fp32
template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int k) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(word(r, k));
  else
    return bf16_half(word(r, k >> 1), k);
}

// V parameters (scale or bias) of dtype P as 32-bit words, packed as they
// lie in memory (a bf16 scale in half the registers of its fp32 values),
// and parameter k of them as fp32
template <typename P, int V>
struct Params {
  static constexpr int kWords = V * sizeof(P) / 4;
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const P* __restrict__ p) {
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kWords; i += 4) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i / 4];
        w[i] = v.x, w[i + 1] = v.y, w[i + 2] = v.z, w[i + 3] = v.w;
      }
    } else {
      static_assert(kWords == 2, "8, 16 or 32 bytes of parameters");
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ float operator[](int k) const {
    if constexpr (sizeof(P) == 4)
      return __uint_as_float(w[k]);
    else
      return bf16_half(w[k >> 1], k);
  }
};

// Rows kept in registers, G lanes a row (32, or 16 at W = 512 in bf16):
// C chunks of 16 bytes a lane, every chunk in the row when kExact (W = G C
// V), else those below W. Persistent: the block's row groups walk the rows
// with the grid's stride; each lane holds its columns' scale and bias in
// registers from the start, and the next row's chunks are loaded before
// this row's reductions. RMS last, so that a profile can tell the variants
// by the last template argument. At least one block an SM: without it
// ptxas spilled a few bytes at 80-128 registers to fit more blocks.
template <typename T, typename P, int G, int C, bool kExact, bool RMS>
__global__ void __launch_bounds__(kThreads, 1)
ln_fwd(const T* __restrict__ x, const P* __restrict__ scale,
       const P* __restrict__ bias, T* __restrict__ y, long rows, int W,
       float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kPerWarp = 32 / G;  // rows a warp takes at once
  const int lane = threadIdx.x % G;
  const int nchunk = kExact ? G * C : W / V;
  auto ok = [&](int c) { return kExact || lane + G * c < nchunk; };
  Params<P, V> sc[C], bi[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sc[c].zero(), bi[c].zero();
    if (ok(c)) {
      sc[c].load(scale + (lane + G * c) * V);
      if (!RMS) bi[c].load(bias + (lane + G * c) * V);
    }
  }
  // a warp's rows advance together, so that a half-warp whose row is past
  // the end still takes part in the shuffles (on zeros, storing nothing)
  const long first = ((long)blockIdx.x * kWarps + (threadIdx.x >> 5)) *
                         kPerWarp +
                     (threadIdx.x & 31) / G;
  const long stride = (long)gridDim.x * kWarps * kPerWarp;
  const long warp_first = first - (threadIdx.x & 31) / G;
  uint4 cur[C], nxt[C];
  auto load = [&](uint4 (&r)[C], long row) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * W);
#pragma unroll
    for (int c = 0; c < C; ++c)
      r[c] = row < rows && ok(c) ? xr[lane + G * c] : make_uint4(0, 0, 0, 0);
  };
  auto group_sum = [](float v) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  load(cur, first);
  for (long row = first, w0 = warp_first; w0 < rows;
       row += stride, w0 += stride) {
    load(nxt, row + stride);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < V; ++k) sum += elem<T>(cur[c], k);
    const float mean = RMS ? 0.f : group_sum(sum) / W;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!ok(c)) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = elem<T>(cur[c], k) - mean;
        sq = __fmaf_rn(d, d, sq);
      }
    }
    const float rstd = rsqrtf(group_sum(sq) / W + eps);
    if (row < rows) {
      uint4* yr = reinterpret_cast<uint4*>(y + row * W);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!ok(c)) continue;
        float o[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float n = __fmul_rn(
              __fmul_rn(elem<T>(cur[c], k) - mean, rstd), sc[c][k]);
          o[k] = RMS ? n : n + bi[c][k];
        }
        yr[lane + G * c] = pack16<T>(o);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) cur[c] = nxt[c];
  }
}

// Any width and alignment: three passes over the row.
template <typename T, typename P, bool RMS>
__global__ void __launch_bounds__(kThreads)
ln_fwd_any(const T* __restrict__ x, const P* __restrict__ scale,
           const P* __restrict__ bias, T* __restrict__ y, long rows, int W,
           float eps) {
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + row * W;
  float sum = 0.f;
  if (!RMS)
    for (int i = lane; i < W; i += 32) sum += mct::to_float(xr[i]);
  const float mean = RMS ? 0.f : mct::warp_sum(sum) / W;
  float sq = 0.f;
  for (int i = lane; i < W; i += 32) {
    const float d = mct::to_float(xr[i]) - mean;
    sq = __fmaf_rn(d, d, sq);
  }
  const float rstd = rsqrtf(mct::warp_sum(sq) / W + eps);
  for (int i = lane; i < W; i += 32) {
    const float n = __fmul_rn(__fmul_rn(mct::to_float(xr[i]) - mean, rstd),
                              mct::to_float(scale[i]));
    y[row * W + i] =
        mct::from_float<T>(RMS ? n : n + mct::to_float(bias[i]));
  }
}

// The blocks of `kernel` the SMs hold at once (at least 1).
template <typename K>
int resident_blocks(K* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

// A persistent grid: as many blocks as the SMs hold, no more than the rows
// need (kThreads / G rows a block at once).
template <typename T, typename P, int G, int C, bool kExact, bool RMS>
void launch_fwd(const T* x, const P* s, const P* b, T* y, long rows, int W,
                float eps, cudaStream_t st) {
  auto* kernel = ln_fwd<T, P, G, C, kExact, RMS>;
  static const int cap = resident_blocks(kernel);
  const long need = (rows + kThreads / G - 1) / (kThreads / G);
  kernel<<<(unsigned)std::min<long>(cap, need), kThreads, 0, st>>>(
      x, s, b, y, rows, W, eps);
}

template <typename T, typename P, bool RMS>
void launch(const void* x, const void* scale, const void* bias, void* y,
            long rows, int W, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool kBf16 = sizeof(T) == 2;
  const bool aligned = W % V == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)y % 16 == 0 && (uintptr_t)scale % 16 == 0 &&
                       (RMS || (uintptr_t)bias % 16 == 0);
  const int per_lane = (W / V + 31) / 32;
  const T* xt = static_cast<const T*>(x);
  const P* s = static_cast<const P*>(scale);
  const P* b = static_cast<const P*>(bias);
  T* yt = static_cast<T*>(y);
  if (!aligned || per_lane > 8) {
    ln_fwd_any<T, P, RMS>
        <<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, st>>>(
            xt, s, b, yt, rows, W, eps);
    return;
  }
  if constexpr (kBf16) {  // the paths' widths, each chunk count exactly
    if (W == 512)
      return launch_fwd<T, P, 16, 4, true, RMS>(xt, s, b, yt, rows, W, eps,
                                                st);
    if (W == 768)
      return launch_fwd<T, P, 32, 3, true, RMS>(xt, s, b, yt, rows, W, eps,
                                                st);
    if (W == 1024)
      return launch_fwd<T, P, 32, 4, true, RMS>(xt, s, b, yt, rows, W, eps,
                                                st);
    if (W == 1280)
      return launch_fwd<T, P, 32, 5, true, RMS>(xt, s, b, yt, rows, W, eps,
                                                st);
    if (W == 2048)
      return launch_fwd<T, P, 32, 8, true, RMS>(xt, s, b, yt, rows, W, eps,
                                                st);
  }
  if (per_lane <= 1)
    return launch_fwd<T, P, 32, 1, false, RMS>(xt, s, b, yt, rows, W, eps,
                                               st);
  if (per_lane <= 2)
    return launch_fwd<T, P, 32, 2, false, RMS>(xt, s, b, yt, rows, W, eps,
                                               st);
  if (per_lane <= 4)
    return launch_fwd<T, P, 32, 4, false, RMS>(xt, s, b, yt, rows, W, eps,
                                               st);
  launch_fwd<T, P, 32, 8, false, RMS>(xt, s, b, yt, rows, W, eps, st);
}

// ---- backward --------------------------------------------------------------

constexpr int kMaxBwdW = 6144;       // ln_bwd_any: 4 warps x [2][W] fp32
constexpr int kMaxBwdBlocks = 1024;  // partial rows of the scratch
constexpr int kMinIters = 2;         // rows a row group takes at least
constexpr int kSumCols = 32, kSumSlices = 32;  // ln_bwd_sum's block

// Rows kept in registers, G lanes a row (16, 32, or 64: two warps): C
// chunks of 16 bytes a lane of x and of dy, every chunk in the row when
// kExact (W = G C V), else those below W. Persistent as ln_fwd; the lane's
// scale and its column sums (dscale, and for LayerNorm dbias) stay in
// registers for every row it takes. Each block writes its partial column
// sums, added in row-group order, to part[blockIdx.x][S][W]. RMS last and
// launch bounds as ln_fwd.
template <typename T, typename P, int G, int C, bool kExact, bool RMS>
__global__ void __launch_bounds__(kThreads, 1)
ln_bwd(const T* __restrict__ x, const P* __restrict__ scale,
       const T* __restrict__ dy, T* __restrict__ dx,
       float* __restrict__ part, long rows, int W, float eps) {
  static_assert(G == 16 || G == 32 || G == 64, "a row is 16, 32 or 64 lanes");
  constexpr int V = 16 / sizeof(T);
  constexpr int S = RMS ? 1 : 2;  // column sums per column
  constexpr int R = kThreads / G;  // row groups of a block
  constexpr int kCols = G * C * V;  // the columns a row group covers
  // the row groups' column sums at the end, [group][sum][column]
  __shared__ __align__(16) float red[R][S][kCols];
  // two-warp rows: their row sums, [group][exchange][value][warp]
  __shared__ float xch[G > 32 ? R : 1][3][2][2];
  // an fp32 scale of 40 values a lane (a 1280 row in bf16) would spill
  // from registers: it lies in shared memory, [chunk][element][lane], read
  // without bank conflicts
  constexpr bool kSharedScale = sizeof(P) == 4 && C * V >= 40;
  __shared__ float ssc[kSharedScale ? C * V * G : 1];
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int nchunk = kExact ? G * C : W / V;
  auto ok = [&](int c) { return kExact || lane + G * c < nchunk; };
  Params<P, V> sc[kSharedScale ? 1 : C];
  float ds[C][V], db[C][V];  // db: LayerNorm only
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < V; ++k) ds[c][k] = db[c][k] = 0.f;
    if constexpr (!kSharedScale) {
      sc[c].zero();
      if (ok(c)) sc[c].load(scale + (lane + G * c) * V);
    }
  }
  if constexpr (kSharedScale) {
    for (int i = threadIdx.x; i < C * V * G; i += kThreads) {
      const int ci = i / V, c = ci / G;  // column i's chunk, and its lane's
      ssc[(c * V + i % V) * G + ci % G] =
          ci < nchunk ? mct::to_float(scale[i]) : 0.f;
    }
    __syncthreads();
  }
  auto scale_at = [&](int c, int k) {
    if constexpr (kSharedScale)
      return ssc[(c * V + k) * G + lane];
    else
      return sc[c][k];
  };
  const long first = (long)blockIdx.x * R + grp;
  const long stride = (long)gridDim.x * R;
  // a warp's rows advance together, so that a half-warp whose row is past
  // the end still takes part in the shuffles (on zeros, storing nothing);
  // the two warps of a 64-lane row share it
  const long lead = G < 32 ? first - (threadIdx.x & 31) / G : first;
  uint4 cx[C], cg[C], nx[C], ng[C];
  auto load = [&](uint4 (&rx)[C], uint4 (&rg)[C], long row) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * W);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + row * W);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool in = row < rows && ok(c);
      rx[c] = in ? xr[lane + G * c] : make_uint4(0, 0, 0, 0);
      rg[c] = in ? gr[lane + G * c] : make_uint4(0, 0, 0, 0);
    }
  };
  // v[0..n) summed over the row's G lanes. A two-warp row adds its warps'
  // sums through xch[grp][slot] after a 64-thread barrier; a row's
  // exchanges take the slots in turn, so that a warp that runs ahead never
  // overwrites a value its partner has not read yet (its next write to a
  // slot comes after the partner has passed the following barrier).
  auto row_sum = [&](float (&v)[2], int n, int slot) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= n) break;
#pragma unroll
      for (int o = (G < 32 ? G : 32) / 2; o > 0; o >>= 1)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
    }
    if constexpr (G > 32) {
      const int w = (threadIdx.x >> 5) & 1;
      if ((threadIdx.x & 31) == 0)
        for (int i = 0; i < n; ++i) xch[grp][slot][i][w] = v[i];
      asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(64) : "memory");
      for (int i = 0; i < n; ++i)
        v[i] = xch[grp][slot][i][0] + xch[grp][slot][i][1];
    }
  };
  float prev_mgx = 0.f;  // MCT_LN_BWD_FAULT=2 only
  load(cx, cg, first);
  for (long row = first, w0 = lead; w0 < rows; row += stride, w0 += stride) {
    load(nx, ng, row + stride);
    float v[2];
    float mean = 0.f;
    if constexpr (!RMS) {
      v[0] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < V; ++k) v[0] += elem<T>(cx[c], k);
      row_sum(v, 1, 0);
      mean = v[0] / W;
    }
    v[0] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!ok(c)) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = elem<T>(cx[c], k) - mean;
        v[0] = __fmaf_rn(d, d, v[0]);
      }
    }
    row_sum(v, 1, RMS ? 0 : 1);
    const float rstd = rsqrtf(v[0] / W + eps);
    // the column sums, and sums of g = dy scale and g xhat over the row
    const bool add_row = MCT_LN_BWD_FAULT != 1 || row + stride < rows;
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!ok(c)) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = __fmul_rn(elem<T>(cx[c], k) - mean, rstd);
        const float g = elem<T>(cg[c], k);
        if (add_row) {
          ds[c][k] = __fmaf_rn(g, xh, ds[c][k]);
          if (!RMS) db[c][k] += g;
        }
        const float gs = __fmul_rn(g, scale_at(c, k));
        sg += gs;
        sgx = __fmaf_rn(gs, xh, sgx);
      }
    }
    float mg = 0.f, mgx;
    if constexpr (RMS) {
      v[0] = sgx;
      row_sum(v, 1, 1);
      mgx = v[0] / W;
    } else {
      v[0] = sg, v[1] = sgx;
      row_sum(v, 2, 2);
      mg = v[0] / W, mgx = v[1] / W;
    }
    if (row < rows) {
      uint4* dr = reinterpret_cast<uint4*>(dx + row * W);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!ok(c)) continue;
        const float m =
            MCT_LN_BWD_FAULT == 2 && c == C - 1 ? prev_mgx : mgx;
        float o[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = __fmul_rn(elem<T>(cx[c], k) - mean, rstd);
          const float gs = __fmul_rn(elem<T>(cg[c], k), scale_at(c, k));
          o[k] = __fmul_rn(rstd, gs - mg - __fmul_rn(xh, m));
        }
        dr[lane + G * c] = pack16<T>(o);
      }
    }
    prev_mgx = mgx;
#pragma unroll
    for (int c = 0; c < C; ++c) cx[c] = nx[c], cg[c] = ng[c];
  }
  // the block's partial: its row groups' sums added in group order
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const int i = (lane + G * c) * V + k;
      *reinterpret_cast<float4*>(&red[grp][0][i]) =
          make_float4(ds[c][k], ds[c][k + 1], ds[c][k + 2], ds[c][k + 3]);
      if constexpr (!RMS)
        *reinterpret_cast<float4*>(&red[grp][1][i]) = make_float4(
            db[c][k], db[c][k + 1], db[c][k + 2], db[c][k + 3]);
    }
  __syncthreads();
  for (int i = threadIdx.x; i < S * W; i += kThreads) {
    const int s = i / W, col = i - s * W;
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) t += red[r][s][col];
    part[(long)blockIdx.x * S * W + i] = t;
  }
}

// Any width and alignment: several passes over the row, the column sums in
// shared memory, one [S][W] slice a warp.
template <typename T, typename P, bool RMS>
__global__ void __launch_bounds__(kThreads)
ln_bwd_any(const T* __restrict__ x, const P* __restrict__ scale,
           const T* __restrict__ dy, T* __restrict__ dx,
           float* __restrict__ part, long rows, int W, float eps) {
  constexpr int S = RMS ? 1 : 2;
  extern __shared__ float acc[];  // [kWarps][S][W]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dsc = acc + warp * S * W;
  float* dbi = dsc + W;  // LayerNorm only
  for (int i = lane; i < S * W; i += 32) dsc[i] = 0.f;
  __syncwarp();  // lanes own other columns than they zeroed
  for (long row = (long)blockIdx.x * kWarps + warp; row < rows;
       row += (long)gridDim.x * kWarps) {
    const T* xr = x + row * W;
    const T* gr = dy + row * W;
    float sum = 0.f;
    if (!RMS)
      for (int i = lane; i < W; i += 32) sum += mct::to_float(xr[i]);
    const float mean = RMS ? 0.f : mct::warp_sum(sum) / W;
    float sq = 0.f;
    for (int i = lane; i < W; i += 32) {
      const float d = mct::to_float(xr[i]) - mean;
      sq = __fmaf_rn(d, d, sq);
    }
    const float rstd = rsqrtf(mct::warp_sum(sq) / W + eps);
    float sg = 0.f, sgx = 0.f;
    for (int i = lane; i < W; i += 32) {
      const float xh = __fmul_rn(mct::to_float(xr[i]) - mean, rstd);
      const float g = mct::to_float(gr[i]);
      dsc[i] = __fmaf_rn(g, xh, dsc[i]);
      if (!RMS) dbi[i] += g;
      const float gs = __fmul_rn(g, mct::to_float(scale[i]));
      sg += gs;
      sgx = __fmaf_rn(gs, xh, sgx);
    }
    const float mg = RMS ? 0.f : mct::warp_sum(sg) / W;
    const float mgx = mct::warp_sum(sgx) / W;
    for (int i = lane; i < W; i += 32) {
      const float xh = __fmul_rn(mct::to_float(xr[i]) - mean, rstd);
      const float g = __fmul_rn(mct::to_float(gr[i]), mct::to_float(scale[i]));
      dx[row * W + i] =
          mct::from_float<T>(__fmul_rn(rstd, g - mg - __fmul_rn(xh, mgx)));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * W; i += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += acc[w * S * W + i];
    part[(long)blockIdx.x * S * W + i] = t;
  }
}

// out[c] = the sum over p of part[p][c], c < n, rounded once to P: thread
// (x, y) adds the partial rows p = y, y + 32, ... of column 32 blockIdx.x +
// x in order; then warp y adds column 32 blockIdx.x + y's 32 slices by
// shuffles, the same order in every run.
template <typename P, bool RMS>
__global__ void __launch_bounds__(kSumCols * kSumSlices)
ln_bwd_sum(const float* __restrict__ part, int nparts, int n,
           P* __restrict__ out) {
  __shared__ float red[kSumSlices][kSumCols + 1];
  const int c = blockIdx.x * kSumCols + threadIdx.x;
  float t = 0.f;
  if (c < n) {
#pragma unroll 4
    for (int p = threadIdx.y; p < nparts; p += kSumSlices)
      t += part[(long)p * n + c];
  }
  red[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  const float v = mct::warp_sum(red[threadIdx.x][threadIdx.y]);
  const int col = blockIdx.x * kSumCols + threadIdx.y;
  if (threadIdx.x == 0 && col < n) out[col] = mct::from_float<P>(v);
}

// The persistent ln_bwd grid: the blocks the SMs hold, no more than give
// each row group kMinIters rows, and no more than the scratch's max_parts
// partial rows. The blocks the SMs hold are counted for both scale dtypes
// and the fewer taken, so that the grid, and with it the order in which
// the column sums are added, is the same for either: a bf16 scale's dscale
// is the fp32 scale's sum rounded once. Returns the grid.
template <typename T, typename P, int G, int C, bool kExact, bool RMS>
int launch_bwd_rows(const T* x, const P* s, const T* g, T* dx, float* part,
                    int max_parts, long rows, int W, float eps,
                    cudaStream_t st) {
  auto* kernel = ln_bwd<T, P, G, C, kExact, RMS>;
  static const int cap = std::min(
      resident_blocks(ln_bwd<T, float, G, C, kExact, RMS>),
      resident_blocks(ln_bwd<T, __nv_bfloat16, G, C, kExact, RMS>));
  constexpr int R = kThreads / G;
  const long need = (rows + R * kMinIters - 1) / (R * kMinIters);
  const int grid = (int)std::min<long>(std::min<long>(cap, need), max_parts);
  kernel<<<grid, kThreads, 0, st>>>(x, s, g, dx, part, rows, W, eps);
  return grid;
}

// ln_bwd's instantiation for the width: at the paths' bf16 widths each
// chunk count exactly, W = 2048 on two-warp rows; other widths up to 256
// chunks (2048 bf16, 1024 fp32) with guarded chunks. Returns the grid.
template <typename T, typename P, bool RMS>
int launch_rows(const T* x, const P* s, const T* g, T* dx, float* part,
                int max_parts, long rows, int W, float eps,
                cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int nchunk = W / V;
  if constexpr (sizeof(T) == 2) {
    if (W == 512)
      return launch_bwd_rows<T, P, 16, 4, true, RMS>(x, s, g, dx, part,
                                                     max_parts, rows, W, eps,
                                                     st);
    if (W == 768)
      return launch_bwd_rows<T, P, 32, 3, true, RMS>(x, s, g, dx, part,
                                                     max_parts, rows, W, eps,
                                                     st);
    if (W == 1024)
      return launch_bwd_rows<T, P, 32, 4, true, RMS>(x, s, g, dx, part,
                                                     max_parts, rows, W, eps,
                                                     st);
    if (W == 1280)
      return launch_bwd_rows<T, P, 32, 5, true, RMS>(x, s, g, dx, part,
                                                     max_parts, rows, W, eps,
                                                     st);
    if (W == 2048)
      return launch_bwd_rows<T, P, 64, 4, true, RMS>(x, s, g, dx, part,
                                                     max_parts, rows, W, eps,
                                                     st);
  }
  if (nchunk <= 32)
    return launch_bwd_rows<T, P, 32, 1, false, RMS>(x, s, g, dx, part,
                                                    max_parts, rows, W, eps,
                                                    st);
  if (nchunk <= 64)
    return launch_bwd_rows<T, P, 32, 2, false, RMS>(x, s, g, dx, part,
                                                    max_parts, rows, W, eps,
                                                    st);
  if (nchunk <= 128)
    return launch_bwd_rows<T, P, 32, 4, false, RMS>(x, s, g, dx, part,
                                                    max_parts, rows, W, eps,
                                                    st);
  return launch_bwd_rows<T, P, 64, 4, false, RMS>(x, s, g, dx, part,
                                                  max_parts, rows, W, eps,
                                                  st);
}

// The rows' kernel, then ln_bwd_sum over its partial rows: two launches.
template <typename T, typename P, bool RMS>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy,
                       void* dx, float* part, int max_parts, void* out,
                       long rows, int W, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  constexpr int S = RMS ? 1 : 2;
  const bool aligned = W % V == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)dy % 16 == 0 && (uintptr_t)dx % 16 == 0 &&
                       (uintptr_t)scale % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const P* s = static_cast<const P*>(scale);
  const T* gt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  int grid = max_parts;
  if (aligned && W / V <= 256) {
    grid = launch_rows<T, P, RMS>(xt, s, gt, dxt, part, max_parts, rows, W,
                                  eps, st);
  } else {
    const int smem = kWarps * S * W * 4;
    auto* kernel = ln_bwd_any<T, P, RMS>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    kernel<<<grid, kThreads, smem, st>>>(xt, s, gt, dxt, part, rows, W, eps);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ln_bwd_sum<P, RMS><<<(S * W + kSumCols - 1) / kSumCols,
                       dim3(kSumCols, kSumSlices), 0, st>>>(
      part, grid, S * W, static_cast<P*>(out));
  return cudaGetLastError();
}

template <bool RMS>
int fwd_api(const void* x, const void* scale, const void* bias, void* y,
            long long rows, int W, float eps, int dtype, int pdtype,
            void* stream) {
  if (rows < 1 || W < 1 || (rows + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const long n = (long)rows;
  if (dtype == mct::kFloat32 && pdtype == mct::kFloat32)
    launch<float, float, RMS>(x, scale, bias, y, n, W, eps, st);
  else if (dtype == mct::kFloat32 && pdtype == mct::kBFloat16)
    launch<float, bf16, RMS>(x, scale, bias, y, n, W, eps, st);
  else if (dtype == mct::kBFloat16 && pdtype == mct::kFloat32)
    launch<bf16, float, RMS>(x, scale, bias, y, n, W, eps, st);
  else if (dtype == mct::kBFloat16 && pdtype == mct::kBFloat16)
    launch<bf16, bf16, RMS>(x, scale, bias, y, n, W, eps, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <bool RMS>
int bwd_api(const void* x, const void* scale, const void* dy, void* dx,
            void* part, int max_parts, void* out, long long rows, int W,
            float eps, int dtype, int pdtype, void* stream) {
  if (rows < 1 || W < 1 || W > kMaxBwdW || max_parts < 1 ||
      max_parts > kMaxBwdBlocks || max_parts > (rows + kWarps - 1) / kWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  float* p = static_cast<float*>(part);
  const long n = (long)rows;
  if (dtype == mct::kFloat32 && pdtype == mct::kFloat32)
    return (int)launch_bwd<float, float, RMS>(x, scale, dy, dx, p, max_parts,
                                              out, n, W, eps, st);
  if (dtype == mct::kFloat32 && pdtype == mct::kBFloat16)
    return (int)launch_bwd<float, bf16, RMS>(x, scale, dy, dx, p, max_parts,
                                             out, n, W, eps, st);
  if (dtype == mct::kBFloat16 && pdtype == mct::kFloat32)
    return (int)launch_bwd<bf16, float, RMS>(x, scale, dy, dx, p, max_parts,
                                             out, n, W, eps, st);
  if (dtype == mct::kBFloat16 && pdtype == mct::kBFloat16)
    return (int)launch_bwd<bf16, bf16, RMS>(x, scale, dy, dx, p, max_parts,
                                            out, n, W, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x and y in dtype, scale and bias in pdtype (0 fp32, 1 bf16). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mct_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, long long rows,
                                  int W, float eps, int dtype, int pdtype,
                                  void* stream) {
  return fwd_api<false>(x, scale, bias, y, rows, W, eps, dtype, pdtype,
                        stream);
}

// Backward: dx [rows, W] in x's dtype; out [2, W] in scale's pdtype =
// (dscale, dbias); part is a [max_parts, 2, W] fp32 scratch, max_parts =
// min(ceil(rows / 4), 1024), of which the launch uses the first rows (as
// many as its grid has blocks). Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int mct_layer_norm_bwd(const void* x, const void* scale,
                                  const void* dy, void* dx, void* part,
                                  int max_parts, void* out, long long rows,
                                  int W, float eps, int dtype, int pdtype,
                                  void* stream) {
  return bwd_api<false>(x, scale, dy, dx, part, max_parts, out, rows, W, eps,
                        dtype, pdtype, stream);
}

// RMSNorm forward: as mct_layer_norm_fwd without a bias.
extern "C" int mct_rms_norm_fwd(const void* x, const void* scale, void* y,
                                long long rows, int W, float eps, int dtype,
                                int pdtype, void* stream) {
  return fwd_api<true>(x, scale, nullptr, y, rows, W, eps, dtype, pdtype,
                       stream);
}

// RMSNorm backward: out [1, W] in pdtype = dscale; part is [max_parts, 1, W].
extern "C" int mct_rms_norm_bwd(const void* x, const void* scale,
                                const void* dy, void* dx, void* part,
                                int max_parts, void* out, long long rows,
                                int W, float eps, int dtype, int pdtype,
                                void* stream) {
  return bwd_api<true>(x, scale, dy, dx, part, max_parts, out, rows, W, eps,
                       dtype, pdtype, stream);
}
