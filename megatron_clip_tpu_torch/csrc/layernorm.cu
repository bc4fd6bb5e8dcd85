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
// fp32; y [rows, W] in x's dtype. Mean and variance in fp32 (variance of
// the centred row, as the TPU kernel computes it), normalise, times scale
// plus bias in fp32, one rounding to x's dtype. Any row count: no padding of
// the rows to a block multiple as the TPU kernel does.
//
// Backward contract (_fln_bwd line by line). x and dy [rows, W] in x's
// dtype, scale [W] fp32. Per row, in fp32: mean and rstd recomputed from x,
// xhat = (x - mean) rstd, g = dy scale, dx = rstd (g - mean(g) - xhat
// mean(g xhat)), rounded to x's dtype. dscale = sum_rows dy xhat and dbias =
// sum_rows dy, in fp32: each block writes its partial column sums to a
// [blocks, 2, W] fp32 scratch and a second small kernel adds the partials
// of each column in a fixed order. No atomics, so the sums are the same
// from run to run.
//
// What bounds them. The forward does about 8 FLOP per element against 4
// bytes moved per element in bf16 (read once, write once), the backward
// about 12 against 6 (x and dy read, dx written): device-memory bytes bound
// both on an H100 by two orders of magnitude (the forward's bound 0.0176 /
// 0.0181 ms at ViT-B/32's 19200 x 768 and 29568 x 512 rows). Rows are read
// once with 16-byte loads into registers (up to 2048 bf16 or 1024 fp32
// columns per row), the reductions are shuffles, and the output is written
// once with 16-byte stores. Rows too wide for registers, or not a multiple
// of 16 bytes, take plain per-element kernels that read the row several
// times (the re-reads hit L1/L2).
//
// The forward (ln_fwd). The first kernel gave each warp one row and let it
// exit: nothing overlapped a row's loads with its two reductions, each
// element's scale and bias were scalar loads per row, and the chunks a lane
// rounded up to a power of two (768 compiled for 4, 1280 for 8). Now the
// grid is persistent (as many 128-thread blocks as the SMs hold) and each
// warp, or half-warp at W = 512 in bf16 (16 lanes of 4 chunks), walks rows
// with the grid's stride; a lane loads its columns' scale and bias once,
// as 16-byte vectors, into registers; the next row's 16-byte loads go
// into a second set of registers before this row's reductions
// (double-buffered registers rather than a cp.async.bulk ring in shared
// memory: a row is at most 32 chunks a warp, the loads need no barrier
// between warps, and the registers hold it at every path width); the chunk
// count is exact at the paths' bf16 widths 512, 768, 1024, 1280 and 2048.
// The arithmetic is the first kernel's: the fp32 mean, then the mean square of the
// centred row (RMS: of the uncentred row), one rounding of the output.
//
// The backward. Its column partials stay in shared memory, one [2][W]
// slice per warp (each lane owns its columns, so no two threads add to one
// sum), which caps W at kMaxBwdW; its blocks loop over rows, so the scratch
// holds at most kMaxBwdBlocks partial rows however many rows there are.
//
// Why CUDA C++ and not Triton: a row reduction and an elementwise pass are
// short in either; keeping every kernel of the port in CUDA C++ keeps one
// build route (nvcc + ctypes) and no dependency on the triton package.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

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

// Rows kept in registers, G lanes a row (32, or 16 at W = 512 in bf16):
// C chunks of 16 bytes a lane, every chunk in the row when kExact (W = G C
// V), else those below W. Persistent: the block's row groups walk the rows
// with the grid's stride; each lane holds its columns' scale and bias in
// registers from the start, and the next row's chunks are loaded before
// this row's reductions. RMS last, so that a profile can tell the variants
// by the last template argument.
template <typename T, int G, int C, bool kExact, bool RMS>
__global__ void __launch_bounds__(kThreads)
ln_fwd(const T* __restrict__ x, const float* __restrict__ scale,
       const float* __restrict__ bias, T* __restrict__ y, long rows, int W,
       float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kPerWarp = 32 / G;  // rows a warp takes at once
  const int lane = threadIdx.x % G;
  const int nchunk = kExact ? G * C : W / V;
  auto ok = [&](int c) { return kExact || lane + G * c < nchunk; };
  float sc[C][V], bi[C][V];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const int i = (lane + G * c) * V + k;
      const float4 s4 = ok(c) ? *reinterpret_cast<const float4*>(scale + i)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b4 = !RMS && ok(c)
                            ? *reinterpret_cast<const float4*>(bias + i)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      sc[c][k] = s4.x, sc[c][k + 1] = s4.y, sc[c][k + 2] = s4.z;
      sc[c][k + 3] = s4.w;
      bi[c][k] = b4.x, bi[c][k + 1] = b4.y, bi[c][k + 2] = b4.z;
      bi[c][k + 3] = b4.w;
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
    for (int c = 0; c < C; ++c) {
      const T* e = reinterpret_cast<const T*>(&cur[c]);
#pragma unroll
      for (int k = 0; k < V; ++k) sum += mct::to_float(e[k]);
    }
    const float mean = RMS ? 0.f : group_sum(sum) / W;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!ok(c)) continue;
      const T* e = reinterpret_cast<const T*>(&cur[c]);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = mct::to_float(e[k]) - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(group_sum(sq) / W + eps);
    if (row < rows) {
      uint4* yr = reinterpret_cast<uint4*>(y + row * W);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!ok(c)) continue;
        const T* e = reinterpret_cast<const T*>(&cur[c]);
        float o[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float n = (mct::to_float(e[k]) - mean) * rstd * sc[c][k];
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
template <typename T, bool RMS>
__global__ void __launch_bounds__(kThreads)
ln_fwd_any(const T* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ bias, T* __restrict__ y, long rows, int W,
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
    sq += d * d;
  }
  const float rstd = rsqrtf(mct::warp_sum(sq) / W + eps);
  for (int i = lane; i < W; i += 32) {
    const float n = (mct::to_float(xr[i]) - mean) * rstd * scale[i];
    y[row * W + i] = mct::from_float<T>(RMS ? n : n + bias[i]);
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
template <typename T, int G, int C, bool kExact, bool RMS>
void launch_fwd(const T* x, const float* s, const float* b, T* y, long rows,
                int W, float eps, cudaStream_t st) {
  auto* kernel = ln_fwd<T, G, C, kExact, RMS>;
  static const int cap = resident_blocks(kernel);
  const long need = (rows + kThreads / G - 1) / (kThreads / G);
  kernel<<<(unsigned)std::min<long>(cap, need), kThreads, 0, st>>>(
      x, s, b, y, rows, W, eps);
}

template <typename T, bool RMS>
void launch(const void* x, const void* scale, const void* bias, void* y,
            long rows, int W, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool kBf16 = sizeof(T) == 2;
  const bool aligned = W % V == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)y % 16 == 0 && (uintptr_t)scale % 16 == 0 &&
                       (RMS || (uintptr_t)bias % 16 == 0);
  const int per_lane = (W / V + 31) / 32;
  const T* xt = static_cast<const T*>(x);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  T* yt = static_cast<T*>(y);
  if (!aligned || per_lane > 8) {
    ln_fwd_any<T, RMS>
        <<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, st>>>(
            xt, s, b, yt, rows, W, eps);
    return;
  }
  if constexpr (kBf16) {  // the paths' widths, each chunk count exactly
    if (W == 512)
      return launch_fwd<T, 16, 4, true, RMS>(xt, s, b, yt, rows, W, eps, st);
    if (W == 768)
      return launch_fwd<T, 32, 3, true, RMS>(xt, s, b, yt, rows, W, eps, st);
    if (W == 1024)
      return launch_fwd<T, 32, 4, true, RMS>(xt, s, b, yt, rows, W, eps, st);
    if (W == 1280)
      return launch_fwd<T, 32, 5, true, RMS>(xt, s, b, yt, rows, W, eps, st);
    if (W == 2048)
      return launch_fwd<T, 32, 8, true, RMS>(xt, s, b, yt, rows, W, eps, st);
  }
  if (per_lane <= 1)
    return launch_fwd<T, 32, 1, false, RMS>(xt, s, b, yt, rows, W, eps, st);
  if (per_lane <= 2)
    return launch_fwd<T, 32, 2, false, RMS>(xt, s, b, yt, rows, W, eps, st);
  if (per_lane <= 4)
    return launch_fwd<T, 32, 4, false, RMS>(xt, s, b, yt, rows, W, eps, st);
  launch_fwd<T, 32, 8, false, RMS>(xt, s, b, yt, rows, W, eps, st);
}

// ---- backward --------------------------------------------------------------

constexpr int kMaxBwdW = 6144;       // 4 warps x [2][W] fp32 in shared memory
constexpr int kMaxBwdBlocks = 1024;  // partial rows of the scratch

__host__ __device__ inline int bwd_smem_bytes(int W, int sums) {
  return kWarps * sums * W * 4;
}

// Row kept in registers: C chunks of 16 bytes per lane, of x and of dy.
// RMS: no mean, and dscale is the only column sum.
template <typename T, int C, bool RMS>
__global__ void __launch_bounds__(kThreads)
ln_bwd_reg(const T* __restrict__ x, const float* __restrict__ scale,
           const T* __restrict__ dy, T* __restrict__ dx,
           float* __restrict__ part, long rows, int W, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int S = RMS ? 1 : 2;  // column sums per column
  extern __shared__ float acc[];  // [kWarps][S][W]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nchunk = W / V;
  float* dsc = acc + warp * S * W;
  float* dbi = dsc + W;  // LayerNorm only
  for (int i = lane; i < S * W; i += 32) dsc[i] = 0.f;
  __syncwarp();  // lanes own other columns than they zeroed
  for (long row = (long)blockIdx.x * kWarps + warp; row < rows;
       row += (long)gridDim.x * kWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * W);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + row * W);
    float xv[C][V], gv[C][V];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int ci = lane + 32 * c;
      if (ci < nchunk) {
        const uint4 rx = xr[ci], rg = gr[ci];
        const T* ex = reinterpret_cast<const T*>(&rx);
        const T* eg = reinterpret_cast<const T*>(&rg);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          xv[c][k] = mct::to_float(ex[k]);
          gv[c][k] = mct::to_float(eg[k]);
          sum += xv[c][k];
        }
      }
    }
    const float mean = RMS ? 0.f : mct::warp_sum(sum) / W;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (lane + 32 * c < nchunk) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          xv[c][k] -= mean;
          sq += xv[c][k] * xv[c][k];
        }
      }
    }
    const float rstd = rsqrtf(mct::warp_sum(sq) / W + eps);
    // xv becomes xhat; column sums; sums of g and g * xhat over the row
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int ci = lane + 32 * c;
      if (ci < nchunk) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int i = ci * V + k;
          xv[c][k] *= rstd;
          dsc[i] += gv[c][k] * xv[c][k];
          if (!RMS) dbi[i] += gv[c][k];
          gv[c][k] *= scale[i];
          sg += gv[c][k];
          sgx += gv[c][k] * xv[c][k];
        }
      }
    }
    const float mg = RMS ? 0.f : mct::warp_sum(sg) / W;
    const float mgx = mct::warp_sum(sgx) / W;
    uint4* dr = reinterpret_cast<uint4*>(dx + row * W);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int ci = lane + 32 * c;
      if (ci < nchunk) {
        alignas(16) T o[V];
#pragma unroll
        for (int k = 0; k < V; ++k)
          o[k] = mct::from_float<T>(rstd *
                                    (gv[c][k] - mg - xv[c][k] * mgx));
        dr[ci] = *reinterpret_cast<const uint4*>(o);
      }
    }
  }
  __syncthreads();
  // the block's partial: the warps' slices added in warp order
  for (int i = threadIdx.x; i < S * W; i += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += acc[w * S * W + i];
    part[(long)blockIdx.x * S * W + i] = t;
  }
}

// Any width and alignment: several passes over the row.
template <typename T, bool RMS>
__global__ void __launch_bounds__(kThreads)
ln_bwd_any(const T* __restrict__ x, const float* __restrict__ scale,
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
      sq += d * d;
    }
    const float rstd = rsqrtf(mct::warp_sum(sq) / W + eps);
    float sg = 0.f, sgx = 0.f;
    for (int i = lane; i < W; i += 32) {
      const float xh = (mct::to_float(xr[i]) - mean) * rstd;
      const float g = mct::to_float(gr[i]);
      dsc[i] += g * xh;
      if (!RMS) dbi[i] += g;
      sg += g * scale[i];
      sgx += g * scale[i] * xh;
    }
    const float mg = RMS ? 0.f : mct::warp_sum(sg) / W;
    const float mgx = mct::warp_sum(sgx) / W;
    for (int i = lane; i < W; i += 32) {
      const float xh = (mct::to_float(xr[i]) - mean) * rstd;
      const float g = mct::to_float(gr[i]) * scale[i];
      dx[row * W + i] = mct::from_float<T>(rstd * (g - mg - xh * mgx));
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

// out[c] = sum over p of part[p][c], c < 2W, in the order p = ty, ty + 8,
// ... per thread row ty, then the 8 thread rows in order.
__global__ void __launch_bounds__(256)
ln_bwd_reduce(const float* __restrict__ part, int nparts, int n,
              float* __restrict__ out) {
  __shared__ float red[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float t = 0.f;
  if (c < n)
    for (int p = threadIdx.y; p < nparts; p += 8) t += part[(long)p * n + c];
  red[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
#pragma unroll
    for (int y = 1; y < 8; ++y) t += red[y][threadIdx.x];
    out[c] = t;
  }
}

template <typename T, bool RMS>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy,
                       void* dx, float* part, int nparts, float* out,
                       long rows, int W, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  constexpr int S = RMS ? 1 : 2;
  const bool aligned = W % V == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)dy % 16 == 0 && (uintptr_t)dx % 16 == 0;
  const int per_lane = (W / V + 31) / 32;
  const int smem = bwd_smem_bytes(W, S);
  const T* xt = static_cast<const T*>(x);
  const float* s = static_cast<const float*>(scale);
  const T* gt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    kernel<<<nparts, kThreads, smem, st>>>(xt, s, gt, dxt, part, rows, W,
                                           eps);
    return cudaGetLastError();
  };
  cudaError_t e;
  if (aligned && per_lane <= 1)
    e = run(ln_bwd_reg<T, 1, RMS>);
  else if (aligned && per_lane <= 2)
    e = run(ln_bwd_reg<T, 2, RMS>);
  else if (aligned && per_lane <= 4)
    e = run(ln_bwd_reg<T, 4, RMS>);
  else if (aligned && per_lane <= 8)
    e = run(ln_bwd_reg<T, 8, RMS>);
  else
    e = run(ln_bwd_any<T, RMS>);
  if (e != cudaSuccess) return e;
  ln_bwd_reduce<<<(S * W + 31) / 32, dim3(32, 8), 0, st>>>(part, nparts,
                                                            S * W, out);
  return cudaGetLastError();
}

template <bool RMS>
int fwd_api(const void* x, const void* scale, const void* bias, void* y,
            long long rows, int W, float eps, int dtype, void* stream) {
  if (rows < 1 || W < 1 || (rows + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mct::kFloat32)
    launch<float, RMS>(x, scale, bias, y, (long)rows, W, eps, st);
  else if (dtype == mct::kBFloat16)
    launch<__nv_bfloat16, RMS>(x, scale, bias, y, (long)rows, W, eps, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <bool RMS>
int bwd_api(const void* x, const void* scale, const void* dy, void* dx,
            void* part, int nparts, void* out, long long rows, int W,
            float eps, int dtype, void* stream) {
  if (rows < 1 || W < 1 || W > kMaxBwdW || nparts < 1 ||
      nparts > kMaxBwdBlocks || nparts > (rows + kWarps - 1) / kWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (dtype == mct::kFloat32)
    return (int)launch_bwd<float, RMS>(x, scale, dy, dx, p, nparts, o,
                                       (long)rows, W, eps, st);
  if (dtype == mct::kBFloat16)
    return (int)launch_bwd<__nv_bfloat16, RMS>(x, scale, dy, dx, p, nparts,
                                               o, (long)rows, W, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mct_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, long long rows,
                                  int W, float eps, int dtype, void* stream) {
  return fwd_api<false>(x, scale, bias, y, rows, W, eps, dtype, stream);
}

// Backward: dx [rows, W] in x's dtype; out [2, W] fp32 = (dscale, dbias);
// part is [nparts, 2, W] fp32 scratch, nparts = min(ceil(rows / 4), 1024)
// blocks. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int mct_layer_norm_bwd(const void* x, const void* scale,
                                  const void* dy, void* dx, void* part,
                                  int nparts, void* out, long long rows,
                                  int W, float eps, int dtype, void* stream) {
  return bwd_api<false>(x, scale, dy, dx, part, nparts, out, rows, W, eps,
                        dtype, stream);
}

// RMSNorm forward: as mct_layer_norm_fwd without a bias.
extern "C" int mct_rms_norm_fwd(const void* x, const void* scale, void* y,
                                long long rows, int W, float eps, int dtype,
                                void* stream) {
  return fwd_api<true>(x, scale, nullptr, y, rows, W, eps, dtype, stream);
}

// RMSNorm backward: out [1, W] fp32 = dscale; part is [nparts, 1, W].
extern "C" int mct_rms_norm_bwd(const void* x, const void* scale,
                                const void* dy, void* dx, void* part,
                                int nparts, void* out, long long rows, int W,
                                float eps, int dtype, void* stream) {
  return bwd_api<true>(x, scale, dy, dx, part, nparts, out, rows, W, eps,
                       dtype, stream);
}
