// LayerNorm forward: y = (x - mean) * rsqrt(var + eps) * scale + bias.
//
// Replaces the TPU kernel megatron_clip_tpu/ops/pallas/layernorm.py::
// fused_layer_norm (body _ln_kernel with rms=False, pallas_call in _ln_fwd).
// On the CLIP path it carries ln_pre, ln_1, ln_2, ln_post and ln_final.
//
// Contract. x [rows, W] contiguous, fp32 or bf16; scale and bias [W] fp32;
// y [rows, W] in x's dtype. Mean and variance in fp32 (variance of the
// centred row, as the TPU kernel computes it), normalise, times scale plus
// bias in fp32, one rounding to x's dtype. Any row count: no padding of the
// rows to a block multiple as the TPU kernel does.
//
// What bounds it. About 8 FLOP per element against 4 bytes moved per element
// in bf16 (read once, write once): device-memory bytes bound it on an H100
// by two orders of magnitude. Design for that: one warp per row; the row is
// read once with 16-byte loads into registers (up to 2048 bf16 or 1024 fp32
// columns per row), the two reductions are warp shuffles, and the output is
// written once with 16-byte stores. Rows too wide for registers, or not a
// multiple of 16 bytes, take a plain per-element kernel that reads the row
// three times (the re-reads hit L1/L2).
//
// Why CUDA C++ and not Triton: a row reduction and an elementwise pass are
// short in either; keeping both kernels of the port in CUDA C++ keeps one
// build route (nvcc + ctypes) and no dependency on the triton package.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // rows per block
constexpr int kThreads = kWarps * 32;

// Row kept in registers: C chunks of 16 bytes per lane.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
ln_fwd_reg(const T* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ bias, T* __restrict__ y, long rows, int W,
           float eps) {
  constexpr int V = 16 / sizeof(T);
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int nchunk = W / V;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * W);
  float v[C][V];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int ci = lane + 32 * c;
    if (ci < nchunk) {
      const uint4 raw = xr[ci];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[c][k] = mct::to_float(e[k]);
        sum += v[c][k];
      }
    }
  }
  const float mean = mct::warp_sum(sum) / W;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (lane + 32 * c < nchunk) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[c][k] -= mean;
        sq += v[c][k] * v[c][k];
      }
    }
  }
  const float rstd = rsqrtf(mct::warp_sum(sq) / W + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + row * W);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int ci = lane + 32 * c;
    if (ci < nchunk) {
      alignas(16) T o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int i = ci * V + k;
        o[k] = mct::from_float<T>(v[c][k] * rstd * scale[i] + bias[i]);
      }
      yr[ci] = *reinterpret_cast<const uint4*>(o);
    }
  }
}

// Any width and alignment: three passes over the row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_any(const T* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ bias, T* __restrict__ y, long rows, int W,
           float eps) {
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + row * W;
  float sum = 0.f;
  for (int i = lane; i < W; i += 32) sum += mct::to_float(xr[i]);
  const float mean = mct::warp_sum(sum) / W;
  float sq = 0.f;
  for (int i = lane; i < W; i += 32) {
    const float d = mct::to_float(xr[i]) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(mct::warp_sum(sq) / W + eps);
  for (int i = lane; i < W; i += 32)
    y[row * W + i] = mct::from_float<T>(
        (mct::to_float(xr[i]) - mean) * rstd * scale[i] + bias[i]);
}

template <typename T>
void launch(const void* x, const void* scale, const void* bias, void* y,
            long rows, int W, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
  const bool aligned = W % V == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)y % 16 == 0;
  const int per_lane = (W / V + 31) / 32;
  const T* xt = static_cast<const T*>(x);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  T* yt = static_cast<T*>(y);
  if (aligned && per_lane <= 1)
    ln_fwd_reg<T, 1><<<grid, kThreads, 0, st>>>(xt, s, b, yt, rows, W, eps);
  else if (aligned && per_lane <= 2)
    ln_fwd_reg<T, 2><<<grid, kThreads, 0, st>>>(xt, s, b, yt, rows, W, eps);
  else if (aligned && per_lane <= 4)
    ln_fwd_reg<T, 4><<<grid, kThreads, 0, st>>>(xt, s, b, yt, rows, W, eps);
  else if (aligned && per_lane <= 8)
    ln_fwd_reg<T, 8><<<grid, kThreads, 0, st>>>(xt, s, b, yt, rows, W, eps);
  else
    ln_fwd_any<T><<<grid, kThreads, 0, st>>>(xt, s, b, yt, rows, W, eps);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mct_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, long long rows,
                                  int W, float eps, int dtype, void* stream) {
  if (rows < 1 || W < 1 || (rows + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mct::kFloat32)
    launch<float>(x, scale, bias, y, (long)rows, W, eps, st);
  else if (dtype == mct::kBFloat16)
    launch<__nv_bfloat16>(x, scale, bias, y, (long)rows, W, eps, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
