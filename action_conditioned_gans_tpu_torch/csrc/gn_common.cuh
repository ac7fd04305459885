// The GroupNorm passes of the fused conv kernels' epilogue (conv_common.cuh),
// and the element helpers every kernel here uses. (The standalone GroupNorm +
// activation kernel, group_norm_act.cu, is one cluster launch of its own:
// gn_cluster.cuh.)
//
// A conv's output plane is more than one block's shared memory holds, so the
// statistics come from per-tile, per-channel partial sums S1 = sum x and
// S2 = sum x^2 that the conv kernel's epilogue wrote, laid out
// (B, slots, C) in float32. Then:
//   gn_stats_kernel  one block per sample reduces the slots in a fixed order
//                    into per-group mean and rstd (E[x^2] - mean^2, clamped
//                    at 0, as the TPU kernels compute them);
//   gn_apply_kernel  normalise, affine, activation in float32, cast.
// No atomics: the result does not depend on scheduling order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace acg {

constexpr int NT = 256;  // threads per block in every kernel here

// The port's ACTIVATIONS order: none, lrelu, relu, tanh.
enum Act { ACT_NONE = 0, ACT_LRELU = 1, ACT_RELU = 2, ACT_TANH = 3 };

__device__ __forceinline__ float apply_act(float v, int act, float leak) {
  if (act == ACT_LRELU) return v >= 0.f ? v : v * leak;
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_TANH) return tanhf(v);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Grid: B blocks of NT threads. Dynamic shared memory: 2*C floats.
// stats[b, grp] = mean, stats[B*G + b*G + grp] = rstd.
__global__ void __launch_bounds__(NT) gn_stats_kernel(
    const float* __restrict__ psum, const float* __restrict__ psq, float* __restrict__ stats,
    int B, int C, int slots, int groups, int pixels, float eps) {
  extern __shared__ float sm[];
  float* ch_s = sm;
  float* ch_q = sm + C;
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int t = 0; t < slots; ++t) {
      s += psum[((size_t)b * slots + t) * C + c];
      q += psq[((size_t)b * slots + t) * C + c];
    }
    ch_s[c] = s;
    ch_q[c] = q;
  }
  __syncthreads();
  const int cg = C / groups;
  const float count = (float)pixels * (float)cg;
  for (int grp = threadIdx.x; grp < groups; grp += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int c = grp * cg; c < (grp + 1) * cg; ++c) {
      s += ch_s[c];
      q += ch_q[c];
    }
    const float mean = s / count;
    const float var = fmaxf(q / count - mean * mean, 0.f);
    stats[(size_t)b * groups + grp] = mean;
    stats[(size_t)B * groups + (size_t)b * groups + grp] = rsqrtf(var + eps);
  }
}

constexpr int APPLY_CHUNK = 4096;  // elements per apply block

// Grid: (ceil(pixels*C / APPLY_CHUNK), B). Block: NT threads. y is the
// pre-norm input, the conv kernels' float32 scratch.
template <typename TY, typename T>
__global__ void __launch_bounds__(NT) gn_apply_kernel(
    const TY* __restrict__ y, const float* __restrict__ stats,
    const float* __restrict__ scale, const float* __restrict__ bias, T* __restrict__ out,
    int B, int C, int groups, int pixels, int act, float leak) {
  const int b = blockIdx.y;
  const int cg = C / groups;
  const size_t n_el = (size_t)pixels * C;
  const size_t start = (size_t)blockIdx.x * APPLY_CHUNK;
  const size_t end = start + APPLY_CHUNK < n_el ? start + APPLY_CHUNK : n_el;
  const float* mean = stats + (size_t)b * groups;
  const float* rstd = stats + (size_t)B * groups + (size_t)b * groups;
  const TY* yb = y + (size_t)b * n_el;
  T* ob = out + (size_t)b * n_el;
  for (size_t i = start + threadIdx.x; i < end; i += blockDim.x) {
    const int c = (int)(i % C);
    const int grp = c / cg;
    const float v = (to_f32(yb[i]) - mean[grp]) * rstd[grp] * scale[c] + bias[c];
    ob[i] = from_f32<T>(apply_act(v, act, leak));
  }
}

// Launches gn_stats_kernel then gn_apply_kernel on partials already
// written. Returns the first launch error, 0 on success.
template <typename TY, typename T>
int launch_gn_stats_apply(const TY* y, const float* psum, const float* psq, float* stats,
                          const float* scale, const float* bias, T* out, int B, int C,
                          int slots, int groups, int pixels, float eps, int act, float leak,
                          cudaStream_t stream) {
  const size_t smem = 2 * (size_t)C * sizeof(float);
  if (smem > 48 * 1024 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  gn_stats_kernel<<<B, NT, smem, stream>>>(psum, psq, stats, B, C, slots, groups, pixels, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n_el = (size_t)pixels * C;
  const dim3 agrid((unsigned)((n_el + APPLY_CHUNK - 1) / APPLY_CHUNK), B);
  gn_apply_kernel<TY, T><<<agrid, NT, 0, stream>>>(y, stats, scale, bias, out, B, C, groups,
                                                   pixels, act, leak);
  return (int)cudaGetLastError();
}

}  // namespace acg
