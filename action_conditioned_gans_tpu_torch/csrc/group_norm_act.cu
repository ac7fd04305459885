// Standalone GroupNorm + affine + activation.
//
// Replaces the TPU kernel of action_conditioned_gans_tpu/ops/pallas/norm_act.py
// (group_norm_act: fwd_pallas / _kernel), which holds one sample's (H*W, C)
// plane in VMEM, computes the group statistics (float32, E[x^2] - mean^2
// clamped at 0), normalises, applies the affine and the activation in
// float32 and casts, in one program per sample. It runs where a layer's conv
// is too large for the fused conv kernels' envelope: the conv output x
// arrives in the compute dtype and is normalised as it is.
//
// What bounds it on an H100: bytes. It does ~10 operations per element and
// must read x and write out once (2 bytes each in bfloat16), far below the
// card's ~295 FLOP/byte ridge. A sample's plane (up to 2 MB in bfloat16 in the
// presets) is more than a block's 227 KB of shared memory, but not more than
// a cluster of 8 blocks holds. So one launch, one thread-block cluster per
// sample (gn_cluster.cuh holds the plan and the cluster helpers):
//   1. each block starts a 1-D bulk copy (TMA) of its share of the sample's
//      rows into shared memory, and meanwhile reads the rows that do not fit,
//      if any, from global memory;
//   2. it sums S1 = sum x and S2 = sum x^2 per group in float32 over its share;
//   3. cluster barrier; every block reads all blocks' partials through DSMEM
//      in rank order and gets the same mean and rstd; rank 0 writes them to
//      stats (2, B, groups) for the backward;
//   4. it normalises, applies the affine and the activation in float32 and
//      casts its share from shared memory (the rows that did not fit from
//      global memory again, now in L2), with 16-byte stores;
//   5. a second cluster barrier, so that no block leaves while another still
//      reads its partials.
// x is read from device memory once wherever the plan keeps the share in
// shared memory. No atomics: the result does not depend on scheduling order.
#include "gn_cluster.cuh"

namespace {

using acg::NT;
namespace gnc = acg::gnc;

// Grid (cluster, B), cluster (cluster, 1, 1), NT threads, the plan's dynamic
// shared memory. V channels per unit (16 bytes, or 1 when C is no multiple);
// ACT the activation, fixed at compile time. At most 80 registers (three
// blocks an SM), so that the 256 blocks of a small plane at B = 32 are
// resident at once.
template <typename T, int V, int ACT>
__global__ void __launch_bounds__(NT, 3) gn_cluster_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ stats, int B, int HW, int C, int G, int keep_max,
    float eps, float leak) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = (int)gnc::cluster_blocks(), rank = (int)gnc::cluster_rank();
  const int b = blockIdx.y;
  const int r0 = (int)((long long)rank * HW / k);
  const int n = (int)((long long)(rank + 1) * HW / k) - r0;
  const int keep = min(n, keep_max);
  const int U = C / V, cg = C / G;
  const int S = gnc::unit_slots(V, cg), w = V / S, lw = 31 - __clz(w);  // slots of w channels
  T* xs = reinterpret_cast<T*>(smem);
  float* red_s = reinterpret_cast<float*>(smem + gnc::align16((long long)keep_max * C * sizeof(T)));
  float* red_q = red_s + NT * S;
  float* part = red_q + NT * S;  // this block's S1, S2 per group
  float* tot = part + 2 * G;     // the cluster's S1, S2, then mean, rstd
  uint64_t* bar = reinterpret_cast<uint64_t*>(tot + 2 * G);  // the copy's mbarrier
  const size_t base = ((size_t)b * HW + r0) * C;
  const T* xg = x + base;
  T* og = out + base;

  // 1. The kept rows into shared memory: one bulk copy, or element by element
  // when the rows are no multiple of 16 bytes.
  if constexpr (V > 1) {
    if (threadIdx.x == 0) gnc::bar_init(bar);
    __syncthreads();
    if (threadIdx.x == 0) gnc::bulk_load(xs, xg, (uint32_t)(keep * C * sizeof(T)), bar);
  } else {
    for (int i = threadIdx.x; i < keep * C; i += NT) xs[i] = xg[i];
  }
  for (int i = threadIdx.x; i < 2 * G; i += NT) part[i] = 0.f;

  // 2. Partial sums per group, chunk by chunk of at most NT units.
  for (int c0 = 0; c0 < U; c0 += NT) {
    const int cw = min(NT, U - c0), lanes = NT / cw;
    const int u = threadIdx.x % cw, l = threadIdx.x / cw;
    const bool active = l < lanes;
    const int col = (c0 + u) * V;
    float a1[V], a2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
    if (active) {
#pragma unroll 4
      for (int r = keep + l; r < n; r += lanes) {  // rows past the kept ones, from global memory
        float f[V];
        gnc::load_unit<T, V>(xg + (size_t)r * C + col, f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a1[j] += f[j];
          a2[j] += f[j] * f[j];
        }
      }
    }
    if constexpr (V > 1) {
      if (c0 == 0) gnc::bar_wait(bar);
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int r = l; r < keep; r += lanes) {
        float f[V];
        gnc::load_unit<T, V>(xs + r * C + col, f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a1[j] += f[j];
          a2[j] += f[j] * f[j];
        }
      }
      float s1 = 0.f, s2 = 0.f;  // the unit's channels into its slots, in order
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1 += a1[j];
        s2 += a2[j];
        if (((j + 1) & (w - 1)) == 0) {
          red_s[(l * cw + u) * S + (j >> lw)] = s1;
          red_q[(l * cw + u) * S + (j >> lw)] = s2;
          s1 = s2 = 0.f;
        }
      }
    }
    __syncthreads();
    gnc::fold_groups(red_s, red_q, lanes, cw * S, c0 * S, cg / w, G, part);
    __syncthreads();
  }

  // 3. The cluster's statistics, the same in every block. The first chunk's
  // scale and bias load meanwhile.
  float sc0[V], bi0[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sc0[j] = scale[(threadIdx.x % min(NT, U)) * V + j];
    bi0[j] = bias[(threadIdx.x % min(NT, U)) * V + j];
  }
  gnc::cluster_sync();
  gnc::sum_over_cluster(part, tot, 2 * G);
  gnc::cluster_arrive();  // this block is done with the others' shared memory
  __syncthreads();
  const float count = (float)HW * (float)cg;
  for (int g = threadIdx.x; g < G; g += NT) {
    const float mean = tot[g] / count;
    const float var = fmaxf(tot[G + g] / count - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    tot[g] = mean;
    tot[G + g] = rstd;
    if (rank == 0) {
      stats[(size_t)b * G + g] = mean;
      stats[(size_t)B * G + (size_t)b * G + g] = rstd;
    }
  }
  __syncthreads();

  // 4. Normalise, affine, activation in float32, cast; 16-byte stores. The
  // kept rows from shared memory, the others from global memory again.
  for (int c0 = 0; c0 < U; c0 += NT) {
    const int cw = min(NT, U - c0), lanes = NT / cw;
    const int u = threadIdx.x % cw, l = threadIdx.x / cw;
    if (l >= lanes) continue;
    const int col = (c0 + u) * V;
    float m[V], sc[V], bi[V];  // mean, rstd * scale, bias per channel
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int grp = (col + j) / cg;
      m[j] = tot[grp];
      const float rs = tot[G + grp];
      sc[j] = rs * (c0 == 0 ? sc0[j] : scale[col + j]);
      bi[j] = c0 == 0 ? bi0[j] : bias[col + j];
    }
#pragma unroll 2
    for (int r = l; r < keep; r += lanes) {
      float f[V];
      gnc::load_unit<T, V>(xs + r * C + col, f);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = acg::apply_act(fmaf(f[j] - m[j], sc[j], bi[j]), ACT, leak);
      gnc::store_unit<T, V>(og + (size_t)r * C + col, f);
    }
#pragma unroll 4
    for (int r = keep + l; r < n; r += lanes) {
      float f[V];
      gnc::load_unit<T, V>(xg + (size_t)r * C + col, f);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = acg::apply_act(fmaf(f[j] - m[j], sc[j], bi[j]), ACT, leak);
      gnc::store_unit<T, V>(og + (size_t)r * C + col, f);
    }
  }

  // 5. No block leaves while another may still read its partials.
  gnc::cluster_wait();
}

template <typename T, int V, int ACT>
cudaError_t launch(const T* x, const float* scale, const float* bias, T* out, float* stats,
                   const gnc::Plan& p, int B, int HW, int C, int G, float eps, float leak,
                   cudaStream_t stream) {
  auto kernel = gn_cluster_kernel<T, V, ACT>;
  static const cudaError_t attr = gnc::allow_plans(kernel);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];
  gnc::launch_config(cfg, cluster, p, B, stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, scale, bias, out, stats, B, HW, C,
                                             G, p.keep_rows, eps, leak);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_act(const void* x, const float* scale, const float* bias, void* out,
                       float* stats, const gnc::Plan& p, int B, int HW, int C, int G, float eps,
                       int act, float leak, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (act) {
    case acg::ACT_NONE:
      return launch<T, V, acg::ACT_NONE>(xt, scale, bias, ot, stats, p, B, HW, C, G, eps, leak, stream);
    case acg::ACT_LRELU:
      return launch<T, V, acg::ACT_LRELU>(xt, scale, bias, ot, stats, p, B, HW, C, G, eps, leak, stream);
    case acg::ACT_RELU:
      return launch<T, V, acg::ACT_RELU>(xt, scale, bias, ot, stats, p, B, HW, C, G, eps, leak, stream);
    case acg::ACT_TANH:
      return launch<T, V, acg::ACT_TANH>(xt, scale, bias, ot, stats, p, B, HW, C, G, eps, leak, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int run(const void* x, const float* scale, const float* bias, void* out, float* stats, int B,
        int HW, int C, int G, float eps, int act, float leak, cudaStream_t stream) {
  if (B < 1 || B > 65535 || HW < 1 || G < 1 || C % G) return (int)cudaErrorInvalidConfiguration;
  const gnc::Plan p = gnc::make_plan(sizeof(T), B, HW, C, G);
  if (p.smem < 0) return (int)cudaErrorInvalidConfiguration;
  constexpr int VW = 16 / sizeof(T);
  if (p.vec == 1)
    return (int)launch_act<T, 1>(x, scale, bias, out, stats, p, B, HW, C, G, eps, act, leak, stream);
  if ((uintptr_t)x % 16 || (uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  return (int)launch_act<T, VW>(x, scale, bias, out, stats, p, B, HW, C, G, eps, act, leak, stream);
}

// Clusters of the lrelu instance that can be resident at once under plan p.
template <typename T, int V>
int max_active_clusters(const gnc::Plan& p, int B) {
  auto kernel = gn_cluster_kernel<T, V, acg::ACT_LRELU>;
  const cudaError_t attr = gnc::allow_plans(kernel);
  if (attr != cudaSuccess) return -(int)attr;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];
  gnc::launch_config(cfg, cluster, p, B, 0);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

}  // namespace

// The plan of a (B, HW, C) call with `groups` (already resolved) groups:
// out[0..5] = cluster, rows_max, keep_rows, vec, smem, reread (see
// gn_cluster.cuh). Returns 0, or cudaErrorInvalidConfiguration when no plan
// fits a block.
extern "C" int acg_gn_plan(int bf16, int B, int HW, int C, int groups, int* out) {
  const gnc::Plan p = gnc::make_plan(bf16 ? 2 : 4, B, HW, C, groups);
  const int v[6] = {p.cluster, p.rows_max, p.keep_rows, p.vec, p.smem, p.reread};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return p.smem < 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

// How many clusters of the kernel can be resident at once for this call's
// plan, or for the plan at `cluster` blocks per sample when it is not 0 (16
// asks for the non-portable size). Negative: minus the CUDA error.
extern "C" int acg_gn_max_active_clusters(int bf16, int B, int HW, int C, int groups,
                                          int cluster) {
  const int es = bf16 ? 2 : 4;
  const gnc::Plan p = cluster ? gnc::plan_for(es, HW, C, groups, cluster)
                              : gnc::make_plan(es, B, HW, C, groups);
  if (p.smem < 0) return -(int)cudaErrorInvalidConfiguration;
  if (bf16)
    return p.vec > 1 ? max_active_clusters<__nv_bfloat16, 8>(p, B)
                     : max_active_clusters<__nv_bfloat16, 1>(p, B);
  return p.vec > 1 ? max_active_clusters<float, 4>(p, B) : max_active_clusters<float, 1>(p, B);
}

// x, out (B, HW, C) in the compute dtype; scale, bias (C,) float32; stats
// (2, B, groups) float32 receives mean and rstd. One launch; returns its
// error, 0 on success.
extern "C" int acg_group_norm_act(const void* x, const void* scale, const void* bias, void* out,
                                  void* stats, int bf16, int B, int HW, int C, int groups,
                                  float eps, int act, float leak, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return run<__nv_bfloat16>(x, (const float*)scale, (const float*)bias, out, (float*)stats, B,
                              HW, C, groups, eps, act, leak, s);
  return run<float>(x, (const float*)scale, (const float*)bias, out, (float*)stats, B, HW, C,
                    groups, eps, act, leak, s);
}
