// GroupNorm + affine + activation backward from the saved statistics.
//
// Replaces the TPU kernel of action_conditioned_gans_tpu/ops/pallas/gn_bwd.py
// (gn_act_bwd_pallas: run / _kernel), which holds one sample's x, out and
// cotangent in VMEM and computes every reduction and the dx map in one
// program per sample. Same function, from ops/gn.py gn_act_grads:
//
//   xhat = (y - mean) * rstd          dpre = act'(out) * g
//   dbias = sum dpre                  dscale = sum dpre * xhat
//   h = dpre * scale                  dx = rstd * (h - mean_G(h) - xhat * mean_G(h * xhat))
//
// Layouts: y, out, g and dx are canonical NHWC viewed as (B, HW, C). y is
// the fused conv kernels' float32 pre-norm scratch, or, behind the
// standalone GroupNorm kernel, its input in the compute dtype (bfloat16 or
// float32, read as it is: no extra pass casts it); out, g and dx are in the
// compute dtype. The conv-transpose kernel writes its y at the
// depth-to-space position, so one kernel serves both layer kinds with
// grp = c / (C / groups). mean and rstd are (B, groups) float32, the two
// halves of the forward's stats scratch.
//
// What bounds it on an H100: bytes. It does ~20 operations per element and
// must read y (4 bytes, or 2 in bfloat16), out and g (2 each in bfloat16)
// and write dx (2), far below the card's ~295 FLOP/byte ridge. A sample's
// y, out and g (up to 2 MB in the training presets) can be more than a
// block's 227 KB of shared memory, but not more than a cluster of 16 blocks
// holds. So one launch with one thread-block cluster per sample
// (gn_cluster.cuh holds the plan and the cluster helpers), then a small
// batch sum:
//   1. each block starts 1-D bulk copies (TMA) of its share of the sample's
//      rows of y, out and g into shared memory, in up to STAGES stages of
//      rows, each on an mbarrier of its own, stages per-channel copies of
//      scale, mean and rstd meanwhile, and reads the rows that do not fit,
//      if any, from global memory;
//   2. per channel, over its share, in float32: S1 = sum dpre and
//      S2 = sum dpre * xhat (a thread's lane sums dpre * (y - mean) and
//      multiplies by rstd once); the lanes fold per channel in a fixed order;
//      one thread per group folds the block's per-channel sums, weighted by
//      scale, into per-group sums, since h = dpre * scale_c gives
//      mean_G(h) = sum_{c in G} scale_c * S1[c] / (HW * cg), and
//      mean_G(h * xhat) likewise from S2;
//   3. cluster barrier; every block reads all blocks' per-group sums
//      through DSMEM in rank order (every block gets the same bits) and
//      turns them into per-channel coefficients of dx;
//   4. dx = rstd*scale*dpre - (rstd * mean_G(h) + rstd^2 * mean_G(h*xhat) *
//      (y - mean)) from shared memory (the rows that did not fit from global
//      memory again, now in L2), written with 16-byte stores where the unit
//      allows;
//   5. block q reduces channels [q*C/k, (q+1)*C/k) of every block's
//      per-channel sums through DSMEM in rank order into the sample's
//      (dbias_b, dscale_b) row of the (B, 2C) scratch; a second cluster
//      barrier keeps each block's shared memory alive until its peers have
//      read it (a cluster of one block skips both barriers);
//   6. a second launch sums the (B, 2C) partials over the batch in sample
//      order into dbias and dscale.
// The plan is the smallest cluster whose shares fit (fewer, fuller blocks
// run fewer rounds of the fixed per-block chain: barriers, folds, DSMEM
// reads), so y, out and g are read from device memory once wherever some
// cluster of at most 16 blocks holds the sample. No atomics: the result
// does not depend on scheduling order.
#include "gn_cluster.cuh"

namespace {

using acg::NT;
namespace gnc = acg::gnc;

constexpr int STAGES = 4;  // mbarriers a block's kept rows are copied on

// act'(pre) * g from the saved output (ops/gn.py act_bwd): strict mask at
// leak 0, like relu's.
template <int ACT>
__device__ __forceinline__ float act_grad(float g, float out, float leak) {
  if constexpr (ACT == acg::ACT_LRELU) {
    if (leak == 0.f) return out > 0.f ? g : 0.f;
    return out >= 0.f ? g : g * leak;
  } else if constexpr (ACT == acg::ACT_RELU) {
    return out > 0.f ? g : 0.f;
  } else if constexpr (ACT == acg::ACT_TANH) {
    return g * (1.f - out * out);
  }
  return g;
}

// Shared memory past the kept rows: the copies' mbarriers, then floats: the
// lane partials of S1 and S2 (NT * vec each), this block's per-channel sums
// (2 * C), five per-channel coefficients (5 * C: scale, the sample's mean
// and rstd, then dx's two group terms), this block's per-group sums (2 *
// groups) and the cluster's (2 * groups).
inline long long scratch_bytes(int vec, int C, int groups) {
  return gnc::align16(8LL * STAGES + 4LL * (2LL * NT * vec + 7LL * C + 4LL * groups));
}

// Stores V floats to shared memory at p (16-byte aligned when V > 1).
template <int V>
__device__ __forceinline__ void store_floats(float* p, const float (&f)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = f[j];
  }
}

// A row of y (y_bytes an element), out and g (t_bytes each); units of 16
// bytes of out.
inline gnc::Rows bwd_rows(int y_bytes, int t_bytes, int C, int groups) {
  const int vec = C % (16 / t_bytes) == 0 ? 16 / t_bytes : 1;
  return gnc::Rows{(long long)C * (y_bytes + 2 * t_bytes), vec, scratch_bytes(vec, C, groups)};
}

inline gnc::Plan bwd_plan(int y_bytes, int t_bytes, int HW, int C, int groups) {
  return gnc::fit_plan(bwd_rows(y_bytes, t_bytes, C, groups), HW);
}

// The first row r >= a with r = l (mod lanes), for 0 <= l < lanes, a >= 0.
__device__ __forceinline__ int first_row(int a, int l, int lanes) {
  return l + (a - l + lanes - 1) / lanes * lanes;
}

// Grid (cluster, B), cluster (cluster, 1, 1), NT threads, the plan's dynamic
// shared memory. V channels per unit (16 bytes of out, or 1); ACT the
// activation, fixed at compile time. part (B, 2C) receives each sample's
// dbias_b, then dscale_b. At most 128 registers (two blocks an SM), so that
// the blocks of a small plane stay resident together.
template <typename TY, typename T, int V, int ACT>
__global__ void __launch_bounds__(NT, 2) gn_bwd_cluster_kernel(
    const TY* __restrict__ y, const T* __restrict__ out, const T* __restrict__ g,
    const float* __restrict__ scale, const float* __restrict__ mean,
    const float* __restrict__ rstd, T* __restrict__ dx, float* __restrict__ part, int HW, int C,
    int G, int keep_max, float leak) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = (int)gnc::cluster_blocks(), rank = (int)gnc::cluster_rank();
  const int b = blockIdx.y;
  const int r0 = (int)((long long)rank * HW / k);
  const int n = (int)((long long)(rank + 1) * HW / k) - r0;
  const int keep = min(n, keep_max);
  const int U = C / V, cg = C / G;
  const int S = min(STAGES, keep);  // copy stages; stage s holds rows [s*keep/S, (s+1)*keep/S)
  TY* ys = reinterpret_cast<TY*>(smem);
  T* os = reinterpret_cast<T*>(smem + (size_t)keep_max * C * sizeof(TY));
  T* gs = os + (size_t)keep_max * C;
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem + gnc::align16((long long)keep_max * C * (sizeof(TY) + 2 * sizeof(T))));
  float* red_s = reinterpret_cast<float*>(bar + STAGES);
  float* red_q = red_s + NT * V;
  float* ch = red_q + NT * V;  // this block's S1 (C), then S2 (C), per channel
  float* sc_c = ch + 2 * C;    // per channel: scale, the sample's mean and rstd,
  float* mu_c = sc_c + C;      // then rstd * mean_G(h) and rstd^2 * mean_G(h * xhat);
  float* rs_c = mu_c + C;      // rs_c becomes rstd * scale for dx
  float* m_c = rs_c + C;
  float* sq_c = m_c + C;
  float* grp = sq_c + C;       // this block's scale-weighted S1, S2 per group
  float* tot = grp + 2 * G;    // the cluster's
  const size_t base = ((size_t)b * HW + r0) * C;
  const TY* yg = y + base;
  const T* og = out + base;
  const T* gg = g + base;

  // 1. The kept rows into shared memory: three bulk copies a stage, or
  // element by element when the rows are no multiple of 16 bytes. The
  // parameters follow, while the copies run.
  if constexpr (V > 1) {
    if (threadIdx.x == 0)
      for (int s = 0; s < S; ++s) gnc::bar_init(bar + s, 3);
    __syncthreads();
    if (threadIdx.x == 0)
      for (int s = 0; s < S; ++s) {
        const int a = s * keep / S, e = (s + 1) * keep / S;
        const size_t o = (size_t)a * C, m = (size_t)(e - a) * C;
        gnc::bulk_load(ys + o, yg + o, (uint32_t)(m * sizeof(TY)), bar + s);
        gnc::bulk_load(os + o, og + o, (uint32_t)(m * sizeof(T)), bar + s);
        gnc::bulk_load(gs + o, gg + o, (uint32_t)(m * sizeof(T)), bar + s);
      }
  } else {
    for (int i = threadIdx.x; i < keep * C; i += NT) {
      ys[i] = yg[i];
      os[i] = og[i];
      gs[i] = gg[i];
    }
  }
  for (int i = threadIdx.x; i < C; i += NT) {
    const size_t gi = (size_t)b * G + i / cg;
    sc_c[i] = scale[i];
    mu_c[i] = mean[gi];
    rs_c[i] = rstd[gi];
  }
  __syncthreads();

  // 2. Per-channel sums, chunk by chunk of at most NT units; the lanes fold
  // into this block's per-channel sums.
  for (int c0 = 0; c0 < U; c0 += NT) {
    const int cw = min(NT, U - c0), lanes = NT / cw;
    const int u = threadIdx.x % cw, l = threadIdx.x / cw;
    const bool active = l < lanes;
    const int col = (c0 + u) * V;
    float mu[V], a1[V], a2[V];
    gnc::load_unit<float, V>(mu_c + col, mu);
#pragma unroll
    for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
    auto add_row = [&](const TY* yr, const T* orow, const T* gr) {
      float fy[V], fo[V], fg[V];
      gnc::load_unit<TY, V>(yr, fy);
      gnc::load_unit<T, V>(orow, fo);
      gnc::load_unit<T, V>(gr, fg);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = act_grad<ACT>(fg[j], fo[j], leak);
        a1[j] += d;
        a2[j] = fmaf(d, fy[j] - mu[j], a2[j]);
      }
    };
    if (active) {
#pragma unroll 2
      for (int r = keep + l; r < n; r += lanes) {  // rows past the kept ones, from global memory
        const size_t o = (size_t)r * C + col;
        add_row(yg + o, og + o, gg + o);
      }
    }
    for (int s = 0; s < S; ++s) {
      if constexpr (V > 1) {
        if (c0 == 0) gnc::bar_wait(bar + s);
      }
      if (!active) continue;
      const int e = (s + 1) * keep / S;
#pragma unroll 2
      for (int r = first_row(s * keep / S, l, lanes); r < e; r += lanes) {
        const int o = r * C + col;
        add_row(ys + o, os + o, gs + o);
      }
    }
    if (active) {
      float rs[V];
      gnc::load_unit<float, V>(rs_c + col, rs);
#pragma unroll
      for (int j = 0; j < V; ++j) a2[j] *= rs[j];
      store_floats<V>(red_s + (l * cw + u) * V, a1);
      store_floats<V>(red_q + (l * cw + u) * V, a2);
    }
    __syncthreads();
    gnc::fold_lanes(red_s, red_q, lanes, cw * V, ch + c0 * V, ch + C + c0 * V);
    __syncthreads();
  }
  gnc::fold_scaled_groups(ch, ch + C, sc_c, cg, G, grp);

  // 3. The cluster's group sums, the same in every block (a cluster of one
  // block has them already and needs no cluster barrier); then dx's
  // per-channel coefficients.
  const float* sums = grp;
  if (k > 1) {
    gnc::cluster_sync();
    gnc::sum_over_cluster(grp, tot, 2 * G);
    sums = tot;
  }
  __syncthreads();
  const float count = (float)HW * (float)cg;
  for (int i = threadIdx.x; i < C; i += NT) {
    const int gi = i / cg;
    const float rs = rs_c[i];
    m_c[i] = rs * (sums[gi] / count);
    sq_c[i] = rs * rs * (sums[G + gi] / count);
    rs_c[i] = rs * sc_c[i];
  }
  __syncthreads();

  // 4. dx from shared memory (the kept rows) and global memory (the others);
  // 16-byte stores.
  for (int c0 = 0; c0 < U; c0 += NT) {
    const int cw = min(NT, U - c0), lanes = NT / cw;
    const int u = threadIdx.x % cw, l = threadIdx.x / cw;
    if (l >= lanes) continue;
    const int col = (c0 + u) * V;
    // dx = d * sa - (y - mu) * sq - m, per channel
    float mu[V], sa[V], sq[V], m[V];
    gnc::load_unit<float, V>(mu_c + col, mu);
    gnc::load_unit<float, V>(rs_c + col, sa);
    gnc::load_unit<float, V>(sq_c + col, sq);
    gnc::load_unit<float, V>(m_c + col, m);
    auto dx_row = [&](const TY* yr, const T* orow, const T* gr, T* dr) {
      float fy[V], fo[V], fg[V];
      gnc::load_unit<TY, V>(yr, fy);
      gnc::load_unit<T, V>(orow, fo);
      gnc::load_unit<T, V>(gr, fg);
#pragma unroll
      for (int j = 0; j < V; ++j)
        fy[j] = fmaf(act_grad<ACT>(fg[j], fo[j], leak), sa[j], -fmaf(fy[j] - mu[j], sq[j], m[j]));
      gnc::store_unit<T, V>(dr, fy);
    };
    T* dg = dx + base;
#pragma unroll 2
    for (int r = l; r < keep; r += lanes) {
      const int o = r * C + col;
      dx_row(ys + o, os + o, gs + o, dg + o);
    }
#pragma unroll 2
    for (int r = keep + l; r < n; r += lanes) {
      const size_t o = (size_t)r * C + col;
      dx_row(yg + o, og + o, gg + o, dg + o);
    }
  }

  // 5. This block's slice [q0, q1) of the sample's per-channel sums, over the
  // cluster in rank order, into part; then no block leaves while another may
  // still read its sums.
  float* part_b = part + (size_t)b * 2 * C;
  if (k > 1) {
    const int q0 = (int)((long long)rank * C / k), q1 = (int)((long long)(rank + 1) * C / k);
    gnc::sum_over_cluster(ch + q0, part_b + q0, q1 - q0);
    gnc::sum_over_cluster(ch + C + q0, part_b + C + q0, q1 - q0);
    gnc::cluster_arrive();
    gnc::cluster_wait();
  } else {
    for (int i = threadIdx.x; i < 2 * C; i += NT) part_b[i] = ch[i];
  }
}

// Grid ceil(2C / 32), NT threads; block x sums columns [32x, 32x + 32) of
// part (B, 2C) over the batch: its warps stage SUM_ROWS samples of the
// columns in shared memory at a time, then warp 0 adds them in sample order,
// one column a lane. dbias[c] = column c, dscale[c] = column C + c.
constexpr int SUM_ROWS = 256;
__global__ void __launch_bounds__(NT) gn_bwd_batch_sum_kernel(const float* __restrict__ part,
                                                              float* __restrict__ dbias,
                                                              float* __restrict__ dscale, int B,
                                                              int C) {
  __shared__ float rows[SUM_ROWS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, n = 2 * C;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  for (int b0 = 0; b0 < B; b0 += SUM_ROWS) {
    const int m = min(SUM_ROWS, B - b0);
    if (i < n) {
#pragma unroll 8
      for (int r = w; r < m; r += NT / 32) rows[r][lane] = part[(size_t)(b0 + r) * n + i];
    }
    __syncthreads();
    if (w == 0) {
#pragma unroll 16
      for (int r = 0; r < m; ++r) s += rows[r][lane];
    }
    __syncthreads();
  }
  if (w == 0 && i < n) {
    if (i < C)
      dbias[i] = s;
    else
      dscale[i - C] = s;
  }
}

template <typename TY, typename T, int V, int ACT>
cudaError_t launch(const TY* y, const T* out, const T* g, const float* scale, const float* mean,
                   const float* rstd, T* dx, float* part, const gnc::Plan& p, int B, int HW, int C,
                   int G, float leak, cudaStream_t stream) {
  auto kernel = gn_bwd_cluster_kernel<TY, T, V, ACT>;
  static const cudaError_t attr = gnc::allow_plans(kernel);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];
  gnc::launch_config(cfg, cluster, p, B, stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, y, out, g, scale, mean, rstd, dx, part,
                                             HW, C, G, p.keep_rows, leak);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TY, typename T, int V>
cudaError_t launch_act(const void* y, const void* out, const void* g, const float* scale,
                       const float* mean, const float* rstd, void* dx, float* part,
                       const gnc::Plan& p, int B, int HW, int C, int G, int act, float leak,
                       cudaStream_t stream) {
  const TY* yt = static_cast<const TY*>(y);
  const T* ot = static_cast<const T*>(out);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  switch (act) {
    case acg::ACT_NONE:
      return launch<TY, T, V, acg::ACT_NONE>(yt, ot, gt, scale, mean, rstd, dt, part, p, B, HW, C, G, leak, stream);
    case acg::ACT_LRELU:
      return launch<TY, T, V, acg::ACT_LRELU>(yt, ot, gt, scale, mean, rstd, dt, part, p, B, HW, C, G, leak, stream);
    case acg::ACT_RELU:
      return launch<TY, T, V, acg::ACT_RELU>(yt, ot, gt, scale, mean, rstd, dt, part, p, B, HW, C, G, leak, stream);
    case acg::ACT_TANH:
      return launch<TY, T, V, acg::ACT_TANH>(yt, ot, gt, scale, mean, rstd, dt, part, p, B, HW, C, G, leak, stream);
  }
  return cudaErrorInvalidValue;
}

// The cluster launch, then the batch sum. A unit of 1 channel where the plan
// says so or an address is not 16-byte aligned.
template <typename TY, typename T>
int run(const void* y, const void* out, const void* g, const float* scale, const float* mean,
        const float* rstd, void* dx, float* dscale, float* dbias, float* part, int B, int HW,
        int C, int G, int act, float leak, cudaStream_t stream) {
  if (B < 1 || B > 65535 || HW < 1 || G < 1 || C % G) return (int)cudaErrorInvalidConfiguration;
  const gnc::Plan p = bwd_plan(sizeof(TY), sizeof(T), HW, C, G);
  if (p.smem < 0) return (int)cudaErrorInvalidConfiguration;
  constexpr int VW = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)y | (uintptr_t)out | (uintptr_t)g | (uintptr_t)dx) % 16 == 0;
  const cudaError_t err =
      p.vec > 1 && aligned
          ? launch_act<TY, T, VW>(y, out, g, scale, mean, rstd, dx, part, p, B, HW, C, G, act, leak, stream)
          : launch_act<TY, T, 1>(y, out, g, scale, mean, rstd, dx, part, p, B, HW, C, G, act, leak, stream);
  if (err != cudaSuccess) return (int)err;
  gn_bwd_batch_sum_kernel<<<(2 * C + 31) / 32, NT, 0, stream>>>(part, dbias, dscale, B, C);
  return (int)cudaGetLastError();
}

// Clusters of the lrelu instance that can be resident at once under plan p.
template <typename TY, typename T, int V>
int max_active_clusters(const gnc::Plan& p, int B) {
  auto kernel = gn_bwd_cluster_kernel<TY, T, V, acg::ACT_LRELU>;
  const cudaError_t attr = gnc::allow_plans(kernel);
  if (attr != cudaSuccess) return -(int)attr;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];
  gnc::launch_config(cfg, cluster, p, B, 0);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

using bf = __nv_bfloat16;

}  // namespace

// The plan of a (B, HW, C) call with `groups` (already resolved) groups, y
// in y_bytes-byte elements, out and g in t_bytes: out[0..5] = cluster,
// rows_max, keep_rows, vec, smem, reread (see gn_cluster.cuh); B does not
// change it. Returns 0, or cudaErrorInvalidConfiguration when no plan fits a
// block.
extern "C" int acg_gn_bwd_plan(int y_bytes, int t_bytes, int B, int HW, int C, int groups,
                               int* out) {
  const gnc::Plan p = bwd_plan(y_bytes, t_bytes, HW, C, groups);
  const int v[6] = {p.cluster, p.rows_max, p.keep_rows, p.vec, p.smem, p.reread};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return p.smem < 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

// Floats of scratch the wrapper allocates: each sample's dbias_b and
// dscale_b, (B, 2C).
extern "C" long long acg_gn_bwd_scratch_floats(int B, int C) { return 2LL * B * C; }

// How many clusters of the kernel's instance for this call's plan can be
// resident at once. Negative: minus the CUDA error.
extern "C" int acg_gn_bwd_max_active_clusters(int y_bytes, int t_bytes, int B, int HW, int C,
                                              int groups) {
  const gnc::Plan p = bwd_plan(y_bytes, t_bytes, HW, C, groups);
  if (p.smem < 0) return -(int)cudaErrorInvalidConfiguration;
  const bool vec = p.vec > 1;
  if (y_bytes == 2)
    return vec ? max_active_clusters<bf, bf, 8>(p, B) : max_active_clusters<bf, bf, 1>(p, B);
  if (t_bytes == 2)
    return vec ? max_active_clusters<float, bf, 8>(p, B) : max_active_clusters<float, bf, 1>(p, B);
  return vec ? max_active_clusters<float, float, 4>(p, B) : max_active_clusters<float, float, 1>(p, B);
}

// bf16: out, g and dx in bfloat16 (else float32); y_bf16: y in bfloat16 too
// (else float32; a bfloat16 y needs bf16). scratch: acg_gn_bwd_scratch_floats
// floats. Two launches; returns the first launch error, 0 on success.
extern "C" int acg_gn_act_bwd(const void* y, const void* out, const void* g, const void* scale,
                              const void* mean, const void* rstd, void* dx, void* dscale,
                              void* dbias, void* scratch, int y_bf16, int bf16, int B, int HW,
                              int C, int groups, int act, float leak, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* sc = (const float*)scale;
  const auto* mu = (const float*)mean;
  const auto* rs = (const float*)rstd;
  auto* ds = (float*)dscale;
  auto* db = (float*)dbias;
  auto* sp = (float*)scratch;
  if (y_bf16 && !bf16) return (int)cudaErrorInvalidValue;
  if (y_bf16)
    return run<bf, bf>(y, out, g, sc, mu, rs, dx, ds, db, sp, B, HW, C, groups, act, leak, s);
  if (bf16)
    return run<float, bf>(y, out, g, sc, mu, rs, dx, ds, db, sp, B, HW, C, groups, act, leak, s);
  return run<float, float>(y, out, g, sc, mu, rs, dx, ds, db, sp, B, HW, C, groups, act, leak, s);
}
