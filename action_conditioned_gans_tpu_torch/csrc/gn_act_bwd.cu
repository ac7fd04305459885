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
// grp = c / (C / groups). mean and rstd
// are (B, groups) float32, the two halves of the forward's stats scratch.
//
// What bounds it on an H100: bytes. It does ~20 operations per element and
// must move y (4 bytes), out and g (2 each in bfloat16) and dx (2); far
// below the card's ~295 FLOP/byte ridge. A config1 sample's float32 y at
// 32x32x64 is 256 KB, more than a block's 227 KB of shared memory, so the
// TPU kernel's one-program-per-sample design does not carry over. It runs
// in passes with no atomics (the result does not depend on scheduling):
//   pass 1  grid (row tiles, B): per channel, over the tile's rows,
//           S1 = sum dpre and S2 = sum dpre * xhat. Lanes walk channels
//           (coalesced), warps walk rows; warps combine in a fixed order.
//   pass 2  grid B: reduce the tiles in order, write the per-sample
//           dbias / dscale partials, and the two group means, which follow
//           from S1, S2 alone since h = dpre * scale_c:
//           mean_G(h) = sum_{c in G} scale_c * S1[c] / (HW * cg), likewise
//           mean_G(h * xhat) from S2.
//   pass 2b grid ceil(C / 256): sum the per-sample partials over the batch
//           in order into dscale, dbias (float32).
//   pass 3  grid (chunks, B): the elementwise dx, written in the compute
//           dtype.
// y, out and g are read twice (passes 1 and 3); a fused single-read design
// for samples that fit shared memory is later work.
#include "gn_common.cuh"

namespace {

using acg::from_f32;
using acg::to_f32;

constexpr int NT = 256;          // threads per block
constexpr int WARPS = NT / 32;   // rows walked in parallel in pass 1
constexpr int TILE_ROWS = 64;    // rows (pixels) per pass-1 block
constexpr int DX_CHUNK = 4096;   // elements per pass-3 block

// act'(pre) * g from the saved output (ops/gn.py act_bwd): strict mask at
// leak 0, like relu's.
__device__ __forceinline__ float act_bwd(float g, float out, int act, float leak) {
  if (act == acg::ACT_LRELU) {
    if (leak == 0.f) return out > 0.f ? g : 0.f;
    return out >= 0.f ? g : g * leak;
  }
  if (act == acg::ACT_RELU) return out > 0.f ? g : 0.f;
  if (act == acg::ACT_TANH) return g * (1.f - out * out);
  return g;
}

inline int row_tiles(int hw) { return (hw + TILE_ROWS - 1) / TILE_ROWS; }

// Pass 1. Grid (tiles, B). p1, p2: (B, tiles, C).
template <typename TY, typename T>
__global__ void __launch_bounds__(NT) gn_bwd_partials_kernel(
    const TY* __restrict__ y, const T* __restrict__ out, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ rstd, float* __restrict__ p1,
    float* __restrict__ p2, int HW, int C, int groups, int act, float leak) {
  __shared__ float s1[WARPS][33];
  __shared__ float s2[WARPS][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int tiles = gridDim.x;
  const int r0 = tile * TILE_ROWS;
  const int r1 = r0 + TILE_ROWS < HW ? r0 + TILE_ROWS : HW;
  const int cg = C / groups;
  const size_t base = (size_t)b * HW * C;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float a1 = 0.f, a2 = 0.f;
    if (c < C) {
      const int grp = c / cg;
      const float mu = mean[b * groups + grp], rs = rstd[b * groups + grp];
      for (int r = r0 + warp; r < r1; r += WARPS) {
        const size_t i = base + (size_t)r * C + c;
        const float d = act_bwd(to_f32(g[i]), to_f32(out[i]), act, leak);
        a1 += d;
        a2 += d * ((to_f32(y[i]) - mu) * rs);
      }
    }
    s1[warp][lane] = a1;
    s2[warp][lane] = a2;
    __syncthreads();
    if (warp == 0 && c < C) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        t1 += s1[w][lane];
        t2 += s2[w][lane];
      }
      const size_t slot = ((size_t)b * tiles + tile) * C + c;
      p1[slot] = t1;
      p2[slot] = t2;
    }
    __syncthreads();
  }
}

// Pass 2. Grid B. Dynamic shared memory: 2*C floats. Writes the per-sample
// partials dbias_b, dscale_b (B, C) and the group means mh, mhx (B, groups).
__global__ void __launch_bounds__(NT) gn_bwd_sample_kernel(
    const float* __restrict__ p1, const float* __restrict__ p2, const float* __restrict__ scale,
    float* __restrict__ dbias_b, float* __restrict__ dscale_b, float* __restrict__ mh,
    float* __restrict__ mhx, int HW, int C, int groups, int tiles) {
  extern __shared__ float sm[];
  float* c1 = sm;
  float* c2 = sm + C;
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += NT) {
    float t1 = 0.f, t2 = 0.f;
    for (int t = 0; t < tiles; ++t) {
      t1 += p1[((size_t)b * tiles + t) * C + c];
      t2 += p2[((size_t)b * tiles + t) * C + c];
    }
    c1[c] = t1;
    c2[c] = t2;
    dbias_b[(size_t)b * C + c] = t1;
    dscale_b[(size_t)b * C + c] = t2;
  }
  __syncthreads();
  const int cg = C / groups;
  const float count = (float)HW * (float)cg;
  for (int grp = threadIdx.x; grp < groups; grp += NT) {
    float s = 0.f, q = 0.f;
    for (int c = grp * cg; c < (grp + 1) * cg; ++c) {
      s += scale[c] * c1[c];
      q += scale[c] * c2[c];
    }
    mh[b * groups + grp] = s / count;
    mhx[b * groups + grp] = q / count;
  }
}

// Pass 2b. Grid ceil(C / NT). The batch sum of the per-sample partials, in
// sample order.
__global__ void __launch_bounds__(NT) gn_bwd_batch_sum_kernel(
    const float* __restrict__ dbias_b, const float* __restrict__ dscale_b,
    float* __restrict__ dbias, float* __restrict__ dscale, int B, int C) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c >= C) return;
  float sb = 0.f, ss = 0.f;
  for (int b = 0; b < B; ++b) {
    sb += dbias_b[(size_t)b * C + c];
    ss += dscale_b[(size_t)b * C + c];
  }
  dbias[c] = sb;
  dscale[c] = ss;
}

// Pass 3. Grid (ceil(HW*C / DX_CHUNK), B).
template <typename TY, typename T>
__global__ void __launch_bounds__(NT) gn_bwd_dx_kernel(
    const TY* __restrict__ y, const T* __restrict__ out, const T* __restrict__ g,
    const float* __restrict__ scale, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ mh, const float* __restrict__ mhx,
    T* __restrict__ dx, int HW, int C, int groups, int act, float leak) {
  const int b = blockIdx.y;
  const int cg = C / groups;
  const size_t n_el = (size_t)HW * C;
  const size_t start = (size_t)blockIdx.x * DX_CHUNK;
  const size_t end = start + DX_CHUNK < n_el ? start + DX_CHUNK : n_el;
  const size_t base = (size_t)b * n_el;
  const float* mu = mean + (size_t)b * groups;
  const float* rs = rstd + (size_t)b * groups;
  const float* m1 = mh + (size_t)b * groups;
  const float* m2 = mhx + (size_t)b * groups;
  for (size_t i = start + threadIdx.x; i < end; i += NT) {
    const int c = (int)(i % C);
    const int grp = c / cg;
    const size_t o = base + i;
    const float xhat = (to_f32(y[o]) - mu[grp]) * rs[grp];
    const float h = act_bwd(to_f32(g[o]), to_f32(out[o]), act, leak) * scale[c];
    dx[o] = from_f32<T>(rs[grp] * (h - m1[grp] - xhat * m2[grp]));
  }
}

template <typename TY, typename T>
int launch(const TY* y, const T* out, const T* g, const float* scale, const float* mean,
           const float* rstd, T* dx, float* dscale, float* dbias, float* scratch, int B, int HW,
           int C, int groups, int act, float leak, cudaStream_t stream) {
  const int tiles = row_tiles(HW);
  const size_t smem = 2 * (size_t)C * sizeof(float);
  if (B > 65535 || smem > 48 * 1024 || C % groups) return (int)cudaErrorInvalidConfiguration;
  float* p1 = scratch;
  float* p2 = p1 + (size_t)B * tiles * C;
  float* dbias_b = p2 + (size_t)B * tiles * C;
  float* dscale_b = dbias_b + (size_t)B * C;
  float* mh = dscale_b + (size_t)B * C;
  float* mhx = mh + (size_t)B * groups;

  gn_bwd_partials_kernel<TY, T><<<dim3(tiles, B), NT, 0, stream>>>(
      y, out, g, mean, rstd, p1, p2, HW, C, groups, act, leak);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_sample_kernel<<<B, NT, smem, stream>>>(p1, p2, scale, dbias_b, dscale_b, mh, mhx, HW, C,
                                                groups, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_batch_sum_kernel<<<(C + NT - 1) / NT, NT, 0, stream>>>(dbias_b, dscale_b, dbias, dscale,
                                                               B, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n_el = (size_t)HW * C;
  const dim3 grid((unsigned)((n_el + DX_CHUNK - 1) / DX_CHUNK), B);
  gn_bwd_dx_kernel<TY, T><<<grid, NT, 0, stream>>>(y, out, g, scale, mean, rstd, mh, mhx, dx, HW,
                                                   C, groups, act, leak);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch the wrapper allocates: p1, p2 (B*tiles*C each), the
// per-sample partials (B*C each) and the group means (B*groups each).
extern "C" long long acg_gn_bwd_scratch_floats(int B, int HW, int C, int groups) {
  return 2LL * B * row_tiles(HW) * C + 2LL * B * C + 2LL * B * groups;
}

// bf16: out, g and dx in bfloat16 (else float32); y_bf16: y in bfloat16 too
// (else float32; a bfloat16 y needs bf16). Returns the first launch error, 0
// on success.
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
  using bf = __nv_bfloat16;
  if (y_bf16 && !bf16) return (int)cudaErrorInvalidValue;
  if (y_bf16)
    return launch<bf, bf>((const bf*)y, (const bf*)out, (const bf*)g, sc, mu, rs, (bf*)dx, ds,
                          db, sp, B, HW, C, groups, act, leak, s);
  if (bf16)
    return launch<float, bf>((const float*)y, (const bf*)out, (const bf*)g, sc, mu, rs, (bf*)dx,
                             ds, db, sp, B, HW, C, groups, act, leak, s);
  return launch<float, float>((const float*)y, (const float*)out, (const float*)g, sc, mu, rs,
                              (float*)dx, ds, db, sp, B, HW, C, groups, act, leak, s);
}
