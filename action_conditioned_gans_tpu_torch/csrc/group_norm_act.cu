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
// card's ~295 FLOP/byte ridge. A 256x256-frame generator's largest plane,
// 128x128x64, is 2 MB per sample in bfloat16: more than a block's 227 KB of
// shared memory, so the one-program-per-sample design does not carry over.
// It runs in three passes with no atomics (the result does not depend on
// scheduling order):
//   pass a  grid (row tiles, B): per channel, over the tile's rows, the
//           partial sums S1 = sum x and S2 = sum x^2 in float32. Lanes walk
//           channels (coalesced), warps walk rows; warps combine in a fixed
//           order.
//   pass b  gn_stats_kernel (gn_common.cuh), one block per sample: the tiles
//           in order, then per-group mean and rstd, written to the caller's
//           (2, B, groups) buffer for the backward.
//   pass c  gn_apply_kernel (gn_common.cuh): normalise, affine, activation
//           in float32, cast.
// x is read twice (passes a and c); a single-read design for planes that
// fit shared memory is later work.
#include "gn_common.cuh"

namespace {

constexpr int WARPS = acg::NT / 32;  // rows walked in parallel in pass a
constexpr int TILE_ROWS = 256;       // rows (pixels) per pass-a block

inline int row_tiles(int hw) { return (hw + TILE_ROWS - 1) / TILE_ROWS; }

// Pass a. Grid (tiles, B). psum, psq: (B, tiles, C).
template <typename T>
__global__ void __launch_bounds__(acg::NT) gn_partials_kernel(
    const T* __restrict__ x, float* __restrict__ psum, float* __restrict__ psq, int HW, int C) {
  __shared__ float s1[WARPS][33];
  __shared__ float s2[WARPS][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int tiles = gridDim.x;
  const int r0 = tile * TILE_ROWS;
  const int r1 = r0 + TILE_ROWS < HW ? r0 + TILE_ROWS : HW;
  const T* xb = x + (size_t)b * HW * C;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float a1 = 0.f, a2 = 0.f;
    if (c < C) {
      for (int r = r0 + warp; r < r1; r += WARPS) {
        const float v = acg::to_f32(xb[(size_t)r * C + c]);
        a1 += v;
        a2 += v * v;
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
      psum[slot] = t1;
      psq[slot] = t2;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* x, const float* scale, const float* bias, T* out, float* psum, float* psq,
           float* stats, int B, int HW, int C, int groups, float eps, int act, float leak,
           cudaStream_t stream) {
  if (B > 65535 || groups < 1 || C % groups) return (int)cudaErrorInvalidConfiguration;
  const int tiles = row_tiles(HW);
  gn_partials_kernel<T><<<dim3(tiles, B), acg::NT, 0, stream>>>(x, psum, psq, HW, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return acg::launch_gn_stats_apply<T, T>(x, psum, psq, stats, scale, bias, out, B, C, tiles,
                                          groups, HW, eps, act, leak, stream);
}

}  // namespace

// Row tiles per sample: psum and psq each hold B * tiles * C floats.
extern "C" int acg_gn_tiles(int HW) { return row_tiles(HW); }

// x, out (B, HW, C) in the compute dtype; scale, bias (C,) float32; stats
// (2, B, groups) float32 receives mean and rstd. Returns the first launch
// error, 0 on success.
extern "C" int acg_group_norm_act(const void* x, const void* scale, const void* bias, void* out,
                                  void* psum, void* psq, void* stats, int bf16, int B, int HW,
                                  int C, int groups, float eps, int act, float leak,
                                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>((const __nv_bfloat16*)x, (const float*)scale,
                                 (const float*)bias, (__nv_bfloat16*)out, (float*)psum,
                                 (float*)psq, (float*)stats, B, HW, C, groups, eps, act, leak, s);
  return launch<float>((const float*)x, (const float*)scale, (const float*)bias, (float*)out,
                       (float*)psum, (float*)psq, (float*)stats, B, HW, C, groups, eps, act, leak,
                       s);
}
