// Shared body of the two fused conv kernels (conv_norm_act.cu and
// conv_transpose_norm_act.cu): an implicit-GEMM convolution with float32
// accumulation, followed by bias + activation or by a deterministic
// two-phase GroupNorm + affine + activation.
//
// Layouts are the JAX package's: x is NHWC, w is HWIO, out is NHWC. No
// tensor is rearranged on the host; each kernel indexes x and w in place.
//
// GEMM view, per (sample, phase):
//   rows    p in [0, PH*PW)   output pixels of this phase
//   columns n in [0, Cout)    output channels
//   depth   k in [0, K)       (tap, input channel), channel fastest
// A plain conv has one phase (PH, PW = OH, OW; K = KH*KW*Cin). A k=4 /
// stride-2 conv-transpose has four subpixel phases (r, c), each a 2x2
// stride-1 conv over the input padded by 1 (PH, PW = H, W; K = 4*Cin):
//   y[2a+r, 2b+c] = sum_{dy,dx} x[a+dy+r-1, b+dx+c-1] @ w[2dy+r, 2dx+c].
//
// Products: bfloat16 operands go to the tensor cores (WMMA 16x16x16 here,
// wgmma in conv_wgmma.cuh, mma.sync in conv_transpose_narrow.cuh; float32
// accumulators); float32 operands stay on the CUDA cores (FMA), so the
// float32 path keeps full float32 products.
//
// GroupNorm needs statistics over a whole sample, more than one block's
// shared memory holds (a 32x32x64 float32 plane is 256 KB). So:
//   phase 1  the GEMM kernel: each block computes an output tile of one
//            (sample, phase), writes the pre-norm y (float32) to scratch at
//            its final NHWC position and writes the tile's per-channel sum
//            and sum of squares. Tiles never span two samples.
//   phase 2  gn_stats_kernel (gn_common.cuh): one block per sample reduces
//            those partials in a fixed order into per-group mean and rstd
//            (E[x^2] - mean^2, clamped at 0, as the TPU kernel computes).
//   phase 3  gn_apply_kernel (gn_common.cuh): normalise, affine,
//            activation in float32, cast.
// No atomics anywhere: the output does not depend on scheduling order.
// With no norm, bias + activation is fused into phase 1 and nothing else
// runs.
#pragma once

#include <mma.h>

#include "gn_common.cuh"

namespace acg {

struct Geom {
  int B, H, W, Cin;    // input
  int OH, OW, Cout;    // output
  int KH, KW, stride;  // plain conv only
  int pad_h, pad_w;    // plain conv only: SAME padding before
  int PH, PW;          // per-phase output grid
  int phases;          // 1 (conv) or 4 (conv-transpose)
  int K;               // GEMM depth
  int tiles;           // row tiles per (sample, phase): ceil(PH*PW / tile rows)
};

// Output rows per tile of the FMA and WMMA mainloops. bfloat16 calls with
// at most 16 output channels that reach them (a GroupNorm conv-transpose
// with Cout <= 16; the generator's norm-free last layer takes
// conv_transpose_narrow.cuh) take a narrow 128x16 tile instead of 64x64.
inline int tile_rows(int bf16, int cout) { return bf16 && cout <= 16 ? 128 : 64; }

// -- index maps -----------------------------------------------------------------

// Top-left input position of output row p's window (transpose: phase (pr, pc)).
struct Row {
  int ih0, iw0;
  bool ok;
};

template <bool TRANSPOSE>
__device__ __forceinline__ Row row_at(const Geom& g, int p, int pr, int pc) {
  Row r;
  r.ok = p < g.PH * g.PW;
  const int oy = p / g.PW, ox = p - (p / g.PW) * g.PW;
  if (TRANSPOSE) {
    r.ih0 = oy + pr - 1;
    r.iw0 = ox + pc - 1;
  } else {
    r.ih0 = oy * g.stride - g.pad_h;
    r.iw0 = ox * g.stride - g.pad_w;
  }
  return r;
}

// Depth k -> window offset (dih, diw) and input channel.
struct Tap {
  int dih, diw, ci;
  bool ok;
};

template <bool TRANSPOSE>
__device__ __forceinline__ Tap tap_at(const Geom& g, int k) {
  Tap t;
  t.ok = k < g.K;
  t.dih = t.diw = t.ci = 0;
  if (t.ok) {
    const int tap = k / g.Cin;
    t.ci = k - tap * g.Cin;
    if (TRANSPOSE) {
      t.dih = tap >> 1;
      t.diw = tap & 1;
    } else {
      t.dih = tap / g.KW;
      t.diw = tap - t.dih * g.KW;
    }
  }
  return t;
}

// Offset of A[p, k] in one sample's NHWC input, or -1 in the padding.
__device__ __forceinline__ long long a_offset(const Geom& g, const Row& r, const Tap& t) {
  const int ih = r.ih0 + t.dih, iw = r.iw0 + t.diw;
  if (!(r.ok && t.ok && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)) return -1;
  return ((long long)ih * g.W + iw) * g.Cin + t.ci;
}

// Row of B[k, :] in the HWIO weights viewed as (KH*KW*Cin, Cout). The
// transpose reads phase kernel w[2dy+pr, 2dx+pc] for tap (dy, dx).
template <bool TRANSPOSE>
__device__ __forceinline__ size_t w_row(const Geom& g, int k, int pr, int pc) {
  if (!TRANSPOSE) return k;
  const int tap = k / g.Cin;
  const int ci = k - tap * g.Cin;
  return (size_t)((2 * (tap >> 1) + pr) * 4 + 2 * (tap & 1) + pc) * g.Cin + ci;
}

// NHWC offset of output row p at channel 0 (transpose: its depth-to-space
// position 2a+pr, 2b+pc).
template <bool TRANSPOSE>
__device__ __forceinline__ size_t out_offset(const Geom& g, int b, int p, int pr, int pc) {
  const int oy = p / g.PW, ox = p - (p / g.PW) * g.PW;
  const int orow = TRANSPOSE ? 2 * oy + pr : oy;
  const int ocol = TRANSPOSE ? 2 * ox + pc : ox;
  return (((size_t)b * g.OH + orow) * g.OW + ocol) * g.Cout;
}

// -- phase 1 epilogue, shared by both GEMM kernels ----------------------------------

// The block's float32 tile sits in shared memory Cs[BM_][LDC]. Without norm:
// bias + activation + cast straight to out. With GroupNorm: y to scratch, and
// per-channel partial sums over the tile's valid rows, in row order.
template <typename T, bool TRANSPOSE, int BM_, int BN_, int LDC>
__device__ __forceinline__ void tile_epilogue(const float* Cs, const Geom& g, int b, int phase,
                                              int tile, int n0, const float* __restrict__ bias,
                                              T* __restrict__ out, float* __restrict__ y,
                                              float* __restrict__ psum, float* __restrict__ psq,
                                              int group_norm, int act, float leak) {
  const int pr = phase >> 1, pc = phase & 1;
  const int p0 = tile * BM_;
  const int P = g.PH * g.PW;
  for (int idx = threadIdx.x; idx < BM_ * BN_; idx += NT) {
    const int r = idx / BN_, c = idx - (idx / BN_) * BN_;
    const int p = p0 + r, n = n0 + c;
    if (p >= P || n >= g.Cout) continue;
    const float v = Cs[r * LDC + c];
    const size_t o = out_offset<TRANSPOSE>(g, b, p, pr, pc) + n;
    if (group_norm)
      y[o] = v;
    else
      out[o] = from_f32<T>(apply_act(v + bias[n], act, leak));
  }
  if (!group_norm) return;
  const int rows = P - p0 < BM_ ? P - p0 : BM_;
  for (int c = threadIdx.x; c < BN_; c += NT) {
    if (n0 + c >= g.Cout) continue;
    float s = 0.f, q = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float v = Cs[r * LDC + c];
      s += v;
      q += v * v;
    }
    const size_t slot = (((size_t)b * g.phases + phase) * g.tiles + tile) * g.Cout + n0 + c;
    psum[slot] = s;
    psq[slot] = q;
  }
}

// -- phase 1, float32: CUDA-core FMA, 64x64 tile, 4x4 outputs per thread --------------

// Grid: (tiles, ceil(Cout/64), B*phases).
template <bool TRANSPOSE>
__global__ void __launch_bounds__(NT) conv_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, float* __restrict__ y, float* __restrict__ psum,
    float* __restrict__ psq, Geom g, int group_norm, int act, float leak) {
  constexpr int BM_ = 64, BN_ = 64, BK_ = 16, LDC = BN_ + 4;
  __shared__ __align__(16) float As[BK_][BM_ + 4];
  __shared__ __align__(16) float Bs[BK_][BN_];
  __shared__ __align__(16) float Cs[BM_ * LDC];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * BN_;
  const int b = blockIdx.z / g.phases;
  const int phase = blockIdx.z - b * g.phases;
  const int pr = phase >> 1, pc = phase & 1;
  const int p0 = tile * BM_;

  // A loads: thread -> (depth a_k, rows a_m + 16*i); consecutive threads
  // read consecutive input channels of one pixel.
  const int a_k = tid % BK_, a_m = tid / BK_;
  Row rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rows[i] = row_at<TRANSPOSE>(g, p0 + a_m + 16 * i, pr, pc);
  // B loads: thread -> (channel b_n, depth b_k + 4*i); coalesced over Cout.
  const int b_n = tid % BN_, b_k = tid / BN_;
  const float* xb = x + (size_t)b * g.H * g.W * g.Cin;

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += BK_) {
    const Tap t = tap_at<TRANSPOSE>(g, k0 + a_k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long o = a_offset(g, rows[i], t);
      As[a_k][a_m + 16 * i] = o < 0 ? 0.f : xb[o];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + b_k + 4 * i, n = n0 + b_n;
      Bs[b_k + 4 * i][b_n] =
          k < g.K && n < g.Cout ? w[w_row<TRANSPOSE>(g, k, pr, pc) * g.Cout + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK_; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(ty * 4 + i) * LDC + tx * 4 + j] = acc[i][j];
  __syncthreads();
  tile_epilogue<float, TRANSPOSE, BM_, BN_, LDC>(Cs, g, b, phase, tile, n0, bias, out, y, psum,
                                                 psq, group_norm, act, leak);
}

// -- phase 1, bfloat16: tensor cores (WMMA), float32 accumulators -------------------

// V consecutive bfloat16 values moved as one load: a scalar, 8 or 16 bytes.
template <int V> struct Vec;
template <> struct Vec<1> {
  using type = __nv_bfloat16;
  static __device__ __forceinline__ type zero() { return __float2bfloat16(0.f); }
};
template <> struct Vec<4> {
  using type = uint2;
  static __device__ __forceinline__ type zero() { return make_uint2(0u, 0u); }
};
template <> struct Vec<8> {
  using type = uint4;
  static __device__ __forceinline__ type zero() { return make_uint4(0u, 0u, 0u, 0u); }
};

// Eight warps; warp (wm, wn) owns rows 16*wm.. and FRAG_N 16-wide column
// blocks starting at 16*FRAG_N*wn. Grid: (tiles, ceil(Cout/BN_), B*phases).
// Each thread gathers its share of the next stage's A (AV depths of one
// tap per load, which needs Cin % AV == 0) and B (BV channels per load,
// which needs Cout % BV == 0) into registers while the tensor cores work
// on the current stage.
template <bool TRANSPOSE, int BM_, int BN_, int WARPS_N, int FRAG_N, int AV, int BV>
__global__ void __launch_bounds__(NT) conv_wmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, float* __restrict__ y,
    float* __restrict__ psum, float* __restrict__ psq, Geom g, int group_norm, int act,
    float leak) {
  using namespace nvcuda;
  using VA = typename Vec<AV>::type;
  using VB = typename Vec<BV>::type;
  constexpr int BK_ = 32, LDA = BK_ + 8, LDB = BN_ + 8, LDC = BN_ + 4;
  constexpr int A_TPR = BK_ / AV, A_RPP = NT / A_TPR, A_PER = BM_ / A_RPP;
  constexpr int B_TPR = BN_ / BV, B_RPP = NT / B_TPR, B_PER = BK_ / B_RPP;
  static_assert((BM_ / 16) * WARPS_N == NT / 32, "one 16-row strip per warp");
  static_assert(WARPS_N * FRAG_N * 16 == BN_, "warps cover the tile's columns");
  static_assert(A_PER * A_RPP == BM_ && B_PER * B_RPP == BK_, "loads cover the stage");
  __shared__ __align__(32) __nv_bfloat16 As[BM_ * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK_ * LDB];
  __shared__ __align__(32) float Cs[BM_ * LDC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp - (warp / WARPS_N) * WARPS_N;
  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * BN_;
  const int b = blockIdx.z / g.phases;
  const int phase = blockIdx.z - b * g.phases;
  const int pr = phase >> 1, pc = phase & 1;
  const int p0 = tile * BM_;
  const __nv_bfloat16* xb = x + (size_t)b * g.H * g.W * g.Cin;

  // A: thread -> rows a_r + A_RPP*i, depths a_c..a_c+AV-1.
  // B: thread -> depths b_r + B_RPP*i, channels b_c..b_c+BV-1.
  const int a_r = tid / A_TPR, a_c = (tid % A_TPR) * AV;
  const int b_r = tid / B_TPR, b_c = (tid % B_TPR) * BV;
  Row rows[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) rows[i] = row_at<TRANSPOSE>(g, p0 + a_r + A_RPP * i, pr, pc);
  VA ra[A_PER];
  VB rb[B_PER];
  auto fetch = [&](int k0) {
    const Tap t = tap_at<TRANSPOSE>(g, k0 + a_c);
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const long long o = a_offset(g, rows[i], t);
      ra[i] = o < 0 ? Vec<AV>::zero() : *reinterpret_cast<const VA*>(xb + o);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int k = k0 + b_r + B_RPP * i, n = n0 + b_c;
      rb[i] = k < g.K && n < g.Cout
                  ? *reinterpret_cast<const VB*>(w + w_row<TRANSPOSE>(g, k, pr, pc) * g.Cout + n)
                  : Vec<BV>::zero();
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FRAG_N];
#pragma unroll
  for (int f = 0; f < FRAG_N; ++f) wmma::fill_fragment(acc[f], 0.f);

  fetch(0);
  for (int k0 = 0; k0 < g.K; k0 += BK_) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i)
      *reinterpret_cast<VA*>(As + (a_r + A_RPP * i) * LDA + a_c) = ra[i];
#pragma unroll
    for (int i = 0; i < B_PER; ++i)
      *reinterpret_cast<VB*>(Bs + (b_r + B_RPP * i) * LDB + b_c) = rb[i];
    __syncthreads();
    if (k0 + BK_ < g.K) fetch(k0 + BK_);
#pragma unroll
    for (int kk = 0; kk < BK_; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + wm * 16 * LDA + kk, LDA);
#pragma unroll
      for (int f = 0; f < FRAG_N; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + kk * LDB + (wn * FRAG_N + f) * 16, LDB);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < FRAG_N; ++f)
    wmma::store_matrix_sync(Cs + wm * 16 * LDC + (wn * FRAG_N + f) * 16, acc[f], LDC,
                            wmma::mem_row_major);
  __syncthreads();
  tile_epilogue<__nv_bfloat16, TRANSPOSE, BM_, BN_, LDC>(Cs, g, b, phase, tile, n0, bias, out, y,
                                                         psum, psq, group_norm, act, leak);
}

// Picks the A vector width the input allows: 16-byte loads when Cin % 8 == 0,
// 8-byte when Cin % 4 == 0, scalars otherwise.
template <bool TRANSPOSE, int BM_, int BN_, int WARPS_N, int FRAG_N, int BV>
void launch_wmma(const Geom& g, dim3 grid, cudaStream_t stream, const void* x, const void* w,
                 const void* bias, void* out, float* y, float* psum, float* psq, int group_norm,
                 int act, float leak) {
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* wb = (const __nv_bfloat16*)w;
  auto* ob = (__nv_bfloat16*)out;
  const auto* bf = (const float*)bias;
  if (g.Cin % 8 == 0 && (uintptr_t)x % 16 == 0)
    conv_wmma_kernel<TRANSPOSE, BM_, BN_, WARPS_N, FRAG_N, 8, BV><<<grid, NT, 0, stream>>>(
        xb, wb, bf, ob, y, psum, psq, g, group_norm, act, leak);
  else if (g.Cin % 4 == 0 && (uintptr_t)x % 8 == 0)
    conv_wmma_kernel<TRANSPOSE, BM_, BN_, WARPS_N, FRAG_N, 4, BV><<<grid, NT, 0, stream>>>(
        xb, wb, bf, ob, y, psum, psq, g, group_norm, act, leak);
  else
    conv_wmma_kernel<TRANSPOSE, BM_, BN_, WARPS_N, FRAG_N, 1, BV><<<grid, NT, 0, stream>>>(
        xb, wb, bf, ob, y, psum, psq, g, group_norm, act, leak);
}

// Runs phase 1, and phases 2-3 when group_norm is set. Returns the first
// launch error, 0 on success. g.tiles is set here from tile_rows. Scratch
// (group_norm only): y holds B*OH*OW*Cout floats, psum and psq
// B*phases*tiles*Cout each, stats 2*B*groups.
template <bool TRANSPOSE>
int launch_conv_norm_act(Geom g, int bf16, const void* x, const void* w, const void* scale,
                         const void* bias, void* out, void* y, void* psum, void* psq,
                         void* stats, int group_norm, int groups, float eps, int act,
                         float leak, cudaStream_t stream) {
  const int bm = tile_rows(bf16, g.Cout);
  const int bn = bf16 && g.Cout <= 16 ? 16 : 64;
  g.tiles = (g.PH * g.PW + bm - 1) / bm;
  if (g.B * g.phases > 65535 || (g.Cout + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(g.tiles, (g.Cout + bn - 1) / bn, g.B * g.phases);
  float* yf = (float*)y;
  float* ps = (float*)psum;
  float* pq = (float*)psq;
  if (!bf16)
    conv_fma_kernel<TRANSPOSE><<<grid, NT, 0, stream>>>(
        (const float*)x, (const float*)w, (const float*)bias, (float*)out, yf, ps, pq, g,
        group_norm, act, leak);
  else if (bn == 16)
    launch_wmma<TRANSPOSE, 128, 16, 1, 1, 1>(g, grid, stream, x, w, bias, out, yf, ps, pq,
                                             group_norm, act, leak);
  else if (g.Cout % 8 == 0 && (uintptr_t)w % 16 == 0)
    launch_wmma<TRANSPOSE, 64, 64, 2, 2, 8>(g, grid, stream, x, w, bias, out, yf, ps, pq,
                                            group_norm, act, leak);
  else
    launch_wmma<TRANSPOSE, 64, 64, 2, 2, 1>(g, grid, stream, x, w, bias, out, yf, ps, pq,
                                            group_norm, act, leak);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !group_norm) return (int)err;

  const int pixels = g.OH * g.OW;
  const int slots = g.phases * g.tiles;
  if (bf16)
    return launch_gn_stats_apply<float, __nv_bfloat16>(
        yf, ps, pq, (float*)stats, (const float*)scale, (const float*)bias, (__nv_bfloat16*)out,
        g.B, g.Cout, slots, groups, pixels, eps, act, leak, stream);
  return launch_gn_stats_apply<float, float>(yf, ps, pq, (float*)stats, (const float*)scale,
                                             (const float*)bias, (float*)out, g.B, g.Cout, slots,
                                             groups, pixels, eps, act, leak, stream);
}

}  // namespace acg
