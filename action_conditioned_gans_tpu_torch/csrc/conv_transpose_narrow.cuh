// Kernel 2's mainloop for bfloat16 layers with at most 16 output channels and
// no GroupNorm: the generator's last layer (every preset's dec_0, Cin 64 ->
// 3 channels, bias + tanh).
//
// What bounds it on an H100: dec_0 at config1's B=128 moves 17 MB of x and
// 3 MB of output for 0.8 GFLOP, so the bound is bytes (0.006 ms), not
// operations. A GEMM tile is the wrong shape: 3 of its 16 or 64 columns
// would be used, and each (sample, phase) block would read x again. So one
// block owns one band of a sample's input rows and does everything for it:
//
//   1. cp.async copies the band, with its one-row and one-column halo and
//      zeros outside the input, into shared memory once (channels padded
//      to CP, a multiple of 16, plus 8 so that rows of a fragment fall in
//      different banks). The band's input rows are contiguous in NHWC, so
//      the copy is one coalesced sweep.
//   2. The block places all 16*Cin*Cout weights in shared memory as the four
//      phase kernels w[2dy+r, 2dx+c], K-major, Cout padded to NP (8 or 16).
//   3. All four phases come from that one read: warp w takes phase w % 4 and
//      every other 16-row m-tile of the phase's (rows x W) plane, a K = 4*CP
//      implicit GEMM on mma.sync m16n8k16 (bfloat16 in, float32
//      accumulators), A fragments by ldmatrix.x4 straight from the band.
//      mma.sync rather than CUDA-core FMA: 0.8 GFLOP in float32 FMA is
//      0.012 ms at the card's peak, twice the byte bound, while the tensor
//      cores do it in a fraction of that even with 5 of 8 columns padding;
//      mma.sync rather than wgmma: a 16-row tile follows one input row, and
//      the work is too small to pay for wgmma's 64-row tiles and
//      descriptors.
//   4. The float32 accumulators go to a staged (2*rows, 2W, Cout) output
//      band in shared memory; then every thread takes 8 consecutive outputs
//      of it: bias, activation in float32, cast last, one 16-byte store.
//      Rows 2*a0 .. 2*(a0+rows)-1 of the output are contiguous in NHWC
//      (384 bytes per output row of dec_0), so the band is one coalesced
//      sweep, and no lane idles on the 5 of 8 padded columns.
//
// A-fragment addresses: m-tile row p of phase (r, c) is input position
// (a, b) = (a0 + p / W, p % W); depth k = tap*CP + ci with tap = 2dy + dx
// reads band row a - a0 + dy + r, band column b + dx + c (the halo is row and
// column 0), channel ci. ldmatrix.x4 takes one 16-byte row address per lane:
// lane l names row (l % 8) + 8 * (l / 8 % 2), depths 8 * (l / 16) .. + 7, of
// the 16 x 16 A tile, and hands back exactly mma.sync's A registers.
//
// On an H100 the block's time goes to issued instructions more than to the
// tensor cores or to shared-memory bandwidth (in timings of variants,
// doubling the ldmatrix instructions left dec_0's time as it was and
// doubling the mma.sync ones moved it little), so index math stays off the
// per-element paths: divisions by multiply-high (FastDiv), the weights
// placed a row of Cout at a time, and the activation applied once per
// output, not once per accumulator slot. Persistent blocks that overlap the
// next band's copy with this band's GEMM ran slower (fewer blocks per SM).
#pragma once

#include "conv_wgmma.cuh"

namespace acg {
namespace narrow {

constexpr int BAND_PIXELS = 128;       // input positions per band: rows * W
constexpr int MPW = 4;                 // m-tiles a warp accumulates at once
constexpr int SMEM_MAX = 113 * 1024;   // two blocks fit an SM (227 KB)

// Shared-memory plan of one block.
struct Plan {
  int rows;             // input rows per band
  int cp, np;           // Cin padded to a multiple of 16, Cout to one of 8
  int cs, ws;           // element strides: band pixel (cp + 8), weight row (4*cp + 8)
  int x_bytes, w_bytes, out_bytes;
  int smem;
};

inline Plan plan(int h, int w, int cin, int cout) {
  Plan p;
  p.rows = w >= BAND_PIXELS ? 1 : BAND_PIXELS / w;
  if (p.rows > h) p.rows = h;
  p.cp = (cin + 15) / 16 * 16;
  p.np = (cout + 7) / 8 * 8;
  p.cs = p.cp + 8;
  p.ws = 4 * p.cp + 8;
  p.x_bytes = (p.rows + 2) * (w + 2) * p.cs * 2;
  p.w_bytes = 4 * p.np * p.ws * 2;
  p.out_bytes = 4 * p.rows * w * cout * 4;  // float32; a multiple of 16
  p.smem = p.x_bytes + p.w_bytes + p.out_bytes;
  return p;
}

inline bool fits(int h, int w, int cin, int cout) {
  return cout <= 16 && plan(h, w, cin, cout).smem <= SMEM_MAX;
}

// n / d for 0 <= n with n * d < 2^32, as one multiply-high by m =
// ceil(2^32 / d): n * m / 2^32 exceeds n / d by less than 1 / d. (SMEM_MAX
// keeps every n * d here below 2^28.)
struct FastDiv {
  uint32_t d, m;
};

inline FastDiv fast_div(int d) {
  return {(uint32_t)d, d == 1 ? 0u : (uint32_t)((0x100000000ull + d - 1) / (uint64_t)d)};
}

__device__ __forceinline__ int div_of(int n, FastDiv q) {
  return q.d == 1 ? n : (int)__umulhi((uint32_t)n, q.m);
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const float* bias;
  __nv_bfloat16* out;
  int H, W, Cin, Cout, act;
  float leak;
  Plan p;
  FastDiv chunks, w2, wd, cind;  // copies per band pixel, W + 2, W, Cin
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The four A registers of m16n8k16 from the 16-byte rows this lane names.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(wg::smem_u32(row)));
}

// D += A * B, m16n8k16, A row-major (16 x 16), B column-major (16 x 8).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Grid: (bands = ceil(H / rows), B). Block: NT threads. Dynamic shared
// memory: Plan::smem. NTILES = NP / 8; V = channels per copy of x (8 when
// Cin % 8 == 0 and x is 16-byte aligned, else 1).
template <int NTILES, int V>
__global__ void __launch_bounds__(NT) narrow_transpose_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Plan pl = a.p;
  auto* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* ws = reinterpret_cast<__nv_bfloat16*>(smem + pl.x_bytes);
  auto* os = reinterpret_cast<float*>(smem + pl.x_bytes + pl.w_bytes);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * pl.rows;
  const int rows = min(pl.rows, a.H - a0);
  const int W2 = a.W + 2;

  // 1. The band: rows a0-1 .. a0+rows, columns -1 .. W, channels 0 .. CP-1;
  // every slot written once, zeros outside x.
  const __nv_bfloat16* xb = a.x + (size_t)b * a.H * a.W * a.Cin;
  const int total = (rows + 2) * W2 * (int)a.chunks.d;
  for (int i = tid; i < total; i += NT) {
    const int pix = div_of(i, a.chunks), ci = (i - pix * (int)a.chunks.d) * V;
    const int s = div_of(pix, a.w2), col = pix - s * W2;
    const int ih = a0 - 1 + s, iw = col - 1;
    const bool in = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W && ci < a.Cin;
    const __nv_bfloat16* src = in ? xb + ((size_t)ih * a.W + iw) * a.Cin + ci : xb;
    if (V == 8)
      wg::cp_async<16, false>(wg::smem_u32(xs + pix * pl.cs + ci), src, in);
    else
      xs[pix * pl.cs + ci] = in ? *src : __float2bfloat16(0.f);
  }
  if (V == 8) wg::cp_async_commit();

  // 2. The weights: zeros, then HWIO row w[kh, kw, ci, :] at phase
  // (kh % 2, kw % 2), tap (kh / 2, kw / 2): ws[(phase*NP + n)*WS + tap*CP + ci].
  for (int i = tid; i < pl.w_bytes / 16; i += NT)
    reinterpret_cast<uint4*>(ws)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
#pragma unroll 4
  for (int r = tid; r < 16 * a.Cin; r += NT) {
    const int kk = div_of(r, a.cind), ci = r - kk * a.Cin;
    const int kh = kk >> 2, kw = kk & 3;
    __nv_bfloat16* dst = ws + ((kh & 1) * 2 + (kw & 1)) * pl.np * pl.ws +
                         ((kh >> 1) * 2 + (kw >> 1)) * pl.cp + ci;
    const __nv_bfloat16* src = a.w + (size_t)r * a.Cout;
    for (int n = 0; n < a.Cout; ++n) dst[n * pl.ws] = __ldg(src + n);
  }
  if (V == 8) wg::cp_async_wait<0>();
  __syncthreads();

  // 3. Warp -> phase warp % 4 and m-tiles warp / 4, + 2, + 4, ... of the
  // phase's rows x W plane; MPW of them at a time.
  const int warp = tid / 32, lane = tid % 32, gq = lane >> 2, tq = lane & 3;
  const int phase = warp & 3, pr = phase >> 1, pc = phase & 1;
  const int P = rows * a.W;
  const int MT = (P + 15) / 16;
  const __nv_bfloat16* wph = ws + phase * pl.np * pl.ws + 2 * tq;
  // This lane's ldmatrix row within an m-tile, and its depth offset.
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lk = 8 * (lane >> 4);
  for (int j0 = warp >> 2; j0 < MT; j0 += 2 * MPW) {
    float acc[MPW][NTILES][4];
    int base[MPW];  // band offset of this lane's ldmatrix row of each m-tile, tap (0, 0)
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      const int p = min(16 * (j0 + 2 * i) + lrow, P - 1);
      const int al = div_of(p, a.wd), bc = p - al * a.W;
      base[i] = ((al + pr) * W2 + bc + pc) * pl.cs + lk;
#pragma unroll
      for (int t = 0; t < NTILES; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][t][q] = 0.f;
    }
    for (int tap = 0; tap < 4; ++tap) {
      const int toff = ((tap >> 1) * W2 + (tap & 1)) * pl.cs;
      for (int c0 = 0; c0 < pl.cp; c0 += 16) {
        const int k = tap * pl.cp + c0;
        uint32_t bf[NTILES][2];
#pragma unroll
        for (int t = 0; t < NTILES; ++t) {
          const __nv_bfloat16* bp = wph + (t * 8 + gq) * pl.ws + k;
          bf[t][0] = ld32(bp);
          bf[t][1] = ld32(bp + 8);
        }
#pragma unroll
        for (int i = 0; i < MPW; ++i) {
          if (j0 + 2 * i >= MT) break;
          uint32_t af[4];
          ldmatrix_x4(af, xs + base[i] + toff + c0);
#pragma unroll
          for (int t = 0; t < NTILES; ++t) mma16816(acc[i][t], af, bf[t]);
        }
      }
    }
    // 4a. The accumulators into the staged output band at
    // (2*(p / W) + r, 2*(p % W) + c).
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (j0 + 2 * i >= MT) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * (j0 + 2 * i) + gq + 8 * h;
        if (p >= P) continue;
        const int al = div_of(p, a.wd), bc = p - al * a.W;
        float* o = os + ((2 * al + pr) * 2 * a.W + 2 * bc + pc) * a.Cout;
#pragma unroll
        for (int t = 0; t < NTILES; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = t * 8 + 2 * tq + e;
            if (n < a.Cout) o[n] = acc[i][t][2 * h + e];
          }
      }
    }
  }
  __syncthreads();

  // 4b. Bias, activation in float32, cast; output rows 2*a0 .. 2*(a0+rows)-1,
  // contiguous in NHWC, 8 outputs per thread and step.
  __nv_bfloat16* ob = a.out + ((size_t)b * 2 * a.H + 2 * a0) * 2 * a.W * a.Cout;
  const int n_out = 4 * rows * a.W * a.Cout;
  const bool v16 = (uintptr_t)ob % 16 == 0;
  for (int e0 = tid * 8; e0 < n_out; e0 += NT * 8) {
    int n = e0 % a.Cout;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float y = e0 + q < n_out ? os[e0 + q] : 0.f;
      const uint32_t h = __bfloat16_as_ushort(
          from_f32<__nv_bfloat16>(apply_act(y + __ldg(a.bias + n), a.act, a.leak)));
      v[q / 2] = q % 2 ? v[q / 2] | h << 16 : h;
      n = n + 1 == a.Cout ? 0 : n + 1;
    }
    if (v16 && e0 + 8 <= n_out) {
      *reinterpret_cast<uint4*>(ob + e0) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      for (int q = 0; q < 8 && e0 + q < n_out; ++q)
        ob[e0 + q] = __ushort_as_bfloat16((unsigned short)(v[q / 2] >> (16 * (q % 2))));
    }
  }
}

template <int NTILES, int V>
int launch_v(const Args& a, dim3 grid, cudaStream_t stream) {
  auto kernel = narrow_transpose_kernel<NTILES, V>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, a.p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Bias + activation only (no GroupNorm). Returns the launch error.
inline int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                  int Cin, int Cout, int act, float leak, cudaStream_t stream) {
  if (!fits(H, W, Cin, Cout) || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const bool v8 = Cin % 8 == 0 && (uintptr_t)x % 16 == 0;
  const Plan p = plan(H, W, Cin, Cout);
  Args a{(const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias,
         (__nv_bfloat16*)out, H, W, Cin, Cout, act, leak, p,
         fast_div(p.cp / (v8 ? 8 : 1)), fast_div(W + 2), fast_div(W), fast_div(Cin)};
  const dim3 grid((H + p.rows - 1) / p.rows, B);
  if (a.p.np == 8) return v8 ? launch_v<1, 8>(a, grid, stream) : launch_v<1, 1>(a, grid, stream);
  return v8 ? launch_v<2, 8>(a, grid, stream) : launch_v<2, 1>(a, grid, stream);
}

}  // namespace narrow
}  // namespace acg
