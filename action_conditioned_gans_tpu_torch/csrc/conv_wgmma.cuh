// Hopper mainloop of the fused conv kernels for bfloat16 layers with
// Cin % 4 == 0 and Cout % 64 == 0: warpgroup MMA (wgmma) reading a
// multi-stage shared-memory ring that cp.async fills with the implicit-im2col
// gather. Kernel 1 (conv_norm_act.cu) runs it with TRANSPOSE = false, kernel 2
// (conv_transpose_norm_act.cu) with TRANSPOSE = true: the grid's z axis walks
// (sample, phase) and each of the four subpixel phases is a K = 4*Cin GEMM
// over one sample's H*W input positions. The index maps (row_at, tap_at,
// a_offset), the epilogue (tile_epilogue) and the GroupNorm passes are
// conv_common.cuh's, unchanged.
//
// Tile: BM output rows of one (sample, phase) plane (128 when the plane has at
// least 128 rows, else 64) x BN output channels, depth BK = 64 per stage:
// one 128-byte swizzle row of bfloat16. BN is 256 for a 64-row tile when
// Cout % 256 == 0 and the grid keeps at least 128 blocks (it halves the
// re-reads of A, which bound these tiles through L2), else 128 when
// Cout % 128 == 0, else 64 (wgmma_bm / wgmma_bn below). Every block has
// NT = 256 threads, two warpgroups, as tile_epilogue expects: with BM = 128
// each warpgroup takes 64 rows and all BN columns; with BM = 64 both take
// the 64 rows and BN/2 columns each.
//
// A stage holds A (BM rows x 64 depths) then B (BN channels x 64 depths),
// both K-major in the 128-byte swizzle: row r's 16-byte chunk c sits at byte
// r*128 + ((c ^ (r % 8)) * 16). Both start on 1024-byte boundaries, so the
// 8-row x 128-byte swizzle atoms of the wgmma descriptors line up. B comes
// from the weights packed as (phases, Cout, K) by pack_weights_kernel; for the
// transpose, phase (r, c)'s slab holds the phase kernel w[2dy+r, 2dx+c].
//
// A copy moves AV channels of one tap (16 bytes when Cin % 8 == 0, 8 bytes
// when Cin % 4 == 0): as Cin % AV == 0, a copy never straddles two taps, but
// a 64-deep stage does, so each copy takes its own tap_at. A copy with
// src-size 0 writes zeros: the SAME padding (the transpose's one-pixel
// border), rows past the plane and depths k >= K (the last stage of K = 2340
// or K = 48 is partial).
//
// Per k-step, STAGES - 1 stages in flight:
//   1. cp.async.wait_group STAGES-2: this thread's copies of the step landed;
//   2. fence.proxy.async: cp.async wrote through the generic proxy, wgmma
//      reads through the async proxy; then __syncthreads;
//   3. wgmma.fence, BK/16 = 4 wgmma m64nNk16 per warpgroup, commit;
//   4. while they run, the copies of step + STAGES-1 into the stage that
//      the previous step read (its wgmma finished before the barrier);
//   5. wgmma.wait_group 0.
// After the last step the ring is free and holds the float32 Cs tile.
#pragma once

#include "conv_common.cuh"

namespace acg {
namespace wg {

constexpr int BK = 64;             // depths per stage
constexpr int ROW_BYTES = BK * 2;  // one swizzle row

// Ring stages: 3 for the wide tiles; 4 for kernel 1's narrower ones. The
// transposed GEMMs (K = 4*Cin: 4 to 32 k-steps) take 3 throughout, which
// fits a third block of 128 x 64 or 64 x 128 on an SM (in a timing of both
// on an H100, 3 stages ran the 128 x 64 dec_1 layers faster, and no
// transposed layer slower).
template <int BM, int BN, bool TRANSPOSE>
struct Shape {
  static constexpr int WN = BM == 128 ? BN : BN / 2;  // columns per warpgroup
  static constexpr int STAGES = TRANSPOSE || BM + BN >= 256 ? 3 : 4;
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int STAGE_BYTES = (BM + BN) * ROW_BYTES;
  static constexpr int LDC = BN + 4;
  // The ring, plus slack to align it to 1024 bytes. Two blocks fit an SM.
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
  static_assert(BM * LDC * 4 <= STAGES * STAGE_BYTES, "Cs fits the ring");
};

// Channels per copy of the gather: 8 (16 bytes) when Cin % 8 == 0 and x is
// 16-byte aligned, 4 (8 bytes) when Cin % 4 == 0 and x 8-byte aligned; 0 when
// neither holds (the call cannot take this mainloop).
inline int wgmma_av(int cin, const void* x) {
  if (cin % 8 == 0 && (uintptr_t)x % 16 == 0) return 8;
  if (cin % 4 == 0 && (uintptr_t)x % 8 == 0) return 4;
  return 0;
}

// Rows of a tile, from the rows of one (sample, phase) plane.
inline int wgmma_bm(int pixels) { return pixels >= 128 ? 128 : 64; }

// 256 columns for a 64-row tile when Cout % 256 == 0 and the grid keeps at
// least 128 blocks: every block re-reads the whole K of its A rows and B
// columns from L2, and a wider tile halves the A side. With fewer blocks
// the card idles, and 128 columns win (on an H100, config1's layers at
// B=128 run faster at 256, config3's at B=32 at 128). blocks = B * phases *
// tiles.
inline int wgmma_bn(int cout, int bm, int blocks) {
  if (bm == 64 && cout % 256 == 0 && (long long)blocks * (cout / 256) >= 128) return 256;
  return cout % 128 == 0 ? 128 : 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of row r's 16-byte chunk c in a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  return (uint32_t)(r * ROW_BYTES + ((c ^ (r & 7)) << 4));
}

// BYTES from src to shared dst, or BYTES zeros when !valid (nothing read).
// A goes through L1 (.ca: neighbouring windows share input pixels); 16-byte
// B copies bypass it (.cg).
template <int BYTES, bool L1>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if (BYTES == 16 && !L1)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major, 128-byte-swizzled shared-memory operand starting
// at shared address addr: start >> 4, leading offset 16 bytes (unused by
// this layout), stride 1024 bytes between 8-row groups, layout B128.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// One wgmma m64nNk16, bfloat16 in, float32 accumulators d (N/2 per thread),
// A and B from shared memory, both K-major (no transpose), D += A*B.
template <int N>
struct Mma;

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The weights HWIO -> (phases, Cout, K), the K-major B operand: phase
// (r, c)'s depth k reads HWIO row w_row<TRANSPOSE>(g, k, r, c). 32x32 tiles
// through shared memory so both sides are coalesced.
// Grid: (ceil(K/32), ceil(Cout/32), phases). Block: NT threads.
template <bool TRANSPOSE>
__global__ void __launch_bounds__(NT) pack_weights_kernel(const __nv_bfloat16* __restrict__ w,
                                                          __nv_bfloat16* __restrict__ wt, Geom g) {
  __shared__ __nv_bfloat16 t[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32, phase = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += NT / 32) {
    const int k = k0 + i, n = n0 + tx;
    if (k < g.K && n < g.Cout)
      t[i][tx] = w[w_row<TRANSPOSE>(g, k, phase >> 1, phase & 1) * g.Cout + n];
  }
  __syncthreads();
  __nv_bfloat16* wp = wt + (size_t)phase * g.Cout * g.K;
  for (int i = ty; i < 32; i += NT / 32) {
    const int n = n0 + i, k = k0 + tx;
    if (n < g.Cout && k < g.K) wp[(size_t)n * g.K + k] = t[tx][i];
  }
}

// Grid: (g.tiles, Cout/BN, B*phases). Block: NT threads. Dynamic shared
// memory: Shape<BM, BN, TRANSPOSE>::SMEM_BYTES.
template <bool TRANSPOSE, int BM, int BN, int AV>
__global__ void __launch_bounds__(NT) conv_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, float* __restrict__ y,
    float* __restrict__ psum, float* __restrict__ psq, Geom g, int group_norm, int act,
    float leak) {
  using S = Shape<BM, BN, TRANSPOSE>;
  constexpr int STAGES = S::STAGES, WN = S::WN;
  constexpr int CPR = BK / AV;         // copies per tile row
  constexpr int RSTEP = NT / CPR;      // rows between one thread's copies
  constexpr int A_PER = BM / RSTEP, B_PER = BN / RSTEP;
  constexpr int CHUNK = AV * 2;        // bytes per copy
  static_assert(NT % CPR == 0 && A_PER * RSTEP == BM && B_PER * RSTEP == BN, "copies cover a stage");

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t ring = raw + pad;

  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z / g.phases;
  const int phase = blockIdx.z - b * g.phases;
  const int pr = phase >> 1, pc = phase & 1;
  const int p0 = tile * BM;
  const __nv_bfloat16* xb = x + (size_t)b * g.H * g.W * g.Cin;

  // This thread's copies: rows r0 + RSTEP*i of A (and of B), depths
  // c*AV .. c*AV+AV-1 of the stage, i.e. byte cb of 16-byte chunk cc.
  const int c = tid % CPR, r0 = tid / CPR;
  const int cc = (c * CHUNK) >> 4, cb = (c * CHUNK) & 15;
  Row rows[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) rows[i] = row_at<TRANSPOSE>(g, p0 + r0 + RSTEP * i, pr, pc);
  const __nv_bfloat16* wrow = wt + ((size_t)phase * g.Cout + n0 + r0) * g.K;

  auto load = [&](int kt) {
    const uint32_t a_st = ring + (kt % STAGES) * S::STAGE_BYTES;
    const uint32_t b_st = a_st + S::A_BYTES;
    const int k = kt * BK + c * AV;
    const Tap t = tap_at<TRANSPOSE>(g, k);
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const long long o = a_offset(g, rows[i], t);
      cp_async<CHUNK, true>(a_st + swizzle(r0 + RSTEP * i, cc) + cb, o < 0 ? xb : xb + o, o >= 0);
    }
    const bool kin = k < g.K;
#pragma unroll
    for (int i = 0; i < B_PER; ++i)
      cp_async<CHUNK, false>(b_st + swizzle(r0 + RSTEP * i, cc) + cb,
                             wrow + (size_t)RSTEP * i * g.K + (kin ? k : 0), kin);
  };

  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);

  // This warpgroup's operands inside a stage.
  const uint32_t a_wg = BM == 128 ? wgi * 64 * ROW_BYTES : 0;
  const uint32_t b_wg = S::A_BYTES + (BM == 128 ? 0 : wgi * WN * ROW_BYTES);

  const int KT = (g.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t st = ring + (kt % STAGES) * S::STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)
      Mma<WN>::run(acc, desc(st + a_wg + 32 * s), desc(st + b_wg + 32 * s));
    wgmma_commit();
    if (kt + STAGES - 1 < KT) load(kt + STAGES - 1);
    cp_async_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  // Accumulators -> Cs in wgmma's m64nN layout: warp w of the warpgroup
  // holds rows 16w + lane/4 (+8), columns 8j + 2*(lane%4) (+1).
  float* Cs = reinterpret_cast<float*>(smem_raw + pad);
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int row = (BM == 128 ? wgi * 64 : 0) + warp * 16 + lane / 4;
  const int col = (BM == 128 ? 0 : wgi * WN) + (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    float* c0 = Cs + row * S::LDC + col + 8 * j;
    *reinterpret_cast<float2*>(c0) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(c0 + 8 * S::LDC) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  tile_epilogue<__nv_bfloat16, TRANSPOSE, BM, BN, S::LDC>(Cs, g, b, phase, tile, n0, bias, out, y,
                                                           psum, psq, group_norm, act, leak);
}

// The GEMM kernel's operands, as launch_conv_norm_act hands them on.
struct GemmArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wt;
  const float* bias;
  __nv_bfloat16* out;
  float *y, *psum, *psq;
  int group_norm, act;
  float leak;
};

template <bool TRANSPOSE, int BM, int BN, int AV>
int launch_gemm(const Geom& g, const GemmArgs& a, cudaStream_t stream) {
  auto kernel = conv_wgmma_kernel<TRANSPOSE, BM, BN, AV>;
  constexpr int smem = Shape<BM, BN, TRANSPOSE>::SMEM_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(g.tiles, g.Cout / BN, g.B * g.phases);
  kernel<<<grid, NT, smem, stream>>>(a.x, a.wt, a.bias, a.out, a.y, a.psum, a.psq, g,
                                     a.group_norm, a.act, a.leak);
  return (int)cudaGetLastError();
}

template <bool TRANSPOSE, int BM, int BN>
int launch_gemm_av(int av, const Geom& g, const GemmArgs& a, cudaStream_t stream) {
  return av == 8 ? launch_gemm<TRANSPOSE, BM, BN, 8>(g, a, stream)
                 : launch_gemm<TRANSPOSE, BM, BN, 4>(g, a, stream);
}

// Packs w into wt (phases*Cout*K bfloat16 of scratch, as many as w holds),
// runs the wgmma GEMM with tile bm x bn (128 x 64 / 128, or 64 x 64 / 128 /
// 256) and copy width av (g.tiles already set from bm), then the GroupNorm
// passes when group_norm is set. Returns the first launch error.
template <bool TRANSPOSE>
int launch_conv_norm_act(const Geom& g, int bm, int bn, int av, const void* x, const void* w,
                         void* wt, const void* scale, const void* bias, void* out, void* y,
                         void* psum, void* psq, void* stats, int group_norm, int groups,
                         float eps, int act, float leak, cudaStream_t stream) {
  if (g.B * g.phases > 65535 || g.Cout % bn != 0 || g.Cout / bn > 65535 || wt == nullptr ||
      (bm == 128 && bn == 256))
    return (int)cudaErrorInvalidConfiguration;
  auto* wtb = (__nv_bfloat16*)wt;
  const dim3 pgrid((g.K + 31) / 32, (g.Cout + 31) / 32, g.phases);
  pack_weights_kernel<TRANSPOSE><<<pgrid, NT, 0, stream>>>((const __nv_bfloat16*)w, wtb, g);
  const cudaError_t packed = cudaGetLastError();
  if (packed != cudaSuccess) return (int)packed;

  const GemmArgs a{(const __nv_bfloat16*)x, wtb, (const float*)bias, (__nv_bfloat16*)out,
                   (float*)y, (float*)psum, (float*)psq, group_norm, act, leak};
  int err;
  if (bm == 128)
    err = bn == 128 ? launch_gemm_av<TRANSPOSE, 128, 128>(av, g, a, stream)
                    : launch_gemm_av<TRANSPOSE, 128, 64>(av, g, a, stream);
  else
    err = bn == 256   ? launch_gemm_av<TRANSPOSE, 64, 256>(av, g, a, stream)
          : bn == 128 ? launch_gemm_av<TRANSPOSE, 64, 128>(av, g, a, stream)
                      : launch_gemm_av<TRANSPOSE, 64, 64>(av, g, a, stream);
  if (err != 0 || !group_norm) return err;
  // One GroupNorm slot per (phase, row tile) of a sample, as conv_common.cuh.
  return launch_gn_stats_apply<float, __nv_bfloat16>(
      a.y, a.psum, a.psq, (float*)stats, (const float*)scale, a.bias, a.out, g.B, g.Cout,
      g.phases * g.tiles, groups, g.OH * g.OW, eps, act, leak, stream);
}

}  // namespace wg
}  // namespace acg
