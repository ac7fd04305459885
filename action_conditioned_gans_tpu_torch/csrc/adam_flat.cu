// Kernel 5: one fused Adam update over a flat parameter vector
// (train.flatten_optimizer), for sm_90a.
//
// Replaces no Pallas kernel. The JAX package runs the whole optimizer chain
// as optax.flatten(inner) (action_conditioned_gans_tpu/train/state.py:182):
// clip_by_global_norm, Adam with float32 or bfloat16 moments and the learning
// rate over the concatenation of the parameters, which XLA fuses into one
// elementwise pass. This is that pass, over the port's flat buffers
// (train/state.py's flat layout).
//
// One pass over N elements: read p (f32), g (f32), mu and nu (f32 or bf16);
// write p, mu and nu. With clipping it reads the global norm of g from device
// memory (no host sync) and replaces g by (g / norm) * clip where
// norm >= clip, as torch.where(norm < clip, g, (g / norm) * clip) does, NaN
// included. The arithmetic is the plain version's, the torch._foreach ops of
// train.state.Adam, rounded as PyTorch's CUDA foreach kernels round them:
//   mu = fma(1 - b1, g, b1 * mu)         (_foreach_mul_, _foreach_add_ alpha)
//   nu = fma(1 - b2, g * g, b2 * nu)     (_foreach_mul_, _foreach_addcmul_)
//   p  = fma(-lr, (mu * inv_bc1) / (sqrt(nu * inv_bc2) + eps), p)
// where inv_bc = 1 / bc taken in double and rounded to float: PyTorch's CUDA
// division by a Python scalar multiplies by that reciprocal. Written with the
// _rn intrinsics so that nvcc contracts nothing else. The
// update reads the unrounded float32 moments; bf16 moments are stored
// rounded to nearest even.
//
// Bound: bytes. 28 B a parameter with f32 moments (16 read, 12 written), 20 B
// with bf16 moments; no data is reused, so the design is a grid-stride loop
// of 128-bit loads (4 elements a thread: float4 for p, g and f32 moments,
// 8-byte loads for bf16 moments) where every base pointer allows them, and a
// scalar loop for the rest of N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps, neg_lr, clip;
};

template <bool CLIP>
__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v, const Hyper& h,
                                          float norm) {
  if (CLIP) g = norm < h.clip ? g : __fmul_rn(__fdiv_rn(g, norm), h.clip);
  m = __fmaf_rn(h.omb1, g, __fmul_rn(h.b1, m));
  v = __fmaf_rn(h.omb2, __fmul_rn(g, g), __fmul_rn(h.b2, v));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_bc2)), h.eps);
  p = __fmaf_rn(h.neg_lr, __fdiv_rn(__fmul_rn(m, h.inv_bc1), denom), p);
}

__device__ __forceinline__ void load4(const float* base, long long i, float (&x)[4]) {
  const float4 t = reinterpret_cast<const float4*>(base)[i];
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

__device__ __forceinline__ void store4(float* base, long long i, const float (&x)[4]) {
  reinterpret_cast<float4*>(base)[i] = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* base, long long i, float (&x)[4]) {
  const uint2 t = reinterpret_cast<const uint2*>(base)[i];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}

__device__ __forceinline__ void store4(__nv_bfloat16* base, long long i, const float (&x)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned int*>(&lo);
  t.y = *reinterpret_cast<const unsigned int*>(&hi);
  reinterpret_cast<uint2*>(base)[i] = t;
}

__device__ __forceinline__ float load1(const float* base, long long i) { return base[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* base, long long i) {
  return __bfloat162float(base[i]);
}
__device__ __forceinline__ void store1(float* base, long long i, float x) { base[i] = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* base, long long i, float x) {
  base[i] = __float2bfloat16_rn(x);
}

template <typename M, bool VEC, bool CLIP>
__global__ void __launch_bounds__(kThreads)
adam_flat_kernel(float* __restrict__ p, const float* __restrict__ g, M* __restrict__ mu,
                 M* __restrict__ nu, const float* __restrict__ norm_ptr, long long n, Hyper h) {
  const float norm = CLIP ? *norm_ptr : 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      float pp[4], gg[4], mm[4], vv[4];
      load4(p, i, pp);
      load4(g, i, gg);
      load4(mu, i, mm);
      load4(nu, i, vv);
#pragma unroll
      for (int k = 0; k < 4; ++k) adam_elem<CLIP>(pp[k], gg[k], mm[k], vv[k], h, norm);
      store4(p, i, pp);
      store4(mu, i, mm);
      store4(nu, i, vv);
    }
    tail = n4 * 4;
  }
  for (long long i = tail + tid; i < n; i += stride) {
    float pp = p[i], mm = load1(mu, i), vv = load1(nu, i);
    adam_elem<CLIP>(pp, g[i], mm, vv, h, norm);
    p[i] = pp;
    store1(mu, i, mm);
    store1(nu, i, vv);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

template <typename M, bool VEC, bool CLIP>
void launch(void* p, const void* g, void* mu, void* nu, const void* norm, long long n,
            const Hyper& h, cudaStream_t stream) {
  const long long units = VEC ? (n / 4 > 0 ? n / 4 : n) : n;
  long long blocks = (units + kThreads - 1) / kThreads;
  const long long cap = 8LL * sm_count();  // enough resident warps to saturate HBM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  adam_flat_kernel<M, VEC, CLIP><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<float*>(p), static_cast<const float*>(g), static_cast<M*>(mu),
      static_cast<M*>(nu), static_cast<const float*>(norm), n, h);
}

template <typename M>
void dispatch(void* p, const void* g, void* mu, void* nu, const void* norm, long long n,
              const Hyper& h, cudaStream_t stream) {
  const uintptr_t wide = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g);
  const uintptr_t moments = reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(nu);
  const bool vec = wide % 16 == 0 && moments % (4 * sizeof(M)) == 0;
  if (vec && norm) launch<M, true, true>(p, g, mu, nu, norm, n, h, stream);
  else if (vec) launch<M, true, false>(p, g, mu, nu, norm, n, h, stream);
  else if (norm) launch<M, false, true>(p, g, mu, nu, norm, n, h, stream);
  else launch<M, false, false>(p, g, mu, nu, norm, n, h, stream);
}

}  // namespace

// One update of n elements in place. norm: a device float (the global norm of
// g) with clipping, or null without. Returns the launch's CUDA error (0 when
// it was taken).
extern "C" int acg_adam_flat(void* p, const void* g, void* mu, void* nu, const void* norm,
                             int bf16, long long n, float b1, float omb1, float b2, float omb2,
                             float inv_bc1, float inv_bc2, float eps, float neg_lr, float clip,
                             void* stream) {
  if (n <= 0) return 0;
  const Hyper h{b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps, neg_lr, clip};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) dispatch<__nv_bfloat16>(p, g, mu, nu, norm, n, h, s);
  else dispatch<float>(p, g, mu, nu, norm, n, h, s);
  return static_cast<int>(cudaGetLastError());
}
