// GroupNorm over one sample per thread-block cluster: the plan, the load of a
// block's share into shared memory, the partial sums and their reduction
// across the cluster through distributed shared memory (DSMEM). Kernel 3
// (group_norm_act.cu, the forward) and kernel 4 (gn_act_bwd.cu, the
// backward) are built on it.
//
// A sample's (HW, C) plane is cut into `cluster` contiguous shares of whole
// rows, one per block of the cluster: block q holds rows
// [q*HW/cluster, (q+1)*HW/cluster). A block keeps the first `keep_rows` rows of
// its share in shared memory (one read of its inputs from device memory, by
// the TMA's 1-D bulk copy on an mbarrier) and reads the rest, if any, from
// global memory twice (the second read finds it in L2). A row is the bytes of
// every array the kernel keeps: x for kernel 3; y, out and g for kernel 4.
//
// Inside a block the share is walked by columns: the C channels are cut into
// units of `vec` channels (16 bytes of the narrowest array when C allows, else
// 1 channel), and the units into chunks of at most NT. In a chunk of `cw`
// units thread t owns unit t % cw and every (NT / cw)-th row from t / cw (its
// lane), so each thread sees fixed channels and no element needs a division
// by C. Consecutive threads touch consecutive 16-byte units: shared and
// global accesses are contiguous per warp.
//
// Every sum runs in a fixed order (rows within a lane; a unit's channels into
// per-group slots; lanes in four running sums; a group's slots 32 at a time,
// then a fixed shuffle tree, or (kernel 4) a group's channels in a fixed
// order by one thread; the cluster's blocks by rank), so two launches on the
// same input give the same bits; there are no atomics.
#pragma once

#include <stdint.h>

#include "gn_common.cuh"

namespace acg {
namespace gnc {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use on sm_90 (227 KB)
constexpr int PORTABLE_CLUSTER = 8;  // the largest portable cluster
constexpr int MAX_CLUSTER = 16;      // non-portable; the H100 schedules it (PERF.md)
constexpr int FILL_BLOCKS = 256;     // blocks the plan aims for: about two per SM of an H100
constexpr int SMS = 132;             // an H100 SXM's SMs
constexpr int TWO_PER_SM = 115200;   // the most shared memory at which two blocks share an SM

struct Plan {
  int cluster;    // blocks per sample: one cluster
  int rows_max;   // rows of the largest share, ceil(HW / cluster)
  int keep_rows;  // rows of its share a block keeps in shared memory
  int vec;        // channels per unit: 16 bytes' worth, or 1 when C is no multiple of that
  int smem;       // dynamic shared memory per block, bytes
  int reread;     // bytes of one sample read twice (rows past keep_rows)
};

__host__ __device__ inline int align16(long long n) { return (int)((n + 15) / 16 * 16); }

// Per-group slots a thread folds its unit's `vec` channels into before they
// leave its registers: one when a group holds whole units, vec / cg when a
// unit holds whole groups, else one per channel. Each slot lies in one group.
__host__ __device__ inline int unit_slots(int vec, int cg) {
  return cg % vec == 0 ? 1 : (vec % cg == 0 ? vec / cg : vec);
}

// Bytes of kernel 3's shared memory past the kept rows: two float arrays of
// NT * slots lane partials (S1, S2), this block's per-group partials (2 *
// groups) and the cluster's sums, then mean and rstd (2 * groups); then the
// copy's mbarrier.
inline long long scratch_bytes(int vec, int cg, int groups) {
  return 4LL * (2LL * NT * unit_slots(vec, cg) + 4LL * groups) + 16;
}

// What a block of a kernel keeps: the bytes of one row of its kept arrays,
// its unit width, and its shared memory past the kept rows (a multiple of
// 16 bytes).
struct Rows {
  long long row_bytes;
  int vec;
  long long scratch;
};

// Kernel 3's rows: x in `esize`-byte elements.
inline Rows norm_rows(int esize, int C, int groups) {
  const int vec = C % (16 / esize) == 0 ? 16 / esize : 1;
  return Rows{(long long)C * esize, vec, scratch_bytes(vec, C / groups, groups)};
}

// The plan at a given cluster size. smem < 0: no plan fits a block.
inline Plan plan_at(const Rows& s, int HW, int cluster) {
  Plan p;
  p.cluster = cluster;
  p.vec = s.vec;
  p.rows_max = (HW + cluster - 1) / cluster;
  const long long room = SMEM_MAX - s.scratch;
  const long long fit = room > 0 ? room / s.row_bytes : 0;
  p.keep_rows = (int)(fit < p.rows_max ? fit : p.rows_max);
  p.smem = room < 0 ? -1 : (int)(align16(p.keep_rows * s.row_bytes) + s.scratch);
  long long reread = 0;
  for (int q = 0; q < cluster; ++q) {
    const long long n = (long long)(q + 1) * HW / cluster - (long long)q * HW / cluster;
    if (n > p.keep_rows) reread += (n - p.keep_rows) * s.row_bytes;
  }
  p.reread = (int)reread;
  return p;
}

// The one plan of B samples of HW rows. The cluster doubles from 1 while it
// may (at most PORTABLE_CLUSTER blocks, each with a row) and either the grid
// has fewer than FILL_BLOCKS blocks or a share does not fit a block's shared
// memory. A cluster of 8 whose blocks each take an SM of their own (more
// shared memory than TWO_PER_SM) and that the card cannot hold at once for
// all B samples doubles once more, to 16.
inline Plan choose_plan(const Rows& s, int B, int HW) {
  int k = 1;
  while (2 * k <= PORTABLE_CLUSTER && 2 * k <= HW) {
    const Plan p = plan_at(s, HW, k);
    if ((long long)B * k >= FILL_BLOCKS && p.keep_rows == p.rows_max) break;
    k *= 2;
  }
  const Plan p = plan_at(s, HW, k);
  if (k == PORTABLE_CLUSTER && 2 * k <= HW && p.smem > TWO_PER_SM && (long long)B * k > SMS)
    return plan_at(s, HW, 2 * k);
  return p;
}

// The smallest cluster (1, 2, 4, 8, then MAX_CLUSTER blocks, at most one a
// row) whose shares all fit a block's shared memory; where none does, the
// largest, with the rows that do not fit read twice.
inline Plan fit_plan(const Rows& s, int HW) {
  int k = 1;
  for (;;) {
    const Plan p = plan_at(s, HW, k);
    if (p.keep_rows == p.rows_max || 2 * k > MAX_CLUSTER || 2 * k > HW) return p;
    k *= 2;
  }
}

// Kernel 3's plan at a given cluster size, and its one plan of a (B, HW, C)
// GroupNorm with `groups` groups.
inline Plan plan_for(int esize, int HW, int C, int groups, int cluster) {
  return plan_at(norm_rows(esize, C, groups), HW, cluster);
}

inline Plan make_plan(int esize, int B, int HW, int C, int groups) {
  return choose_plan(norm_rows(esize, C, groups), B, HW);
}

// Lets `kernel` take any plan: the most dynamic shared memory, and clusters
// past the portable size.
template <typename K>
cudaError_t allow_plans(K* kernel) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// The launch of a plan: grid (cluster, B) of NT threads in clusters of
// (cluster, 1, 1), the plan's dynamic shared memory. `attr` holds the
// cluster attribute that `cfg` points to.
inline void launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], const Plan& p,
                          int B, cudaStream_t stream) {
  cfg.gridDim = dim3(p.cluster, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// -- cluster primitives (PTX) -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Arrive on the cluster barrier: this block's shared-memory writes before it
// are visible to every block that waits on the barrier after it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The float at `p` (in this block's shared memory) in the shared memory of the
// cluster's block `rank`.
__device__ __forceinline__ float load_peer(const float* p, unsigned rank) {
  const uint32_t local = smem_addr(p);
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// -- the share in shared memory -------------------------------------------------------

// One thread: initialise the mbarrier at `bar` for `arrivals` arrivals (one
// per bulk_load on it), visible to the async proxy; a __syncthreads() must
// follow before others use it.
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t arrivals = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: start copying `bytes` (a multiple of 16) from `src` (global,
// 16-byte aligned) to `dst` (shared) with the TMA's 1-D bulk copy, in pieces
// of at most BULK_PIECE bytes, all completing on `bar`.
constexpr uint32_t BULK_PIECE = 16384;
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t b = smem_addr(bar), d = smem_addr(dst);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  for (uint32_t off = 0; off < bytes; off += BULK_PIECE) {
    const uint32_t n = bytes - off < BULK_PIECE ? bytes - off : BULK_PIECE;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(d + off), "l"(static_cast<const char*>(src) + off), "r"(n), "r"(b)
        : "memory");
  }
}

// Every thread: wait until the copies on `bar` (phase 0) have landed.
__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  const uint32_t b = smem_addr(bar), parity = 0;
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
}

// One unit of V channels (16 bytes of bfloat16, 16 or 32 bytes of float32, or
// one element when V == 1) as float32.
template <typename T, int V>
__device__ __forceinline__ void load_unit(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f32(*p);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 u = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = u.x, f[4 * i + 1] = u.y, f[4 * i + 2] = u.z, f[4 * i + 3] = u.w;
    }
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_unit(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    *p = from_f32<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&t);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// -- partial sums and their reduction ---------------------------------------------------

// Sums one chunk's lane partials over the lanes. red_s / red_q hold lanes x
// width values (lane-major); sum_s[k] and sum_q[k] receive value k's sums,
// one thread per value, in four running sums over lanes l % 4, then added
// pairwise. sum_s / sum_q may be red_s / red_q themselves (lane 0's row).
__device__ __forceinline__ void fold_lanes(const float* red_s, const float* red_q, int lanes,
                                           int width, float* sum_s, float* sum_q) {
  for (int k = threadIdx.x; k < width; k += blockDim.x) {
    float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
    for (int l = 0; l < lanes; l += 4)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (l + i < lanes) {
          s[i] += red_s[(l + i) * width + k];
          q[i] += red_q[(l + i) * width + k];
        }
    sum_s[k] = (s[0] + s[1]) + (s[2] + s[3]);
    sum_q[k] = (q[0] + q[1]) + (q[2] + q[3]);
  }
}

// Folds one chunk's lane partials into per-group sums. red_s / red_q hold
// lanes x width slots (lane-major), slot k of the chunk being the block-wide
// slot k0 + k; a group holds per_group consecutive slots. part[g] and
// part[groups + g] accumulate S1 and S2 of group g, chunk after chunk. First
// the lanes fold into lane 0's row (fold_lanes); then one warp per group sums
// the group's slots, 32 at a time, and reduces the warp with a fixed shuffle
// tree. The order never depends on scheduling.
__device__ __forceinline__ void fold_groups(float* red_s, float* red_q, int lanes, int width,
                                            int k0, int per_group, int groups, float* part) {
  fold_lanes(red_s, red_q, lanes, width, red_s, red_q);
  __syncthreads();
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int g0 = k0 / per_group, g1 = (k0 + width - 1) / per_group;
  for (int g = g0 + (int)(threadIdx.x >> 5); g <= g1; g += warps) {
    const int k_lo = max(k0, g * per_group) - k0, k_hi = min(k0 + width, (g + 1) * per_group) - k0;
    float s = 0.f, q = 0.f;
    for (int k = k_lo + lane; k < k_hi; k += 32) {
      s += red_s[k];
      q += red_q[k];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) {
      part[g] += s;
      part[groups + g] += q;
    }
  }
}

// Kernel 4's group sums of per-channel sums: part[g] = sum over the channels
// c of group g of scale[c] * ch_s[c], and part[groups + g] likewise of ch_q,
// for the C = groups * cg channels. One thread per group adds its channels
// in a fixed order: from channel g % cg of the group on, cyclically, so that
// the threads of a warp read different shared-memory banks.
__device__ __forceinline__ void fold_scaled_groups(const float* ch_s, const float* ch_q,
                                                   const float* scale, int cg, int groups,
                                                   float* part) {
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int i = 0, j = g % cg; i < cg; ++i, j = j + 1 == cg ? 0 : j + 1) {
      const int c = g * cg + j;
      s = fmaf(scale[c], ch_s[c], s);
      q = fmaf(scale[c], ch_q[c], q);
    }
    part[g] = s;
    part[groups + g] = q;
  }
}

// After cluster_sync(): tot[i] = sum over the cluster's blocks, by rank, of
// their part[i], for i < n. Every block computes the same bits. A thread
// issues four loads from other blocks at a time before it adds them.
__device__ __forceinline__ void sum_over_cluster(const float* part, float* tot, int n) {
  const unsigned k = cluster_blocks();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float s = 0.f;
    for (unsigned q0 = 0; q0 < k; q0 += 4) {
      float v[4];
#pragma unroll
      for (unsigned q = 0; q < 4; ++q) v[q] = q0 + q < k ? load_peer(part + i, q0 + q) : 0.f;
#pragma unroll
      for (unsigned q = 0; q < 4; ++q)
        if (q0 + q < k) s += v[q];
    }
    tot[i] = s;
  }
}

}  // namespace gnc
}  // namespace acg
