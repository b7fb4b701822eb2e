// pillar_scatter: the production pillar route's decoration sums.
//
// Replaces the Pallas TPU kernel lav_tpu/ops/pillar_pallas2.py::_kernel
// and ::_kernel_stream with op="add" (launched by _call; entry
// scatter_pallas), which sums [xyz, 1] per pillar for lav_tpu's pillar
// decoration (ops/pillar.py).  The TPU kernel's VMEM-resident canvas,
// n_copies and slab/stream modes are VMEM tactics; on Hopper the sums are
// atomics in device memory (the canvas rows stay in the 50 MB L2 while
// their points arrive).  Its op="max", the canvas, is
// csrc/pillar_scatter_max.cu's `scatter_max`.
//
// Contract: out (S, C) starts zeroed (the caller zeroes it); point p adds
// feat[p, :] to row pid[p]; ids outside [0, S) are skipped.
//   scatter_add_f32: out[s, c] += feat[p, c].  The sum's order changes
//     from run to run: not bit-reproducible, within (n-1) ulp-scale
//     rounding of any sequential order.  Integer lanes (the count) below
//     2^24 are exact.
//
// Bound: bytes.  Payload and ids are read once and the canvas written
// once: at the agent's shapes (16 egos x 60000 points, C = 4, 16 x 102400
// + 1 rows) 15 MB of payload and 3.8 MB of ids into a 26 MB canvas,
// 0.0136 ms at 3.35 TB/s.
//
// The add's design, against contention.  The agent sends every invalid
// point to one dump row with its payload zeroed: a fifth of the 960,000
// points of a 16-ego tick once the ring buffer is full, and all of them
// at tick 1, before the first sweep enters it; one scalar atomic per
// (point, channel) serialised them on 4 addresses.  For C = 4:
//   - one thread per point, a 16-byte load of its row;
//   - a row whose 4 lanes are all +-0 is skipped.  The sum starts at +0
//     and never becomes -0 under round-to-nearest (x + (-x) = +0), and
//     s + (+-0) = s for every other s, NaN included, so skipping never
//     changes a bit; a NaN lane is not zero and lands.  This removes the
//     dump row's traffic outright;
//   - each live row is one 16-byte vector atomic (red.global.add.v4.f32,
//     sm_90) instead of four scalar ones.
// Summing equal ids within a warp first (__match_any_sync) was timed and
// gained nothing on the agent's ids, where a warp rarely holds two
// points of one pillar; it gained 13% only on made-up runs of 16 equal
// ids (PERF.md).  Other C, or rows not 16-byte aligned,
// take one thread per (point, channel) and a scalar atomic each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_add_f32_kernel(const float* __restrict__ feat,
                                       const int32_t* __restrict__ pid,
                                       float* __restrict__ out,
                                       long long n_points, int C,
                                       long long segments) {
  const long long total = n_points * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / C;
    const int c = (int)(i - p * C);
    const long long s = pid[p];
    if (s < 0 || s >= segments) continue;
    atomicAdd(out + s * C + c, feat[i]);
  }
}

// one 16-byte vector reduction into global memory (sm_90)
__device__ __forceinline__ void red_add_v4(float4* addr, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// C = 4: one thread per point
__global__ void scatter_add4_kernel(const float4* __restrict__ feat,
                                    const int32_t* __restrict__ pid,
                                    float4* __restrict__ out,
                                    long long n_points, long long segments) {
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       p < n_points; p += (long long)gridDim.x * blockDim.x) {
    const long long s = __ldcs(pid + p);
    if (s < 0 || s >= segments) continue;
    const float4 v = __ldcs(feat + p);
    // all four lanes +-0: adding the row changes no bit of the sum
    if (((__float_as_uint(v.x) | __float_as_uint(v.y) |
          __float_as_uint(v.z) | __float_as_uint(v.w)) << 1) == 0)
      continue;
    red_add_v4(out + s, v);
  }
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;  // enough resident blocks for 132 SMs
  if (b > cap) b = cap;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace

extern "C" int scatter_add_f32(const void* feat, const void* pid, void* out,
                               long long n_points, int C, long long segments,
                               void* stream) {
  if (n_points == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 4 && ((uintptr_t)feat % 16 == 0) && ((uintptr_t)out % 16 == 0)) {
    scatter_add4_kernel<<<blocks_for(n_points), kThreads, 0, st>>>(
        static_cast<const float4*>(feat), static_cast<const int32_t*>(pid),
        static_cast<float4*>(out), n_points, segments);
  } else {
    scatter_add_f32_kernel<<<blocks_for(n_points * C), kThreads, 0, st>>>(
        static_cast<const float*>(feat), static_cast<const int32_t*>(pid),
        static_cast<float*>(out), n_points, C, segments);
  }
  return (int)cudaGetLastError();
}
