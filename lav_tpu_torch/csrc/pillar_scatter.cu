// pillar_scatter: the production pillar route's two scatters.
//
// Replaces the Pallas TPU kernel lav_tpu/ops/pillar_pallas2.py::_kernel
// and ::_kernel_stream (launched by _call; entry scatter_pallas), which
// hold the two scatters of lav_tpu's inference pillar path
// (ops/pillar.py, use_pallas=False): op="max" builds the canvas, op="add"
// the decoration sums.  The TPU kernel's VMEM-resident canvas, n_copies
// and slab/stream modes are VMEM tactics; on Hopper a scatter is one
// thread per update with an atomic in device memory (the canvas rows stay
// in the 50 MB L2 while their points arrive).
//
// Contract (both ops): out (S, C) starts zeroed (the caller zeroes it);
// point p updates row pid[p]; ids outside [0, S) are skipped (the caller
// routes invalid points to a dump row and slices it off).
//
//   scatter_max_{bf16,f32}: out[s, c] = max(0, max over points of
//     feat[p, c]): the zero-init max of non-negative (post-ReLU)
//     payloads.  A value replaces the stored one only when it is strictly
//     greater, so negative values, -0.0 and NaN never land.  Max is
//     order-independent: exact whatever order the atomics run in.
//     bf16: one thread per channel pair, a 32-bit compare-and-swap on the
//     word holding the pair (there is no 16-bit atomic max).  The stored
//     values only grow, so a stale read that already beats the payload
//     ends the loop without a write.  f32: atomicMax on the int bits,
//     which order like the values for non-negative floats.
//   scatter_add_f32: out[s, c] += feat[p, c].  The sum's order changes
//     from run to run: not bit-reproducible, within (n-1) ulp-scale
//     rounding of any sequential order.  Integer lanes (the count) below
//     2^24 are exact.
//
// Bound: bytes.  Payload and ids are read once and the canvas written
// once: at the agent's shapes (16 egos x 60000 points, 64 bf16 channels,
// 16 x 102400 + 1 rows) 7.7 MB of payload against a 210 MB canvas, so the
// zero fill and the canvas are most of the bytes; the add moves 15 MB of
// payload and 3.8 MB of ids into a 26 MB canvas, 0.0136 ms at 3.35 TB/s.
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

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void atomic_max_bf16x2(uint32_t* addr,
                                                  uint32_t v) {
  const float vlo = bf16_lo(v), vhi = bf16_hi(v);
  uint32_t old = *addr;
  while (true) {
    const uint32_t lo = vlo > bf16_lo(old) ? (v & 0xffffu) : (old & 0xffffu);
    const uint32_t hi =
        vhi > bf16_hi(old) ? (v & 0xffff0000u) : (old & 0xffff0000u);
    const uint32_t nw = lo | hi;
    if (nw == old) return;
    const uint32_t prev = atomicCAS(addr, old, nw);
    if (prev == old) return;
    old = prev;
  }
}

// one thread per (point, channel pair); C even
__global__ void scatter_max_bf16_kernel(const uint32_t* __restrict__ feat,
                                        const int32_t* __restrict__ pid,
                                        uint32_t* __restrict__ out,
                                        long long n_points, int half,
                                        long long segments) {
  const long long total = n_points * half;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / half;
    const int c = (int)(i - p * half);
    const long long s = pid[p];
    if (s < 0 || s >= segments) continue;
    const uint32_t v = feat[i];
    if (!(bf16_lo(v) > 0.0f) && !(bf16_hi(v) > 0.0f)) continue;
    atomic_max_bf16x2(out + s * half + c, v);
  }
}

__global__ void scatter_max_f32_kernel(const float* __restrict__ feat,
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
    const float v = feat[i];
    if (!(v > 0.0f)) continue;
    atomicMax(reinterpret_cast<int*>(out + s * C + c), __float_as_int(v));
  }
}

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

extern "C" int scatter_max_bf16(const void* feat, const void* pid, void* out,
                                long long n_points, int C, long long segments,
                                void* stream) {
  if (n_points == 0 || C == 0) return 0;
  if (C % 2) return (int)cudaErrorInvalidValue;
  const int half = C / 2;
  scatter_max_bf16_kernel<<<blocks_for(n_points * half), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(feat), static_cast<const int32_t*>(pid),
      static_cast<uint32_t*>(out), n_points, half, segments);
  return (int)cudaGetLastError();
}

extern "C" int scatter_max_f32(const void* feat, const void* pid, void* out,
                               long long n_points, int C, long long segments,
                               void* stream) {
  if (n_points == 0 || C == 0) return 0;
  scatter_max_f32_kernel<<<blocks_for(n_points * C), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat), static_cast<const int32_t*>(pid),
      static_cast<float*>(out), n_points, C, segments);
  return (int)cudaGetLastError();
}

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
