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
// Contract (both ops): out (S, C) is zeroed by the caller; point p updates
// row pid[p]; ids outside [0, S) are skipped (the caller routes invalid
// points to a dump row and slices it off).
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
//   scatter_add_f32: out[s, c] += feat[p, c] with atomicAdd.  The sum's
//     order changes from run to run: not bit-reproducible, within
//     (n-1) ulp-scale rounding of any sequential order.  Integer lanes
//     (the count) below 2^24 are exact.
//
// Bound: bytes, and in practice the atomics.  Payload and ids are read
// once and the canvas written once: at the agent's shapes (16 egos x
// 60000 points, 64 bf16 channels, 16 x 102400 + 1 rows) 7.7 MB of
// payload against a 210 MB canvas, so the zero fill and the canvas are
// most of the bytes; the add moves 15 MB of payload into a 26 MB canvas.

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
  scatter_add_f32_kernel<<<blocks_for(n_points * C), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat), static_cast<const int32_t*>(pid),
      static_cast<float*>(out), n_points, C, segments);
  return (int)cudaGetLastError();
}
