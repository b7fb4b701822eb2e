// pillar_scatter_max: per-pillar max of point features.
//
// Replaces the Pallas TPU kernel lav_tpu/ops/pillar_pallas.py::_kernel
// (launched by _packed_call; entry pillar_scatter_max_pallas), the role
// torch_scatter's scatter_max had in LAV's PointPillars.
//
// Contract: out (S, C) f32 starts at NEG = -1e30; every point p raises
// out[pid[p], :] to feat[p, :]; entries still at or below NEG become 0
// (untouched pillars, and pillars touched only by masked points that carry
// NEG).  The caller folds a batch into the segment space
// (pid + b * segments).  Ids outside [0, S) are skipped.  Max is
// order-independent, so the result is exact whatever the atomics' order.
//
// Bound: bytes — feat and pid read once, out written once (at the agent's
// shapes 49152 points x 64 ch per ego against a 102401 x 64 canvas, the
// canvas write dominates).  Design: a fill pass, one thread per (point,
// channel) issuing an order-preserving float atomic max (signed atomicMax
// on the bits of a value with the sign bit clear, unsigned atomicMin on
// the bits of one with it set; exact for negative values and -0.0 too),
// with points at NEG skipped, then a pass turning NEG into 0.
//
// bf16 entry (pillar_scatter_max_bf16; the TPU kernel's bf16 form, which
// the JAX package runs under bf16 compute): the same contract in bf16,
// with NEG the bf16 rounding of -1e30 (0xF14A, -1.0003e30), as the TPU
// kernel fills and compares in the feature dtype.  bf16 has no atomic
// max: one thread per (point, channel pair) runs a 32-bit compare-and-swap
// on the word holding the pair, each lane taking the payload only when
// its decoded float is strictly greater (so NEG, and NaN, never land;
// negative values do).  The stored values only grow, so a stale read that
// already beats both lanes ends the loop without a write.  A pillar that
// only masked points reach keeps NEG and the finalize pass turns it into
// 0.  C must be even.  At the bf16 production shapes (16 x 60000 points,
// 64 ch, 16 x 102401 rows) 123 MB of payload against a 210 MB canvas.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr uint32_t kNegBf16 = 0xF14Au;       // bf16 rounding of -1e30
constexpr uint32_t kNegBf16x2 = 0xF14AF14Au;
constexpr int kThreads = 256;

__global__ void fill_kernel(float* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = kNeg;
}

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (!signbit(v))
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__global__ void scatter_kernel(const float* __restrict__ feat,
                               const int32_t* __restrict__ pid,
                               float* __restrict__ out, long long n_points,
                               int C, long long segments) {
  const long long total = n_points * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / C;
    const int c = (int)(i - p * C);
    const float v = feat[i];
    if (!(v > kNeg)) continue;  // masked point (or NaN): cannot raise a max
    const long long s = pid[p];
    if (s < 0 || s >= segments) continue;
    atomic_max_float(out + s * C + c, v);
  }
}

__global__ void finalize_kernel(float* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = out[i];
    out[i] = v > kNeg ? v : 0.0f;
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__global__ void fill_bf16x2_kernel(uint32_t* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = kNegBf16x2;
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

// one thread per (point, channel pair)
__global__ void scatter_bf16x2_kernel(const uint32_t* __restrict__ feat,
                                      const int32_t* __restrict__ pid,
                                      uint32_t* __restrict__ out,
                                      long long n_points, int half,
                                      long long segments) {
  const float neg = bf16_lo(kNegBf16);
  const long long total = n_points * half;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / half;
    const int c = (int)(i - p * half);
    const uint32_t v = feat[i];
    if (!(bf16_lo(v) > neg) && !(bf16_hi(v) > neg)) continue;  // masked
    const long long s = pid[p];
    if (s < 0 || s >= segments) continue;
    atomic_max_bf16x2(out + s * half + c, v);
  }
}

__global__ void finalize_bf16x2_kernel(uint32_t* __restrict__ out,
                                       long long n) {
  const float neg = bf16_lo(kNegBf16);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t w = out[i];
    const uint32_t lo = bf16_lo(w) > neg ? (w & 0xffffu) : 0u;
    const uint32_t hi = bf16_hi(w) > neg ? (w & 0xffff0000u) : 0u;
    out[i] = lo | hi;
  }
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;  // enough resident blocks for 132 SMs
  if (b > cap) b = cap;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace

extern "C" int pillar_scatter_max_f32(const void* feat, const void* pid,
                                      void* out, long long n_points, int C,
                                      long long segments, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_out = segments * C;
  if (n_out == 0) return 0;
  float* o = static_cast<float*>(out);
  fill_kernel<<<blocks_for(n_out), kThreads, 0, st>>>(o, n_out);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (n_points > 0) {
    scatter_kernel<<<blocks_for(n_points * C), kThreads, 0, st>>>(
        static_cast<const float*>(feat), static_cast<const int32_t*>(pid), o,
        n_points, C, segments);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  finalize_kernel<<<blocks_for(n_out), kThreads, 0, st>>>(o, n_out);
  return (int)cudaGetLastError();
}

extern "C" int pillar_scatter_max_bf16(const void* feat, const void* pid,
                                       void* out, long long n_points, int C,
                                       long long segments, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 2) return (int)cudaErrorInvalidValue;
  const int half = C / 2;
  const long long n_out = segments * half;
  if (n_out == 0) return 0;
  uint32_t* o = static_cast<uint32_t*>(out);
  fill_bf16x2_kernel<<<blocks_for(n_out), kThreads, 0, st>>>(o, n_out);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (n_points > 0) {
    scatter_bf16x2_kernel<<<blocks_for(n_points * half), kThreads, 0, st>>>(
        static_cast<const uint32_t*>(feat), static_cast<const int32_t*>(pid),
        o, n_points, half, segments);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  finalize_bf16x2_kernel<<<blocks_for(n_out), kThreads, 0, st>>>(o, n_out);
  return (int)cudaGetLastError();
}
