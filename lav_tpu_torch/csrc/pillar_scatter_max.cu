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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
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
