// take_along_rows: out[i, l] = x[idx[i, l], l], a gather along axis 0.
//
// Replaces the Pallas TPU kernel scripts/exp_gather.py::kern (its
// pallas_call at exp_gather.py:33), a probe of Mosaic's dynamic gather
// (jnp.take_along_axis(x, idx, axis=0) on VMEM-resident operands) at
// (S, L) in {8, 512, 9216, 25600} x {128, 256}, f32 and bf16.  The TPU
// kernel held both operands whole in VMEM; on Hopper the rows of x are
// read where the indices point, straight from device memory (the probe's
// largest x, 13 MB, stays in the 50 MB L2).
//
// Contract: x (S, L) of 4-byte (f32) or 2-byte (bf16) elements, idx
// (M, L) int32, out (M, L) of x's type; an index outside [0, S) gives 0.
// The copy moves bits, so the result is exact.
//
// Bound: bytes — idx read once, out written once, and at most M*L
// elements of x read (each gathered element once).  Design: one thread per
// output element, consecutive threads along l, so the idx load, the out
// store and, for a row index shared across a warp, the x load coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void take_along_rows_kernel(const T* __restrict__ x,
                                       const int32_t* __restrict__ idx,
                                       T* __restrict__ out, long long S,
                                       long long L, long long n) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long l = e % L;
    const long long r = idx[e];
    out[e] = (r >= 0 && r < S) ? x[r * L + l] : T(0);
  }
}

template <typename T>
int launch(const void* x, const void* idx, void* out, long long S,
           long long M, long long L, void* stream) {
  const long long n = M * L;
  if (n == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // resident on 132 SMs
  take_along_rows_kernel<T><<<(int)blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<T*>(out), S, L, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int take_along_rows_b32(const void* x, const void* idx, void* out,
                                   long long S, long long M, long long L,
                                   void* stream) {
  return launch<uint32_t>(x, idx, out, S, M, L, stream);
}

extern "C" int take_along_rows_b16(const void* x, const void* idx, void* out,
                                   long long S, long long M, long long L,
                                   void* stream) {
  return launch<uint16_t>(x, idx, out, S, M, L, stream);
}
