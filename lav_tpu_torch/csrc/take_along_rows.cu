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
// Bound: bytes — idx read once, out written once, and of x the distinct
// elements idx names: (25600, 128) f32 moves 34.5 MB, 0.0103 ms at
// 3.35 TB/s.  Design: one thread per element; a warp reads 32 consecutive
// indices and writes 32 consecutive outputs, so idx and out move in whole
// sectors, while its 32 reads of x land on 32 random rows: 32 L2 sectors
// of 32 bytes for 128 (f32) or 64 (bf16) useful bytes.  That scattered
// traffic, not the bytes, sets the large cases' time at ~2.8x the bound
// (f32): with the rows in order the same kernel takes 1.6x its bound
// (chip_smoke.py phase `gather`, "rows in order"; PERF.md).  Two other
// bodies were timed on the probe's six cases and not kept (PERF.md):
// 16-byte loads of idx and stores of out with 4 or 8 gathers per thread
// moved nothing, and a column slab of x staged in shared memory was
// slower (at most 227 KB of S rows leaves slabs 2-8 bytes wide at the
// large cases, so loading them costs as many sectors as the gathers).

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
