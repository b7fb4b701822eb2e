// take_along_rows: out[i, l] = x[idx[i, l], l], a gather along axis 0.
//
// Replaces the Pallas TPU kernel scripts/exp_gather.py::kern (its
// pallas_call at exp_gather.py:33), a probe of Mosaic's dynamic gather
// (jnp.take_along_axis(x, idx, axis=0) on VMEM-resident operands) at
// (S, L) in {8, 512, 9216, 25600} x {128, 256}, f32 and bf16.  The TPU
// kernel held both operands whole in VMEM.
//
// Contract (jnp.take_along_axis's): x (S, L) of 4-byte (f32) or 2-byte
// (bf16) elements, idx (M, L) int32, out (M, L) of x's type.  An index r
// in [-S, 0) reads row r + S; an index outside [-S, S) gives a quiet NaN
// of the element's width (0x7fc00000, 0x7fc0).  In range the bits move
// unchanged, so the result is exact.
//
// Bound: bytes — idx read once, out written once, and of x the distinct
// elements idx names: (25600, 128) f32 moves 34.5 MB, 0.0103 ms at
// 3.35 TB/s.  One thread an element, reading x where the indices point,
// puts a warp's 32 reads of x on 32 random rows: 32 L2 sectors of 32
// bytes for 128 (f32) or 64 (bf16) useful bytes, ~2.8x the bound.  A
// column slab of x in one block's shared memory did not help either: 227
// KB over S = 9216-25600 rows is a slab 2-8 bytes wide, whose loads cost
// as many sectors as the gathers.
//
// Design: one thread an element, in a grid-stride loop; a warp reads 32
// consecutive indices and writes 32 consecutive outputs, so idx and out
// move in whole sectors, while its reads of x fall where the indices
// point.  The index arithmetic is 32-bit wherever S * L and M * L (plus
// one stride) stay below 2^31, which holds at every probe shape; a 64-bit
// remainder an element is a long emulated sequence on this card.  A
// thread-block cluster holding column strips of x in distributed shared
// memory was built and measured on an H100, bit for bit right and 1.4-3.2x
// slower at the large cases: filling the SMs makes each block stage a
// 144-200 KB share of strips, which alone takes 60-70% of this body's
// time (PERF.md §6 has the table).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ uint32_t quiet_nan<uint32_t>() {
  return 0x7fc00000u;
}
template <>
__device__ __forceinline__ uint16_t quiet_nan<uint16_t>() {
  return 0x7fc0u;
}

// I: int where every index fits 31 bits, else long long
template <typename T, typename I>
__global__ void rows_simple(const T* __restrict__ x,
                            const int32_t* __restrict__ idx,
                            T* __restrict__ out, I S, I L, I n) {
  for (I e = blockIdx.x * (I)blockDim.x + threadIdx.x; e < n;
       e += (I)gridDim.x * blockDim.x) {
    const I l = e % L;
    I r = idx[e];
    r += r < 0 ? S : 0;
    out[e] = (r >= 0 && r < S) ? x[r * L + l] : quiet_nan<T>();
  }
}

template <typename T>
int launch(const void* x, const void* idx, void* out, long long S,
           long long M, long long L, void* stream) {
  const long long n = M * L;
  if (n == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // resident on 132 SMs
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const T*>(x);
  const auto ip = static_cast<const int32_t*>(idx);
  const auto op = static_cast<T*>(out);
  // 32-bit indices where x's and out's elements, and e plus one stride,
  // stay below 2^31
  if (S * L < (1LL << 31) && n + blocks * kThreads < (1LL << 31))
    rows_simple<T, int><<<(int)blocks, kThreads, 0, st>>>(
        xp, ip, op, (int)S, (int)L, (int)n);
  else
    rows_simple<T, long long><<<(int)blocks, kThreads, 0, st>>>(
        xp, ip, op, S, L, n);
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
