// crop_shared_bwd: the source gradient of the f32 shared crop.
//
// Replaces lav_tpu's custom VJP of the shared crop,
// lav_tpu/core/warp.py::_grid_sample_shared_bwd (also the backward of the
// Pallas route, warp_pallas.py:447-451), which XLA computes as four
// scatter-adds; lav_tpu has no Pallas kernel for it.  The distillation
// step runs it on the student's crops of the lidar features.
//
// Contract (the forward's geometry, csrc/crop_shared.cu): for each output
// pixel of crop k of item b, ix = (gx + 1) / 2 * (W - 1), iy likewise;
// the tap origin floor(pos) is clamped into [0, W-2] x [0, H-2]; tap
// (dy, dx) has the f32 weight max(0, 1-|iy-(y0+dy)|) * max(0,
// 1-|ix-(x0+dx)|), and d_src[b, y0+dy, x0+dx, :] += g[b, k, pixel, :] *
// weight.  d_src starts zeroed (the wrapper zeroes it).  The grid gets no
// gradient.  A tap of weight 0 is skipped: it would add g * 0 = +-0,
// which changes no sum for a finite g (a non-finite g there is not
// propagated; training's is finite).  The adds are atomics, in an order
// that changes from run to run: the sums are within f32 rounding of
// lav_tpu's sequential order, not bit-reproducible.
//
// Bound: bytes.  g is read once and d_src written once: at the
// distillation step's shapes (B = 4, 4 + 1 crops of 96x96x384 from a
// 160x160x384 source) 283 MB of g and 157 MB of d_src, 0.13 ms at
// 3.35 TB/s.  Design, simple first: one thread per (output pixel,
// 4-channel vector), consecutive threads on consecutive vectors of one
// pixel, so g is read in 16-byte coalesced pieces (streaming, __ldcs);
// each tap is one 16-byte vector reduction (red.global.add.v4.f32,
// sm_90), as csrc/pillar_scatter.cu's scatter_add does.  The four taps'
// reductions read and write d_src in L2; a 157 MB d_src does not fit the
// 50 MB L2, so the reductions' traffic, not g, sets the time.  Each
// thread recomputes its pixel's geometry (the grid read hits L1).  C not
// a multiple of 4, or a g not 16-byte aligned, takes one thread per
// (pixel, channel) and scalar atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void red_add_v4(float* addr, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void red_add(float* addr, float4 v) {
  red_add_v4(addr, v);
}
__device__ __forceinline__ void red_add(float* addr, float v) {
  atomicAdd(addr, v);
}

__device__ __forceinline__ float4 scale(float4 v, float w) {
  return make_float4(__fmul_rn(v.x, w), __fmul_rn(v.y, w),
                     __fmul_rn(v.z, w), __fmul_rn(v.w, w));
}
__device__ __forceinline__ float scale(float v, float w) {
  return __fmul_rn(v, w);
}

// V = 4: T is float4, one 4-channel vector a thread; V = 1: T is float
template <typename T, int V>
__global__ void crop_bwd_kernel(const T* __restrict__ g,
                                const float* __restrict__ grid,
                                float* __restrict__ d_src, int H, int W,
                                int C, long long pix_per_item,
                                long long total, int nvec) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long pix = i / nvec;
    const int v = (int)(i - pix * nvec);
    const long long b = pix / pix_per_item;
    const float ix = (grid[2 * pix] + 1.0f) * 0.5f * (float)(W - 1);
    const float iy = (grid[2 * pix + 1] + 1.0f) * 0.5f * (float)(H - 1);
    const float x0f = fminf(fmaxf(floorf(ix), 0.0f), (float)(W - 2));
    const float y0f = fminf(fmaxf(floorf(iy), 0.0f), (float)(H - 2));
    const float wy0 = fmaxf(0.0f, 1.0f - fabsf(iy - y0f));
    const float wy1 = fmaxf(0.0f, 1.0f - fabsf(iy - (y0f + 1.0f)));
    const float wx0 = fmaxf(0.0f, 1.0f - fabsf(ix - x0f));
    const float wx1 = fmaxf(0.0f, 1.0f - fabsf(ix - (x0f + 1.0f)));
    const float w[4] = {__fmul_rn(wy0, wx0), __fmul_rn(wy0, wx1),
                        __fmul_rn(wy1, wx0), __fmul_rn(wy1, wx1)};
    if (w[0] == 0.0f && w[1] == 0.0f && w[2] == 0.0f && w[3] == 0.0f)
      continue;  // wholly outside the source
    const T gv = __ldcs(g + i);
    float* base = d_src +
                  ((b * H + (long long)y0f) * W + (long long)x0f) * C +
                  (long long)v * V;
    const long long off[4] = {0, C, (long long)W * C, (long long)W * C + C};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (w[t] != 0.0f) red_add(base + off[t], scale(gv, w[t]));
  }
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;  // enough resident blocks for 132 SMs
  if (b > cap) b = cap;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace

extern "C" int crop_shared_bwd_f32(const void* g, const void* grid,
                                   void* d_src, int B, int H, int W, int C,
                                   int K, int Ho, int Wo, int vec,
                                   void* stream) {
  if (B == 0 || K == 0 || Ho == 0 || Wo == 0 || C == 0) return 0;
  if (H < 2 || W < 2 || (vec == 4 && C % 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long pix_per_item = (long long)K * Ho * Wo;
  const long long pix = B * pix_per_item;
  if (vec == 4) {
    const int nvec = C / 4;
    crop_bwd_kernel<float4, 4><<<blocks_for(pix * nvec), kThreads, 0, st>>>(
        static_cast<const float4*>(g), static_cast<const float*>(grid),
        static_cast<float*>(d_src), H, W, C, pix_per_item, pix * nvec, nvec);
  } else {
    crop_bwd_kernel<float, 1><<<blocks_for(pix * C), kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(grid),
        static_cast<float*>(d_src), H, W, C, pix_per_item, pix * C, C);
  }
  return (int)cudaGetLastError();
}
