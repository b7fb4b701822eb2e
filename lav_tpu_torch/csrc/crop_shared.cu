// crop_shared: K bilinear crops per batch item from that item's own
// NHWC source, align_corners=True with zero padding.
//
// Replaces the Pallas TPU kernel lav_tpu/core/warp_pallas.py::_kernel
// (launched by _grid_sample_pallas_batched; entries
// grid_sample_shared_pallas and grid_sample_shared_pallas_q8), f32 and
// bf16 forms.  The TPU kernel turned the gather into a tile-resident MXU
// matmul with hinge weights; on Hopper a direct 4-tap gather is the
// natural form.
//
// Semantics (lav_tpu/core/warp.py::grid_sample_shared): the tap origin is
// floor(pos) clamped into [0, W-2] x [0, H-2]; tap (dy, dx) gets weight
// max(0, 1-|iy-(y0+dy)|) * max(0, 1-|ix-(x0+dx)|), computed in f32 and
// cast to the source dtype; the four products accumulate in f32 and the
// sum is cast to the source dtype.
//
// Bound: bytes.  Each output element is written once and each source
// element is read at least once; at the agent's shapes (src 160x160x384,
// K+1 = 16 crops of 96x96) the f32 output is 226 MB per ego against a
// 39 MB source, so the write dominates.  Design: one block per (batch,
// crop, tile of output pixels); threadIdx.x runs over channel vectors of
// 16 bytes (consecutive threads on consecutive channels, so the four tap
// rows and the output row are coalesced), threadIdx.y over pixels.  The
// source (39 MB f32) stays resident in the 50 MB L2 across the crops.
//
// q8 entries (crop_shared_q8_{f32,bf16}): the TPU kernel's q8=True
// epilogue (warp_pallas.py:164-168).  The f32 sum above is not cast to the
// source dtype but quantized in registers: q = clip(rint(acc * inv_s),
// -127, 127) as int8, with inv_s = 1/x_scale an f32 read from device
// memory (so a calibrated scale needs no host sync).  rintf rounds half to
// even, as jnp.round and torch.round do.  Bound: bytes again; the int8
// output (57 MB for 16 crops of 96x96x384 per ego) is half the bf16 one,
// so the crop write halves.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ int8_t quantize(float acc, float inv_s) {
  const float q = rintf(__fmul_rn(acc, inv_s));
  return (int8_t)fminf(fmaxf(q, -127.0f), 127.0f);
}

constexpr int kPixPerBlock = 32;

// OutT is T for the plain crop and int8_t for the q8 epilogue.
template <typename T, int V, typename OutT>
__global__ void crop_shared_kernel(const T* __restrict__ src,
                                   const float* __restrict__ grid,
                                   OutT* __restrict__ out,
                                   const float* __restrict__ inv_s, int H,
                                   int W, int C, int K, int npix) {
  constexpr bool kQ8 = std::is_same<OutT, int8_t>::value;
  const float inv = kQ8 ? *inv_s : 0.0f;
  const int b = blockIdx.z;
  const int k = blockIdx.y;
  const int p_begin = blockIdx.x * kPixPerBlock;
  const int p_end = min(p_begin + kPixPerBlock, npix);
  const int nvec = C / V;
  const T* s = src + (size_t)b * H * W * C;
  const float* g = grid + ((size_t)b * K + k) * npix * 2;
  OutT* o = out + ((size_t)b * K + k) * (size_t)npix * C;

  for (int p = p_begin + threadIdx.y; p < p_end; p += blockDim.y) {
    const float ix = (g[2 * p] + 1.0f) * 0.5f * (float)(W - 1);
    const float iy = (g[2 * p + 1] + 1.0f) * 0.5f * (float)(H - 1);
    const float x0f = fminf(fmaxf(floorf(ix), 0.0f), (float)(W - 2));
    const float y0f = fminf(fmaxf(floorf(iy), 0.0f), (float)(H - 2));
    const float wy0 = fmaxf(0.0f, 1.0f - fabsf(iy - y0f));
    const float wy1 = fmaxf(0.0f, 1.0f - fabsf(iy - (y0f + 1.0f)));
    const float wx0 = fmaxf(0.0f, 1.0f - fabsf(ix - x0f));
    const float wx1 = fmaxf(0.0f, 1.0f - fabsf(ix - (x0f + 1.0f)));
    // weights in the source dtype, as the TPU kernel's contract says
    const float w00 = to_f(from_f<T>(__fmul_rn(wy0, wx0)));
    const float w01 = to_f(from_f<T>(__fmul_rn(wy0, wx1)));
    const float w10 = to_f(from_f<T>(__fmul_rn(wy1, wx0)));
    const float w11 = to_f(from_f<T>(__fmul_rn(wy1, wx1)));

    const T* r00 = s + ((size_t)((int)y0f) * W + (int)x0f) * C;
    const T* r01 = r00 + C;
    const T* r10 = r00 + (size_t)W * C;
    const T* r11 = r10 + C;
    OutT* op = o + (size_t)p * C;
    for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
      const Vec<T, V> a = reinterpret_cast<const Vec<T, V>*>(r00)[c];
      const Vec<T, V> bq = reinterpret_cast<const Vec<T, V>*>(r01)[c];
      const Vec<T, V> cq = reinterpret_cast<const Vec<T, V>*>(r10)[c];
      const Vec<T, V> d = reinterpret_cast<const Vec<T, V>*>(r11)[c];
      Vec<OutT, V> r;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float acc = w00 * to_f(a.v[i]);
        acc += w01 * to_f(bq.v[i]);
        acc += w10 * to_f(cq.v[i]);
        acc += w11 * to_f(d.v[i]);
        if constexpr (kQ8)
          r.v[i] = quantize(acc, inv);
        else
          r.v[i] = from_f<T>(acc);
      }
      reinterpret_cast<Vec<OutT, V>*>(op)[c] = r;
    }
  }
}

template <typename T, int V, typename OutT>
int launch(const void* src, const void* grid, void* out, const void* inv_s,
           int B, int H, int W, int C, int K, int Ho, int Wo,
           cudaStream_t stream) {
  const int npix = Ho * Wo;
  const int nvec = C / V;
  dim3 block(nvec < 256 ? nvec : 256, 1, 1);
  block.y = 256 / block.x > kPixPerBlock ? kPixPerBlock : 256 / block.x;
  if (block.y < 1) block.y = 1;
  dim3 grid_dim((npix + kPixPerBlock - 1) / kPixPerBlock, K, B);
  crop_shared_kernel<T, V, OutT><<<grid_dim, block, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const float*>(grid),
      static_cast<OutT*>(out), static_cast<const float*>(inv_s), H, W, C, K,
      npix);
  return (int)cudaGetLastError();
}

template <typename T, typename OutT>
int dispatch(const void* src, const void* grid, void* out, const void* inv_s,
             int B, int H, int W, int C, int K, int Ho, int Wo, int vec,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || K == 0 || Ho * Wo == 0 || C == 0) return 0;
  constexpr int VMAX = 16 / sizeof(T);
  if (vec == VMAX)
    return launch<T, VMAX, OutT>(src, grid, out, inv_s, B, H, W, C, K, Ho,
                                 Wo, st);
  return launch<T, 1, OutT>(src, grid, out, inv_s, B, H, W, C, K, Ho, Wo,
                            st);
}

}  // namespace

extern "C" int crop_shared_f32(const void* src, const void* grid, void* out,
                               int B, int H, int W, int C, int K, int Ho,
                               int Wo, int vec, void* stream) {
  return dispatch<float, float>(src, grid, out, nullptr, B, H, W, C, K, Ho,
                                Wo, vec, stream);
}

extern "C" int crop_shared_bf16(const void* src, const void* grid, void* out,
                                int B, int H, int W, int C, int K, int Ho,
                                int Wo, int vec, void* stream) {
  return dispatch<__nv_bfloat16, __nv_bfloat16>(
      src, grid, out, nullptr, B, H, W, C, K, Ho, Wo, vec, stream);
}

extern "C" int crop_shared_q8_f32(const void* src, const void* grid,
                                  void* out, const void* inv_s, int B, int H,
                                  int W, int C, int K, int Ho, int Wo,
                                  int vec, void* stream) {
  return dispatch<float, int8_t>(src, grid, out, inv_s, B, H, W, C, K, Ho,
                                 Wo, vec, stream);
}

extern "C" int crop_shared_q8_bf16(const void* src, const void* grid,
                                   void* out, const void* inv_s, int B,
                                   int H, int W, int C, int K, int Ho, int Wo,
                                   int vec, void* stream) {
  return dispatch<__nv_bfloat16, int8_t>(src, grid, out, inv_s, B, H, W, C,
                                         K, Ho, Wo, vec, stream);
}
