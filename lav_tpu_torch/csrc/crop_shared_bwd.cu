// crop_shared_bwd: the source gradient of the shared crop, f32 or bf16, as a
// gather.
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
// 1-|ix-(x0+dx)|), and d_src[b, y0+dy, x0+dx, :] gets g[b, k, pixel, :] *
// weight added.  Every cell of d_src is written, a cell no tap reaches
// with 0, so the caller need not fill it.  The grid gets no gradient.  A
// tap of weight 0 is skipped: it would add g * 0 = +-0, which changes no
// sum for a finite g (a non-finite g there is not propagated; training's
// is finite).  Each cell's terms are added in one fixed order (crop, then
// output row, then column), so the result is the same bit for bit on
// every run; it is within f32 rounding of lav_tpu's order.
//
// bf16 (crop_shared_bwd_bf16: g and d_src bf16, the grid f32): each tap's
// weight is rounded to bf16 and each product g * weight to bf16, as
// lav_tpu's VJP rounds them (`w.astype(g.dtype)`, `g * w` in bf16); the
// terms are summed in f32 and the cell is rounded to bf16 once.  lav_tpu
// adds the terms in bf16, by four scatter-adds whose order of duplicates
// XLA leaves open, so the two agree to a tolerance that grows with a
// cell's terms, not bit for bit (ROADMAP C).
//
// Bound: bytes.  g is read once and d_src written once: at the
// distillation step's shapes (B = 4, 4 + 1 crops of 96x96x384 from a
// 160x160x384 source) 283 MB of g and 157 MB of d_src, 0.13 ms at
// 3.35 TB/s in f32, half that in bf16.
//
// Design: the work runs from the source side, one writer per cell, no
// atomics.  A warp owns a source cell (x, y) of item b and a slice of its
// channels (3 16-byte vectors a lane for C = 384); it finds the output
// pixels of each crop of item b whose taps can reach the cell, adds their
// g * weight in registers, and stores the cell once.
//   1. map (a block per crop): a crop's positions are an affine function
//      of the output pixel (u, v) when the grid comes from an affine map
//      (`affine_grid`), as every crop's does.  The pass fits that function
//      through three corners of the crop's grid (in double), measures the
//      largest distance `dev` of any pixel's position from the fit, and
//      stores the fit's inverse.  The kernel relies on nothing more: a
//      grid far from affine widens the window by `dev`, and a crop whose
//      fit is degenerate (|det| near 0, a 1-pixel side, a non-finite
//      position) takes every output pixel as a candidate.
//   2. gather (a warp per cell and channel slice): a tap reaches (x, y)
//      with a weight above 0 only if |ix - x| < 1 and |iy - y| < 1 (the
//      clamping keeps this true at the borders: ix in (-1, 0) weighs only
//      tap 0, ix in [W-1, W) only tap W-1).  The inverse image of that
//      square, widened by `dev`, bounds the candidates in (u, v); one more
//      output pixel on each side covers rounding.  At the step's scale
//      (about one source pixel an output pixel) that is at most 5 x 5
//      candidates: the warp's lanes test one candidate each with the
//      forward's own arithmetic on the candidate's own grid values (never
//      the fit), a ballot lists the hits, and the warp walks them in order,
//      two at a time, each lane loading its 16-byte vectors of the hit's g
//      row (coalesced, 1536 bytes a row).  Each output pixel is read by
//      the (up to) four warps of its taps; neighbouring cells are
//      neighbouring warps of a block, so the rereads hit L1 or L2 and the
//      device memory sees g about once.  A warp may own a block of
//      kCellsX x kCellsY cells and walk the union of their windows, which
//      reads a hit's g row once for all of them (2.25 reads an output pixel
//      for 2 x 2, not 4) with each cell's terms in the same order; at the
//      step's shapes 1 x 1 is the fastest, so the rereads are not what
//      bounds the kernel (PERF.md, `turns.py train --variants`).
// A lane's vectors are 16 bytes (4 f32 or 8 bf16 channels), each channel
// summed in an f32 register.  C not a multiple of 4 (f32) or 8 (bf16), or
// a g or d_src not 16-byte aligned, takes the same kernel over single
// elements.  `map` is 8 floats a crop of scratch from the caller.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMap = 8;  // inv00, inv01, inv10, inv11, ox, oy, hu, hv
constexpr int kCellsX = 1, kCellsY = 1;  // the cells of d_src a warp owns

// the forward's position of an output pixel, in source pixels
__device__ __forceinline__ void position(const float* gp, int H, int W,
                                         float& ix, float& iy) {
  ix = (gp[0] + 1.0f) * 0.5f * (float)(W - 1);
  iy = (gp[1] + 1.0f) * 0.5f * (float)(H - 1);
}

// the forward's weight of source cell (x, y) in the taps at (ix, iy): 0
// unless (x, y) is one of the four clamped taps
__device__ __forceinline__ float tap_weight(float ix, float iy, int x, int y,
                                            int H, int W) {
  const float x0f = fminf(fmaxf(floorf(ix), 0.0f), (float)(W - 2));
  const float y0f = fminf(fmaxf(floorf(iy), 0.0f), (float)(H - 2));
  const int dx = x - (int)x0f, dy = y - (int)y0f;
  if ((unsigned)dx > 1u || (unsigned)dy > 1u) return 0.0f;
  const float wx = fmaxf(0.0f, 1.0f - fabsf(ix - (x0f + (float)dx)));
  const float wy = fmaxf(0.0f, 1.0f - fabsf(iy - (y0f + (float)dy)));
  return __fmul_rn(wy, wx);
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

// 1. a block per crop: the affine fit of its positions, the fit's largest
// miss, and the inverse the gather reads
__global__ void __launch_bounds__(kThreads)
    crop_map_kernel(const float* __restrict__ grid, float* __restrict__ map,
                    int H, int W, int Ho, int Wo) {
  __shared__ double part[kThreads / 32];
  const long long npix = (long long)Ho * Wo;
  const float* gr = grid + (long long)blockIdx.x * npix * 2;
  float x00, y00, x10, y10, x01, y01;
  position(gr, H, W, x00, y00);
  position(gr + 2 * (Wo - 1), H, W, x10, y10);
  position(gr + 2 * (long long)(Ho - 1) * Wo, H, W, x01, y01);
  // d(ix, iy) / du and / dv
  const double a = Wo > 1 ? ((double)x10 - x00) / (Wo - 1) : 0.0;
  const double b = Ho > 1 ? ((double)x01 - x00) / (Ho - 1) : 0.0;
  const double c = Wo > 1 ? ((double)y10 - y00) / (Wo - 1) : 0.0;
  const double d = Ho > 1 ? ((double)y01 - y00) / (Ho - 1) : 0.0;
  double dev = 0.0;  // a NaN miss makes it infinite
  for (long long i = threadIdx.x; i < npix; i += blockDim.x) {
    const int u = (int)(i % Wo), v = (int)(i / Wo);
    float ix, iy;
    position(gr + 2 * i, H, W, ix, iy);
    const double e =
        fmax(fabs(ix - __dadd_rn(__dadd_rn(x00, __dmul_rn(a, u)),
                                 __dmul_rn(b, v))),
             fabs(iy - __dadd_rn(__dadd_rn(y00, __dmul_rn(c, u)),
                                 __dmul_rn(d, v))));
    const bool nan = ix != ix || iy != iy || e != e;
    dev = nan ? INFINITY : fmax(dev, e);
  }
  dev = warp_max(dev);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = dev;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) dev = fmax(dev, part[w]);
  // unfused, as crop_bwd_map (core/warp.py) computes them
  const double det = __dmul_rn(a, d) - __dmul_rn(b, c);
  const double scale = (fabs(a) + fabs(b)) * (fabs(c) + fabs(d));
  float* m = map + (long long)blockIdx.x * kMap;
  if (isfinite(dev) && isfinite(det) && isfinite(scale) &&
      fabs(det) > 1e-9 * scale && isfinite((double)x00) &&
      isfinite((double)y00)) {
    const double i00 = d / det, i01 = -b / det, i10 = -c / det, i11 = a / det;
    const double r = 1.0 + dev + 1e-3;  // the square's half side, and slack
    m[0] = (float)i00, m[1] = (float)i01, m[2] = (float)i10, m[3] = (float)i11;
    m[4] = x00, m[5] = y00;
    m[6] = (float)(__dmul_rn(r, fabs(i00) + fabs(i01)) + 1.0);
    m[7] = (float)(__dmul_rn(r, fabs(i10) + fabs(i11)) + 1.0);
  } else {  // every output pixel is a candidate
    m[0] = m[1] = m[2] = m[3] = m[4] = m[5] = 0.0f;
    m[6] = m[7] = INFINITY;
  }
}

// the element types of g and d_src: `Raw` is what one lane loads (a
// 16-byte vector or one element), `kN` its channels, each summed in f32
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
struct F32x4 {
  using Raw = float4;
  static constexpr int kN = 4;
  static constexpr bool kBf16 = false;
  __device__ static void unpack(const Raw& r, float* x) {
    x[0] = r.x, x[1] = r.y, x[2] = r.z, x[3] = r.w;
  }
  __device__ static Raw pack(const float* x) {
    return make_float4(x[0], x[1], x[2], x[3]);
  }
};
struct F32x1 {
  using Raw = float;
  static constexpr int kN = 1;
  static constexpr bool kBf16 = false;
  __device__ static void unpack(const Raw& r, float* x) { x[0] = r; }
  __device__ static Raw pack(const float* x) { return x[0]; }
};
struct Bf16x8 {  // two bf16 a 32-bit word, the lower address in the low half
  using Raw = uint4;
  static constexpr int kN = 8;
  static constexpr bool kBf16 = true;
  __device__ static void unpack(const Raw& r, float* x) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static Raw pack(const float* x) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bf16_bits(x[2 * i]) | (bf16_bits(x[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
struct Bf16x1 {
  using Raw = unsigned short;
  static constexpr int kN = 1;
  static constexpr bool kBf16 = true;
  __device__ static void unpack(const Raw& r, float* x) {
    x[0] = __uint_as_float((uint32_t)r << 16);
  }
  __device__ static Raw pack(const float* x) {
    return (unsigned short)bf16_bits(x[0]);
  }
};

// a tap's weight as the sum takes it: f32, or rounded to bf16
template <typename V>
__device__ __forceinline__ float tap_term_weight(float w) {
  return V::kBf16 ? bf16_round(w) : w;
}
// acc + g * w, the product rounded to bf16 in the bf16 form
template <typename V>
__device__ __forceinline__ float axpy(float acc, float g, float w) {
  const float p = __fmul_rn(g, w);
  return __fadd_rn(acc, V::kBf16 ? bf16_round(p) : p);
}

// the candidate window of cell (x, y) in crop m's map, clamped to the crop
// in float (it may be infinite); false when empty
__device__ __forceinline__ bool window(const float* m, int x, int y, int Ho,
                                       int Wo, int& u0, int& u1, int& v0,
                                       int& v1) {
  const float dx = (float)x - __ldg(m + 4), dy = (float)y - __ldg(m + 5);
  // rounded as crop_bwd_window (core/warp.py) rounds them
  const float uc =
      __fadd_rn(__fmul_rn(__ldg(m), dx), __fmul_rn(__ldg(m + 1), dy));
  const float vc =
      __fadd_rn(__fmul_rn(__ldg(m + 2), dx), __fmul_rn(__ldg(m + 3), dy));
  const float hu = __ldg(m + 6), hv = __ldg(m + 7);
  const float u0f = fmaxf(ceilf(uc - hu), 0.0f);
  const float u1f = fminf(floorf(uc + hu), (float)(Wo - 1));
  const float v0f = fmaxf(ceilf(vc - hv), 0.0f);
  const float v1f = fminf(floorf(vc + hv), (float)(Ho - 1));
  if (!(u0f <= u1f && v0f <= v1f)) return false;
  u0 = (int)u0f, u1 = (int)u1f, v0 = (int)v0f, v1 = (int)v1f;
  return true;
}

// 2. a warp per (block of CX x CY cells of d_src, slice of 32 * VPL
// channel vectors); V is the vector type (F32x4, F32x1, Bf16x8, Bf16x1).
// The warp walks the union of its cells' windows: a hit's g row is read
// once for all the cells it reaches, each cell's terms still in its own
// window's order.
template <typename V, int VPL, int CX, int CY>
__global__ void __launch_bounds__(kThreads)
    crop_gather_kernel(const typename V::Raw* __restrict__ g,
                       const float* __restrict__ grid,
                       const float* __restrict__ map,
                       typename V::Raw* __restrict__ d_src, int H, int W,
                       int K, int Ho, int Wo, int nvec, int slices,
                       long long warps) {
  using T = typename V::Raw;
  constexpr int kCells = CX * CY, kN = V::kN;
  const long long wid =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (wid >= warps) return;
  const int lane = threadIdx.x & 31;
  const int slice = (int)(wid % slices);
  const int bw = (W + CX - 1) / CX, bh = (H + CY - 1) / CY;
  const long long blk = wid / slices;  // (b * bh + by) * bw + bx
  const int x0 = (int)(blk % bw) * CX, y0 = (int)((blk / bw) % bh) * CY;
  const long long b = blk / ((long long)bh * bw);
  const long long npix = (long long)Ho * Wo;
  const int v0 = slice * 32 * VPL + lane;  // this lane's first vector
  float acc[kCells][VPL][kN];
#pragma unroll
  for (int c = 0; c < kCells; ++c)
#pragma unroll
    for (int t = 0; t < VPL; ++t)
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[c][t][e] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long crop = b * K + k;
    const float* m = map + crop * kMap;
    int ulo = INT_MAX, uhi = -1, vlo = INT_MAX, vhi = -1;
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const int x = x0 + c % CX, y = y0 + c / CX;
      int a0, a1, c0, c1;
      if (x < W && y < H && window(m, x, y, Ho, Wo, a0, a1, c0, c1)) {
        ulo = min(ulo, a0), uhi = max(uhi, a1), vlo = min(vlo, c0),
        vhi = max(vhi, c1);
      }
    }
    if (ulo > uhi) continue;
    const int nu = uhi - ulo + 1;
    const int n = nu * (vhi - vlo + 1);
    const float* gr = grid + crop * npix * 2;
    const T* gc = g + crop * npix * nvec;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      float w[kCells];
      bool any = false;
      int pix = 0;
#pragma unroll
      for (int c = 0; c < kCells; ++c) w[c] = 0.0f;
      if (i < n) {
        pix = (vlo + i / nu) * Wo + ulo + i % nu;
        float ix, iy;
        position(gr + 2 * (long long)pix, H, W, ix, iy);
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          w[c] = tap_term_weight<V>(
              tap_weight(ix, iy, x0 + c % CX, y0 + c / CX, H, W));
          any |= w[c] != 0.0f;
        }
      }
      unsigned hits = __ballot_sync(0xffffffffu, any);
      while (hits) {  // two hits at a time: 2 * VPL loads in flight
        const int j1 = __ffs(hits) - 1;
        hits &= hits - 1;
        const bool two = hits != 0;
        const int j2 = two ? __ffs(hits) - 1 : j1;
        if (two) hits &= hits - 1;
        const T* r1 = gc + (long long)__shfl_sync(0xffffffffu, pix, j1) * nvec;
        const T* r2 = gc + (long long)__shfl_sync(0xffffffffu, pix, j2) * nvec;
        T a1[VPL], a2[VPL];
#pragma unroll
        for (int t = 0; t < VPL; ++t) {
          const int v = v0 + 32 * t;
          if (v < nvec) {
            a1[t] = __ldg(r1 + v);
            if (two) a2[t] = __ldg(r2 + v);
          }
        }
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          const float w1c = __shfl_sync(0xffffffffu, w[c], j1);
          const float w2c = __shfl_sync(0xffffffffu, w[c], j2);
#pragma unroll
          for (int t = 0; t < VPL; ++t) {
            if (v0 + 32 * t < nvec) {
              float x[kN];
              if (w1c != 0.0f) {
                V::unpack(a1[t], x);
#pragma unroll
                for (int e = 0; e < kN; ++e)
                  acc[c][t][e] = axpy<V>(acc[c][t][e], x[e], w1c);
              }
              if (two && w2c != 0.0f) {
                V::unpack(a2[t], x);
#pragma unroll
                for (int e = 0; e < kN; ++e)
                  acc[c][t][e] = axpy<V>(acc[c][t][e], x[e], w2c);
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const int x = x0 + c % CX, y = y0 + c / CX;
    if (x >= W || y >= H) continue;
    T* out = d_src + ((b * H + y) * W + x) * nvec;
#pragma unroll
    for (int t = 0; t < VPL; ++t)
      if (v0 + 32 * t < nvec) __stcs(out + v0 + 32 * t, V::pack(acc[c][t]));
  }
}

template <typename V, int VPL>
void launch_gather(const void* g, const void* grid, const float* map,
                   void* d_src, int B, int H, int W, int K, int Ho, int Wo,
                   int nvec, cudaStream_t st) {
  using T = typename V::Raw;
  const int slices = (nvec + 32 * VPL - 1) / (32 * VPL);
  const long long warps = (long long)B * ((H + kCellsY - 1) / kCellsY) *
                          ((W + kCellsX - 1) / kCellsX) * slices;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  crop_gather_kernel<V, VPL, kCellsX, kCellsY>
      <<<(unsigned)blocks, kThreads, 0, st>>>(
          static_cast<const T*>(g), static_cast<const float*>(grid), map,
          static_cast<T*>(d_src), H, W, K, Ho, Wo, nvec, slices, warps);
}

// vectors a lane: the fewest that cover nvec in one slice, at most 4
template <typename V>
void gather(const void* g, const void* grid, const float* map, void* d_src,
            int B, int H, int W, int K, int Ho, int Wo, int nvec,
            cudaStream_t st) {
  const int vpl = nvec <= 32 ? 1 : nvec <= 64 ? 2 : nvec <= 96 ? 3 : 4;
  if (vpl == 1)
    launch_gather<V, 1>(g, grid, map, d_src, B, H, W, K, Ho, Wo, nvec, st);
  else if (vpl == 2)
    launch_gather<V, 2>(g, grid, map, d_src, B, H, W, K, Ho, Wo, nvec, st);
  else if (vpl == 3)
    launch_gather<V, 3>(g, grid, map, d_src, B, H, W, K, Ho, Wo, nvec, st);
  else
    launch_gather<V, 4>(g, grid, map, d_src, B, H, W, K, Ho, Wo, nvec, st);
}

// both passes; V is the 16-byte vector of the element type, S its single
// element, taken when `vec` is 1
template <typename V, typename S>
int crop_bwd(const void* g, const void* grid, void* d_src, void* map, int B,
             int H, int W, int C, int K, int Ho, int Wo, int vec,
             void* stream) {
  if (B == 0 || C == 0) return 0;
  if (H < 2 || W < 2 || B < 0 || K < 0 || Ho < 0 || Wo < 0 ||
      (vec != 1 && (vec != V::kN || C % V::kN)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(map);
  // a crop of no pixel reaches nothing: the gather sees no crop
  const int crops = Ho > 0 && Wo > 0 ? K : 0;
  if (crops > 0)
    crop_map_kernel<<<B * crops, kThreads, 0, st>>>(
        static_cast<const float*>(grid), m, H, W, Ho, Wo);
  if (vec == V::kN)
    gather<V>(g, grid, m, d_src, B, H, W, crops, Ho, Wo, C / V::kN, st);
  else
    gather<S>(g, grid, m, d_src, B, H, W, crops, Ho, Wo, C, st);
  return (int)cudaGetLastError();
}

}  // namespace

// map: 8 floats a crop (B * K) of scratch; vec: 4 (16-byte vectors) or 1
extern "C" int crop_shared_bwd_f32(const void* g, const void* grid,
                                   void* d_src, void* map, int B, int H,
                                   int W, int C, int K, int Ho, int Wo,
                                   int vec, void* stream) {
  return crop_bwd<F32x4, F32x1>(g, grid, d_src, map, B, H, W, C, K, Ho, Wo,
                                vec, stream);
}

// g and d_src bf16, the grid f32; vec: 8 (16-byte vectors) or 1
extern "C" int crop_shared_bwd_bf16(const void* g, const void* grid,
                                    void* d_src, void* map, int B, int H,
                                    int W, int C, int K, int Ho, int Wo,
                                    int vec, void* stream) {
  return crop_bwd<Bf16x8, Bf16x1>(g, grid, d_src, map, B, H, W, C, K, Ho,
                                  Wo, vec, stream);
}
