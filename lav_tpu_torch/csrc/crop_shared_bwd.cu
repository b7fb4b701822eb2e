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
// Bound: bytes.  g is read once and d_src written once by each call: at
// the distillation step's two calls (B = 4, 4 + 1 crops of 96x96x384 from
// a 160x160x384 source) 283 MB of g and 315 MB of d_src, 0.1789 ms at
// 3.35 TB/s in f32, 0.0896 in bf16.
//
// Design: the work runs from the source side, one writer per cell, no
// atomics.  A block owns a tile of kTileX x kTileY source cells of item b
// and a slice of their channels; it finds the output pixels of each crop
// of item b whose taps reach the tile, adds their g * weight to each cell
// in registers, and stores each cell once.
//   1. map (a block per crop): a crop's positions are an affine function
//      of the output pixel (u, v) when the grid comes from an affine map
//      (`affine_grid`), as every crop's does.  The pass fits that function
//      through three corners of the crop's grid (in double), measures the
//      largest distance `dev` of any pixel's position from the fit, and
//      stores the fit's inverse.  The kernel relies on nothing more: a
//      grid far from affine widens the window by `dev`, and a crop whose
//      fit is degenerate (|det| near 0, a 1-pixel side, a non-finite
//      position) takes every output pixel as a candidate.
//   2. tiles (a block per tile and channel slice): a tap reaches (x, y)
//      with a weight above 0 only if |ix - x| < 1 and |iy - y| < 1 (the
//      clamping keeps this true at the borders: ix in (-1, 0) weighs only
//      tap 0, ix in [W-1, W) only tap W-1).  The inverse image of that
//      square, widened by `dev` and one output pixel for rounding, is a
//      cell's window; the tile's is the union of its cells' (about 9 x 9
//      candidates a crop at the step's scale, one source pixel an output
//      pixel).  The candidates of every crop of the item form one list,
//      crop after crop; each thread tests one with the forward's own
//      arithmetic on its own grid values (never the fit): its four taps,
//      the weight of each that lands in the tile, and for a hit it asks
//      for the g row early (`prefetch.global.L1`).  A bit per (cell,
//      candidate) marks the hits; a hit's rank in its cell's list is the
//      count of bits before it, so each list keeps the candidates' order.
//      A worker of G lanes owns a cell and VPL 16-byte vectors a lane of
//      its channels (16 x 3 for 384 bf16 channels, 32 x 3 for 384 f32),
//      and walks the cell's list kHitsInFlight hits at a time, loading
//      each hit's g row (coalesced; the tile's other workers find it in
//      L1).  A candidate is tested by about (T + 3)^2 / T^2 tiles of side
//      T (3 at T = 4) where a warp per cell tested each about 25 times,
//      and a g row is read from L2 about (T + 1)^2 / T^2 times.  A list
//      of more than kChunk candidates (a zoom-in, a degenerate crop) is
//      taken in chunks, in order.  The registers decide the speed: held to
//      kTileRegs = 64 (4 blocks of 256 threads an SM), two bf16 hits in
//      flight spilled and were slower than one.
//   At the step's two calls on an NVIDIA H100 80GB HBM3 (700 W), device
//   only: bf16 0.1693 ms (the warp per cell took 0.3185; bound 0.0896),
//   f32 0.2519 (0.3038; bound 0.1789); at B = 32, bf16 1.19 ms (2.29), f32
//   1.92 (2.17) (`turns.py train`, PERF.md).
// Each cell's terms are added as the earlier warp per cell added them:
// by crop, then output row, then column, from 0, skipping weights of 0,
// with `axpy`'s rounding, so the two agree bit for bit (`turns.py train`).
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

constexpr int kMap = 8;  // inv00, inv01, inv10, inv11, ox, oy, hu, hv
constexpr int kTileX = 4, kTileY = 4;  // the cells of d_src a block owns
constexpr int kHitsInFlight[2] = {2, 1};  // hits a worker loads at once,
                                          // f32 and bf16 (its sums take
                                          // twice the registers)
constexpr int kMaxCrops = 32;          // crops whose windows a block holds
constexpr int kMapThreads = 1024;      // the map pass's block
constexpr int kTileRegs = 64;          // registers a thread, at most

// the forward's position of an output pixel, in source pixels
__device__ __forceinline__ void position(const float* gp, int H, int W,
                                         float& ix, float& iy) {
  ix = (gp[0] + 1.0f) * 0.5f * (float)(W - 1);
  iy = (gp[1] + 1.0f) * 0.5f * (float)(H - 1);
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

// 1. a block per crop: the affine fit of its positions, the fit's largest
// miss, and the inverse the gather reads
__global__ void __launch_bounds__(kMapThreads)
    crop_map_kernel(const float* __restrict__ grid, float* __restrict__ map,
                    int H, int W, int Ho, int Wo) {
  __shared__ double part[kMapThreads / 32];
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

// asks for the 128-byte line at p to be brought into L1
__device__ __forceinline__ void prefetch_l1(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

// a tap's weight as the sum takes it: f32, or rounded to bf16
template <typename V>
__device__ __forceinline__ float tap_term_weight(float w) {
  return V::kBf16 ? bf16_round(w) : w;
}
// acc[e] += g[e] * w over the channels of r, each product rounded to bf16
// in the bf16 forms (a pair at a time where it can: one conversion rounds
// both, as two would)
template <typename V>
__device__ __forceinline__ void axpy(float* acc, const typename V::Raw& r,
                                     float w) {
  float x[V::kN];
  V::unpack(r, x);
  if constexpr (V::kBf16 && V::kN % 2 == 0) {
#pragma unroll
    for (int e = 0; e < V::kN; e += 2) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(__fmul_rn(x[e], w),
                                                     __fmul_rn(x[e + 1], w));
      acc[e] = __fadd_rn(acc[e], __low2float(p));
      acc[e + 1] = __fadd_rn(acc[e + 1], __high2float(p));
    }
  } else {
#pragma unroll
    for (int e = 0; e < V::kN; ++e) {
      const float p = __fmul_rn(x[e], w);
      acc[e] = __fadd_rn(acc[e], V::kBf16 ? bf16_round(p) : p);
    }
  }
}

// the candidate window of the cells [xa, xb] x [ya, yb] in crop m's map.
// A cell's window is the output pixels within (hu, hv) of its centre, the
// fit's inverse at the cell (crop_bwd_window, core/warp.py); the tile's is
// the union of its cells', which is the box of its four corners' (each
// rounded step of the centre is monotone in x and in y, and so are ceil
// and floor), clamped to the crop (crop_bwd_tile_window); false when
// empty
__device__ __forceinline__ bool tile_window(const float* m, int xa, int xb,
                                            int ya, int yb, int Ho, int Wo,
                                            int& u0, int& u1, int& v0,
                                            int& v1) {
  const float i00 = __ldg(m), i01 = __ldg(m + 1), i10 = __ldg(m + 2),
              i11 = __ldg(m + 3), ox = __ldg(m + 4), oy = __ldg(m + 5);
  float ulo = INFINITY, uhi = -INFINITY, vlo = INFINITY, vhi = -INFINITY;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float dx = (float)(q & 1 ? xb : xa) - ox;
    const float dy = (float)(q & 2 ? yb : ya) - oy;
    // rounded as crop_bwd_window (core/warp.py) rounds them
    const float uc = __fadd_rn(__fmul_rn(i00, dx), __fmul_rn(i01, dy));
    const float vc = __fadd_rn(__fmul_rn(i10, dx), __fmul_rn(i11, dy));
    ulo = fminf(ulo, uc), uhi = fmaxf(uhi, uc);
    vlo = fminf(vlo, vc), vhi = fmaxf(vhi, vc);
  }
  const float hu = __ldg(m + 6), hv = __ldg(m + 7);
  const float u0f = fmaxf(ceilf(ulo - hu), 0.0f);
  const float u1f = fminf(floorf(uhi + hu), (float)(Wo - 1));
  const float v0f = fmaxf(ceilf(vlo - hv), 0.0f);
  const float v1f = fminf(floorf(vhi + hv), (float)(Ho - 1));
  if (!(u0f <= u1f && v0f <= v1f)) return false;
  u0 = (int)u0f, u1 = (int)u1f, v0 = (int)v0f, v1 = (int)v1f;
  return true;
}

// 2. a block per (tile of kTileX x kTileY cells of item b, slice of G *
// VPL channel vectors): a worker of G lanes per cell, VPL vectors a lane;
// V is the vector type (F32x4, F32x1, Bf16x8, Bf16x1).
// The candidates are the tile's window in each crop of item b, crop after
// crop, each row by row; in chunks of kChunk of them, each thread tests
// one (its four taps, the weight of each that lands in the tile), a bit
// per (cell, candidate) marks the hits, each hit takes its rank in its
// cell's list from the bits before it, and each worker walks its cell's
// list in order, kHitsInFlight hits at a time.
template <int G>
struct TileShape {
  static constexpr int kCells = kTileX * kTileY;
  static constexpr int kThreads = kCells * G;
  // candidates a chunk, a thread each; a cell's hit bits
  static constexpr int kChunk = kThreads < 256 ? kThreads : 256;
  static constexpr int kWords = kChunk / 32;
  static constexpr int kBlocks = 65536 / (kTileRegs * kThreads);
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "block size");
};

template <typename V, int VPL, int G>
__global__ void __launch_bounds__(TileShape<G>::kThreads,
                                  TileShape<G>::kBlocks)
    crop_tile_kernel(const typename V::Raw* __restrict__ g,
                     const float* __restrict__ grid,
                     const float* __restrict__ map,
                     typename V::Raw* __restrict__ d_src, int H, int W, int K,
                     int Ho, int Wo, int nvec) {
  using T = typename V::Raw;
  using S = TileShape<G>;
  constexpr int kCells = S::kCells;
  constexpr int kThreads = S::kThreads, kChunk = S::kChunk;
  constexpr int kWords = S::kWords;
  constexpr int kF = kHitsInFlight[V::kBf16];
  __shared__ int s_row[kChunk];            // a candidate's g row in its item
  __shared__ float s_w[kChunk][4];         // its taps' weights, by slot
  __shared__ unsigned s_mask[kCells][kWords];
  __shared__ unsigned short s_list[kCells][kChunk];  // candidate << 2 | slot
  __shared__ int s_cnt[kCells];
  __shared__ int s_win[kMaxCrops + 1][4];  // u0, v0, columns, first candidate
  const int t = threadIdx.x;
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const int tiles_y = (H + kTileY - 1) / kTileY;
  const int tx0 = (int)(blockIdx.x % tiles_x) * kTileX;
  const int ty0 = (int)((blockIdx.x / tiles_x) % tiles_y) * kTileY;
  const long long b = blockIdx.x / ((long long)tiles_x * tiles_y);
  const int xb = min(tx0 + kTileX, W) - 1, yb = min(ty0 + kTileY, H) - 1;
  const int npix = Ho * Wo;
  const float* gi = grid + b * K * npix * 2;  // item b's crops
  const T* gb = g + b * K * npix * nvec;
  const float* mb = map + b * K * kMap;
  const int v0 = (int)blockIdx.y * G * VPL + t % G;  // this lane's first
  const int cell = t / G;  // this worker's
  float acc[VPL][V::kN];
#pragma unroll
  for (int q = 0; q < VPL; ++q)
#pragma unroll
    for (int e = 0; e < V::kN; ++e) acc[q][e] = 0.0f;
  for (int i = t; i < kCells * kWords; i += kThreads)
    (&s_mask[0][0])[i] = 0u;
  for (int k0 = 0; k0 < K; k0 += kMaxCrops) {  // kMaxCrops crops at a time
    const int nk = min(K - k0, kMaxCrops);
    if (t < nk) {  // the tile's window in crop k0 + t
      int u0 = 0, u1 = 0, wv0 = 0, wv1 = 0;
      const bool any = tile_window(mb + (k0 + t) * kMap, tx0, xb, ty0, yb, Ho,
                                   Wo, u0, u1, wv0, wv1);
      s_win[t][0] = u0, s_win[t][1] = wv0;
      s_win[t][2] = any ? u1 - u0 + 1 : 0;
      s_win[t][3] = any ? (u1 - u0 + 1) * (wv1 - wv0 + 1) : 0;  // its size
    }
    __syncthreads();
    if (t == 0)  // sizes -> first candidates; the total after the last
      for (int k = 0, at = 0; k <= nk; ++k) {
        const int n = k < nk ? s_win[k][3] : 0;
        s_win[k][3] = at;
        at += n;
      }
    __syncthreads();
    const int total = s_win[nk][3];
    for (int base = 0; base < total; base += kChunk) {
      // test: the candidate's taps in the tile, a bit for each hit
      float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int cx0 = 0, cy0 = 0;
      if (t < kChunk && base + t < total) {
        int i = base + t, k = 0;
        while (i >= s_win[k + 1][3]) ++k;  // its crop
        i -= s_win[k][3];                    // its place in the crop's window
        i = (k0 + k) * npix + (s_win[k][1] + i / s_win[k][2]) * Wo +
            s_win[k][0] + i % s_win[k][2];
        float ix, iy;
        position(gi + 2 * (long long)i, H, W, ix, iy);
        // the forward's taps, clamped into the source, and their weights
        const float x0f = fminf(fmaxf(floorf(ix), 0.0f), (float)(W - 2));
        const float y0f = fminf(fmaxf(floorf(iy), 0.0f), (float)(H - 2));
        cx0 = (int)x0f - tx0, cy0 = (int)y0f - ty0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int dx = q & 1, dy = q >> 1;
          const int cx = cx0 + dx, cy = cy0 + dy;
          if ((unsigned)cx < (unsigned)kTileX &&
              (unsigned)cy < (unsigned)kTileY) {
            const float wx = fmaxf(0.0f, 1.0f - fabsf(ix - (x0f + (float)dx)));
            const float wy = fmaxf(0.0f, 1.0f - fabsf(iy - (y0f + (float)dy)));
            w[q] = tap_term_weight<V>(__fmul_rn(wy, wx));
            if (w[q] != 0.0f)
              atomicOr(&s_mask[cy * kTileX + cx][t >> 5], 1u << (t & 31));
          }
        }
        s_row[t] = i;
#pragma unroll
        for (int q = 0; q < 4; ++q) s_w[t][q] = w[q];
        if (w[0] != 0.0f || w[1] != 0.0f || w[2] != 0.0f ||
            w[3] != 0.0f) {  // a hit: its g row, for the walk
          const int v = (int)blockIdx.y * G * VPL;
          const char* row =
              reinterpret_cast<const char*>(gb + (long long)i * nvec + v);
          const int bytes = min(nvec - v, G * VPL) * (int)sizeof(T);
          for (int o = 0; o < bytes; o += 128) prefetch_l1(row + o);
        }
      }
      __syncthreads();
      // place: each hit at its rank among its cell's hits of the chunk
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (w[q] == 0.0f) continue;
        const int c = (cy0 + (q >> 1)) * kTileX + cx0 + (q & 1);
        int rank = __popc(s_mask[c][t >> 5] & ((1u << (t & 31)) - 1u));
        for (int j = 0; j < (t >> 5); ++j) rank += __popc(s_mask[c][j]);
        s_list[c][rank] = (unsigned short)(t << 2 | q);
      }
      for (int c = t; c < kCells; c += kThreads) {
        int cnt = 0;
        for (int j = 0; j < kWords; ++j) cnt += __popc(s_mask[c][j]);
        s_cnt[c] = cnt;
      }
      __syncthreads();
      for (int j = t; j < kCells * kWords; j += kThreads)
        (&s_mask[0][0])[j] = 0u;  // for the next chunk: read no more
      // walk: each worker its cell's hits, in order, kF at a time
      const int cnt = s_cnt[cell];
      for (int h = 0; h < cnt; h += kF) {
        T a[kF][VPL];
        float wh[kF];
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          if (h + f >= cnt) break;
          const int e = s_list[cell][h + f];
          wh[f] = s_w[e >> 2][e & 3];
          const T* row = gb + (long long)s_row[e >> 2] * nvec;
#pragma unroll
          for (int q = 0; q < VPL; ++q)
            if (v0 + G * q < nvec) a[f][q] = __ldg(row + v0 + G * q);
        }
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          if (h + f >= cnt) break;
#pragma unroll
          for (int q = 0; q < VPL; ++q)
            if (v0 + G * q < nvec) axpy<V>(acc[q], a[f][q], wh[f]);
        }
      }
      __syncthreads();  // the chunk's candidates and lists are read
    }
    __syncthreads();  // the windows are read
  }
  const int x = tx0 + cell % kTileX, y = ty0 + cell / kTileX;
  if (x >= W || y >= H) return;
  T* out = d_src + ((b * H + y) * W + x) * nvec;
#pragma unroll
  for (int q = 0; q < VPL; ++q)
    if (v0 + G * q < nvec) __stcs(out + v0 + G * q, V::pack(acc[q]));
}

template <typename V, int VPL, int G>
void launch_tiles(const void* g, const void* grid, const float* map,
                  void* d_src, int B, int H, int W, int K, int Ho, int Wo,
                  int nvec, cudaStream_t st) {
  using T = typename V::Raw;
  const long long tiles = (long long)B * ((H + kTileY - 1) / kTileY) *
                          ((W + kTileX - 1) / kTileX);
  const int slices = (nvec + G * VPL - 1) / (G * VPL);
  crop_tile_kernel<V, VPL, G>
      <<<dim3((unsigned)tiles, (unsigned)slices),
         TileShape<G>::kThreads, 0, st>>>(
          static_cast<const T*>(g), static_cast<const float*>(grid), map,
          static_cast<T*>(d_src), H, W, K, Ho, Wo, nvec);
}

// lanes a worker (G) and vectors a lane (VPL), by the vectors of a row:
// 16 x 3 for 48 (384 bf16 channels), 32 x 3 for 96 (384 f32); past 128
// the channels take more slices (blockIdx.y)
template <typename V>
void gather(const void* g, const void* grid, const float* map, void* d_src,
            int B, int H, int W, int K, int Ho, int Wo, int nvec,
            cudaStream_t st) {
#define CROP_BWD_TILES(VPL, G)                                               \
  launch_tiles<V, VPL, G>(g, grid, map, d_src, B, H, W, K, Ho, Wo, nvec, st)
  if (nvec > 96) CROP_BWD_TILES(4, 32);
  else if (nvec > 64) CROP_BWD_TILES(3, 32);
  else if (nvec > 48) CROP_BWD_TILES(4, 16);
  else if (nvec > 32) CROP_BWD_TILES(3, 16);
  else if (nvec > 16) CROP_BWD_TILES(4, 8);
  else if (nvec > 8) CROP_BWD_TILES(2, 8);
  else CROP_BWD_TILES(1, 8);
#undef CROP_BWD_TILES
}

// both passes; V is the 16-byte vector of the element type, S its single
// element, taken when `vec` is 1
template <typename V, typename S>
int crop_bwd(const void* g, const void* grid, void* d_src, void* map, int B,
             int H, int W, int C, int K, int Ho, int Wo, int vec,
             void* stream) {
  if (B == 0 || C == 0) return 0;
  if (H < 2 || W < 2 || B < 0 || K < 0 || Ho < 0 || Wo < 0 ||
      (long long)K * Ho * Wo > INT_MAX ||
      (vec != 1 && (vec != V::kN || C % V::kN)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(map);
  // a crop of no pixel reaches nothing: the gather sees no crop
  const int crops = Ho > 0 && Wo > 0 ? K : 0;
  if (crops > 0)
    crop_map_kernel<<<B * crops, kMapThreads, 0, st>>>(
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
