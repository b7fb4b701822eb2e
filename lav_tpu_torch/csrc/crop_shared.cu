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
// 39 MB source, so the write dominates; at the BEV trainer's (64 sources
// of 320x320x9 f32, 5 crops of 192x192) the output is 424 MB, the grid
// 94 MB and the sources 236 MB.
//
// The plain forms (crop_shared_{f32,bf16}) run crop_tiled.  The first
// design (crop_shared_kernel, which the int8 forms' scalar path keeps)
// gave each output vector of 16 bytes, or each channel where C is no
// multiple of the vector, a thread that read the pixel's grid point and
// computed its weights again, over 32 pixels of one output row a block:
// at C = 9 a block of 9 x 28 threads whose second pass over its pixels
// ran 4 of its 28 rows.  crop_tiled:
//  * one block makes a tile of output pixels; its setup gives each pixel
//    one thread, which reads the grid point once (a float2) and computes
//    the weights, the tap and the output offset into shared memory once
//    for all the channels;
//  * then the block's threads walk the tile's pieces in output order,
//    pixel by pixel and piece by piece within a pixel, consecutive threads
//    on consecutive pieces: 16 bytes of channels a piece on the vector
//    route (C a multiple of 16 bytes, source and output 16-byte aligned),
//    one channel on the narrow route (any C, any alignment), so a warp's
//    taps and stores are contiguous runs at any C.
// Sizes, each measured in turns against its alternatives on the card
// (`utils/turns.py crop --diagnose --variants`, PERF.md): tiles 32 pixels
// wide (16-pixel-wide ones were 20% slower at the BEV's shapes, 11% in
// bf16 at the agent's), 8 rows on the narrow route (4 rows were 17%
// slower at the BEV's) and one on the vector route (8 rows were 33%
// slower in f32, 17% in bf16), and 4 blocks an SM (8 were within 4%
// either way).  A thread has one piece's taps in flight: builds that
// loaded two or four pieces' taps before summing any were 20-40% slower.
// Staging the narrow tile in shared memory and storing it a row a warp
// in 16-byte pieces, each row at the alignment its run has in the
// output, was 11% slower at the BEV's shapes (a warp's 4-byte stores
// already write whole lines), and was taken out.  Computing the setup
// again for each piece, as the first design did, was 2.1x slower there.
// Weights, FMA chain and rounding are crop_shared_kernel's, the chain
// spelt out in intrinsics as nvcc contracted it there, so the output is
// that kernel's bit for bit (checked on the card, `utils/turns.py crop`).
//
// q8 entries (crop_shared_q8_{f32,bf16}): the TPU kernel's q8=True
// epilogue (warp_pallas.py:164-168).  The f32 sum above is not cast to the
// source dtype but quantized in registers: q = clip(rint(acc * inv_s),
// -127, 127) as int8, with inv_s = 1/x_scale an f32 read from device
// memory (so a calibrated scale needs no host sync).  rintf rounds half to
// even, as jnp.round and torch.round do.  Bound: bytes again; the int8
// output (57 MB for 16 crops of 96x96x384 per ego) is half the bf16 one,
// so the crop write halves.
//
// q8 space-to-depth entries (crop_shared_q8_s2d_{f32,bf16}): the TPU
// kernel's s2d=True emit (warp_pallas.py:171-219), the input form of the
// int8 crop ResNet's 4x4 stride-1 conv1 (lav_tpu nn/quant.py
// conv2d_int8_s2d).  The sums and the rounding are crop_shared_q8's; only
// the store moves: crop pixel (y, x), channel c goes to
// out[b, k, y/2, x/2, ((y%2)*2 + x%2)*C + c], the (dy, dx, c) channel
// order of warp_pallas.py:250-253.  Ho and Wo must be even.
//
// The int8 forms over 16-byte source vectors run their own kernel,
// crop_q8_tiled; their scalar path keeps crop_shared_kernel.  Measured on
// the card at the production shapes,
// crop_shared_kernel's int8 forms were bound by their instructions, not
// by their bytes (PERF.md): without their stores they ran 4% faster,
// reading one tap instead of four 19% faster, with every tap from one
// fixed address 26%.  Each thread made 8 output bytes of a pixel, so the
// pixel's grid read and weights (and for s2d the store's row division)
// were repeated by each of its 48 threads, and rintf and the cast to
// int8 are conversions, 16 a clock on an SM.  crop_q8_tiled:
//  * one block makes a kTile x kTile tile of output pixels.  Its setup
//    gives each pixel one thread, which computes the weights, the tap
//    origin and the output offset into shared memory once for all the
//    channels;
//  * then 8 threads a pixel (kPieces), each a 16-byte source piece of
//    every tap and an int8 store of the piece, chunk by chunk of 8 pieces,
//    kVisit chunks a visit, so that the block's warps read a few chunks
//    of the tile's source window at a time and reuse its lines from L1.
//    The tile is 2-D, so vertical neighbours share taps there too;
//  * the quantization clamps first and rounds by adding 1.5 * 2^23
//    (q8_bits), with no conversion instruction, and bf16 widens by one
//    bit operation (widen);
//  * 4 blocks of 256 threads an SM (64 registers a thread) hide the
//    latency of the taps that miss L1.
// Staging the tile's source window through shared memory with cp.async
// (the window per source row, 1.1 source pixels an output pixel) was
// measured too and gained nothing: it held two blocks an SM and spent
// instructions on the copies (PERF.md).  Weights, FMA chain and rounding
// are crop_shared_kernel's, written the same way, so the int8 output is
// that kernel's exactly (checked on the card).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <climits>
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

// OutT is T for the plain crop and int8_t for the q8 epilogue; S2D stores
// the q8 crop space-to-depth.
template <typename T, int V, typename OutT, bool S2D>
__global__ void crop_shared_kernel(const T* __restrict__ src,
                                   const float* __restrict__ grid,
                                   OutT* __restrict__ out,
                                   const float* __restrict__ inv_s, int H,
                                   int W, int C, int K, int npix, int Wo) {
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
    if constexpr (S2D) {
      const int y = p / Wo, x = p - y * Wo;
      op = o + ((size_t)(y >> 1) * (Wo >> 1) + (x >> 1)) * 4 * C +
           ((y & 1) * 2 + (x & 1)) * C;
    }
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

template <typename T, int V, typename OutT, bool S2D>
int launch(const void* src, const void* grid, void* out, const void* inv_s,
           int B, int H, int W, int C, int K, int Ho, int Wo,
           cudaStream_t stream) {
  const int npix = Ho * Wo;
  const int nvec = C / V;
  dim3 block(nvec < 256 ? nvec : 256, 1, 1);
  block.y = 256 / block.x > kPixPerBlock ? kPixPerBlock : 256 / block.x;
  if (block.y < 1) block.y = 1;
  dim3 grid_dim((npix + kPixPerBlock - 1) / kPixPerBlock, K, B);
  crop_shared_kernel<T, V, OutT, S2D><<<grid_dim, block, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const float*>(grid),
      static_cast<OutT*>(out), static_cast<const float*>(inv_s), H, W, C, K,
      npix, Wo);
  return (int)cudaGetLastError();
}

// ---- crop_q8_tiled: the int8 forms over 16-byte source vectors ----

constexpr int kTile = 16;      // output tile, kTile x kTile pixels
constexpr int kQThreads = 256;
constexpr int kPieces = 8;     // threads a pixel, a 16-byte piece each
constexpr int kSlots = kQThreads / kPieces;   // pixels a pass
constexpr int kTilePix = kTile * kTile;
constexpr int kPix = kTilePix / kSlots;       // pixels a thread
constexpr int kQBlocks = 4;    // blocks an SM (64 registers a thread)
constexpr int kVisit = 2;      // chunks a pixel's visit makes
static_assert(kSlots * kPix == kTilePix, "whole pixels a thread");
static_assert(kQThreads == kTilePix, "a thread a pixel in the setup");

// quantize(acc, inv) as the low byte of the result: clamping first keeps
// the value within +-127, where adding 1.5 * 2^23 rounds it to an
// integer half to even (the f32 spacing there is 1) and leaves it, two's
// complement, in the low mantissa bits.  A NaN clamps to -127 in both.
__device__ __forceinline__ uint32_t q8_bits(float acc, float inv) {
  const float y = fminf(fmaxf(__fmul_rn(acc, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(y, 12582912.0f));
}

// a piece's values as f32: bf16 is the high half of an f32, so one bit
// operation each (__bfloat162float's shift went through a byte permute
// and a multiply for the odd elements)
__device__ __forceinline__ void widen(const Vec<float, 4>& v, float (&f)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = v.v[i];
}
__device__ __forceinline__ void widen(const Vec<__nv_bfloat16, 8>& v,
                                      float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(&v);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the V int8 values of one piece: the f32 sums written as
// crop_shared_kernel writes them (the compiler contracts them to FMAs the
// same way), quantized, packed 4 a word.  The taps come by value: one
// 16-byte load each
template <typename T, int V>
__device__ __forceinline__ void q8_piece(const Vec<T, V> a,
                                         const Vec<T, V> b,
                                         const Vec<T, V> c,
                                         const Vec<T, V> d,
                                         const float (&w)[4], float inv,
                                         int8_t* dst) {
  float fa[V], fb[V], fc[V], fd[V];
  widen(a, fa);
  widen(b, fb);
  widen(c, fc);
  widen(d, fd);
  uint32_t q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float acc = w[0] * fa[i];
    acc += w[1] * fb[i];
    acc += w[2] * fc[i];
    acc += w[3] * fd[i];
    q[i] = q8_bits(acc, inv);
  }
  uint32_t word[V / 4];
#pragma unroll
  for (int i = 0; i < V; i += 4)
    word[i / 4] = __byte_perm(__byte_perm(q[i], q[i + 1], 0x0040),
                              __byte_perm(q[i + 2], q[i + 3], 0x0040),
                              0x5410);
  if constexpr (V == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(word[0], word[1]);
  else
    *reinterpret_cast<uint32_t*>(dst) = word[0];
}

template <typename T, bool S2D>
__global__ void __launch_bounds__(kQThreads, kQBlocks)
    crop_q8_tiled(const T* __restrict__ src, const float* __restrict__ grid,
                  int8_t* __restrict__ out, const float* __restrict__ inv_s,
                  int H, int W, int C, int K, int Ho, int Wo, int tiles_x) {
  constexpr int V = 16 / sizeof(T);  // channels of a piece
  constexpr int CC = kPieces * V;    // channels of a chunk
  __shared__ float4 pw[kTilePix];    // each pixel's weights
  // each pixel's top-left tap (a source element) and output offset (< 0:
  // past the crop's last row or column)
  __shared__ int2 pq[kTilePix];

  const float inv = *inv_s;
  const int tid = threadIdx.x, part = tid % kPieces, slot = tid / kPieces;
  const int tyi = blockIdx.x / tiles_x;
  const int ty0 = tyi * kTile, tx0 = (blockIdx.x - tyi * tiles_x) * kTile;
  const T* s = src + (size_t)blockIdx.z * H * W * C;
  const size_t crop = (size_t)blockIdx.z * K + blockIdx.y;
  const float* g = grid + crop * Ho * Wo * 2;
  int8_t* o = out + crop * Ho * Wo * C;

  {  // thread tid: pixel tid of the tile
    const int y = ty0 + tid / kTile, x = tx0 + tid % kTile;
    float4 wv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int2 q = make_int2(0, -1);
    if (y < Ho && x < Wo) {
      const int p = y * Wo + x;
      const float ix = (g[2 * p] + 1.0f) * 0.5f * (float)(W - 1);
      const float iy = (g[2 * p + 1] + 1.0f) * 0.5f * (float)(H - 1);
      const float x0f = fminf(fmaxf(floorf(ix), 0.0f), (float)(W - 2));
      const float y0f = fminf(fmaxf(floorf(iy), 0.0f), (float)(H - 2));
      const float wy0 = fmaxf(0.0f, 1.0f - fabsf(iy - y0f));
      const float wy1 = fmaxf(0.0f, 1.0f - fabsf(iy - (y0f + 1.0f)));
      const float wx0 = fmaxf(0.0f, 1.0f - fabsf(ix - x0f));
      const float wx1 = fmaxf(0.0f, 1.0f - fabsf(ix - (x0f + 1.0f)));
      wv = make_float4(to_f(from_f<T>(__fmul_rn(wy0, wx0))),
                       to_f(from_f<T>(__fmul_rn(wy0, wx1))),
                       to_f(from_f<T>(__fmul_rn(wy1, wx0))),
                       to_f(from_f<T>(__fmul_rn(wy1, wx1))));
      q.x = ((int)y0f * W + (int)x0f) * C;
      q.y = S2D ? ((y >> 1) * (Wo >> 1) + (x >> 1)) * 4 * C +
                      ((y & 1) * 2 + (x & 1)) * C
                : p * C;
    }
    pw[tid] = wv;
    pq[tid] = q;
  }
  __syncthreads();

  // kVisit chunks at a time, so that the block's warps read a few chunks
  // of the tile's source window at a time and its lines are reused from
  // L1; a pixel's weights and addresses serve its kVisit pieces
  const int nch = (C + CC - 1) / CC;
  const int right = C / V, below = W * C / V;  // in pieces
  for (int ch = 0; ch < nch; ch += kVisit) {
    const int c = ch * CC + part * V;
    if (c >= C) continue;
    const T* sc = s + c;
    int8_t* oc = o + c;
#pragma unroll 2
    for (int i = 0; i < kPix; ++i) {
      const int pix = slot + kSlots * i;
      const int2 q = pq[pix];
      if (q.y < 0) continue;
      const float4 wv = pw[pix];
      const float w[4] = {wv.x, wv.y, wv.z, wv.w};
      const auto* t = reinterpret_cast<const Vec<T, V>*>(sc + q.x);
#pragma unroll
      for (int v = 0; v < kVisit; ++v) {
        if (c + v * CC >= C) break;
        const int k = v * kPieces;
        q8_piece<T, V>(t[k], t[k + right], t[k + below],
                       t[k + below + right], w, inv, oc + q.y + v * CC);
      }
    }
  }
}

template <typename T, bool S2D>
int launch_q8(const void* src, const void* grid, void* out,
              const void* inv_s, int B, int H, int W, int C, int K, int Ho,
              int Wo, cudaStream_t stream) {
  // offsets within a source and within a crop are ints
  if ((long long)H * W * C > INT_MAX || (long long)Ho * Wo * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (Wo + kTile - 1) / kTile;
  const int tiles_y = (Ho + kTile - 1) / kTile;
  dim3 grid_dim(tiles_x * tiles_y, K, B);
  crop_q8_tiled<T, S2D><<<grid_dim, kQThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const float*>(grid),
      static_cast<int8_t*>(out), static_cast<const float*>(inv_s), H, W, C,
      K, Ho, Wo, tiles_x);
  return (int)cudaGetLastError();
}

// ---- crop_tiled: the plain forms (f32, bf16) ----

// a block's threads and the blocks an SM; its tile, kTileX pixels wide,
// is kNarrowTy rows on the narrow route (a channel a piece) and one row
// on the vector route (16 bytes a piece); PERF.md has the measured
// alternatives
constexpr int kPlainThreads = 256, kPlainBlocks = 4;
constexpr int kTileX = 32, kNarrowTy = 8;

// pixel p's weights (rounded to T) and top-left tap (a source element),
// written as crop_shared_kernel computes them; g8: the grid is 8-byte
// aligned, so the point is one float2 load
template <typename T>
__device__ __forceinline__ void pixel_setup(const float* g, bool g8, int p,
                                            int H, int W, int C, float4& wv,
                                            int& tap) {
  float gx, gy;
  if (g8) {
    const float2 v = reinterpret_cast<const float2*>(g)[p];
    gx = v.x, gy = v.y;
  } else {
    gx = g[2 * p], gy = g[2 * p + 1];
  }
  const float ix = (gx + 1.0f) * 0.5f * (float)(W - 1);
  const float iy = (gy + 1.0f) * 0.5f * (float)(H - 1);
  const float x0f = fminf(fmaxf(floorf(ix), 0.0f), (float)(W - 2));
  const float y0f = fminf(fmaxf(floorf(iy), 0.0f), (float)(H - 2));
  const float wy0 = fmaxf(0.0f, 1.0f - fabsf(iy - y0f));
  const float wy1 = fmaxf(0.0f, 1.0f - fabsf(iy - (y0f + 1.0f)));
  const float wx0 = fmaxf(0.0f, 1.0f - fabsf(ix - x0f));
  const float wx1 = fmaxf(0.0f, 1.0f - fabsf(ix - (x0f + 1.0f)));
  wv = make_float4(to_f(from_f<T>(__fmul_rn(wy0, wx0))),
                   to_f(from_f<T>(__fmul_rn(wy0, wx1))),
                   to_f(from_f<T>(__fmul_rn(wy1, wx0))),
                   to_f(from_f<T>(__fmul_rn(wy1, wx1))));
  tap = ((int)y0f * W + (int)x0f) * C;
}

// the V outputs of one piece: crop_shared_kernel's sums as nvcc
// contracted them there (w00 a fused onto the rounded w01 b, then w10 c
// and w11 d fused in turn; the other two orders of rounding differ in the
// last bit, measured on the card), spelt out so that no build contracts
// them otherwise
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> plain_piece(const Vec<T, V> a,
                                                 const Vec<T, V> b,
                                                 const Vec<T, V> c,
                                                 const Vec<T, V> d,
                                                 const float4 w) {
  Vec<T, V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float acc = __fmaf_rn(w.x, to_f(a.v[i]), __fmul_rn(w.y, to_f(b.v[i])));
    acc = __fmaf_rn(w.z, to_f(c.v[i]), acc);
    acc = __fmaf_rn(w.w, to_f(d.v[i]), acc);
    r.v[i] = from_f<T>(acc);
  }
  return r;
}

// One block makes a TX x TY tile of output pixels of one crop.  The
// setup gives each pixel one thread, which computes its weights, tap and
// output offset into shared memory once for all its channels.  Then the
// block's threads walk the tile's pieces in output order, pixel by pixel
// and within a pixel piece by piece: V = 16 bytes of channels on the
// vector route (C a multiple of V, 16-byte aligned source and output),
// V = 1 on the narrow route (any C, any alignment).  Consecutive threads
// take consecutive pieces, so a warp's taps and stores are contiguous
// runs.
template <typename T, int V>
__global__ void __launch_bounds__(kPlainThreads, kPlainBlocks)
    crop_tiled(const T* __restrict__ src, const float* __restrict__ grid,
               T* __restrict__ out, int H, int W, int C, int K, int Ho,
               int Wo, int tiles_x) {
  constexpr int TX = kTileX, TY = V == 1 ? kNarrowTy : 1, PIX = TX * TY;
  static_assert(PIX <= kPlainThreads, "a thread a pixel in the setup");
  __shared__ float4 pw[PIX];  // each pixel's weights
  // each pixel's top-left tap and output offset (< 0: past the crop)
  __shared__ int2 pq[PIX];

  const int tid = threadIdx.x;
  const int tyi = blockIdx.x / tiles_x;
  const int ty0 = tyi * TY, tx0 = (blockIdx.x - tyi * tiles_x) * TX;
  const T* s = src + (size_t)blockIdx.z * H * W * C;
  const size_t crop = (size_t)blockIdx.z * K + blockIdx.y;
  const float* g = grid + crop * Ho * Wo * 2;
  T* o = out + crop * Ho * Wo * C;

  if (tid < PIX) {
    const int y = ty0 + tid / TX, x = tx0 + tid % TX;
    float4 wv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int2 q = make_int2(0, -1);
    if (y < Ho && x < Wo) {
      const bool g8 = (reinterpret_cast<uintptr_t>(grid) & 7) == 0;
      pixel_setup<T>(g, g8, y * Wo + x, H, W, C, wv, q.x);
      q.y = (y * Wo + x) * C;
    }
    pw[tid] = wv;
    pq[tid] = q;
  }
  __syncthreads();

  const int P = C / V;                // pieces a pixel
  const int right = P, below = W * P;  // the other taps, in pieces
  const int dpix = kPlainThreads / P, dpiece = kPlainThreads % P;
  int pix = tid / P, piece = tid - pix * P;
  for (; pix < PIX; pix += dpix) {
    const int2 q = pq[pix];
    if (q.y >= 0) {
      const auto* t = reinterpret_cast<const Vec<T, V>*>(s + q.x) + piece;
      reinterpret_cast<Vec<T, V>*>(o + q.y)[piece] = plain_piece<T, V>(
          t[0], t[right], t[below], t[below + right], pw[pix]);
    }
    piece += dpiece;
    if (piece >= P) piece -= P, ++pix;
  }
}

template <typename T, int V>
int launch_tiled(const void* src, const void* grid, void* out, int B, int H,
                 int W, int C, int K, int Ho, int Wo, cudaStream_t stream) {
  constexpr int TY = V == 1 ? kNarrowTy : 1;
  const int tiles_x = (Wo + kTileX - 1) / kTileX;
  const int tiles_y = (Ho + TY - 1) / TY;
  crop_tiled<T, V><<<dim3(tiles_x * tiles_y, K, B), kPlainThreads, 0,
                     stream>>>(static_cast<const T*>(src),
                               static_cast<const float*>(grid),
                               static_cast<T*>(out), H, W, C, K, Ho, Wo,
                               tiles_x);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_plain(const void* src, const void* grid, void* out, int B, int H,
                 int W, int C, int K, int Ho, int Wo, int vec,
                 cudaStream_t stream) {
  // offsets within a source and within a crop are ints
  if ((long long)H * W * C > INT_MAX || (long long)Ho * Wo * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  constexpr int VMAX = 16 / sizeof(T);
  const bool vector =
      vec == VMAX && C % VMAX == 0 &&
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  return vector ? launch_tiled<T, VMAX>(src, grid, out, B, H, W, C, K, Ho,
                                        Wo, stream)
                : launch_tiled<T, 1>(src, grid, out, B, H, W, C, K, Ho, Wo,
                                     stream);
}

template <typename T, typename OutT, bool S2D = false>
int dispatch(const void* src, const void* grid, void* out, const void* inv_s,
             int B, int H, int W, int C, int K, int Ho, int Wo, int vec,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || K == 0 || Ho * Wo == 0 || C == 0) return 0;
  if (S2D && (Ho % 2 || Wo % 2)) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<OutT, T>::value) {
    return launch_plain<T>(src, grid, out, B, H, W, C, K, Ho, Wo, vec, st);
  } else {
    if (vec == 16 / (int)sizeof(T))
      return launch_q8<T, S2D>(src, grid, out, inv_s, B, H, W, C, K, Ho, Wo,
                               st);
    return launch<T, 1, OutT, S2D>(src, grid, out, inv_s, B, H, W, C, K, Ho,
                                   Wo, st);
  }
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

extern "C" int crop_shared_q8_s2d_f32(const void* src, const void* grid,
                                      void* out, const void* inv_s, int B,
                                      int H, int W, int C, int K, int Ho,
                                      int Wo, int vec, void* stream) {
  return dispatch<float, int8_t, true>(src, grid, out, inv_s, B, H, W, C, K,
                                       Ho, Wo, vec, stream);
}

extern "C" int crop_shared_q8_s2d_bf16(const void* src, const void* grid,
                                       void* out, const void* inv_s, int B,
                                       int H, int W, int C, int K, int Ho,
                                       int Wo, int vec, void* stream) {
  return dispatch<__nv_bfloat16, int8_t, true>(src, grid, out, inv_s, B, H,
                                               W, C, K, Ho, Wo, vec, stream);
}
