// conv2d_int8: int8 x int8 -> int32 convolution, dequantized in the
// epilogue.  NHWC activations, OHWI weights (each output channel's
// (ky, kx, c) run contiguous), any stride, kernel dilation, padding and
// input (lhs) dilation, all given as a phase plan (below).
//
// Replaces lav_tpu/nn/quant.py::conv2d_int8 (quant.py:246-273), which the
// TPU ran as XLA's s8 convolution on the MXU (preferred_element_type
// int32) rather than as a Pallas kernel, and its two other s8 forms:
// conv2d_int8_s2d (quant.py:219-243, the planner's conv1 as a 4x4
// stride-1 conv over space-to-depth crops, padding ((2,1),(2,1))) and
// conv_transpose2d_int8 (quant.py:149-166, a transposed conv as the
// equivalent conv over the input dilated by the stride, with the flipped
// kernel and padding (k-1-p, k-1-p+output_padding)).  PyTorch has no int8
// convolution on CUDA, and im2col + an int8 matmul would materialise
// ~11 GB for the planner's conv1 at 16 egos, so it is a kernel here.
//
// The phase plan (nn/quant.py conv_plan).  Along each axis the conv over
// the input dilated by l with stride s splits into P = l / gcd(s, l)
// output phases: phase r holds outputs o = r + P*j, and it is an ordinary
// conv of the undilated input with stride s / gcd(s, l) over the taps t
// whose dilated position r*s - pad + t*d lands on a real pixel, tap t
// reading input row j*s' + off[r][t].  A direct conv is one phase with
// every tap (off = t*d - pad); a stride-s transposed conv is s phases per
// axis of about k/s taps each, so no zero of the dilated input is walked.
// Phase (ry, rx) is blockIdx.z: one launch per conv.  The weight is read
// in place, each tap (ky, kx) taken from the plan, so no derived weight
// is kept.  Limits: C a multiple of 16 (the wrapper pads other C with
// zero channels), at most kMaxP = 16 phases per axis (l / gcd(s, l)) and
// kMaxT = 16 taps per phase and axis (a direct conv of kernel size up to
// 16, a transposed conv of up to about 16 taps per stride); the wrapper
// raises on a larger conv, the launch returns cudaErrorInvalidValue.
//
// Epilogue, bit for bit the plain version's: y = float(acc) * (s_x *
// w_scale[o]), the product s_x * w_scale[o] rounded first, then + b[o],
// each step rounded on its own (__fmul_rn / __fadd_rn, so no FMA
// contraction), then cast to bf16 (round to nearest even) or kept f32.
// s_x lives in device memory (a calibrated or a dynamic per-tensor
// scale), so the launch needs no host sync.  The int32 sum is exact in
// any order, so the output is bit-identical to the plain version's.
//
// Bound: operations for the path's large convs (planner conv1 at 16
// egos: 1.42e12 int8 ops against 0.9 GB of input read once; the card's
// dense int8 rate, 1979 TOPS, comes only through wgmma).  Design: an
// implicit GEMM, M = a phase's output pixels, N = output channels, K =
// the phase's taps x C, in steps of BK = 128 bytes.  Two warpgroups (256
// threads) own a BM x BN output tile (Tile, chosen per conv by nn/quant.py
// conv_tiles) and issue wgmma.mma_async m64nBNk32 s32.s8.s8, both operands
// K-major in shared memory.  The tiles sit in a ring of kStages stages,
// each row 128 bytes in the 128-byte swizzle (16-byte chunk j of row r at
// chunk j ^ (r & 7), 8-row groups 1024 bytes apart: the descriptor's
// SBO).  Every thread gathers 16-byte chunks with cp.async, zero-filled
// (src-size 0) where a tap falls in the padding or past K, M or O; a chunk
// finds its own tap, so C need only be a multiple of 16.  Loads run
// kStages - 2 steps ahead and are issued after the step's wgmma, so the
// tensor cores always hold one step while the addresses of the next are
// computed; one wgmma group stays in flight across the barrier.  The
// activations bypass L1 (cp.async.cg): with the ring in shared memory L1
// is too small to keep a step's lines for the next tap, and allocating
// them there cost ~15% (PERF.md).  No TMA: the im2col gather needs a zero
// fill per chunk, and the weights' share of a step is BN/32 copies a
// thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBK = 128;       // bytes of K per step: one swizzled row
constexpr int kMaxP = 16;      // phases per axis
constexpr int kMaxT = 16;      // taps per phase and axis

// one axis of the phase plan
struct Axis {
  int n_out[kMaxP];       // outputs of phase r
  int ntaps[kMaxP];       // its taps
  // each tap's input offset * 65536 + its kernel index (0 <= k < 65536,
  // |offset| < 32768)
  int tap[kMaxP][kMaxT];
};
__device__ __forceinline__ int tap_k(int t) { return t & 0xffff; }
__device__ __forceinline__ int tap_off(int t) { return t >> 16; }

// N, H, W, C, O, KH, KW, OH, OW, phases (ph, pw), phase strides (sh, sw),
// tile (bm, bn), then the y and x axes: 591 ints (nn/quant.py
// _plan_ints), 2364 bytes, passed by value well inside the 4 KB of a
// kernel's parameters
struct Plan {
  int N, H, W, C, O, KH, KW, OH, OW, ph, pw, sh, sw, bm, bn;
  Axis y, x;
};
static_assert(sizeof(Plan) == 591 * sizeof(int), "plan layout");

// the tiles, BM x BN outputs with a ring of Stages<BM, BN>::k stages;
// nn/quant.py TILES lists the same (BM, BN) -> stages, and conv_tiles
// picks one per conv.  256 x 64 (5 stages, 201 KB) for the long K of the
// O = 64 convs; 128 x 64 (4 stages, 97 KB: two blocks an SM, each hiding
// the other's prologue and epilogue) for their shorter K and for small
// grids; 128 x 128 (6 stages, 193 KB) for O > 64
template <int BM, int BN> struct Stages;
template <> struct Stages<256, 64> { static constexpr int k = 5; };
template <> struct Stages<128, 128> { static constexpr int k = 6; };
template <> struct Stages<128, 64> { static constexpr int k = 4; };

template <int BM, int BN>
struct Tile {
  static constexpr int kStageBytes = (BM + BN) * kBK;
  static constexpr int kStages = Stages<BM, BN>::k;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + align
  static constexpr int kMW = BM / 128;  // m64 tiles per warpgroup
  static constexpr int kArows = BM / 32, kBrows = BN / 32;  // per thread
  // BM = 128 tiles keep to 128 registers, so that two blocks share an SM
  // (128 x 128 when a short K shrinks its ring)
  static constexpr int kBlocks = BM == 128 ? 2 : 1;
};

// stages of the ring a launch touches: a K of at most kStages - 2 steps
// is all loaded by the prologue, one stage a step.  The smaller ring lets
// two 128 x 128 blocks share an SM: upconv1 0.147 -> 0.115 ms, upconv3
// 0.143 -> 0.119, the 1x1 down convs 6-11% (H100, PERF.md)
template <int BM, int BN> int ring_stages(int ksteps_max) {
  using T = Tile<BM, BN>;
  return ksteps_max <= T::kStages - 2 ? (ksteps_max > 1 ? ksteps_max : 1)
                                      : T::kStages;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 only; bytes past `n` (0 or 16)
// are zero-filled
__device__ __forceinline__ void cp_async_cg(uint32_t dst, const void* src,
                                            int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// K-major operand in the 128-byte swizzle: start address, LBO 16 bytes
// (unused in this mode), SBO 1024 bytes (8 rows of 128), layout 1
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R> __device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

#define R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define R16(i) R4(i), R4(i + 4), R4(i + 8), R4(i + 12)

// d (64 x BN s32, the warpgroup's accumulator) += A (64 x 32 s8) * B^T
// (BN x 32 s8), both from shared memory
template <int BN> __device__ void wgmma(int (&d)[BN / 2], uint64_t a,
                                        uint64_t b);
template <>
__device__ __forceinline__ void wgmma<64>(int (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p;\n}\n"
      : R16(0), R16(16)
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<128>(int (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p;\n}\n"
      : R16(0), R16(16), R16(32), R16(48)
      : "l"(a), "l"(b), "r"(1));
}
#undef R16
#undef R4

template <int BM, int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, (Tile<BM, BN>::kBlocks))
    conv2d_int8_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ x_scale,
                       const float* __restrict__ bias,
                       OutT* __restrict__ out,
                       const __grid_constant__ Plan p) {
  using T = Tile<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int ry = blockIdx.z / p.pw, rx = blockIdx.z - ry * p.pw;
  // a phase's outputs fit an int (the launch checks), so the per-row
  // divisions below are 32-bit
  const int owz = p.x.n_out[rx];
  const int pix = p.y.n_out[ry] * owz;
  const int Mz = p.N * pix;
  const int m0 = blockIdx.x * BM;
  if (m0 >= Mz) return;  // a phase with fewer outputs than the largest
  const int n0 = blockIdx.y * BN;
  const int ntx = p.x.ntaps[rx];
  const int K = p.y.ntaps[ry] * ntx * p.C;  // bytes of a phase's row
  const int ksteps = (K + kBK - 1) / kBK;

  // the phase's taps (input row / column offsets, weight offsets) and
  // the tile's dequantization, s_x * w_scale[o] rounded, and bias
  __shared__ int s_dy[kMaxT], s_dx[kMaxT], s_wy[kMaxT], s_wx[kMaxT];
  __shared__ float s_sc[BN], s_b[BN];
  const int tid = threadIdx.x;
  if (tid < kMaxT) {
    const int vy = p.y.tap[ry][tid], vx = p.x.tap[rx][tid];
    s_dy[tid] = tap_off(vy);
    s_wy[tid] = tap_k(vy) * p.KW * p.C;
    s_dx[tid] = tap_off(vx);
    s_wx[tid] = tap_k(vx) * p.C;
  }
  if (tid < BN) {
    const int o = n0 + tid < p.O ? n0 + tid : p.O - 1;
    s_sc[tid] = __fmul_rn(*x_scale, w_scale[o]);
    s_b[tid] = bias != nullptr ? bias[o] : 0.0f;
  }

  // load slots: chunk column j of rows rb + 32 i of both tiles; abase[i]
  // points at row i's pixel (iy0, ix0), each step adds its tap's offset
  const int j = tid & 7, rb = tid >> 3;
  const uint32_t slot = rb * kBK + ((j ^ (rb & 7)) << 4);
  const int8_t* abase[T::kArows];
  int iy0[T::kArows], ix0[T::kArows];
#pragma unroll
  for (int i = 0; i < T::kArows; ++i) {
    const int m = m0 + rb + 32 * i;
    abase[i] = x;
    iy0[i] = ix0[i] = -(1 << 30);  // past M: never inside the image
    if (m < Mz) {
      const int img = m / pix;
      const int r = m - img * pix;
      const int jy = r / owz;
      iy0[i] = jy * p.sh;
      ix0[i] = (r - jy * owz) * p.sw;
      abase[i] =
          x + (((long long)img * p.H + iy0[i]) * p.W + ix0[i]) * p.C;
    }
  }
  const int8_t* brow[T::kBrows];
#pragma unroll
  for (int i = 0; i < T::kBrows; ++i) {
    const int n = n0 + rb + 32 * i;
    brow[i] = n < p.O ? w + (size_t)n * p.KH * p.KW * p.C : nullptr;
  }

  // K order.  Where C holds whole 128-byte chunks, step ks is (c-chunk,
  // ty, tx): one chunk's input lines serve every tap before the next
  // chunk's are read, so an SM's lines stay in L2.  Else chunk j of
  // step ks is byte ks * 128 + 16 j of the (ty, tx, c) row.  (ty, tx, c)
  // of this thread's chunk in the next step to load advance one step at
  // a time.
  const int nty = p.y.ntaps[ry];
  const bool chunked = p.C % kBK == 0;
  int ty = 0, tx = 0, c = j * 16;
  if (!chunked && ksteps > 0) {
    const int t = c / p.C;
    c -= t * p.C;
    ty = t / ntx;
    tx = t - ty * ntx;
  }
  auto advance = [&]() {
    if (chunked) {
      if (++tx == ntx) {
        tx = 0;
        if (++ty == nty) {
          ty = 0;
          c += kBK;
        }
      }
    } else {
      for (c += kBK; c >= p.C; c -= p.C) {
        if (++tx == ntx) {
          tx = 0;
          ++ty;
        }
      }
    }
  };
  auto load = [&](int stage) {
    const bool kin = ty < nty && c < p.C;
    int dy = 0, dx = 0, wofs = 0;
    if (kin) {
      dy = s_dy[ty];
      dx = s_dx[tx];
      wofs = s_wy[ty] + s_wx[tx] + c;
    }
    const int delta = (dy * p.W + dx) * p.C + c;
    const uint32_t a_s = sbase + stage * T::kStageBytes + slot;
#pragma unroll
    for (int i = 0; i < T::kArows; ++i) {
      const bool ok = kin && (unsigned)(iy0[i] + dy) < (unsigned)p.H &&
                      (unsigned)(ix0[i] + dx) < (unsigned)p.W;
      cp_async_cg(a_s + i * 32 * kBK, ok ? abase[i] + delta : x, ok ? 16 : 0);
    }
    const uint32_t b_s = a_s + BM * kBK;
#pragma unroll
    for (int i = 0; i < T::kBrows; ++i) {
      const bool ok = kin && brow[i] != nullptr;
      cp_async_cg(b_s + i * 32 * kBK, ok ? brow[i] + wofs : w, ok ? 16 : 0);
    }
    advance();
  };

  const int wg = tid >> 7;
  int acc[T::kMW][BN / 2];
#pragma unroll
  for (int q = 0; q < T::kMW; ++q) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[q][e] = 0;
    fence_regs(acc[q]);
  }

  __syncthreads();  // the tables
  constexpr int kAhead = T::kStages - 2;  // steps loaded ahead
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < ksteps) load(s);
    cp_async_commit();
  }
  int cur = 0, next = kAhead;  // the stages of steps ks and ks + kAhead
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<kAhead - 1>();  // this thread's chunks of step ks
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // every thread's chunks of step ks are in; every warpgroup has
    // retired step ks - 2's wgmma, whose stage this step's load refills
    __syncthreads();
    const uint32_t st = sbase + cur * T::kStageBytes;
    const uint64_t db = smem_desc(st + BM * kBK);
    const uint64_t da = smem_desc(st + wg * (BM / 2) * kBK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
#pragma unroll
      for (int q = 0; q < T::kMW; ++q)  // +32 bytes per kk, 8 KB per q
        wgmma<BN>(acc[q], da + q * 512 + kk * 2, db + kk * 2);
    }
    wgmma_commit();
    // the next loads are issued while this step's wgmma runs
    if (ks + kAhead < ksteps) load(next);
    cp_async_commit();
    cur = cur + 1 == T::kStages ? 0 : cur + 1;
    next = next + 1 == T::kStages ? 0 : next + 1;
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // epilogue: thread t of the warpgroup holds rows 16 (t / 32) + (t % 32)
  // / 4 (+ 8) and column pairs 8 n8 + 2 (t % 4) of each m64 tile
  const int t = tid & 127;
#pragma unroll
  for (int q = 0; q < T::kMW; ++q) {
    fence_regs(acc[q]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wg * (BM / 2) + q * 64 + (t >> 5) * 16 +
                    ((t & 31) >> 2) + 8 * h;
      if (m >= Mz) continue;
      const int img = m / pix;
      const int r = m - img * pix;
      const int jy = r / owz;
      const int oh = ry + p.ph * jy, ow = rx + p.pw * (r - jy * owz);
      OutT* orow = out + (((long long)img * p.OH + oh) * p.OW + ow) * p.O;
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8) {
        const int col = n0 + n8 * 8 + 2 * (t & 3);
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = n8 * 8 + 2 * (t & 3) + e;  // within the tile
          y[e] = __fmul_rn(__int2float_rn(acc[q][n8 * 4 + 2 * h + e]),
                           s_sc[o]);
          if (bias != nullptr) y[e] = __fadd_rn(y[e], s_b[o]);
        }
        if (col + 1 < p.O && (p.O & 1) == 0) {
          store2(orow + col, y[0], y[1]);
        } else {
          if (col < p.O) orow[col] = from_f<OutT>(y[0]);
          if (col + 1 < p.O) orow[col + 1] = from_f<OutT>(y[1]);
        }
      }
    }
  }
}

template <int BM, int BN, typename OutT>
int launch_tile(const void* x, const void* w, const void* w_scale,
                const void* x_scale, const void* bias, void* out,
                const Plan& p, dim3 grid, int ksteps_max,
                cudaStream_t stream) {
  using T = Tile<BM, BN>;
  auto kernel = conv2d_int8_kernel<BM, BN, OutT>;
  // the dynamic shared-memory limit, raised once per instance and device
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = (uint64_t)1 << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(bit);
  }
  const int nst = ring_stages<BM, BN>(ksteps_max);
  kernel<<<grid, kThreads, nst * T::kStageBytes + 1024, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(x_scale),
      static_cast<const float*>(bias), static_cast<OutT*>(out), p);
  return (int)cudaGetLastError();
}

bool axis_ok(const Axis& a, int n) {
  if (n < 1 || n > kMaxP) return false;
  for (int r = 0; r < n; ++r)
    if (a.ntaps[r] < 0 || a.ntaps[r] > kMaxT || a.n_out[r] < 0) return false;
  return true;
}

template <typename OutT>
int launch(const void* x, const void* w, const void* w_scale,
           const void* x_scale, const void* bias, void* out,
           const int* plan, void* stream) {
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  if (p.C % 16 || p.C < 16 || !axis_ok(p.y, p.ph) || !axis_ok(p.x, p.pw))
    return (int)cudaErrorInvalidValue;
  long long mtiles = 0;
  int ksteps_max = 0;
  for (int ry = 0; ry < p.ph; ++ry)
    for (int rx = 0; rx < p.pw; ++rx) {
      const long long m = (long long)p.N * p.y.n_out[ry] * p.x.n_out[rx];
      if (m > 0x7fffffffLL - 256) return (int)cudaErrorInvalidValue;
      const long long tiles = (m + p.bm - 1) / p.bm;
      if (tiles > mtiles) mtiles = tiles;
      const int ks = (p.y.ntaps[ry] * p.x.ntaps[rx] * p.C + kBK - 1) / kBK;
      if (ks > ksteps_max) ksteps_max = ks;
    }
  if (mtiles == 0 || p.O == 0) return 0;
  dim3 grid((unsigned)mtiles, (unsigned)((p.O + p.bn - 1) / p.bn),
            (unsigned)(p.ph * p.pw));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.bm == 256 && p.bn == 64)
    return launch_tile<256, 64, OutT>(x, w, w_scale, x_scale, bias, out, p,
                                      grid, ksteps_max, st);
  if (p.bm == 128 && p.bn == 128)
    return launch_tile<128, 128, OutT>(x, w, w_scale, x_scale, bias, out, p,
                                       grid, ksteps_max, st);
  if (p.bm == 128 && p.bn == 64)
    return launch_tile<128, 64, OutT>(x, w, w_scale, x_scale, bias, out, p,
                                      grid, ksteps_max, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// plan: the phase plan and tile of nn/quant.py _plan_ints (591 ints)
extern "C" int conv2d_int8_bf16(const void* x, const void* w,
                                const void* w_scale, const void* x_scale,
                                const void* bias, void* out, const int* plan,
                                void* stream) {
  return launch<__nv_bfloat16>(x, w, w_scale, x_scale, bias, out, plan,
                               stream);
}

extern "C" int conv2d_int8_f32(const void* x, const void* w,
                               const void* w_scale, const void* x_scale,
                               const void* bias, void* out, const int* plan,
                               void* stream) {
  return launch<float>(x, w, w_scale, x_scale, bias, out, plan, stream);
}
