// conv2d_int8: int8 x int8 -> int32 convolution, dequantized in the
// epilogue.  NHWC activations, OHWI weights (each output channel's
// (ky, kx, c) run contiguous), any stride, kernel dilation, padding (top
// and left given, the bottom and right ones implied by OH, OW) and input
// (lhs) dilation.
//
// Replaces lav_tpu/nn/quant.py::conv2d_int8 (quant.py:246-273), which the
// TPU ran as XLA's s8 convolution on the MXU (preferred_element_type
// int32) rather than as a Pallas kernel, and its two other s8 forms:
// conv2d_int8_s2d (quant.py:219-243, the planner's conv1 as a 4x4
// stride-1 conv over space-to-depth crops, padding ((2,1),(2,1))) and
// conv_transpose2d_int8 (quant.py:149-166, a transposed conv as the
// equivalent conv over the input dilated by the stride, with the flipped
// kernel and padding (k-1-p, k-1-p+output_padding)).
//
// Input dilation: tap (ky, kx) of output (oh, ow) reads the dilated image
// at u = oh*sh - pad_top + ky*dh (likewise v for columns); that holds
// input row u / lh when u % lh == 0 and 0 <= u / lh < H, and zero
// otherwise.  The kernel walks every tap of the dilated window, zeros
// included: for a stride-s transposed conv that is s*s times the useful
// MMA work (a later kernel can skip the zero taps).  PyTorch has no int8 convolution
// on CUDA, and im2col + an int8 matmul would materialise ~11 GB for the
// planner's conv1 at 16 egos, so it is a kernel here.
//
// Epilogue, bit for bit the plain version's: y = float(acc) * (s_x *
// w_scale[o]), the product s_x * w_scale[o] rounded first, then + b[o],
// each step rounded on its own (__fmul_rn / __fadd_rn, so no FMA
// contraction), then cast to bf16 (round to nearest even) or kept f32.
// s_x lives in device memory (a calibrated or a dynamic per-tensor
// scale), so the launch needs no host sync.  Since the int32 sum is exact,
// the output is bit-identical to the plain version's.
//
// Bound: operations for the path's large convs (planner conv1 at 16
// egos: 1.42e12 int8 ops against 0.9 GB of input read once; the card's
// dense int8 rate is 1979 TOPS).  Design: an implicit GEMM, M = output
// pixels, N = output channels, K = KH*KW*C walked in steps of 32 bytes
// (C % 32 == 0, so a step never crosses a tap).  A block of 4 warps owns
// a 64x64 output tile; each step it stages a 64x32 activation tile (the
// im2col rows, gathered with 16-byte loads, zeros where the tap falls in
// the padding) and a 64x32 weight tile in shared memory with a 48-byte
// row stride (conflict-free fragment loads), prefetches the next step's
// tiles into registers, and each warp issues 8 mma.sync m16n8k32 s8 per
// step into 32 int32 accumulators a thread.  No wgmma or TMA yet: a
// first kernel that is simple and exact.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int kThreads = 128;
constexpr int kStrideW = 12;  // shared-memory row stride, 32-bit words

struct Geom {
  int N, H, W, C, O, KH, KW, sh, sw, ph, pw, dh, dw, lh, lw, OH, OW;
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// kDil: the input is dilated (lh or lw > 1); without it the tap test is
// the plain bounds check, with no integer division on the load path.
template <typename OutT, bool kDil>
__global__ void __launch_bounds__(kThreads)
    conv2d_int8_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ x_scale,
                       const float* __restrict__ bias,
                       OutT* __restrict__ out, Geom g) {
  __shared__ __align__(16) uint32_t As[BM * kStrideW];
  __shared__ __align__(16) uint32_t Bs[BN * kStrideW];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long npix = (long long)g.OH * g.OW;
  const long long M = (long long)g.N * npix;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // this thread's load slot: row tid/2 of both tiles, 16-byte half tid%2
  const int lrow = tid >> 1, lhalf = tid & 1;
  const long long m = m0 + lrow;
  const bool m_ok = m < M;
  int img = 0, iy0 = 0, ix0 = 0;
  if (m_ok) {
    img = (int)(m / npix);
    const int r = (int)(m - (long long)img * npix);
    iy0 = (r / g.OW) * g.sh - g.ph;
    ix0 = (r % g.OW) * g.sw - g.pw;
  }
  const int oc = n0 + lrow;
  const bool n_ok = oc < g.O;
  const int8_t* xb = x + (size_t)img * g.H * g.W * g.C;
  const int8_t* wb = w + (size_t)(n_ok ? oc : 0) * g.KH * g.KW * g.C;
  const int csteps = g.C / BK;
  const int ksteps = g.KH * g.KW * csteps;

  uint4 av, bv;
  auto load = [&](int ks) {
    const int tap = ks / csteps;
    const int c0 = (ks - tap * csteps) * BK + lhalf * 16;
    const int ky = tap / g.KW;
    const int kx = tap - ky * g.KW;
    int iy = iy0 + ky * g.dh;  // row and column of the (dilated) input
    int ix = ix0 + kx * g.dw;
    bool ok = m_ok && iy >= 0 && ix >= 0;
    if constexpr (kDil) {
      ok = ok && iy % g.lh == 0 && ix % g.lw == 0;
      iy /= g.lh;
      ix /= g.lw;
    }
    av = make_uint4(0u, 0u, 0u, 0u);
    if (ok && iy < g.H && ix < g.W)
      av = *reinterpret_cast<const uint4*>(
          xb + ((size_t)iy * g.W + ix) * g.C + c0);
    bv = make_uint4(0u, 0u, 0u, 0u);
    if (n_ok)
      bv = *reinterpret_cast<const uint4*>(wb + (size_t)tap * g.C + c0);
  };

  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps of 32x32
  const int gr = lane >> 2, tq = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load(0);
  for (int ks = 0; ks < ksteps; ++ks) {
    *reinterpret_cast<uint4*>(As + lrow * kStrideW + lhalf * 4) = av;
    *reinterpret_cast<uint4*>(Bs + lrow * kStrideW + lhalf * 4) = bv;
    __syncthreads();
    if (ks + 1 < ksteps) load(ks + 1);
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t* ap = As + (wm * 32 + i * 16 + gr) * kStrideW + tq;
      af[i][0] = ap[0];
      af[i][1] = ap[8 * kStrideW];
      af[i][2] = ap[4];
      af[i][3] = ap[8 * kStrideW + 4];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t* bp = Bs + (wn * 32 + j * 8 + gr) * kStrideW + tq;
      bf[j][0] = bp[0];
      bf[j][1] = bp[4];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    __syncthreads();
  }

  const float sx = *x_scale;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn * 32 + j * 8 + tq * 2 + e;
      if (col >= g.O) continue;
      const float sc = __fmul_rn(sx, w_scale[col]);
      const float bb = bias != nullptr ? bias[col] : 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = m0 + wm * 32 + i * 16 + gr + h * 8;
          if (row >= M) continue;
          float y = __fmul_rn(__int2float_rn(acc[i][j][h * 2 + e]), sc);
          if (bias != nullptr) y = __fadd_rn(y, bb);
          out[row * g.O + col] = from_f<OutT>(y);
        }
      }
    }
  }
}

template <typename OutT>
int launch(const void* x, const void* w, const void* w_scale,
           const void* x_scale, const void* bias, void* out, const Geom& g,
           void* stream) {
  const long long M = (long long)g.N * g.OH * g.OW;
  if (M == 0 || g.O == 0) return 0;
  if (g.C % BK) return (int)cudaErrorInvalidValue;
  const long long bx = (M + BM - 1) / BM;
  if (bx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)bx, (unsigned)((g.O + BN - 1) / BN), 1);
  auto kernel = (g.lh > 1 || g.lw > 1) ? conv2d_int8_kernel<OutT, true>
                                       : conv2d_int8_kernel<OutT, false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(x_scale),
      static_cast<const float*>(bias), static_cast<OutT*>(out), g);
  return (int)cudaGetLastError();
}

// geom: N, H, W, C, O, KH, KW, sh, sw, pad_top, pad_left, dh, dw, lh, lw,
// OH, OW (17 ints)
Geom make_geom(const int* q) {
  return Geom{q[0], q[1], q[2],  q[3],  q[4],  q[5],  q[6],  q[7], q[8],
              q[9], q[10], q[11], q[12], q[13], q[14], q[15], q[16]};
}

}  // namespace

extern "C" int conv2d_int8_bf16(const void* x, const void* w,
                                const void* w_scale, const void* x_scale,
                                const void* bias, void* out, const int* geom,
                                void* stream) {
  const Geom g = make_geom(geom);
  if (g.lh < 1 || g.lw < 1) return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16>(x, w, w_scale, x_scale, bias, out, g, stream);
}

extern "C" int conv2d_int8_f32(const void* x, const void* w,
                               const void* w_scale, const void* x_scale,
                               const void* bias, void* out, const int* geom,
                               void* stream) {
  const Geom g = make_geom(geom);
  if (g.lh < 1 || g.lw < 1) return (int)cudaErrorInvalidValue;
  return launch<float>(x, w, w_scale, x_scale, bias, out, g, stream);
}
