// pillar_scatter_max: the pillar canvas max, under both of lav_tpu's
// contracts.
//
// Replaces two Pallas TPU kernels:
//   - lav_tpu/ops/pillar_pallas.py::_kernel (launched by _packed_call;
//     entry pillar_scatter_max_pallas), the NEG-init max of the
//     use_pallas route: entries pillar_scatter_max_{f32,bf16};
//   - lav_tpu/ops/pillar_pallas2.py::_kernel and ::_kernel_stream with
//     op="max" (entry scatter_pallas), the zero-init max of the production
//     route, which lav_tpu runs as the XLA scatter
//     jnp.zeros(...).at[pid].max(feat, mode="drop"): entries
//     scatter_max_{f32,bf16}.
//
// Contract.  feat (N, C) f32 or bf16 (C even), pid (N,) int32, out (S, C)
// in feat's dtype; the kernel writes every element of out, so the caller
// need not fill it.  Point p raises row pid[p]; ids outside [0, S) are
// dropped.  Per element, from the init value on, a payload replaces the
// stored value when it is strictly greater, and a NaN payload lands and
// sticks: the element ends NaN whatever else arrives.  So:
//   scatter_max (zero init): max(0, max over the row's points); negative
//     values and -0.0 do not raise the zero; a NaN ends NaN, as lav_tpu's
//     drop scatter gives it.
//   pillar_scatter_max (NEG init, NEG = -1e30; in bf16 its rounding 0xF14A
//     = -1.0003e30, as the TPU kernel fills and compares in the feature
//     dtype): the max over the row's points, then every element not above
//     NEG becomes 0: untouched rows, rows reached only by payloads at or
//     below NEG, and NaN (the TPU kernel's maximum keeps the NaN, its
//     finalize `> NEG` turns it into 0).
// Max does not depend on order, so the result is exact whatever order the
// points are visited in.
//
// Bound: bytes.  Payload and ids read once, the canvas written once: at
// the bf16 production shapes (16 egos x 60000 points, 64 channels, 16 x
// 102400 rows) 123 MB of payload, 3.8 MB of ids and a 210 MB canvas,
// 0.1004 ms at 3.35 TB/s.
//
// Design: a counting sort of the point indices by row, then one store per
// canvas row.  No fill pass, no finalize pass, no atomic on the payload.
//   1. histogram: one thread per point reads its id once and takes its
//      rank in its row from an atomicAdd on the row's count; the equal ids
//      of a warp share one atomicAdd (__match_any_sync).  Without that,
//      the phase ids' in-range dump row takes 190,000 atomics on one
//      address: 1.6x slower there, and 5.4x where every point goes to one
//      in-range row (the agent's tick-1 ids with the dump row in range).
//      Grouping only a warp's least and greatest ids (`redux.sync`) was
//      up to 4% faster on the agent's ids but misses a crowded pillar
//      that is neither; __match_any_sync groups any (PERF.md, `turns.py
//      scatter --variants`).  Dropped ids stop here.
//   2. scan: exclusive prefix sums of the counts, by tiles of kTile rows
//      (a block each), then one block over the tiles' sums; a row's offset
//      is its prefix in its tile plus its tile's prefix.  The tile pass
//      also lists the rows holding more than kHot points.
//   3. place: each point's index goes to its row's offset plus its rank.
//   4. rows: a group of threads owns a row, a thread a 16-byte piece of it
//      (8 threads for 64 bf16 channels); the group walks the row's list
//      with independent loads, keeps the max in registers and stores the
//      row once, finalized.  An empty row is one store of the init value.
//      A row of more than kHot points is cut into chunks of kGroupPoints
//      points for each group of a block (1024 points for 64 bf16
//      channels, 512 for 64 f32), each reduced by a whole block into a
//      partial max; the block that finishes a row's last chunk combines
//      the partials by the same rule (so NaN sticks) and stores the row.
//      Without the cut, the dump row of 190,000 points that the phase ids
//      hold would serialise on one group.  The rows kernel is held to 32
//      registers, 8 blocks an SM: the walk is bound by the latency of its
//      dependent loads (offsets, then indices, then payload), and more
//      warps in flight gained 0-5% (PERF.md).
// The counts, offsets, ranks, indices and partials live in one scratch
// buffer from the caller (PyTorch's caching allocator; no cudaMalloc here),
// laid out by `Layout`; `scratch_bytes` must cover it.  cudaMemsetAsync
// zeroes the counts, 6.6 MB at the production shapes, where the canvas
// fill was 210 MB.  About 50 MB of scratch traffic in all, beside 333 MB
// of payload and canvas.
//
// Why not atomics: sm_90's vector bf16x2 `red.global.max` returns the
// operand that is not NaN, so it cannot keep NaN as the contract says, and
// it needs the canvas filled first (and K2's finalize after).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;          // rows a scan block covers: 256 x 16
constexpr int kHot = 64;             // a row with more points is cut up
constexpr int kGroupPoints = 32;     // a hot chunk's points per group
constexpr int kHotBlocks = 132 * 4;  // blocks that walk the hot chunks
constexpr size_t kAlign = 256;       // each scratch array starts aligned
constexpr uint32_t kNegBf16 = 0xF14Au;  // bf16 rounding of -1e30

// The scratch buffer, in bytes from its start.  The Python wrapper's
// `canvas_scratch_bytes` computes `total` the same way.
struct Layout {
  size_t meta, cnt, done, zeroed, tile_sum, rank, idx, hot_rows, hot_start,
      partials, total;
  int tiles, max_hot, max_chunks;
  size_t at = 0;

  size_t take(size_t bytes) {
    const size_t r = at;
    at = (at + bytes + kAlign - 1) / kAlign * kAlign;
    return r;
  }
  Layout(long long n, long long rows, long long row_bytes) {
    tiles = (int)((rows + 1 + kTile - 1) / kTile);  // rows + the end
    max_hot = (int)(n / (kHot + 1) + 1);
    max_chunks = (int)(n / kGroupPoints) + max_hot;  // chunks >= 32 points
    meta = take(16);  // hot rows (low 32 bits), their chunks (high 32)
    cnt = take(4ull * tiles * kTile);
    done = take(4ull * max_hot);  // chunks finished per hot row
    zeroed = at;
    tile_sum = take(4ull * tiles);
    rank = take(4ull * n);
    idx = take(4ull * n);
    hot_rows = take(4ull * max_hot);
    hot_start = take(4ull * max_hot);  // each hot row's first chunk
    partials = take((size_t)max_chunks * row_bytes);
    total = at;
  }
};

// Element types: a 4-byte word holds one f32 or two bf16 lanes.  The
// max is kept in f32: a bf16 widens exactly, and narrows back exactly by
// its high 16 bits for every value the max can hold (NaN payloads too).
struct Bf16 {};
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kLanes = 1, kBytes = 4;
  __device__ static float lane(uint32_t w, int) { return __uint_as_float(w); }
  __device__ static uint32_t pack(const float* x) {
    return __float_as_uint(x[0]);
  }
  __device__ static float neg() { return -1e30f; }
};
template <>
struct Elem<Bf16> {
  static constexpr int kLanes = 2, kBytes = 2;
  __device__ static float lane(uint32_t w, int i) {
    return __uint_as_float(i ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static uint32_t pack(const float* x) {
    return (__float_as_uint(x[0]) >> 16) |
           (__float_as_uint(x[1]) & 0xffff0000u);
  }
  __device__ static float neg() { return __uint_as_float(kNegBf16 << 16); }
};

// A piece of a row: W 4-byte words (16, 8 or 4 bytes, by alignment).
template <int W>
struct Piece {
  uint32_t w[W];
};

// cs: read or written once (payload, canvas); cg: through L2 only (the
// partials, which other blocks of the same launch read)
template <int W, bool kCg>
__device__ __forceinline__ Piece<W> load(const uint8_t* p) {
  Piece<W> r;
  if constexpr (W == 4) {
    const uint4 v = kCg ? __ldcg(reinterpret_cast<const uint4*>(p))
                        : __ldcs(reinterpret_cast<const uint4*>(p));
    r.w[0] = v.x, r.w[1] = v.y, r.w[2] = v.z, r.w[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = kCg ? __ldcg(reinterpret_cast<const uint2*>(p))
                        : __ldcs(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x, r.w[1] = v.y;
  } else {
    r.w[0] = kCg ? __ldcg(reinterpret_cast<const unsigned int*>(p))
                 : __ldcs(reinterpret_cast<const unsigned int*>(p));
  }
  return r;
}

template <int W, bool kCg>
__device__ __forceinline__ void store(uint8_t* p, const Piece<W>& r) {
  if constexpr (W == 4) {
    const uint4 v = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
    kCg ? __stcg(reinterpret_cast<uint4*>(p), v)
        : __stcs(reinterpret_cast<uint4*>(p), v);
  } else if constexpr (W == 2) {
    const uint2 v = make_uint2(r.w[0], r.w[1]);
    kCg ? __stcg(reinterpret_cast<uint2*>(p), v)
        : __stcs(reinterpret_cast<uint2*>(p), v);
  } else {
    kCg ? __stcg(reinterpret_cast<unsigned int*>(p), r.w[0])
        : __stcs(reinterpret_cast<unsigned int*>(p), r.w[0]);
  }
}

// the contract's rule: strictly greater replaces; a NaN lands and sticks
__device__ __forceinline__ float vmax(float acc, float v) {
  return (v > acc || (v != v && acc == acc)) ? v : acc;
}

template <typename T, int W>
struct Acc {
  static constexpr int kL = Elem<T>::kLanes;
  float v[W * kL];

  __device__ explicit Acc(float init) {
#pragma unroll
    for (int i = 0; i < W * kL; ++i) v[i] = init;
  }
  __device__ void add(const Piece<W>& p) {
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int l = 0; l < kL; ++l)
        v[w * kL + l] = vmax(v[w * kL + l], Elem<T>::lane(p.w[w], l));
  }
  // finalize: every value not above NEG (NaN included) becomes 0
  __device__ Piece<W> pack(bool finalize) const {
    const float neg = Elem<T>::neg();
    Piece<W> p;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      float x[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const float y = v[w * kL + l];
        x[l] = (finalize && !(y > neg)) ? 0.0f : y;
      }
      p.w[w] = Elem<T>::pack(x);
    }
    return p;
  }
};

// exclusive prefix of v over the block (blockDim.x a multiple of 32);
// `total` gets the block's sum.  warp_sum holds 33 ints.
__device__ int block_scan(int v, int* warp_sum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nw ? warp_sum[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += t;
    }
    if (lane < nw) warp_sum[lane] = wi - w;
    if (lane == 31) warp_sum[32] = wi;
  }
  __syncthreads();
  total = warp_sum[32];
  const int r = warp_sum[warp] + incl - v;
  __syncthreads();  // warp_sum is reused by the next call
  return r;
}

// 1. one thread per point: its row's count, and its rank in the row
__global__ void histogram_kernel(const int32_t* __restrict__ pid,
                                 int* __restrict__ cnt,
                                 int* __restrict__ rank, int n, int rows) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = p < n ? __ldg(pid + p) : -1;
  const bool ok = s >= 0 && s < rows;
  const unsigned active = __ballot_sync(0xffffffffu, ok);
  if (!ok) return;
  const unsigned peers = __match_any_sync(active, s);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cnt + s, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  rank[p] = base + __popc(peers & ((1u << lane) - 1u));
}

// 2a. a tile's counts become their exclusive prefix within the tile; the
// tile's total goes to tile_sum; rows of more than kHot points are listed
// with their chunks of `chunk` points (one 64-bit atomic adds a row and its
// chunks at once, so hot_start rises with the list's order)
__global__ void __launch_bounds__(kThreads)
    scan_tiles_kernel(int* __restrict__ cnt, int* __restrict__ tile_sum,
                      unsigned long long* __restrict__ meta,
                      int* __restrict__ hot_rows,
                      int* __restrict__ hot_start, int chunk) {
  __shared__ int warp_sum[33];
  int4* q = reinterpret_cast<int4*>(cnt + (size_t)blockIdx.x * kTile) +
            threadIdx.x * 4;
  int v[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 t = q[i];
    v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z,
          v[4 * i + 3] = t.w;
  }
  const int r0 = blockIdx.x * kTile + threadIdx.x * 16;
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = v[i];
    if (c > kHot) {
      const unsigned long long chunks = (c + chunk - 1) / chunk;
      const unsigned long long old = atomicAdd(meta, (chunks << 32) | 1ull);
      const int h = (int)(old & 0xffffffffu);
      hot_rows[h] = r0 + i;
      hot_start[h] = (int)(old >> 32);
    }
    v[i] = sum;
    sum += c;
  }
  int total;
  const int pre = block_scan(sum, warp_sum, total);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = make_int4(v[4 * i] + pre, v[4 * i + 1] + pre, v[4 * i + 2] + pre,
                     v[4 * i + 3] + pre);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

// 2b. one block: the tiles' sums become their exclusive prefix
__global__ void scan_sums_kernel(int* __restrict__ tile_sum, int tiles) {
  __shared__ int warp_sum[33];
  int carry = 0;
  for (int b = 0; b < tiles; b += blockDim.x) {
    const int i = b + threadIdx.x;
    const int v = i < tiles ? tile_sum[i] : 0;
    int total;
    const int pre = block_scan(v, warp_sum, total);
    if (i < tiles) tile_sum[i] = carry + pre;
    carry += total;
  }
}

struct Offsets {
  const int* local;     // prefix within the tile
  const int* tile_pre;  // prefix of the tiles
  __device__ int operator()(int r) const {
    return __ldg(local + r) + __ldg(tile_pre + r / kTile);
  }
};

// 3. each point's index to its place in its row's list
__global__ void place_kernel(const int32_t* __restrict__ pid,
                             const int* __restrict__ rank, Offsets off,
                             int* __restrict__ idx, int n, int rows) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int s = __ldg(pid + p);
  if (s < 0 || s >= rows) return;
  idx[off(s) + rank[p]] = p;
}

struct RowsArgs {
  const uint8_t* feat;
  uint8_t* out;
  uint8_t* partials;
  Offsets off;
  const int* idx;
  const unsigned long long* meta;
  const int* hot_rows;
  const int* hot_start;
  int* done;
  int rows, row_bytes, pieces, hot_blocks, chunk;
};

// the max of piece j over the points idx[k], idx[k + step], ... below
// end, four loads in flight
template <typename T, int W>
__device__ __forceinline__ void walk(Acc<T, W>& acc, const RowsArgs& a,
                                     int k, int end, int step, int j) {
  const uint8_t* f = a.feat + (size_t)j * (4 * W);
  const size_t rb = (size_t)a.row_bytes;
  for (; k + 3 * step < end; k += 4 * step) {
    const int p0 = __ldg(a.idx + k), p1 = __ldg(a.idx + k + step),
              p2 = __ldg(a.idx + k + 2 * step),
              p3 = __ldg(a.idx + k + 3 * step);
    const Piece<W> v0 = load<W, false>(f + p0 * rb),
                   v1 = load<W, false>(f + p1 * rb),
                   v2 = load<W, false>(f + p2 * rb),
                   v3 = load<W, false>(f + p3 * rb);
    acc.add(v0), acc.add(v1), acc.add(v2), acc.add(v3);
  }
  for (; k < end; k += step)
    acc.add(load<W, false>(f + __ldg(a.idx + k) * rb));
}

// the max over the block's rows (threadIdx.y) into the threads of row 0
template <typename T, int W>
__device__ __forceinline__ void block_max(Acc<T, W>& acc, Piece<W>* red) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  red[t] = acc.pack(false);
  __syncthreads();
  if (threadIdx.y == 0)
    for (int y = 1; y < blockDim.y; ++y)
      acc.add(red[y * blockDim.x + threadIdx.x]);
  __syncthreads();
}

// 4. blocks [0, hot_blocks) walk the hot rows' chunks (a.chunk =
// blockDim.y * kGroupPoints points); the others own blockDim.y rows each,
// blockDim.x threads a row, a piece a thread
template <typename T, bool kNegInit, int W>
__global__ void __launch_bounds__(kThreads, 8) rows_kernel(RowsArgs a) {
  const float init = kNegInit ? Elem<T>::neg() : 0.0f;
  constexpr int kPiece = 4 * W;
  if ((int)blockIdx.x >= a.hot_blocks) {
    const int r = ((int)blockIdx.x - a.hot_blocks) * blockDim.y + threadIdx.y;
    if (r >= a.rows) return;
    const int start = a.off(r), end = a.off(r + 1);
    if (end - start > kHot) return;  // a hot row: the hot blocks store it
    uint8_t* o = a.out + (size_t)r * a.row_bytes;
    for (int j = threadIdx.x; j < a.pieces; j += blockDim.x) {
      Acc<T, W> acc(init);
      walk(acc, a, start, end, 1, j);
      store<W, false>(o + j * kPiece, acc.pack(kNegInit));
    }
    return;
  }
  __shared__ Piece<W> red[kThreads];
  __shared__ int last;
  const unsigned long long m = *a.meta;
  const int n_hot = (int)(m & 0xffffffffu), chunks = (int)(m >> 32);
  for (int c = blockIdx.x; c < chunks; c += a.hot_blocks) {
    // the hot row of chunk c: the last h with hot_start[h] <= c
    int lo = 0, hi = n_hot - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(a.hot_start + mid) <= c) lo = mid;
      else hi = mid - 1;
    }
    const int first = __ldg(a.hot_start + lo), s = __ldg(a.hot_rows + lo);
    const int start = a.off(s), end = a.off(s + 1);
    const int n_chunks = (end - start + a.chunk - 1) / a.chunk;
    const int k0 = start + (c - first) * a.chunk;
    const int k1 = min(end, k0 + a.chunk);
    for (int j0 = 0; j0 < a.pieces; j0 += blockDim.x) {
      const int j = j0 + threadIdx.x;
      Acc<T, W> acc(init);
      if (j < a.pieces) walk(acc, a, k0 + (int)threadIdx.y, k1, blockDim.y, j);
      block_max(acc, red);
      if (threadIdx.y == 0 && j < a.pieces)
        store<W, true>(a.partials + (size_t)c * a.row_bytes + j * kPiece,
                       acc.pack(false));
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0 && threadIdx.y == 0)
      last = atomicAdd(a.done + lo, 1) == n_chunks - 1;
    __syncthreads();
    if (last) {  // every chunk of row s is in: combine and store
      __threadfence();
      for (int j0 = 0; j0 < a.pieces; j0 += blockDim.x) {
        const int j = j0 + threadIdx.x;
        Acc<T, W> acc(init);
        if (j < a.pieces)
          for (int q = threadIdx.y; q < n_chunks; q += blockDim.y)
            acc.add(load<W, true>(a.partials +
                                  (size_t)(first + q) * a.row_bytes +
                                  j * kPiece));
        block_max(acc, red);
        if (threadIdx.y == 0 && j < a.pieces)
          store<W, false>(a.out + (size_t)s * a.row_bytes + j * kPiece,
                          acc.pack(kNegInit));
      }
    }
    __syncthreads();  // `last` is written again for the next chunk
  }
}

template <typename T, bool kNegInit, int W>
void launch_rows(const RowsArgs& a, dim3 block, cudaStream_t st) {
  const long long blocks = a.hot_blocks + ((long long)a.rows + block.y - 1) /
                                              block.y;
  rows_kernel<T, kNegInit, W><<<(unsigned)blocks, block, 0, st>>>(a);
}

template <typename T, bool kNegInit>
int canvas_max(const void* feat, const void* pid, void* out,
               long long n_points, int C, long long segments, void* scratch,
               long long scratch_bytes, void* stream) {
  if (n_points < 0 || C < 0 || segments < 0 || n_points > INT_MAX ||
      segments > INT_MAX - kTile)
    return (int)cudaErrorInvalidValue;
  if (segments == 0 || C == 0) return 0;
  const long long row_bytes = (long long)C * Elem<T>::kBytes;
  if (row_bytes % 4 || row_bytes > INT_MAX) return (int)cudaErrorInvalidValue;
  const Layout L(n_points, segments, row_bytes);
  if (scratch_bytes < 0 || (size_t)scratch_bytes < L.total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* s = static_cast<uint8_t*>(scratch);
  const int n = (int)n_points, rows = (int)segments;
  int* cnt = reinterpret_cast<int*>(s + L.cnt);
  int* tile_sum = reinterpret_cast<int*>(s + L.tile_sum);
  int* rank = reinterpret_cast<int*>(s + L.rank);
  int* idx = reinterpret_cast<int*>(s + L.idx);
  int* hot_rows = reinterpret_cast<int*>(s + L.hot_rows);
  int* hot_start = reinterpret_cast<int*>(s + L.hot_start);
  auto* meta = reinterpret_cast<unsigned long long*>(s + L.meta);
  const int32_t* ids = static_cast<const int32_t*>(pid);
  int err = (int)cudaMemsetAsync(s, 0, L.zeroed, st);
  if (err) return err;
  const int point_blocks = (n + kThreads - 1) / kThreads;
  if (n > 0)
    histogram_kernel<<<point_blocks, kThreads, 0, st>>>(ids, cnt, rank, n,
                                                         rows);
  // the rows kernel's block: x threads a row (a piece each), y rows
  const uintptr_t align = reinterpret_cast<uintptr_t>(feat) |
                          reinterpret_cast<uintptr_t>(out) |
                          (uintptr_t)row_bytes;
  const int W = align % 16 == 0 ? 4 : align % 8 == 0 ? 2 : 1;
  const int pieces = (int)(row_bytes / (4 * W));
  const dim3 block(pieces < kThreads ? pieces : kThreads,
                   kThreads / (pieces < kThreads ? pieces : kThreads));
  const int chunk = (int)block.y * kGroupPoints;
  scan_tiles_kernel<<<L.tiles, kThreads, 0, st>>>(cnt, tile_sum, meta,
                                                  hot_rows, hot_start, chunk);
  scan_sums_kernel<<<1, 1024, 0, st>>>(tile_sum, L.tiles);
  const Offsets off{cnt, tile_sum};
  if (n > 0)
    place_kernel<<<point_blocks, kThreads, 0, st>>>(ids, rank, off, idx, n,
                                                    rows);
  RowsArgs a{static_cast<const uint8_t*>(feat),
             static_cast<uint8_t*>(out),
             s + L.partials,
             off,
             idx,
             meta,
             hot_rows,
             hot_start,
             reinterpret_cast<int*>(s + L.done),
             rows,
             (int)row_bytes,
             pieces,
             n > 0 ? (L.max_chunks < kHotBlocks ? L.max_chunks : kHotBlocks)
                   : 0,
             chunk};
  if (W == 4) launch_rows<T, kNegInit, 4>(a, block, st);
  else if (W == 2) launch_rows<T, kNegInit, 2>(a, block, st);
  else launch_rows<T, kNegInit, 1>(a, block, st);
  return (int)cudaGetLastError();
}

}  // namespace

// feat, pid, out, n_points, C, segments, scratch, scratch_bytes, stream

extern "C" int scatter_max_bf16(const void* feat, const void* pid, void* out,
                                long long n_points, int C, long long segments,
                                void* scratch, long long scratch_bytes,
                                void* stream) {
  return canvas_max<Bf16, false>(feat, pid, out, n_points, C, segments,
                                 scratch, scratch_bytes, stream);
}

extern "C" int scatter_max_f32(const void* feat, const void* pid, void* out,
                               long long n_points, int C, long long segments,
                               void* scratch, long long scratch_bytes,
                               void* stream) {
  return canvas_max<float, false>(feat, pid, out, n_points, C, segments,
                                  scratch, scratch_bytes, stream);
}

extern "C" int pillar_scatter_max_f32(const void* feat, const void* pid,
                                      void* out, long long n_points, int C,
                                      long long segments, void* scratch,
                                      long long scratch_bytes, void* stream) {
  return canvas_max<float, true>(feat, pid, out, n_points, C, segments,
                                 scratch, scratch_bytes, stream);
}

extern "C" int pillar_scatter_max_bf16(const void* feat, const void* pid,
                                       void* out, long long n_points, int C,
                                       long long segments, void* scratch,
                                       long long scratch_bytes,
                                       void* stream) {
  return canvas_max<Bf16, true>(feat, pid, out, n_points, C, segments,
                                scratch, scratch_bytes, stream);
}

// ---- pillar_scatter_max_bwd: the gradient of the NEG-init canvas max ----
//
// Replaces XLA's VJP of lav_tpu's training canvas,
// lav_tpu/ops/pillar.py:516-522: where(keep, feat, -1e30) -> .at[pid].max
// over a -1e30 canvas -> where(canvas > -1e30, canvas, 0), whose forward
// is pillar_scatter_max_f32's contract (no Pallas kernel; JAX's
// _scatter_extremal_jvp).  Contract: g (S, C) the canvas' gradient, feat
// (N, C) and pid (N,) the forward's inputs, canvas (S, C) its output;
// d_feat (N, C):
//   d_feat[p, c] = g[s, c] * (1 / n[s, c])  where s = pid[p] is in [0, S)
//                                           and feat[p, c] == canvas[s, c]
//                = 0                         otherwise,
// with n[s, c] the number of points of row s whose channel c equals
// canvas[s, c]: JAX splits a cell's gradient evenly among the points that
// tie for its max, and computes 1 / n in f32 before the product, as here
// (__frcp_rn is the correctly rounded reciprocal).  A row whose max was
// not above NEG holds 0 in the finalized canvas, and no point of it can
// equal 0 (one that did would have raised the max to 0), so comparing
// with the finalized canvas gives 0 there, as JAX's where does.  Dropped
// ids give 0.  A NaN in the forward is not a case training has to match:
// a NaN payload equals nothing and gets 0.  Up to the division, the
// result is exact (no sum is taken).
//
// Bound: bytes.  feat, the gathered canvas and g rows and d_feat, about
// 4 x 16.8 MB at the distillation step's shapes (4 x 16384 points, 64
// channels), 0.02 ms at 3.35 TB/s.  Design, simple first, two passes over
// the points, one thread per (point, 4-channel vector): the first counts
// the ties of each (row, channel) with int32 atomics into `counts`
// (S x C, zeroed here with cudaMemsetAsync: 105 MB at those shapes, more
// than the rest), the second writes d_feat.  Reusing the forward's
// counting sort (rows pass) would need neither the counts nor their
// zeroing; that is the redesign to try if this is slow.

namespace {

template <typename T>
__global__ void max_bwd_count(const T* __restrict__ feat,
                              const int32_t* __restrict__ pid,
                              const T* __restrict__ canvas,
                              int* __restrict__ counts, long long total,
                              int nvec, int C, long long segments) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / nvec;
    const int v = (int)(i - p * nvec);
    const long long s = pid[p];
    if (s < 0 || s >= segments) continue;
    const T f = feat[i], m = canvas[s * nvec + v];
    int* cnt = counts + s * C + (long long)v * (sizeof(T) / 4);
    if constexpr (sizeof(T) == 16) {
      if (f.x == m.x) atomicAdd(cnt, 1);
      if (f.y == m.y) atomicAdd(cnt + 1, 1);
      if (f.z == m.z) atomicAdd(cnt + 2, 1);
      if (f.w == m.w) atomicAdd(cnt + 3, 1);
    } else {
      if (f == m) atomicAdd(cnt, 1);
    }
  }
}

__device__ __forceinline__ float share(float f, float m, float g, int n) {
  return f == m ? __fmul_rn(g, __frcp_rn((float)n)) : 0.0f;
}

template <typename T>
__global__ void max_bwd_write(const T* __restrict__ g,
                              const T* __restrict__ feat,
                              const int32_t* __restrict__ pid,
                              const T* __restrict__ canvas,
                              const int* __restrict__ counts,
                              T* __restrict__ out, long long total, int nvec,
                              int C, long long segments) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / nvec;
    const int v = (int)(i - p * nvec);
    const long long s = pid[p];
    T r;
    if (s < 0 || s >= segments) {
      if constexpr (sizeof(T) == 16)
        r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      else
        r = 0.0f;
    } else {
      const long long cell = s * nvec + v;
      const T f = feat[i], m = canvas[cell], gv = g[cell];
      const int* cnt = counts + s * C + (long long)v * (sizeof(T) / 4);
      if constexpr (sizeof(T) == 16) {
        const int4 n = *reinterpret_cast<const int4*>(cnt);
        r = make_float4(share(f.x, m.x, gv.x, n.x), share(f.y, m.y, gv.y, n.y),
                        share(f.z, m.z, gv.z, n.z), share(f.w, m.w, gv.w, n.w));
      } else {
        r = share(f, m, gv, *cnt);
      }
    }
    out[i] = r;
  }
}

int bwd_blocks(long long n) {
  long long b = (n + 255) / 256;
  const long long cap = 132LL * 64;  // enough resident blocks for 132 SMs
  if (b > cap) b = cap;
  return (int)(b < 1 ? 1 : b);
}

template <typename T>
int max_bwd(const void* g, const void* feat, const void* pid,
            const void* canvas, void* out, long long n_points, int C,
            long long segments, void* counts, cudaStream_t st) {
  const int nvec = C / (int)(sizeof(T) / 4);
  const long long total = n_points * nvec;
  cudaError_t err = cudaMemsetAsync(counts, 0, segments * C * sizeof(int),
                                    st);
  if (err != cudaSuccess) return (int)err;
  max_bwd_count<T><<<bwd_blocks(total), 256, 0, st>>>(
      static_cast<const T*>(feat), static_cast<const int32_t*>(pid),
      static_cast<const T*>(canvas), static_cast<int*>(counts), total, nvec,
      C, segments);
  max_bwd_write<T><<<bwd_blocks(total), 256, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(feat),
      static_cast<const int32_t*>(pid), static_cast<const T*>(canvas),
      static_cast<const int*>(counts), static_cast<T*>(out), total, nvec, C,
      segments);
  return (int)cudaGetLastError();
}

}  // namespace

// counts: S x C int32 scratch from the caller
extern "C" int pillar_scatter_max_bwd_f32(const void* g, const void* feat,
                                          const void* pid, const void* canvas,
                                          void* out, long long n_points,
                                          int C, long long segments,
                                          void* counts, void* stream) {
  if (n_points == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t any = (uintptr_t)g | (uintptr_t)feat | (uintptr_t)canvas |
                        (uintptr_t)out | (uintptr_t)counts;
  if (C % 4 == 0 && any % 16 == 0)
    return max_bwd<float4>(g, feat, pid, canvas, out, n_points, C, segments,
                           counts, st);
  return max_bwd<float>(g, feat, pid, canvas, out, n_points, C, segments,
                        counts, st);
}
