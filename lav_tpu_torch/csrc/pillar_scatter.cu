// pillar_scatter: the production pillar route's decoration sums.
//
// Replaces the Pallas TPU kernel lav_tpu/ops/pillar_pallas2.py::_kernel
// and ::_kernel_stream with op="add" (launched by _call; entry
// scatter_pallas), which sums [xyz, 1] per pillar for lav_tpu's pillar
// decoration (ops/pillar.py).  The TPU kernel's VMEM-resident canvas,
// n_copies and slab/stream modes are VMEM tactics.  Its op="max", the
// canvas, is csrc/pillar_scatter_max.cu's `scatter_max`.
//
// Contract: out (S, C) starts zeroed (the caller zeroes it); point p adds
// feat[p, :] to row pid[p]; ids outside [0, S) are skipped.
//   scatter_add_f32: out[s, c] = ((0 + v_p0) + v_p1) + ... over the row's
//     points p0 < p1 < ... in index order: the sum of a sequential loop
//     over the points (index_add_ on the CPU), bit for bit, and the same
//     bits on every launch.  lav_tpu's scatter-add is deterministic; an
//     f32 atomicAdd is not, and train-mode BatchNorm amplifies its last
//     bits into percents of a gradient leaf.
//
// Bound: bytes.  Payload and ids are read once and the canvas written
// once: at the agent's shapes (16 egos x 60000 points, C = 4, 16 x 102400
// + 1 rows) 15 MB of payload and 3.8 MB of ids into a 26 MB canvas,
// 0.0136 ms at 3.35 TB/s.
//
// Design: a stable LSD radix sort of the live points by row, then one
// thread per run of equal rows adding the run in index order.
//   - A point whose C lanes are all +-0 adds nothing to any bit of a sum
//     that starts at +0 (s + (+-0) = s for every s a sum can hold: it
//     never becomes -0 under round-to-nearest, and NaN stays NaN), and
//     neither does a point outside [0, S): both are left out of the sort.
//     The agent sends every invalid point to one dump row with a zero
//     payload: a fifth of the 960,000 points of a 16-ego tick once its
//     ring buffer is full, all of them at tick 1.
//   - Each pass sorts by 8 bits of the row (3 passes for 1.6M rows) in
//     tiles of kTileItems points, three kernels a pass: `upsweep` counts a
//     tile's digits (pass 0 also marks the live points), `scan` turns the
//     (digit, tile) counts into exclusive offsets, a block per digit, and
//     `downsweep` places each point at its digit's offset plus its rank
//     among the tile's earlier points of that digit: a warp walks its
//     points in index order, 32 at a time, ranking equal digits with
//     __match_any_sync, so the placement is stable; the tile is ordered
//     by digit in shared memory first and written out in that order, a
//     digit's run to consecutive addresses.  Later passes sort only the
//     live points, whose number the pass-0 totals hold.
//   - `sum`: a thread whose sorted position starts a run of one row adds
//     the run's payloads in their order, kUnroll loads in flight, and
//     stores the row once.  No atomic touches the payload.
// Everything lives in one scratch buffer from the caller (PyTorch's
// caching allocator), laid out by `AddLayout`; `scratch_bytes` must cover
// it (ops/pillar.py::scatter_add_scratch_bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;  // points a thread: a warp walks 8 x 32 in turn
constexpr int kTileItems = kThreads * kItems;
constexpr int kDigits = 256;
constexpr int kBits = 8;
constexpr int kUnroll = 8;
constexpr size_t kAlign = 256;

struct AddLayout {
  size_t keys0, vals0, keys1, vals1, hist, totals, total;
  int tiles, passes;
  size_t at = 0;

  size_t take(size_t bytes) {
    const size_t r = at;
    at = (at + bytes + kAlign - 1) / kAlign * kAlign;
    return r;
  }
  AddLayout(long long n, long long rows) {
    tiles = (int)((n + kTileItems - 1) / kTileItems);
    int bits = 1;
    while (bits < 62 && (1LL << bits) < rows) bits++;
    passes = (bits + kBits - 1) / kBits;
    keys0 = take(4ull * n);
    vals0 = take(4ull * n);
    keys1 = take(4ull * n);
    vals1 = take(4ull * n);
    hist = take(4ull * passes * kDigits * tiles);
    totals = take(4ull * passes * kDigits);
    total = at;
  }
};

// exclusive prefix sum over the block of kThreads threads; `sh` holds
// kWarps ints.  Every thread must call it.
__device__ int block_exclusive_scan(int v, int* sh, int* block_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  int base = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; w++) {
    const int t = sh[w];
    if (w < warp) base += t;
    all += t;
  }
  __syncthreads();
  if (block_total) *block_total = all;
  return base + x - v;
}

// the points pass 0 left live: the sum of its digit totals
__device__ long long live_points(const int* totals0, int* sh) {
  int all;
  block_exclusive_scan(totals0[threadIdx.x], sh, &all);
  return all;
}

// a point is live when its id is in [0, S) and a lane is not +-0
__device__ __forceinline__ bool live_row(const float* __restrict__ feat,
                                         long long p, int C, bool vec) {
  if (vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(feat) + p);
    return ((__float_as_uint(v.x) | __float_as_uint(v.y) |
             __float_as_uint(v.z) | __float_as_uint(v.w)) << 1) != 0;
  }
  uint32_t bits = 0;
  for (int c = 0; c < C; c++) bits |= __float_as_uint(feat[p * C + c]);
  return (bits << 1) != 0;
}

// count the tile's digits; pass 0 reads (pid, feat) and writes each
// point's key (its row, or -1 when it is not live) to keys0
__global__ void upsweep_kernel(const float* __restrict__ feat,
                               const int32_t* __restrict__ pid, int C,
                               bool vec, long long n, long long segments,
                               const int32_t* __restrict__ keys_in,
                               int32_t* __restrict__ keys0,
                               int* __restrict__ hist, int tiles,
                               const int* __restrict__ totals0, int pass) {
  __shared__ int s_hist[kDigits];
  __shared__ int sh[kWarps];
  s_hist[threadIdx.x] = 0;
  const long long limit = pass == 0 ? n : live_points(totals0, sh);
  __syncthreads();
  const long long start = (long long)blockIdx.x * kTileItems;
  const int shift = pass * kBits;
  for (int i = threadIdx.x; i < kTileItems; i += kThreads) {
    const long long p = start + i;
    if (p >= limit) break;
    int key;
    if (pass == 0) {
      const long long s = pid[p];
      key = s >= 0 && s < segments && live_row(feat, p, C, vec) ? (int)s
                                                                : -1;
      keys0[p] = key;
    } else {
      key = keys_in[p];
    }
    if (key >= 0) atomicAdd(&s_hist[(key >> shift) & (kDigits - 1)], 1);
  }
  __syncthreads();
  hist[(long long)threadIdx.x * tiles + blockIdx.x] = s_hist[threadIdx.x];
}

// a block per digit: that digit's tile counts -> exclusive offsets among
// the digit's points, and the digit's total
__global__ void scan_kernel(int* __restrict__ hist, int tiles,
                            int* __restrict__ totals) {
  __shared__ int sh[kWarps];
  int* row = hist + (long long)blockIdx.x * tiles;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const int v = t < tiles ? row[t] : 0;
    int all;
    const int ex = block_exclusive_scan(v, sh, &all);
    if (t < tiles) row[t] = carry + ex;
    carry += all;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// place the tile's live points at their digit's offset plus their rank
// among the tile's earlier points of that digit: stable.  The tile is
// first ordered by digit in shared memory, then written out in that
// order, so that a digit's run of points goes to consecutive addresses.
__global__ void downsweep_kernel(const int32_t* __restrict__ keys_in,
                                 const int32_t* __restrict__ vals_in,
                                 int32_t* __restrict__ keys_out,
                                 int32_t* __restrict__ vals_out,
                                 const int* __restrict__ hist, int tiles,
                                 const int* __restrict__ totals,
                                 const int* __restrict__ totals0,
                                 long long n, int pass) {
  __shared__ int s_cnt[kWarps][kDigits];
  __shared__ int s_keys[kTileItems];
  __shared__ int s_vals[kTileItems];
  __shared__ int s_local[kDigits];  // the digit's first slot in the tile
  __shared__ int s_glob[kDigits];   // the digit's first global position
  __shared__ int sh[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long limit = pass == 0 ? n : live_points(totals0, sh);
  const long long start = (long long)blockIdx.x * kTileItems;
  if (start >= limit) return;  // the same for every thread of the block
  for (int w = 0; w < kWarps; w++) s_cnt[w][threadIdx.x] = 0;
  // the digit's base: the points of lower digits, then of earlier tiles
  s_glob[threadIdx.x] =
      block_exclusive_scan(totals[threadIdx.x], sh, nullptr) +
      hist[(long long)threadIdx.x * tiles + blockIdx.x];
  __syncthreads();
  const int shift = pass * kBits;
  const unsigned lower = (1u << lane) - 1;
  int key[kItems], pos[kItems];
#pragma unroll
  for (int r = 0; r < kItems; r++) {
    const long long p = start + (long long)(warp * kItems + r) * 32 + lane;
    key[r] = p < limit ? keys_in[p] : -1;
    const int digit = key[r] >= 0 ? (key[r] >> shift) & (kDigits - 1)
                                  : kDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    pos[r] = 0;
    if (digit < kDigits) pos[r] = s_cnt[warp][digit] + __popc(peers & lower);
    __syncwarp();
    if (digit < kDigits && (peers & lower) == 0)
      s_cnt[warp][digit] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  int mine = 0;  // the tile's points of digit threadIdx.x
  for (int w = 0; w < kWarps; w++) mine += s_cnt[w][threadIdx.x];
  int live;
  int run = block_exclusive_scan(mine, sh, &live);
  s_local[threadIdx.x] = run;
  for (int w = 0; w < kWarps; w++) {
    const int t = s_cnt[w][threadIdx.x];
    s_cnt[w][threadIdx.x] = run;
    run += t;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; r++) {
    if (key[r] < 0) continue;
    const long long p = start + (long long)(warp * kItems + r) * 32 + lane;
    const int at = s_cnt[warp][(key[r] >> shift) & (kDigits - 1)] + pos[r];
    s_keys[at] = key[r];
    s_vals[at] = pass == 0 ? (int)p : vals_in[p];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < live; i += kThreads) {
    const int k = s_keys[i];
    const int d = (k >> shift) & (kDigits - 1);
    const int dst = s_glob[d] + (i - s_local[d]);
    keys_out[dst] = k;
    vals_out[dst] = s_vals[i];
  }
}

// one thread per run of a row in the sorted order: the run's payloads
// added in index order, the row stored once
__global__ void sum_kernel(const float* __restrict__ feat, int C, bool vec,
                           const int32_t* __restrict__ keys,
                           const int32_t* __restrict__ vals,
                           float* __restrict__ out,
                           const int* __restrict__ totals0) {
  __shared__ int sh[kWarps];
  const long long n_live = live_points(totals0, sh);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_live; i += (long long)gridDim.x * blockDim.x) {
    const int row = keys[i];
    if (i > 0 && keys[i - 1] == row) continue;
    if (vec) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4* f4 = reinterpret_cast<const float4*>(feat);
      for (long long j = i; j < n_live; j += kUnroll) {
        float4 v[kUnroll];
        bool in[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; u++) {
          in[u] = j + u < n_live && keys[j + u] == row;
          if (in[u]) v[u] = __ldg(f4 + vals[j + u]);
        }
        bool more = true;
#pragma unroll
        for (int u = 0; u < kUnroll; u++) {
          more = more && in[u];
          if (more) {
            s.x += v[u].x;
            s.y += v[u].y;
            s.z += v[u].z;
            s.w += v[u].w;
          }
        }
        if (!more) break;
      }
      reinterpret_cast<float4*>(out)[row] = s;
    } else {
      for (int c = 0; c < C; c++) {
        float s = 0.f;
        for (long long j = i; j < n_live && keys[j] == row; j++)
          s += feat[(long long)vals[j] * C + c];
        out[(long long)row * C + c] = s;
      }
    }
  }
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // resident blocks for 132 SMs
  if (b > cap) b = cap;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace

extern "C" int scatter_add_f32(const void* feat, const void* pid, void* out,
                               long long n_points, int C, long long segments,
                               void* scratch, long long scratch_bytes,
                               void* stream) {
  if (n_points == 0 || C == 0 || segments <= 0) return 0;
  const AddLayout L(n_points, segments);
  if ((size_t)scratch_bytes < L.total || n_points >= (1LL << 31) ||
      segments >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // C = 4 rows 16-byte aligned go as float4 vectors, others lane by lane
  const bool vec = C == 4 && (uintptr_t)feat % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  int32_t* keys[2] = {reinterpret_cast<int32_t*>(base + L.keys1),
                      reinterpret_cast<int32_t*>(base + L.keys0)};
  int32_t* vals[2] = {reinterpret_cast<int32_t*>(base + L.vals1),
                      reinterpret_cast<int32_t*>(base + L.vals0)};
  int32_t* keys0 = reinterpret_cast<int32_t*>(base + L.keys0);
  int* hist = reinterpret_cast<int*>(base + L.hist);
  int* totals = reinterpret_cast<int*>(base + L.totals);
  const float* f = static_cast<const float*>(feat);
  for (int pass = 0; pass < L.passes; pass++) {
    int* h = hist + (size_t)pass * kDigits * L.tiles;
    int* tot = totals + pass * kDigits;
    // pass 0 reads keys0 (written by its upsweep); pass k reads what
    // pass k - 1 wrote: buffer (k - 1) % 2 of keys/vals
    const int32_t* kin = pass == 0 ? keys0 : keys[(pass - 1) % 2];
    const int32_t* vin = pass == 0 ? nullptr : vals[(pass - 1) % 2];
    upsweep_kernel<<<L.tiles, kThreads, 0, st>>>(
        f, static_cast<const int32_t*>(pid), C, vec, n_points, segments,
        pass == 0 ? nullptr : kin, keys0, h, L.tiles, totals, pass);
    scan_kernel<<<kDigits, kThreads, 0, st>>>(h, L.tiles, tot);
    downsweep_kernel<<<L.tiles, kThreads, 0, st>>>(
        kin, vin, keys[pass % 2], vals[pass % 2], h, L.tiles, tot, totals,
        n_points, pass);
  }
  const int last = (L.passes - 1) % 2;
  sum_kernel<<<blocks_for(n_points), kThreads, 0, st>>>(
      f, C, vec, keys[last], vals[last], static_cast<float*>(out), totals);
  return (int)cudaGetLastError();
}
