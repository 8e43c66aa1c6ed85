// Cell order: a stable counting sort of a window's points by grid cell,
// the helper of K4x (pip_lattice.cu). K4x folds a geometry's edges into a
// warp's points and skips an edge when no lane can be changed by it; that
// only pays when a warp's points lie close together, and a window's points
// arrive in stream order, spread over the whole grid. Sorting them by cell
// id (cx * n + cy) puts neighbouring points into one warp.
//
// Replaces no TPU kernel: the Pallas lattice (benchmarks/exp_pip_lattice.py)
// takes its points as they come. Plain PyTorch version:
// spatialflink_tpu_torch/ops/hopper_kernels.py cell_order_plain (a stable
// argsort of the same key).
//
// Key: cell for 0 <= cell < num_cells, num_cells otherwise (the -1 pad and
// out-of-grid points go last). Output: perm (the original index of each
// sorted position) and the coordinates gathered into sorted order, so that
// K4x reads its points coalesced and writes each distance back through perm.
//
// LSD radix sort, digits of at most 8 bits (two passes for a 100 x 100
// grid), carrying (key, index, x, y) through the passes. Each pass is
// three launches: a per-tile digit histogram, an exclusive scan of each
// digit's row over the tiles (one block per digit), and a stable
// scatter. In the scatter each warp ranks its
// own contiguous part of the tile in order, equal digits inside the warp
// with one ballot per digit bit and across warps with per-warp counters
// in shared memory, so equal keys keep their input order; the tile is placed in
// digit order in shared memory first, so that each digit's run is written
// at neighbouring addresses.
//
// What bounds it on an H100: bytes (read and write 16 bytes per point per
// pass: ~10 us per pass at 1M points) and, at a window's size, latency:
// every thread loads all of its items before it uses any.
//
// The same sort builds the join index of K6 and K7 (join_lattice.cu,
// join_reduce.cu; join_index_launch below): the b points of a window by
// (b tile, bucket), with the sorted keys written by the last pass. Its key
// is tile * stride + bucket, tile = i / tile_size, and the bucket 0 for a
// cell < 0, cell + 1 for a cell of the grid, cells + 1 for a cell >= cells
// and cells + 2 for an invalid point (stride = cells + 3; 0 when each
// tile is sorted on its own). Then, where the caller asks for it, the
// index's start table: for each key k, the first sorted position whose
// key is >= k (one binary search per entry). Plain PyTorch version:
// spatialflink_tpu_torch/ops/join.py join_index_plain.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                         // per thread, loaded at once
constexpr int kTileItems = kThreads * kItems;     // 4,096
constexpr int kSegment = kTileItems / kWarps;     // per warp: 256
constexpr int kRounds = kSegment / 32;            // per warp: 8 of 32 items
constexpr int kMaxDigits = 256;
constexpr int kScanThreads = 256;
constexpr int kNoDigit = -1;
// the scatter's dynamic shared memory: per-warp digit counters, the tile's
// digit starts, and the tile's (key, index, x, y) in digit order
constexpr size_t kScatterSmem =
    sizeof(int) * (kWarps * kMaxDigits + kMaxDigits + 4 * kTileItems);

// How the first pass forms an item's key from its cell: the cell order's
// rule (kJoin false: the rule's fields are not read, and the kernels
// compile as they did without them) or the join index's.
struct KeyRule {
  const uint8_t* valid;  // the join index's valid flags
  int tile;              // items per b tile
  int stride;            // keys per tile (0: one tile)
  int cells;             // the grid's cells
};

template <bool kJoin>
__device__ __forceinline__ int sort_key(const int32_t* __restrict__ cell,
                                        const int32_t* __restrict__ key_in,
                                        int i, int num_cells,
                                        const KeyRule& rule) {
  if (key_in != nullptr) return key_in[i];
  const int c = cell[i];
  if (!kJoin) return (c >= 0 && c < num_cells) ? c : num_cells;
  int bucket;
  if (rule.valid[i] == 0) {
    bucket = rule.cells + 2;
  } else if (c < 0) {
    bucket = 0;
  } else {
    bucket = c < rule.cells ? c + 1 : rule.cells + 1;
  }
  return (i / rule.tile) * rule.stride + bucket;
}

// Inclusive sum over the block of one int per thread; `warp_sums` is
// shared, 32 entries.
__device__ __forceinline__ int block_inclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  __syncthreads();  // warp_sums is free
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  return v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// The lanes of the warp whose digit equals this lane's (lanes without an
// item match only each other): one ballot per digit bit, which costs less
// than __match_any_sync.
__device__ __forceinline__ unsigned digit_peers(int d, int width) {
  const bool none = d == kNoDigit;
  unsigned peers = __ballot_sync(0xffffffffu, none);
  if (!none) peers = ~peers;
  for (int b = 0; b < width; ++b) {
    const bool bit = !none && ((d >> b) & 1);
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// counts[d * tiles + tile] = items of `tile` whose digit is d. Every
// thread loads its kItems keys before it counts them (the loads overlap).
template <bool kJoin>
__global__ void __launch_bounds__(kThreads)
order_hist_kernel(const int32_t* __restrict__ cell,
                  const int32_t* __restrict__ key_in, KeyRule rule, int n,
                  int num_cells, int shift, int digits,
                  int32_t* __restrict__ counts) {
  __shared__ int hist[kMaxDigits];
  for (int d = threadIdx.x; d < digits; d += kThreads) hist[d] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTileItems + threadIdx.x;
  int key[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = base + r * kThreads;
    key[r] = i < n ? sort_key<kJoin>(cell, key_in, i, num_cells, rule) : -1;
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (key[r] >= 0) atomicAdd(&hist[(key[r] >> shift) & (digits - 1)], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < digits; d += kThreads) {
    counts[static_cast<size_t>(d) * gridDim.x + blockIdx.x] = hist[d];
  }
}

// Row d of counts (one entry per tile) to its exclusive prefix over the
// tiles, in place, and its total to totals[d]: one block per digit.
__global__ void __launch_bounds__(kScanThreads)
order_scan_kernel(int32_t* __restrict__ counts, int tiles,
                  int32_t* __restrict__ totals) {
  __shared__ int warp_sums[32];
  int32_t* row = counts + static_cast<size_t>(blockIdx.x) * tiles;
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(tiles, static_cast<int>(threadIdx.x) * per);
  const int hi = min(tiles, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += row[i];
  const int incl = block_inclusive_sum(sum, warp_sums);
  int run = incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = row[i];
    row[i] = run;
    run += v;
  }
  if (threadIdx.x == kScanThreads - 1) totals[blockIdx.x] = incl;
}

// Stable scatter of one pass over one tile of (key, index, x, y). Each
// warp ranks its own kSegment consecutive items in order (equal digits
// inside the warp with digit_peers, across warps through per-warp
// counters), places them in digit order in shared memory, and the block
// then writes the tile's runs of each digit at neighbouring addresses,
// at the digit's start (the totals of the smaller digits) plus the tiles
// before this one. A non-final pass writes all four arrays; the final one
// index, x and y, and the keys when it is given somewhere to put them.
template <bool kJoin>
__global__ void __launch_bounds__(kThreads, 2)
order_scatter_kernel(const int32_t* __restrict__ cell,
                     const int32_t* __restrict__ key_in, KeyRule rule,
                     const int32_t* __restrict__ idx_in,
                     const float* __restrict__ x_in,
                     const float* __restrict__ y_in, int n, int num_cells,
                     int shift, int digits,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ totals,
                     int32_t* __restrict__ key_out,
                     int32_t* __restrict__ idx_out,
                     float* __restrict__ x_out, float* __restrict__ y_out) {
  extern __shared__ int smem[];
  int* wcount = smem;                               // [kWarps][kMaxDigits]
  int* start = wcount + kWarps * kMaxDigits;        // [kMaxDigits]
  __shared__ int base[kMaxDigits];  // the digit's first output position
  int* s_key = start + kMaxDigits;                  // [kTileItems] each
  int* s_idx = s_key + kTileItems;
  float* s_x = reinterpret_cast<float*>(s_idx + kTileItems);
  float* s_y = s_x + kTileItems;
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int j = threadIdx.x; j < kWarps * kMaxDigits; j += kThreads) {
    wcount[j] = 0;
  }
  const int tile0 = blockIdx.x * kTileItems;
  const int seg = tile0 + warp * kSegment + lane;
  int key[kRounds], d[kRounds], idx[kRounds];
  float px[kRounds], py[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = seg + r * 32;
    key[r] = 0;
    d[r] = kNoDigit;
    idx[r] = i;
    px[r] = 0.0f;
    py[r] = 0.0f;
    if (i < n) {
      key[r] = sort_key<kJoin>(cell, key_in, i, num_cells, rule);
      d[r] = (key[r] >> shift) & (digits - 1);
      if (idx_in != nullptr) idx[r] = idx_in[i];
      px[r] = x_in[i];
      py[r] = y_in[i];
    }
  }
  __syncthreads();
  // 1. this warp's digit counts
  const int width = __ffs(digits) - 1;
  unsigned peers[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    peers[r] = digit_peers(d[r], width);
    if (d[r] != kNoDigit && (peers[r] & lt) == 0) {
      wcount[warp * kMaxDigits + d[r]] += __popc(peers[r]);
    }
    __syncwarp();
  }
  __syncthreads();
  // 2. each digit's first output position, the tile's start of each
  // digit, then each warp's start in it
  const int t = threadIdx.x < digits ? totals[threadIdx.x] : 0;
  const int below = block_inclusive_sum(t, warp_sums) - t;
  if (threadIdx.x < digits) {
    base[threadIdx.x] =
        below + offsets[static_cast<size_t>(threadIdx.x) * gridDim.x +
                        blockIdx.x];
  }
  int total = 0;
  if (threadIdx.x < digits) {
    for (int w = 0; w < kWarps; ++w) total += wcount[w * kMaxDigits + threadIdx.x];
  }
  const int first = block_inclusive_sum(total, warp_sums) - total;
  if (threadIdx.x < digits) {
    start[threadIdx.x] = first;
    int run = first;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w * kMaxDigits + threadIdx.x];
      wcount[w * kMaxDigits + threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
  // 3. the tile in digit order, stable, in shared memory
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (d[r] != kNoDigit) {
      const int at = wcount[warp * kMaxDigits + d[r]] + __popc(peers[r] & lt);
      s_key[at] = key[r];
      s_idx[at] = idx[r];
      s_x[at] = px[r];
      s_y[at] = py[r];
    }
    __syncwarp();
    if (d[r] != kNoDigit && (peers[r] & lt) == 0) {
      wcount[warp * kMaxDigits + d[r]] += __popc(peers[r]);
    }
    __syncwarp();
  }
  __syncthreads();
  // 4. each digit's run to its place in the output, neighbours together
  const int items = min(kTileItems, n - tile0);
  for (int j = threadIdx.x; j < items; j += kThreads) {
    const int k = s_key[j];
    const int dj = (k >> shift) & (digits - 1);
    const int pos = base[dj] + (j - start[dj]);
    if (key_out != nullptr) key_out[pos] = k;
    idx_out[pos] = s_idx[j];
    x_out[pos] = s_x[j];
    y_out[pos] = s_y[j];
  }
}

// starts[k] = the first position of the sorted keys[0..n) whose key is
// >= k, for k < num.
__global__ void __launch_bounds__(kScanThreads)
join_starts_kernel(const int32_t* __restrict__ keys, int n,
                   int32_t* __restrict__ starts, int num) {
  const int k = blockIdx.x * kScanThreads + threadIdx.x;
  if (k >= num) return;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  starts[k] = lo;
}

// The passes of one sort: perm, sx, sy (and keys_out, the sorted keys,
// unless it is nullptr) from the items' keys under the cell order's rule
// or (kJoin) `rule`, all below num_cells + 1.
template <bool kJoin>
int order_passes(const int32_t* cell, const KeyRule& rule, int n,
                 int num_cells, const float* px, const float* py,
                 int32_t* perm, float* sx, float* sy, int32_t* keys_out,
                 int32_t* counts, int32_t* work, cudaStream_t s) {
  if (num_cells < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        order_scatter_kernel<kJoin>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kScatterSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  int bits = 1;
  while ((num_cells >> bits) != 0) ++bits;  // keys are 0..num_cells
  const int passes = (bits + 7) / 8;
  const int width = (bits + passes - 1) / passes;
  const int digits = 1 << width;
  const int tiles = (n + kTileItems - 1) / kTileItems;
  int32_t* totals = counts + static_cast<size_t>(tiles) * kMaxDigits;
  int32_t* keys = work;  // two key buffers, then index, x, y
  int32_t* idx_tmp = work + 2 * static_cast<size_t>(n);
  float* x_tmp = reinterpret_cast<float*>(idx_tmp + n);
  float* y_tmp = x_tmp + n;
  const int32_t* key_in = nullptr;
  const int32_t* idx_in = nullptr;
  const float* x_in = px;
  const float* y_in = py;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * width;
    const bool last = p == passes - 1;
    // the final pass writes perm, sx and sy, so the pass before it writes
    // the scratch copies
    const bool to_tmp = ((passes - 1 - p) & 1) != 0;
    int32_t* key_out = last ? keys_out : keys + static_cast<size_t>(p & 1) * n;
    int32_t* idx_out = to_tmp ? idx_tmp : perm;
    float* x_out = to_tmp ? x_tmp : sx;
    float* y_out = to_tmp ? y_tmp : sy;
    order_hist_kernel<kJoin><<<tiles, kThreads, 0, s>>>(
        cell, key_in, rule, n, num_cells, shift, digits, counts);
    order_scan_kernel<<<digits, kScanThreads, 0, s>>>(counts, tiles, totals);
    order_scatter_kernel<kJoin><<<tiles, kThreads, kScatterSmem, s>>>(
        cell, key_in, rule, idx_in, x_in, y_in, n, num_cells, shift, digits,
        counts, totals, key_out, idx_out, x_out, y_out);
    key_in = key_out;
    idx_in = idx_out;
    x_in = x_out;
    y_in = y_out;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch sizes (in int32) the wrapper allocates: counts holds
// cell_order_counts(n) entries (per-tile digit counts, then the digit
// totals), then 5 n for keys (2 n) and the index, x and y of the passes
// before the last.
extern "C" int cell_order_counts(int n) {
  const int tiles = (n + kTileItems - 1) / kTileItems;
  return ((tiles > 0 ? tiles : 1) + 1) * kMaxDigits;
}

// cell: (n,) int32 cell ids; px, py: (n,) f32. Writes perm (n,) int32 and
// sx, sy (n,) f32 in cell order. Scratch: counts (cell_order_counts(n),)
// and work (5 n,) int32. Launches on `stream`, does not synchronise,
// returns a CUDA error code (0 when every launch was accepted).
extern "C" int cell_order_launch(const int32_t* cell, int n, int num_cells,
                                 const float* px, const float* py,
                                 int32_t* perm, float* sx, float* sy,
                                 int32_t* counts, int32_t* work,
                                 void* stream) {
  return order_passes<false>(cell, KeyRule{nullptr, 1, 0, 0}, n, num_cells,
                             px, py, perm, sx, sy, nullptr, counts, work,
                             static_cast<cudaStream_t>(stream));
}

// The join index of n b points (see the note at the top): cell (n,) int32
// and valid (n,) bool of the points, cells the grid's cell count, tile the
// points per b tile, stride the keys per tile (cells + 3, or 0 for a
// single tile sorted on its own); every key lies below num_keys. Writes
// perm (n,) int32, sx, sy (n,) f32 and keys (n,) int32 in key order, and
// unless starts is nullptr the start table starts (num_starts,) int32.
// Scratch as cell_order_launch's. Launches on `stream`, does not
// synchronise, returns a CUDA error code.
extern "C" int join_index_launch(const int32_t* cell, const uint8_t* valid,
                                 int n, int cells, int tile, int stride,
                                 int num_keys, const float* px,
                                 const float* py, int32_t* perm, float* sx,
                                 float* sy, int32_t* keys, int32_t* starts,
                                 int num_starts, int32_t* counts,
                                 int32_t* work, void* stream) {
  if (valid == nullptr || keys == nullptr || cells < 1 || tile < 1 ||
      stride < 0 || num_starts < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = order_passes<true>(cell, KeyRule{valid, tile, stride, cells},
                                     n, num_keys, px, py, perm, sx, sy, keys,
                                     counts, work, s);
  if (err != 0 || starts == nullptr || num_starts == 0) return err;
  join_starts_kernel<<<(num_starts + kScanThreads - 1) / kScanThreads,
                       kScanThreads, 0, s>>>(keys, n, starts, num_starts);
  return static_cast<int>(cudaGetLastError());
}
