// K8: the trajectory kernels. K8a tstats_update (running spatial length,
// temporal length and speed of each trajectory over a batch, with carried
// per-object state), K8b tstats_window_summary (the same on fresh state,
// reduced to one row per object), K8c taggregate_group_extents (the
// batch grouped by (cell, object) with each group's [min_ts, max_ts]) and
// K8d taggregate_heatmap (per-cell SUM/AVG/MIN/MAX/COUNT of the group
// lengths).
//
// Replaces the XLA kernels of spatialflink_tpu/ops/trajectory.py:
// tstats_update (:88), tstats_window_summary (:192),
// taggregate_group_extents (:378, with taggregate_groups :401) and
// taggregate_heatmap (:433). Plain PyTorch versions:
// spatialflink_tpu_torch/ops/trajectory.py tstats_update_plain,
// tstats_window_summary_plain, taggregate_group_extents_plain and
// taggregate_heatmap_plain.
//
// The sort (K8a, K8b, K8c). The JAX package sorts the batch with
// jax.lax.sort, stable, by (object, ts) or by (cell, object). Here a key
// kernel packs each point's sort fields into one 64-bit key (K8a/K8b: the
// object id, or m for a padded slot, above ts with its sign bit flipped,
// so that unsigned order is (object, ts) order; K8c: the cell, or
// num_cells for a padded or out-of-grid slot, above the object id) and a
// stable LSD radix sort orders (key, original index): 8-bit digits, as
// many passes as the key has bits (48 for a 16,384-slot state). Each pass
// is the three launches of csrc/cell_order.cu's passes, generalised to
// 64-bit keys and an index payload: a per-tile digit histogram, an
// exclusive scan of each digit's row over the tiles, and a stable scatter
// in which each warp ranks its own part of the tile in order (one ballot
// per digit bit) and the tile is laid out in digit order in shared memory
// before its runs are written. K8c does not sort on ts: its groups and
// their order depend only on (cell, object).
//
// The runs (K8a, K8b). One thread per sorted position; the thread at the
// first position of an object's run walks the run in (ts) order and
// applies the JAX package's rules as it goes: a point is accepted when it
// is the first of its exact (object, ts) group and newer than the carried
// last_ts; an accepted point links to the previous accepted point of the
// run, or to the carried state for the run's first one (emitted only when
// that state was initialised); the running spatial and temporal lengths
// are sums over the run's contributions taken one by one in sorted order,
// added to the carried totals. The JAX package takes them as differences
// of one f32 cumsum over the whole batch, which loses up to tens of ms on
// a window's temporal lengths (PERF.md); a run's own sum is the function
// that cumsum approximates. The carried state of each object is read at
// its run's first point and written once, after its last: the update is
// in place. A padded slot's position gets (2^31 - 1, 0, 0, 0, false).
//
// The groups (K8c). The thread at the first position of each (cell,
// object) run walks it for the run's min and max ts and writes them over
// the run; the positions of padded and out-of-grid slots (the sentinel
// cell num_cells) take the min and max over all such slots, as the JAX
// package's segment_min / segment_max over its shared segment n - 1 do,
// reduced with integer atomics (exact, in any order).
//
// The heatmap (K8d). The groups arrive in (cell, object) order, K8c's
// output order, so each cell's groups are contiguous: the thread at a
// cell's first group walks them and writes the cell's value. Lengths are
// integer-valued f32, summed one by one in group order (exact below 2^24
// ms per cell, whatever the order).
//
// Every float sum has one fixed order (no float atomics), so the kernels
// and their plain versions agree bit for bit; built with --fmad=false,
// each operation rounds once, as the plain versions' separate PyTorch ops
// do.
//
// What bounds them on an H100: at a window's size (262,144 points), the
// sort's passes (each reads and writes 12 bytes per point) and launch
// latency; the walks are a few dependent loads per point (PERF.md has the
// times beside the bounds).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // per thread, loaded at once
constexpr int kTileItems = kThreads * kItems;  // 4,096
constexpr int kSegment = kTileItems / kWarps;  // per warp: 256
constexpr int kRounds = kSegment / 32;         // per warp: 8 of 32 items
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kScanThreads = 256;
constexpr int kWalkThreads = 256;
constexpr int kNoDigit = -1;
constexpr int32_t kIntMax = 2147483647;
constexpr int32_t kIntMin = -2147483647 - 1;
constexpr unsigned kAll = 0xffffffffu;
// the scatter's dynamic shared memory: per-warp digit counters, the tile's
// digit starts, and the tile's (key, index) in digit order
constexpr size_t kScatterSmem =
    sizeof(int) * (kWarps * kDigits + kDigits) +
    static_cast<size_t>(kTileItems) * (sizeof(u64) + sizeof(int));

__device__ __forceinline__ int digit_of(u64 key, int shift) {
  return static_cast<int>((key >> shift) & static_cast<u64>(kDigits - 1));
}

// Inclusive sum over the block of one int per thread; `warp_sums` is
// shared, 32 entries (cell_order.cu's).
__device__ __forceinline__ int block_inclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kAll, v, off);
    if (lane >= off) v += u;
  }
  __syncthreads();  // warp_sums is free
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kAll, w, off);
      if (lane >= off) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  return v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// The lanes of the warp whose digit equals this lane's (lanes without an
// item match only each other): one ballot per digit bit.
__device__ __forceinline__ unsigned digit_peers(int d) {
  const bool none = d == kNoDigit;
  unsigned peers = __ballot_sync(kAll, none);
  if (!none) peers = ~peers;
#pragma unroll
  for (int b = 0; b < kDigitBits; ++b) {
    const bool bit = !none && ((d >> b) & 1);
    const unsigned set = __ballot_sync(kAll, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// counts[d * tiles + tile] = items of `tile` whose digit is d.
__global__ void __launch_bounds__(kThreads)
sort_hist_kernel(const u64* __restrict__ keys, int n, int shift,
                 int32_t* __restrict__ counts) {
  __shared__ int hist[kDigits];
  for (int d = threadIdx.x; d < kDigits; d += kThreads) hist[d] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTileItems + threadIdx.x;
  int dig[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = base + r * kThreads;
    dig[r] = i < n ? digit_of(keys[i], shift) : kNoDigit;
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (dig[r] != kNoDigit) atomicAdd(&hist[dig[r]], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kDigits; d += kThreads) {
    counts[static_cast<size_t>(d) * gridDim.x + blockIdx.x] = hist[d];
  }
}

// Row d of counts (one entry per tile) to its exclusive prefix over the
// tiles, in place, and its total to totals[d]: one block per digit.
__global__ void __launch_bounds__(kScanThreads)
sort_scan_kernel(int32_t* __restrict__ counts, int tiles,
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

// Stable scatter of one pass over one tile of (key, index): each warp
// ranks its own kSegment consecutive items in order (equal digits inside
// the warp with digit_peers, across warps through per-warp counters),
// places them in digit order in shared memory, and the block writes the
// tile's runs of each digit at neighbouring addresses. idx_in nullptr: the
// first pass, whose index is the position itself.
__global__ void __launch_bounds__(kThreads, 2)
sort_scatter_kernel(const u64* __restrict__ key_in,
                    const int32_t* __restrict__ idx_in, int n, int shift,
                    const int32_t* __restrict__ offsets,
                    const int32_t* __restrict__ totals,
                    u64* __restrict__ key_out, int32_t* __restrict__ idx_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* wcount = reinterpret_cast<int*>(smem_raw);  // [kWarps][kDigits]
  int* start = wcount + kWarps * kDigits;          // [kDigits]
  u64* s_key = reinterpret_cast<u64*>(start + kDigits);
  int* s_idx = reinterpret_cast<int*>(s_key + kTileItems);
  __shared__ int base[kDigits];  // the digit's first output position
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int j = threadIdx.x; j < kWarps * kDigits; j += kThreads) {
    wcount[j] = 0;
  }
  const int tile0 = blockIdx.x * kTileItems;
  const int seg = tile0 + warp * kSegment + lane;
  u64 key[kRounds];
  int d[kRounds], idx[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = seg + r * 32;
    key[r] = 0ull;
    d[r] = kNoDigit;
    idx[r] = i;
    if (i < n) {
      key[r] = key_in[i];
      d[r] = digit_of(key[r], shift);
      if (idx_in != nullptr) idx[r] = idx_in[i];
    }
  }
  __syncthreads();
  // 1. this warp's digit counts
  unsigned peers[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    peers[r] = digit_peers(d[r]);
    if (d[r] != kNoDigit && (peers[r] & lt) == 0) {
      wcount[warp * kDigits + d[r]] += __popc(peers[r]);
    }
    __syncwarp();
  }
  __syncthreads();
  // 2. each digit's first output position, the tile's start of each digit,
  // then each warp's start in it
  const int t = threadIdx.x < kDigits ? totals[threadIdx.x] : 0;
  const int below = block_inclusive_sum(t, warp_sums) - t;
  if (threadIdx.x < kDigits) {
    base[threadIdx.x] =
        below + offsets[static_cast<size_t>(threadIdx.x) * gridDim.x +
                        blockIdx.x];
  }
  int total = 0;
  if (threadIdx.x < kDigits) {
    for (int w = 0; w < kWarps; ++w) total += wcount[w * kDigits + threadIdx.x];
  }
  const int first = block_inclusive_sum(total, warp_sums) - total;
  if (threadIdx.x < kDigits) {
    start[threadIdx.x] = first;
    int run = first;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w * kDigits + threadIdx.x];
      wcount[w * kDigits + threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
  // 3. the tile in digit order, stable, in shared memory
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (d[r] != kNoDigit) {
      const int at = wcount[warp * kDigits + d[r]] + __popc(peers[r] & lt);
      s_key[at] = key[r];
      s_idx[at] = idx[r];
    }
    __syncwarp();
    if (d[r] != kNoDigit && (peers[r] & lt) == 0) {
      wcount[warp * kDigits + d[r]] += __popc(peers[r]);
    }
    __syncwarp();
  }
  __syncthreads();
  // 4. each digit's run to its place in the output, neighbours together
  const int items = min(kTileItems, n - tile0);
  for (int j = threadIdx.x; j < items; j += kThreads) {
    const u64 k = s_key[j];
    const int dj = digit_of(k, shift);
    const int pos = base[dj] + (j - start[dj]);
    key_out[pos] = k;
    idx_out[pos] = s_idx[j];
  }
}

int bit_length(long long v) {
  int b = 0;
  while (b < 63 && (v >> b) != 0) ++b;
  return b;
}

// The scratch of one sort of n keys, carved from one byte buffer: the
// keys as formed, the sorted keys and their ping-pong copy, the index's
// ping-pong copy and the sorted order (for the kernels whose order is not
// an output), and the per-tile digit counts with the digit totals.
struct Scratch {
  u64* key_in;
  u64* key_out;
  u64* key_tmp;
  int32_t* idx_tmp;
  int32_t* perm;
  int32_t* counts;
  int32_t* extra;  // two ints: K8c's sentinel min and max
};

size_t tiles_of(int n) {
  return static_cast<size_t>((n + kTileItems - 1) / kTileItems);
}

size_t scratch_bytes(int n) {
  const size_t nn = static_cast<size_t>(n > 0 ? n : 1);
  return 3 * nn * sizeof(u64) + 2 * nn * sizeof(int32_t) +
         (tiles_of(n > 0 ? n : 1) + 1) * kDigits * sizeof(int32_t) +
         2 * sizeof(int32_t);
}

Scratch carve(void* base, int n) {
  const size_t nn = static_cast<size_t>(n > 0 ? n : 1);
  Scratch s;
  s.key_in = static_cast<u64*>(base);
  s.key_out = s.key_in + nn;
  s.key_tmp = s.key_out + nn;
  s.idx_tmp = reinterpret_cast<int32_t*>(s.key_tmp + nn);
  s.perm = s.idx_tmp + nn;
  s.counts = s.perm + nn;
  s.extra = s.counts + (tiles_of(n > 0 ? n : 1) + 1) * kDigits;
  return s;
}

// Stable LSD sort of sc.key_in[0..n) on its low `bits` bits: the sorted
// keys to sc.key_out, the original index of each sorted position to perm.
cudaError_t sort_keys(const Scratch& sc, int n, int bits, int32_t* perm,
                      cudaStream_t s) {
  if (n == 0) return cudaSuccess;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kScatterSmem));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int passes = bits < 1 ? 1 : (bits + kDigitBits - 1) / kDigitBits;
  const int tiles = static_cast<int>(tiles_of(n));
  int32_t* totals = sc.counts + static_cast<size_t>(tiles) * kDigits;
  const u64* kin = sc.key_in;
  const int32_t* iin = nullptr;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * kDigitBits;
    // the final pass writes key_out and perm, so the pass before it writes
    // the scratch copies
    const bool to_tmp = ((passes - 1 - p) & 1) != 0;
    u64* kout = to_tmp ? sc.key_tmp : sc.key_out;
    int32_t* iout = to_tmp ? sc.idx_tmp : perm;
    sort_hist_kernel<<<tiles, kThreads, 0, s>>>(kin, n, shift, sc.counts);
    sort_scan_kernel<<<kDigits, kScanThreads, 0, s>>>(sc.counts, tiles,
                                                       totals);
    sort_scatter_kernel<<<tiles, kThreads, kScatterSmem, s>>>(
        kin, iin, n, shift, sc.counts, totals, kout, iout);
    kin = kout;
    iin = iout;
  }
  return cudaGetLastError();
}

int blocks_of(int n, int threads) { return (n + threads - 1) / threads; }

// K8a/K8b key: (object, or m for a padded slot) above ts with its sign
// bit flipped.
__global__ void tstats_key_kernel(const int32_t* __restrict__ oid,
                                  const int32_t* __restrict__ ts,
                                  const uint8_t* __restrict__ valid, int n,
                                  int m, u64* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t hi = valid[i] != 0 ? static_cast<uint32_t>(oid[i])
                                    : static_cast<uint32_t>(m);
  const uint32_t lo = static_cast<uint32_t>(ts[i]) ^ 0x80000000u;
  keys[i] = (static_cast<u64>(hi) << 32) | lo;
}

__device__ __forceinline__ int key_ts(u64 key) {
  return static_cast<int>(static_cast<uint32_t>(key) ^ 0x80000000u);
}

__device__ __forceinline__ float pp_dist(float x1, float y1, float x2,
                                         float y2) {
  const float dx = x2 - x1;
  const float dy = y2 - y1;
  return sqrtf(dx * dx + dy * dy);
}

// K8a: one thread per sorted position; a run's first position walks it.
__global__ void __launch_bounds__(kWalkThreads)
tstats_walk_kernel(const u64* __restrict__ skey,
                   const int32_t* __restrict__ perm, int n, int m,
                   const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ last_x, float* __restrict__ last_y,
                   int32_t* __restrict__ last_ts,
                   float* __restrict__ spatial, float* __restrict__ temporal,
                   int32_t* __restrict__ out_oid, float* __restrict__ out_sp,
                   float* __restrict__ out_tm, float* __restrict__ out_speed,
                   uint8_t* __restrict__ out_emit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u64 key = skey[i];
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  if (o >= static_cast<uint32_t>(m)) {  // a padded slot
    out_oid[i] = kIntMax;
    out_sp[i] = 0.0f;
    out_tm[i] = 0.0f;
    out_speed[i] = 0.0f;
    out_emit[i] = 0;
    return;
  }
  if (i > 0 && static_cast<uint32_t>(skey[i - 1] >> 32) == o) return;
  const int st_ts = last_ts[o];
  const bool init = st_ts != kIntMin;
  const float sx = last_x[o], sy = last_y[o];
  const float base_sp = spatial[o], base_tm = temporal[o];
  bool have = false;  // an accepted point of this run so far
  float ax = 0.0f, ay = 0.0f;
  int ats = 0;
  float rd = 0.0f, rt = 0.0f;
  int prev_ts = 0;
  for (int j = i; j < n; ++j) {
    const u64 kj = skey[j];
    if (static_cast<uint32_t>(kj >> 32) != o) break;
    const int ts = key_ts(kj);
    const int p = perm[j];
    const float px = x[p], py = y[p];
    const bool tie = j > i && ts == prev_ts;
    prev_ts = ts;
    const bool acc = !tie && ts > st_ts;
    bool emit = false;
    float cd = 0.0f, ct = 0.0f;
    if (acc) {
      const bool linked = have || init;
      if (linked) {
        const float lx = have ? ax : sx;
        const float ly = have ? ay : sy;
        const int lts = have ? ats : st_ts;
        emit = true;
        cd = pp_dist(lx, ly, px, py);
        ct = static_cast<float>(ts - lts);
      }
      have = true;
      ax = px;
      ay = py;
      ats = ts;
    }
    rd = rd + cd;
    rt = rt + ct;
    const float osp = base_sp + rd;
    const float otm = base_tm + rt;
    out_oid[j] = static_cast<int32_t>(o);
    out_sp[j] = osp;
    out_tm[j] = otm;
    out_speed[j] = otm > 0.0f ? osp / otm : 0.0f;
    out_emit[j] = emit ? 1 : 0;
  }
  if (have) {
    last_x[o] = ax;
    last_y[o] = ay;
    last_ts[o] = ats;
    spatial[o] = base_sp + rd;
    temporal[o] = base_tm + rt;
  }
}

// K8b: the summary rows of the objects absent from the batch.
__global__ void summary_init_kernel(int m, float* __restrict__ spatial,
                                    int32_t* __restrict__ count,
                                    int32_t* __restrict__ min_ts,
                                    int32_t* __restrict__ max_ts,
                                    float* __restrict__ fx,
                                    float* __restrict__ fy,
                                    float* __restrict__ lx,
                                    float* __restrict__ ly) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= m) return;
  spatial[o] = 0.0f;
  count[o] = 0;
  min_ts[o] = kIntMax;
  max_ts[o] = kIntMin;
  fx[o] = 0.0f;
  fy[o] = 0.0f;
  lx[o] = 0.0f;
  ly[o] = 0.0f;
}

// K8b: the first position of each object's run walks it on fresh state.
__global__ void __launch_bounds__(kWalkThreads)
summary_walk_kernel(const u64* __restrict__ skey,
                    const int32_t* __restrict__ perm, int n, int m,
                    const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ spatial, int32_t* __restrict__ count,
                    int32_t* __restrict__ min_ts,
                    int32_t* __restrict__ max_ts, float* __restrict__ fx,
                    float* __restrict__ fy, float* __restrict__ lx,
                    float* __restrict__ ly) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u64 key = skey[i];
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  if (o >= static_cast<uint32_t>(m)) return;  // a padded slot
  if (i > 0 && static_cast<uint32_t>(skey[i - 1] >> 32) == o) return;
  float sum = 0.0f;
  int cnt = 0;
  float ax = 0.0f, ay = 0.0f, bx = 0.0f, by = 0.0f;
  int first_ts = 0, ats = 0;
  int prev_ts = 0;
  for (int j = i; j < n; ++j) {
    const u64 kj = skey[j];
    if (static_cast<uint32_t>(kj >> 32) != o) break;
    const int ts = key_ts(kj);
    const bool tie = j > i && ts == prev_ts;
    prev_ts = ts;
    if (tie) continue;
    const int p = perm[j];
    const float px = x[p], py = y[p];
    const float cd = cnt > 0 ? pp_dist(ax, ay, px, py) : 0.0f;
    sum = sum + cd;
    if (cnt == 0) {
      bx = px;
      by = py;
      first_ts = ts;
    }
    ++cnt;
    ax = px;
    ay = py;
    ats = ts;
  }
  spatial[o] = sum;
  count[o] = cnt;
  min_ts[o] = first_ts;
  max_ts[o] = ats;
  fx[o] = bx;
  fy[o] = by;
  lx[o] = ax;
  ly[o] = ay;
}

// K8c key: (cell, or num_cells for a padded or out-of-grid slot) above the
// object id (0 for such a slot).
__global__ void group_key_kernel(const int32_t* __restrict__ cell,
                                 const int32_t* __restrict__ oid,
                                 const uint8_t* __restrict__ valid, int n,
                                 int num_cells, int oid_bits,
                                 u64* __restrict__ keys,
                                 int32_t* __restrict__ sentinel) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    sentinel[0] = kIntMax;
    sentinel[1] = kIntMin;
  }
  if (i >= n) return;
  const int c = cell[i];
  const bool ok = valid[i] != 0 && c >= 0;
  const uint32_t hi = ok ? static_cast<uint32_t>(min(c, num_cells))
                         : static_cast<uint32_t>(num_cells);
  const uint32_t lo = ok ? static_cast<uint32_t>(oid[i]) : 0u;
  keys[i] = (static_cast<u64>(hi) << oid_bits) | lo;
}

// K8c: the first position of each (cell, object) run walks it; positions
// of the sentinel cell reduce their ts into sentinel[0..1].
__global__ void __launch_bounds__(kWalkThreads)
group_walk_kernel(const u64* __restrict__ skey,
                  const int32_t* __restrict__ perm, int n, int num_cells,
                  int oid_bits, const int32_t* __restrict__ ts,
                  int32_t* __restrict__ sentinel,
                  int32_t* __restrict__ out_cell,
                  int32_t* __restrict__ out_oid,
                  int32_t* __restrict__ out_min,
                  int32_t* __restrict__ out_max,
                  uint8_t* __restrict__ out_first) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const u64 key = in ? skey[i] : 0ull;
  const int c = static_cast<int>(key >> oid_bits);
  const bool sent = in && c >= num_cells;
  const int t = sent ? ts[perm[i]] : 0;
  // every lane of the warp takes part in the reductions
  const int wmin = __reduce_min_sync(kAll, sent ? t : kIntMax);
  const int wmax = __reduce_max_sync(kAll, sent ? t : kIntMin);
  if (__any_sync(kAll, sent) && (threadIdx.x & 31) == 0) {
    atomicMin(&sentinel[0], wmin);
    atomicMax(&sentinel[1], wmax);
  }
  if (!in || sent) return;
  if (i > 0 && skey[i - 1] == key) return;
  int mn = kIntMax, mx = kIntMin;
  int j = i;
  for (; j < n && skey[j] == key; ++j) {
    const int v = ts[perm[j]];
    mn = min(mn, v);
    mx = max(mx, v);
  }
  const int32_t o = static_cast<int32_t>(
      key & ((static_cast<u64>(1) << oid_bits) - 1ull));
  for (int q = i; q < j; ++q) {
    out_cell[q] = c;
    out_oid[q] = o;
    out_min[q] = mn;
    out_max[q] = mx;
    out_first[q] = q == i ? 1 : 0;
  }
}

// K8c: the positions of the sentinel cell.
__global__ void group_sentinel_kernel(const u64* __restrict__ skey, int n,
                                      int num_cells, int oid_bits,
                                      const int32_t* __restrict__ sentinel,
                                      int32_t* __restrict__ out_cell,
                                      int32_t* __restrict__ out_oid,
                                      int32_t* __restrict__ out_min,
                                      int32_t* __restrict__ out_max,
                                      uint8_t* __restrict__ out_first) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (static_cast<int>(skey[i] >> oid_bits) < num_cells) return;
  out_cell[i] = num_cells;
  out_oid[i] = kIntMax;
  out_min[i] = sentinel[0];
  out_max[i] = sentinel[1];
  out_first[i] = 0;
}

__global__ void zero_kernel(int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 0.0f;
}

// K8d: the first group of each cell walks the cell's groups.
// agg: 0 SUM, 1 AVG, 2 MIN, 3 MAX, 4 COUNT.
__global__ void __launch_bounds__(kWalkThreads)
heatmap_walk_kernel(const int32_t* __restrict__ cell,
                    const int32_t* __restrict__ length,
                    const uint8_t* __restrict__ first, int n, int num_cells,
                    int agg, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || first[i] == 0) return;
  const int c = cell[i];
  if (c < 0 || c >= num_cells) return;
  if (i > 0 && cell[i - 1] == c) return;  // not the cell's first group
  float total = 0.0f, cnt = 0.0f;
  float lo = 0.0f, hi = 0.0f;
  bool any = false;
  for (int j = i; j < n && cell[j] == c; ++j) {
    if (first[j] == 0) continue;
    const float v = static_cast<float>(length[j]);
    total = total + v;
    cnt = cnt + 1.0f;
    lo = (!any || v < lo) ? v : lo;
    hi = (!any || v > hi) ? v : hi;
    any = true;
  }
  float r;
  switch (agg) {
    case 0: r = total; break;
    case 1: r = total / cnt; break;
    case 2: r = lo; break;
    case 3: r = hi; break;
    default: r = cnt; break;
  }
  out[c] = r;
}

}  // namespace

// Bytes of the scratch buffer the K8a, K8b and K8c launches take for n
// points.
extern "C" long long traj_scratch_bytes(int n) {
  return static_cast<long long>(scratch_bytes(n));
}

// K8a. Batch: x, y (n,) f32, oid, ts (n,) int32, valid (n,) bool, every
// valid oid in [0, m). State (m,): last_x, last_y, last_ts (int32, INT_MIN
// = uninitialised), spatial, temporal, updated in place. Writes, in sorted
// (object, ts) order: out_oid (n,) int32, out_sp, out_tm, out_speed (n,)
// f32, out_emit (n,) bool, order (n,) int32 (the batch position of each).
// Launches on `stream`, does not synchronise, returns a CUDA error code.
extern "C" int tstats_update_launch(
    const float* x, const float* y, const int32_t* oid, const int32_t* ts,
    const uint8_t* valid, int n, int m, float* last_x, float* last_y,
    int32_t* last_ts, float* spatial, float* temporal, int32_t* out_oid,
    float* out_sp, float* out_tm, float* out_speed, uint8_t* out_emit,
    int32_t* order, void* scratch, void* stream) {
  if (n < 0 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const Scratch sc = carve(scratch, n);
  tstats_key_kernel<<<blocks_of(n, 256), 256, 0, s>>>(oid, ts, valid, n, m,
                                                       sc.key_in);
  const cudaError_t err = sort_keys(sc, n, 32 + bit_length(m), order, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tstats_walk_kernel<<<blocks_of(n, kWalkThreads), kWalkThreads, 0, s>>>(
      sc.key_out, order, n, m, x, y, last_x, last_y, last_ts, spatial,
      temporal, out_oid, out_sp, out_tm, out_speed, out_emit);
  return static_cast<int>(cudaGetLastError());
}

// K8b. Batch as K8a's; writes the (m,) summary: spatial f32, count int32,
// min_ts, max_ts int32 (INT_MAX / INT_MIN for an absent object), first_x,
// first_y, last_x, last_y f32 (0 when absent).
extern "C" int tstats_summary_launch(
    const float* x, const float* y, const int32_t* oid, const int32_t* ts,
    const uint8_t* valid, int n, int m, float* spatial, int32_t* count,
    int32_t* min_ts, int32_t* max_ts, float* fx, float* fy, float* lx,
    float* ly, void* scratch, void* stream) {
  if (n < 0 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  summary_init_kernel<<<blocks_of(m, 256), 256, 0, s>>>(
      m, spatial, count, min_ts, max_ts, fx, fy, lx, ly);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const Scratch sc = carve(scratch, n);
  tstats_key_kernel<<<blocks_of(n, 256), 256, 0, s>>>(oid, ts, valid, n, m,
                                                       sc.key_in);
  const cudaError_t err = sort_keys(sc, n, 32 + bit_length(m), sc.perm, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  summary_walk_kernel<<<blocks_of(n, kWalkThreads), kWalkThreads, 0, s>>>(
      sc.key_out, sc.perm, n, m, x, y, spatial, count, min_ts, max_ts, fx,
      fy, lx, ly);
  return static_cast<int>(cudaGetLastError());
}

// K8c. Batch: cell, oid, ts (n,) int32, valid (n,) bool, every valid oid
// in [0, 2^oid_bits). Writes, in sorted (cell, object) order: out_cell
// (num_cells for a padded or out-of-grid slot), out_oid (2^31 - 1 there),
// out_min, out_max (the group's ts extent) (n,) int32 and out_first (n,)
// bool (the group's first position, never in the sentinel cell).
extern "C" int taggregate_extents_launch(
    const int32_t* cell, const int32_t* oid, const int32_t* ts,
    const uint8_t* valid, int n, int num_cells, int oid_bits,
    int32_t* out_cell, int32_t* out_oid, int32_t* out_min, int32_t* out_max,
    uint8_t* out_first, void* scratch, void* stream) {
  if (n < 0 || num_cells < 1 || oid_bits < 1 || oid_bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const Scratch sc = carve(scratch, n);
  group_key_kernel<<<blocks_of(n, 256), 256, 0, s>>>(
      cell, oid, valid, n, num_cells, oid_bits, sc.key_in, sc.extra);
  const cudaError_t err =
      sort_keys(sc, n, oid_bits + bit_length(num_cells), sc.perm, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_walk_kernel<<<blocks_of(n, kWalkThreads), kWalkThreads, 0, s>>>(
      sc.key_out, sc.perm, n, num_cells, oid_bits, ts, sc.extra, out_cell,
      out_oid, out_min, out_max, out_first);
  group_sentinel_kernel<<<blocks_of(n, 256), 256, 0, s>>>(
      sc.key_out, n, num_cells, oid_bits, sc.extra, out_cell, out_oid,
      out_min, out_max, out_first);
  return static_cast<int>(cudaGetLastError());
}

// K8d. Groups as K8c writes them (cell-sorted): cell, length (n,) int32,
// first (n,) bool. Writes out (num_cells,) f32: agg 0 SUM, 1 AVG, 2 MIN,
// 3 MAX, 4 COUNT of each cell's group lengths (0 for a cell without a
// group).
extern "C" int taggregate_heatmap_launch(const int32_t* cell,
                                         const int32_t* length,
                                         const uint8_t* first, int n,
                                         int num_cells, int agg, float* out,
                                         void* stream) {
  if (n < 0 || num_cells < 1 || agg < 0 || agg > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  zero_kernel<<<blocks_of(num_cells, 256), 256, 0, s>>>(num_cells, out);
  if (n > 0) {
    heatmap_walk_kernel<<<blocks_of(n, kWalkThreads), kWalkThreads, 0, s>>>(
        cell, length, first, n, num_cells, agg, out);
  }
  return static_cast<int>(cudaGetLastError());
}
