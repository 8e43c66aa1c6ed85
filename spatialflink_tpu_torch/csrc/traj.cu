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
// jax.lax.sort, stable, by (object, ts) or by (cell, object). Here each
// point's sort fields are packed into one unsigned key as wide as the
// batch's own fields, and a stable LSD radix sort of 8-bit digits orders
// (key, payload). K8a and K8b: the object (m for a padded slot) in
// bit_length(m) bits above ts - ts_lo in bit_length(ts_hi - ts_lo) bits,
// where [ts_lo, ts_hi] holds the ts of every slot, padded ones too (the
// walks add ts_lo back); K8c: the cell (num_cells for a padded or
// out-of-grid slot) above the object id (0 there) in oid_bits bits, with
// ts as the payload instead of the index (K8c's outputs do not depend on
// the order inside a (cell, object) group). A key of at most 32 bits is a
// 32-bit word (the main path's: 29 bits at a 10 s window of 10,357 taxis
// in a 16,384-slot state, 28 for K8c over 10,000 cells), else 64 bits.
// Then one of two paths, which the wrapper picks from n:
//  - one block (n <= kOneBlockMax, every realtime cut): ONE launch forms
//    the keys, runs every pass in shared memory (each warp ranks its own
//    part in order, one ballot per digit bit) and walks the runs there;
//  - tiled: one launch forms the keys and counts every pass's digits per
//    tile of kTileItems in one read of the inputs, and clears the
//    look-back state; then one launch per pass, in which each tile
//    publishes its count of each digit and takes the digit's count over
//    the earlier tiles by look-back, reading all their published counts
//    at once rather than a chain of prefixes, ranks its items as above
//    and writes each digit's run at neighbouring addresses through shared
//    memory; then the walk. The first pass, its tiles still in input
//    order, reads its offsets from the key launch's counts instead, and
//    sums every later pass's digit totals from them (a total over the
//    batch does not depend on the order). Tiles of the later passes take
//    their numbers from an atomic counter, so every tile a block waits on
//    was numbered by a block that started before it and publishes without
//    waiting. K8a at a 10 s window, K8b at a 5 s pane: 1 + 4 + 1 = 6.
// Either way the result is stable and deterministic.

// The runs (K8a, K8b). The thread at the first position of an object's
// run walks the run in (ts) order and applies the JAX package's rules as
// it goes. K8a: a point is accepted when it is the first of its exact
// (object, ts) group and newer than the carried last_ts; an accepted point
// links to the previous accepted point of the run, or to the carried state
// for the run's first one (emitted only when that state was initialised);
// the running spatial and temporal lengths are sums over the run's
// contributions taken one by one in sorted order, added to the carried
// totals. The JAX package takes them as differences of one f32 cumsum over
// the whole batch, which loses up to tens of ms on a window's temporal
// lengths (PERF.md); a run's own sum is the function that cumsum
// approximates. The carried state of each object is read at its run's
// first point and written once, after its last: the update is in place. A
// padded slot's position gets (2^31 - 1, 0, 0, 0, false). K8b: the same
// walk on fresh state, reduced to the object's row (pair sum, count, ts
// extent, first and last point). The rows of the objects the batch lacks
// are written by the tiled path's key launch (a grid-stride loop over m,
// before the walk in stream order), and in the one-block launch by the
// grid's other blocks, kInitRows rows each, skipping the objects the batch
// holds (a bit each in shared memory), while the first block sorts and
// walks. The tiled walks pack the runs that start in a block onto its
// first threads, so that the walks share warps, and stage the block's
// points (and K8a's outputs) in shared memory.
//
// The groups (K8c). Each position writes its cell, object and first flag;
// the thread at the first position of each (cell, object) run walks it
// for the run's min and max ts and writes them over the run; the
// positions of padded and out-of-grid slots (the sentinel cell num_cells)
// take the min and max over all such slots, as the JAX package's
// segment_min / segment_max over its shared segment n - 1 do: reduced in
// shared memory in the one-block path, per tile by the key launch and over
// the tiles by the walk in the tiled one (integers: exact in any order).

// The heatmap (K8d). One launch, one warp per cell. The groups arrive in
// K8c's order, cell ascending, so the warp finds its cell's first position
// by a 32-way search (one load per lane and a ballot per level), then reads
// the cell's positions 32 at a time, coalesced, until the cell ends: every
// cell written once, 0 without a group, so nothing else zeroes the output.
// SUM and AVG add the lengths (integer-valued f32) one by one in group
// order, so they equal the plain version's sequential f32 sums even above
// 2^24 ms per cell; COUNT is the group count as that sequential f32 count
// rounds it (it stops at 2^24); MIN and MAX reduce the integer lengths in
// any order (the conversion to f32 is monotone).
//
// Every float sum has one fixed order (no float atomics), so the kernels
// and their plain versions agree bit for bit; built with --fmad=false,
// each operation rounds once, as the plain versions' separate PyTorch ops
// do.
//
// What bounds them on an H100: at a window's size (262,144 points), the
// sort's passes (each reads and writes 8 bytes per point, which fit in
// the 50 MB L2) and the launches; at a realtime cut (512 points), the one
// launch and its latency; the walks are a few dependent loads per point,
// K8d a few per cell (PERF.md has the times beside the bounds).
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
constexpr int kWalkThreads = 256;
constexpr int kNoDigit = -1;
constexpr int32_t kIntMax = 2147483647;
constexpr int32_t kIntMin = -2147483647 - 1;
constexpr unsigned kAll = 0xffffffffu;

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

int bit_length(long long v) {
  int b = 0;
  while (b < 63 && (v >> b) != 0) ++b;
  return b;
}

size_t tiles_of(int n) {
  return static_cast<size_t>((n + kTileItems - 1) / kTileItems);
}

int blocks_of(int n, int threads) { return (n + threads - 1) / threads; }

__device__ __forceinline__ float pp_dist(float x1, float y1, float x2,
                                         float y2) {
  const float dx = x2 - x1;
  const float dy = y2 - y1;
  return sqrtf(dx * dx + dy * dy);
}

// K8b's (m,) summary rows.
struct Summary {
  float* spatial;
  int32_t* count;
  int32_t* min_ts;
  int32_t* max_ts;
  float* fx;
  float* fy;
  float* lx;
  float* ly;

  // an object the batch does not hold
  __device__ __forceinline__ void absent(int o) const {
    spatial[o] = 0.0f;
    count[o] = 0;
    min_ts[o] = kIntMax;
    max_ts[o] = kIntMin;
    fx[o] = 0.0f;
    fy[o] = 0.0f;
    lx[o] = 0.0f;
    ly[o] = 0.0f;
  }
};

// K8d: one warp per cell. agg: 0 SUM, 1 AVG, 2 MIN, 3 MAX, 4 COUNT.
constexpr int kHeatWarps = 8;             // cells per block
constexpr int kHeatAhead = 4;             // chunks of 32 read at once
constexpr int kCountStop = 1 << 24;       // a sequential f32 count of ones
constexpr int kSum = 0, kAvg = 1, kMin = 2, kMax = 3;

__global__ void __launch_bounds__(kHeatWarps * 32)
heatmap_kernel(const int32_t* __restrict__ cell,
               const int32_t* __restrict__ length,
               const uint8_t* __restrict__ first, int n, int num_cells,
               int agg, float* __restrict__ out) {
  __shared__ float s_len[kHeatWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kHeatWarps + warp;
  if (c >= num_cells) return;  // the whole warp
  const unsigned lt = (1u << lane) - 1u;
  // the cell's first position: the first whose cell is >= c; the answer
  // stays in [lo, hi], which each level cuts to one of 32 steps
  int lo = 0, hi = n;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const long long q = lo + static_cast<long long>(lane + 1) * step - 1;
    const bool below = q < hi && __ldg(cell + q) < c;
    const long long k = __popc(__ballot_sync(kAll, below));
    hi = static_cast<int>(min(static_cast<long long>(hi),
                              lo + (k + 1) * step));
    lo += static_cast<int>(k) * step;
  }
  lo += __popc(__ballot_sync(
      kAll, lo + lane < hi && __ldg(cell + lo + lane) < c));
  // the cell's positions, 32 at a time; returns whether the cell goes on
  // past this chunk
  float total = 0.0f;
  int groups = 0, mn = kIntMax, mx = kIntMin;
  const bool ordered = agg == kSum || agg == kAvg;
  auto take = [&](int j, int cj, uint8_t fj, int lj) {
    const bool in = j < n && cj == c;
    const bool f = in && fj != 0;
    const unsigned flags = __ballot_sync(kAll, f);
    if (f) {
      mn = min(mn, lj);
      mx = max(mx, lj);
    }
    if (ordered && flags != 0u) {  // in group order, by lane 0
      if (f) s_len[warp][__popc(flags & lt)] = static_cast<float>(lj);
      __syncwarp();
      if (lane == 0) {
        const int here = __popc(flags);
        for (int g = 0; g < here; ++g) total = total + s_len[warp][g];
      }
      __syncwarp();
    }
    groups += __popc(flags);
    return __all_sync(kAll, in);
  };
  int cj = 0, lj = 0;
  uint8_t fj = 0;
  int j = lo + lane;
  if (j < n) {
    cj = __ldg(cell + j);
    fj = __ldg(first + j);
    lj = __ldg(length + j);
  }
  // a cell of one chunk (the common case) reads no further; a longer one
  // reads kHeatAhead chunks at a time
  if (take(j, cj, fj, lj)) {
    for (int base = lo + 32;; base += kHeatAhead * 32) {
      int c4[kHeatAhead], l4[kHeatAhead];
      uint8_t f4[kHeatAhead];
#pragma unroll
      for (int u = 0; u < kHeatAhead; ++u) {
        const int ju = base + u * 32 + lane;
        c4[u] = ju < n ? __ldg(cell + ju) : 0;
        f4[u] = ju < n ? __ldg(first + ju) : 0;
        l4[u] = ju < n ? __ldg(length + ju) : 0;
      }
      bool more = true;
#pragma unroll
      for (int u = 0; u < kHeatAhead; ++u) {
        if (more) more = take(base + u * 32 + lane, c4[u], f4[u], l4[u]);
      }
      if (!more) break;
    }
  }
  if (agg == kMin || agg == kMax) {
    mn = __reduce_min_sync(kAll, mn);
    mx = __reduce_max_sync(kAll, mx);
  }
  if (lane != 0) return;
  float r = 0.0f;
  if (groups > 0) {
    const float cnt = static_cast<float>(min(groups, kCountStop));
    switch (agg) {
      case kSum: r = total; break;
      case kAvg: r = total / cnt; break;
      case kMin: r = static_cast<float>(mn); break;
      case kMax: r = static_cast<float>(mx); break;
      default: r = cnt; break;
    }
  }
  out[c] = r;
}

// ------------------------------------------------------------------------
// K8a, K8b and K8c: keys as wide as the batch's own fields; one launch when
// the batch fits one block, else a key launch, one launch per pass and a
// walk.

constexpr int kOneBlockMax = 4096;  // points of the one-block path
constexpr int kMaxPasses = 8;       // 8-bit digits of a key of <= 64 bits
constexpr size_t kRankSmem = sizeof(int) * kWarps * kDigits;  // wcount
constexpr int kInitRows = 4096;    // K8b: absent rows per extra block

template <typename K>
__device__ __forceinline__ int digit_at(K key, int shift) {
  return static_cast<int>((key >> shift) & static_cast<K>(kDigits - 1));
}

// K8a's and K8b's key: the object (m for a padded slot) above ts - ts_lo
// in ts_bits bits. The wrapper's range holds every slot's ts; a ts outside
// it is clamped into the field, so it can never reach the object's bits.
template <typename K>
__device__ __forceinline__ K tstats_key(int32_t oid, int32_t ts,
                                        uint8_t valid, int m, long long ts_lo,
                                        int ts_bits) {
  const long long top = (1ll << ts_bits) - 1;
  long long d = static_cast<long long>(ts) - ts_lo;
  d = d < 0 ? 0 : (d > top ? top : d);
  const uint32_t o = valid != 0 ? static_cast<uint32_t>(oid)
                                : static_cast<uint32_t>(m);
  return (static_cast<K>(o) << ts_bits) | static_cast<K>(d);
}

// K8c's key: the cell (num_cells for a padded or out-of-grid slot) above
// the object id (0 for such a slot) in oid_bits bits.
template <typename K>
__device__ __forceinline__ K group_key(int32_t cell, int32_t oid,
                                       uint8_t valid, int num_cells,
                                       int oid_bits) {
  const bool ok = valid != 0 && cell >= 0;
  const uint32_t hi = ok ? static_cast<uint32_t>(min(cell, num_cells))
                         : static_cast<uint32_t>(num_cells);
  const uint32_t lo = ok ? static_cast<uint32_t>(oid) : 0u;
  return (static_cast<K>(hi) << oid_bits) | static_cast<K>(lo);
}

// K8a: the run of object o that starts at sorted position i (keys and
// batch positions in skey / perm, in shared or device memory), walked in
// (ts) order as the header describes; the object's state read once and
// written once; every output but out_oid (which each position writes
// itself). Positions [i, b1) take their points from bx / by (at j - b0)
// and, when s_sp is not null, leave their outputs in s_sp, s_tm, s_speed,
// s_emit (at j - b0); the rest of the run gathers its points through perm
// and writes device memory, its loads running ahead of the sums (the
// next position's point and the key and batch position of the one after
// it are asked for before the current position is summed; perm is a
// permutation, so a position past the run is still a valid gather).
template <typename K>
__device__ __forceinline__ void tstats_run(
    const K* skey, const int32_t* perm, int i, int n, uint32_t o,
    int ts_bits, long long ts_lo, const float* __restrict__ x,
    const float* __restrict__ y, const float* bx, const float* by, int b0,
    int b1, float* s_sp, float* s_tm, float* s_speed, uint8_t* s_emit,
    float* __restrict__ last_x, float* __restrict__ last_y,
    int32_t* __restrict__ last_ts, float* __restrict__ spatial,
    float* __restrict__ temporal, float* __restrict__ out_sp,
    float* __restrict__ out_tm, float* __restrict__ out_speed,
    uint8_t* __restrict__ out_emit) {
  const K field = (static_cast<K>(1) << ts_bits) - static_cast<K>(1);
  const int st_ts = last_ts[o];
  const bool init = st_ts != kIntMin;
  const float sx = last_x[o], sy = last_y[o];
  const float base_sp = spatial[o], base_tm = temporal[o];
  bool have = false;  // an accepted point of this run so far
  float ax = 0.0f, ay = 0.0f;
  int ats = 0;
  float rd = 0.0f, rt = 0.0f;
  int prev_ts = 0;
  float osp, otm, ospeed;
  bool emit;
  // position j of the run: its key and point into the sums and outputs
  auto step = [&](int j, K kj, float px, float py) {
    const int ts =
        static_cast<int>(static_cast<long long>(kj & field) + ts_lo);
    const bool tie = j > i && ts == prev_ts;
    prev_ts = ts;
    const bool acc = !tie && ts > st_ts;
    emit = false;
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
    osp = base_sp + rd;
    otm = base_tm + rt;
    ospeed = otm > 0.0f ? osp / otm : 0.0f;
  };
  int j = i;
  for (; j < b1; ++j) {  // staged points
    const K kj = skey[j];
    if (j > i && static_cast<uint32_t>(kj >> ts_bits) != o) break;
    step(j, kj, bx[j - b0], by[j - b0]);
    if (s_sp != nullptr) {
      s_sp[j - b0] = osp;
      s_tm[j - b0] = otm;
      s_speed[j - b0] = ospeed;
      s_emit[j - b0] = emit ? 1 : 0;
    } else {
      out_sp[j] = osp;
      out_tm[j] = otm;
      out_speed[j] = ospeed;
      out_emit[j] = emit ? 1 : 0;
    }
  }
  if (j == b1 && j < n && static_cast<uint32_t>(skey[j] >> ts_bits) == o) {
    // the rest of the run, gathered: position j's key and point, j + 1's
    // key and batch position
    K kj = skey[j];
    const int pj = perm[j];
    float px = x[pj], py = y[pj];
    K k1 = j + 1 < n ? skey[j + 1] : static_cast<K>(0);
    int p1 = j + 1 < n ? perm[j + 1] : 0;
    for (;; ++j) {
      const bool next =
          j + 1 < n && static_cast<uint32_t>(k1 >> ts_bits) == o;
      const K k2 = j + 2 < n ? skey[j + 2] : static_cast<K>(0);
      const int p2 = j + 2 < n ? perm[j + 2] : 0;
      const float qx = j + 1 < n ? x[p1] : 0.0f;
      const float qy = j + 1 < n ? y[p1] : 0.0f;
      step(j, kj, px, py);
      out_sp[j] = osp;
      out_tm[j] = otm;
      out_speed[j] = ospeed;
      out_emit[j] = emit ? 1 : 0;
      if (!next) break;
      kj = k1;
      px = qx;
      py = qy;
      k1 = k2;
      p1 = p2;
    }
  }
  if (have) {
    last_x[o] = ax;
    last_y[o] = ay;
    last_ts[o] = ats;
    spatial[o] = base_sp + rd;
    temporal[o] = base_tm + rt;
  }
}

// K8b: the run of object o that starts at sorted position i, on fresh
// state: every first point of an (object, ts) group is accepted and
// linked to the previous accepted one; the pair distances summed one by
// one in order (a tie adds 0, as in the plain version's sum, so a step
// has no branch and the steps' distances overlap); the object's row written
// once. Positions [i, b1) take their points from bx / by (at j - b0); the
// rest of the run (a run that crosses its block's end, or one object's
// long run) is read kGather positions at a time, their keys, batch
// positions and points loaded together before they are summed (perm is a
// permutation, so a position past the run is still a valid gather).
constexpr int kGather = 8;

template <typename K>
__device__ __forceinline__ void summary_of_run(
    const K* skey, const int32_t* perm, int i, int n, uint32_t o,
    int ts_bits, long long ts_lo, const float* __restrict__ x,
    const float* __restrict__ y, const float* bx, const float* by, int b0,
    int b1, const Summary& rows) {
  const K field = (static_cast<K>(1) << ts_bits) - static_cast<K>(1);
  float sum = 0.0f, ax = 0.0f, ay = 0.0f, fx = 0.0f, fy = 0.0f;
  int cnt = 0;
  K prev = 0, first = 0, last = 0;  // keys: within the run, ts alone differs
  // position j (of the run when `live`) into the row
  auto step = [&](bool live, int j, K kj, float px, float py) {
    const bool acc = live && (j == i || kj != prev);
    prev = kj;
    const float d = pp_dist(ax, ay, px, py);
    sum = sum + (acc && cnt > 0 ? d : 0.0f);
    fx = acc && cnt == 0 ? px : fx;
    fy = acc && cnt == 0 ? py : fy;
    first = acc && cnt == 0 ? kj : first;
    ax = acc ? px : ax;
    ay = acc ? py : ay;
    last = acc ? kj : last;
    cnt += acc ? 1 : 0;
  };
  bool more = true;
  int j = i;
  for (; j < b1; ++j) {  // staged points
    const K kj = skey[j];
    more = j == i || static_cast<uint32_t>(kj >> ts_bits) == o;
    if (!more) break;
    step(true, j, kj, bx[j - b0], by[j - b0]);
  }
  for (; more && j < n; j += kGather) {
    K kk[kGather];
    int pp[kGather];
    float px[kGather], py[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int q = min(j + u, n - 1);
      kk[u] = skey[q];
      pp[u] = perm[q];
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      px[u] = x[pp[u]];
      py[u] = y[pp[u]];
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      more = more && j + u < n &&
             static_cast<uint32_t>(kk[u] >> ts_bits) == o;
      step(more, j + u, kk[u], px[u], py[u]);
    }
  }
  rows.spatial[o] = sum;
  rows.count[o] = cnt;
  rows.min_ts[o] = static_cast<int>(static_cast<long long>(first & field) +
                                    ts_lo);
  rows.max_ts[o] = static_cast<int>(static_cast<long long>(last & field) +
                                    ts_lo);
  rows.fx[o] = fx;
  rows.fy[o] = fy;
  rows.lx[o] = ax;
  rows.ly[o] = ay;
}

__device__ __forceinline__ void tstats_padded(
    int j, int32_t* __restrict__ out_oid, float* __restrict__ out_sp,
    float* __restrict__ out_tm, float* __restrict__ out_speed,
    uint8_t* __restrict__ out_emit) {
  out_oid[j] = kIntMax;
  out_sp[j] = 0.0f;
  out_tm[j] = 0.0f;
  out_speed[j] = 0.0f;
  out_emit[j] = 0;
}

// K8c: the (cell, object) group `key` that starts at sorted position j
// (ts of each position in sts): its min and max ts, written over it.
template <typename K>
__device__ __forceinline__ void group_extent(const K* skey,
                                             const int32_t* sts, int j, int n,
                                             K key,
                                             int32_t* __restrict__ out_min,
                                             int32_t* __restrict__ out_max) {
  int mn = kIntMax, mx = kIntMin;
  int e = j;
  for (; e < n && skey[e] == key; ++e) {
    const int v = sts[e];
    mn = min(mn, v);
    mx = max(mx, v);
  }
  for (int q = j; q < e; ++q) {
    out_min[q] = mn;
    out_max[q] = mx;
  }
}

// K8c: sorted position j of the group `key` (cell c): its cell, object and
// first-position flag, which it returns.
template <typename K>
__device__ __forceinline__ bool group_fields(const K* skey, int j, K key,
                                             int c, int oid_bits,
                                             int32_t* __restrict__ out_cell,
                                             int32_t* __restrict__ out_oid,
                                             uint8_t* __restrict__ out_first) {
  const bool first = j == 0 || skey[j - 1] != key;
  out_cell[j] = c;
  out_oid[j] = static_cast<int32_t>(
      key & ((static_cast<K>(1) << oid_bits) - static_cast<K>(1)));
  out_first[j] = first ? 1 : 0;
  return first;
}

__device__ __forceinline__ void group_sentinel(
    int j, int num_cells, int smin, int smax, int32_t* __restrict__ out_cell,
    int32_t* __restrict__ out_oid, int32_t* __restrict__ out_min,
    int32_t* __restrict__ out_max, uint8_t* __restrict__ out_first) {
  out_cell[j] = num_cells;
  out_oid[j] = kIntMax;
  out_min[j] = smin;
  out_max[j] = smax;
  out_first[j] = 0;
}

// The min and max of each thread's (mn, mx) over the block into s[0..1]
// (initialised to (INT_MAX, INT_MIN) by the caller before a barrier that
// every thread passed); integer atomics, exact in any order.
__device__ __forceinline__ void block_min_max(int mn, int mx, int* s) {
  mn = __reduce_min_sync(kAll, mn);
  mx = __reduce_max_sync(kAll, mx);
  if ((threadIdx.x & 31) == 0 && mn <= mx) {
    atomicMin(&s[0], mn);
    atomicMax(&s[1], mx);
  }
}

// One stable pass of the one-block sort over n items in shared memory,
// (ka, pa) to (kb, pb): each warp ranks its own consecutive segment in
// rounds of 32 (digit_peers and per-warp counters, as sort_pass_kernel
// does), the block turns the counts into each warp's start in each digit,
// and each warp places its items in order.
template <typename K>
__device__ __forceinline__ void block_pass(const K* ka, const int32_t* pa,
                                           K* kb, int32_t* pb, int n,
                                           int shift, int* wcount,
                                           int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int seg = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = warp * seg, hi = min(n, lo + seg);
  int* mine = wcount + warp * kDigits;
  for (int j = threadIdx.x; j < kWarps * kDigits; j += kThreads) {
    wcount[j] = 0;
  }
  __syncthreads();
  for (int r = lo; r < hi; r += 32) {
    const int i = r + lane;
    const int d = i < hi ? digit_at(ka[i], shift) : kNoDigit;
    const unsigned peers = digit_peers(d);
    if (d != kNoDigit && (peers & lt) == 0) mine[d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  int total = 0;
  if (threadIdx.x < kDigits) {
    for (int w = 0; w < kWarps; ++w) {
      total += wcount[w * kDigits + threadIdx.x];
    }
  }
  const int first = block_inclusive_sum(total, warp_sums) - total;
  if (threadIdx.x < kDigits) {
    int run = first;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w * kDigits + threadIdx.x];
      wcount[w * kDigits + threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int r = lo; r < hi; r += 32) {
    const int i = r + lane;
    const bool in = i < hi;
    const K k = in ? ka[i] : static_cast<K>(0);
    const int d = in ? digit_at(k, shift) : kNoDigit;
    const unsigned peers = digit_peers(d);
    if (in) {
      const int at = mine[d] + __popc(peers & lt);
      kb[at] = k;
      pb[at] = pa[i];
    }
    __syncwarp();
    if (in && (peers & lt) == 0) mine[d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
}

// Dynamic shared memory of a one-block launch over n points: the per-warp
// counters, then the keys and the payloads, each with its ping-pong copy.
template <typename K>
constexpr size_t block_smem(int n) {
  return kRankSmem + static_cast<size_t>(n) * 2 * (sizeof(K) + sizeof(int));
}

// ... and of a tiled pass: the per-warp counters, each digit's start in
// the tile, and the tile's (key, payload) in digit order.
template <typename K>
constexpr size_t pass_smem() {
  return kRankSmem + sizeof(int) * kDigits +
         static_cast<size_t>(kTileItems) * (sizeof(K) + sizeof(int));
}

// The one-block kernels' shared memory: (ka, pa) and (kb, pb) after the
// per-warp counters.
template <typename K>
struct BlockSmem {
  int* wcount;
  K* ka;
  K* kb;
  int32_t* pa;
  int32_t* pb;
  __device__ BlockSmem(unsigned char* raw, int n) {
    wcount = reinterpret_cast<int*>(raw);
    ka = reinterpret_cast<K*>(wcount + kWarps * kDigits);
    kb = ka + n;
    pa = reinterpret_cast<int32_t*>(kb + n);
    pb = pa + n;
  }
  // every pass, (ka, pa) to (kb, pb) and swap: the sorted keys end in ka
  __device__ void sort(int n, int passes, int* warp_sums) {
    for (int p = 0; p < passes; ++p) {
      block_pass(ka, pa, kb, pb, n, p * kDigitBits, wcount, warp_sums);
      K* kt = ka;
      ka = kb;
      kb = kt;
      int32_t* pt = pa;
      pa = pb;
      pb = pt;
    }
  }
};

// K8a in one launch (n <= kOneBlockMax): keys, every pass and the walk in
// shared memory.
template <typename K>
__global__ void __launch_bounds__(kThreads)
tstats_block_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const int32_t* __restrict__ oid,
                    const int32_t* __restrict__ ts,
                    const uint8_t* __restrict__ valid, int n, int m,
                    long long ts_lo, int ts_bits, int passes,
                    float* __restrict__ last_x, float* __restrict__ last_y,
                    int32_t* __restrict__ last_ts,
                    float* __restrict__ spatial,
                    float* __restrict__ temporal,
                    int32_t* __restrict__ out_oid, float* __restrict__ out_sp,
                    float* __restrict__ out_tm,
                    float* __restrict__ out_speed,
                    uint8_t* __restrict__ out_emit,
                    int32_t* __restrict__ order) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_sums[32];
  BlockSmem<K> sm(smem_raw, n);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    sm.ka[i] = tstats_key<K>(oid[i], ts[i], valid[i], m, ts_lo, ts_bits);
    sm.pa[i] = i;
  }
  sm.sort(n, passes, warp_sums);  // its first barrier follows the keys
  const K* skey = sm.ka;
  const int32_t* perm = sm.pa;
  // the points in sorted order, in the sort's free copies (n floats each)
  float* sx = reinterpret_cast<float*>(sm.pb);
  float* sy = reinterpret_cast<float*>(sm.kb);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int p = perm[j];
    order[j] = p;
    sx[j] = x[p];
    sy[j] = y[p];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const uint32_t o = static_cast<uint32_t>(skey[j] >> ts_bits);
    if (o >= static_cast<uint32_t>(m)) {
      tstats_padded(j, out_oid, out_sp, out_tm, out_speed, out_emit);
      continue;
    }
    out_oid[j] = static_cast<int32_t>(o);
    if (j > 0 && static_cast<uint32_t>(skey[j - 1] >> ts_bits) == o) continue;
    tstats_run(skey, perm, j, n, o, ts_bits, ts_lo, x, y, sx, sy, 0, n,
               nullptr, nullptr, nullptr, nullptr, last_x, last_y, last_ts,
               spatial, temporal, out_sp, out_tm, out_speed, out_emit);
  }
}

// K8b's one-block launch, blocks after the first: the rows [r0, r0 +
// kInitRows) of the objects the batch does not hold (a bit per row in
// `present`, shared) to their absent form.
__device__ __forceinline__ void absent_rows(const int32_t* __restrict__ oid,
                                            const uint8_t* __restrict__ valid,
                                            int n, int m, int r0,
                                            const Summary& rows,
                                            uint32_t* present) {
  for (int w = threadIdx.x; w < kInitRows / 32; w += kThreads) {
    present[w] = 0u;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const uint32_t r = static_cast<uint32_t>(oid[i]) -
                       static_cast<uint32_t>(r0);
    if (valid[i] != 0 && r < static_cast<uint32_t>(kInitRows)) {
      atomicOr(&present[r >> 5], 1u << (r & 31));
    }
  }
  __syncthreads();
  const int r1 = min(m, r0 + kInitRows);
  for (int o = r0 + threadIdx.x; o < r1; o += kThreads) {
    const int r = o - r0;
    if (((present[r >> 5] >> (r & 31)) & 1u) == 0u) rows.absent(o);
  }
}

// K8b in one launch (n <= kOneBlockMax): the first block forms the keys,
// runs every pass and walks the runs in shared memory, writing the present
// objects' rows; the others write the absent objects' rows.
template <typename K>
__global__ void __launch_bounds__(kThreads)
summary_block_kernel(const float* __restrict__ x,
                     const float* __restrict__ y,
                     const int32_t* __restrict__ oid,
                     const int32_t* __restrict__ ts,
                     const uint8_t* __restrict__ valid, int n, int m,
                     long long ts_lo, int ts_bits, int passes, Summary rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_sums[32];
  __shared__ uint32_t present[kInitRows / 32];
  if (blockIdx.x > 0) {
    absent_rows(oid, valid, n, m, (blockIdx.x - 1) * kInitRows, rows,
                present);
    return;
  }
  if (n == 0) return;
  BlockSmem<K> sm(smem_raw, n);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    sm.ka[i] = tstats_key<K>(oid[i], ts[i], valid[i], m, ts_lo, ts_bits);
    sm.pa[i] = i;
  }
  sm.sort(n, passes, warp_sums);  // its first barrier follows the keys
  const K* skey = sm.ka;
  const int32_t* perm = sm.pa;
  // the points in sorted order, in the sort's free copies
  float* sx = reinterpret_cast<float*>(sm.pb);
  float* sy = reinterpret_cast<float*>(sm.kb);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int p = perm[j];
    sx[j] = x[p];
    sy[j] = y[p];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const uint32_t o = static_cast<uint32_t>(skey[j] >> ts_bits);
    if (o >= static_cast<uint32_t>(m)) continue;  // a padded slot
    if (j > 0 && static_cast<uint32_t>(skey[j - 1] >> ts_bits) == o) continue;
    summary_of_run(skey, perm, j, n, o, ts_bits, ts_lo, x, y, sx, sy, 0, n,
                   rows);
  }
}

// K8c in one launch (n <= kOneBlockMax): keys with ts as the payload and
// the sentinel's min and max, every pass, and the walk.
template <typename K>
__global__ void __launch_bounds__(kThreads)
group_block_kernel(const int32_t* __restrict__ cell,
                   const int32_t* __restrict__ oid,
                   const int32_t* __restrict__ ts,
                   const uint8_t* __restrict__ valid, int n, int num_cells,
                   int oid_bits, int passes, int32_t* __restrict__ out_cell,
                   int32_t* __restrict__ out_oid,
                   int32_t* __restrict__ out_min,
                   int32_t* __restrict__ out_max,
                   uint8_t* __restrict__ out_first) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_sums[32];
  __shared__ int sent[2];
  BlockSmem<K> sm(smem_raw, n);
  if (threadIdx.x == 0) {
    sent[0] = kIntMax;
    sent[1] = kIntMin;
  }
  int mn = kIntMax, mx = kIntMin;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const K key = group_key<K>(cell[i], oid[i], valid[i], num_cells,
                               oid_bits);
    const int t = ts[i];
    sm.ka[i] = key;
    sm.pa[i] = t;
    if (static_cast<int>(key >> oid_bits) >= num_cells) {
      mn = min(mn, t);
      mx = max(mx, t);
    }
  }
  __syncthreads();  // sent initialised
  block_min_max(mn, mx, sent);
  __syncthreads();
  sm.sort(n, passes, warp_sums);
  const K* skey = sm.ka;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const K key = skey[j];
    const int c = static_cast<int>(key >> oid_bits);
    if (c >= num_cells) {
      group_sentinel(j, num_cells, sent[0], sent[1], out_cell, out_oid,
                     out_min, out_max, out_first);
      continue;
    }
    if (group_fields(skey, j, key, c, oid_bits, out_cell, out_oid,
                     out_first)) {
      group_extent(skey, sm.pa, j, n, key, out_min, out_max);
    }
  }
}

// The positions of the block whose `lead` is set, packed in order into
// lead_at[0..count) (shared); returns count. Every thread of the block
// calls it.
__device__ __forceinline__ int pack_leads(bool lead, int i, int* lead_at,
                                          int* warp_sums, int* count) {
  const int incl = block_inclusive_sum(lead ? 1 : 0, warp_sums);
  if (lead) lead_at[incl - 1] = i;
  if (threadIdx.x == blockDim.x - 1) *count = incl;
  __syncthreads();
  return *count;
}

// The tiled path. Adds one item's digit of every pass to the tile's
// counts hist[pass][digit] (shared): one atomic per distinct digit in the
// warp. Every lane of the warp calls it.
template <typename K>
__device__ __forceinline__ void count_digits(K key, bool in, int passes,
                                             int* hist) {
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  for (int p = 0; p < passes; ++p) {
    const int d = in ? digit_at(key, p * kDigitBits) : kNoDigit;
    const unsigned peers = __match_any_sync(kAll, d);
    if (in && (peers & lt) == 0) {
      atomicAdd(&hist[p * kDigits + d], __popc(peers));
    }
  }
}

// counts[(pass * tiles + tile) * kDigits + digit] = the tile's count; and
// the look-back state cleared: this tile's status word of each pass and
// digit (laid out as the counts), and, by the first tile, every pass's
// tile counter.
__device__ __forceinline__ void store_counts(const int* hist, int passes,
                                             int32_t* __restrict__ counts,
                                             uint32_t* __restrict__ status,
                                             int* __restrict__ tickets) {
  for (int j = threadIdx.x; j < passes * kDigits; j += kThreads) {
    const size_t at =
        (static_cast<size_t>(j / kDigits) * gridDim.x + blockIdx.x) *
            kDigits + j % kDigits;
    counts[at] = hist[j];
    status[at] = 0u;
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < passes) {
    tickets[threadIdx.x] = 0;
  }
}

// K8a's and K8b's key launch: one block per tile forms its keys and
// counts the digits of every pass; for K8b (init_rows = m) the grid also
// writes every summary row absent, before the walk writes the present
// ones (K8a: init_rows = 0).
template <typename K>
__global__ void __launch_bounds__(kThreads)
tstats_keys_kernel(const int32_t* __restrict__ oid,
                   const int32_t* __restrict__ ts,
                   const uint8_t* __restrict__ valid, int n, int m,
                   long long ts_lo, int ts_bits, int passes,
                   K* __restrict__ keys, int32_t* __restrict__ counts,
                   uint32_t* __restrict__ status,
                   int* __restrict__ tickets, Summary rows, int init_rows) {
  __shared__ int hist[kMaxPasses * kDigits];
  for (int j = threadIdx.x; j < passes * kDigits; j += kThreads) hist[j] = 0;
  for (int o = blockIdx.x * kThreads + threadIdx.x; o < init_rows;
       o += gridDim.x * kThreads) {
    rows.absent(o);
  }
  __syncthreads();
  const int tile0 = blockIdx.x * kTileItems + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = tile0 + r * kThreads;
    const bool in = i < n;
    K key = 0;
    if (in) {
      key = tstats_key<K>(oid[i], ts[i], valid[i], m, ts_lo, ts_bits);
      keys[i] = key;
    }
    count_digits(key, in, passes, hist);
  }
  __syncthreads();
  store_counts(hist, passes, counts, status, tickets);
}

// K8c's key launch: as K8a's, with ts as the payload and the tile's
// sentinel min and max to sent[2 * tile ..].
template <typename K>
__global__ void __launch_bounds__(kThreads)
group_keys_kernel(const int32_t* __restrict__ cell,
                  const int32_t* __restrict__ oid,
                  const int32_t* __restrict__ ts,
                  const uint8_t* __restrict__ valid, int n, int num_cells,
                  int oid_bits, int passes, K* __restrict__ keys,
                  int32_t* __restrict__ pay, int32_t* __restrict__ counts,
                  uint32_t* __restrict__ status, int* __restrict__ tickets,
                  int32_t* __restrict__ sent) {
  __shared__ int hist[kMaxPasses * kDigits];
  __shared__ int s_sent[2];
  for (int j = threadIdx.x; j < passes * kDigits; j += kThreads) hist[j] = 0;
  if (threadIdx.x == 0) {
    s_sent[0] = kIntMax;
    s_sent[1] = kIntMin;
  }
  __syncthreads();
  const int tile0 = blockIdx.x * kTileItems + threadIdx.x;
  int mn = kIntMax, mx = kIntMin;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = tile0 + r * kThreads;
    const bool in = i < n;
    K key = 0;
    if (in) {
      key = group_key<K>(cell[i], oid[i], valid[i], num_cells, oid_bits);
      const int t = ts[i];
      keys[i] = key;
      pay[i] = t;
      if (static_cast<int>(key >> oid_bits) >= num_cells) {
        mn = min(mn, t);
        mx = max(mx, t);
      }
    }
    count_digits(key, in, passes, hist);
  }
  block_min_max(mn, mx, s_sent);
  __syncthreads();
  store_counts(hist, passes, counts, status, tickets);
  if (threadIdx.x == 0) {
    sent[2 * blockIdx.x] = s_sent[0];
    sent[2 * blockIdx.x + 1] = s_sent[1];
  }
}

// The look-back's status word of one tile and digit in one pass: 0 until
// the tile publishes its count of the digit plus one. Volatile loads and
// stores, so that a word is read from and written to L2, where every
// block sees it.
__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.volatile.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  asm volatile("st.volatile.u32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

constexpr int kBatch = 16;  // loads in flight per thread in the sums below
static_assert(kThreads == 2 * kDigits, "two threads per digit");

// Over rows [t0, t1) of column `col` of a (tiles, kDigits) table (the
// key launch's counts): the sum, and the sum over the rows before
// `split`; kBatch loads at a time, coalesced across the warp's digits.
__device__ __forceinline__ void column_sums(const int32_t* table, int col,
                                            int t0, int t1, int split,
                                            int* total, int* before) {
  for (int q0 = t0; q0 < t1; q0 += kBatch) {
    int v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      v[k] = q0 + k < t1
                 ? __ldg(table + static_cast<size_t>(q0 + k) * kDigits + col)
                 : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      *total += v[k];
      if (q0 + k < split) *before += v[k];
    }
  }
}

// Look-back: the sum of the counts tiles [t0, t1) published in column
// `col` of `status`, kBatch loads at a time, waiting (with a growing
// sleep) for a tile that has published nothing yet. Every tile it waits
// for took its number before this one and publishes without waiting.
__device__ __forceinline__ int look_back(const uint32_t* status, int col,
                                         int t0, int t1) {
  int sum = 0;
  for (int q0 = t0; q0 < t1; q0 += kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      v[k] = q0 + k < t1
                 ? load_status(status + static_cast<size_t>(q0 + k) * kDigits +
                               col)
                 : 1u;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      unsigned nap = 32;
      while (v[k] == 0u) {
        __nanosleep(nap);
        nap = min(nap * 2, 1024u);
        v[k] = load_status(status + static_cast<size_t>(q0 + k) * kDigits +
                           col);
      }
      sum += static_cast<int>(v[k] - 1u);
    }
  }
  return sum;
}

// One pass of the tiled sort over one tile of (key, payload): the ranking
// and the scatter of the one-block pass, the tile laid out in digit order
// in shared memory first. Each digit's first output
// position is the digits below it over the batch plus the digit's count
// over the earlier tiles. The first pass, whose tiles are in input order,
// reads both from the key launch's counts and sums the later passes'
// digit totals into `totals` (its first tiles, one (pass, digit) column
// per thread); a later pass reads its totals there, takes its tile's
// number from `ticket`, publishes its own counts in `status` and reads
// the earlier tiles' (look-back). Two threads per digit, each over half
// of the tiles. pay_in nullptr: the first pass of K8a, whose payload is
// the position itself.
template <typename K>
__global__ void __launch_bounds__(kThreads, 1)
sort_pass_kernel(const K* __restrict__ key_in,
                 const int32_t* __restrict__ pay_in, int n, int pass,
                 int passes, const int32_t* __restrict__ counts, int tiles,
                 int32_t* totals, uint32_t* status, int* ticket,
                 K* __restrict__ key_out, int32_t* __restrict__ pay_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* wcount = reinterpret_cast<int*>(smem_raw);  // [kWarps][kDigits]
  int* start = wcount + kWarps * kDigits;          // [kDigits]
  K* s_key = reinterpret_cast<K*>(start + kDigits);
  int* s_pay = reinterpret_cast<int*>(s_key + kTileItems);
  __shared__ int base[kDigits];  // the digit's first output position
  __shared__ int warp_sums[32];
  __shared__ int s_tile;
  __shared__ int s_total[kThreads], s_before[kThreads];  // per half
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int shift = pass * kDigitBits;
  if (threadIdx.x == 0) {
    s_tile = pass == 0 ? static_cast<int>(blockIdx.x) : atomicAdd(ticket, 1);
  }
  for (int j = threadIdx.x; j < kWarps * kDigits; j += kThreads) {
    wcount[j] = 0;
  }
  __syncthreads();
  const int tile = s_tile;
  const int dd = threadIdx.x & (kDigits - 1);
  const int span = (tiles + 1) / 2;  // tiles per half
  const int t0 = threadIdx.x >= kDigits ? span : 0;
  const int t1 = min(tiles, t0 + span);
  const int32_t* pass_counts = counts + static_cast<size_t>(pass) * tiles *
                                            kDigits;
  if (pass == 0) {
    int total = 0, before = 0;
    column_sums(pass_counts, dd, t0, t1, tile, &total, &before);
    s_total[threadIdx.x] = total;
    s_before[threadIdx.x] = before;
    // q: pass * kDigits + digit, of the passes after this one
    for (int q = kDigits + tile * kThreads + threadIdx.x; q < passes * kDigits;
         q += tiles * kThreads) {
      int sum = 0, unused = 0;
      column_sums(counts + static_cast<size_t>(q / kDigits) * tiles * kDigits,
                  q % kDigits, 0, tiles, 0, &sum, &unused);
      totals[q] = sum;
    }
  }
  const int tile0 = tile * kTileItems;
  const int seg = tile0 + warp * kSegment + lane;
  K key[kRounds];
  int d[kRounds], pay[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = seg + r * 32;
    key[r] = 0;
    d[r] = kNoDigit;
    pay[r] = i;
    if (i < n) {
      key[r] = key_in[i];
      d[r] = digit_at(key[r], shift);
      if (pay_in != nullptr) pay[r] = pay_in[i];
    }
  }
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
  // 2. the tile's count of each digit (published for the later tiles
  // after the first pass); the digit's count over the earlier tiles; its
  // total over the batch
  uint32_t* pass_status = status + static_cast<size_t>(pass) * tiles *
                                       kDigits;
  int here = 0;
  if (threadIdx.x < kDigits) {
    for (int w = 0; w < kWarps; ++w) here += wcount[w * kDigits + threadIdx.x];
    if (pass > 0) {
      store_status(pass_status + static_cast<size_t>(tile) * kDigits + dd,
                   static_cast<uint32_t>(here) + 1u);
    }
  }
  if (pass > 0) {
    s_before[threadIdx.x] = look_back(pass_status, dd, t0, min(tile, t1));
  }
  __syncthreads();
  int total = 0, before = 0;
  if (threadIdx.x < kDigits) {
    before = s_before[dd] + s_before[dd + kDigits];
    total = pass == 0 ? s_total[dd] + s_total[dd + kDigits]
                      : __ldcg(totals + pass * kDigits + dd);
  }
  const int below = block_inclusive_sum(total, warp_sums) - total;
  if (threadIdx.x < kDigits) base[threadIdx.x] = below + before;
  // 3. the tile's start of each digit, then each warp's start in it
  const int first = block_inclusive_sum(here, warp_sums) - here;
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
  // 4. the tile in digit order, stable, in shared memory
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (d[r] != kNoDigit) {
      const int at = wcount[warp * kDigits + d[r]] + __popc(peers[r] & lt);
      s_key[at] = key[r];
      s_pay[at] = pay[r];
    }
    __syncwarp();
    if (d[r] != kNoDigit && (peers[r] & lt) == 0) {
      wcount[warp * kDigits + d[r]] += __popc(peers[r]);
    }
    __syncwarp();
  }
  __syncthreads();
  // 5. each digit's run to its place in the output, neighbours together
  const int items = min(kTileItems, n - tile0);
  for (int j = threadIdx.x; j < items; j += kThreads) {
    const K k = s_key[j];
    const int dj = digit_at(k, shift);
    const int pos = base[dj] + (j - start[dj]);
    key_out[pos] = k;
    pay_out[pos] = s_pay[j];
  }
}

// K8a's walk after the tiled sort: one thread per sorted position. The
// block gathers its positions' points into shared memory first, so that a
// run's walk reads them there up to the block's end; the runs that start
// in the block are walked by its first threads, and write the block's own
// positions' outputs to shared memory too, which the block then writes
// out in order.
template <typename K>
__global__ void __launch_bounds__(kWalkThreads)
tstats_walk_kernel(const K* __restrict__ skey,
                   const int32_t* __restrict__ perm, int n, int m,
                   long long ts_lo, int ts_bits, const float* __restrict__ x,
                   const float* __restrict__ y, float* __restrict__ last_x,
                   float* __restrict__ last_y, int32_t* __restrict__ last_ts,
                   float* __restrict__ spatial, float* __restrict__ temporal,
                   int32_t* __restrict__ out_oid, float* __restrict__ out_sp,
                   float* __restrict__ out_tm, float* __restrict__ out_speed,
                   uint8_t* __restrict__ out_emit) {
  __shared__ float sx[kWalkThreads], sy[kWalkThreads];
  __shared__ float s_sp[kWalkThreads], s_tm[kWalkThreads];
  __shared__ float s_speed[kWalkThreads];
  __shared__ uint8_t s_emit[kWalkThreads];
  __shared__ int lead_at[kWalkThreads], warp_sums[32], leads;
  const int b0 = blockIdx.x * kWalkThreads;
  const int b1 = min(n, b0 + kWalkThreads);
  const int i = b0 + threadIdx.x;
  const int t = threadIdx.x;
  if (i < n) {
    const int p = perm[i];
    sx[t] = x[p];
    sy[t] = y[p];
  }
  uint32_t o = 0;
  bool lead = false;
  if (i < n) {
    o = static_cast<uint32_t>(skey[i] >> ts_bits);
    if (o >= static_cast<uint32_t>(m)) {  // a padded slot
      s_sp[t] = 0.0f;
      s_tm[t] = 0.0f;
      s_speed[t] = 0.0f;
      s_emit[t] = 0;
    } else {
      lead = i == 0 || static_cast<uint32_t>(skey[i - 1] >> ts_bits) != o;
    }
  }
  // the runs that start in the block, walked by its first threads (one
  // run each), so that the walks share warps
  if (t < pack_leads(lead, i, lead_at, warp_sums, &leads)) {
    const int j = lead_at[t];
    tstats_run(skey, perm, j, n, static_cast<uint32_t>(skey[j] >> ts_bits),
               ts_bits, ts_lo, x, y, sx, sy, b0, b1, s_sp, s_tm, s_speed,
               s_emit, last_x, last_y, last_ts, spatial, temporal, out_sp,
               out_tm, out_speed, out_emit);
  }
  __syncthreads();
  if (i >= n) return;
  const bool padded = o >= static_cast<uint32_t>(m);
  out_oid[i] = padded ? kIntMax : static_cast<int32_t>(o);
  // a run that began in an earlier block: its walk wrote here already
  if (!padded && b0 > 0 &&
      static_cast<uint32_t>(skey[b0 - 1] >> ts_bits) == o) {
    return;
  }
  out_sp[i] = s_sp[t];
  out_tm[i] = s_tm[t];
  out_speed[i] = s_speed[t];
  out_emit[i] = s_emit[t];
}

// K8b's walk after the tiled sort: the block stages its positions' points
// in shared memory, and the runs that start in it are walked by its first
// threads (one row each).
template <typename K>
__global__ void __launch_bounds__(kWalkThreads)
summary_walk_kernel(const K* __restrict__ skey,
                    const int32_t* __restrict__ perm, int n, int m,
                    long long ts_lo, int ts_bits,
                    const float* __restrict__ x, const float* __restrict__ y,
                    Summary rows) {
  __shared__ float sx[kWalkThreads], sy[kWalkThreads];
  __shared__ int lead_at[kWalkThreads], warp_sums[32], leads;
  const int b0 = blockIdx.x * kWalkThreads;
  const int b1 = min(n, b0 + kWalkThreads);
  const int i = b0 + threadIdx.x;
  bool lead = false;
  if (i < n) {
    const int p = perm[i];
    sx[threadIdx.x] = x[p];
    sy[threadIdx.x] = y[p];
    const uint32_t o = static_cast<uint32_t>(skey[i] >> ts_bits);
    lead = o < static_cast<uint32_t>(m) &&
           (i == 0 || static_cast<uint32_t>(skey[i - 1] >> ts_bits) != o);
  }
  if (static_cast<int>(threadIdx.x) <
      pack_leads(lead, i, lead_at, warp_sums, &leads)) {
    const int j = lead_at[threadIdx.x];
    summary_of_run(skey, perm, j, n,
                   static_cast<uint32_t>(skey[j] >> ts_bits), ts_bits, ts_lo,
                   x, y, sx, sy, b0, b1, rows);
  }
}

// K8c's walk after the tiled sort, the sentinel folded in: a block that
// holds sentinel positions reduces the tiles' sentinel min and max first;
// each position writes its own fields, and the groups that start in the
// block are walked by its first threads.
template <typename K>
__global__ void __launch_bounds__(kWalkThreads)
group_walk_kernel(const K* __restrict__ skey, const int32_t* __restrict__ sts,
                  int n, int num_cells, int oid_bits,
                  const int32_t* __restrict__ sent, int tiles,
                  int32_t* __restrict__ out_cell,
                  int32_t* __restrict__ out_oid,
                  int32_t* __restrict__ out_min,
                  int32_t* __restrict__ out_max,
                  uint8_t* __restrict__ out_first) {
  __shared__ int s_sent[2];
  __shared__ int lead_at[kWalkThreads], warp_sums[32], leads;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const K key = in ? skey[i] : static_cast<K>(0);
  const int c = static_cast<int>(key >> oid_bits);
  const bool is_sent = in && c >= num_cells;
  if (__syncthreads_or(is_sent)) {
    if (threadIdx.x == 0) {
      s_sent[0] = kIntMax;
      s_sent[1] = kIntMin;
    }
    int mn = kIntMax, mx = kIntMin;
    for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
      mn = min(mn, sent[2 * t]);
      mx = max(mx, sent[2 * t + 1]);
    }
    __syncthreads();
    block_min_max(mn, mx, s_sent);
    __syncthreads();
  }
  bool lead = false;
  if (is_sent) {
    group_sentinel(i, num_cells, s_sent[0], s_sent[1], out_cell, out_oid,
                   out_min, out_max, out_first);
  } else if (in) {
    lead = group_fields(skey, i, key, c, oid_bits, out_cell, out_oid,
                        out_first);
  }
  // the groups that start in the block, walked by its first threads
  if (static_cast<int>(threadIdx.x) <
      pack_leads(lead, i, lead_at, warp_sums, &leads)) {
    const int j = lead_at[threadIdx.x];
    group_extent(skey, sts, j, n, skey[j], out_min, out_max);
  }
}

// The tiled path's scratch, carved from one byte buffer (256-byte aligned
// parts): the keys and their ping-pong copy, the payloads and theirs,
// every pass's per-tile digit counts, every pass's look-back status words,
// digit totals and tile counter, and K8c's per-tile sentinel min and max.
struct SortScratch {
  void* key_a;
  void* key_b;
  int32_t* pay_a;
  int32_t* pay_b;
  int32_t* counts;
  uint32_t* status;
  int32_t* totals;
  int* tickets;
  int32_t* sent;
  int tiles;
};

size_t align_part(size_t v) { return (v + 255) & ~static_cast<size_t>(255); }

int passes_of(int bits) {
  return bits < 1 ? 1 : (bits + kDigitBits - 1) / kDigitBits;
}

// Bytes of the scratch for n points of key_bytes-byte keys; carves it
// when `base` is not null.
size_t sort_scratch(int n, int key_bytes, int passes, void* base,
                    SortScratch* out) {
  const size_t nn = static_cast<size_t>(n > 0 ? n : 1);
  const int tiles = static_cast<int>(tiles_of(n > 0 ? n : 1));
  const size_t part[] = {
      align_part(nn * key_bytes),                        // key_a
      align_part(nn * key_bytes),                        // key_b
      align_part(nn * sizeof(int32_t)),                  // pay_a
      align_part(nn * sizeof(int32_t)),                  // pay_b
      align_part(static_cast<size_t>(passes) * tiles * kDigits *
                 sizeof(int32_t)),                       // counts
      align_part(static_cast<size_t>(passes) * tiles * kDigits *
                 sizeof(uint32_t)),                      // status
      align_part(static_cast<size_t>(passes) * kDigits *
                 sizeof(int32_t)),                       // totals
      align_part(static_cast<size_t>(passes) * sizeof(int)),  // tickets
      align_part(2 * static_cast<size_t>(tiles) * sizeof(int32_t)),  // sent
  };
  size_t at[sizeof(part) / sizeof(part[0]) + 1] = {0};
  for (size_t i = 0; i < sizeof(part) / sizeof(part[0]); ++i) {
    at[i + 1] = at[i] + part[i];
  }
  if (base != nullptr) {
    unsigned char* p = static_cast<unsigned char*>(base);
    out->key_a = p + at[0];
    out->key_b = p + at[1];
    out->pay_a = reinterpret_cast<int32_t*>(p + at[2]);
    out->pay_b = reinterpret_cast<int32_t*>(p + at[3]);
    out->counts = reinterpret_cast<int32_t*>(p + at[4]);
    out->status = reinterpret_cast<uint32_t*>(p + at[5]);
    out->totals = reinterpret_cast<int32_t*>(p + at[6]);
    out->tickets = reinterpret_cast<int*>(p + at[7]);
    out->sent = reinterpret_cast<int32_t*>(p + at[8]);
    out->tiles = tiles;
  }
  return at[sizeof(part) / sizeof(part[0])];
}

// The dynamic shared memory limits of one key width's kernels, set once.
template <typename K>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(
      tstats_block_kernel<K>, attr,
      static_cast<int>(block_smem<K>(kOneBlockMax)));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(summary_block_kernel<K>, attr,
                               static_cast<int>(block_smem<K>(kOneBlockMax)));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(group_block_kernel<K>, attr,
                               static_cast<int>(block_smem<K>(kOneBlockMax)));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(sort_pass_kernel<K>, attr,
                               static_cast<int>(pass_smem<K>()));
  }
  if (err == cudaSuccess) done = true;
  return err;
}

// The tiled passes over sc's ping-pong buffers from (key_a, pay_in):
// returns where the sorted keys and payloads end (the last pass's
// payloads to `final_pay` when it is not null).
template <typename K>
void tiled_passes(const SortScratch& sc, int n, int passes,
                  const int32_t* pay_in, int32_t* final_pay, cudaStream_t s,
                  const K** keys_out, const int32_t** pay_out) {
  const K* kin = static_cast<const K*>(sc.key_a);
  const int32_t* pin = pay_in;
  for (int p = 0; p < passes; ++p) {
    K* kout = static_cast<K*>((p & 1) ? sc.key_a : sc.key_b);
    int32_t* pout = (p & 1) ? sc.pay_a : sc.pay_b;
    if (p == passes - 1 && final_pay != nullptr) pout = final_pay;
    sort_pass_kernel<K><<<sc.tiles, kThreads, pass_smem<K>(), s>>>(
        kin, pin, n, p, passes, sc.counts, sc.tiles, sc.totals, sc.status,
        sc.tickets + p, kout, pout);
    kin = kout;
    pin = pout;
  }
  *keys_out = kin;
  *pay_out = pin;
}

template <typename K>
cudaError_t tstats_update_run(
    const float* x, const float* y, const int32_t* oid, const int32_t* ts,
    const uint8_t* valid, int n, int m, long long ts_lo, int ts_bits,
    int passes, bool one_block, float* last_x, float* last_y,
    int32_t* last_ts, float* spatial, float* temporal, int32_t* out_oid,
    float* out_sp, float* out_tm, float* out_speed, uint8_t* out_emit,
    int32_t* order, void* scratch, cudaStream_t s) {
  const cudaError_t err = allow_smem<K>();
  if (err != cudaSuccess) return err;
  if (one_block) {
    tstats_block_kernel<K><<<1, kThreads, block_smem<K>(n), s>>>(
        x, y, oid, ts, valid, n, m, ts_lo, ts_bits, passes, last_x, last_y,
        last_ts, spatial, temporal, out_oid, out_sp, out_tm, out_speed,
        out_emit, order);
    return cudaGetLastError();
  }
  SortScratch sc;
  sort_scratch(n, sizeof(K), passes, scratch, &sc);
  tstats_keys_kernel<K><<<sc.tiles, kThreads, 0, s>>>(
      oid, ts, valid, n, m, ts_lo, ts_bits, passes,
      static_cast<K*>(sc.key_a), sc.counts, sc.status, sc.tickets,
      Summary{}, 0);
  const K* skey;
  const int32_t* perm;
  tiled_passes<K>(sc, n, passes, nullptr, order, s, &skey, &perm);
  tstats_walk_kernel<K><<<blocks_of(n, kWalkThreads), kWalkThreads, 0, s>>>(
      skey, perm, n, m, ts_lo, ts_bits, x, y, last_x, last_y, last_ts,
      spatial, temporal, out_oid, out_sp, out_tm, out_speed, out_emit);
  return cudaGetLastError();
}

template <typename K>
cudaError_t tstats_summary_run(const float* x, const float* y,
                               const int32_t* oid, const int32_t* ts,
                               const uint8_t* valid, int n, int m,
                               long long ts_lo, int ts_bits, int passes,
                               bool one_block, const Summary& rows,
                               void* scratch, cudaStream_t s) {
  const cudaError_t err = allow_smem<K>();
  if (err != cudaSuccess) return err;
  if (one_block) {
    const int init_blocks = static_cast<int>(
        (static_cast<long long>(m) + kInitRows - 1) / kInitRows);
    summary_block_kernel<K><<<1 + init_blocks, kThreads, block_smem<K>(n),
                              s>>>(x, y, oid, ts, valid, n, m, ts_lo, ts_bits,
                                   passes, rows);
    return cudaGetLastError();
  }
  SortScratch sc;
  sort_scratch(n, sizeof(K), passes, scratch, &sc);
  tstats_keys_kernel<K><<<sc.tiles, kThreads, 0, s>>>(
      oid, ts, valid, n, m, ts_lo, ts_bits, passes,
      static_cast<K*>(sc.key_a), sc.counts, sc.status, sc.tickets, rows, m);
  const K* skey;
  const int32_t* perm;
  tiled_passes<K>(sc, n, passes, nullptr, nullptr, s, &skey, &perm);
  summary_walk_kernel<K><<<blocks_of(n, kWalkThreads), kWalkThreads, 0, s>>>(
      skey, perm, n, m, ts_lo, ts_bits, x, y, rows);
  return cudaGetLastError();
}

template <typename K>
cudaError_t group_extents_run(
    const int32_t* cell, const int32_t* oid, const int32_t* ts,
    const uint8_t* valid, int n, int num_cells, int oid_bits, int passes,
    bool one_block, int32_t* out_cell, int32_t* out_oid, int32_t* out_min,
    int32_t* out_max, uint8_t* out_first, void* scratch, cudaStream_t s) {
  const cudaError_t err = allow_smem<K>();
  if (err != cudaSuccess) return err;
  if (one_block) {
    group_block_kernel<K><<<1, kThreads, block_smem<K>(n), s>>>(
        cell, oid, ts, valid, n, num_cells, oid_bits, passes, out_cell,
        out_oid, out_min, out_max, out_first);
    return cudaGetLastError();
  }
  SortScratch sc;
  sort_scratch(n, sizeof(K), passes, scratch, &sc);
  group_keys_kernel<K><<<sc.tiles, kThreads, 0, s>>>(
      cell, oid, ts, valid, n, num_cells, oid_bits, passes,
      static_cast<K*>(sc.key_a), sc.pay_a, sc.counts, sc.status,
      sc.tickets, sc.sent);
  const K* skey;
  const int32_t* sts;
  tiled_passes<K>(sc, n, passes, sc.pay_a, nullptr, s, &skey, &sts);
  group_walk_kernel<K><<<blocks_of(n, kWalkThreads), kWalkThreads, 0, s>>>(
      skey, sts, n, num_cells, oid_bits, sc.sent, sc.tiles, out_cell, out_oid,
      out_min, out_max, out_first);
  return cudaGetLastError();
}

}  // namespace

// Bytes of K8a's, K8b's and K8c's scratch buffer for n points and a key of
// `bits` bits on the tiled path (the one-block path takes none).
extern "C" long long traj_sort_scratch_bytes(int n, int bits) {
  if (n < 0 || bits < 1 || bits > 64) return -1;
  return static_cast<long long>(
      sort_scratch(n, bits <= 32 ? 4 : 8, passes_of(bits), nullptr, nullptr));
}

// K8a. Batch: x, y (n,) f32, oid, ts (n,) int32, valid (n,) bool, every
// valid oid in [0, m), every slot's ts (padded ones too) in [ts_lo, ts_lo
// + 2^ts_bits). State (m,): last_x, last_y, last_ts (int32, INT_MIN =
// uninitialised), spatial, temporal, updated in place. Writes, in sorted
// (object, ts) order: out_oid (n,) int32, out_sp, out_tm, out_speed (n,)
// f32, out_emit (n,) bool, order (n,) int32 (the batch position of each).
// one_block (n <= kOneBlockMax, 4,096): one launch, no scratch; else
// the tiled path over `scratch` (traj_sort_scratch_bytes(n,
// bit_length(m) + ts_bits) bytes). Launches on `stream`, does not
// synchronise, returns a CUDA error code.
extern "C" int tstats_update_launch(
    const float* x, const float* y, const int32_t* oid, const int32_t* ts,
    const uint8_t* valid, int n, int m, long long ts_lo, int ts_bits,
    int one_block, float* last_x, float* last_y, int32_t* last_ts,
    float* spatial, float* temporal, int32_t* out_oid, float* out_sp,
    float* out_tm, float* out_speed, uint8_t* out_emit, int32_t* order,
    void* scratch, void* stream) {
  const int bits = bit_length(m) + ts_bits;
  if (n < 0 || m < 1 || ts_bits < 0 || ts_bits > 32 || bits > 64 ||
      (one_block != 0 && n > kOneBlockMax) ||
      (one_block == 0 && n > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int passes = passes_of(bits);
  const cudaError_t err =
      bits <= 32
          ? tstats_update_run<uint32_t>(
                x, y, oid, ts, valid, n, m, ts_lo, ts_bits, passes,
                one_block != 0, last_x, last_y, last_ts, spatial, temporal,
                out_oid, out_sp, out_tm, out_speed, out_emit, order, scratch,
                s)
          : tstats_update_run<u64>(
                x, y, oid, ts, valid, n, m, ts_lo, ts_bits, passes,
                one_block != 0, last_x, last_y, last_ts, spatial, temporal,
                out_oid, out_sp, out_tm, out_speed, out_emit, order, scratch,
                s);
  return static_cast<int>(err);
}

// K8b. Batch as K8a's (every slot's ts in [ts_lo, ts_lo + 2^ts_bits));
// writes the (m,) summary: spatial f32, count int32, min_ts, max_ts int32
// (INT_MAX / INT_MIN for an absent object), first_x, first_y, last_x,
// last_y f32 (0 when absent). one_block and scratch as K8a's (n = 0 takes
// the one-block launch, which writes every row absent). Launches on
// `stream`, does not synchronise, returns a CUDA error code.
extern "C" int tstats_summary_launch(
    const float* x, const float* y, const int32_t* oid, const int32_t* ts,
    const uint8_t* valid, int n, int m, long long ts_lo, int ts_bits,
    int one_block, float* spatial, int32_t* count, int32_t* min_ts,
    int32_t* max_ts, float* fx, float* fy, float* lx, float* ly,
    void* scratch, void* stream) {
  const int bits = bit_length(m) + ts_bits;
  if (n < 0 || m < 1 || ts_bits < 0 || ts_bits > 32 || bits > 64 ||
      (one_block != 0 && n > kOneBlockMax) ||
      (one_block == 0 && n > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int passes = passes_of(bits);
  const Summary rows{spatial, count, min_ts, max_ts, fx, fy, lx, ly};
  const bool one = one_block != 0 || n == 0;
  const cudaError_t err =
      bits <= 32
          ? tstats_summary_run<uint32_t>(x, y, oid, ts, valid, n, m, ts_lo,
                                         ts_bits, passes, one, rows, scratch,
                                         s)
          : tstats_summary_run<u64>(x, y, oid, ts, valid, n, m, ts_lo,
                                    ts_bits, passes, one, rows, scratch, s);
  return static_cast<int>(err);
}

// K8c. Batch: cell, oid, ts (n,) int32, valid (n,) bool, every valid oid
// in [0, 2^oid_bits). Writes, in sorted (cell, object) order: out_cell
// (num_cells for a padded or out-of-grid slot), out_oid (2^31 - 1 there),
// out_min, out_max (the group's ts extent) (n,) int32 and out_first (n,)
// bool (the group's first position, never in the sentinel cell).
// one_block and scratch as K8a's, for a key of oid_bits +
// bit_length(num_cells) bits.
extern "C" int taggregate_extents_launch(
    const int32_t* cell, const int32_t* oid, const int32_t* ts,
    const uint8_t* valid, int n, int num_cells, int oid_bits, int one_block,
    int32_t* out_cell, int32_t* out_oid, int32_t* out_min, int32_t* out_max,
    uint8_t* out_first, void* scratch, void* stream) {
  if (n < 0 || num_cells < 1 || oid_bits < 1 || oid_bits > 31 ||
      (one_block != 0 && n > kOneBlockMax) ||
      (one_block == 0 && n > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int bits = oid_bits + bit_length(num_cells);
  const int passes = passes_of(bits);
  const cudaError_t err =
      bits <= 32
          ? group_extents_run<uint32_t>(cell, oid, ts, valid, n, num_cells,
                                        oid_bits, passes, one_block != 0,
                                        out_cell, out_oid, out_min, out_max,
                                        out_first, scratch, s)
          : group_extents_run<u64>(cell, oid, ts, valid, n, num_cells,
                                   oid_bits, passes, one_block != 0, out_cell,
                                   out_oid, out_min, out_max, out_first,
                                   scratch, s);
  return static_cast<int>(err);
}

// K8d. Groups as K8c writes them (cell ascending): cell, length (n,)
// int32, first (n,) bool. Writes out (num_cells,) f32: agg 0 SUM, 1 AVG,
// 2 MIN, 3 MAX, 4 COUNT of each cell's group lengths (0 for a cell
// without a group), in one launch.
extern "C" int taggregate_heatmap_launch(const int32_t* cell,
                                         const int32_t* length,
                                         const uint8_t* first, int n,
                                         int num_cells, int agg, float* out,
                                         void* stream) {
  if (n < 0 || num_cells < 1 || agg < 0 || agg > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  heatmap_kernel<<<blocks_of(num_cells, kHeatWarps), kHeatWarps * 32, 0, s>>>(
      cell, length, first, n, num_cells, agg, out);
  return static_cast<int>(cudaGetLastError());
}
