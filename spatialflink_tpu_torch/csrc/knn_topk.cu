// K2: windowed kNN over one window batch, for Q queries at once: each
// object's minimum distance among the eligible points, then the k smallest
// minima ordered by (distance, interned object id) ascending.
//
// Replaces the dedup + top-k of spatialflink_tpu/ops/knn.py
// (dedup_min_by_id :45, _topk_full_sort :69 and the exact strategies
// behind topk_by_distance(_multi) :260/:294), reached through
// knn_point_stats (:385), knn_point_multi_stats (:443) and
// knn_eligible_stats (:583), and the eligibility of
// point_stream_eligibility (:591). Plain PyTorch version:
// spatialflink_tpu_torch/ops/knn.py knn_topk_plain.
//
// Semantics kept: eligible = valid & in grid & (Chebyshev layer <=
// nb_layers in point mode, or nb_mask[q, cell] in cell mode, or a given
// (Q, N) mask); no radius filter on the distance (windowed kNN) unless
// the caller asks for the trajectory kNN's exact radius (enforce_radius:
// a slot also needs d <= radius to enter the table, JAX
// spatialflink_tpu/ops/knn.py _knn_point_parts :345-357); k slots
// always, empty ones (2^31-1, 3.4e38, false); counts[q] = eligible slots
// before the radius filter (every one of them cost a distance).
//
// Three launches after two memsets, no library selection:
// A. fold: one grid-stride pass over the points. A thread loads its point
//    once and folds it into all Q tables; the queries' parameters sit in
//    shared memory (up to kQChunk queries per block; more queries take
//    more blocks along y). Per (point, query): eligibility and distance
//    (point mode computes the point-point distance; cell and mask modes
//    read the (Q, N) distance row from K4/K4x or the bbox distance,
//    coalesced across the warp), then an unsigned atomicMin of the f32
//    bit pattern into the per-object table best[oid, q] (num_ids x Q,
//    an object's Q entries side by side; 0 <= oid < num_ids is guarded),
//    skipped when a plain read (one uint4 per 4 queries) already shows a
//    smaller value. Every distance is >= +0 (a -0 is
//    folded to +0), so the bit order is the float order. Eligible slots
//    are counted per warp with a ballot into shared counters and added
//    with one atomicAdd per block and query.
// B. histogram: one pass over the (Q, num_ids) table, counting entries by
//    the top kBinBits of their distance bits (bits 30..19; bit 31, the
//    sign, is 0), in shared memory and then into a per-query global
//    histogram. The last block of each query (a __threadfence and an
//    atomic ticket) finds the boundary bin, where the running count
//    reaches k. This pass cannot be fused into the fold: while the fold
//    runs, a slot's value is not yet its object's minimum.
// C. pick: entries at or below the boundary bin are the candidates; there
//    are exactly upto = cum(boundary) of them. When upto <= kTile, every
//    block appends its candidates as packed (dist_bits << 32) | oid keys
//    to a per-query list, and the query's last block sorts them (bitonic,
//    in shared memory, padded to a power of two >= k) and writes the
//    first k as (obj_id, dist, valid). When the boundary bin holds more
//    (many equal or nearly equal minima: ties, distance 0 inside a
//    polygon, many objects at one point), the blocks append the entries
//    below the bin (fewer than k) to that list, and copy the bin's own
//    entries in id order into a region per block. If the whole bin holds
//    one distance, the last block takes its first k - below entries in
//    id order; otherwise it refines on the next bits of the bin's 64-bit
//    keys (11-bit digits, a shared histogram per digit, starting below the
//    distance bits all of them share) until the keys at or below the
//    prefix number exactly k. Either way it sorts the k keys. Keys
//    are unique per query (one per object), so the k-th key is
//    exact and equal distances break by ascending interned id, the order
//    of the JAX package's lexicographic (id, dist) sort + top_k and the
//    one merge_topk_host depends on.
// D. k > kTile / 2 (any k): the list per query holds cap = k rounded up
//    to kTile keys. The pick gathers its keys (all upto of them, or below
//    plus the refined kk when upto > cap) in that list instead of shared
//    memory and does not sort; one block per run of kTile keys sorts its
//    run (bitonic, keys past the query's count padded with ~0), merge
//    rounds (csrc/topk_merge.cuh, a binary search per key) merge the runs,
//    and a last launch writes the first k. The keys are unique, so the
//    merge has nothing to dedup.
//
// What bounds it on an H100: bytes for the fold (17 bytes per point in
// point mode, plus 4 per point and query of distance row in the other
// modes) against a few operations per (point, query); the table passes
// read 4 bytes per (query, id) twice. At a window's size what it pays
// beyond that is launch and atomic latency (PERF.md); for k > kTile / 2
// the runs' sort and ceil(log2(cap / kTile)) merge rounds add launches.
//
// Built with --fmad=false: the point-mode distance rounds exactly as the
// plain version's separate PyTorch ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // fold grid: 16 blocks per SM of 132
constexpr int kQChunk = 64;          // queries per fold block
constexpr int kGroup = 4;            // queries whose table reads overlap
constexpr int kModePoint = 0;
constexpr int kModeCells = 1;
constexpr int kNoLayer = 1 << 30;      // uniform_grid.cheb_layers sentinel
constexpr uint32_t kEmpty = 0xFFFFFFFFu;  // table entry of an absent object
constexpr int kBinBits = 12;
constexpr int kBins = 1 << kBinBits;
constexpr int kBinShift = 31 - kBinBits;  // distance bits 30..19
constexpr int kKeyBinShift = 32 + kBinShift;  // the bin in a packed key
constexpr int kHistThreads = 256;
constexpr int kPickThreads = 1024;
constexpr int kIdsPerBlock = 4096;  // table entries per hist / pick block
constexpr int kTile = 2048;         // most keys one block sorts
constexpr int kDigitBits = 11;      // refinement digit
constexpr u64 kNoKey = ~0ull;
constexpr float kBig = 3.4e38f;        // ops/knn._BIG
constexpr int32_t kOidSentinel = 0x7fffffff;  // ops/knn._OID_SENTINEL
constexpr unsigned kAll = 0xffffffffu;

// int32 scratch layout per call (zeroed by one memset): counts[Q] |
// hist[Q * kBins] | bound[Q * 4] | hist tickets[Q] | pick tickets[Q] |
// candidate list fills[Q] | boundary-bin bits max[Q] and ~min[Q] |
// boundary-bin entries per pick block[Q * chunks]
struct Zone {
  int32_t* counts;
  int32_t* hist;
  int32_t* bound;  // per query: boundary bin, cum below it, cum through it
  int32_t* hist_ticket;
  int32_t* pick_ticket;
  int32_t* fill;
  uint32_t* bits_hi;      // largest distance bits in the boundary bin
  uint32_t* bits_lo_inv;  // ~(smallest), so that both start at 0
  int32_t* over_count;
};

__host__ __device__ inline int chunks_of(int num_ids) {
  return num_ids > 0 ? (num_ids + kIdsPerBlock - 1) / kIdsPerBlock : 1;
}

__host__ __device__ inline Zone zone_of(int32_t* base, int q, int num_ids) {
  Zone z;
  z.counts = base;
  z.hist = base + q;
  z.bound = z.hist + static_cast<size_t>(q) * kBins;
  z.hist_ticket = z.bound + 4 * q;
  z.pick_ticket = z.hist_ticket + q;
  z.fill = z.pick_ticket + q;
  z.bits_hi = reinterpret_cast<uint32_t*>(z.fill + q);
  z.bits_lo_inv = z.bits_hi + q;
  z.over_count = reinterpret_cast<int32_t*>(z.bits_lo_inv + q);
  return z;
}

__host__ __device__ inline size_t zone_ints(int q, int num_ids) {
  return static_cast<size_t>(q) * (1 + kBins + 4 + 5 + chunks_of(num_ids));
}

// The keys of a query's candidate list: kTile, or k rounded up to kTile
// keys when k > kTile / 2 (the list then sorts as runs of kTile).
__host__ __device__ inline int cap_of(int k) {
  return k <= kTile / 2 ? kTile : (k + kTile - 1) / kTile * kTile;
}

// The histogram bin of a table entry: its distance bits 30..19. Distances
// are >= +0; a pattern with the sign bit set (no distance has one) goes to
// the last bin, so that no index leaves the histogram.
__device__ __forceinline__ int bin_of(uint32_t bits) {
  return bits < 0x80000000u ? static_cast<int>(bits >> kBinShift) : kBins - 1;
}

__device__ __forceinline__ u64 key_of(uint32_t bits, int e) {
  return (static_cast<u64>(bits) << 32) | static_cast<uint32_t>(e);
}

__global__ void __launch_bounds__(kThreads)
knn_fold_kernel(int mode, int n, int num_queries, int num_ids,
                const int32_t* __restrict__ obj_id,
                const float* __restrict__ x, const float* __restrict__ y,
                const int32_t* __restrict__ cell,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ qx, const float* __restrict__ qy,
                const int32_t* __restrict__ q_cell, int grid_n,
                int nb_layers, int enforce_radius, float radius,
                const float* __restrict__ dists,
                const uint8_t* __restrict__ nb_mask, int num_cells,
                const uint8_t* __restrict__ eligible,
                uint32_t* __restrict__ best, int32_t* __restrict__ counts) {
  __shared__ float s_qx[kQChunk], s_qy[kQChunk];
  __shared__ int s_qc[kQChunk], s_bx[kQChunk], s_by[kQChunk];
  __shared__ int s_count[kQChunk];
  const int q0 = blockIdx.y * kQChunk;
  const int nq = min(kQChunk, num_queries - q0);
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x; t < nq; t += kThreads) {
    s_count[t] = 0;
    if (mode == kModePoint) {
      const int qc = q_cell[q0 + t];
      s_qx[t] = qx[q0 + t];
      s_qy[t] = qy[q0 + t];
      s_qc[t] = qc;
      s_bx[t] = qc >= 0 ? qc / grid_n : 0;
      s_by[t] = qc >= 0 ? qc % grid_n : 0;
    }
  }
  __syncthreads();
  // every thread runs the same trip count, so each ballot has all lanes
  for (int i0 = blockIdx.x * kThreads; i0 < n; i0 += gridDim.x * kThreads) {
    const int i = i0 + threadIdx.x;
    const bool in = i < n;
    const int oid = in ? obj_id[i] : -1;
    const bool v = in && (mode == 2 || valid[i] != 0);
    const int c = in && mode != 2 ? cell[i] : -1;
    float px = 0.0f, py = 0.0f;
    int cx = 0, cy = 0;
    if (mode == kModePoint && v) {
      px = x[i];
      py = y[i];
      if (c >= 0) {
        cx = c / grid_n;
        cy = c % grid_n;
      }
    }
    const bool in_table = oid >= 0 && oid < num_ids;
    // kGroup queries at a time: their table reads are in flight together
    for (int j0 = 0; j0 < nq; j0 += kGroup) {
      bool go[kGroup];
      uint32_t bits[kGroup], cur[kGroup];
      uint32_t* slot[kGroup];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int j = j0 + jj;
        go[jj] = false;
        bits[jj] = 0u;
        slot[jj] = best;
        if (j >= nq) continue;  // the same for the whole block
        const int q = q0 + j;
        const size_t row = static_cast<size_t>(q) * n;
        bool elig = false;
        float d = 0.0f;
        if (mode == kModePoint) {
          int layers = kNoLayer;
          if (c >= 0 && s_qc[j] >= 0) {
            layers = max(abs(cx - s_bx[j]), abs(cy - s_by[j]));
          }
          elig = v && layers <= nb_layers;
          if (elig) {
            const float dx = s_qx[j] - px;
            const float dy = s_qy[j] - py;
            d = sqrtf(dx * dx + dy * dy);
          }
        } else {
          // the row is read whether or not the point is eligible, so that
          // this load and the mask's are in flight together
          d = in ? dists[row + i] : 0.0f;
          if (mode == kModeCells) {
            // the cell >= 0 guard: a -1 pad must never index the mask
            elig = v && c >= 0 && c < num_cells &&
                   nb_mask[static_cast<size_t>(q) * num_cells + c] != 0;
          } else {
            elig = in && eligible[row + i] != 0;
          }
        }
        const unsigned ballot = __ballot_sync(kAll, elig);
        if (lane == 0 && ballot != 0) atomicAdd(&s_count[j], __popc(ballot));
        go[jj] = elig && in_table && (enforce_radius == 0 || d <= radius);
        uint32_t b = __float_as_uint(d);
        if (b == 0x80000000u) b = 0u;  // -0 sorts as +0
        bits[jj] = b;
        slot[jj] = best + static_cast<size_t>(go[jj] ? oid : 0) * num_queries + q;
      }
      // minima only fall, so a stale read can only cost a needless atomic;
      // an object's kGroup entries are neighbours, read as one uint4 when
      // whole and aligned
      if ((go[0] || go[1] || go[2] || go[3]) && (num_queries & 3) == 0 &&
          j0 + kGroup <= nq) {
        const uint4 c4 = __ldcg(reinterpret_cast<const uint4*>(
            best + static_cast<size_t>(oid) * num_queries + q0 + j0));
        cur[0] = c4.x;
        cur[1] = c4.y;
        cur[2] = c4.z;
        cur[3] = c4.w;
      } else {
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          cur[jj] = go[jj] ? __ldcg(slot[jj]) : 0u;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        if (go[jj] && bits[jj] < cur[jj]) atomicMin(slot[jj], bits[jj]);
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nq; t += kThreads) {
    if (s_count[t] != 0) atomicAdd(&counts[q0 + t], s_count[t]);
  }
}

// The bin of h[0..nbins) in which the running count reaches kk (>= 1):
// res = {bin, count below it, count through it}; when the total is below
// kk, the last bin. Every thread of the block calls it; res is shared.
__device__ void block_find(const int* h, int nbins, int kk, int* res,
                           int* warp_sums) {
  const int per = (nbins + blockDim.x - 1) / blockDim.x;
  const int lo = min(nbins, static_cast<int>(threadIdx.x) * per);
  const int hi = min(nbins, lo + per);
  int sum = 0;
  for (int b = lo; b < hi; ++b) sum += h[b];
  int total;
  const int incl = topk_merge::block_sum(sum, warp_sums, &total);
  const int excl = incl - sum;
  if (excl < kk && kk <= incl) {
    int run = excl;
    for (int b = lo; b < hi; ++b) {
      if (run + h[b] >= kk) {
        res[0] = b;
        res[1] = run;
        res[2] = run + h[b];
        break;
      }
      run += h[b];
    }
  }
  if (total < kk && threadIdx.x == 0) {
    res[0] = nbins - 1;
    res[1] = total - h[nbins - 1];
    res[2] = total;
  }
  __syncthreads();
}

// True in the one block of query blockIdx.y that arrives last; its
// caller may then read what every block of the query wrote.
__device__ __forceinline__ bool last_block(int32_t* ticket, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (*flag) __threadfence();
  return *flag != 0;
}

__global__ void __launch_bounds__(kHistThreads)
knn_hist_kernel(const uint32_t* __restrict__ best, int num_ids, int k,
                int32_t* __restrict__ zone_base, int num_queries) {
  __shared__ int h[kBins];
  __shared__ int warp_sums[32];
  __shared__ int res[3];
  __shared__ int flag;
  const Zone z = zone_of(zone_base, num_queries, num_ids);
  const int q = blockIdx.y;
  for (int b = threadIdx.x; b < kBins; b += kHistThreads) h[b] = 0;
  __syncthreads();
  const uint32_t* table = best + q;  // entry e at table[e * num_queries]
  const int e0 = blockIdx.x * kIdsPerBlock;
  const int e1 = min(num_ids, e0 + kIdsPerBlock);
#pragma unroll 4
  for (int e = e0 + threadIdx.x; e < e1; e += kHistThreads) {
    const uint32_t b = table[static_cast<size_t>(e) * num_queries];
    if (b != kEmpty) atomicAdd(&h[bin_of(b)], 1);
  }
  __syncthreads();
  int32_t* hist = z.hist + static_cast<size_t>(q) * kBins;
  for (int b = threadIdx.x; b < kBins; b += kHistThreads) {
    if (h[b] != 0) atomicAdd(&hist[b], h[b]);
  }
  if (!last_block(&z.hist_ticket[q], &flag)) return;
  for (int b = threadIdx.x; b < kBins; b += kHistThreads) {
    h[b] = __ldcg(&hist[b]);
  }
  __syncthreads();
  block_find(h, kBins, k, res, warp_sums);
  if (threadIdx.x < 3) z.bound[4 * q + threadIdx.x] = res[threadIdx.x];
}

__device__ __forceinline__ int pow2_at_least(int v) {
  int p = 2;
  while (p < v) p <<= 1;
  return p;
}

// Append the keys of entries [e0, e1) of `table` that `take` accepts to
// `list` through the counter `fill`, one atomic per warp and round.
template <typename Take>
__device__ __forceinline__ void append(const uint32_t* __restrict__ table,
                                       int stride, int e0, int e1, Take take,
                                       u64* __restrict__ list,
                                       int32_t* fill) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  for (int base = e0; base < e1; base += kPickThreads) {
    const int e = base + threadIdx.x;
    const uint32_t b = e < e1 ? table[static_cast<size_t>(e) * stride]
                              : kEmpty;
    const bool ok = b != kEmpty && take(bin_of(b));
    const unsigned ballot = __ballot_sync(kAll, ok);
    if (ballot == 0) continue;
    int at = 0;
    if (ok && (ballot & lt) == 0) at = atomicAdd(fill, __popc(ballot));
    at = __shfl_sync(kAll, at, __ffs(ballot) - 1);
    if (ok) list[at + __popc(ballot & lt)] = key_of(b, e);
  }
}

// Copy the entries of [e0, e1) whose bin is `bin` to out[0..), in id
// order (a block-wide ordered compaction), and return how many there are;
// fold their distance bits into the block's min and max.
__device__ int compact_bin(const uint32_t* __restrict__ table, int stride,
                           int e0, int e1, int bin, u64* __restrict__ out,
                           int* warp_sums, uint32_t* lo, uint32_t* hi) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int done = 0;
  for (int base = e0; base < e1; base += kPickThreads) {
    const int e = base + threadIdx.x;
    const uint32_t b = e < e1 ? table[static_cast<size_t>(e) * stride]
                              : kEmpty;
    const bool ok = b != kEmpty && bin_of(b) == bin;
    if (ok) {
      *lo = min(*lo, b);
      *hi = max(*hi, b);
    }
    const unsigned ballot = __ballot_sync(kAll, ok);
    int total;
    const int incl = topk_merge::block_sum(
        lane == 0 ? __popc(ballot) : 0, warp_sums, &total);
    // incl at lane 0 is this warp's inclusive count; share its start
    const int start = __shfl_sync(kAll, incl - __popc(ballot), 0);
    if (ok) out[done + start + __popc(ballot & lt)] = key_of(b, e);
    done += total;
  }
  return done;
}

// Slot o of the outputs from a sorted key (kNoKey: an empty slot).
__device__ __forceinline__ void write_slot(u64 key, size_t o,
                                           int32_t* __restrict__ out_oid,
                                           float* __restrict__ out_dist,
                                           uint8_t* __restrict__ out_valid) {
  float d = kBig;
  int32_t oid = kOidSentinel;
  uint8_t v = 0;
  if (key != kNoKey) {
    d = __uint_as_float(static_cast<uint32_t>(key >> 32));
    v = d < kBig ? 1 : 0;
    if (v) oid = static_cast<int32_t>(static_cast<uint32_t>(key));
  }
  out_oid[o] = oid;
  out_dist[o] = d;
  out_valid[o] = v;
}

// kGather: k > kTile / 2 (part D); a template parameter so that the k <=
// kTile / 2 instantiation carries none of part D's branches.
template <bool kGather>
__global__ void __launch_bounds__(kPickThreads)
knn_pick_kernel(const uint32_t* __restrict__ best, int num_ids, int k,
                int32_t* __restrict__ zone_base, int num_queries,
                u64* __restrict__ cand, u64* __restrict__ over,
                int32_t* __restrict__ out_oid, float* __restrict__ out_dist,
                uint8_t* __restrict__ out_valid) {
  __shared__ u64 s[kTile];
  __shared__ int h[1 << kDigitBits];
  __shared__ int warp_sums[32];
  __shared__ int res[3];
  __shared__ int flag, fill;
  const Zone z = zone_of(zone_base, num_queries, num_ids);
  const int q = blockIdx.y;
  const uint32_t* table = best + q;  // entry e at table[e * num_queries]
  const int bin = z.bound[4 * q];
  const int below = z.bound[4 * q + 1];
  const int upto = z.bound[4 * q + 2];
  const int cap = kGather ? cap_of(k) : kTile;
  const bool overflow = upto > cap;
  const int chunks = gridDim.x;
  u64* list = cand + static_cast<size_t>(q) * cap;
  // the boundary bin's entries of chunk c, in id order, at
  // olist[c * kIdsPerBlock ...], z.over_count[q * chunks + c] of them
  u64* olist = over + static_cast<size_t>(q) * num_ids;
  const int32_t* ocount = z.over_count + static_cast<size_t>(q) * chunks;
  const int e0 = blockIdx.x * kIdsPerBlock;
  const int e1 = min(num_ids, e0 + kIdsPerBlock);
  if (!overflow) {
    append(table, num_queries, e0, e1, [bin](int b) { return b <= bin; },
           list, &z.fill[q]);
  } else {  // below < k entries under the boundary bin, the bin's apart
    append(table, num_queries, e0, e1, [bin](int b) { return b < bin; },
           list, &z.fill[q]);
    uint32_t lo = 0xFFFFFFFFu, hi = 0u;
    const int cnt = compact_bin(table, num_queries, e0, e1, bin, olist + e0,
                                warp_sums, &lo, &hi);
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(kAll, lo, off));
      hi = max(hi, __shfl_xor_sync(kAll, hi, off));
    }
    if ((threadIdx.x & 31) == 0 && hi >= lo) {
      atomicMax(&z.bits_hi[q], hi);
      atomicMax(&z.bits_lo_inv[q], ~lo);
    }
    if (threadIdx.x == 0) z.over_count[static_cast<size_t>(q) * chunks +
                                       blockIdx.x] = cnt;
  }
  if (!last_block(&z.pick_ticket[q], &flag)) return;
  if (kGather && !overflow) return;  // the list holds all upto keys

  // the k keys gather in s, or in the list under kGather
  int size;
  if (!overflow) {
    size = pow2_at_least(max(upto, k));
    for (int j = threadIdx.x; j < size; j += kPickThreads) {
      s[j] = j < upto ? __ldcg(&list[j]) : kNoKey;
    }
  } else {
    // The kk = k - below smallest keys of the boundary bin's entries.
    size = kGather ? k : pow2_at_least(k);
    for (int j = threadIdx.x; j < size && !kGather; j += kPickThreads) {
      s[j] = j < below ? __ldcg(&list[j]) : kNoKey;
    }
    const int kk = k - below;
    const uint32_t lo = ~__ldcg(&z.bits_lo_inv[q]);
    const uint32_t hi = __ldcg(&z.bits_hi[q]);
    if (lo == hi) {
      // One distance for the whole bin (ties, distance 0 inside a
      // polygon): its kk smallest keys are its first kk in id order,
      // which the chunks hold in order.
      if (threadIdx.x < 32) {
        int done = 0;
        for (int c = 0; c < chunks && done < kk; ++c) {
          const int take = min(__ldcg(&ocount[c]), kk - done);
          for (int j = threadIdx.x; j < take; j += 32) {
            const u64 key = __ldcg(&olist[c * kIdsPerBlock + j]);
            if (kGather) {
              list[below + done + j] = key;
            } else {
              s[below + done + j] = key;
            }
          }
          done += take;
        }
      }
    } else {
      // Refine a prefix p (the key bits at and above `shift`) until the
      // keys whose top bits are <= p's number exactly kk, starting below
      // the distance bits that all of the bin's keys share.
      int shift = 64 - __clz(lo ^ hi);
      u64 p = (static_cast<u64>(lo) >> (shift - 32)) << shift;
      int left = kk;
      int count = upto - below;  // keys with exactly p's top bits
      while (count != left && shift > 0) {
        const int width = min(kDigitBits, shift);
        const int nb = 1 << width;
        const int next = shift - width;
        for (int b = threadIdx.x; b < nb; b += kPickThreads) h[b] = 0;
        __syncthreads();
#pragma unroll 4
        for (int e = threadIdx.x; e < num_ids; e += kPickThreads) {
          const int c = e / kIdsPerBlock;
          if (e - c * kIdsPerBlock >= __ldcg(&ocount[c])) continue;
          const u64 key = __ldcg(&olist[e]);
          if ((key >> shift) == (p >> shift)) {
            atomicAdd(&h[(key >> next) & (nb - 1)], 1);
          }
        }
        __syncthreads();
        block_find(h, nb, left, res, warp_sums);
        p |= static_cast<u64>(res[0]) << next;
        left -= res[1];
        count = res[2] - res[1];
        shift = next;
        __syncthreads();  // res and h are read before the next level
      }
      if (threadIdx.x == 0) fill = below;
      __syncthreads();
      for (int e = threadIdx.x; e < num_ids; e += kPickThreads) {
        const int c = e / kIdsPerBlock;
        if (e - c * kIdsPerBlock >= __ldcg(&ocount[c])) continue;
        const u64 key = __ldcg(&olist[e]);
        if ((key >> shift) <= (p >> shift)) {
          const int at = atomicAdd(&fill, 1);
          if (at < size) {  // exactly k arrive (keys are unique)
            if (kGather) {
              list[at] = key;
            } else {
              s[at] = key;
            }
          }
        }
      }
    }
  }
  if (kGather) return;
  __syncthreads();
  topk_merge::block_bitonic(s, size);
  for (int r = threadIdx.x; r < k; r += kPickThreads) {
    write_slot(s[r], static_cast<size_t>(q) * k + r, out_oid, out_dist,
               out_valid);
  }
}

// Part D, grid (cap / kTile, Q): block b sorts keys [b * kTile, + kTile)
// of query q's list in place; keys at or past the query's count (upto,
// or k when the boundary bin overflowed the list) become kNoKey.
__global__ void __launch_bounds__(kPickThreads)
knn_runs_kernel(u64* __restrict__ cand, int k, int32_t* __restrict__ zone_base,
                int num_queries, int num_ids) {
  __shared__ u64 s[kTile];
  const Zone z = zone_of(zone_base, num_queries, num_ids);
  const int q = blockIdx.y;
  const int cap = cap_of(k);
  const int upto = z.bound[4 * q + 2];
  const int count = upto > cap ? k : upto;
  u64* run = cand + static_cast<size_t>(q) * cap +
             static_cast<size_t>(blockIdx.x) * kTile;
  const int j0 = blockIdx.x * kTile;
  for (int j = threadIdx.x; j < kTile; j += kPickThreads) {
    s[j] = j0 + j < count ? run[j] : kNoKey;
  }
  __syncthreads();
  topk_merge::block_bitonic(s, kTile);
  for (int j = threadIdx.x; j < kTile; j += kPickThreads) run[j] = s[j];
}

// Part D's last launch, grid (ceil(k / 256), Q): the first k sorted keys.
__global__ void knn_write_kernel(const u64* __restrict__ sorted, int k,
                                 int32_t* __restrict__ out_oid,
                                 float* __restrict__ out_dist,
                                 uint8_t* __restrict__ out_valid) {
  const int q = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= k) return;
  write_slot(sorted[static_cast<size_t>(q) * cap_of(k) + r],
             static_cast<size_t>(q) * k + r, out_oid, out_dist, out_valid);
}

}  // namespace

// The int32 scratch the wrapper allocates for Q queries and num_ids
// objects (its first Q entries are the counts output).
extern "C" long long knn_topk_zone_ints(int num_queries, int num_ids) {
  return static_cast<long long>(zone_ints(num_queries, num_ids));
}

// The u64 keys of candidate list the wrapper allocates: (Q, kTile) for k
// <= kTile / 2; two (Q, cap) halves for a larger k (part D's merge
// rounds ping-pong between them).
extern "C" long long knn_topk_cand_keys(int num_queries, int k) {
  return static_cast<long long>(num_queries) * cap_of(k) *
         (k <= kTile / 2 ? 1 : 2);
}


// mode 0 (point): x, y, cell, valid, obj_id (n,), qx, qy (Q,) f32, q_cell
// (Q,) int32, grid_n, nb_layers; enforce_radius != 0 also drops every
// slot farther than radius from its query. mode 1 (cells): cell, valid,
// obj_id, dists (Q, n) f32, nb_mask (Q, num_cells) bool. mode 2 (eligible): obj_id, dists
// and eligible (Q, n). best: (num_ids, Q) uint32 scratch; zone and cand as
// sized above. Writes out_oid (Q, k) int32, out_dist (Q, k) f32, out_valid
// (Q, k) bool and the counts (Q,) int32 at the start of zone. cand:
// knn_topk_cand_keys u64; over: (Q, num_ids) u64 (the boundary bin's keys
// when they pass the candidate list). The table and the zone are initialised here on `stream`. Does not synchronise;
// returns a CUDA error code (0 when every memset and launch was accepted).
extern "C" int knn_topk_launch(
    int mode, int n, int num_queries, int num_ids, int k,
    const int32_t* obj_id, const float* x, const float* y,
    const int32_t* cell, const uint8_t* valid, const float* qx,
    const float* qy, const int32_t* q_cell, int grid_n, int nb_layers,
    int enforce_radius, float radius, const float* dists,
    const uint8_t* nb_mask, int num_cells, const uint8_t* eligible,
    uint32_t* best, int32_t* zone, u64* cand, u64* over, int32_t* out_oid, float* out_dist, uint8_t* out_valid,
    void* stream) {
  if (k < 1 || num_queries < 1 || num_ids < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      zone, 0, sizeof(int32_t) * zone_ints(num_queries, num_ids), s);
  if (err == cudaSuccess && num_ids > 0) {
    err = cudaMemsetAsync(best, 0xFF,
                          sizeof(uint32_t) * static_cast<size_t>(num_ids) *
                              num_queries, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const dim3 grid(min((n + kThreads - 1) / kThreads, kMaxBlocks),
                    (num_queries + kQChunk - 1) / kQChunk);
    knn_fold_kernel<<<grid, kThreads, 0, s>>>(
        mode, n, num_queries, num_ids, obj_id, x, y, cell, valid, qx, qy,
        q_cell, grid_n, nb_layers, enforce_radius, radius, dists, nb_mask,
        num_cells, eligible, best, zone);
  }
  const dim3 grid(chunks_of(num_ids), num_queries);
  knn_hist_kernel<<<grid, kHistThreads, 0, s>>>(best, num_ids, k, zone,
                                                num_queries);
  if (k <= kTile / 2) {
    knn_pick_kernel<false><<<grid, kPickThreads, 0, s>>>(
        best, num_ids, k, zone, num_queries, cand, over, out_oid, out_dist,
        out_valid);
  } else {
    knn_pick_kernel<true><<<grid, kPickThreads, 0, s>>>(
        best, num_ids, k, zone, num_queries, cand, over, out_oid, out_dist,
        out_valid);
    const int cap = cap_of(k);
    knn_runs_kernel<<<dim3(cap / kTile, num_queries), kPickThreads, 0, s>>>(
        cand, k, zone, num_queries, num_ids);
    u64* sorted = cand;
    err = topk_merge::merge_rows(
        cand, cand + static_cast<size_t>(num_queries) * cap, num_queries,
        topk_merge::Runs{cap, kTile, kTile}, cap, s, &sorted);
    if (err != cudaSuccess) return static_cast<int>(err);
    knn_write_kernel<<<dim3((k + 255) / 256, num_queries), 256, 0, s>>>(
        sorted, k, out_oid, out_dist, out_valid);
  }
  return static_cast<int>(cudaGetLastError());
}
