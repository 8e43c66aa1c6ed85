// The walk of the join index shared by K6 (join_lattice.cu) and K7
// (join_reduce.cu).
//
// The index (built by cell_order.cu's join_index_launch, plain version
// ops/join.py join_index_plain) holds a window's b points sorted by
// (b tile, bucket), stably, so that within a bucket the b indices ascend:
// perm (the original b index of each sorted position), key (the sorted
// keys), x and y. Tile t of `tile` points owns the sorted positions
// [t * tile, min(nb, (t + 1) * tile)), its section. A key is
// t * stride + bucket, stride = cells + 3 (0 when each tile was sorted on
// its own), with the buckets
//   0               b cell < 0 (-1: outside the grid)
//   cell + 1        b cell in [0, cells), cells = n * n
//   cells + 1       b cell >= cells
//   cells + 2       b point invalid: never walked
// Because cell = cx * n + cy, the b points whose cells lie in column cx' of
// the grid with cy in [y0, y1] are one contiguous run of a section: a row
// visits 2L + 1 runs per tile for a layer bound L (one run when [y0, y1]
// is the whole column) and tests no pair's cells inside them. A run's ends
// come from the index's start table (starts[k], the first sorted position
// whose key is >= k, for every key of every tile: two loads a run) where
// the index has one, else by binary search over the section's keys (the
// table is capped, ops/join.py MAX_STARTS). The buckets of cells outside
// the grid are walked with a per-pair cell test, under each kernel's own
// cell rule.
#pragma once

#include <stdint.h>

namespace join_walk {

// The bucket of the cells >= cells and of the invalid points, from the
// grid's cell count.
__device__ __forceinline__ int high_bucket(int cells) { return cells + 1; }
__device__ __forceinline__ int dead_bucket(int cells) { return cells + 2; }
constexpr int kNegBucket = 0;

// First position in [lo, hi) whose key is >= target (hi if none).
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ key,
                                           int lo, int hi, int target) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(key + mid) < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// lower_bound searched outward from lo: a run is usually a few points, so
// its end lies close to its start.
__device__ __forceinline__ int gallop(const int32_t* __restrict__ key,
                                      int lo, int hi, int target) {
  int probe = lo, step = 1;
  while (probe < hi && __ldg(key + probe) < target) {
    lo = probe + 1;
    probe = lo + step;
    step <<= 1;
  }
  return lower_bound(key, lo, probe < hi ? probe : hi, target);
}

// A section [lo, hi) of the index, its keys offset by base.
struct Section {
  const int32_t* key;
  const int32_t* starts;  // nullptr: binary search
  int lo;
  int hi;
  int base;

  // The first position of the section whose bucket is >= bucket, at or
  // after `from` (runs are found in ascending order).
  __device__ __forceinline__ int first(int from, int bucket) const {
    return starts != nullptr ? __ldg(starts + base + bucket)
                             : lower_bound(key, from, hi, base + bucket);
  }
  // The same, for the end of a run that begins at `from` (usually a few
  // points on).
  __device__ __forceinline__ int end(int from, int bucket) const {
    return starts != nullptr ? __ldg(starts + base + bucket)
                             : gallop(key, from, hi, base + bucket);
  }
};

// Calls run(s, e) for each run [s, e) of the section that holds the b
// points of the grid's cells (bx, by) with |acx - bx| <= layers and
// |acy - by| <= layers, acy in [0, n), layers below 2^30 (none below 0);
// in ascending cx' (so in ascending key).
template <typename Run>
__device__ __forceinline__ void grid_runs(const Section& sec, int acx,
                                          int acy, int layers, int n,
                                          Run run) {
  const long long x0 = max(0LL, static_cast<long long>(acx) - layers);
  const long long x1 = min(static_cast<long long>(n) - 1,
                           static_cast<long long>(acx) + layers);
  if (x0 > x1 || sec.lo >= sec.hi) return;
  const int y0 = max(0, acy - layers);
  const int y1 = min(n - 1, acy + layers);
  // bucket of cell c is c + 1
  if (y0 == 0 && y1 == n - 1) {  // whole columns: one run
    const int s = sec.first(sec.lo, static_cast<int>(x0) * n + 1);
    const int e = sec.first(s, static_cast<int>(x1) * n + n + 1);
    if (s < e) run(s, e);
    return;
  }
  int s = sec.lo;
  for (int cx = static_cast<int>(x0); cx <= static_cast<int>(x1); ++cx) {
    s = sec.first(s, cx * n + y0 + 1);
    const int e = sec.end(s, cx * n + y1 + 2);
    if (s < e) run(s, e);
    s = e;
  }
}

// The positions [s, e) of one bucket of the section.
__device__ __forceinline__ int2 bucket_run(const Section& sec, int bucket) {
  const int s = sec.first(sec.lo, bucket);
  return make_int2(s, sec.end(s, bucket + 1));
}

}  // namespace join_walk
