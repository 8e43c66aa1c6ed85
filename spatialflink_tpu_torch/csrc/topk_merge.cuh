// The merge of sorted runs of 64-bit keys, shared by K2 (csrc/knn_topk.cu:
// its selection for k > 1,024 sorts the k keys as runs of one block each
// and merges the runs) and K3 (csrc/knn_merge.cu: a window's pane lists
// are the runs).
//
// A row of n keys is cut into runs: run 0 is [0, f), then runs of w keys
// (the last one shorter). Each run is sorted ascending. A merge round
// pairs the runs two by two (round t merges runs of 2^t original runs):
// every key finds its place in the merged pair as its index in its own
// run plus the count of the partner run's keys below it, by a binary
// search. Equal keys keep the left run first (the left run counts the
// partner's keys < key, the right run those <= key), so a round is a
// stable merge and the final order is the keys' order with ties broken
// by their original position. ceil(log2(runs)) rounds sort the row.
//
// The first position of each id among sorted keys (K3's dedup): an open-
// addressing table maps an id, the low 32 bits of a key, to the smallest
// index that carries it (atomicCAS into an empty slot, then atomicMin).
// A slot's id never changes once set, so a stale read costs one probe.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace topk_merge {

typedef unsigned long long u64;

constexpr u64 kNoKey = ~0ULL;
constexpr unsigned kFull = 0xffffffffu;

// The run layout of a row: n keys, run 0 = [0, f), then runs of w.
struct Runs {
  int n, f, w;

  __host__ __device__ int start(long long i) const {
    if (i <= 0) return 0;
    const long long s = f + (i - 1) * static_cast<long long>(w);
    return s < n ? static_cast<int>(s) : n;
  }
  __host__ __device__ int of(int j) const {
    return j < f ? 0 : 1 + (j - f) / w;
  }
  __host__ __device__ int count() const {
    return n <= f ? 1 : 1 + (n - f + w - 1) / w;
  }
};

// The count of a[0, len) below key (or at or below it, with or_equal); a
// sorted ascending.
__device__ __forceinline__ int count_below(const u64* a, int len, u64 key,
                                           bool or_equal) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const u64 v = a[mid];
    if (v < key || (or_equal && v == key)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Where key, at index j of `in`, lands in round t.
__device__ __forceinline__ int merged_index(const u64* in, const Runs& runs,
                                            int t, int j, u64 key) {
  const long long r = runs.of(j) >> t;
  const long long pair = r >> 1;
  const int l0 = runs.start((2 * pair) << t);
  const int r0 = runs.start((2 * pair + 1) << t);
  const int r1 = runs.start((2 * pair + 2) << t);
  if ((r & 1) == 0) {
    return r0 == r1 ? j : j + count_below(in + r0, r1 - r0, key, false);
  }
  return l0 + (j - r0) + count_below(in + l0, r0 - l0, key, true);
}

// Merge the runs of a[0, runs.n) with the block's threads, ping-ponging
// with b; returns the buffer that holds the sorted row.
__device__ u64* block_merge_runs(u64* a, u64* b, const Runs& runs) {
  const int nr = runs.count();
  for (int t = 0; (1LL << t) < nr; ++t) {
    for (int j = threadIdx.x; j < runs.n; j += blockDim.x) {
      const u64 key = a[j];
      b[merged_index(a, runs, t, j, key)] = key;
    }
    __syncthreads();
    u64* tmp = a;
    a = b;
    b = tmp;
  }
  return a;
}

// One merge round over rows of runs.n keys, row r at in + r * stride; grid
// (blocks, rows).
__global__ void merge_round_kernel(const u64* __restrict__ in,
                                   u64* __restrict__ out, Runs runs, int t,
                                   long long stride) {
  const u64* src = in + blockIdx.y * stride;
  u64* dst = out + blockIdx.y * stride;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < runs.n;
       j += gridDim.x * blockDim.x) {
    const u64 key = src[j];
    dst[merged_index(src, runs, t, j, key)] = key;
  }
}

// Sort `rows` rows of sorted runs with merge rounds on `s`, ping-ponging
// between a and b; *out is the buffer that holds the sorted rows.
inline cudaError_t merge_rows(u64* a, u64* b, int rows, const Runs& runs,
                              long long stride, cudaStream_t s, u64** out) {
  constexpr int kThreads = 256;
  const int blocks = (runs.n + kThreads - 1) / kThreads;
  for (int t = 0; (1LL << t) < runs.count(); ++t) {
    merge_round_kernel<<<dim3(blocks, rows), kThreads, 0, s>>>(a, b, runs, t,
                                                               stride);
    u64* tmp = a;
    a = b;
    b = tmp;
  }
  *out = a;
  return cudaGetLastError();
}

// Ascending bitonic sort of s[0, size), size a power of two, by the block.
__device__ void block_bitonic(u64* s, int size) {
  for (int len = 2; len <= size; len <<= 1) {
    for (int stride = len >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (size >> 1); t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const u64 x = s[lo], y = s[hi];
        if ((x > y) == ((lo & len) == 0)) {
          s[lo] = y;
          s[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ uint32_t slot_of(uint32_t id, uint32_t mask) {
  return (id * 0x9E3779B1u) & mask;
}

// Record index j of keys (sorted) in tab (mask + 1 slots, -1 empty) as
// its id's first index, if it is the smallest so far.
__device__ __forceinline__ void first_insert(int* tab, uint32_t mask,
                                             const u64* keys, int j) {
  const uint32_t id = static_cast<uint32_t>(keys[j]);
  for (uint32_t h = slot_of(id, mask);; h = (h + 1) & mask) {
    int e = *reinterpret_cast<volatile int*>(&tab[h]);
    if (e < 0) {
      e = atomicCAS(&tab[h], -1, j);
      if (e < 0) return;
    }
    if (static_cast<uint32_t>(keys[e]) == id) {
      atomicMin(&tab[h], j);
      return;
    }
  }
}

// The first index of `id` among keys (-1 when it was never inserted).
__device__ __forceinline__ int first_of(const int* tab, uint32_t mask,
                                        const u64* keys, uint32_t id) {
  for (uint32_t h = slot_of(id, mask);; h = (h + 1) & mask) {
    const int e = tab[h];
    if (e < 0) return -1;
    if (static_cast<uint32_t>(keys[e]) == id) return e;
  }
}

// Inclusive sum over the block of one int per thread (blockDim.x a
// multiple of 32, at most 1,024); `warp_sums` is shared, 32 entries.
__device__ __forceinline__ int block_sum(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  __syncthreads();  // warp_sums is free
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[warps - 1];
  return v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

}  // namespace topk_merge
