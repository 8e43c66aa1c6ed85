// K2: windowed kNN over one window batch, for Q queries at once: each
// object's minimum distance among the eligible points, then the k smallest
// minima ordered by (distance, interned object id) ascending.
//
// Replaces the dedup + top-k of spatialflink_tpu/ops/knn.py
// (dedup_min_by_id :45, _topk_full_sort :69 and the exact strategies
// behind topk_by_distance(_multi) :260/:294), reached through
// knn_point_stats (:384), knn_point_multi_stats (:442) and
// knn_eligible_stats (:582), and the eligibility of
// point_stream_eligibility (:591). Plain PyTorch version:
// spatialflink_tpu_torch/ops/knn.py knn_topk_plain.
//
// Semantics kept: eligible = valid & in grid & (Chebyshev layer <=
// nb_layers in point mode, or nb_mask[q, cell] in cell mode, or a given
// (Q, N) mask); no radius filter on the distance (windowed kNN); k slots
// always, empty ones (2^31-1, 3.4e38, false); counts[q] = eligible slots.
//
// Two stages, no library selection:
// A. fold (one grid-stride pass, blockIdx.y = query): eligibility and
//    distance per point (the point-point distance is computed here; cell
//    and mask modes read a (Q, N) distance row from K4/K4x or the bbox
//    distance), then an unsigned atomicMin of the f32 bit pattern into a
//    per-object table best[q, oid] (num_ids entries per query, one per
//    interned id; 0 <= oid < num_ids is guarded). Every distance is >= +0
//    (a -0 is folded to +0), so the bit order is the float order. Eligible
//    slots are counted in registers, reduced per block with warp shuffles,
//    and added with one atomicAdd per block.
// B. select: exact k smallest of the keys (dist_bits << 32) | oid. A block
//    sorts a tile of kTile keys in shared memory (bitonic, 16 KB) and keeps
//    its k smallest; rounds repeat over the survivors until one tile is
//    left, whose first k keys become (obj_id, dist, valid). The packed key
//    breaks equal distances by ascending interned id, the order of the JAX
//    package's lexicographic (id, dist) sort + top_k and the one
//    merge_topk_host depends on. k <= kTile / 2 (checked), so every round
//    at least halves the survivors.
//
// What bounds it on an H100: bytes for the fold (17 bytes per point in
// point mode, plus 4 per point and query of distance row in the other
// modes) against a few operations per (point, query). What the kernel pays
// beyond that is the atomics into the L2-resident table and the tile
// sorts over num_ids entries per query; both are latency, not bandwidth,
// at the shapes the main path gives it (PERF.md).
//
// Built with --fmad=false: the point-mode distance rounds exactly as the
// plain version's separate PyTorch ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks on each of 132 SMs
constexpr int kModePoint = 0;
constexpr int kModeCells = 1;
constexpr int kNoLayer = 1 << 30;      // uniform_grid.cheb_layers sentinel
constexpr uint32_t kEmpty = 0xFFFFFFFFu;  // table entry of an absent object
constexpr int kTile = 2048;            // keys sorted per block in stage B
constexpr int kSelectThreads = kTile / 2;  // one compare-exchange each
constexpr u64 kNoKey = ~0ull;
constexpr float kBig = 3.4e38f;        // ops/knn._BIG
constexpr int32_t kOidSentinel = 0x7fffffff;  // ops/knn._OID_SENTINEL

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
knn_fold_kernel(int mode, int n, int num_ids,
                const int32_t* __restrict__ obj_id,
                const float* __restrict__ x, const float* __restrict__ y,
                const int32_t* __restrict__ cell,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ qx, const float* __restrict__ qy,
                const int32_t* __restrict__ q_cell, int grid_n,
                int nb_layers, const float* __restrict__ dists,
                const uint8_t* __restrict__ nb_mask, int num_cells,
                const uint8_t* __restrict__ eligible,
                uint32_t* __restrict__ best, int32_t* __restrict__ counts) {
  const int q = blockIdx.y;
  const size_t row = static_cast<size_t>(q) * n;
  uint32_t* table = best + static_cast<size_t>(q) * num_ids;
  float fqx = 0.0f, fqy = 0.0f;
  int qc = -1, bx = 0, by = 0;
  if (mode == kModePoint) {
    fqx = qx[q];
    fqy = qy[q];
    qc = q_cell[q];
    if (qc >= 0) {
      bx = qc / grid_n;
      by = qc % grid_n;
    }
  }
  int count = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    bool elig;
    float d = 0.0f;
    if (mode == kModePoint) {
      const int c = cell[i];
      int layers = kNoLayer;
      if (c >= 0 && qc >= 0) {
        layers = max(abs(c / grid_n - bx), abs(c % grid_n - by));
      }
      elig = valid[i] != 0 && layers <= nb_layers;
      if (elig) {
        const float dx = fqx - x[i];
        const float dy = fqy - y[i];
        d = sqrtf(dx * dx + dy * dy);
      }
    } else if (mode == kModeCells) {
      // the cell >= 0 guard: a -1 pad must never index the mask
      const int c = cell[i];
      elig = valid[i] != 0 && c >= 0 && c < num_cells &&
             nb_mask[static_cast<size_t>(q) * num_cells + c] != 0;
      if (elig) d = dists[row + i];
    } else {
      elig = eligible[row + i] != 0;
      if (elig) d = dists[row + i];
    }
    if (!elig) continue;
    ++count;
    const int oid = obj_id[i];
    if (oid < 0 || oid >= num_ids) continue;
    uint32_t bits = __float_as_uint(d);
    if (bits == 0x80000000u) bits = 0u;  // -0 sorts as +0
    uint32_t* slot = table + oid;
    // minima only fall, so a stale read can only cost a needless atomic
    if (bits < __ldcg(slot)) atomicMin(slot, bits);
  }

  __shared__ int s_count[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  count = warp_sum(count);
  if (lane == 0) s_count[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = lane < kThreads / 32 ? s_count[lane] : 0;
    count = warp_sum(count);
    if (lane == 0 && count) atomicAdd(&counts[q], count);
  }
}

// One round of stage B over tile blockIdx.x of query blockIdx.y. Round 1
// reads the table (`table` non-null: key of entry e is (best << 32) | e,
// absent entries are no key); later rounds read the (Q, m_in) survivor keys
// of the previous round. Writes the tile's k smallest keys to keys_out[q,
// tile * k + r], or, in the last round (one tile, out_oid non-null), the
// (Q, k) result.
__global__ void __launch_bounds__(kSelectThreads)
knn_select_kernel(const uint32_t* __restrict__ table, int num_ids,
                  const u64* __restrict__ keys_in, int m_in, int k,
                  u64* __restrict__ keys_out, int out_stride,
                  int32_t* __restrict__ out_oid, float* __restrict__ out_dist,
                  uint8_t* __restrict__ out_valid) {
  __shared__ u64 s[kTile];
  const int q = blockIdx.y;
  const int base = blockIdx.x * kTile;
  for (int j = threadIdx.x; j < kTile; j += kSelectThreads) {
    const int e = base + j;
    u64 key = kNoKey;
    if (table != nullptr) {
      if (e < num_ids) {
        const uint32_t b = table[static_cast<size_t>(q) * num_ids + e];
        if (b != kEmpty) key = (static_cast<u64>(b) << 32) | uint32_t(e);
      }
    } else if (e < m_in) {
      key = keys_in[static_cast<size_t>(q) * m_in + e];
    }
    s[j] = key;
  }
  __syncthreads();
  // bitonic sort, ascending: thread t compare-exchanges one pair per step
  const int t = threadIdx.x;
  for (int size = 2; size <= kTile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int lo = 2 * t - (t & (stride - 1));
      const int hi = lo + stride;
      const bool up = (lo & size) == 0;
      const u64 a = s[lo], b = s[hi];
      if ((a > b) == up) {
        s[lo] = b;
        s[hi] = a;
      }
      __syncthreads();
    }
  }
  for (int r = threadIdx.x; r < k; r += kSelectThreads) {
    const u64 key = s[r];
    if (out_oid != nullptr) {
      float d = kBig;
      int32_t oid = kOidSentinel;
      uint8_t v = 0;
      if (key != kNoKey) {
        d = __uint_as_float(static_cast<uint32_t>(key >> 32));
        v = d < kBig ? 1 : 0;
        if (v) oid = static_cast<int32_t>(static_cast<uint32_t>(key));
      }
      const size_t o = static_cast<size_t>(q) * k + r;
      out_oid[o] = oid;
      out_dist[o] = d;
      out_valid[o] = v;
    } else {
      keys_out[static_cast<size_t>(q) * out_stride +
               static_cast<size_t>(blockIdx.x) * k + r] = key;
    }
  }
}

}  // namespace

// The number of stage-B tiles of the first round: the wrapper sizes each of
// the two (Q, tiles * k) u64 scratch buffers with it.
extern "C" int knn_topk_tiles(int num_ids) {
  return num_ids > kTile ? (num_ids + kTile - 1) / kTile : 1;
}

// mode 0 (point): x, y, cell, valid, obj_id (n,), qx, qy (Q,) f32, q_cell
// (Q,) int32, grid_n, nb_layers. mode 1 (cells): cell, valid, obj_id, dists
// (Q, n) f32, nb_mask (Q, num_cells) bool. mode 2 (eligible): obj_id, dists
// and eligible (Q, n). best: (Q, num_ids) uint32 scratch; scratch_a/b: (Q,
// knn_topk_tiles(num_ids) * k) u64 each. Writes out_oid (Q, k) int32,
// out_dist (Q, k) f32, out_valid (Q, k) bool and counts (Q,) int32. The
// table and the counts are initialised here on `stream`. Does not
// synchronise; returns a CUDA error code (0 when every memset and launch
// was accepted).
extern "C" int knn_topk_launch(
    int mode, int n, int num_queries, int num_ids, int k,
    const int32_t* obj_id, const float* x, const float* y,
    const int32_t* cell, const uint8_t* valid, const float* qx,
    const float* qy, const int32_t* q_cell, int grid_n, int nb_layers,
    const float* dists, const uint8_t* nb_mask, int num_cells,
    const uint8_t* eligible, uint32_t* best, u64* scratch_a, u64* scratch_b,
    int32_t* out_oid, float* out_dist, uint8_t* out_valid, int32_t* counts,
    void* stream) {
  if (k < 1 || k > kTile / 2 || num_queries < 1 || num_ids < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      counts, 0, sizeof(int32_t) * static_cast<size_t>(num_queries), s);
  if (err == cudaSuccess && num_ids > 0) {
    err = cudaMemsetAsync(best, 0xFF,
                          sizeof(uint32_t) * static_cast<size_t>(num_ids) *
                              num_queries, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int per_row = max(1, kMaxBlocks / num_queries);
    const dim3 grid(min((n + kThreads - 1) / kThreads, per_row),
                    num_queries);
    knn_fold_kernel<<<grid, kThreads, 0, s>>>(
        mode, n, num_ids, obj_id, x, y, cell, valid, qx, qy, q_cell, grid_n,
        nb_layers, dists, nb_mask, num_cells, eligible, best, counts);
  }
  const uint32_t* table = best;
  const u64* in = nullptr;
  u64* out = scratch_a;
  int m = num_ids;
  for (;;) {
    const int tiles = m > kTile ? (m + kTile - 1) / kTile : 1;
    const bool last = tiles == 1;
    knn_select_kernel<<<dim3(tiles, num_queries), kSelectThreads, 0, s>>>(
        table, num_ids, in, m, k, out, tiles * k,
        last ? out_oid : nullptr, out_dist, out_valid);
    if (last) break;
    table = nullptr;
    in = out;
    m = tiles * k;
    out = out == scratch_a ? scratch_b : scratch_a;
  }
  return static_cast<int>(cudaGetLastError());
}
