// K3: the merge of a window's pane top-k partials. Input: P stacked
// partials of Q query rows, each k slots of (obj_id, dist, valid), laid out
// (P, Q, k). Output: per query row, the exact top-k of its P*k candidates:
// each object's minimum distance, then the k smallest minima ordered by
// (distance, object id) ascending, in k slots whose empty ones hold
// (2^31-1, 3.4e38, false).
//
// Replaces _merge_topk_stacked (spatialflink_tpu/ops/knn.py:532) and
// _merge_topk_stacked_multi (:541), the jitted full-sort dedup + top-k
// (_topk_full_sort :69, dedup_min_by_id :45) that merge_knn_device(_multi)
// (:551-573) runs over a window's resident pane partials. Plain PyTorch
// version: spatialflink_tpu_torch/ops/knn.py merge_topk_stacked_plain.
//
// Design: one block per (tile, query row). A block stages its candidates
// in shared memory as 64-bit keys and sorts them twice (bitonic):
// 1. key (id, distance): an ineligible slot becomes (2^31-1, 3.4e38), so
//    the first slot of each id after the sort carries its minimum; the
//    sentinel id and the padding (all ones) are never kept;
// 2. key (distance, id) for the kept slots below 3.4e38, all ones for the
//    rest: the first k keys are the answer, equal distances in ascending
//    id (the JAX sort keeps ids ascending among kept slots and top_k
//    breaks ties by position).
// Ids and distances enter the keys in the total order of int32 and f32
// (sign bit flipped; negative floats inverted), so the keys sort as the
// plain version's stable sorts do, whatever the values.
// A row of at most kTile candidates is one block. A wider row (P*k >
// kTile, e.g. 16 panes at k = 1,024) is cut into tiles of kTile: each
// tile's block writes its top-k survivors to scratch, and the survivors
// merge again (another level when they still pass a tile). This is exact
// by the argument of the pane merge itself: an object of the row's top-k
// has its minimum in some tile, and there it is in the tile's top-k, or k
// objects of that tile alone beat it; ties follow one total order.
//
// What bounds it on an H100: a window's merge moves P*Q*k*9 bytes in and
// Q*k*9 out (a few KB to a few MB), so at the main path's shapes it is
// bound by the launch and by the sort's shared-memory passes and
// barriers, log2(L)*(log2(L)+1) of them for a tile of L keys (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 8192;       // MERGE_TILE in ops/knn.py
constexpr int kMaxThreads = 512;
constexpr int kPerThread = kTile / kMaxThreads;
constexpr int32_t kSentinel = 0x7fffffff;
constexpr float kBig = 3.4e38f;
constexpr u64 kNone = ~0ULL;

__device__ __forceinline__ uint32_t order_dist(float d) {
  const uint32_t b = __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float dist_of(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ uint32_t order_id(int32_t id) {
  return static_cast<uint32_t>(id) ^ 0x80000000u;
}

__device__ __forceinline__ int32_t id_of(uint32_t o) {
  return static_cast<int32_t>(o ^ 0x80000000u);
}

// Where a level reads its candidates: element j of query row q is slot
// i = j % width of part p = j / width, at p * pane_stride + q * row_stride
// + i. valid == nullptr: a slot is eligible iff its id is not the
// sentinel (the survivors of an earlier level).
struct Source {
  const int32_t* oid;
  const float* dist;
  const uint8_t* valid;
  int width;
  long long pane_stride;
  long long row_stride;
  int m;  // candidates per row
};

// Ascending bitonic sort of s[0, L), L a power of two, by the whole block.
__device__ void bitonic_sort(u64* s, int L) {
  for (int size = 2; size <= L; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (L >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const u64 a = s[i], b = s[j];
        if ((a > b) == ((i & size) == 0)) {
          s[i] = b;
          s[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// grid (tiles, Q), L keys of shared memory (a power of two >= the tile's
// candidates). Writes k slots per block at dst[q * dst_row + tile * k];
// dst_valid == nullptr for a level's survivors (scratch).
__global__ void knn_merge_kernel(Source src, int tile, int L, int k,
                                 int32_t* dst_oid, float* dst_dist,
                                 uint8_t* dst_valid, long long dst_row) {
  extern __shared__ u64 keys[];
  const int q = blockIdx.y;
  const int lo = blockIdx.x * tile;
  const int n = min(tile, src.m - lo);
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    u64 key = kNone;
    if (j < n) {
      const int g = lo + j;
      const int p = g / src.width;
      const long long off = p * src.pane_stride + q * src.row_stride +
                            (g - p * src.width);
      int32_t id = src.oid[off];
      float d = src.dist[off];
      const bool ok = src.valid != nullptr ? src.valid[off] != 0
                                           : id != kSentinel;
      if (!ok) {
        id = kSentinel;
        d = kBig;
      }
      key = (static_cast<u64>(order_id(id)) << 32) | order_dist(d);
    }
    keys[j] = key;
  }
  __syncthreads();
  bitonic_sort(keys, L);
  // first of each id, below the distance sentinel -> (distance, id) key
  u64 next[kPerThread];
  int c = 0;
  for (int j = threadIdx.x; j < L; j += blockDim.x, ++c) {
    const u64 a = keys[j];
    const uint32_t hi = static_cast<uint32_t>(a >> 32);
    const uint32_t dl = static_cast<uint32_t>(a);
    const bool first = j == 0 || static_cast<uint32_t>(keys[j - 1] >> 32) != hi;
    const bool keep = first && id_of(hi) != kSentinel && dist_of(dl) < kBig;
    next[c] = keep ? (static_cast<u64>(dl) << 32) | hi : kNone;
  }
  __syncthreads();
  c = 0;
  for (int j = threadIdx.x; j < L; j += blockDim.x, ++c) keys[j] = next[c];
  __syncthreads();
  bitonic_sort(keys, L);
  const long long base = q * dst_row + static_cast<long long>(blockIdx.x) * k;
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const u64 key = r < L ? keys[r] : kNone;
    const bool ok = key != kNone;
    dst_oid[base + r] = ok ? id_of(static_cast<uint32_t>(key)) : kSentinel;
    dst_dist[base + r] = ok ? dist_of(static_cast<uint32_t>(key >> 32))
                            : kBig;
    if (dst_valid != nullptr) dst_valid[base + r] = ok ? 1 : 0;
  }
}

int pow2_at_least(int n) {
  int L = 2;
  while (L < n) L <<= 1;
  return L;
}

cudaError_t launch(const Source& src, int tiles, int queries, int L, int k,
                   int32_t* oid, float* dist, uint8_t* valid,
                   long long dst_row, cudaStream_t s) {
  const size_t smem = sizeof(u64) * static_cast<size_t>(L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = min(kMaxThreads, max(32, L / 2));
  knn_merge_kernel<<<dim3(tiles, queries), threads, smem, s>>>(
      src, kTile, L, k, oid, dist, valid, dst_row);
  return cudaGetLastError();
}

}  // namespace

// obj_id, dist, valid: (panes, queries, k), contiguous. s_oid, s_dist: two
// scratch halves of scratch_ints each (merge_scratch_ints in ops/knn.py;
// unused when panes * k <= kTile). Writes out_oid (queries, k) int32,
// out_dist f32 and out_valid bool on `stream`; does not synchronise.
// Returns a CUDA error code (0 when every launch was accepted).
extern "C" int knn_merge_launch(int panes, int queries, int k,
                                const int32_t* obj_id, const float* dist,
                                const uint8_t* valid, long long scratch_ints,
                                int32_t* s_oid, float* s_dist,
                                int32_t* out_oid, float* out_dist,
                                uint8_t* out_valid, void* stream) {
  if (panes < 1 || queries < 1 || queries > 65535 || k < 1 ||
      k > kTile / 8 || static_cast<long long>(panes) * k > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Source src{obj_id, dist, valid, k, static_cast<long long>(queries) * k, k,
             panes * k};
  int half = 0;
  while (src.m > kTile) {
    const int tiles = (src.m + kTile - 1) / kTile;
    const long long row = static_cast<long long>(tiles) * k;
    if (row * queries > scratch_ints) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int32_t* d_oid = s_oid + half * scratch_ints;
    float* d_dist = s_dist + half * scratch_ints;
    const cudaError_t err = launch(src, tiles, queries, kTile, k, d_oid,
                                   d_dist, nullptr, row, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    src = Source{d_oid, d_dist, nullptr, static_cast<int>(row), 0, row,
                 static_cast<int>(row)};
    half ^= 1;
  }
  return static_cast<int>(launch(src, 1, queries, pow2_at_least(src.m),
                                 k, out_oid, out_dist, out_valid, k, s));
}
