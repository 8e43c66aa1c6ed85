// K3: the merge of a window's pane top-k partials. Input: P partials of Q
// query rows, each k slots of (obj_id, dist, valid) per row, read where
// they lie (one pointer triple per pane). Output: per query row, the
// exact top-k of its P*k candidates: each object's minimum distance, then
// the k smallest minima ordered by (distance, object id) ascending, in k
// slots whose empty ones hold (2^31-1, 3.4e38, false).
//
// Replaces _merge_topk_stacked (spatialflink_tpu/ops/knn.py:532) and
// _merge_topk_stacked_multi (:541), the jitted full-sort dedup + top-k
// (_topk_full_sort :69, dedup_min_by_id :45) that merge_knn_device(_multi)
// (:551-573) runs over a window's resident pane partials. Plain PyTorch
// version: spatialflink_tpu_torch/ops/knn.py merge_topk_stacked_plain.
//
// Design: a merge of the sorted pane lists (csrc/topk_merge.cuh). A slot
// is a candidate when it is valid, its id is not the sentinel and its
// distance is below 3.4e38; it becomes the key (distance, id), both in
// their total order (f32 sign bit flipped, negatives inverted; int32 sign
// bit flipped), and every other slot the key ~0. The order of the row is
// that of the keys, ties broken by (pane, slot). Each pane's k keys are a
// run; K2 writes its k slots sorted by (distance, interned id), valid
// ones first, so its partials are sorted runs, and merge rounds (a binary
// search per key into the partner run) sort the row in ceil(log2 P)
// rounds. Then a key is kept when it is the first of its id in that
// order, which is the id's minimum distance: the plain version's (id,
// distance) sort followed by first-of-id. An id table (open addressing,
// atomicMin of the index) finds each id's first index, a block scan over
// the kept flags gives each kept key its output slot, and the first k
// are written. Equal distances come out in ascending id because the id is
// the key's low half. Rows whose pane lists are not sorted come out right
// too: one pass checks every pane's piece, and a block that finds one out
// of order sorts all its keys (bitonic) into a single run first.
//
// A row of up to kMaxKeys = 1,024 keys is one block, one key a thread:
// keys, merge and id table in shared memory (16 bytes per key: the keys
// and a second buffer, which after the merge holds the id table at load
// <= 1/2). One key a thread because a binary search is a chain of
// dependent shared-memory loads: a thread that walks several keys' chains
// one after another makes the rounds latency-bound (measured on an H100:
// 4 to 8 keys a thread of 1,024 ran slower than the wide paths below).
// A wider row spreads over blocks and SMs, chosen over a cluster with the
// id table in distributed shared memory because a row may hold any P*k
// keys and a cluster at most 16 blocks' shared memory:
// - k <= kMaxKeys / 2 and at most kReduceLevels levels: a two-stage
//   reduce. Each block of kMaxKeys keys keeps its chunk's top-k survivors
//   (deduped, sorted), and the survivors, runs of k, merge again (one
//   launch a level) until a row fits one block. This is exact by the pane
//   merge's own covering argument: an object of the row's top-k has its
//   minimum in some chunk, and there it is in the chunk's top-k, or k
//   objects of that chunk alone beat it.
// - otherwise a sort across blocks. Each block sorts its chunk as above,
//   global merge rounds (one launch each, a thread per key) merge the
//   chunks, and three passes over the sorted row (the id table in device
//   memory, the kept count per block of 1,024 keys, the writes) dedup and
//   write it.
// A reduce level costs about one block's latency and a merge round about
// half that, but the sort pays a fixed chunk sort, memset and three
// passes. On an H100 (kernel_ab.py --kernels k3wide, PERF.md), with both
// paths forced, the reduce took 0.025 / 0.027 / 0.041 / 0.043 ms against
// the sort's 0.034 / 0.048 / 0.062 / 0.050 at (panes, queries, k) = (21,
// 2, 50) / (60, 1, 100) / (300, 1, 100) / (16, 1, 512), 1 to 3 levels;
// tied at (32, 1, 512), 4 levels (0.052 against 0.051), and lost at (300,
// 1, 512), 8 levels (0.098 against 0.084).
//
// The partials' pointers travel in the kernel's parameters for up to
// kParamPanes panes; beyond, the launch copies them to a table at the head
// of the scratch. knn_merge_scratch_bytes says how much scratch a shape
// needs (0 for a row of one block and few panes), so these limits live
// here alone.
//
// What bounds it on an H100: a window's merge moves P*Q*k*9 bytes in and
// Q*k*9 out (a few KB at the main path's shapes), so it is bound by the
// launch and by its barriers: one to load, one for the order check,
// ceil(log2 P) merge rounds, three for the id table and the scan
// (PERF.md). NaN distances are outside its contract.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

using topk_merge::kNoKey;
using topk_merge::Runs;
using topk_merge::u64;

constexpr int kMaxKeys = 1024;
constexpr int kParamPanes = 64;
constexpr int kReduceLevels = 3;  // most survivor levels (see the header)
constexpr int kScan = 1024;       // keys per block of the wide row's scan
constexpr int32_t kSentinel = 0x7fffffff;
constexpr float kBig = 3.4e38f;

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

struct Parts {
  const int32_t* oid[kParamPanes];
  const float* dist[kParamPanes];
  const uint8_t* valid[kParamPanes];
};

// Where the candidates lie: pane p's row q at oid[p] + q * k. table ==
// nullptr: the pointers are in parts; else 3 * panes pointers in device
// memory (every pane's oid, then dist, then valid). keys != nullptr: a
// reduce level's survivors instead, key j of row q at keys[q * key_row +
// j], runs of k.
struct Source {
  Parts parts;
  const long long* table;
  const u64* keys;
  long long key_row;
  int panes, k;
};

struct Out {
  int32_t* oid;
  float* dist;
  uint8_t* valid;
};

// What a block writes: its chunk sorted (the sort across blocks), its
// chunk's top-k survivors at surv[q * surv_row + c * k] (a reduce level),
// or the row's top-k to out.
struct Dst {
  u64* sorted;
  u64* surv;
  long long surv_row;
  Out out;
};

// Key j of row q (pane j / k, slot j % k).
__device__ __forceinline__ u64 load_key(const Source& src, int q, int j) {
  if (src.keys != nullptr) return src.keys[q * src.key_row + j];
  const int p = j / src.k;
  const size_t off = static_cast<size_t>(q) * src.k + (j - p * src.k);
  const int32_t* o;
  const float* d;
  const uint8_t* v;
  if (src.table != nullptr) {
    o = reinterpret_cast<const int32_t*>(src.table[p]);
    d = reinterpret_cast<const float*>(src.table[src.panes + p]);
    v = reinterpret_cast<const uint8_t*>(src.table[2 * src.panes + p]);
  } else {
    o = src.parts.oid[p];
    d = src.parts.dist[p];
    v = src.parts.valid[p];
  }
  const int32_t id = o[off];
  const float dd = d[off];
  const bool ok = v[off] != 0 && id != kSentinel && dd < kBig;
  return ok ? (static_cast<u64>(order_dist(dd)) << 32) | order_id(id)
            : kNoKey;
}

__device__ __forceinline__ void put(const Out& out, size_t at, u64 key) {
  out.oid[at] = id_of(static_cast<uint32_t>(key));
  out.dist[at] = dist_of(static_cast<uint32_t>(key >> 32));
  out.valid[at] = 1;
}

__device__ __forceinline__ void put_empty(const Out& out, size_t at) {
  out.oid[at] = kSentinel;
  out.dist[at] = kBig;
  out.valid[at] = 0;
}

// grid (chunks, Q), max(32, size) threads; `size` keys of dynamic shared
// memory twice (a power of two >= the chunk's keys). Block c takes keys
// [c * kMaxKeys, + len) of its row's n: loads them, checks each pane's
// piece for order (else sorts them all), merges the pane runs, and then
// writes the sorted chunk, or dedups it and writes its top-k (Dst).
__global__ void __launch_bounds__(kMaxKeys)
merge_block_kernel(Source src, int n, int size, Dst dst) {
  extern __shared__ u64 smem[];
  __shared__ int warp_sums[32];
  u64* a = smem;
  u64* b = smem + size;
  const int q = blockIdx.y;
  const int k = src.k;
  const int g0 = blockIdx.x * kMaxKeys;
  const int len = min(kMaxKeys, n - g0);
  for (int j = threadIdx.x; j < size; j += blockDim.x) {
    a[j] = j < len ? load_key(src, q, g0 + j) : kNoKey;
  }
  __syncthreads();
  int bad = 0;
  for (int j = threadIdx.x; j + 1 < len; j += blockDim.x) {
    if ((g0 + j + 1) % k != 0 && a[j] > a[j + 1]) bad = 1;
  }
  Runs runs{len, min(len, k - g0 % k), k};
  if (__syncthreads_or(bad)) {
    topk_merge::block_bitonic(a, size);
    runs = Runs{len, len, len};
  }
  const u64* r = topk_merge::block_merge_runs(a, b, runs);
  if (dst.sorted != nullptr) {
    u64* row = dst.sorted + static_cast<size_t>(q) * n + g0;
    for (int j = threadIdx.x; j < len; j += blockDim.x) row[j] = r[j];
    return;
  }
  int* tab = reinterpret_cast<int*>(r == a ? b : a);  // 2 * size slots
  const uint32_t mask = 2 * size - 1;
  for (int j = threadIdx.x; j < 2 * size; j += blockDim.x) tab[j] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    if (r[j] != kNoKey) topk_merge::first_insert(tab, mask, r, j);
  }
  __syncthreads();
  const int j = threadIdx.x;  // blockDim.x >= len
  const bool keep = j < len && r[j] != kNoKey &&
                    topk_merge::first_of(tab, mask, r,
                                         static_cast<uint32_t>(r[j])) == j;
  int total;
  const int at = topk_merge::block_sum(keep ? 1 : 0, warp_sums, &total) - 1;
  if (dst.surv != nullptr) {
    u64* row = dst.surv + q * dst.surv_row +
               static_cast<long long>(blockIdx.x) * k;
    if (keep && at < k) row[at] = r[j];
    for (int s = total + threadIdx.x; s < k; s += blockDim.x) {
      row[s] = kNoKey;
    }
    return;
  }
  const Out& out = dst.out;
  const size_t base = static_cast<size_t>(q) * k;
  if (keep && at < k) put(out, base + at, r[j]);
  for (int s = total + threadIdx.x; s < k; s += blockDim.x) {
    put_empty(out, base + s);
  }
}

// A wide row's dedup, over its sorted keys (row q at sorted + q * n) and
// its id table (row q at tab + q * (mask + 1)).
struct Wide {
  const u64* sorted;
  int n;
  int* tab;
  uint32_t mask;
  int32_t* counts;  // kept keys per block of kScan, row q at q * gridDim.x

  __device__ const u64* row() const {
    return sorted + static_cast<size_t>(blockIdx.y) * n;
  }
  __device__ int* table() const {
    return tab + static_cast<size_t>(blockIdx.y) * (mask + 1);
  }
  __device__ bool kept(int j) const {
    if (j >= n) return false;
    const u64* keys = row();
    const u64 key = keys[j];
    return key != kNoKey &&
           topk_merge::first_of(table(), mask, keys,
                                static_cast<uint32_t>(key)) == j;
  }
};

__global__ void wide_insert_kernel(Wide w) {
  const u64* keys = w.row();
  int* tab = w.table();
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < w.n;
       j += gridDim.x * blockDim.x) {
    if (keys[j] != kNoKey) topk_merge::first_insert(tab, w.mask, keys, j);
  }
}

// grid (ceil(n / kScan), Q): the kept keys of each block of kScan.
__global__ void __launch_bounds__(kScan) wide_count_kernel(Wide w) {
  const int c = __syncthreads_count(
      w.kept(blockIdx.x * kScan + static_cast<int>(threadIdx.x)));
  if (threadIdx.x == 0) {
    w.counts[static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x] = c;
  }
}

// The same grid: each kept key's slot is the kept count before its block
// plus its rank in the block; slots past the row's kept keys are empty
// (n >= k, so the blocks cover every slot).
__global__ void __launch_bounds__(kScan)
wide_write_kernel(Wide w, int k, Out out) {
  __shared__ int warp_sums[32];
  const int32_t* cnt = w.counts + static_cast<size_t>(blockIdx.y) * gridDim.x;
  int before = 0, all = 0;
  for (int c = threadIdx.x; c < static_cast<int>(gridDim.x);
       c += blockDim.x) {
    all += cnt[c];
    if (c < static_cast<int>(blockIdx.x)) before += cnt[c];
  }
  int kept_before, total, unused;
  topk_merge::block_sum(before, warp_sums, &kept_before);
  topk_merge::block_sum(all, warp_sums, &total);
  const int j = blockIdx.x * kScan + threadIdx.x;
  const bool keep = w.kept(j);
  const int at = kept_before +
                 topk_merge::block_sum(keep ? 1 : 0, warp_sums, &unused) - 1;
  const size_t base = static_cast<size_t>(blockIdx.y) * k;
  if (keep && at < k) put(out, base + at, w.row()[j]);
  if (j >= total && j < k) put_empty(out, base + j);
}

int pow2_at_least(long long v) {
  int p = 2;
  while (p < v) p <<= 1;
  return p;
}

long long chunks_of(long long n) { return (n + kMaxKeys - 1) / kMaxKeys; }

// Whether a row of n keys takes the survivor reduce: survivors shrink it
// (2k <= kMaxKeys) within kReduceLevels levels.
bool reduces(long long n, int k) {
  if (2 * k > kMaxKeys) return false;
  int levels = 0;
  for (; n > kMaxKeys; n = chunks_of(n) * k) ++levels;
  return levels <= kReduceLevels;
}

// The sort across blocks' scratch: the sorted row twice (ping-pong), the
// id table (a power of two >= 2n slots) and the kept counts, per row.
struct WideLayout {
  long long n, slots, blocks;
  long long bytes(int q) const {
    return q * (16 * n + 4 * slots + 4 * blocks);
  }
};

WideLayout wide_layout(int panes, int k) {
  const long long n = static_cast<long long>(panes) * k;
  return WideLayout{n, pow2_at_least(2 * n), (n + kScan - 1) / kScan};
}

// 16 KB of shared memory at most (kMaxKeys keys twice).
cudaError_t launch_blocks(const Source& src, long long n, int chunks,
                          int queries, const Dst& dst, cudaStream_t s) {
  const int size = chunks > 1 ? kMaxKeys : pow2_at_least(n);
  merge_block_kernel<<<dim3(chunks, queries), max(32, size),
                       2 * sizeof(u64) * size, s>>>(
      src, static_cast<int>(n), size, dst);
  return cudaGetLastError();
}

// The two-stage reduce: levels of survivors in two halves of `scratch`
// (each queries * chunks_of(n) * k keys), then the last block.
cudaError_t reduce(Source src, long long n, int queries, u64* scratch,
                   const Out& out, cudaStream_t s) {
  const long long half = queries * chunks_of(n) * src.k;
  for (int level = 0; n > kMaxKeys; ++level) {
    const long long chunks = chunks_of(n);
    u64* surv = scratch + (level & 1) * half;
    const cudaError_t err = launch_blocks(
        src, n, static_cast<int>(chunks), queries,
        Dst{nullptr, surv, chunks * src.k, out}, s);
    if (err != cudaSuccess) return err;
    n = chunks * src.k;
    src.keys = surv;
    src.key_row = n;
  }
  return launch_blocks(src, n, 1, queries, Dst{nullptr, nullptr, 0, out}, s);
}

long long table_bytes(int panes) {
  return panes > kParamPanes ? 3LL * panes * sizeof(long long) : 0;
}

// Bytes of the row work's scratch (0 when a row fits one block).
long long work_bytes(int panes, int queries, int k) {
  const long long n = static_cast<long long>(panes) * k;
  if (n <= kMaxKeys) return 0;
  if (reduces(n, k)) return 2 * sizeof(u64) * queries * chunks_of(n) * k;
  return wide_layout(panes, k).bytes(queries);
}

}  // namespace

// Bytes of device scratch the wrapper allocates for a merge of `panes`
// partials of `queries` rows of k slots: the pointer table beyond
// kParamPanes panes, then the work of rows wider than one block; 0 when
// neither is needed.
extern "C" long long knn_merge_scratch_bytes(int panes, int queries, int k) {
  return table_bytes(panes) + work_bytes(panes, queries, k);
}

// ptrs: a host array of 3 * panes device pointers (every pane's obj_id
// (queries, k) int32, then dist f32, then valid bool, each contiguous).
// scratch: knn_merge_scratch_bytes bytes of device memory (nullptr when
// that is 0). Writes out_oid (queries, k) int32, out_dist f32 and
// out_valid bool on `stream`; does not synchronise. Returns a CUDA error
// code (0 when every copy, memset and launch was accepted).
extern "C" int knn_merge_launch(int panes, int queries, int k,
                                const long long* ptrs, void* scratch,
                                int32_t* out_oid, float* out_dist,
                                uint8_t* out_valid, void* stream) {
  const long long n = static_cast<long long>(panes) * k;
  if (panes < 1 || queries < 1 || queries > 65535 || k < 1 ||
      n > (1LL << 30) ||
      (knn_merge_scratch_bytes(panes, queries, k) > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Source src;
  src.table = nullptr;
  src.keys = nullptr;
  src.key_row = 0;
  src.panes = panes;
  src.k = k;
  if (panes > kParamPanes) {
    // pageable host memory: the copy has read ptrs when it returns
    const cudaError_t err = cudaMemcpyAsync(
        scratch, ptrs, table_bytes(panes), cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    src.table = static_cast<const long long*>(scratch);
    scratch = static_cast<char*>(scratch) + table_bytes(panes);
  }
  for (int p = 0; p < kParamPanes; ++p) {
    const bool in = p < panes;
    src.parts.oid[p] = in ? reinterpret_cast<const int32_t*>(ptrs[p]) : nullptr;
    src.parts.dist[p] =
        in ? reinterpret_cast<const float*>(ptrs[panes + p]) : nullptr;
    src.parts.valid[p] =
        in ? reinterpret_cast<const uint8_t*>(ptrs[2 * panes + p]) : nullptr;
  }
  const Out out{out_oid, out_dist, out_valid};
  if (n <= kMaxKeys) {
    return static_cast<int>(launch_blocks(src, n, 1, queries,
                                          Dst{nullptr, nullptr, 0, out}, s));
  }
  if (reduces(n, k)) {
    return static_cast<int>(
        reduce(src, n, queries, static_cast<u64*>(scratch), out, s));
  }
  const WideLayout lay = wide_layout(panes, k);
  u64* x = static_cast<u64*>(scratch);
  u64* y = x + queries * lay.n;
  int* tab = reinterpret_cast<int*>(y + queries * lay.n);
  int32_t* counts = tab + queries * lay.slots;
  cudaError_t err = launch_blocks(src, n, static_cast<int>(chunks_of(n)),
                                  queries, Dst{x, nullptr, 0, out}, s);
  u64* sorted = x;
  if (err == cudaSuccess) {
    err = topk_merge::merge_rows(
        x, y, queries, Runs{static_cast<int>(n), kMaxKeys, kMaxKeys}, n, s,
        &sorted);
  }
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(tab, 0xFF, sizeof(int) * queries * lay.slots, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const Wide w{sorted, static_cast<int>(n), tab,
               static_cast<uint32_t>(lay.slots - 1), counts};
  const int blocks = static_cast<int>(lay.blocks);
  wide_insert_kernel<<<dim3(blocks * 4, queries), 256, 0, s>>>(w);
  wide_count_kernel<<<dim3(blocks, queries), kScan, 0, s>>>(w);
  wide_write_kernel<<<dim3(blocks, queries), kScan, 0, s>>>(w, k, out);
  return static_cast<int>(cudaGetLastError());
}
