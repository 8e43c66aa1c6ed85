// K6: the point x point join lattice of a window, produced on the device
// as its list of surviving (a index, b index) pairs.
//
// Replaces join_mask (spatialflink_tpu/ops/join.py:137, with
// pairwise_dist2 :38 and _pair_cell_ok :130), an XLA (Na, Nb) boolean
// lattice that join_pairs_host / _tiled_pairs_host (:266, :332) pull to the
// host one b tile of 4,096 at a time for np.nonzero. Plain PyTorch
// version: spatialflink_tpu_torch/ops/join.py join_lattice_plain (over
// join_mask), whose arithmetic this file follows step for step. A pair
// survives when both points are valid, cheb_layers(a.cell, b.cell) <=
// layers (2^30 where either cell is < 0), and the centred expansion
// (a2 + b2) - 2 * (a0*b0 + a1*b1) <= r2, with a0 = ax - cx, a1 = ay - cy,
// a2 = a0*a0 + a1*a1 (and b's alike) in f32. The plain version clamps the
// expansion at 0 first; for r2 >= 0 that changes no comparison, so it is
// left out here. The pairs come out in the JAX package's order: by b tile,
// then by a, then by b; with a row list (the a rows that K7 found
// partners for) only those rows, in ascending order, keeping their own
// indices.
//
// The walk: b comes as the window's join index (join_walk.cuh: sorted by
// (b tile, bucket), built once per window by cell_order.cu and shared with
// K7). A unit is (b tile, a row). It visits the 2L + 1 runs of its tile's
// section that hold the grid's cells within the layers of its row's cell
// (grid_runs; no cell test inside them; their ends from the index's start
// table, or by binary search above its cap), and the bucket of cells
// >= n * n with the cell test when acx + L >= n (cheb_layers compares such
// cells as any other). Under cheb_layers a cell < 0 meets nothing: a row
// whose cell is < 0 visits nothing, and the bucket of b cells < 0 is never
// visited, except when every cell is admitted (layers >= 2^30, kAll),
// where a unit visits every valid b point of its tile. Invalid b points
// sit in a bucket of their own that no walk visits.
//
// The order: a unit's pairs are consecutive in the output, units in
// ascending (tile, row) order, as before; but the walk meets its b points
// by (cell, b), so each unit's segment is sorted by b before it leaves.
// Three kernels:
// - count: one thread per unit walks and counts; each block's sum;
// - scan: one block turns the block sums into exclusive offsets and the
//   total (the only number the host waits for: it sizes the output);
// - write: the same walk again. A unit of at most kReg pairs keeps them
//   sorted in registers (insertion) and writes them once; a larger unit
//   writes its b indices unsorted into its segment of out_a, and after
//   the block's barrier one warp sorts each such segment (the block's
//   warps take them in turn): the segment's b indices (distinct, within
//   one tile) set bits of the warp's 4,096-bit map in shared memory,
//   chunk by chunk of the tile, and each lane writes the set bits of its
//   four 32-bit words at the map's prefix count; then out_a gets the
//   row.
// Nothing of size (Na, tile) is written or read back, and no pair outside
// the runs a unit walks has its cells tested.
//
// What bounds it on an H100: the distance (7 operations) on the pairs
// inside the cell layers and 2 (2L + 1) start-table loads per unit, twice
// (count and write), against 13 bytes read per point, the index's 16
// bytes per b point and 8 bytes written per pair; at a window's size the
// host's wait for the pair total between the passes. Built with
// --fmad=false so that no product is contracted into an FMA: each
// operation rounds once, exactly as the plain version's separate PyTorch
// ops do, and the pair list equals the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "join_walk.cuh"

namespace {

constexpr int kThreads = 128;  // a rows per block (ops/join.py mirrors it)
constexpr int kScanThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kReg = 16;                  // pairs a unit sorts in registers
constexpr int kMapWords = 128;            // a warp's map: 4 words a lane
constexpr int kChunk = kMapWords * 32;    // b indices per map: 4,096

struct Args {
  const float* ax;
  const float* ay;
  const int32_t* acell;
  const uint8_t* avalid;
  const int32_t* rows;  // nullptr: every a row
  int m;                // a rows walked (rows' length, or na)
  const int32_t* bcell;  // original b order (the per-pair tested bucket)
  const int32_t* perm;   // the join index
  const int32_t* key;
  const int32_t* starts;  // nullptr: no start table
  const float* sx;
  const float* sy;
  int nb;
  int tile;
  int stride;
  float cx;
  float cy;
  float r2;
  int layers;
  int n;
};

// The walk of one unit: calls emit(j) for every surviving b index j of
// row `row` (valid) in tile `t`, in the index's order.
template <bool kAll, typename Emit>
__device__ __forceinline__ void walk(const Args& p, int row, int t,
                                     Emit emit) {
  const float a0 = p.ax[row] - p.cx;
  const float a1 = p.ay[row] - p.cy;
  const float a2 = a0 * a0 + a1 * a1;
  auto visit = [&](int k) {
    const float b0 = __ldg(p.sx + k) - p.cx;
    const float b1 = __ldg(p.sy + k) - p.cy;
    const float b2 = b0 * b0 + b1 * b1;
    const float cross = a0 * b0 + a1 * b1;
    const float d2 = (a2 + b2) - 2.0f * cross;
    if (d2 <= p.r2) emit(__ldg(p.perm + k));
  };
  const int lo = t * p.tile;
  const join_walk::Section sec{p.key, p.starts, lo, min(p.nb, lo + p.tile),
                               t * p.stride};
  const int cells = p.n * p.n;
  if (kAll) {
    const int e = sec.first(lo, join_walk::dead_bucket(cells));
    for (int k = lo; k < e; ++k) visit(k);
    return;
  }
  const int c = p.acell[row];
  if (c < 0) return;
  const int acx = c / p.n;
  const int acy = c - acx * p.n;
  join_walk::grid_runs(sec, acx, acy, p.layers, p.n, [&](int s, int e) {
    for (int k = s; k < e; ++k) visit(k);
  });
  if (static_cast<long long>(acx) + p.layers >= p.n) {
    const int2 run =
        join_walk::bucket_run(sec, join_walk::high_bucket(cells));
    for (int k = run.x; k < run.y; ++k) {
      const int bc = __ldg(p.bcell + __ldg(p.perm + k));
      const int q = bc / p.n;
      if (abs(acx - q) <= p.layers && abs(acy - (bc - q * p.n)) <= p.layers) {
        visit(k);
      }
    }
  }
}

__device__ __forceinline__ int row_of(const Args& p, int i) {
  return p.rows != nullptr ? p.rows[i] : i;
}

// Exclusive prefix sum over the block of one int per thread;
// `warp_sums` is shared, kWarps entries.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += u;
  }
  __syncthreads();  // warp_sums is free
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  return before + inc - v;
}

template <bool kAll>
__global__ void __launch_bounds__(kThreads)
join_count_kernel(Args p, int32_t* __restrict__ counts,
                  int32_t* __restrict__ block_sums) {
  __shared__ int s_warp[kWarps];
  const int t = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < p.m;
  const int row = in ? row_of(p, i) : 0;
  int c = 0;
  if (in && p.avalid[row] != 0) walk<kAll>(p, row, t, [&](int) { ++c; });
  if (in) counts[static_cast<long long>(t) * p.m + i] = c;
  int s = c;
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
    block_sums[t * gridDim.x + blockIdx.x] = total;
  }
}

// One block: block_sums[0..nblocks) -> exclusive offsets in place, and the
// total at block_sums[nblocks].
__global__ void __launch_bounds__(kScanThreads)
join_scan_kernel(int32_t* __restrict__ block_sums, int nblocks) {
  __shared__ int s_part[kScanThreads];
  const int per = (nblocks + kScanThreads - 1) / kScanThreads;
  const int lo = min(nblocks, threadIdx.x * per);
  const int hi = min(nblocks, lo + per);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += block_sums[k];
  s_part[threadIdx.x] = sum;
  __syncthreads();
  // Hillis-Steele inclusive scan of the per-thread sums
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int v = threadIdx.x >= off ? s_part[threadIdx.x - off] : 0;
    __syncthreads();
    s_part[threadIdx.x] += v;
    __syncthreads();
  }
  int run = s_part[threadIdx.x] - sum;
  for (int k = lo; k < hi; ++k) {
    const int v = block_sums[k];
    block_sums[k] = run;
    run += v;
  }
  if (threadIdx.x == kScanThreads - 1) block_sums[nblocks] = s_part[threadIdx.x];
}

// Inserts v into the ascending r[0..k) (k < kReg); indices are constant
// after unrolling, so r stays in registers.
__device__ __forceinline__ void insert_sorted(int (&r)[kReg], int k, int v) {
  bool placed = false;
#pragma unroll
  for (int q = kReg - 1; q >= 0; --q) {
    if (!placed && q <= k) {
      if (q > 0 && r[q - 1] > v) {
        r[q] = r[q - 1];
      } else {
        r[q] = v;
        placed = true;
      }
    }
  }
}

// One warp sorts one segment [pos, pos + cnt) of tile t: its b indices
// are in out_a (distinct, within the tile), ascending into out_b; then
// out_a gets the row. `map` is the warp's kMapWords words.
__device__ void sort_segment(const Args& p, int t, int pos, int cnt, int row,
                             uint32_t* map, int32_t* __restrict__ out_a,
                             int32_t* __restrict__ out_b) {
  const int lane = threadIdx.x & 31;
  const int jlo = t * p.tile;
  const int jhi = min(p.nb, jlo + p.tile);
  int done = 0;  // the segment's entries below this chunk
  for (int base = jlo; base < jhi; base += kChunk) {
    for (int w = lane; w < kMapWords; w += 32) map[w] = 0u;
    __syncwarp();
    for (int e = lane; e < cnt; e += 32) {
      const int d = out_a[pos + e] - base;
      if (d >= 0 && d < kChunk) atomicOr(&map[d >> 5], 1u << (d & 31));
    }
    __syncwarp();
    // lane owns words 4 lane .. 4 lane + 3, in order
    uint32_t words[4];
    int own = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      words[q] = map[4 * lane + q];
      own += __popc(words[q]);
    }
    int inc = own;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += u;
    }
    int at = pos + done + inc - own;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = words[q];
      while (word != 0u) {
        const int bit = __ffs(word) - 1;
        word &= word - 1u;
        out_b[at++] = base + (4 * lane + q) * 32 + bit;
      }
    }
    done += __shfl_sync(0xffffffffu, inc, 31);
    __syncwarp();  // every read of this chunk's map and of out_a is done
  }
  for (int e = lane; e < cnt; e += 32) out_a[pos + e] = row;
}

template <bool kAll>
__global__ void __launch_bounds__(kThreads)
join_write_kernel(Args p, const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ offsets,
                  int32_t* __restrict__ out_a, int32_t* __restrict__ out_b) {
  __shared__ int s_warp[kWarps];
  __shared__ uint32_t s_map[kWarps][kMapWords];
  __shared__ int s_big_pos[kThreads], s_big_cnt[kThreads],
      s_big_row[kThreads];
  __shared__ int s_nbig;
  const int t = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < p.m;
  const int row = in ? row_of(p, i) : 0;
  const bool live = in && p.avalid[row] != 0;
  const int c = in ? counts[static_cast<long long>(t) * p.m + i] : 0;
  if (threadIdx.x == 0) s_nbig = 0;
  int pos = offsets[t * gridDim.x + blockIdx.x] +
            block_exclusive_sum(c, s_warp);
  if (live && c > 0) {
    if (c <= kReg) {
      int r[kReg];
      int k = 0;
      walk<kAll>(p, row, t, [&](int j) { insert_sorted(r, k++, j); });
#pragma unroll
      for (int q = 0; q < kReg; ++q) {
        if (q < k) {
          out_a[pos + q] = row;
          out_b[pos + q] = r[q];
        }
      }
    } else {
      const int slot = atomicAdd(&s_nbig, 1);
      s_big_pos[slot] = pos;
      s_big_cnt[slot] = c;
      s_big_row[slot] = row;
      walk<kAll>(p, row, t, [&](int j) { out_a[pos++] = j; });
    }
  }
  __syncthreads();  // the large segments' b indices are in out_a
  const int nbig = s_nbig;
  const int warp = threadIdx.x >> 5;
  for (int u = warp; u < nbig; u += kWarps) {
    sort_segment(p, t, s_big_pos[u], s_big_cnt[u], s_big_row[u],
                 s_map[warp], out_a, out_b);
  }
}

template <bool kAll>
int launch(const Args& p, int32_t* counts, int32_t* offsets, int32_t* out_a,
           int32_t* out_b, cudaStream_t stream) {
  const int n_tiles = p.nb > 0 ? (p.nb + p.tile - 1) / p.tile : 0;
  const dim3 grid((p.m + kThreads - 1) / kThreads, n_tiles);
  const int nblocks = static_cast<int>(grid.x * grid.y);
  if (out_a == nullptr) {
    if (nblocks > 0) {
      join_count_kernel<kAll><<<grid, kThreads, 0, stream>>>(p, counts,
                                                            offsets);
    }
    join_scan_kernel<<<1, kScanThreads, 0, stream>>>(offsets, nblocks);
  } else if (nblocks > 0) {
    join_write_kernel<kAll><<<grid, kThreads, 0, stream>>>(
        p, counts, offsets, out_a, out_b);
  }
  return static_cast<int>(cudaGetLastError());
}

int entry(const float* ax, const float* ay, const int32_t* acell,
          const uint8_t* avalid, const int32_t* rows, int m,
          const int32_t* bcell, int nb, const int32_t* perm,
          const int32_t* key, const int32_t* starts, const float* sx,
          const float* sy, int tile, int stride, float cx, float cy, float r2,
          int layers, int all_cells, int n, int32_t* counts,
          int32_t* offsets, int32_t* out_a, int32_t* out_b, void* stream) {
  if (n < 1 || n >= (1 << 15) || tile < 1 || stride < 0 || m < 0 ||
      nb < 0 || (!all_cells && layers >= (1 << 30))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args p{ax, ay, acell, avalid, rows, m, bcell, perm, key, starts,
               sx, sy, nb, tile, stride, cx, cy, r2, layers, n};
  const auto s = static_cast<cudaStream_t>(stream);
  return all_cells ? launch<true>(p, counts, offsets, out_a, out_b, s)
                   : launch<false>(p, counts, offsets, out_a, out_b, s);
}

}  // namespace

// a*: (na,) x, y f32, cell int32, valid bool; rows: nullptr or (m,) int32
// ascending a rows to walk (m = na without it); bcell: (nb,) int32, the b
// batch's cells in their own order; perm, key, sx, sy: (nb,) the window's
// join index of b (join_walk.cuh) with its start table (nullptr: none),
// built with `tile` b points per tile (the pair order's first key) and
// `stride`; cx, cy: the expansion's centre in
// f32; r2 = r * r in f32; layers: the cell-layer bound, and all_cells =
// (layers >= 2^30), when every pair passes the cell test (the sentinel of
// a cell < 0 included); n: the grid's cells per side. counts: (tiles * m,)
// int32 scratch; offsets: (blocks + 1,) int32, blocks = ceil(m / 128) *
// tiles, which returns the pair total at offsets[blocks].
// join_lattice_count launches the count and scan kernels (out_a = out_b =
// nullptr); join_lattice_write, after the host has read the total and
// allocated out_a and out_b (total,) int32, the write kernel. Each
// launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when the launches were accepted).
extern "C" int join_lattice_count(
    const float* ax, const float* ay, const int32_t* acell,
    const uint8_t* avalid, const int32_t* rows, int m, const int32_t* bcell,
    int nb, const int32_t* perm, const int32_t* key, const int32_t* starts,
    const float* sx, const float* sy, int tile, int stride, float cx,
    float cy, float r2, int layers, int all_cells, int n, int32_t* counts,
    int32_t* offsets, int32_t* out_a, int32_t* out_b, void* stream) {
  if (out_a != nullptr || out_b != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return entry(ax, ay, acell, avalid, rows, m, bcell, nb, perm, key, starts,
               sx, sy, tile, stride, cx, cy, r2, layers, all_cells, n, counts,
               offsets, nullptr, nullptr, stream);
}

extern "C" int join_lattice_write(
    const float* ax, const float* ay, const int32_t* acell,
    const uint8_t* avalid, const int32_t* rows, int m, const int32_t* bcell,
    int nb, const int32_t* perm, const int32_t* key, const int32_t* starts,
    const float* sx, const float* sy, int tile, int stride, float cx,
    float cy, float r2, int layers, int all_cells, int n, int32_t* counts,
    int32_t* offsets, int32_t* out_a, int32_t* out_b, void* stream) {
  if (out_a == nullptr || out_b == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return entry(ax, ay, acell, avalid, rows, m, bcell, nb, perm, key, starts,
               sx, sy, tile, stride, cx, cy, r2, layers, all_cells, n, counts,
               offsets, out_a, out_b, stream);
}
