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
// layers (2^30 where either cell is -1), and the centred expansion
// (a2 + b2) - 2 * (a0*b0 + a1*b1) <= r2, with a0 = ax - cx, a1 = ay - cy,
// a2 = a0*a0 + a1*a1 (and b's alike) in f32. The plain version clamps the
// expansion at 0 first; for r2 >= 0 that changes no comparison, so it is
// left out here. The pairs come out in the JAX package's order: by b tile,
// then by a, then by b; with a row list (the a rows that K7 found
// partners for) only those rows, in ascending order, keeping their own
// indices.
//
// What bounds it on an H100: operations, ~7 per pair for the cell test
// and 7 more for the expansion of the pairs inside the cell layers,
// against 13 bytes read per point and 8 written per pair.
//
// Design: a unit is (b tile, a row); its pairs are consecutive in the
// output, units in ascending (tile, row) order. Three kernels:
// - count: one thread per unit (blocks of kThreads rows of one tile, the
//   tile's b points staged through shared memory in chunks of kStage with
//   b0, b1, b2 and the cell's (cx, cy) computed once per point, read by
//   every thread of a warp at once), writes the unit's pair count and the
//   block's sum;
// - scan: one block turns the block sums into exclusive offsets and the
//   total (the only number the host waits for: it sizes the output);
// - write: the same walk again, each thread writing its pairs from its
//   block's offset plus its exclusive position within the block.
// Nothing of size (Na, tile) is ever written or read back. Built with
// --fmad=false so that no product is contracted into an FMA: each
// operation rounds once, exactly as the plain version's separate PyTorch
// ops do, and the pair list equals the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // a rows per block (ops/join.py mirrors it)
constexpr int kStage = 1024;   // b points per shared-memory chunk (24 KB)
constexpr int kScanThreads = 1024;
// (cx, cy) of a b point that never passes the cell test: a padded slot
// always, a cell of -1 unless every cell is admitted (kAll); farther than
// any layer bound below 2^30 from a cx in [0, 2^15)
constexpr int kDead = 3 << 29;
constexpr int kOutside = kDead + 1;

__device__ __forceinline__ int floor_div(int a, int n) {
  int q = a / n;
  if ((a % n != 0) && ((a < 0) != (n < 0))) --q;
  return q;
}

struct Args {
  const float* ax;
  const float* ay;
  const int32_t* acell;
  const uint8_t* avalid;
  const int32_t* rows;  // nullptr: every a row
  int m;                // a rows walked (rows' length, or na)
  const float* bx;
  const float* by;
  const int32_t* bcell;
  const uint8_t* bvalid;
  int nb;
  int tile;
  float cx;
  float cy;
  float r2;
  int layers;
  int n;
};

// The walk of one unit: calls emit(j) for every surviving b index j of
// row `row` in tile `t`, in ascending j. All threads of the block call it
// (it stages shared memory); `live` says whether this thread's row counts.
template <bool kAll, typename Emit>
__device__ __forceinline__ void walk(const Args& p, int row, bool live, int t,
                                     float4* s_b, int2* s_c, Emit emit) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  int acx = 0, acy = 0;
  if (live) {
    a0 = p.ax[row] - p.cx;
    a1 = p.ay[row] - p.cy;
    a2 = a0 * a0 + a1 * a1;
    const int c = p.acell[row];
    acx = floor_div(c, p.n);
    acy = c - acx * p.n;
    // a cell of -1 meets no cell within the layers unless all are admitted
    if (!kAll && c < 0) live = false;
  }
  const int lo = t * p.tile;
  const int hi = min(p.nb, lo + p.tile);
  for (int base = lo; base < hi; base += kStage) {
    const int cnt = min(kStage, hi - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const int j = base + k;
      const float b0 = p.bx[j] - p.cx;
      const float b1 = p.by[j] - p.cy;
      s_b[k] = make_float4(b0, b1, b0 * b0 + b1 * b1, 0.0f);
      const int c = p.bcell[j];
      int2 bc;
      if (p.bvalid[j] == 0) {
        bc = make_int2(kDead, 0);
      } else if (c < 0) {
        bc = make_int2(kOutside, 0);
      } else {
        const int q = floor_div(c, p.n);
        bc = make_int2(q, c - q * p.n);
      }
      s_c[k] = bc;
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < cnt; ++k) {
      const int2 bc = s_c[k];
      if (kAll) {
        if (bc.x == kDead) continue;
      } else if (abs(acx - bc.x) > p.layers || abs(acy - bc.y) > p.layers) {
        continue;
      }
      const float4 b = s_b[k];
      const float cross = a0 * b.x + a1 * b.y;
      const float d2 = (a2 + b.z) - 2.0f * cross;
      if (d2 <= p.r2) emit(base + k);
    }
  }
}

__device__ __forceinline__ int row_of(const Args& p, int i) {
  return p.rows != nullptr ? p.rows[i] : i;
}

template <bool kAll>
__global__ void __launch_bounds__(kThreads)
join_count_kernel(Args p, int32_t* __restrict__ counts,
                  int32_t* __restrict__ block_sums) {
  __shared__ float4 s_b[kStage];
  __shared__ int2 s_c[kStage];
  __shared__ int s_warp[kThreads / 32];
  const int t = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < p.m;
  const int row = in ? row_of(p, i) : 0;
  const bool live = in && p.avalid[row] != 0;
  int c = 0;
  walk<kAll>(p, row, live, t, s_b, s_c, [&](int) { ++c; });
  if (in) counts[static_cast<long long>(t) * p.m + i] = c;
  int s = c;
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += s_warp[w];
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

template <bool kAll>
__global__ void __launch_bounds__(kThreads)
join_write_kernel(Args p, const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ offsets,
                  int32_t* __restrict__ out_a, int32_t* __restrict__ out_b) {
  __shared__ float4 s_b[kStage];
  __shared__ int2 s_c[kStage];
  __shared__ int s_warp[kThreads / 32];
  const int t = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < p.m;
  const int row = in ? row_of(p, i) : 0;
  const bool live = in && p.avalid[row] != 0;
  const int c = in ? counts[static_cast<long long>(t) * p.m + i] : 0;
  // exclusive position of this thread's pairs within the block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = c;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  int pos = offsets[t * gridDim.x + blockIdx.x] + before + inc - c;
  walk<kAll>(p, row, live, t, s_b, s_c, [&](int j) {
    out_a[pos] = row;
    out_b[pos] = j;
    ++pos;
  });
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
          const uint8_t* avalid, const int32_t* rows, int m, const float* bx,
          const float* by, const int32_t* bcell, const uint8_t* bvalid, int nb,
          int tile, float cx, float cy, float r2, int layers, int all_cells,
          int n, int32_t* counts, int32_t* offsets, int32_t* out_a,
          int32_t* out_b, void* stream) {
  if (n < 1 || n >= (1 << 15) || tile < 1 || m < 0 || nb < 0 ||
      (!all_cells && layers >= (1 << 30))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args p{ax, ay, acell, avalid, rows, m, bx, by, bcell, bvalid, nb,
               tile, cx, cy, r2, layers, n};
  const auto s = static_cast<cudaStream_t>(stream);
  return all_cells ? launch<true>(p, counts, offsets, out_a, out_b, s)
                   : launch<false>(p, counts, offsets, out_a, out_b, s);
}

}  // namespace

// a*: (na,) x, y f32, cell int32, valid bool; rows: nullptr or (m,) int32
// ascending a rows to walk (m = na without it); b*: (nb,) likewise; tile:
// b points per tile (the pair order's first key); cx, cy: the expansion's
// centre in f32; r2 = r * r in f32; layers: the cell-layer bound, and
// all_cells = (layers >= 2^30), when every pair passes the cell test (the
// sentinel of a -1 cell included); n: the grid's cells per side.
// counts: (tiles * m,) int32 scratch; offsets: (blocks + 1,) int32, blocks =
// ceil(m / 128) * tiles, which returns the pair total at offsets[blocks].
// join_lattice_count launches the count and scan kernels (out_a = out_b =
// nullptr); join_lattice_write, after the host has read the total and
// allocated out_a and out_b (total,) int32, the write kernel. Each
// launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when the launches were accepted).
extern "C" int join_lattice_count(
    const float* ax, const float* ay, const int32_t* acell,
    const uint8_t* avalid, const int32_t* rows, int m, const float* bx,
    const float* by, const int32_t* bcell, const uint8_t* bvalid, int nb,
    int tile, float cx, float cy, float r2, int layers, int all_cells, int n,
    int32_t* counts, int32_t* offsets, int32_t* out_a, int32_t* out_b,
    void* stream) {
  if (out_a != nullptr || out_b != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return entry(ax, ay, acell, avalid, rows, m, bx, by, bcell, bvalid, nb,
               tile, cx, cy, r2, layers, all_cells, n, counts, offsets,
               nullptr, nullptr, stream);
}

extern "C" int join_lattice_write(
    const float* ax, const float* ay, const int32_t* acell,
    const uint8_t* avalid, const int32_t* rows, int m, const float* bx,
    const float* by, const int32_t* bcell, const uint8_t* bvalid, int nb,
    int tile, float cx, float cy, float r2, int layers, int all_cells, int n,
    int32_t* counts, int32_t* offsets, int32_t* out_a, int32_t* out_b,
    void* stream) {
  if (out_a == nullptr || out_b == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return entry(ax, ay, acell, avalid, rows, m, bx, by, bcell, bvalid, nb,
               tile, cx, cy, r2, layers, all_cells, n, counts, offsets,
               out_a, out_b, stream);
}
