// K4: distance from every point of a window to ONE query polygon or
// linestring, with even-odd containment, fused in one pass over the edges.
//
// Replaces the Pallas kernel _pip_kernel / _pip_pallas
// (spatialflink_tpu/ops/pallas_kernels.py:100-209, pallas_call at :195).
// Plain PyTorch version: spatialflink_tpu_torch/ops/hopper_kernels.py
// pip_dist_plain, whose operation order this file follows step for step.
//
// What bounds it on an H100: arithmetic. Each (point, edge) pair costs
// 26 f32 operations (ray-cast test and clamped projection) against 8 bytes
// read per point and 17 bytes per edge, so at 1M points x 64 edges the
// operations floor (~25 us at 67 TFLOP/s) is several times the bytes floor
// (~4 us at 3.35 TB/s). Without FMA each operation issues alone, so the
// dense fold cannot beat ~50 us there: only folding fewer pairs helps.
//
// Two kernels:
// - pip_dist_kernel, the dense fold (no table; geometries of more than one
//   staged chunk): every block owns a disjoint range of kPointsPerThread *
//   kThreads points, kept in registers (no cross-block reduction, no
//   atomic); the Pallas grid's sequential edge-chunk dimension becomes a
//   loop inside the block: each chunk of kEdgeChunk edges is staged in
//   shared memory with its per-edge divides (the ray slope and the
//   reciprocal squared length) computed once per edge, and all threads read
//   the same edge at the same time (a shared-memory broadcast).
// - pip_dist_table_kernel, the per-cell edge table
//   (hopper_kernels.pip_table, built once per query geometry and grid):
//   for each grid cell, a bit set of the edges that can change the result
//   of a point in the cell (an edge whose distance lower bound over the
//   cell exceeds the least upper bound of any edge cannot be the nearest;
//   an edge that no ray from the cell can cross, or that every ray from
//   the cell crosses, is a constant), the constant crossing parity of the
//   unlisted edges, and an inside flag for cells wholly inside an areal
//   geometry (distance 0, no fold at all). The geometry's <= kEdgeChunk
//   edges are staged once; each point reads its cell (PointBatch.cell),
//   its cell's flags and bit set, and folds only the listed edges (lanes
//   gather different edges from shared memory). Cell -1 and cells outside
//   the table fold every edge. A min and a parity do not depend on the
//   order or the set of the edges that cannot change them, so the result
//   equals the dense fold bit for bit (the table's margins and their
//   derivation: hopper_kernels.pip_table). What bounds it: the gathers,
//   7 shared loads per (lane, edge) whose bank conflicts grow with the
//   edge count, so it pays where the lists are short against the edges:
//   at 64 edges a point's list averages ~6.5 edges. Up to 64 edges (one
//   bit word) a thread walks its points one after another; above, one
//   merged walk over all its points' lists keeps the warp's time at its
//   longest lane's total.
//
// The chunk staging and the per-(point, edge) fold live in pip_edges.cuh
// (K4's own; K4x has its own fold). Built with --fmad=false so that no
// a*b+c is contracted into an FMA: each operation rounds once, exactly as
// the plain version's separate PyTorch ops do, and the kernel's result
// equals the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pip_edges.cuh"

namespace {

__global__ void __launch_bounds__(pip::kThreads)
pip_dist_kernel(const float* __restrict__ px, const float* __restrict__ py,
                int n, const float* __restrict__ edges,
                const uint8_t* __restrict__ edge_mask, int ne, int is_areal,
                float* __restrict__ dist) {
  __shared__ pip::EdgeChunk s;
  float x[pip::kPointsPerThread], y[pip::kPointsPerThread];
  float d[pip::kPointsPerThread];
  pip::load_points(px, py, n, x, y);
  pip::geometry_dist(s, edges, edge_mask, ne, is_areal != 0, x, y, d);
  const int base = blockIdx.x * pip::kPointsPerBlock + threadIdx.x;
#pragma unroll
  for (int p = 0; p < pip::kPointsPerThread; ++p) {
    const int i = base + p * pip::kThreads;
    if (i < n) dist[i] = d[p];
  }
}

__global__ void __launch_bounds__(pip::kThreads)
pip_dist_table_kernel(const float* __restrict__ px,
                      const float* __restrict__ py,
                      const int32_t* __restrict__ cell, int n,
                      const float* __restrict__ edges,
                      const uint8_t* __restrict__ edge_mask, int ne,
                      int is_areal, const unsigned long long* __restrict__ bits,
                      int words, const uint8_t* __restrict__ flags,
                      int num_cells, float* __restrict__ dist) {
  __shared__ pip::EdgeChunk s;
  __shared__ unsigned long long s_valid[pip::kEdgeChunk / 64];  // as a row
  constexpr int kP = pip::kPointsPerThread;
  pip::stage_chunk(s, edges, edge_mask, 0, ne);  // ne <= kEdgeChunk
  __syncthreads();
  if (threadIdx.x < words) {
    unsigned long long v = 0;
    for (int e = 0; e < 64; ++e) {
      const int j = threadIdx.x * 64 + e;
      if (j < ne && s.valid[j]) v |= 1ull << e;
    }
    s_valid[threadIdx.x] = v;
  }
  __syncthreads();
  // This thread's points (kP of them, kThreads apart) and their rows, read
  // up front: its cell's table row (the valid edges for a point without a
  // cell), the row's first word, and the crossings so far (the cell's
  // parity bit). A point of an inside cell is answered here and gets no
  // row.
  const int base = blockIdx.x * pip::kPointsPerBlock + threadIdx.x;
  float xs[kP], ys[kP];
  const unsigned long long* rows[kP];
  unsigned long long bs[kP];
  int crosses[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int i = base + p * pip::kThreads;
    xs[p] = i < n ? px[i] : 0.0f;
    ys[p] = i < n ? py[i] : 0.0f;
    const int c = i < n ? cell[i] : -1;
    rows[p] = i < n ? s_valid : nullptr;  // past n: nothing to fold
    crosses[p] = 0;
    if (c >= 0 && c < num_cells) {
      const int f = flags[c];
      rows[p] = bits + static_cast<size_t>(c) * words;
      crosses[p] = f & 1;  // the unlisted edges' constant crossings
      if (is_areal && (f & 2)) {  // wholly inside: no fold
        dist[i] = 0.0f;
        rows[p] = nullptr;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) bs[p] = rows[p] != nullptr ? rows[p][0] : 0ull;
  if (words == 1) {
    // up to 64 edges: one point after another; each point's list is one
    // word already in a register, and all lanes finish a point together
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (rows[p] == nullptr) continue;
      float mind2 = pip::kBig;
      for (unsigned long long b = bs[p]; b; b &= b - 1) {
        pip::fold_pair(s, __ffsll(static_cast<long long>(b)) - 1, xs[p],
                       ys[p], mind2, crosses[p]);
      }
      dist[base + p * pip::kThreads] =
          (is_areal && (crosses[p] & 1)) ? 0.0f : sqrtf(mind2);
    }
    return;
  }
  // Longer lists: one merged walk over the listed edges of all kP points,
  // so that a warp runs as long as its longest lane's total, not the sum
  // over the points of each point's longest lane (measured: the walk's
  // bookkeeping diverges, which costs more than it saves for one word).
  // The current point is slot 0; when it is done the others move down one
  // slot (no dynamic register indexing).
  int next = 0, w = 0;
  float mind2 = pip::kBig;
  while (next < kP) {
    if (bs[0]) {
      const int e = w * 64 + __ffsll(static_cast<long long>(bs[0])) - 1;
      bs[0] &= bs[0] - 1;
      pip::fold_pair(s, e, xs[0], ys[0], mind2, crosses[0]);
      continue;
    }
    if (rows[0] != nullptr && ++w < words) {
      bs[0] = rows[0][w];
      continue;
    }
    if (rows[0] != nullptr) {
      dist[base + next * pip::kThreads] =
          (is_areal && (crosses[0] & 1)) ? 0.0f : sqrtf(mind2);
    }
    ++next;
    w = 0;
    mind2 = pip::kBig;
#pragma unroll
    for (int p = 0; p + 1 < kP; ++p) {
      xs[p] = xs[p + 1];
      ys[p] = ys[p + 1];
      rows[p] = rows[p + 1];
      bs[p] = bs[p + 1];
      crosses[p] = crosses[p + 1];
    }
  }
}

}  // namespace

// The per-cell table form (ne <= 512 padded edges): cell (n,) int32 cell
// ids of the points; bits (num_cells, words) uint64 listed edges, bit b of
// word w = edge 64 w + b; flags (num_cells,) uint8: bit 0 the unlisted
// edges' crossing parity, bit 1 inside. Other arguments as
// pip_dist_launch. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (cudaErrorInvalidValue when ne exceeds one chunk).
extern "C" int pip_dist_table_launch(const float* px, const float* py,
                                     const int32_t* cell, int n,
                                     const float* edges,
                                     const uint8_t* edge_mask, int ne,
                                     int is_areal,
                                     const unsigned long long* bits,
                                     int words, const uint8_t* flags,
                                     int num_cells, float* dist,
                                     void* stream) {
  if (ne > pip::kEdgeChunk || words * 64 < ne) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int blocks = (n + pip::kPointsPerBlock - 1) / pip::kPointsPerBlock;
    pip_dist_table_kernel<<<blocks, pip::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        px, py, cell, n, edges, edge_mask, ne, is_areal, bits, words, flags,
        num_cells, dist);
  }
  return static_cast<int>(cudaGetLastError());
}

// px, py: (n,) f32; edges: (ne, 4) f32 [x1, y1, x2, y2]; edge_mask: (ne,)
// bool; dist: (n,) f32 output. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int pip_dist_launch(const float* px, const float* py, int n,
                               const float* edges, const uint8_t* edge_mask,
                               int ne, int is_areal, float* dist,
                               void* stream) {
  if (n > 0) {
    const int blocks = (n + pip::kPointsPerBlock - 1) / pip::kPointsPerBlock;
    pip_dist_kernel<<<blocks, pip::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        px, py, n, edges, edge_mask, ne, is_areal, dist);
  }
  return static_cast<int>(cudaGetLastError());
}
