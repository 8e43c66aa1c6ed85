// K4x: the (G, N) lattice of distances from every point of a window to
// each of G polygons or linestrings (0 inside an areal geometry, else the
// min boundary distance), with a per-geometry is_areal flag and any edge
// count.
//
// Replaces the Pallas experiment build_kernel / kern
// (benchmarks/exp_pip_lattice.py:37-125, pallas_call at :112), the
// multi-geometry K4 written to replace spatialflink_tpu/ops/geom.py
// points_to_geoms_dist (:56), which the JAX package's multi-query paths
// run over a point stream (knn_points_to_geom_queries :64,
// range_points_to_geom_queries :236). Plain PyTorch version:
// spatialflink_tpu_torch/ops/hopper_kernels.py pip_lattice_plain (the port
// of points_to_edges_dist and points_in_geoms, in (N, G) layout).
//
// Layout: the output is (G, N), one row per geometry, which is what the
// multi-query paths consume as (Q, N); the plain version keeps the JAX
// package's (N, G) and the wrapper returns its transpose on the CPU.
//
// What bounds it on an H100: arithmetic when geometries have many edges
// (26 f32 operations per point-edge pair), bytes when they have few: at
// the experiment's shape (65,536 points x 10,240 rectangles of 4 edges)
// the 2.7 GB output write alone is ~0.8 ms at 3.35 TB/s, against ~1.0 ms
// of operations.
//
// What the design does about it:
// - Grid x: disjoint ranges of 1,024 points, kept in registers for the
//   whole block; grid y: a stride over the geometries, so that a block
//   loads its points once and folds up to G / gridDim.y geometries into
//   them (the Pallas tile's (points x geometry lanes) becomes a loop over
//   geometries inside the block).
// - Each geometry's edges stream through shared memory in 512-edge chunks
//   with the per-edge divides done once per edge (pip_edges.cuh, shared
//   with K4), so the inner loop is multiply/add/compare only.
// - A geometry's row of 1,024 outputs is written by the block's threads at
//   neighbouring addresses.
//
// Built with --fmad=false: each operation rounds once, as the plain
// version's separate PyTorch ops do, and the result equals the plain
// version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pip_edges.cuh"

namespace {

constexpr int kMaxGeomBlocks = 64;  // grid y: geometries strided per block

__global__ void __launch_bounds__(pip::kThreads)
pip_lattice_kernel(const float* __restrict__ px,
                   const float* __restrict__ py, int n,
                   const float* __restrict__ edges,
                   const uint8_t* __restrict__ edge_mask, int ne,
                   const uint8_t* __restrict__ is_areal, int g,
                   float* __restrict__ dist) {
  __shared__ pip::EdgeChunk s;
  float x[pip::kPointsPerThread], y[pip::kPointsPerThread];
  float d[pip::kPointsPerThread];
  pip::load_points(px, py, n, x, y);
  const int base = blockIdx.x * pip::kPointsPerBlock + threadIdx.x;
  for (int gi = blockIdx.y; gi < g; gi += gridDim.y) {
    const size_t off = static_cast<size_t>(gi) * ne;
    pip::geometry_dist(s, edges + 4 * off, edge_mask + off, ne,
                       is_areal[gi] != 0, x, y, d);
    float* row = dist + static_cast<size_t>(gi) * n;
#pragma unroll
    for (int p = 0; p < pip::kPointsPerThread; ++p) {
      const int i = base + p * pip::kThreads;
      if (i < n) row[i] = d[p];
    }
  }
}

}  // namespace

// px, py: (n,) f32; edges: (g, ne, 4) f32 [x1, y1, x2, y2]; edge_mask:
// (g, ne) bool; is_areal: (g,) bool; dist: (g, n) f32 output. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 when
// the launch was accepted).
extern "C" int pip_lattice_launch(const float* px, const float* py, int n,
                                  const float* edges,
                                  const uint8_t* edge_mask, int ne,
                                  const uint8_t* is_areal, int g, float* dist,
                                  void* stream) {
  if (n > 0 && g > 0) {
    const dim3 grid((n + pip::kPointsPerBlock - 1) / pip::kPointsPerBlock,
                    g < kMaxGeomBlocks ? g : kMaxGeomBlocks);
    pip_lattice_kernel<<<grid, pip::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        px, py, n, edges, edge_mask, ne, is_areal, g, dist);
  }
  return static_cast<int>(cudaGetLastError());
}
