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
// (~4 us at 3.35 TB/s).
//
// What the design does about it:
// - Every block owns a disjoint range of kPointsPerThread * kThreads points,
//   kept in registers, so no block reads another's partial and there is no
//   cross-block reduction and no atomic.
// - The Pallas grid's sequential edge-chunk dimension (which revisited the
//   output block) becomes a loop inside the block: each chunk of kEdgeChunk
//   edges is staged in shared memory, and its per-edge divides (the ray
//   slope and the reciprocal squared length) are computed once per edge
//   there, so the per-(point, edge) loop is multiply/add/compare only.
// - All threads read the same edge at the same time (a shared-memory
//   broadcast); a masked edge is skipped by the whole block at once.
// - Crossings are counted in an int register (the TPU kernel needed f32).
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

}  // namespace

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
