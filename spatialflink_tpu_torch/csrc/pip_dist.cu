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
// Built with --fmad=false so that no a*b+c is contracted into an FMA: each
// operation rounds once, exactly as the plain version's separate PyTorch
// ops do, and the kernel's result equals the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPointsPerThread = 4;
constexpr int kEdgeChunk = 512;
constexpr float kBig = 3.4e38f;  // "infinitely far" (pallas_kernels._BIG)

__global__ void __launch_bounds__(kThreads)
pip_dist_kernel(const float* __restrict__ px, const float* __restrict__ py,
                int n, const float* __restrict__ edges,
                const uint8_t* __restrict__ edge_mask, int ne, int is_areal,
                float* __restrict__ dist) {
  __shared__ float s_x1[kEdgeChunk];
  __shared__ float s_y1[kEdgeChunk];
  __shared__ float s_y2[kEdgeChunk];
  __shared__ float s_cx[kEdgeChunk];
  __shared__ float s_cy[kEdgeChunk];
  __shared__ float s_slope[kEdgeChunk];
  __shared__ float s_inv_len[kEdgeChunk];
  __shared__ uint8_t s_valid[kEdgeChunk];

  const int base = blockIdx.x * (kThreads * kPointsPerThread) + threadIdx.x;
  float x[kPointsPerThread], y[kPointsPerThread], mind2[kPointsPerThread];
  int cross[kPointsPerThread];
#pragma unroll
  for (int p = 0; p < kPointsPerThread; ++p) {
    const int i = base + p * kThreads;
    x[p] = i < n ? px[i] : 0.0f;
    y[p] = i < n ? py[i] : 0.0f;
    mind2[p] = kBig;
    cross[p] = 0;
  }

  for (int c0 = 0; c0 < ne; c0 += kEdgeChunk) {
    const int len = min(kEdgeChunk, ne - c0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int e = threadIdx.x; e < len; e += kThreads) {
      const float* ed = edges + 4 * (c0 + e);
      const float x1 = ed[0], y1 = ed[1], x2 = ed[2], y2 = ed[3];
      const float cx = x2 - x1;
      const float cy = y2 - y1;
      // distances.point_in_rings: slope on the edge shape
      const float denom = (y2 == y1) ? 1.0f : cy;
      // distances.point_segment_dist2: reciprocal on the edge shape
      const float len_sq = cx * cx + cy * cy;
      s_x1[e] = x1;
      s_y1[e] = y1;
      s_y2[e] = y2;
      s_cx[e] = cx;
      s_cy[e] = cy;
      s_slope[e] = cx / denom;
      s_inv_len[e] = len_sq > 0.0f ? 1.0f / len_sq : 0.0f;
      s_valid[e] = edge_mask[c0 + e];
    }
    __syncthreads();
    for (int e = 0; e < len; ++e) {
      if (!s_valid[e]) continue;  // uniform across the block
      const float x1 = s_x1[e], y1 = s_y1[e], y2 = s_y2[e];
      const float cx = s_cx[e], cy = s_cy[e];
      const float slope = s_slope[e], inv_len = s_inv_len[e];
#pragma unroll
      for (int p = 0; p < kPointsPerThread; ++p) {
        // even-odd ray cast, half-open on y
        const bool straddles = (y1 > y[p]) != (y2 > y[p]);
        const float ry = y[p] - y1;
        const float x_at_y = x1 + ry * slope;
        cross[p] += (straddles && (x[p] < x_at_y)) ? 1 : 0;
        // squared distance to the segment
        const float dot = (x[p] - x1) * cx + ry * cy;
        const float t = fminf(fmaxf(dot * inv_len, 0.0f), 1.0f);
        const float dx = (x1 + t * cx) - x[p];
        const float dy = (y1 + t * cy) - y[p];
        mind2[p] = fminf(mind2[p], dx * dx + dy * dy);
      }
    }
  }

#pragma unroll
  for (int p = 0; p < kPointsPerThread; ++p) {
    const int i = base + p * kThreads;
    if (i < n) {
      dist[i] = (is_areal && (cross[p] & 1)) ? 0.0f : sqrtf(mind2[p]);
    }
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
    const int per_block = kThreads * kPointsPerThread;
    const int blocks = (n + per_block - 1) / per_block;
    pip_dist_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        px, py, n, edges, edge_mask, ne, is_areal, dist);
  }
  return static_cast<int>(cudaGetLastError());
}
