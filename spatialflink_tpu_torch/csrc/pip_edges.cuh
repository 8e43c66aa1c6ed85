// Device code of K4 (pip_dist.cu: points x ONE geometry): one chunk of a
// geometry's edges staged in shared memory, and the fold of that chunk (or
// of one staged edge, fold_pair) into per-point accumulators (even-odd
// crossing count, min squared boundary distance). K4x (pip_lattice.cu) has its own fold, with edge skipping and
// multi-geometry chunks.
//
// The operation order follows spatialflink_tpu_torch/ops/distances.py
// (point_in_rings, point_segment_dist2) step for step, with the per-edge
// divides (ray slope, reciprocal squared length) taken once per edge as
// the plain versions take them on the edge shape. Built with --fmad=false,
// so each operation rounds once and the result equals the plain PyTorch
// versions bit for bit.
#pragma once

#include <stdint.h>

namespace pip {

constexpr int kThreads = 256;
constexpr int kPointsPerThread = 4;
constexpr int kPointsPerBlock = kThreads * kPointsPerThread;
constexpr int kEdgeChunk = 512;
constexpr float kBig = 3.4e38f;  // "infinitely far" (pallas_kernels._BIG)
// the smallest normal f32: a squared edge length below it counts as zero
// (distances.FLT_MIN; its reciprocal would overflow, and 0 * inf is NaN)
constexpr float kMinNormal = 1.17549435e-38f;

// 7 x 512 floats + 512 flags = 14,848 bytes
struct EdgeChunk {
  float x1[kEdgeChunk];
  float y1[kEdgeChunk];
  float y2[kEdgeChunk];
  float cx[kEdgeChunk];
  float cy[kEdgeChunk];
  float slope[kEdgeChunk];
  float inv_len[kEdgeChunk];
  uint8_t valid[kEdgeChunk];
};

// Stage edges [c0, c0 + len) of one geometry (edges (E, 4) f32
// [x1, y1, x2, y2], edge_mask (E,) bool) into `s`. The caller synchronises
// the block before (the previous chunk is done) and after (the chunk is
// complete).
__device__ __forceinline__ void stage_chunk(EdgeChunk& s,
                                            const float* __restrict__ edges,
                                            const uint8_t* __restrict__ mask,
                                            int c0, int len) {
  for (int e = threadIdx.x; e < len; e += kThreads) {
    const float* ed = edges + 4 * (c0 + e);
    const float x1 = ed[0], y1 = ed[1], x2 = ed[2], y2 = ed[3];
    const float cx = x2 - x1;
    const float cy = y2 - y1;
    // distances.point_in_rings: slope on the edge shape
    const float denom = (y2 == y1) ? 1.0f : cy;
    // distances.point_segment_dist2: reciprocal on the edge shape
    const float len_sq = cx * cx + cy * cy;
    s.x1[e] = x1;
    s.y1[e] = y1;
    s.y2[e] = y2;
    s.cx[e] = cx;
    s.cy[e] = cy;
    s.slope[e] = cx / denom;
    s.inv_len[e] = len_sq >= kMinNormal ? 1.0f / len_sq : 0.0f;
    s.valid[e] = mask[c0 + e];
  }
}

// Fold staged edge e into one point's accumulators: the even-odd ray cast
// (half-open on y) and the squared distance to the segment.
__device__ __forceinline__ void fold_pair(const EdgeChunk& s, int e, float x,
                                          float y, float& mind2, int& cross) {
  const float x1 = s.x1[e], y1 = s.y1[e], y2 = s.y2[e];
  const float cx = s.cx[e], cy = s.cy[e];
  const float slope = s.slope[e], inv_len = s.inv_len[e];
  const bool straddles = (y1 > y) != (y2 > y);
  const float ry = y - y1;
  const float x_at_y = x1 + ry * slope;
  cross += (straddles && (x < x_at_y)) ? 1 : 0;
  const float dot = (x - x1) * cx + ry * cy;
  const float t = fminf(fmaxf(dot * inv_len, 0.0f), 1.0f);
  const float dx = (x1 + t * cx) - x;
  const float dy = (y1 + t * cy) - y;
  mind2 = fminf(mind2, dx * dx + dy * dy);
}

// Fold the `len` staged edges into this thread's points. All threads read
// the same edge at the same time (a shared-memory broadcast); a masked edge
// is skipped by the whole block at once.
__device__ __forceinline__ void fold_chunk(const EdgeChunk& s, int len,
                                           const float (&x)[kPointsPerThread],
                                           const float (&y)[kPointsPerThread],
                                           float (&mind2)[kPointsPerThread],
                                           int (&cross)[kPointsPerThread]) {
  for (int e = 0; e < len; ++e) {
    if (!s.valid[e]) continue;
#pragma unroll
    for (int p = 0; p < kPointsPerThread; ++p) {
      fold_pair(s, e, x[p], y[p], mind2[p], cross[p]);
    }
  }
}

// Fold every edge of one geometry (`ne` edges, any count, in chunks of
// kEdgeChunk) into freshly initialised accumulators and return the
// distance of point p: 0 inside an areal geometry, else sqrt(min d^2).
// Every thread of the block must call it (it synchronises the block).
__device__ __forceinline__ void geometry_dist(
    EdgeChunk& s, const float* __restrict__ edges,
    const uint8_t* __restrict__ mask, int ne, bool is_areal,
    const float (&x)[kPointsPerThread], const float (&y)[kPointsPerThread],
    float (&dist)[kPointsPerThread]) {
  float mind2[kPointsPerThread];
  int cross[kPointsPerThread];
#pragma unroll
  for (int p = 0; p < kPointsPerThread; ++p) {
    mind2[p] = kBig;
    cross[p] = 0;
  }
  for (int c0 = 0; c0 < ne; c0 += kEdgeChunk) {
    const int len = min(kEdgeChunk, ne - c0);
    __syncthreads();  // every thread is done with the previous chunk
    stage_chunk(s, edges, mask, c0, len);
    __syncthreads();
    fold_chunk(s, len, x, y, mind2, cross);
  }
#pragma unroll
  for (int p = 0; p < kPointsPerThread; ++p) {
    dist[p] = (is_areal && (cross[p] & 1)) ? 0.0f : sqrtf(mind2[p]);
  }
}

// Load this thread's points of the block's disjoint point range.
__device__ __forceinline__ void load_points(const float* __restrict__ px,
                                            const float* __restrict__ py,
                                            int n,
                                            float (&x)[kPointsPerThread],
                                            float (&y)[kPointsPerThread]) {
  const int base = blockIdx.x * kPointsPerBlock + threadIdx.x;
#pragma unroll
  for (int p = 0; p < kPointsPerThread; ++p) {
    const int i = base + p * kThreads;
    x[p] = i < n ? px[i] : 0.0f;
    y[p] = i < n ? py[i] : 0.0f;
  }
}

}  // namespace pip
