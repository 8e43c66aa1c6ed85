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
// multi-query paths consume as (Q, N).
//
// What bounds it on an H100: instruction issue. Every (point, edge) pair
// costs about 22 separate f32 operations (the build has no FMA, so that
// the result equals the plain version bit for bit), and at the main
// path's shape (1M points x 17 geometries of 64 edges) that is ~0.8 ms of
// issue; with 4-edge geometries (the experiment's 65,536 x 10,240) the
// 2.7 GB output write (~0.8 ms at 3.35 TB/s) comes close.
//
// What the design does about it:
// - Fewer pairs. The fold takes a min and a parity, both exact and free of
//   order, so an edge that provably cannot change any of a warp's points
//   may be skipped and any edge may go first; the result does not change.
//   When the wrapper hands in points in cell order (cell_order.cu), each
//   thread holds 4 neighbouring points and each warp 128, and per staged
//   edge the warp votes:
//   * ray cast skipped when every lane's points lie below the edge's lower
//     y or at or above its upper y (then no point straddles it; a pure
//     comparison, no margin). Never skipped on x: x_at_y can round
//     outside the edge's x-extent.
//   * distance skipped when a lower bound of the squared distance between
//     the lane's point box and the edge's box, each widened by an absolute
//     margin for f32 rounding, exceeds every lane's current min. The margin
//     is (|largest coordinate| of lane and edge) * margin_scale, with
//     margin_scale from hopper_kernels.distance_skip_margin, where its
//     derivation is written down.
//   * before a geometry's edges, each warp folds the distance of its edge
//     of least box lower bound (a shuffle argmin over the lanes), so the
//     distance skip has a tight threshold from the start.
//   * the votes run first per group of 8 consecutive edges of a geometry,
//     on the union of their boxes, and per edge only inside a group the
//     warp cannot skip whole.
// - Cheaper edges. Up to 512 edges of consecutive geometries are staged at
//   once, masked edges compacted out, with each geometry's start in an
//   offset table: two barriers per 512 edges rather than per geometry.
//   Each edge is packed as three float4 (fold fields, and the widened box
//   the votes read), the per-edge divides done once when staged.
// - Writes: with the cell order each distance goes back to its point's
//   original position through perm; a block walks its geometries in order
//   (geometry-major), so the rows being written stay in the 50 MB L2. In
//   stream order (no cell ids) each thread stores its 4 points as one
//   float4.
//
// Parity: given a (G, N) byte output, the kernel also writes each point's
// even-odd crossing parity against each geometry (1 inside by the ray
// cast, whatever the geometry's is_areal; a point on an edge may read 0
// where its distance is 0), the containment of the JAX package's
// points_in_geoms (spatialflink_tpu/ops/geom.py:34), which the
// trajectory range query (tRange) tests. The fold is the same; only the
// writes are added.
//
// Built with --fmad=false: each operation rounds once, as the plain
// version's separate PyTorch ops do, and the result equals the plain
// version bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPts = 4;  // consecutive points per thread
constexpr int kPointsPerBlock = kThreads * kPts;
constexpr int kChunk = 512;  // raw edges staged per pass
constexpr int kHalves = kChunk / kThreads;
constexpr int kSeedMinEdges = 16;  // seed a geometry with at least this many
constexpr int kGroup = 8;  // edges under one group box (skip variant)
constexpr int kBlocksPerSm = 64;   // grid size target: geometry ranges
constexpr float kBig = 3.4e38f;    // "infinitely far" (pallas_kernels._BIG)
// the smallest normal f32: a squared edge length below it counts as zero
// (distances.FLT_MIN; its reciprocal would overflow, and 0 * inf is NaN)
constexpr float kMinNormal = 1.17549435e-38f;
constexpr unsigned kAll = 0xffffffffu;

struct Chunk {
  float4 fold_a[kChunk];  // x1, y1, cx, cy
  float4 fold_b[kChunk];  // slope, inv_len, y2, 0
  float4 box[kChunk];     // edge box widened by its margin: xlo, xhi, ylo, yhi
  // at the first slot of each run of kGroup edges of one geometry: the
  // union of their boxes
  float4 gbox[kChunk];
  int geom[kChunk];        // the chunk's geometry of each slot
  int gstart[kChunk + 2];  // compacted start of each geometry of the chunk
  int seg[kHalves * kThreads / 32];  // valid edges per (half, warp)
};

// Stage raw edges [r0, r1) of the flattened (G * ne) edge array, valid ones
// only, in raw order; gstart[j] is the first slot of geometry g_first + j
// and gstart[ng] the number staged. With `groups`, also the group boxes.
// The caller synchronises the block before (the previous chunk is done)
// and after.
__device__ __forceinline__ void stage(Chunk& c, const float* __restrict__ edges,
                                      const uint8_t* __restrict__ mask,
                                      int r0, int r1, int ne,
                                      float margin_scale, bool groups) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int g_first = r0 / ne;
  bool v[kHalves];
  unsigned ballot[kHalves];
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
    const int j = h * kThreads + threadIdx.x;
    v[h] = r0 + j < r1 && mask[r0 + j] != 0;
    ballot[h] = __ballot_sync(kAll, v[h]);
    if (lane == 0) c.seg[h * (kThreads / 32) + warp] = __popc(ballot[h]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int s = 0; s < kHalves * kThreads / 32; ++s) {
      const int cnt = c.seg[s];
      c.seg[s] = run;
      run += cnt;
    }
    c.gstart[(r1 - 1) / ne - g_first + 1] = run;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
    const int j = h * kThreads + threadIdx.x;
    const int r = r0 + j;
    if (r >= r1) continue;
    const int slot = c.seg[h * (kThreads / 32) + warp] + __popc(ballot[h] & lt);
    if (j == 0 || r % ne == 0) c.gstart[r / ne - g_first] = slot;
    if (!v[h]) continue;
    const float* ed = edges + 4 * static_cast<size_t>(r);
    const float x1 = ed[0], y1 = ed[1], x2 = ed[2], y2 = ed[3];
    const float cx = x2 - x1;
    const float cy = y2 - y1;
    // distances.point_in_rings: slope on the edge shape
    const float denom = (y2 == y1) ? 1.0f : cy;
    // distances.point_segment_dist2: reciprocal on the edge shape
    const float len_sq = cx * cx + cy * cy;
    const float mag = fmaxf(fmaxf(fabsf(x1), fabsf(x2)),
                            fmaxf(fabsf(y1), fabsf(y2)));
    const float m = mag * margin_scale;
    c.geom[slot] = r / ne - g_first;
    c.fold_a[slot] = make_float4(x1, y1, cx, cy);
    c.fold_b[slot] = make_float4(cx / denom,
                                 len_sq >= kMinNormal ? 1.0f / len_sq : 0.0f,
                                 y2, 0.0f);
    c.box[slot] = make_float4(fminf(x1, x2) - m, fmaxf(x1, x2) + m,
                              fminf(y1, y2) - m, fmaxf(y1, y2) + m);
  }
  if (!groups) return;
  __syncthreads();
  const int staged = c.gstart[(r1 - 1) / ne - g_first + 1];
  for (int t = threadIdx.x; t < staged; t += kThreads) {
    const int j = c.geom[t];
    if ((t - c.gstart[j]) % kGroup != 0) continue;
    const int end = min(t + kGroup, c.gstart[j + 1]);
    float4 u = c.box[t];
    for (int i = t + 1; i < end; ++i) {
      const float4 b = c.box[i];
      u = make_float4(fminf(u.x, b.x), fmaxf(u.y, b.y), fminf(u.z, b.z),
                      fmaxf(u.w, b.w));
    }
    c.gbox[t] = u;
  }
}

struct Lane {
  float x[kPts], y[kPts];
  float mind2[kPts];
  int cross;  // bit p: crossing parity of point p
  // the lane's point box widened by its margin (skip variant only)
  float bxlo, bxhi, bylo, byhi;
  float dmax;  // max of mind2 over the lane's points
};

// Lower bound (conservative under f32 rounding, see the header) of the
// squared distance between the lane's points and an edge, from their
// widened boxes.
__device__ __forceinline__ float box_gap2(const Lane& l, const float4 b) {
  const float gx = fmaxf(fmaxf(b.x - l.bxhi, l.bxlo - b.y), 0.0f);
  const float gy = fmaxf(fmaxf(b.z - l.byhi, l.bylo - b.w), 0.0f);
  return gx * gx + gy * gy;
}

__device__ __forceinline__ void fold_ray(Lane& l, const float4 a,
                                         const float4 b) {
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    // even-odd ray cast, half-open on y
    const bool straddles = (a.y > l.y[p]) != (b.z > l.y[p]);
    const float ry = l.y[p] - a.y;
    const float x_at_y = a.x + ry * b.x;
    l.cross ^= (straddles && (l.x[p] < x_at_y)) ? (1 << p) : 0;
  }
}

__device__ __forceinline__ void fold_dist(Lane& l, const float4 a,
                                          const float4 b) {
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    // squared distance to the segment; __saturatef(v) is
    // fminf(fmaxf(v, 0), 1), NaN to 0
    const float ry = l.y[p] - a.y;
    const float dot = (l.x[p] - a.x) * a.z + ry * a.w;
    const float t = __saturatef(dot * b.y);
    const float dx = (a.x + t * a.z) - l.x[p];
    const float dy = (a.y + t * a.w) - l.y[p];
    l.mind2[p] = fminf(l.mind2[p], dx * dx + dy * dy);
  }
}

__device__ __forceinline__ void update_dmax(Lane& l) {
  float m = l.mind2[0];
#pragma unroll
  for (int p = 1; p < kPts; ++p) m = fmaxf(m, l.mind2[p]);
  l.dmax = m;
}

// Fold staged edges [s, e) of one geometry into the lane's accumulators.
template <bool kSkip>
__device__ __forceinline__ void fold_geometry(Lane& l, const Chunk& c, int s,
                                              int e, bool seed) {
  if constexpr (kSkip) {
    if (seed && e - s >= kSeedMinEdges) {
      // the warp's edge of least box lower bound, folded first
      float best = INFINITY;
      int bi = e;
      for (int j = s + (threadIdx.x & 31); j < e; j += 32) {
        const float g = box_gap2(l, c.box[j]);
        if (g < best) {
          best = g;
          bi = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kAll, best, off);
        const int oi = __shfl_xor_sync(kAll, bi, off);
        if (ob < best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      fold_dist(l, c.fold_a[bi], c.fold_b[bi]);
      update_dmax(l);
    }
  }
  if constexpr (!kSkip) {
    for (int j = s; j < e; ++j) {
      const float4 a = c.fold_a[j];
      const float4 b = c.fold_b[j];
      fold_ray(l, a, b);
      fold_dist(l, a, b);
    }
    return;
  }
  // a vote per group of kGroup edges first: a group box contains its
  // edges' boxes, so a group the warp may skip holds only edges it may
  for (int j0 = s; j0 < e; j0 += kGroup) {
    const float4 u = c.gbox[j0];
    const bool group_ray = __any_sync(kAll, !(l.byhi < u.z || l.bylo >= u.w));
    const bool group_dist = __any_sync(kAll, !(box_gap2(l, u) > l.dmax));
    if (!group_ray && !group_dist) continue;
    const int j1 = min(j0 + kGroup, e);
    for (int j = j0; j < j1; ++j) {
      const float4 b = c.box[j];
      const bool ray =
          group_ray && __any_sync(kAll, !(l.byhi < b.z || l.bylo >= b.w));
      const bool dist =
          group_dist && __any_sync(kAll, !(box_gap2(l, b) > l.dmax));
      if (!ray && !dist) continue;
      const float4 a = c.fold_a[j];
      const float4 f = c.fold_b[j];
      if (ray) fold_ray(l, a, f);
      if (dist) {
        fold_dist(l, a, f);
        update_dmax(l);
      }
    }
  }
}

template <bool kSkip>
__global__ void __launch_bounds__(kThreads)
pip_lattice_kernel(const float* __restrict__ px,
                   const float* __restrict__ py,
                   const int32_t* __restrict__ perm, int n,
                   const float* __restrict__ edges,
                   const uint8_t* __restrict__ edge_mask, int ne,
                   const uint8_t* __restrict__ is_areal, int g,
                   float margin_scale, float* __restrict__ dist,
                   uint8_t* __restrict__ parity) {
  __shared__ Chunk c;
  const int base = blockIdx.x * kPointsPerBlock + threadIdx.x * kPts;
  const int per = (g + gridDim.y - 1) / gridDim.y;
  const int g0 = blockIdx.y * per;
  const int g1 = min(g, g0 + per);
  if (g0 >= g1) return;  // the whole block: no barrier is skipped halfway
  Lane l;
  int out[kPts];
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    const int i = min(base + p, n - 1);  // a lane past n copies point n-1
    l.x[p] = px[i];
    l.y[p] = py[i];
    out[p] = perm != nullptr ? perm[i] : i;
  }
  if constexpr (kSkip) {
    float xlo = l.x[0], xhi = l.x[0], ylo = l.y[0], yhi = l.y[0];
#pragma unroll
    for (int p = 1; p < kPts; ++p) {
      xlo = fminf(xlo, l.x[p]);
      xhi = fmaxf(xhi, l.x[p]);
      ylo = fminf(ylo, l.y[p]);
      yhi = fmaxf(yhi, l.y[p]);
    }
    const float m = fmaxf(fmaxf(fabsf(xlo), fabsf(xhi)),
                          fmaxf(fabsf(ylo), fabsf(yhi))) * margin_scale;
    l.bxlo = xlo - m;
    l.bxhi = xhi + m;
    l.bylo = ylo - m;
    l.byhi = yhi + m;
  }
  const bool vec_store = perm == nullptr && (n & 3) == 0 && base + kPts <= n;

  auto finish = [&](int gi) {
    const bool areal = is_areal[gi] != 0;
    float d[kPts];
#pragma unroll
    for (int p = 0; p < kPts; ++p) {
      d[p] = (areal && ((l.cross >> p) & 1)) ? 0.0f : sqrtf(l.mind2[p]);
    }
    float* row = dist + static_cast<size_t>(gi) * n;
    if (parity != nullptr) {
      uint8_t* prow = parity + static_cast<size_t>(gi) * n;
#pragma unroll
      for (int p = 0; p < kPts; ++p) {
        if (base + p < n) prow[out[p]] = (l.cross >> p) & 1;
      }
    }
    if (vec_store) {
      *reinterpret_cast<float4*>(row + base) =
          make_float4(d[0], d[1], d[2], d[3]);
    } else {
#pragma unroll
      for (int p = 0; p < kPts; ++p) {
        if (base + p < n) row[out[p]] = d[p];
      }
    }
  };
  auto reset = [&]() {
#pragma unroll
    for (int p = 0; p < kPts; ++p) l.mind2[p] = kBig;
    l.cross = 0;
    l.dmax = kBig;
  };

  if (ne == 0) {  // no edges at all: every distance is sqrt(kBig)
    reset();
    for (int gi = g0; gi < g1; ++gi) finish(gi);
    return;
  }
  const int r_end = g1 * ne;
  for (int r0 = g0 * ne; r0 < r_end; r0 += kChunk) {
    const int r1 = min(r_end, r0 + kChunk);
    __syncthreads();  // every warp is done with the previous chunk
    stage(c, edges, edge_mask, r0, r1, ne, margin_scale, kSkip);
    __syncthreads();
    const int g_first = r0 / ne;
    const int g_last = (r1 - 1) / ne;
    for (int gi = g_first; gi <= g_last; ++gi) {
      const bool starts = gi * ne >= r0;
      if (starts) reset();
      fold_geometry<kSkip>(l, c, c.gstart[gi - g_first],
                           c.gstart[gi - g_first + 1], starts);
      if ((gi + 1) * ne <= r1) finish(gi);
    }
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1) {
      sms = 132;
    }
  }
  return sms;
}

}  // namespace

// px, py: (n,) f32, in cell order when perm is given (perm[i] = the
// original index of point i; each distance is written there, and the
// edge-skip votes run), else in any order with distances written in place;
// edges: (g, ne, 4) f32 [x1, y1, x2, y2]; edge_mask: (g, ne) bool;
// is_areal: (g,) bool; margin_scale: the distance-skip margin per unit of
// coordinate magnitude; dist: (g, n) f32 output; parity: nullptr, or a
// (g, n) bool output of the even-odd parities. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 when the launch
// was accepted).
extern "C" int pip_lattice_launch(const float* px, const float* py,
                                  const int32_t* perm, int n,
                                  const float* edges,
                                  const uint8_t* edge_mask, int ne,
                                  const uint8_t* is_areal, int g,
                                  float margin_scale, float* dist,
                                  uint8_t* parity, void* stream) {
  if (n > 0 && g > 0) {
    const int bx = (n + kPointsPerBlock - 1) / kPointsPerBlock;
    const int want = (num_sms() * kBlocksPerSm + bx - 1) / bx;
    const int by = want < 1 ? 1 : (want > g ? g : want);
    const dim3 grid(bx, by);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (perm != nullptr) {
      pip_lattice_kernel<true><<<grid, kThreads, 0, s>>>(
          px, py, perm, n, edges, edge_mask, ne, is_areal, g, margin_scale,
          dist, parity);
    } else {
      pip_lattice_kernel<false><<<grid, kThreads, 0, s>>>(
          px, py, perm, n, edges, edge_mask, ne, is_areal, g, margin_scale,
          dist, parity);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
