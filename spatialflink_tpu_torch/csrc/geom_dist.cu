// K5: the distance of every geometry of a polygon/linestring stream window
// to Q query points or Q query geometries, fused with the reference's cell
// rule (range and kNN over polygon and linestring streams).
//
// Replaces the XLA-fused geometry-stream functions of the JAX package (no
// Pallas kernel computes them): spatialflink_tpu/ops/geom.py
// geoms_to_single_geom_dist (:126), geoms_bbox_dist (:159),
// point_to_geoms_dist (:166), _geom_elig_multi (:179),
// knn_geoms_to_point_queries (:189), knn_geoms_to_geom_queries (:213),
// range_geoms_to_point_queries (:270), range_geoms_to_geom_queries (:296),
// geom_cells_all_within (:318) and geom_cells_any_within (:327), with
// spatialflink_tpu/ops/range.py range_filter_geom_stream_stats (:236-249)
// and ops/distances.py seg_seg_dist2 / edges_edges_dist2 (:165-209).
// Plain version: spatialflink_tpu_torch/ops/geom.py geom_stream_dist_plain,
// whose operation order this file follows step for step.
//
// For each (query q, geometry g):
// - the cell rule: all_gn = every cell of g in q's guaranteed cells (and g
//   has a cell), any_nb = some cell of g in q's neighbouring cells;
// - range mode: mask = valid & (all_gn | (any_nb & ~all_gn & d <= r)) and
//   the counts gn_bypassed = valid & all_gn, dist_evals = valid & any_nb &
//   ~all_gn; kNN mode: the eligibility valid & any_nb and its count;
// - the distance d only where the rule consults it (+inf elsewhere):
//   point query: the min squared distance to g's valid edges and the
//   even-odd parity of the point against them (0 inside an areal g);
//   geometry query: the min over every pair of valid edges of the
//   segment-segment squared distance (0 on a proper crossing), whether a
//   vertex (each valid edge's first endpoint) of g lies inside an areal q,
//   whether one of q lies inside an areal g; 0 if either holds and g has an
//   edge, else sqrt(min); approximate mode: the point-bbox or bbox-bbox
//   distance.
//
// What bounds it on an H100: arithmetic. A geometry query costs ~104 f32
// operations per (geometry edge, query edge) pair (four clamped
// projections, four orientations) against 17 bytes per geometry edge read
// once, so at the conf's 4-edge polygon and 32-edge geometries a consulted
// geometry does ~13,000 operations for ~600 bytes: above the H100's ~20
// operations per byte. Without FMA (--fmad=false, for bit equality) every
// operation issues alone. The rule skips whole geometries: a range query
// computes only the candidate-cell ones, the reference's step of exact
// math on candidate-cell objects only.
//
// Design (simple first): one block per (query, tile of kGeomsPerBlock
// geometries); the query's edges are staged once per block in shared memory
// (up to kQueryChunk edges; a larger query is read from device memory) with
// their per-edge divides (reciprocal squared length, ray slope) taken once
// per edge, as the plain version takes them on the edge shape
// (pip_edges.cuh's order of operations). One warp per geometry: its lanes
// over the geometry's edges (padded edges skipped by their mask, element by
// element), the minimum reduced across the warp with shuffles (exact in any
// order), a geometry vertex's crossing parity against the staged query
// edges counted in its lane, and a query vertex's parity against the
// geometry's edges from a ballot and popcount. The rule is decided by the
// warp first (lanes over cells) so that a geometry the rule does not
// consult costs its cell reads only. Counts: one shared atomic per warp and
// one device atomic per block, zeroed by a memset before the launch.
//
// Built with --fmad=false: each operation rounds once, as the plain
// version's separate PyTorch ops do, and the result equals the plain
// version's bit for bit (flags, counts, and the distance of every consulted
// slot).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGeomsPerWarp = 2;
constexpr int kGeomsPerBlock = kWarps * kGeomsPerWarp;
constexpr int kQueryChunk = 1024;  // ops/geom.py QUERY_CHUNK
constexpr int kModeRange = 0;
constexpr int kModeKnn = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.4e38f;  // "infinitely far" (ops/geom.py _BIG)
// the smallest normal f32: a squared edge length below it counts as zero
// (distances.FLT_MIN; its reciprocal would overflow, and 0 * inf is NaN)
constexpr float kMinNormal = 1.17549435e-38f;

struct Args {
  int mode, approximate, G, E, C, Eq, num_cells;
  const float* edges;          // (G, E, 4) [x1, y1, x2, y2]
  const uint8_t* edge_mask;    // (G, E)
  const float* bbox;           // (G, 4)
  const int32_t* cells;        // (G, C), -1 padded
  const uint8_t* cells_mask;   // (G, C)
  const uint8_t* is_areal;     // (G,)
  const uint8_t* valid;        // (G,)
  const float* qx;             // (Q,) point queries
  const float* qy;
  const float* q_edges;        // (Q, Eq, 4) geometry queries
  const uint8_t* q_mask;       // (Q, Eq)
  const uint8_t* q_areal;      // (Q,)
  const float* q_bbox;         // (Q, 4)
  const uint8_t* gn;           // (Q, num_cells), range mode only
  const uint8_t* nb;           // (Q, num_cells)
  float radius;
  uint8_t* flag;               // (Q, G) range mask / kNN eligibility
  float* dist;                 // (Q, G)
  int32_t* counts;             // (Q, 2) [gn_bypassed, dist_evals]
};

// One edge with the values the plain version computes on the edge shape.
struct Edge {
  float x1, y1, x2, y2, cx, cy, slope, inv_len;
  bool valid;
};

// distances.point_segment_dist2's reciprocal and point_in_rings' slope
__device__ __forceinline__ Edge prepare(const float* __restrict__ e,
                                        bool valid) {
  Edge s;
  s.x1 = e[0];
  s.y1 = e[1];
  s.x2 = e[2];
  s.y2 = e[3];
  s.cx = s.x2 - s.x1;
  s.cy = s.y2 - s.y1;
  const float len_sq = s.cx * s.cx + s.cy * s.cy;
  s.inv_len = len_sq >= kMinNormal ? 1.0f / len_sq : 0.0f;
  const float denom = (s.y2 == s.y1) ? 1.0f : s.cy;
  s.slope = s.cx / denom;
  s.valid = valid;
  return s;
}

// 8 x 1,024 floats + 1,024 flags = 33,792 bytes
struct QueryEdges {
  float x1[kQueryChunk], y1[kQueryChunk], x2[kQueryChunk], y2[kQueryChunk];
  float cx[kQueryChunk], cy[kQueryChunk], slope[kQueryChunk];
  float inv_len[kQueryChunk];
  uint8_t valid[kQueryChunk];
};

// The query geometry's edge j: staged in shared memory, or prepared from
// device memory for a query of more than kQueryChunk edges.
struct QuerySide {
  const QueryEdges* s;
  const float* edges;
  const uint8_t* mask;
  bool staged;

  __device__ __forceinline__ Edge operator()(int j) const {
    if (!staged) return prepare(edges + 4 * j, mask[j] != 0);
    Edge e;
    e.x1 = s->x1[j];
    e.y1 = s->y1[j];
    e.x2 = s->x2[j];
    e.y2 = s->y2[j];
    e.cx = s->cx[j];
    e.cy = s->cy[j];
    e.slope = s->slope[j];
    e.inv_len = s->inv_len[j];
    e.valid = s->valid[j] != 0;
    return e;
  }
};

// distances.point_segment_dist2
__device__ __forceinline__ float seg_dist2(float px, float py,
                                           const Edge& s) {
  const float dot = (px - s.x1) * s.cx + (py - s.y1) * s.cy;
  const float t = fminf(fmaxf(dot * s.inv_len, 0.0f), 1.0f);
  const float dx = (s.x1 + t * s.cx) - px;
  const float dy = (s.y1 + t * s.cy) - py;
  return dx * dx + dy * dy;
}

// distances.point_in_rings, one edge: crossing of the ray from (px, py)
__device__ __forceinline__ int crosses(float px, float py, const Edge& s) {
  const bool straddles = (s.y1 > py) != (s.y2 > py);
  const float x_at_y = s.x1 + (py - s.y1) * s.slope;
  return (straddles && s.valid && px < x_at_y) ? 1 : 0;
}

// distances._orient
__device__ __forceinline__ float orient(float ax, float ay, float bx,
                                        float by, float cx, float cy) {
  return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
}

// distances.seg_seg_dist2 (a: the geometry's edge, b: the query's)
__device__ __forceinline__ float seg_seg_dist2(const Edge& a, const Edge& b) {
  const float d = fminf(fminf(seg_dist2(a.x1, a.y1, b),
                              seg_dist2(a.x2, a.y2, b)),
                        fminf(seg_dist2(b.x1, b.y1, a),
                              seg_dist2(b.x2, b.y2, a)));
  const float d1 = orient(b.x1, b.y1, b.x2, b.y2, a.x1, a.y1);
  const float d2 = orient(b.x1, b.y1, b.x2, b.y2, a.x2, a.y2);
  const float d3 = orient(a.x1, a.y1, a.x2, a.y2, b.x1, b.y1);
  const float d4 = orient(a.x1, a.y1, a.x2, a.y2, b.x2, b.y2);
  const bool proper =
      ((d1 > 0.0f) != (d2 > 0.0f)) && ((d3 > 0.0f) != (d4 > 0.0f));
  return proper ? 0.0f : d;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  }
  return v;
}

__device__ __forceinline__ bool warp_parity(int bit) {
  return (__popc(__ballot_sync(kFull, bit & 1)) & 1) != 0;
}

// geom.point_to_geoms_dist for one geometry (the whole warp calls it)
__device__ float point_geom_dist(float px, float py,
                                 const float* __restrict__ edges,
                                 const uint8_t* __restrict__ mask, int E,
                                 bool areal, int lane) {
  float mind2 = kBig;
  int cross = 0;
  for (int i = lane; i < E; i += 32) {
    if (!mask[i]) continue;
    const Edge a = prepare(edges + 4 * i, true);
    mind2 = fminf(mind2, seg_dist2(px, py, a));
    cross ^= crosses(px, py, a);
  }
  mind2 = warp_min(mind2);
  const bool inside = warp_parity(cross);
  return (inside && areal) ? 0.0f : sqrtf(mind2);
}

// geom.geoms_to_single_geom_dist for one geometry (the whole warp calls
// it): lanes over the geometry's edges, each against every query edge
__device__ float geom_geom_dist(const float* __restrict__ edges,
                                const uint8_t* __restrict__ mask, int E,
                                bool g_areal, const QuerySide& query,
                                int Eq, bool q_areal, int lane) {
  // the lane's first edge stays in registers (a geometry of <= 32 edges
  // has only that one)
  Edge a0{};
  if (lane < E && mask[lane]) a0 = prepare(edges + 4 * lane, true);
  float mind2 = kBig;
  bool g_in_q = false, has_edges = false;
  for (int i = lane; i < E; i += 32) {
    if (!mask[i]) continue;
    has_edges = true;
    const Edge a = i == lane ? a0 : prepare(edges + 4 * i, true);
    int cross = 0;
    for (int j = 0; j < Eq; ++j) {
      const Edge b = query(j);
      if (!b.valid) continue;
      mind2 = fminf(mind2, seg_seg_dist2(a, b));
      if (q_areal) cross ^= crosses(a.x1, a.y1, b);
    }
    g_in_q = g_in_q || (cross & 1) != 0;
  }
  mind2 = warp_min(mind2);
  g_in_q = q_areal && __any_sync(kFull, g_in_q);
  has_edges = __any_sync(kFull, has_edges);
  bool q_in_g = false;
  if (g_areal) {
    // each valid query vertex against all of the geometry's edges
    for (int j = 0; j < Eq && !q_in_g; ++j) {
      const Edge b = query(j);
      if (!b.valid) continue;
      int cross = 0;
      for (int i = lane; i < E; i += 32) {
        if (!mask[i]) continue;
        const Edge a = i == lane ? a0 : prepare(edges + 4 * i, true);
        cross ^= crosses(b.x1, b.y1, a);
      }
      q_in_g = warp_parity(cross);
    }
  }
  return ((g_in_q || q_in_g) && has_edges) ? 0.0f : sqrtf(mind2);
}

// geom.point_bbox_dist / distances.bbox_bbox_dist
__device__ __forceinline__ float box_dist(float dx, float dy) {
  dx = fmaxf(dx, 0.0f);
  dy = fmaxf(dy, 0.0f);
  return sqrtf(dx * dx + dy * dy);
}

// The warp's verdict of the cell rule for geometry g and query q: lanes
// over the geometry's cells (geom_cells_all_within / _any_within).
struct Rule {
  bool all_gn, any_nb;
};

__device__ __forceinline__ Rule cell_rule(const Args& a, int q, int g,
                                          int lane) {
  const int32_t* cells = a.cells + static_cast<size_t>(g) * a.C;
  const uint8_t* cmask = a.cells_mask + static_cast<size_t>(g) * a.C;
  const uint8_t* gn = a.mode == kModeRange
                          ? a.gn + static_cast<size_t>(q) * a.num_cells
                          : nullptr;
  const uint8_t* nb = a.nb + static_cast<size_t>(q) * a.num_cells;
  bool all_hit = true, any_cell = false, any_nb = false;
  for (int c = lane; c < a.C; c += 32) {
    const bool m = cmask[c] != 0;
    const int cell = max(cells[c], 0);
    if (gn != nullptr) all_hit = all_hit && (gn[cell] != 0 || !m);
    any_nb = any_nb || (m && nb[cell] != 0);
    any_cell = any_cell || m;
  }
  Rule r;
  const bool all_in = __all_sync(kFull, all_hit);
  const bool some = __any_sync(kFull, any_cell);
  r.all_gn = gn != nullptr && all_in && some;
  r.any_nb = __any_sync(kFull, any_nb);
  return r;
}

// The block's geometries for query q: the rule, the distance where it is
// consulted (dist_fn(g), called by the whole warp), the outputs and the
// counts.
template <typename DistFn>
__device__ __forceinline__ void evaluate(const Args& a, int q,
                                         const DistFn& dist_fn) {
  __shared__ int block_counts[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < 2) block_counts[threadIdx.x] = 0;
  __syncthreads();
  int gn_bypassed = 0, dist_evals = 0;
  const int g0 = blockIdx.x * kGeomsPerBlock;
  for (int k = warp; k < kGeomsPerBlock; k += kWarps) {
    const int g = g0 + k;
    if (g >= a.G) break;
    const Rule r = cell_rule(a, q, g, lane);
    const bool valid = a.valid[g] != 0;
    const bool consulted =
        valid && r.any_nb && (a.mode == kModeKnn || !r.all_gn);
    const float d = consulted ? dist_fn(g, lane) : INFINITY;
    if (lane == 0) {
      bool flag = consulted;
      if (a.mode == kModeRange) {
        flag = valid && (r.all_gn || (consulted && d <= a.radius));
        gn_bypassed += (valid && r.all_gn) ? 1 : 0;
      }
      dist_evals += consulted ? 1 : 0;
      const size_t o = static_cast<size_t>(q) * a.G + g;
      a.flag[o] = flag ? 1 : 0;
      a.dist[o] = d;
    }
  }
  if (lane == 0 && (gn_bypassed | dist_evals)) {
    atomicAdd(&block_counts[0], gn_bypassed);
    atomicAdd(&block_counts[1], dist_evals);
  }
  __syncthreads();
  if (threadIdx.x < 2 && block_counts[threadIdx.x]) {
    atomicAdd(a.counts + 2 * q + threadIdx.x, block_counts[threadIdx.x]);
  }
}

__global__ void __launch_bounds__(kThreads) geom_dist_point_kernel(Args a) {
  const int q = blockIdx.y;
  const float px = a.qx[q], py = a.qy[q];
  evaluate(a, q, [&](int g, int lane) {
    if (a.approximate) {
      const float* b = a.bbox + 4 * static_cast<size_t>(g);
      return box_dist(fmaxf(b[0] - px, px - b[2]),
                      fmaxf(b[1] - py, py - b[3]));
    }
    return point_geom_dist(px, py, a.edges + static_cast<size_t>(g) * a.E * 4,
                           a.edge_mask + static_cast<size_t>(g) * a.E, a.E,
                           a.is_areal[g] != 0, lane);
  });
}

__global__ void __launch_bounds__(kThreads) geom_dist_geom_kernel(Args a) {
  __shared__ QueryEdges s;
  const int q = blockIdx.y;
  const float* q_edges = a.q_edges + static_cast<size_t>(q) * a.Eq * 4;
  const uint8_t* q_mask = a.q_mask + static_cast<size_t>(q) * a.Eq;
  const bool staged = !a.approximate && a.Eq <= kQueryChunk;
  if (staged) {
    for (int j = threadIdx.x; j < a.Eq; j += kThreads) {
      const Edge e = prepare(q_edges + 4 * j, q_mask[j] != 0);
      s.x1[j] = e.x1;
      s.y1[j] = e.y1;
      s.x2[j] = e.x2;
      s.y2[j] = e.y2;
      s.cx[j] = e.cx;
      s.cy[j] = e.cy;
      s.slope[j] = e.slope;
      s.inv_len[j] = e.inv_len;
      s.valid[j] = e.valid ? 1 : 0;
    }
  }
  // evaluate() synchronises the block before it reads the staged edges
  const QuerySide query{&s, q_edges, q_mask, staged};
  const bool q_areal = a.q_areal[q] != 0;
  const float* qb = a.q_bbox + 4 * static_cast<size_t>(q);
  evaluate(a, q, [&](int g, int lane) {
    if (a.approximate) {
      const float* b = a.bbox + 4 * static_cast<size_t>(g);
      return box_dist(fmaxf(b[0] - qb[2], qb[0] - b[2]),
                      fmaxf(b[1] - qb[3], qb[1] - b[3]));
    }
    return geom_geom_dist(a.edges + static_cast<size_t>(g) * a.E * 4,
                          a.edge_mask + static_cast<size_t>(g) * a.E, a.E,
                          a.is_areal[g] != 0, query, a.Eq, q_areal, lane);
  });
}

}  // namespace

// Every pointer is a device pointer; qx/qy are read for a point query
// (geometry_query = 0), q_edges/q_mask/q_areal/q_bbox for a geometry query,
// gn in range mode only. flag (Q, G) bool, dist (Q, G) f32 and counts
// (Q, 2) int32 are outputs. Launches on `stream` (a memset of the counts,
// then one kernel), does not synchronise, and returns cudaGetLastError().
extern "C" int geom_dist_launch(
    int mode, int approximate, int geometry_query, int G, int E, int C,
    int Q, int Eq, int num_cells, const float* edges,
    const uint8_t* edge_mask, const float* bbox, const int32_t* cells,
    const uint8_t* cells_mask, const uint8_t* is_areal, const uint8_t* valid,
    const float* qx, const float* qy, const float* q_edges,
    const uint8_t* q_mask, const uint8_t* q_areal, const float* q_bbox,
    const uint8_t* gn, const uint8_t* nb, float radius, uint8_t* flag,
    float* dist, int32_t* counts, void* stream) {
  if ((mode != kModeRange && mode != kModeKnn) || Q > 65535 || Q < 0 ||
      G < 0 || (mode == kModeRange && gn == nullptr) || nb == nullptr ||
      (geometry_query && (q_edges == nullptr || q_mask == nullptr ||
                          q_areal == nullptr || q_bbox == nullptr)) ||
      (!geometry_query && (qx == nullptr || qy == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q > 0) {
    cudaMemsetAsync(counts, 0, sizeof(int32_t) * 2 * static_cast<size_t>(Q),
                    s);
  }
  if (G > 0 && Q > 0) {
    const Args a{mode, approximate, G, E, C, Eq, num_cells, edges,
                 edge_mask, bbox, cells, cells_mask, is_areal, valid, qx,
                 qy, q_edges, q_mask, q_areal, q_bbox, gn, nb, radius, flag,
                 dist, counts};
    const dim3 grid((G + kGeomsPerBlock - 1) / kGeomsPerBlock, Q);
    if (geometry_query) {
      geom_dist_geom_kernel<<<grid, kThreads, 0, s>>>(a);
    } else {
      geom_dist_point_kernel<<<grid, kThreads, 0, s>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
