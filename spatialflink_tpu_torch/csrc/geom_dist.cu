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
// What bounds it on an H100. A single-query window (options 16-92) reads
// each geometry's cells and validity, and the edges of the geometries the
// rule consults (~17 bytes a padded edge): bytes, 0.005-0.014 ms at a
// 131,072-geometry window. Sixteen 64-edge query polygons (multiQuery)
// cost ~104 f32 operations per (geometry edge, query edge) pair in full
// (four clamped projections, four orientations): operations, 0.75-1.6 ms
// at 67 TFLOP/s. With --fmad=false every add and multiply issues alone, so
// an operations-bound case can reach at most half of that rate, which
// counts an FMA as two. A 512-geometry micro-batch (realtime) is bound by
// the latency of one launch and its few dependent reads. PERF.md has the
// times.
//
// Design. A block of 256 threads takes a tile of `tile` geometries (256 at
// a window, halved down to 8 while the grid would not fill two blocks per
// SM) and loops over the queries inside the block:
// - per query, thread t decides the cell rule of geometry t of the tile,
//   the block compacts the consulted geometries into a list in shared
//   memory, and groups of W lanes take them from the list (an atomic in
//   shared memory hands out the next one); thread t then writes the flag
//   and the distance of geometry t, so every (q, tile) row is written as
//   one contiguous run;
// - a tile of at most 256 / W geometries (a micro-batch) skips the list:
//   group k holds geometry k, whose first edges it reads when the block
//   starts, while the cell rule's reads are in flight;
// - W follows the window's padded edge count E: 8 lanes for E <= 8 (four
//   geometries per warp), 16 for E <= 16, 32 above; a lane holds one edge
//   of the geometry (E > 32: one per 32), prepared in registers once per
//   query (the reciprocal squared length and the ray slope, as the plain
//   version takes them on the edge shape). Min reductions are shuffles and
//   parities popcounts of ballots, both exact in any order;
// - a geometry query of up to kQueryChunk edges is staged per (block,
//   query) in dynamic shared memory sized to Eq: its valid edges only,
//   compacted, with their prepared values and their boxes widened by the
//   skip margin. A larger query is read from device memory, the same code
//   through another accessor;
// - containment first, exactly, and before any distance: a query vertex
//   can lie inside g only if its y is in [ylo, yhi) of g's valid endpoints
//   (no edge of g straddles another y), and a vertex of g inside q needs a
//   query edge whose y-range meets [ylo, yhi]: lanes over the query's
//   vertices or edges find those by one ballot per W, and only they are
//   tested against g (lanes over g's edges or vertices). Each test is the
//   plain version's own crossing test; a y-band skip is exact because it
//   only skips edges whose straddle test is false. Inside -> 0, no fold;
// - then the distance fold, with an exact pair skip: (a) lanes over the
//   query's edges find j*, the edge whose box is nearest g's box; (b) the
//   pairs (i, j*) over all of g's edges give an upper bound UB of the min
//   (real pair values); (c) every other query edge j is folded only where
//   its box bound is <= the running min, or where its orientation is not
//   certified (below); a folded pair still skips its four projections when
//   the bound between its own two edge boxes exceeds the running min.
// - The counts: one __syncthreads_count per (block, query, count) and one
//   atomicAdd each. They are zeroed inside the launch (no memset, one
//   launch per call): each block takes a ticket when it starts; the block
//   with the launch's first ticket zeroes them and raises a flag to the
//   launch's epoch + 1, and a later block waits for that flag before it
//   adds (struct Ticket). The block it waits for has taken its ticket, so
//   it is running: no co-residency of blocks is assumed. The block with
//   the last ticket moves the slot to its next epoch. Each launch takes
//   the next of kSlots slots on the host, so launches in flight at once on
//   several streams use different slots (a clash needs kSlots launches in
//   flight); a CUDA graph replays one slot, one epoch after another.
//
// The skip is exact. For a pair (a of g, b of q) the plain version's
// seg_seg_dist2 is 0 when its orientation test reports a proper crossing,
// else min4 = the min of four point-segment terms.
// (1) min4 >= gap2(box A, box B), for boxes A containing a's endpoints and
//     B containing b's, each widened by its margin m = max|coordinate of
//     the box| * 2^-19 (hopper_kernels.distance_skip_margin, as K4x):
//     K4x's argument (distance_skip_margin's docstring) bounds each term
//     seg_dist2(P, s) with P in one box and the segment s inside the
//     other. The computed projection of P lies within ~5Mu of s (u =
//     2^-24, M the largest |coordinate|), so within 5Mu of s's box; the
//     two margins sum to >= 32uM >= 15uM, which absorbs that, the
//     roundings of the gap and of its square. A box larger than s's own
//     box only lowers the bound. So gap2(g's box, b's box) bounds every
//     pair of the column j, and gap2(a's box, b's box) the pair.
// (2) A proper crossing needs (d1 > 0) != (d2 > 0), d1 and d2 the computed
//     orientations of a's endpoints against b's line, each fl(fl(Dx ey) -
//     fl(Dy ex)) with Dx = fl(bx2 - bx1), ex = fl(vx - bx1), and so for y.
//     Against T(v) = Dx (vy - by1) - Dy (vx - bx1) (exact, affine in v) the
//     computed value is (T(v) + e)(1 + d), |d| <= u, |e| <= (2u + u^2) S* +
//     2^-149, with S* = |Dx| Hy + |Dy| Hx and Hx, Hy the largest |v - b1|
//     over g's box: when |T(v)| exceeds that, the sign is T's. T is
//     smallest and largest at the box's corners; the kernel computes the
//     corners the same way (each within the same error of T) and S with
//     three roundings, and certifies the column j when every corner value
//     is > 2^-21 S + 2^-100, or every one < -(2^-21 S + 2^-100): 2^-21 =
//     8u covers 2 x (2u + u^2) with the roundings of S and of the sum, and
//     2^-100 the underflow terms. Then every endpoint of g has the same
//     computed sign of orientation against b's line, no pair of the column
//     is a proper crossing, and its value is min4. Overflow makes S (and
//     the threshold) infinite, which certifies nothing.
// So a skipped pair (certified column, bound > the running min, which is
// the value of a real pair) has a value above the min: the minimum, and
// its square root, are those of the full fold bit for bit.
// (3) The y-band skips of the containment tests skip only pairs whose
//     straddle comparison is false; the x test is never skipped (x_at_y
//     rounds).
// ops/geom.py holds the plain versions of (1) and (2):
// edge_pair_skip_bound and orientation_certified.
//
// Built with --fmad=false: each operation rounds once, as the plain
// version's separate PyTorch ops do, and the result equals the plain
// version's bit for bit (flags, counts, and the distance of every consulted
// slot).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueryChunk = 1024;  // ops/geom.py QUERY_CHUNK
constexpr int kModeRange = 0;
constexpr int kModeKnn = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.4e38f;  // "infinitely far" (ops/geom.py _BIG)
// the smallest normal f32: a squared edge length below it counts as zero
// (distances.FLT_MIN; its reciprocal would overflow, and 0 * inf is NaN)
constexpr float kMinNormal = 1.17549435e-38f;
// hopper_kernels.distance_skip_margin(1.0) = 2^-19
constexpr float kMarginScale = 1.9073486328125e-06f;
// the orientation certificate's threshold: 2^-21 S + 2^-100
constexpr float kCertScale = 4.76837158203125e-07f;
constexpr float kCertFloor = 7.888609052210118e-31f;
// the kinds of launch: point queries; geometry queries staged in shared
// memory; geometry queries read from device memory (Eq > kQueryChunk)
constexpr int kPoint = 0;
constexpr int kStaged = 1;
constexpr int kUnstaged = 2;
// per staged query edge: x1, y1, x2, y2, cx, cy, slope, inv_len and the
// widened box xlo, xhi, ylo, yhi
constexpr int kQueryFields = 12;
// the counts' zeroing (struct Ticket): per slot, the ticket word (epoch,
// tickets taken) and the epoch + 1 of the last launch that zeroed them
constexpr int kSlots = 1024;
__device__ unsigned long long g_tickets[kSlots];
__device__ unsigned g_zeroed[kSlots];

struct Args {
  int mode, approximate, G, E, C, Q, Eq, num_cells;
  int tile;                    // geometries per block
  int slot;                    // this launch's slot of g_tickets/g_zeroed
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

struct Box {
  float xlo, xhi, ylo, yhi;
};

// distances.point_segment_dist2's reciprocal and point_in_rings' slope
__device__ __forceinline__ Edge prepare(float x1, float y1, float x2,
                                        float y2, bool valid) {
  Edge s;
  s.x1 = x1;
  s.y1 = y1;
  s.x2 = x2;
  s.y2 = y2;
  s.cx = x2 - x1;
  s.cy = y2 - y1;
  const float len_sq = s.cx * s.cx + s.cy * s.cy;
  s.inv_len = len_sq >= kMinNormal ? 1.0f / len_sq : 0.0f;
  const float denom = (y2 == y1) ? 1.0f : s.cy;
  s.slope = s.cx / denom;
  s.valid = valid;
  return s;
}

// A box widened by its skip margin: max |coordinate| * 2^-19 on each side
// (hopper_kernels.distance_skip_bound's m_e and m_l).
__device__ __forceinline__ Box widen(float xlo, float xhi, float ylo,
                                     float yhi) {
  const float m = fmaxf(fmaxf(fabsf(xlo), fabsf(xhi)),
                        fmaxf(fabsf(ylo), fabsf(yhi))) * kMarginScale;
  return Box{xlo - m, xhi + m, ylo - m, yhi + m};
}

__device__ __forceinline__ Box edge_box(const Edge& e) {
  return widen(fminf(e.x1, e.x2), fmaxf(e.x1, e.x2), fminf(e.y1, e.y2),
               fmaxf(e.y1, e.y2));
}

// Lower bound of every point-segment term between two widened boxes
// (hopper_kernels.distance_skip_bound's roundings).
__device__ __forceinline__ float gap2(const Box& a, const Box& b) {
  const float gx = fmaxf(fmaxf(b.xlo - a.xhi, a.xlo - b.xhi), 0.0f);
  const float gy = fmaxf(fmaxf(b.ylo - a.yhi, a.ylo - b.yhi), 0.0f);
  return gx * gx + gy * gy;
}

// Every point of box g lies strictly on one side of b's line, beyond the
// rounding of the orientation test (the header's (2);
// geom.orientation_certified).
__device__ __forceinline__ bool one_side(const Box& g, const Edge& b) {
  const float exl = g.xlo - b.x1, exh = g.xhi - b.x1;
  const float eyl = g.ylo - b.y1, eyh = g.yhi - b.y1;
  const float t00 = b.cx * eyl - b.cy * exl;
  const float t01 = b.cx * eyh - b.cy * exl;
  const float t10 = b.cx * eyl - b.cy * exh;
  const float t11 = b.cx * eyh - b.cy * exh;
  const float s = fabsf(b.cx) * fmaxf(fabsf(eyl), fabsf(eyh)) +
                  fabsf(b.cy) * fmaxf(fabsf(exl), fabsf(exh));
  const float thr = s * kCertScale + kCertFloor;
  const float lo = fminf(fminf(t00, t01), fminf(t10, t11));
  const float hi = fmaxf(fmaxf(t00, t01), fmaxf(t10, t11));
  return lo > thr || hi < -thr;
}

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

// distances.segments_intersect (a: the geometry's edge, b: the query's)
__device__ __forceinline__ bool proper(const Edge& a, const Edge& b) {
  const float d1 = orient(b.x1, b.y1, b.x2, b.y2, a.x1, a.y1);
  const float d2 = orient(b.x1, b.y1, b.x2, b.y2, a.x2, a.y2);
  const float d3 = orient(a.x1, a.y1, a.x2, a.y2, b.x1, b.y1);
  const float d4 = orient(a.x1, a.y1, a.x2, a.y2, b.x2, b.y2);
  return ((d1 > 0.0f) != (d2 > 0.0f)) && ((d3 > 0.0f) != (d4 > 0.0f));
}

// distances.seg_seg_dist2 without its crossing test
__device__ __forceinline__ float min4(const Edge& a, const Edge& b) {
  return fminf(fminf(seg_dist2(a.x1, a.y1, b), seg_dist2(a.x2, a.y2, b)),
               fminf(seg_dist2(b.x1, b.y1, a), seg_dist2(b.x2, b.y2, a)));
}

// W lanes of a warp that serve one geometry at a time.
template <int W>
struct Group {
  unsigned mask;  // the group's lanes in the warp
  int base;       // its first lane
  int lane;       // this thread's lane in the group

  __device__ __forceinline__ Group() {
    const int l = threadIdx.x & 31;
    base = l & ~(W - 1);
    lane = l & (W - 1);
    mask = W == 32 ? kFull : ((1u << (W & 31)) - 1u) << base;
  }
  __device__ __forceinline__ float min(float v) const {
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
      v = fminf(v, __shfl_xor_sync(mask, v, o));
    }
    return v;
  }
  __device__ __forceinline__ float max(float v) const {
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
      v = fmaxf(v, __shfl_xor_sync(mask, v, o));
    }
    return v;
  }
  // bit k: lane k of the group
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return (__ballot_sync(mask, p) & mask) >> base;
  }
  __device__ __forceinline__ bool any(bool p) const {
    return __any_sync(mask, p) != 0;
  }
  __device__ __forceinline__ bool parity(int bit) const {
    return (__popc(ballot((bit & 1) != 0)) & 1) != 0;
  }
  __device__ __forceinline__ int bcast(int v, int src) const {
    return __shfl_sync(mask, v, base + src);
  }
};

// One stream geometry's edges in device memory.
struct GeomRef {
  const float* e;
  const uint8_t* m;
  int E;

  __device__ __forceinline__ Edge edge(int i) const {
    if (i >= E) {
      Edge z{};
      z.valid = false;
      return z;
    }
    // mask and coordinates read together (a padded edge is prepared too,
    // and every caller skips it by `valid`)
    const float* p = e + 4 * i;
    return prepare(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3),
                   __ldg(m + i) != 0);
  }
};

// The query geometry's valid edges, staged in shared memory (compacted).
struct StagedQuery {
  const float* s;
  int n, cap;

  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ bool valid(int) const { return true; }
  __device__ __forceinline__ float vx(int j) const { return s[j]; }
  __device__ __forceinline__ float vy(int j) const { return s[cap + j]; }
  __device__ __forceinline__ Edge edge(int j) const {
    Edge e;
    e.x1 = s[j];
    e.y1 = s[cap + j];
    e.x2 = s[2 * cap + j];
    e.y2 = s[3 * cap + j];
    e.cx = s[4 * cap + j];
    e.cy = s[5 * cap + j];
    e.slope = s[6 * cap + j];
    e.inv_len = s[7 * cap + j];
    e.valid = true;
    return e;
  }
  __device__ __forceinline__ Box box(int j) const {
    return Box{s[8 * cap + j], s[9 * cap + j], s[10 * cap + j],
               s[11 * cap + j]};
  }
};

// The query geometry's edges in device memory (a query of more than
// kQueryChunk edges), prepared where they are read.
struct DeviceQuery {
  const float* e;
  const uint8_t* m;
  int n;

  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ bool valid(int j) const { return m[j] != 0; }
  __device__ __forceinline__ float vx(int j) const { return e[4 * j]; }
  __device__ __forceinline__ float vy(int j) const { return e[4 * j + 1]; }
  __device__ __forceinline__ Edge edge(int j) const {
    const float* p = e + 4 * j;
    return prepare(p[0], p[1], p[2], p[3], m[j] != 0);
  }
  __device__ __forceinline__ Box box(int j) const {
    const float* p = e + 4 * j;
    return widen(fminf(p[0], p[2]), fmaxf(p[0], p[2]), fminf(p[1], p[3]),
                 fmaxf(p[1], p[3]));
  }
};

// A geometry as its group holds it: its edges in device memory, the
// lane's first edge (i = lane) as read, and its kind.
struct Held {
  GeomRef ref;
  float x1, y1, x2, y2;
  bool valid, areal;

  __device__ __forceinline__ Edge e0() const {
    return prepare(x1, y1, x2, y2, valid);
  }
};

template <int W>
__device__ __forceinline__ Held hold(const Args& a, int g,
                                     const Group<W>& grp) {
  const GeomRef ref{a.edges + static_cast<size_t>(g) * a.E * 4,
                    a.edge_mask + static_cast<size_t>(g) * a.E, a.E};
  Held h{ref, 0.0f, 0.0f, 0.0f, 0.0f, false, a.is_areal[g] != 0};
  if (grp.lane < a.E) {
    const float* p = ref.e + 4 * grp.lane;
    h.x1 = __ldg(p);
    h.y1 = __ldg(p + 1);
    h.x2 = __ldg(p + 2);
    h.y2 = __ldg(p + 3);
    h.valid = __ldg(ref.m + grp.lane) != 0;
  }
  return h;
}

// geom.point_to_geoms_dist for one geometry (the group calls it)
template <int W>
__device__ __forceinline__ float point_geom_dist(float px, float py, const Held& h,
                                 const Group<W>& grp) {
  float mind2 = kBig;
  int cross = 0;
  for (int i = grp.lane; i < h.ref.E; i += W) {
    const Edge a = i == grp.lane ? h.e0() : h.ref.edge(i);
    if (!a.valid) continue;
    mind2 = fminf(mind2, seg_dist2(px, py, a));
    cross ^= crosses(px, py, a);
  }
  mind2 = grp.min(mind2);
  const bool inside = grp.parity(cross);
  return (inside && h.areal) ? 0.0f : sqrtf(mind2);
}

// geom.geoms_to_single_geom_dist for one geometry (the group calls it):
// containment first, then the fold with the exact pair skip (the header).
template <int W, typename QV>
__device__ __forceinline__ float geom_geom_dist(const Held& h, const QV& qv, bool q_areal,
                                const Group<W>& grp) {
  const int nch = (h.ref.E + W - 1) / W;  // lane's edges: c * W + lane
  const Edge e0 = h.e0();
  auto edge_at = [&](int c) {
    return c == 0 ? e0 : h.ref.edge(c * W + grp.lane);
  };
  const bool g_areal = h.areal;
  // the exact box of g's valid endpoints
  float xlo = INFINITY, xhi = -INFINITY, ylo = INFINITY, yhi = -INFINITY;
  for (int c = 0; c < nch; ++c) {
    const Edge e = edge_at(c);
    if (!e.valid) continue;
    xlo = fminf(xlo, fminf(e.x1, e.x2));
    xhi = fmaxf(xhi, fmaxf(e.x1, e.x2));
    ylo = fminf(ylo, fminf(e.y1, e.y2));
    yhi = fmaxf(yhi, fmaxf(e.y1, e.y2));
  }
  xlo = grp.min(xlo);
  xhi = grp.max(xhi);
  ylo = grp.min(ylo);
  yhi = grp.max(yhi);
  if (!(xlo <= xhi)) return sqrtf(kBig);  // no valid edge
  const Box gbox{xlo, xhi, ylo, yhi};
  const int n = qv.count();

  // a vertex of q inside an areal g: only a vertex with y in [ylo, yhi)
  // can have an edge of g straddle it
  bool inside = false;
  if (g_areal) {
    for (int jc = 0; jc < n && !inside; jc += W) {
      const int j = jc + grp.lane;
      bool in_band = false;
      if (j < n) {
        const float vy = qv.vy(j);
        in_band = qv.valid(j) && vy >= ylo && vy < yhi;
      }
      unsigned bits = grp.ballot(in_band);
      while (bits != 0 && !inside) {
        const int k = __ffs(bits) - 1;
        bits &= bits - 1;
        const float px = qv.vx(jc + k), py = qv.vy(jc + k);
        int cross = 0;
        for (int c = 0; c < nch; ++c) cross ^= crosses(px, py, edge_at(c));
        inside = grp.parity(cross);
      }
    }
  }
  // a vertex of g inside an areal q: only query edges whose y-range meets
  // [ylo, yhi] can straddle one
  if (q_areal && !inside) {
    for (int c = 0; c < nch && !inside; ++c) {
      const Edge e = edge_at(c);
      int cross = 0;
      for (int jc = 0; jc < n; jc += W) {
        const int j = jc + grp.lane;
        bool meets = false;
        if (j < n && qv.valid(j)) {
          const Edge b = qv.edge(j);
          meets = fmaxf(b.y1, b.y2) > ylo && fminf(b.y1, b.y2) <= yhi;
        }
        unsigned bits = grp.ballot(meets);
        while (bits != 0) {
          const int k = __ffs(bits) - 1;
          bits &= bits - 1;
          cross ^= crosses(e.x1, e.y1, qv.edge(jc + k));
        }
      }
      inside = grp.any(e.valid && (cross & 1) != 0);
    }
  }
  if (inside) return 0.0f;

  // (a) the query edge nearest g's box
  const Box gw = widen(xlo, xhi, ylo, yhi);
  float best = INFINITY;
  int best_j = -1;
  for (int j = grp.lane; j < n; j += W) {
    if (!qv.valid(j)) continue;
    const float lb = gap2(gw, qv.box(j));
    if (best_j < 0 || lb < best) {
      best = lb;
      best_j = j;
    }
  }
  const float nearest = grp.min(best);
  const unsigned who = grp.ballot(best_j >= 0 && best == nearest);
  if (who == 0) return sqrtf(kBig);  // no valid query edge
  const int jstar = grp.bcast(best_j, __ffs(who) - 1);
  // (b) its pairs: the upper bound that the skip starts from
  const Edge bs = qv.edge(jstar);
  float mind2 = kBig;
  for (int c = 0; c < nch; ++c) {
    const Edge e = edge_at(c);
    if (!e.valid) continue;
    mind2 = fminf(mind2, proper(e, bs) ? 0.0f : min4(e, bs));
  }
  mind2 = grp.min(mind2);
  // (c) the other query edges, each folded only where it can matter
  for (int jc = 0; jc < n && mind2 > 0.0f; jc += W) {
    const int j = jc + grp.lane;
    bool need = false, cert = false;
    if (j < n && j != jstar && qv.valid(j)) {
      cert = one_side(gbox, qv.edge(j));
      need = !cert || gap2(gw, qv.box(j)) <= mind2;
    }
    unsigned bits = grp.ballot(need);
    const unsigned certs = grp.ballot(cert);
    while (bits != 0 && mind2 > 0.0f) {
      const int k = __ffs(bits) - 1;
      bits &= bits - 1;
      const Edge b = qv.edge(jc + k);
      const Box bb = qv.box(jc + k);
      const bool certified = ((certs >> k) & 1u) != 0;
      float d = mind2;
      for (int c = 0; c < nch; ++c) {
        const Edge e = edge_at(c);
        if (!e.valid) continue;
        if (!certified && proper(e, b)) {
          d = 0.0f;
        } else if (gap2(edge_box(e), bb) <= d) {
          d = fminf(d, min4(e, b));
        }
      }
      mind2 = grp.min(d);
    }
  }
  return sqrtf(mind2);
}

// geom.point_bbox_dist / distances.bbox_bbox_dist
__device__ __forceinline__ float box_dist(float dx, float dy) {
  dx = fmaxf(dx, 0.0f);
  dy = fmaxf(dy, 0.0f);
  return sqrtf(dx * dx + dy * dy);
}

// Query q's valid edges into shared memory, compacted, with their
// prepared values and widened boxes; returns their number (the same in
// every thread). Ends with the block synchronised.
__device__ int stage_query(const Args& a, int q, float* s, int* s_warp) {
  const int cap = a.Eq;
  const float* e = a.q_edges + static_cast<size_t>(q) * a.Eq * 4;
  const uint8_t* m = a.q_mask + static_cast<size_t>(q) * a.Eq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int base = 0;
  for (int j0 = 0; j0 < a.Eq; j0 += kThreads) {
    const int j = j0 + static_cast<int>(threadIdx.x);
    const bool v = j < a.Eq && m[j] != 0;
    const unsigned b = __ballot_sync(kFull, v);
    if (lane == 0) s_warp[warp] = __popc(b);
    __syncthreads();
    int off = base, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (v) {
      const int k = off + __popc(b & ((1u << lane) - 1u));
      const float* p = e + 4 * j;
      const Edge x = prepare(p[0], p[1], p[2], p[3], true);
      const Box bx = edge_box(x);
      s[k] = x.x1;
      s[cap + k] = x.y1;
      s[2 * cap + k] = x.x2;
      s[3 * cap + k] = x.y2;
      s[4 * cap + k] = x.cx;
      s[5 * cap + k] = x.cy;
      s[6 * cap + k] = x.slope;
      s[7 * cap + k] = x.inv_len;
      s[8 * cap + k] = bx.xlo;
      s[9 * cap + k] = bx.xhi;
      s[10 * cap + k] = bx.ylo;
      s[11 * cap + k] = bx.yhi;
    }
    base += total;
    __syncthreads();  // s_warp is read again by the next round
  }
  return base;
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// The zeroing of the counts inside the launch (the header), run by the
// last warp of every block (at a micro-batch it writes no output, so its
// fences wait for nothing else). A slot holds a ticket word, the launch's
// epoch in its high half and the tickets taken in its low half, and a
// flag, the epoch of the last launch whose counts were zeroed, plus one.
// take() when the block starts: the block that takes the launch's last
// ticket moves the word to the next epoch with no ticket taken (no block
// of this launch takes one after it, and a later launch on the slot runs
// after this one). settle() once the block's first cell rule is done (by
// then the ticket has come back): the block with the first ticket zeroes
// the counts and raises the flag to its epoch + 1; any other reads the
// flag. ready() before the block's first count waits for the flag where
// that read found it lower. No block waits for anything at its end.
struct Ticket {
  unsigned long long* word;
  unsigned* flag;
  unsigned long long ticket = 1ull;  // lane 0's
  unsigned seen = 0u;                // lane 0's read of the flag
  bool settled = false, first = false;

  __device__ __forceinline__ unsigned epoch() const {
    return static_cast<unsigned>(ticket >> 32);
  }
  __device__ __forceinline__ void take() {
    if ((threadIdx.x & 31) != 0) return;
    ticket = atomicAdd(word, 1ull);
    if (static_cast<unsigned>(ticket) == gridDim.x - 1) {
      atomicAdd(word, (1ull << 32) - gridDim.x);
    }
  }
  __device__ __forceinline__ void settle(const Args& a) {
    if (settled) return;
    settled = true;
    const int lane = threadIdx.x & 31;
    const unsigned idx = static_cast<unsigned>(ticket);
    first = __shfl_sync(kFull, idx == 0u ? 1u : 0u, 0) != 0u;
    if (first) {
      for (int i = lane; i < 2 * a.Q; i += 32) a.counts[i] = 0;
      fence_acq_rel();  // the zeroes before the flag
      __syncwarp();
      if (lane == 0) atomicExch(flag, epoch() + 1u);
    } else if (lane == 0) {
      seen = atomicAdd(flag, 0u);  // waited for only in ready()
    }
  }
  __device__ __forceinline__ void ready() {
    if (first || (threadIdx.x & 31) != 0) return;
    while (static_cast<int>(seen - (epoch() + 1u)) < 0) {
      __nanosleep(32);
      seen = atomicAdd(flag, 0u);
    }
    fence_acq_rel();  // the counts' adds after the zeroing seen
  }
};

// The distance of the geometry `h` to query q (the group calls it).
template <int W, int kKind>
__device__ __forceinline__ float dist(const Args& a, int q, const Held& h,
                                      const float* s_query, int n_staged,
                                      const Group<W>& grp) {
  if constexpr (kKind == kPoint) {
    return point_geom_dist<W>(a.qx[q], a.qy[q], h, grp);
  } else {
    const bool q_areal = a.q_areal[q] != 0;
    if constexpr (kKind == kStaged) {
      const StagedQuery qv{s_query, n_staged, a.Eq};
      return geom_geom_dist<W>(h, qv, q_areal, grp);
    } else {
      const DeviceQuery qv{a.q_edges + static_cast<size_t>(q) * a.Eq * 4,
                           a.q_mask + static_cast<size_t>(q) * a.Eq, a.Eq};
      return geom_geom_dist<W>(h, qv, q_areal, grp);
    }
  }
}

// kDirect: a tile of at most kThreads / W geometries (a small window),
// whose group k holds geometry k for every query, loaded before the first
// rule. Registers: 2 blocks per SM, which ptxas meets without spilling;
// the point kernel over a window 4 (64 registers), where the occupancy
// pays more than its few spills cost (kernel_ab.py, PERF.md).
template <int W, int kKind, bool kDirect>
__global__ void __launch_bounds__(kThreads,
                                  kKind == kPoint && !kDirect ? 4 : 2)
    geom_dist_kernel(Args a) {
  extern __shared__ float s_query[];  // kStaged: kQueryFields x Eq floats
  __shared__ float s_dist[kThreads];
  __shared__ uint16_t s_list[kThreads];
  __shared__ int s_warp[kWarps];
  __shared__ int s_next;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  constexpr int kTicketWarp = kWarps - 1;
  Ticket ticket{&g_tickets[a.slot], &g_zeroed[a.slot]};  // kTicketWarp's
  if (warp == kTicketWarp) ticket.take();
  const int g0 = blockIdx.x * a.tile;
  const int g = g0 + t;
  const bool mine = t < a.tile && g < a.G;
  const bool valid = mine && a.valid[g] != 0;
  const Group<W> grp;
  const int group = t / W;
  Held mine_held{};
  if (kDirect && !a.approximate && group < a.tile && g0 + group < a.G) {
    mine_held = hold<W>(a, g0 + group, grp);
  }
  for (int q = 0; q < a.Q; ++q) {
    int n_staged = 0;
    if constexpr (kKind == kStaged) {
      if (!a.approximate) n_staged = stage_query(a, q, s_query, s_warp);
    }
    // the cell rule of geometry t
    bool all_gn = false, any_nb = false;
    if (mine) {
      const int32_t* cells = a.cells + static_cast<size_t>(g) * a.C;
      const uint8_t* cmask = a.cells_mask + static_cast<size_t>(g) * a.C;
      const uint8_t* gn = a.mode == kModeRange
                              ? a.gn + static_cast<size_t>(q) * a.num_cells
                              : nullptr;
      const uint8_t* nb = a.nb + static_cast<size_t>(q) * a.num_cells;
      bool all_hit = true, any_cell = false;
      for (int c = 0; c < a.C; ++c) {
        if (!cmask[c]) continue;
        const int cell = max(cells[c], 0);
        any_cell = true;
        if (gn != nullptr && !gn[cell]) all_hit = false;
        if (nb[cell]) any_nb = true;
      }
      all_gn = gn != nullptr && all_hit && any_cell;
    }
    const bool consulted =
        valid && any_nb && (a.mode == kModeKnn || !all_gn);
    if (warp == kTicketWarp) ticket.settle(a);
    float d = INFINITY;
    if (a.approximate) {
      if (consulted) {
        const float* b = a.bbox + 4 * static_cast<size_t>(g);
        if constexpr (kKind == kPoint) {
          const float px = a.qx[q], py = a.qy[q];
          d = box_dist(fmaxf(b[0] - px, px - b[2]),
                       fmaxf(b[1] - py, py - b[3]));
        } else {
          const float* qb = a.q_bbox + 4 * static_cast<size_t>(q);
          d = box_dist(fmaxf(b[0] - qb[2], qb[0] - b[2]),
                       fmaxf(b[1] - qb[3], qb[1] - b[3]));
        }
      }
    } else {
      if constexpr (kDirect) {
        if (t < a.tile) s_list[t] = consulted ? 1 : 0;
        __syncthreads();
        if (group < a.tile && s_list[group] != 0) {
          const float dd =
              dist<W, kKind>(a, q, mine_held, s_query, n_staged, grp);
          if (grp.lane == 0) s_dist[group] = dd;
        }
      } else {
        // the consulted geometries of the tile, in a list that the groups
        // take from one at a time
        const unsigned bal = __ballot_sync(kFull, consulted);
        if (lane == 0) s_warp[warp] = __popc(bal);
        if (t == 0) s_next = 0;
        __syncthreads();
        int off = 0, total = 0;
        for (int w = 0; w < kWarps; ++w) {
          const int c = s_warp[w];
          off += w < warp ? c : 0;
          total += c;
        }
        if (consulted) {
          s_list[off + __popc(bal & ((1u << lane) - 1u))] =
              static_cast<uint16_t>(t);
        }
        __syncthreads();
        for (;;) {
          int k = 0;
          if (grp.lane == 0) k = atomicAdd(&s_next, 1);
          k = grp.bcast(k, 0);
          if (k >= total) break;
          const int tt = s_list[k];
          const float dd = dist<W, kKind>(a, q, hold<W>(a, g0 + tt, grp),
                                          s_query, n_staged, grp);
          if (grp.lane == 0) s_dist[tt] = dd;
        }
      }
      __syncthreads();
      if (consulted) d = s_dist[t];
    }
    if (mine) {
      bool flag = consulted;
      if (a.mode == kModeRange) {
        flag = valid && (all_gn || (consulted && d <= a.radius));
      }
      const size_t o = static_cast<size_t>(q) * a.G + g;
      a.flag[o] = flag ? 1 : 0;
      a.dist[o] = d;
    }
    // also keeps the next query's staging off this one's shared memory
    const int n_gn = __syncthreads_count(valid && all_gn);
    const int n_ev = __syncthreads_count(consulted);
    if (warp == kTicketWarp && (n_gn | n_ev) != 0) {
      ticket.ready();
      if (lane == 0) {
        if (n_gn) atomicAdd(a.counts + 2 * q, n_gn);
        if (n_ev) atomicAdd(a.counts + 2 * q + 1, n_ev);
      }
    }
  }
}

template <int W, bool kDirect>
void (*pick(int kind))(Args) {
  return kind == kPoint    ? &geom_dist_kernel<W, kPoint, kDirect>
         : kind == kStaged ? &geom_dist_kernel<W, kStaged, kDirect>
                           : &geom_dist_kernel<W, kUnstaged, kDirect>;
}

template <int W>
cudaError_t launch_w(const Args& a, int kind, int blocks, cudaStream_t s) {
  size_t smem = 0;
  if (kind == kStaged && !a.approximate) {
    smem = sizeof(float) * kQueryFields * static_cast<size_t>(a.Eq);
  }
  void (*kernel)(Args) =
      a.tile <= kThreads / W ? pick<W, true>(kind) : pick<W, false>(kind);
  if (smem > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

std::atomic<unsigned> g_next_slot{0};

}  // namespace

// Every pointer is a device pointer; qx/qy are read for a point query
// (geometry_query = 0), q_edges/q_mask/q_areal/q_bbox for a geometry query,
// gn in range mode only. flag (Q, G) bool, dist (Q, G) f32 and counts
// (Q, 2) int32 are outputs (the counts are zeroed inside the launch).
// Launches one kernel on `stream` (none when Q = 0), does not synchronise,
// and returns cudaGetLastError().
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
  if (Q == 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // 256 geometries a block, fewer while the grid would not fill two
  // blocks per SM
  int tile = kThreads;
  while (tile > 8 && (G + tile - 1) / tile < 2 * sms) tile >>= 1;
  const int blocks = G > 0 ? (G + tile - 1) / tile : 1;
  const int kind = !geometry_query                        ? kPoint
                   : (approximate || Eq <= kQueryChunk) ? kStaged
                                                          : kUnstaged;
  const Args a{mode, approximate, G, E, C, Q, Eq, num_cells, tile,
               static_cast<int>(g_next_slot.fetch_add(1) % kSlots), edges,
               edge_mask, bbox, cells, cells_mask, is_areal, valid, qx, qy,
               q_edges, q_mask, q_areal, q_bbox, gn, nb, radius, flag, dist,
               counts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (E <= 8) {
    err = launch_w<8>(a, kind, blocks, s);
  } else if (E <= 16) {
    err = launch_w<16>(a, kind, blocks, s);
  } else {
    err = launch_w<32>(a, kind, blocks, s);
  }
  return static_cast<int>(err);
}
