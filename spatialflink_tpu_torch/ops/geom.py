"""Geometry distances (port of ``spatialflink_tpu.ops.geom``).

Point streams: each point to ONE query geometry through the K4 kernel,
and to Q query geometries through the (N, G) lattice of the K4x kernel,
which the multi-query entries consume as (Q, N).

Polygon and linestring streams (a window as an :class:`EdgeGeomBatch` of
G geometries) against Q query points or Q query geometries: one launch of
the K5 kernel (:func:`geom_stream_dist`, ``csrc/geom_dist.cu``) per
window. K5 fuses the cell rule of the reference (a geometry whose cells
are ALL guaranteed passes a range query without a distance; one with ANY
neighbouring cell is a candidate) with the exact distance, which it
computes only where the rule consults it: segment against segment for
every pair of valid edges, and vertex containment both ways. kNN hands
K5's eligibility and distances to K2 (``ops/knn.py``, eligible mode).
CPU tensors run :func:`geom_stream_dist_plain`, built from the JAX
package's functions ported here as plain PyTorch:
:func:`geoms_to_single_geom_dist`, :func:`point_to_geoms_dist`,
:func:`geoms_bbox_dist`, :func:`geom_cells_all_within`,
:func:`geom_cells_any_within`, :func:`_geom_elig_multi` and
``ops/range.py`` ``range_filter_geom_stream_stats``. They tile over G, so
no (G, E, Eq) lattice of a whole window is ever built.

JTS distance semantics: point -> polygon is 0 inside the areal geometry,
else the min boundary distance; point -> linestring is the min boundary
distance; geometry -> geometry is 0 when the boundaries cross or touch or
one contains a vertex of the other (areal side only), else the min
boundary distance.
"""

from __future__ import annotations

import ctypes
import math

import torch

from spatialflink_tpu_torch.ops import distances as D
from spatialflink_tpu_torch.ops import native
from spatialflink_tpu_torch.ops import range as R

_BIG = 3.4e38  # "infinitely far" sentinel that survives f32 math


def points_to_single_geom_dist(points, edges, edge_mask, is_areal: bool,
                               table=None):
    """(N,) distance from every point of a batch to ONE query geometry,
    through the K4 kernel wrapper (its plain version on CPU tensors). With
    the query's ``hopper_kernels.PipTable`` (whose edges, mask and is_areal
    are the first arguments) the kernel folds only each point's cell's
    listed edges."""
    from spatialflink_tpu_torch.ops import hopper_kernels as HK

    cell = points.cell if table is not None and table.bits is not None \
        else None
    return HK.pip_dist(points.x, points.y, edges, edge_mask, bool(is_areal),
                       cell=cell, table=table)


def points_to_single_edges_raw(px, py, edges, edge_mask):
    """(inside, min_dist2) of each point vs ONE edge set as a (points x
    edges) broadcast; an empty or fully masked edge set yields
    min_dist2 = 3.4e38."""
    d2 = D.point_segment_dist2(
        px[:, None], py[:, None],
        edges[None, :, 0], edges[None, :, 1],
        edges[None, :, 2], edges[None, :, 3])
    d2 = torch.where(edge_mask[None], d2, _BIG)
    pad = torch.full((d2.shape[0], 1), _BIG, dtype=d2.dtype, device=d2.device)
    mind2 = torch.cat([d2, pad], dim=1).amin(dim=1)
    inside = D.point_in_rings(px[:, None], py[:, None], edges[None],
                              edge_mask[None])
    return inside, mind2


def points_in_geoms(px, py, edges, edge_mask):
    """(N, G) even-odd containment of each point in each geometry's rings
    (edges (G, E, 4), edge_mask (G, E))."""
    return D.point_in_rings(px[:, None, None], py[:, None, None], edges[None],
                            edge_mask[None])


def points_to_edges_dist(px, py, edges, edge_mask):
    """(N, G) min boundary distance from each point to each edge set; a
    geometry without valid edges gives sqrt(3.4e38)."""
    d2 = D.point_segment_dist2(
        px[:, None, None], py[:, None, None],
        edges[None, ..., 0], edges[None, ..., 1],
        edges[None, ..., 2], edges[None, ..., 3])
    d2 = torch.where(edge_mask[None], d2, _BIG)
    pad = torch.full(d2.shape[:2] + (1,), _BIG, dtype=d2.dtype,
                     device=d2.device)
    return torch.sqrt(torch.cat([d2, pad], dim=2).amin(dim=2))


def points_to_geoms_dist(points, geoms):
    """(N, G) JTS-style distance from each point to each geometry of an
    :class:`EdgeGeomBatch`, through the K4x kernel wrapper."""
    return _lattice(points, geoms).T


def _lattice(points, geoms, num_cells: int = 0):
    """(G, N) rows of :func:`points_to_geoms_dist`, as K4x writes them.
    With the grid's ``num_cells`` the kernel takes the points in cell order
    (their ``cell`` ids), which lets its warps skip edges; the rows are the
    same."""
    from spatialflink_tpu_torch.ops import hopper_kernels as HK

    cell = points.cell if num_cells > 0 else None
    return HK.pip_lattice(points.x, points.y, geoms.edges, geoms.edge_mask,
                          geoms.is_areal, cell=cell, num_cells=num_cells)


def _bbox_rows(points, geoms):
    """(Q, N) point -> bbox distance of each query geometry (approximate
    mode's distance)."""
    b = geoms.bbox
    return D.point_bbox_dist(points.x[None, :], points.y[None, :],
                             b[:, 0, None], b[:, 1, None], b[:, 2, None],
                             b[:, 3, None])


def knn_points_to_geom_queries(points, geoms, nb_masks, *, k: int,
                               num_ids=None, approximate: bool = False):
    """kNN of each of Q geometry QUERIES (``geoms``, one row each) over one
    point-window batch: ``(KnnResult with (Q, k) fields, dist_evals (Q,))``.
    ``nb_masks`` is the (Q, n*n) neighbouring-cells mask per query. Exact
    mode takes the distances from the K4x lattice, approximate mode the
    bbox distances; the selection is K2's."""
    from spatialflink_tpu_torch.ops import knn as K

    d = (_bbox_rows(points, geoms) if approximate
         else _lattice(points, geoms, nb_masks.shape[-1]))
    return K.knn_masked_stats(points, d, nb_masks, k=k, num_ids=num_ids)


def range_points_to_geom_queries(points, queries, gn_masks, cn_masks, radius,
                                 *, approximate: bool = False):
    """Range filter of Q geometry QUERIES over one point-window batch:
    ``(masks (Q, N), gn_bypassed (Q,), dist_evals (Q,))``. Exact mode takes
    the distances from the K4x lattice; approximate mode the bbox distance,
    which still passes through the radius check (as the single path and the
    JAX package do). The filter is K1's mask mode with a query axis."""
    d = (_bbox_rows(points, queries) if approximate
         else _lattice(points, queries, gn_masks.shape[-1]))
    return R.range_filter_masks_stats(points, gn_masks, cn_masks, d, radius)


# ------------------------------------------------------------------------ #
# polygon / linestring streams: K5


MODE_RANGE = 0  # K5 writes the range mask and the pruning counts
MODE_KNN = 1    # K5 writes the kNN eligibility and its count
#: (G, E, Eq) pairs per tile of the plain versions
_PLAIN_PAIRS = 1 << 22
#: query edges K5 stages in shared memory; above it the kernel reads them
#: from device memory
QUERY_CHUNK = 1024
#: f32 operations of K5 per (geometry edge, query edge) pair: four clamped
#: point-segment projections (16 each), four orientations (5 each), the
#: crossing test (7), three mins and a select (4), the vertex ray test (9)
OPS_PER_EDGE_PAIR = 104
#: ... per (query vertex, geometry edge) pair of the containment test
OPS_PER_VERTEX_EDGE = 9
#: ... per (query point, geometry edge) pair of the point mode (as K4's)
OPS_PER_POINT_EDGE = 26


def geom_cells_all_within(cells, cells_mask, target_mask):
    """(G,) True iff ALL of a geometry's grid cells fall inside
    ``target_mask`` (n*n,) and it has at least one cell: the reference's
    GN-subset rule (a polygon is a guaranteed result only if every cell it
    overlaps is guaranteed)."""
    hit = target_mask[torch.clamp_min(cells, 0).long()] | ~cells_mask
    return hit.all(dim=-1) & cells_mask.any(dim=-1)


def geom_cells_any_within(cells, cells_mask, target_mask):
    """(G,) True iff ANY of a geometry's cells falls inside
    ``target_mask`` (candidate membership of multi-cell geometries)."""
    hit = target_mask[torch.clamp_min(cells, 0).long()] & cells_mask
    return hit.any(dim=-1)


def _geom_elig_multi(geoms, nb_masks):
    """(Q, G) kNN eligibility of each geometry for each query: valid and
    ANY overlapped cell inside that query's neighbouring-cells mask."""
    hit = nb_masks[:, torch.clamp_min(geoms.cells, 0).long()]  # (Q, G, C)
    return geoms.valid[None, :] & (hit & geoms.cells_mask[None]).any(dim=-1)


def geoms_bbox_dist(geoms, q_bbox):
    """(G,) bbox-bbox distance to a query bbox (approximate mode)."""
    return D.bbox_bbox_dist(geoms.bbox, q_bbox[None, :])


def point_to_geoms_dist(px, py, geoms):
    """(G,) distance from ONE query point (0-d f32 tensors) to each
    geometry: 0 inside an areal one, else the min boundary distance; a
    geometry without valid edges gives sqrt(3.4e38)."""
    e = geoms.edges
    d2 = D.point_segment_dist2(px, py, e[..., 0], e[..., 1], e[..., 2],
                               e[..., 3])
    bdist = torch.sqrt(torch.where(geoms.edge_mask, d2, _BIG).amin(dim=-1))
    inside = D.point_in_rings(px, py, e, geoms.edge_mask)
    return torch.where(inside & geoms.is_areal, 0.0, bdist)


def geoms_to_single_geom_dist(geoms, q_edges, q_mask, q_areal):
    """(G,) distance from each geometry to ONE query geometry (q_edges
    (Eq, 4), q_mask (Eq,), q_areal a bool or 0-d bool tensor). A crossing
    gives 0 through the segment-segment term; containment with disjoint
    boundaries through the vertex tests over ALL valid vertices (each
    edge's first endpoint) on both sides, so a multi-part geometry with one
    part far and one inside is 0. A geometry without valid edges gives
    sqrt(3.4e38). Tiled over G."""
    n_geoms, n_edges = geoms.edge_mask.shape
    step = max(1, _PLAIN_PAIRS // max(1, n_edges * q_mask.shape[0]))
    parts = []
    for lo in range(0, n_geoms, step):
        e = geoms.edges[lo:lo + step]
        m = geoms.edge_mask[lo:lo + step]
        bdist2 = D.edges_edges_dist2(e, m, q_edges, q_mask)
        g_in_q = D.point_in_rings(e[..., 0:1], e[..., 1:2],
                                  q_edges[None, None], q_mask[None, None])
        g_in_q = (g_in_q & m).any(dim=-1) & q_areal
        q_in_g = D.point_in_rings(q_edges[None, :, 0:1],
                                  q_edges[None, :, 1:2], e[:, None],
                                  m[:, None])
        q_in_g = (q_in_g & q_mask[None, :]).any(dim=-1) \
            & geoms.is_areal[lo:lo + step]
        zero = (g_in_q | q_in_g) & m.any(dim=-1)
        parts.append(torch.where(zero, 0.0, torch.sqrt(bdist2)))
    if not parts:
        return geoms.bbox.new_empty((0,))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _take(geoms, idx):
    """The geometries at positions ``idx`` as a batch of the same type."""
    return type(geoms)(*(t[idx] for t in geoms))


def _query_kind(qx, queries) -> str:
    if (qx is None) == (queries is None):
        raise ValueError("geom_stream_dist: pass exactly one of query "
                         "points (qx, qy) and query geometries (queries)")
    return "point" if queries is None else "geometry"


def geom_stream_dist_plain(geoms, *, mode: int, nb, gn=None, qx=None,
                           qy=None, queries=None, radius: float = 0.0,
                           approximate: bool = False):
    """Plain version of :func:`geom_stream_dist`: the same three outputs,
    query by query. Distances are computed for the consulted geometries
    only (gathered), exactly as the JAX package computes them for all."""
    kind = _query_kind(qx, queries)
    if mode not in (MODE_RANGE, MODE_KNN):
        raise ValueError(f"geom_stream_dist: unknown mode {mode}")
    flags, dists, counts = [], [], []
    elig = _geom_elig_multi(geoms, nb)  # valid & any_nb
    for q in range(nb.shape[0]):
        any_nb = elig[q]
        if mode == MODE_RANGE:
            all_gn = geom_cells_all_within(geoms.cells, geoms.cells_mask,
                                           gn[q])
            consulted = geoms.valid & any_nb & ~all_gn
        else:
            consulted = any_nb
        d = torch.full(geoms.valid.shape, math.inf, dtype=torch.float32,
                       device=geoms.valid.device)
        idx = torch.nonzero(consulted).reshape(-1)
        if idx.numel():
            sub = _take(geoms, idx)
            if kind == "point" and approximate:
                b = sub.bbox
                dq = D.point_bbox_dist(qx[q], qy[q], b[:, 0], b[:, 1],
                                       b[:, 2], b[:, 3])
            elif kind == "point":
                dq = point_to_geoms_dist(qx[q], qy[q], sub)
            elif approximate:
                dq = geoms_bbox_dist(sub, queries.bbox[q])
            else:
                dq = geoms_to_single_geom_dist(
                    sub, queries.edges[q], queries.edge_mask[q],
                    queries.is_areal[q])
            d[idx] = dq
        if mode == MODE_RANGE:
            flag, gn_c, evals = R.range_filter_geom_stream_stats(
                all_gn, any_nb, d, radius, geoms.valid)
        else:
            flag = consulted
            gn_c = torch.zeros((), dtype=torch.int32, device=d.device)
            evals = consulted.sum(dtype=torch.int32)
        flags.append(flag)
        dists.append(d)
        counts.append(torch.stack([gn_c, evals]))
    return torch.stack(flags), torch.stack(dists), torch.stack(counts)


_C = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_I, _I, _I, _I, _I, _I, _I, _I, _I, _C, _C, _C, _C, _C, _C, _C,
             _C, _C, _C, _C, _C, _C, _C, _C, ctypes.c_float, _C, _C, _C, _C)


def _require(t, name, dtype, shape, dev):
    if t is None:
        raise ValueError(f"geom_stream_dist: {name} is required")
    if t.device != dev:
        raise ValueError(f"geom_stream_dist: {name} on {t.device}, "
                         f"geometries on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"geom_stream_dist: {name} is {t.dtype}, needs "
                        f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"geom_stream_dist: {name} shape {tuple(t.shape)}, "
                         f"needs {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"geom_stream_dist: {name} is not contiguous")
    return t.data_ptr()


def geom_stream_dist(geoms, *, mode: int, nb, gn=None, qx=None, qy=None,
                     queries=None, radius: float = 0.0,
                     approximate: bool = False):
    """K5 over one window of G stream geometries (an
    :class:`EdgeGeomBatch`) against Q query points (``qx``, ``qy`` (Q,)
    f32) or Q query geometries (``queries``, an exact-capacity
    :class:`EdgeGeomBatch`), with the (Q, n*n) neighbouring-cell masks
    ``nb`` (and, for a range query, the guaranteed-cell masks ``gn``).
    Returns ``(flag (Q, G) bool, dist (Q, G) f32, counts (Q, 2) int32)``:

    - ``MODE_RANGE``: flag = valid & (all_gn | (any_nb & ~all_gn & d <=
      radius)), counts = [gn_bypassed, dist_evals];
    - ``MODE_KNN``: flag = valid & any_nb (the eligibility K2 takes),
      counts = [0, eligible count].

    ``dist`` is the distance where the rule consults it (range: valid &
    any_nb & ~all_gn; kNN: the eligible slots) and +inf elsewhere; the
    bbox distance in ``approximate`` mode. CPU tensors run
    :func:`geom_stream_dist_plain`; CUDA tensors launch ``csrc/geom_dist.cu``
    or raise."""
    kind = _query_kind(qx, queries)
    if mode not in (MODE_RANGE, MODE_KNN):
        raise ValueError(f"geom_stream_dist: unknown mode {mode}")
    if mode == MODE_RANGE and gn is None:
        raise ValueError("geom_stream_dist: a range query needs gn")
    dev = geoms.valid.device
    if dev.type == "cpu":
        return geom_stream_dist_plain(
            geoms, mode=mode, nb=nb, gn=gn, qx=qx, qy=qy, queries=queries,
            radius=radius, approximate=approximate)
    n_geoms, n_edges = geoms.edge_mask.shape
    n_cells = geoms.cells.shape[1]
    n_q, grid_cells = nb.shape
    p = {name: _require(getattr(geoms, name), name, dt, shape, dev)
         for name, dt, shape in (
             ("edges", torch.float32, (n_geoms, n_edges, 4)),
             ("edge_mask", torch.bool, (n_geoms, n_edges)),
             ("bbox", torch.float32, (n_geoms, 4)),
             ("cells", torch.int32, (n_geoms, n_cells)),
             ("cells_mask", torch.bool, (n_geoms, n_cells)),
             ("is_areal", torch.bool, (n_geoms,)),
             ("valid", torch.bool, (n_geoms,)))}
    p["nb"] = _require(nb, "nb", torch.bool, (n_q, grid_cells), dev)
    p["gn"] = (None if mode == MODE_KNN else
               _require(gn, "gn", torch.bool, (n_q, grid_cells), dev))
    n_qedges = 0
    p.update(qx=None, qy=None, q_edges=None, q_mask=None, q_areal=None,
             q_bbox=None)
    if kind == "point":
        p["qx"] = _require(qx, "qx", torch.float32, (n_q,), dev)
        p["qy"] = _require(qy, "qy", torch.float32, (n_q,), dev)
    else:
        n_qedges = queries.edge_mask.shape[1]
        p["q_edges"] = _require(queries.edges, "queries.edges",
                                torch.float32, (n_q, n_qedges, 4), dev)
        p["q_mask"] = _require(queries.edge_mask, "queries.edge_mask",
                               torch.bool, (n_q, n_qedges), dev)
        p["q_areal"] = _require(queries.is_areal, "queries.is_areal",
                                torch.bool, (n_q,), dev)
        p["q_bbox"] = _require(queries.bbox, "queries.bbox", torch.float32,
                               (n_q, 4), dev)
    flag = torch.empty((n_q, n_geoms), dtype=torch.bool, device=dev)
    dist = torch.empty((n_q, n_geoms), dtype=torch.float32, device=dev)
    counts = torch.empty((n_q, 2), dtype=torch.int32, device=dev)
    launch = native.function("geom_dist", "geom_dist_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = launch(mode, int(bool(approximate)), int(kind == "geometry"),
                     n_geoms, n_edges, n_cells, n_q, n_qedges, grid_cells,
                     p["edges"], p["edge_mask"], p["bbox"], p["cells"],
                     p["cells_mask"], p["is_areal"], p["valid"], p["qx"],
                     p["qy"], p["q_edges"], p["q_mask"], p["q_areal"],
                     p["q_bbox"], p["gn"], p["nb"], float(radius),
                     flag.data_ptr(), dist.data_ptr(), counts.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "geom_stream_dist")
    geom_stream_dist.launches += 1
    return flag, dist, counts


geom_stream_dist.launches = 0


def range_geoms_to_point_queries(geoms, qx, qy, gn_masks, nb_masks, radius,
                                 *, approximate: bool = False):
    """Range filter of Q query POINTS over one polygon/linestring window
    batch in one K5 launch: ``(masks (Q, G), gn_bypassed (Q,),
    dist_evals (Q,))``, the GN-subset rule applied per query."""
    flag, _, counts = geom_stream_dist(
        geoms, mode=MODE_RANGE, gn=gn_masks, nb=nb_masks, qx=qx, qy=qy,
        radius=radius, approximate=approximate)
    return flag, counts[:, 0], counts[:, 1]


def range_geoms_to_geom_queries(geoms, queries, gn_masks, nb_masks, radius,
                                *, approximate: bool = False):
    """Range filter of Q query GEOMETRIES (one exact-capacity edge batch)
    over one polygon/linestring window batch in one K5 launch."""
    flag, _, counts = geom_stream_dist(
        geoms, mode=MODE_RANGE, gn=gn_masks, nb=nb_masks, queries=queries,
        radius=radius, approximate=approximate)
    return flag, counts[:, 0], counts[:, 1]


def knn_geoms_to_point_queries(geoms, qx, qy, nb_masks, *, k: int,
                               num_ids=None, approximate: bool = False):
    """kNN of Q query POINTS over one polygon/linestring window batch: K5's
    eligibility and distances, then K2's eligible mode. Returns
    ``(KnnResult with (Q, k) fields, dist_evals (Q,))``."""
    from spatialflink_tpu_torch.ops import knn as K

    flag, dist, _ = geom_stream_dist(geoms, mode=MODE_KNN, nb=nb_masks,
                                     qx=qx, qy=qy, approximate=approximate)
    return K.knn_eligible_stats(geoms.obj_id, dist, flag, k=k,
                                num_ids=num_ids)


def knn_geoms_to_geom_queries(geoms, queries, nb_masks, *, k: int,
                              num_ids=None, approximate: bool = False):
    """kNN of Q query GEOMETRIES over one polygon/linestring window batch:
    K5 then K2, as :func:`knn_geoms_to_point_queries`."""
    from spatialflink_tpu_torch.ops import knn as K

    flag, dist, _ = geom_stream_dist(geoms, mode=MODE_KNN, nb=nb_masks,
                                     queries=queries, approximate=approximate)
    return K.knn_eligible_stats(geoms.obj_id, dist, flag, k=k,
                                num_ids=num_ids)
