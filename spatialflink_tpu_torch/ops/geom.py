"""Point -> query geometry distances (port of the parts of
``spatialflink_tpu.ops.geom`` that the point-stream x polygon/linestring
range and kNN queries run): ONE query geometry through the K4 kernel, and
Q query geometries through the (N, G) lattice of the K4x kernel, which the
multi-query entries consume as (Q, N).

JTS distance semantics: point -> polygon is 0 inside the areal geometry,
else the min boundary distance; point -> linestring is the min boundary
distance.
"""

from __future__ import annotations

import torch

from spatialflink_tpu_torch.ops import distances as D

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
    from spatialflink_tpu_torch.ops import range as R

    d = (_bbox_rows(points, queries) if approximate
         else _lattice(points, queries, gn_masks.shape[-1]))
    return R.range_filter_masks_stats(points, gn_masks, cn_masks, d, radius)
