"""Point -> ONE query geometry distance (port of the two functions of
``spatialflink_tpu.ops.geom`` that the point-stream x polygon/linestring
range query runs).

JTS distance semantics: point -> polygon is 0 inside the areal geometry,
else the min boundary distance; point -> linestring is the min boundary
distance.
"""

from __future__ import annotations

import torch

from spatialflink_tpu_torch.ops import distances as D

_BIG = 3.4e38  # "infinitely far" sentinel that survives f32 math


def points_to_single_geom_dist(points, edges, edge_mask, is_areal: bool):
    """(N,) distance from every point of a batch to ONE query geometry,
    through the K4 kernel wrapper (its plain version on CPU tensors)."""
    from spatialflink_tpu_torch.ops import hopper_kernels as HK

    return HK.pip_dist(points.x, points.y, edges, edge_mask, bool(is_areal))


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
