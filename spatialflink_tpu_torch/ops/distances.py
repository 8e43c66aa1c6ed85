"""Distance math as plain PyTorch ops (port of the planar parts of
``spatialflink_tpu.ops.distances``: point, segment, ring, box and
segment-segment distances).

The kernels' plain versions are built on these functions, and the CUDA
kernels repeat their operation order exactly: every square is written as
``d * d`` and every step is its own op (one rounding each), so a kernel
built without FMA contraction agrees with them bit for bit.

Degree-space Euclidean throughout, as the reference's hot paths.
Edge arrays are ``(..., E, 4)`` ``[x1, y1, x2, y2]`` with a boolean
``edge_mask (..., E)`` that excludes padded edges.
"""

from __future__ import annotations

import torch

#: the smallest normal f32 (a squared segment length below it is zero)
FLT_MIN = 1.17549435e-38


def pp_dist2(x1, y1, x2, y2):
    """Squared point-point distance."""
    dx = x2 - x1
    dy = y2 - y1
    return dx * dx + dy * dy


def pp_dist(x1, y1, x2, y2):
    """Euclidean point-point distance (degree space)."""
    return torch.sqrt(pp_dist2(x1, y1, x2, y2))


def point_segment_dist2(px, py, x1, y1, x2, y2):
    """Squared min distance from a point to a segment, branchless; a
    zero-length segment (squared length under :data:`FLT_MIN`) degrades to
    the point distance. The reciprocal is
    taken on the edge shape, so in a (points x edges) broadcast the divide
    runs once per edge and the per-point work is multiply/add only."""
    cx = x2 - x1
    cy = y2 - y1
    len_sq = cx * cx + cy * cy
    # a subnormal squared length counts as zero, as XLA (which flushes
    # subnormals) has it: its reciprocal would overflow, and 0 * inf is NaN
    pos = len_sq >= FLT_MIN
    inv_len = torch.where(pos, torch.reciprocal(torch.where(pos, len_sq, 1.0)),
                          0.0)
    dot = (px - x1) * cx + (py - y1) * cy
    t = torch.clamp(dot * inv_len, 0.0, 1.0)
    qx = x1 + t * cx
    qy = y1 + t * cy
    return pp_dist2(px, py, qx, qy)


def point_in_rings(px, py, edges, edge_mask):
    """Even-odd ray-cast containment over a masked edge array, half-open on
    y. Every ring contributes its own closed edge loop, so holes fall out
    of the crossing parity; horizontal and masked edges never cross. The
    slope is taken on the edge shape (the divide runs once per edge)."""
    x1, y1 = edges[..., 0], edges[..., 1]
    x2, y2 = edges[..., 2], edges[..., 3]
    straddles = (y1 > py) != (y2 > py)
    denom = torch.where(y2 == y1, 1.0, y2 - y1)
    slope = (x2 - x1) / denom
    x_at_y = x1 + (py - y1) * slope
    crossing = straddles & edge_mask & (px < x_at_y)
    return crossing.sum(dim=-1, dtype=torch.int32) % 2 == 1


def point_bbox_dist(px, py, bx1, by1, bx2, by2):
    """Min distance from a point to an axis-aligned box; 0 inside."""
    dx = torch.clamp_min(torch.maximum(bx1 - px, px - bx2), 0.0)
    dy = torch.clamp_min(torch.maximum(by1 - py, py - by2), 0.0)
    return torch.sqrt(dx * dx + dy * dy)


def bbox_bbox_dist(a, b):
    """Min distance between two boxes given as (..., 4) [minx, miny, maxx,
    maxy]; 0 when they overlap."""
    ax1, ay1, ax2, ay2 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx1, by1, bx2, by2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    dx = torch.clamp_min(torch.maximum(ax1 - bx2, bx1 - ax2), 0.0)
    dy = torch.clamp_min(torch.maximum(ay1 - by2, by1 - ay2), 0.0)
    return torch.sqrt(dx * dx + dy * dy)


def _orient(ax, ay, bx, by, cx, cy):
    """Sign of the cross product (b - a) x (c - a): two rounded products
    and a rounded difference."""
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def segments_intersect(a, b):
    """Proper crossing of segments a = (..., 4) [x1, y1, x2, y2] and b,
    broadcasting over leading dims. Touching and collinear cases are left to
    :func:`seg_seg_dist2`'s endpoint terms (distance 0 when an endpoint
    lies on the other segment)."""
    ax1, ay1, ax2, ay2 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx1, by1, bx2, by2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    d1 = _orient(bx1, by1, bx2, by2, ax1, ay1)
    d2 = _orient(bx1, by1, bx2, by2, ax2, ay2)
    d3 = _orient(ax1, ay1, ax2, ay2, bx1, by1)
    d4 = _orient(ax1, ay1, ax2, ay2, bx2, by2)
    return ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))


def seg_seg_dist2(a, b):
    """Squared min distance between two segments; 0 if they cross."""
    d2 = torch.minimum(
        torch.minimum(
            point_segment_dist2(a[..., 0], a[..., 1], b[..., 0], b[..., 1],
                                b[..., 2], b[..., 3]),
            point_segment_dist2(a[..., 2], a[..., 3], b[..., 0], b[..., 1],
                                b[..., 2], b[..., 3])),
        torch.minimum(
            point_segment_dist2(b[..., 0], b[..., 1], a[..., 0], a[..., 1],
                                a[..., 2], a[..., 3]),
            point_segment_dist2(b[..., 2], b[..., 3], a[..., 0], a[..., 1],
                                a[..., 2], a[..., 3])))
    return torch.where(segments_intersect(a, b), 0.0, d2)


def edges_edges_dist2(edges_a, mask_a, edges_b, mask_b):
    """Squared min distance between two masked edge sets (boundary to
    boundary): edges (..., Ea, 4) and (..., Eb, 4) with their masks give
    (...,); no valid pair gives 3.4e38. The (Ea, Eb) pairs are built
    whole: callers tile the leading axes."""
    d2 = seg_seg_dist2(edges_a[..., :, None, :], edges_b[..., None, :, :])
    valid = mask_a[..., :, None] & mask_b[..., None, :]
    return torch.where(valid, d2, 3.4e38).amin(dim=(-2, -1))
