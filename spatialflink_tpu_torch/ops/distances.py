"""Distance math as plain PyTorch ops (port of the parts of
``spatialflink_tpu.ops.distances`` that the range slice uses).

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
    zero-length segment degrades to the point distance. The reciprocal is
    taken on the edge shape, so in a (points x edges) broadcast the divide
    runs once per edge and the per-point work is multiply/add only."""
    cx = x2 - x1
    cy = y2 - y1
    len_sq = cx * cx + cy * cy
    pos = len_sq > 0
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
