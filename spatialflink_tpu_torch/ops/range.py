"""K1: range-query window filter (port of ``spatialflink_tpu.ops.range``:
``range_filter_point_stats`` and ``range_filter_masks_stats``).

Per window, for each point: guaranteed-cell (GN) points pass without a
distance computation; candidate-cell (CN) points pass iff their exact
distance is <= r; approximate mode passes CN points without the check.
GN/CN membership is Chebyshev layer arithmetic for a point query and a
gather into dense (n*n,) cell masks for polygon/linestring queries.

Both public functions are wrappers of ONE hand-written CUDA kernel,
``csrc/range_mask.cu`` (:func:`range_mask_stats`, with a mode argument):
CUDA tensors launch it (or the call raises), CPU tensors run the ``_plain``
version beside each wrapper. There is no other path.

The kernel replaces the XLA-fused ``range_filter_point_stats``
(``spatialflink_tpu/ops/range.py:72-96``) and ``range_filter_masks_stats``
(``:196-217``). On an H100 it is bound by bytes (13 read + 5 written per
point in point mode); it reads each input once in a grid-stride pass and
reduces its two counts per block before one atomicAdd each (see the source).
"""

from __future__ import annotations

import ctypes
import math

import torch

from spatialflink_tpu_torch.index.uniform_grid import cheb_layers
from spatialflink_tpu_torch.ops import distances as D
from spatialflink_tpu_torch.ops import native

MODE_POINT = 0
MODE_MASKS = 1
#: f32/int operations per point in the kernel: point mode (layers: 4 div/
#: rem, 2 sub, 2 abs, max, 3 compares; distance: 2 sub, 2 mul, add, sqrt,
#: compare; select + 3 and/or) and mask mode (2 gathers, compares, and/or)
OPS_PER_POINT = {MODE_POINT: 24, MODE_MASKS: 10}

_C = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = (_I, _I, _I, _C, _C, _C, _C, _F, _F, _I, _I, _I, _I, _C, _C, _C,
             _I, _F, _C, _C, _C, _C)


def _require(t, name, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"range_mask_stats: {name} on {t.device}, "
                         f"points on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"range_mask_stats: {name} is {t.dtype}, needs {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"range_mask_stats: {name} shape {tuple(t.shape)}, "
                         f"needs {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"range_mask_stats: {name} is not contiguous")


def range_mask_stats(points, *, mode: int, approximate: bool, radius: float,
                     qx: float = 0.0, qy: float = 0.0, q_cell: int = -1,
                     n: int = 1, gn_layers: int = -1, cn_layers: int = -1,
                     gn_mask=None, cn_mask=None, dists=None):
    """Launch the K1 kernel on a CUDA batch: returns ``(mask (N,) bool,
    dists (N,) f32 or None, counts (2,) int32 = [gn_bypassed,
    dist_evals])``. ``dists`` is an output in point mode and an input in
    mask mode."""
    dev = points.x.device
    if dev.type != "cuda":
        raise ValueError(f"range_mask_stats: points on {dev}, needs cuda")
    N = points.x.shape[0]
    _require(points.x, "x", torch.float32, (N,), dev)
    _require(points.y, "y", torch.float32, (N,), dev)
    _require(points.cell, "cell", torch.int32, (N,), dev)
    _require(points.valid, "valid", torch.bool, (N,), dev)
    mask = torch.empty(N, dtype=torch.bool, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    null = None
    if mode == MODE_POINT:
        dists_out = torch.empty(N, dtype=torch.float32, device=dev)
        ptrs = (null, null, null, 0, dists_out.data_ptr())
    elif mode == MODE_MASKS:
        cells = gn_mask.shape[0]
        _require(gn_mask, "gn_mask", torch.bool, (cells,), dev)
        _require(cn_mask, "cn_mask", torch.bool, (cells,), dev)
        _require(dists, "dists", torch.float32, (N,), dev)
        dists_out = None
        ptrs = (gn_mask.data_ptr(), cn_mask.data_ptr(), dists.data_ptr(),
                cells, null)
    else:
        raise ValueError(f"range_mask_stats: unknown mode {mode}")
    launch = native.function("range_mask", "range_mask_stats_launch",
                             _ARGTYPES)
    with torch.cuda.device(dev):
        err = launch(mode, int(bool(approximate)), N, points.x.data_ptr(),
                     points.y.data_ptr(), points.cell.data_ptr(),
                     points.valid.data_ptr(), float(qx), float(qy),
                     int(q_cell), int(n), int(gn_layers), int(cn_layers),
                     ptrs[0], ptrs[1], ptrs[2], ptrs[3], float(radius),
                     mask.data_ptr(), ptrs[4], counts.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "range_mask_stats")
    range_mask_stats.launches += 1
    return mask, dists_out, counts


range_mask_stats.launches = 0


def _count(t) -> torch.Tensor:
    return t.sum(dtype=torch.int32)


def range_filter_point_stats_plain(points, qx, qy, q_cell, radius,
                                   gn_layers, cn_layers, *, n: int,
                                   approximate: bool = False):
    """Plain version of :func:`range_filter_point_stats`."""
    layers = cheb_layers(points.cell, q_cell, n)
    in_gn = layers <= gn_layers  # gn_layers == -1 -> all False
    in_cn = (layers <= cn_layers) & ~in_gn
    if approximate:
        mask = points.valid & (in_gn | in_cn)
        dists = torch.full_like(points.x, math.inf)
        dist_evals = torch.zeros((), dtype=torch.int32,
                                 device=points.x.device)
    else:
        d = D.pp_dist(points.x, points.y, qx, qy)
        mask = points.valid & (in_gn | (in_cn & (d <= radius)))
        dists = torch.where(in_cn, d, math.inf)
        dist_evals = _count(points.valid & in_cn)
    return mask, dists, _count(points.valid & in_gn), dist_evals


def range_filter_point_stats(points, qx, qy, q_cell, radius, gn_layers,
                             cn_layers, *, n: int, approximate: bool = False):
    """Point-query range filter over a window batch with pruning counts:
    ``(mask, dists, gn_bypassed, dist_evals)``. ``dists`` holds the exact
    distance where it was computed (CN slots) and +inf elsewhere;
    ``gn_bypassed`` counts valid slots emitted without a distance and
    ``dist_evals`` valid CN slots whose result consulted one (0 in
    approximate mode). gn_layers / cn_layers are the grid's layer counts
    (gn_layers may be -1: no guaranteed cells)."""
    if points.x.device.type == "cpu":
        return range_filter_point_stats_plain(
            points, qx, qy, q_cell, radius, gn_layers, cn_layers, n=n,
            approximate=approximate)
    mask, dists, counts = range_mask_stats(
        points, mode=MODE_POINT, approximate=approximate, radius=radius,
        qx=qx, qy=qy, q_cell=q_cell, n=n, gn_layers=gn_layers,
        cn_layers=cn_layers)
    return mask, dists, counts[0], counts[1]


def range_filter_masks_stats_plain(points, gn_mask, cn_mask, dists, radius,
                                   *, approximate: bool = False):
    """Plain version of :func:`range_filter_masks_stats`."""
    cell_ok = points.cell >= 0
    cell = torch.clamp_min(points.cell, 0)  # guard the -1 pad; gated below
    in_gn = torch.index_select(gn_mask, 0, cell) & cell_ok
    in_cn = torch.index_select(cn_mask, 0, cell) & cell_ok & ~in_gn
    if approximate:
        mask = points.valid & (in_gn | in_cn)
        dist_evals = torch.zeros((), dtype=torch.int32,
                                 device=points.x.device)
    else:
        mask = points.valid & (in_gn | (in_cn & (dists <= radius)))
        dist_evals = _count(points.valid & in_cn)
    return mask, _count(points.valid & in_gn), dist_evals


def range_filter_masks_stats(points, gn_mask, cn_mask, dists, radius, *,
                             approximate: bool = False):
    """Range filter with dense (n*n,) GN/CN cell masks and precomputed
    per-slot distances (polygon/linestring queries): ``(mask, gn_bypassed,
    dist_evals)``. ``dists`` is only consulted for candidate cells."""
    if points.x.device.type == "cpu":
        return range_filter_masks_stats_plain(
            points, gn_mask, cn_mask, dists, radius, approximate=approximate)
    mask, _, counts = range_mask_stats(
        points, mode=MODE_MASKS, approximate=approximate, radius=radius,
        gn_mask=gn_mask, cn_mask=cn_mask, dists=dists)
    return mask, counts[0], counts[1]
