"""K1: range-query window filter (port of ``spatialflink_tpu.ops.range``:
``range_filter_point_stats``, ``range_filter_masks_stats`` and their Q-row
forms ``range_filter_point_multi_masks`` and the vmapped
``range_filter_masks_stats`` of ``ops/geom.py``
``range_points_to_geom_queries``).

Per window, for each point: guaranteed-cell (GN) points pass without a
distance computation; candidate-cell (CN) points pass iff their exact
distance is <= r; approximate mode passes CN points without the check.
GN/CN membership is Chebyshev layer arithmetic for a point query and a
gather into dense (n*n,) cell masks for polygon/linestring queries.

Every point-stream function is a wrapper of ONE hand-written CUDA kernel,
``csrc/range_mask.cu`` (:func:`range_mask_stats`, with a mode argument and
a query axis: Q queries in one launch, each row equal to the single-query
launch): CUDA tensors launch it (or the call raises), CPU tensors run the
``_plain`` version beside each wrapper. There is no other path. The
geometry-stream rule (:func:`range_filter_geom_stream_stats`) is a plain
version only: on the card K5 (``ops/geom.py``) fuses it with the
distances.

The kernel replaces the XLA-fused ``range_filter_point_stats``
(``spatialflink_tpu/ops/range.py:72-96``) and ``range_filter_masks_stats``
(``:196-217``). On an H100 it is bound by bytes (13 read per point, and
per query 1 written, plus 4 when the single-query point mode is asked for
its distances); it reads each point once for all queries, with vector
loads and word stores (see the source).
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
_ARGTYPES = (_I, _I, _I, _I, _C, _C, _C, _C, _F, _F, _I, _C, _C, _C, _I, _I,
             _I, _C, _C, _C, _I, _F, _C, _C, _C, _C)


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
                     qxs=None, qys=None, q_cells=None, n: int = 1,
                     gn_layers: int = -1, cn_layers: int = -1,
                     gn_mask=None, cn_mask=None, dists=None,
                     return_dists: bool = True):
    """Launch the K1 kernel on a CUDA batch: returns ``(mask, dists or
    None, counts)``. One query — (qx, qy, q_cell) by value, or (C,) cell
    masks and an (N,) distance row — gives mask (N,) bool, dists (N,) f32
    and counts (2,) int32 = [gn_bypassed, dist_evals]; Q queries — qxs,
    qys (Q,) f32 and q_cells (Q,) int32, or (Q, C) masks and (Q, N)
    distances — give (Q, N) masks and (Q, 2) counts. ``dists`` is an
    output of the single-query point mode (None otherwise, or when
    ``return_dists`` is False: then none are written) and an input in mask
    mode."""
    dev = points.x.device
    if dev.type != "cuda":
        raise ValueError(f"range_mask_stats: points on {dev}, needs cuda")
    N = points.x.shape[0]
    _require(points.x, "x", torch.float32, (N,), dev)
    _require(points.y, "y", torch.float32, (N,), dev)
    _require(points.cell, "cell", torch.int32, (N,), dev)
    _require(points.valid, "valid", torch.bool, (N,), dev)
    null = None
    q_ptrs = (null, null, null)
    if mode == MODE_POINT:
        multi = qxs is not None
        Q = qxs.shape[0] if multi else 1
        if multi:
            _require(qxs, "qxs", torch.float32, (Q,), dev)
            _require(qys, "qys", torch.float32, (Q,), dev)
            _require(q_cells, "q_cells", torch.int32, (Q,), dev)
            q_ptrs = (qxs.data_ptr(), qys.data_ptr(), q_cells.data_ptr())
        # the Q-row form returns no distances: none are written
        dists_out = (None if multi or not return_dists else
                     torch.empty((Q, N), dtype=torch.float32, device=dev))
        ptrs = (null, null, null, 0,
                null if dists_out is None else dists_out.data_ptr())
    elif mode == MODE_MASKS:
        multi = gn_mask.dim() == 2
        Q = gn_mask.shape[0] if multi else 1
        cells = gn_mask.shape[-1]
        lead = (Q,) if multi else ()
        _require(gn_mask, "gn_mask", torch.bool, lead + (cells,), dev)
        _require(cn_mask, "cn_mask", torch.bool, lead + (cells,), dev)
        _require(dists, "dists", torch.float32, lead + (N,), dev)
        dists_out = None
        ptrs = (gn_mask.data_ptr(), cn_mask.data_ptr(), dists.data_ptr(),
                cells, null)
    else:
        raise ValueError(f"range_mask_stats: unknown mode {mode}")
    mask = torch.empty((Q, N), dtype=torch.bool, device=dev)
    counts = torch.empty((Q, 2), dtype=torch.int32, device=dev)
    launch = native.function("range_mask", "range_mask_stats_launch",
                             _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = launch(mode, int(bool(approximate)), N, Q, points.x.data_ptr(),
                     points.y.data_ptr(), points.cell.data_ptr(),
                     points.valid.data_ptr(), float(qx), float(qy),
                     int(q_cell), *q_ptrs, int(n), int(gn_layers),
                     int(cn_layers), ptrs[0], ptrs[1], ptrs[2], ptrs[3],
                     float(radius), mask.data_ptr(), ptrs[4],
                     counts.data_ptr(), stream)
    native.check(err, "range_mask_stats")
    range_mask_stats.launches += 1
    if not multi:
        return (mask[0], None if dists_out is None else dists_out[0],
                counts[0])
    return mask, dists_out, counts


range_mask_stats.launches = 0


def _count(t) -> torch.Tensor:
    return t.sum(dtype=torch.int32)


def _check_return_dists(return_dists) -> None:
    if not isinstance(return_dists, bool):
        raise TypeError(f"range_filter_point_stats: return_dists must be a "
                        f"bool, got {type(return_dists).__name__}")


def range_filter_point_stats_plain(points, qx, qy, q_cell, radius,
                                   gn_layers, cn_layers, *, n: int,
                                   approximate: bool = False,
                                   return_dists: bool = True):
    """Plain version of :func:`range_filter_point_stats`."""
    _check_return_dists(return_dists)
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
    return (mask, dists if return_dists else None,
            _count(points.valid & in_gn), dist_evals)


def range_filter_point_stats(points, qx, qy, q_cell, radius, gn_layers,
                             cn_layers, *, n: int, approximate: bool = False,
                             return_dists: bool = True):
    """Point-query range filter over a window batch with pruning counts:
    ``(mask, dists, gn_bypassed, dist_evals)``. ``dists`` holds the exact
    distance where it was computed (CN slots) and +inf elsewhere, or is
    None with ``return_dists=False`` (the kernel then writes none);
    ``gn_bypassed`` counts valid slots emitted without a distance and
    ``dist_evals`` valid CN slots whose result consulted one (0 in
    approximate mode). gn_layers / cn_layers are the grid's layer counts
    (gn_layers may be -1: no guaranteed cells)."""
    if points.x.device.type == "cpu":
        return range_filter_point_stats_plain(
            points, qx, qy, q_cell, radius, gn_layers, cn_layers, n=n,
            approximate=approximate, return_dists=return_dists)
    _check_return_dists(return_dists)
    mask, dists, counts = range_mask_stats(
        points, mode=MODE_POINT, approximate=approximate, radius=radius,
        qx=qx, qy=qy, q_cell=q_cell, n=n, gn_layers=gn_layers,
        cn_layers=cn_layers, return_dists=return_dists)
    return mask, dists, counts[0], counts[1]


def range_filter_point_multi_masks_plain(points, qx, qy, q_cell, radius,
                                        gn_layers, cn_layers, *, n: int,
                                        approximate: bool = False):
    """Plain version of :func:`range_filter_point_multi_masks`: the
    single-query plain version row by row."""
    rows = [range_filter_point_stats_plain(
        points, qx[q], qy[q], q_cell[q], radius, gn_layers, cn_layers, n=n,
        approximate=approximate) for q in range(qx.shape[0])]
    mask, _dists, gn, evals = (torch.stack(t) for t in zip(*rows))
    return mask, gn, evals


def range_filter_point_multi_masks(points, qx, qy, q_cell, radius, gn_layers,
                                   cn_layers, *, n: int,
                                   approximate: bool = False):
    """Q query points over one window batch in one launch: ``(masks (Q, N),
    gn_bypassed (Q,), dist_evals (Q,))``, row q equal to
    :func:`range_filter_point_stats` of query q (without its distances).
    ``qx``, ``qy`` (Q,) f32 and ``q_cell`` (Q,) int32 are tensors on the
    batch's device; the radius and layer counts are shared."""
    if points.x.device.type == "cpu":
        return range_filter_point_multi_masks_plain(
            points, qx, qy, q_cell, radius, gn_layers, cn_layers, n=n,
            approximate=approximate)
    mask, _, counts = range_mask_stats(
        points, mode=MODE_POINT, approximate=approximate, radius=radius,
        qxs=qx, qys=qy, q_cells=q_cell, n=n, gn_layers=gn_layers,
        cn_layers=cn_layers)
    return mask, counts[:, 0], counts[:, 1]


def range_filter_masks_stats_plain(points, gn_mask, cn_mask, dists, radius,
                                   *, approximate: bool = False):
    """Plain version of :func:`range_filter_masks_stats` (Q-row inputs run
    row by row)."""
    if gn_mask.dim() == 2:
        rows = [range_filter_masks_stats_plain(points, gn_mask[q], cn_mask[q],
                                               dists[q], radius,
                                               approximate=approximate)
                for q in range(gn_mask.shape[0])]
        return tuple(torch.stack(t) for t in zip(*rows))
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
    dist_evals)``. ``dists`` is only consulted for candidate cells. Q
    queries at once: (Q, n*n) masks and (Q, N) distances give (Q, N) masks
    and (Q,) counts, each row that of the single query."""
    if points.x.device.type == "cpu":
        return range_filter_masks_stats_plain(
            points, gn_mask, cn_mask, dists, radius, approximate=approximate)
    mask, _, counts = range_mask_stats(
        points, mode=MODE_MASKS, approximate=approximate, radius=radius,
        gn_mask=gn_mask, cn_mask=cn_mask, dists=dists)
    return mask, counts[..., 0], counts[..., 1]


def _geom_stream_mask(all_gn, any_nb, dists, radius, valid):
    return valid & (all_gn | (any_nb & ~all_gn & (dists <= radius)))


def range_filter_geom_stream(all_gn, any_nb, dists, radius, valid):
    """Range filter for polygon/linestring STREAMS against any query (plain
    version; on the card it is fused into K5, ``ops/geom.py``
    :func:`geom_stream_dist`): a geometry whose grid cells are ALL
    guaranteed passes without a distance; otherwise a geometry with a
    neighbouring cell passes iff ``dists`` (the exact geometry distance,
    or the bbox distance in approximate mode) is <= r. ``all_gn`` /
    ``any_nb`` are (G,) cell predicates (``geom.geom_cells_all_within`` /
    ``geom_cells_any_within``)."""
    return _geom_stream_mask(all_gn, any_nb, dists, radius, valid)


def range_filter_geom_stream_stats(all_gn, any_nb, dists, radius, valid):
    """:func:`range_filter_geom_stream` with its (gn_bypassed, dist_evals)
    counts: geometries passing on the all-GN rule consult no distance;
    every other valid neighbouring-cell geometry consults one (a bbox
    distance in approximate mode counts too)."""
    mask = _geom_stream_mask(all_gn, any_nb, dists, radius, valid)
    return (mask, _count(valid & all_gn),
            _count(valid & any_nb & ~all_gn))
