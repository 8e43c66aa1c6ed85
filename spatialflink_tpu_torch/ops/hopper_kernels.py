"""K4 and K4x: fused point-in-polygon + min boundary distance, to ONE query
geometry (port of ``spatialflink_tpu.ops.pallas_kernels.pip_dist``) and to
each of G geometries (the lattice of ``spatialflink_tpu.ops.geom
.points_to_geoms_dist``, the function the Pallas experiment
``benchmarks/exp_pip_lattice.py`` was written to replace), and the cell
order that K4x sorts a window's points into.

- :func:`pip_dist`, :func:`pip_lattice` and :func:`cell_order` are the
  wrappers. CUDA tensors go through the hand-written kernels
  ``csrc/pip_dist.cu``, ``csrc/pip_lattice.cu`` and ``csrc/cell_order.cu``
  (or the call raises); CPU tensors go through the plain versions. There
  is no other path.
- :func:`pip_dist_plain` is ``ops.geom.points_to_single_edges_raw`` (the
  JAX package's jnp twin of its Pallas kernel) plus the final select;
  :func:`pip_lattice_plain` is the port of ``points_to_edges_dist`` and
  ``points_in_geoms`` plus the per-geometry select. Both run in point
  blocks so that the (points x edges) intermediates stay bounded.
  :func:`cell_order_plain` is a stable argsort of the cell key.

K4 replaces the Pallas TPU kernel ``_pip_kernel`` / ``_pip_pallas``
(``spatialflink_tpu/ops/pallas_kernels.py:100-209``), K4x the Pallas
experiment ``build_kernel`` (``benchmarks/exp_pip_lattice.py:37-125``).
On an H100 both are bound by instruction issue (about 22 separate f32
operations per point-edge pair; the build fuses none) unless the
geometries have very few edges, where K4x's (G, N) output write bounds
it. K4, given a query's :class:`PipTable` (:func:`pip_table`, built once
per query geometry and grid when an operator sets the query up) and the
points' cell ids, folds only the edges listed for each point's cell (about
a tenth of the pairs at the main path's 64-edge polygon:
:func:`pip_table_fold_share`); without one, or above one staged chunk of
edges, it folds every pair (disjoint point ranges per block, edge chunks
staged in shared memory with the per-edge divides done once per edge).
K4x, given the points' cell ids, sorts them into cell order and lets each
warp skip the edges that provably cannot change any of its points
(:func:`distance_skip_margin`); the sources describe the designs.
:func:`pip_table_fold_plain` is the table fold as plain ops, which the CPU
tests hold equal to :func:`pip_dist_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from spatialflink_tpu_torch.ops import distances as D
from spatialflink_tpu_torch.ops import geom as G
from spatialflink_tpu_torch.ops import native
from spatialflink_tpu_torch.utils.deviceplane import instrumented_kernel

#: edges staged in shared memory per pass of the kernel's edge loop
EDGE_CHUNK = 512
#: f32 operations per (point, valid edge) pair in the kernel's inner loop:
#: ray cast (2 compares, xor, sub, mul, add, compare, and, add = 9) +
#: projection (sub, 2 mul, add, mul, max, min = 7) + distance (2 mul,
#: 2 add, 2 sub, 2 mul, add, min = 10)
OPS_PER_PAIR = 26
#: least padded edges per geometry for which K4x sorts the points into
#: cell order: below it the fold of every pair costs less than the sort and
#: the write-back through the permutation (the 4-edge rectangles of the
#: Pallas experiment's shape ran ~8x slower in cell order; PERF.md)
ORDER_MIN_EDGES = 16
#: points per block of the plain version: (block x edges) intermediates
#: stay at ~2**24 elements
_PLAIN_ELEMS = 1 << 24

#: most grid cells for which :func:`pip_table` builds a cell table (it
#: holds num_cells x (edges / 64) words of 8 bytes)
TABLE_MAX_CELLS = 1 << 20
#: most edges a cell table may list per cell on average, as a share of
#: the geometry's valid edges (:func:`pip_table_listed_share`): above it
#: the table kernel's per-point walk and divergent gathers cost more than
#: the pairs they save, and :func:`pip_table` keeps no table (the dense
#: fold runs). ``kernel_ab.py``'s sweep over grids of 2 to 100 cells a
#: side put the crossover between 0.15 and 0.22 at 64 edges and between
#: 0.12 and 0.19 at 512 (PERF.md); the conf's grid lists 0.11 of the main
#: path's 64-edge polygon.
TABLE_MAX_SHARE = 0.14
#: fewest valid edges for which :func:`pip_table` keeps a cell table: the
#: dense fold of fewer costs less than the table kernel's own reads (the
#: sweep: at 2 and 8 edges the table form lost on every grid)
TABLE_MIN_EDGES = 16

_C = ctypes.c_void_p
_ARGTYPES = (_C, _C, ctypes.c_int, _C, _C, ctypes.c_int, ctypes.c_int, _C,
             _C)
_TABLE_ARGTYPES = (_C, _C, _C, ctypes.c_int, _C, _C, ctypes.c_int,
                   ctypes.c_int, _C, ctypes.c_int, _C, ctypes.c_int, _C, _C)
_LATTICE_ARGTYPES = (_C, _C, _C, ctypes.c_int, _C, _C, ctypes.c_int, _C,
                     ctypes.c_int, ctypes.c_float, _C, _C, _C)
_ORDER_ARGTYPES = (_C, ctypes.c_int, ctypes.c_int, _C, _C, _C, _C, _C, _C, _C,
                   _C)


def _ceil_to(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


def bucket_edges(ne: int) -> int:
    """Edge-count bucket (as ``pallas_kernels.pip_dist``): multiples of 64
    up to one chunk, whole chunks beyond."""
    return _ceil_to(ne, 64) if ne <= EDGE_CHUNK else _ceil_to(ne, EDGE_CHUNK)


def pip_dist_plain(px, py, edges, edge_mask, is_areal: bool, cell=None,
                   table=None):
    """(N,) distance from each point to ONE geometry: 0 inside an areal
    geometry, else sqrt(min squared boundary distance); an empty edge set
    gives sqrt(3.4e38) ~ 1.8e19. ``cell`` and ``table`` are accepted and
    not used: the table changes which pairs the kernel folds, never the
    result."""
    n = px.shape[0]
    step = max(1, _PLAIN_ELEMS // max(1, edges.shape[0]))
    parts = []
    for lo in range(0, n, step):
        inside, mind2 = G.points_to_single_edges_raw(
            px[lo:lo + step], py[lo:lo + step], edges, edge_mask)
        parts.append(torch.where(inside & bool(is_areal), 0.0,
                                 torch.sqrt(mind2)))
    if not parts:
        return torch.empty_like(px)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _check_cuda_args(what, px, py, **tensors) -> None:
    """Device, dtype and contiguity of every argument of a CUDA launch
    (px, py f32; ``tensors`` f32 or bool), and equal 1-D point shapes."""
    dev = px.device
    for name, t in (("px", px), ("py", py), *tensors.items()):
        dtype = torch.bool if "mask" in name or name == "is_areal" \
            else torch.float32
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, px on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, needs {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if px.dim() != 1 or py.shape != px.shape:
        raise ValueError(f"{what}: px {tuple(px.shape)} / py "
                         f"{tuple(py.shape)} must be equal 1-D shapes")


def pad_edges(edges, edge_mask):
    """The edges and mask padded to :func:`bucket_edges` (masked pad
    edges), as the kernel folds them; the inputs themselves when they are
    padded already."""
    ne = edges.shape[0]
    ep = bucket_edges(ne)
    if ep == ne:
        return edges, edge_mask
    return (torch.cat([edges, edges.new_zeros((ep - ne, 4))]),
            torch.cat([edge_mask, edge_mask.new_zeros(ep - ne)]))


class PipTable(NamedTuple):
    """ONE query geometry prepared for K4 once (see :func:`pip_table`):
    its padded edges, and the per-cell edge table over a grid (``bits``
    and ``flags`` None where no table applies: more than one staged chunk
    of edges, or more than :data:`TABLE_MAX_CELLS` cells)."""

    edges: torch.Tensor           # (E, 4) f32, E = bucket_edges(...)
    edge_mask: torch.Tensor       # (E,) bool
    is_areal: bool
    bits: Optional[torch.Tensor]  # (num_cells, E / 64) int64 listed edges
    flags: Optional[torch.Tensor]  # (num_cells,) uint8: parity | inside << 1
    num_cells: int


def _check_table_args(px, edges, edge_mask, is_areal, cell, table) -> None:
    """K4's ``cell`` / ``table`` arguments: a table goes with its own
    edges, mask and is_areal, and a table with bits needs the points'
    cell ids (N,) int32 beside px."""
    if table is None:
        if cell is not None:
            raise ValueError("pip_dist: cell given without a table")
        return
    if not isinstance(table, PipTable):
        raise TypeError(f"pip_dist: table is {type(table).__name__}, needs "
                        f"PipTable (hopper_kernels.pip_table)")
    if edges is not table.edges or edge_mask is not table.edge_mask \
            or bool(is_areal) != table.is_areal:
        raise ValueError("pip_dist: pass the table's own edges, edge_mask "
                         "and is_areal with it")
    if table.bits is None:
        return
    if cell is None:
        raise ValueError("pip_dist: a cell table needs the points' cell ids")
    if cell.device != px.device:
        raise ValueError(f"pip_dist: cell on {cell.device}, px on "
                         f"{px.device}")
    if cell.dtype != torch.int32:
        raise TypeError(f"pip_dist: cell is {cell.dtype}, needs torch.int32")
    if cell.shape != px.shape:
        raise ValueError(f"pip_dist: cell {tuple(cell.shape)} and px "
                         f"{tuple(px.shape)} must be equal 1-D shapes")
    if not cell.is_contiguous():
        raise ValueError("pip_dist: cell is not contiguous")
    if table.bits.device != px.device:
        raise ValueError(f"pip_dist: table on {table.bits.device}, px on "
                         f"{px.device}")


@instrumented_kernel
def pip_dist(px, py, edges, edge_mask, is_areal: bool, cell=None,
             table=None):
    """(N,) JTS-style distance from each point to ONE query geometry (0
    inside areal geometries, else min boundary distance). CPU tensors run
    :func:`pip_dist_plain`; CUDA tensors launch the K4 kernel: with a
    :class:`PipTable` (``pip_dist(px, py, t.edges, t.edge_mask,
    t.is_areal, cell=cell, table=t)``) that has a cell table, the table
    kernel, which folds only each point's listed edges; else the dense
    fold of every pair. The result is the same."""
    _check_table_args(px, edges, edge_mask, is_areal, cell, table)
    if px.device.type == "cpu":
        return pip_dist_plain(px, py, edges, edge_mask, is_areal)
    _check_cuda_args("pip_dist", px, py, edges=edges, edge_mask=edge_mask)
    if edges.dim() != 2 or edges.shape[1] != 4 \
            or edge_mask.shape != edges.shape[:1]:
        raise ValueError(f"pip_dist: edges {tuple(edges.shape)} must be "
                         f"(E, 4) with edge_mask (E,), got "
                         f"{tuple(edge_mask.shape)}")
    edges, edge_mask = pad_edges(edges, edge_mask)  # masked in the kernel
    ep = edges.shape[0]
    dist = torch.empty_like(px)
    stream = torch.cuda.current_stream(px.device).cuda_stream
    with torch.cuda.device(px.device):
        if table is not None and table.bits is not None:
            launch = native.function("pip_dist", "pip_dist_table_launch",
                                     _TABLE_ARGTYPES)
            err = launch(px.data_ptr(), py.data_ptr(), cell.data_ptr(),
                         px.shape[0], edges.data_ptr(), edge_mask.data_ptr(),
                         ep, int(bool(is_areal)), table.bits.data_ptr(),
                         table.bits.shape[1], table.flags.data_ptr(),
                         table.num_cells, dist.data_ptr(), stream)
            pip_dist.table_launches += 1
        else:
            launch = native.function("pip_dist", "pip_dist_launch",
                                     _ARGTYPES)
            err = launch(px.data_ptr(), py.data_ptr(), px.shape[0],
                         edges.data_ptr(), edge_mask.data_ptr(), ep,
                         int(bool(is_areal)), dist.data_ptr(), stream)
    native.check(err, "pip_dist")
    pip_dist.launches += 1
    return dist


pip_dist.launches = 0
#: the launches of them that took the per-cell table form
pip_dist.table_launches = 0


def cell_margin(magnitude: float) -> float:
    """How far a point's f32 coordinates can lie outside its cell's
    nominal box, for coordinates of at most ``magnitude`` in absolute
    value: ``magnitude * 2**-21`` (8 unit roundoffs). A cell id is the
    floor of the float64 coordinate's offset over the cell length
    (``UniformGrid.assign_cell``; its roundings are of order 2**-52), and
    the device holds the coordinate rounded to f32, at most half an ulp
    (2**-24 of the magnitude) away."""
    return float(magnitude) * 2.0 ** -21


def _seg_dist(px, py, x1, y1, x2, y2):
    """Exact (float64) distance from points to segments, broadcast."""
    cx, cy = x2 - x1, y2 - y1
    ls = cx * cx + cy * cy
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(ls > 0, ((px - x1) * cx + (py - y1) * cy) / ls, 0.0)
    t = np.clip(t, 0.0, 1.0)
    return np.hypot(x1 + t * cx - px, y1 + t * cy - py)


def _table_arrays(edges, edge_mask, is_areal: bool, grid):
    """The cell table of :func:`pip_table` as host arrays: (num_cells,
    words) uint64 listed-edge bits and (num_cells,) uint8 flags."""
    ep = edges.shape[0]
    words = ep // 64
    n, L = grid.n, grid.cell_length
    idx = np.flatnonzero(edge_mask)
    e = edges[idx].astype(np.float64)
    coords = [grid.min_x, grid.min_x + n * L, grid.min_y, grid.min_y + n * L]
    mag = max(max(abs(c) for c in coords),
              float(np.abs(e).max()) if len(idx) else 0.0)
    mc, md = cell_margin(mag), distance_skip_margin(mag)
    x1, y1, x2, y2 = (e[None, :, j] for j in range(4))
    ex0, ex1 = np.minimum(x1, x2), np.maximum(x1, x2)
    ey0, ey1 = np.minimum(y1, y2), np.maximum(y1, y2)
    flat = (y1 == y2)
    cells = np.arange(n * n)
    bits = np.zeros((n * n, words * 64), bool)
    flags = np.zeros(n * n, np.uint8)
    step = max(1, (1 << 22) // max(1, len(idx)))
    for lo in range(0, n * n, step):
        c = cells[lo:lo + step]
        # each cell's box, widened by the cell-assignment margin
        X0 = (grid.min_x + (c // n) * L - mc)[:, None]
        X1 = (grid.min_x + (c // n + 1) * L + mc)[:, None]
        Y0 = (grid.min_y + (c % n) * L - mc)[:, None]
        Y1 = (grid.min_y + (c % n + 1) * L + mc)[:, None]
        # distance: an edge whose lower bound over the cell exceeds the
        # least upper bound of any edge is never a point's nearest
        gx = np.maximum(np.maximum(ex0 - X1, X0 - ex1) - md, 0.0)
        gy = np.maximum(np.maximum(ey0 - Y1, Y0 - ey1) - md, 0.0)
        lower = gx * gx + gy * gy
        far = np.maximum.reduce([_seg_dist(X, Y, x1, y1, x2, y2)
                                 for X in (X0, X1) for Y in (Y0, Y1)])
        upper = (far + md) ** 2 * (1.0 + 2.0 ** -20)
        near = lower <= upper.min(axis=1, initial=np.inf)[:, None]
        # ray cast: constant where no y in the band straddles the edge, or
        # every y does and the edge lies wholly right of the cell
        off_band = flat | (ey1 <= Y0) | (ey0 > Y1)
        spans = ~flat & (ey0 <= Y0) & (ey1 > Y1)
        left = ex1 + md < X0
        right = spans & (ex0 - md > X1)
        ray = ~off_band & ~left & ~right
        listed = near | ray
        parity = (right & ~listed).sum(axis=1) & 1
        inside = (bool(is_areal) & ~ray.any(axis=1)
                  & (right.sum(axis=1) & 1 == 1))
        listed[inside] = False
        bits[lo:lo + step, idx] = listed
        flags[lo:lo + step] = parity | (inside.astype(np.uint8) << 1)
    packed = np.packbits(bits, axis=1, bitorder="little")
    return packed.view("<u8").astype(np.int64), flags


def pip_table(edges, edge_mask, is_areal: bool, grid=None,
              gate: bool = True) -> PipTable:
    """ONE query geometry prepared for K4, once per query and grid (the
    operators build it when they set a query up): the edges padded to
    :func:`bucket_edges`, and, given the points' ``grid`` and at most one
    staged chunk of edges and :data:`TABLE_MAX_CELLS` cells, a per-cell
    edge table where it pays: at least :data:`TABLE_MIN_EDGES` valid
    edges, of which it lists at most :data:`TABLE_MAX_SHARE` per cell on
    average (:func:`pip_table_listed_share`; ``gate=False`` keeps every
    table that can be built). Built on the host in float64, moved to the
    edges' device.

    For each cell, with its box widened by :func:`cell_margin` (so that it
    holds the f32 coordinates of every point assigned to it), the table
    lists the edges that can change such a point's result (the kernel folds
    a listed edge for both its distance and its ray cast):

    - *distance*: an edge is listed unless the squared gap between the
      cell's box and the edge's box, each gap shortened by ``md =
      distance_skip_margin(M)`` (M the largest |coordinate| of the grid and
      the edges), exceeds ``(D + md)**2 * (1 + 2**-20)`` for some edge,
      where D is that edge's largest exact distance over the box (at a
      corner: a point's distance to a segment is convex). The shortened gap
      bounds the kernel's f32 d2 from below as K4x's skip does (derivation
      at :func:`distance_skip_margin`); the other side bounds its f32 d2
      from above: the computed projection lies within ~16 uM (u = 2**-24)
      of the segment and the final sum rounds by (1 + 3u), both inside md
      = 32 uM and the factor. So a skipped edge's d2 exceeds some listed
      edge's d2: the min, and its bits, are unchanged.
    - *ray cast*: y comparisons are exact in f32, so an edge no y of the
      widened band straddles (horizontal, or wholly above or below) crosses
      no ray from the cell; one that every y straddles crosses every ray if
      it lies wholly right of the cell by ``md`` (the computed x_at_y stays
      within ~11 uM of the edge's x-range), and one wholly left by ``md``
      crosses none. Every other edge is listed; the unlisted constant
      crossings give the cell's parity bit. Never decided on x without md.
    - *inside*: an areal geometry's cell with no edge that needs a ray
      cast and an odd count of edges every ray crosses lies wholly inside:
      its points get 0 without a fold.

    A min and a parity do not depend on the order of the edges, so the
    table fold (:func:`pip_table_fold_plain`) equals :func:`pip_dist_plain`
    bit for bit. Cell -1 (and a cell outside the table) folds every edge.
    """
    edges, edge_mask = pad_edges(edges.contiguous(), edge_mask.contiguous())
    if grid is None or edges.shape[0] > EDGE_CHUNK \
            or grid.num_cells > TABLE_MAX_CELLS:
        return PipTable(edges, edge_mask, bool(is_areal), None, None, 0)
    bits, flags = _table_arrays(edges.cpu().numpy(),
                                edge_mask.cpu().numpy(), bool(is_areal), grid)
    dev = edges.device
    table = PipTable(edges, edge_mask, bool(is_areal),
                     torch.from_numpy(bits).to(dev),
                     torch.from_numpy(flags).to(dev), grid.num_cells)
    if gate and (int(edge_mask.sum()) < TABLE_MIN_EDGES
                 or pip_table_listed_share(table) > TABLE_MAX_SHARE):
        return table._replace(bits=None, flags=None, num_cells=0)
    return table


def pip_table_listed_share(table) -> float:
    """The edges a cell table lists per cell, on average over its cells,
    as a share of the valid edges (0.0 without valid edges; 1.0 without a
    table: the dense fold folds them all)."""
    valid = int(table.edge_mask.sum())
    if table.bits is None:
        return 1.0
    if valid == 0 or table.num_cells == 0:
        return 0.0
    listed = int(_POPCOUNT[table.bits.cpu().contiguous().view(torch.uint8)
                           .long()].sum())
    return listed / (table.num_cells * valid)


def _listed(cell, table):
    """(N, E) bool: the edges the table kernel folds for each point (every
    valid edge for a cell outside the table), and (N,) bool in-table."""
    in_table = (cell >= 0) & (cell < table.num_cells)
    c = torch.where(in_table, cell, 0).long()
    words = table.bits[c]  # (N, W)
    shifts = torch.arange(64, device=cell.device)
    bits = ((words[:, :, None] >> shifts) & 1).bool().reshape(len(cell), -1)
    return torch.where(in_table[:, None], bits[:, :table.edges.shape[0]],
                       table.edge_mask[None, :]), in_table


def pip_table_fold_plain(px, py, cell, table):
    """The table kernel's fold as plain PyTorch ops: for each point, its
    cell's listed edges only, plus the cell's parity bit, and 0 for an
    inside cell of an areal geometry. Equals :func:`pip_dist_plain` bit
    for bit when the table is exact (the CPU tests check it)."""
    e = table.edges
    n = px.shape[0]
    step = max(1, _PLAIN_ELEMS // max(1, e.shape[0]))
    parts = []
    for lo in range(0, n, step):
        sx, sy = px[lo:lo + step, None], py[lo:lo + step, None]
        listed, in_table = _listed(cell[lo:lo + step], table)
        flag = table.flags[torch.where(in_table, cell[lo:lo + step],
                                       0).long()].int() * in_table
        d2 = D.point_segment_dist2(sx, sy, e[None, :, 0], e[None, :, 1],
                                   e[None, :, 2], e[None, :, 3])
        d2 = torch.where(listed, d2, G._BIG)
        pad = torch.full((d2.shape[0], 1), G._BIG, dtype=d2.dtype,
                         device=d2.device)
        mind2 = torch.cat([d2, pad], dim=1).amin(dim=1)
        x1, y1, x2, y2 = (e[None, :, j] for j in range(4))
        straddles = (y1 > sy) != (y2 > sy)
        denom = torch.where(y2 == y1, 1.0, y2 - y1)
        x_at_y = x1 + (sy - y1) * ((x2 - x1) / denom)
        cross = (straddles & listed & (sx < x_at_y)).sum(
            dim=1, dtype=torch.int32) + (flag & 1)
        inside = ((cross % 2 == 1) | (flag & 2 > 0)) & table.is_areal
        parts.append(torch.where(inside, 0.0, torch.sqrt(mind2)))
    if not parts:
        return torch.empty_like(px)
    return torch.cat(parts)


_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int32)


def pip_table_fold_share(cell, table) -> dict:
    """How much of the dense fold's work the table kernel does for these
    points: ``pair_share``, the (point, edge) pairs it folds over N x the
    valid edges, and ``warp_share``, the pairs a warp folds when it runs
    its longest lane at each of its points in turn (the kernel's layout
    up to 64 edges: 4 points per thread, 256 apart, blocks of 1,024
    points) over the dense fold's 4 x valid edges per lane."""
    valid = int(table.edge_mask.sum())
    n = cell.shape[0]
    if table.bits is None or valid == 0 or n == 0:
        return {"pair_share": 1.0, "warp_share": 1.0, "valid_edges": valid}
    in_table = (cell >= 0) & (cell < table.num_cells)
    c = torch.where(in_table, cell, 0).long()
    lut = _POPCOUNT.to(cell.device)
    per_cell = lut[table.bits.contiguous().view(torch.uint8).long()].view(
        table.num_cells, -1).sum(dim=1)
    folds = torch.where(in_table, per_cell[c], valid)
    blocks = -(-n // 1024)
    lanes = torch.zeros(blocks * 1024, dtype=folds.dtype, device=cell.device)
    lanes[:n] = folds
    per_point = lanes.view(blocks, 4, 8, 32).amax(dim=3)
    return {"pair_share": float(folds.sum()) / (n * valid),
            "warp_share": float(per_point.sum()) / (blocks * 8 * 4 * valid),
            "valid_edges": valid}


def distance_skip_margin(magnitude: float = 1.0) -> float:
    """The absolute f32 rounding margin of K4x's distance skip for
    coordinates of at most ``magnitude`` in absolute value:
    ``magnitude * 2**-19`` (32 unit roundoffs u = 2**-24). The wrapper
    passes ``distance_skip_margin(1.0)``; the kernel multiplies it by the
    largest |coordinate| of a lane's points and of an edge, and widens each
    box by its own part.

    Why it is enough. Let M bound every |coordinate| of the point P, the
    edge (A, B) and the lane's box. The plain formula computes cx = fl(x2 -
    x1), t in [0, 1] (clamped, so S = A + t (B - A) lies on the segment
    exactly), qx = fl(x1 + fl(t cx)): |qx - S_x| <= 2M (2u + u^2) + u (M +
    4Mu) ~ 5Mu, and so for y. With dx = fl(qx - x), |dx| >= (1 - u) (Gx -
    5Mu), where Gx is the exact gap between the lane's x-range and the
    edge's, so d2 = fl(fl(dx dx) + fl(dy dy)) >= (1 - 4u) (Gx'^2 + Gy'^2)
    with Gx' = max(Gx - 5Mu, 0). The kernel's gap gx = max(fl(fl(xlo - m_e)
    - fl(xhi_lane + m_l)), ..., 0) is at most Gx - (m_e + m_l) + 4uM when
    positive (three roundings of values below 2M), and its bound b =
    fl(fl(gx gx) + fl(gy gy)) <= (1 + 2u) (gx^2 + gy^2). It skips only when
    b exceeds max(mind2) over the lane's points, so d2 >= b is enough, and
    that holds axis by axis once (1 - 4u) Gx'^2 >= (1 + 2u) gx^2, i.e. m_e
    + m_l >= 15 uM (Gx <= 2M). The widened boxes give m_e + m_l >= 32 uM:
    every skipped edge has d2 >= the lane's min, and fminf would have kept
    it. Near coordinate 116 one ulp is 7.6e-6 and the margin 2.2e-4
    degrees. Without a margin the bound fails: where an edge's ends straddle
    a binade, cx rounds and the projection can leave the edge's box.
    """
    return float(magnitude) * 2.0 ** -19


def distance_skip_bound(xlo, xhi, ylo, yhi, edges):
    """The plain version of K4x's per-(lane, edge) distance-skip bound, in
    f32 with the kernel's roundings: the squared gap between a box of
    points ``[xlo, xhi] x [ylo, yhi]`` and an edge's box, each widened by
    its margin. The kernel skips an edge for a lane when the bound exceeds
    every point's current min squared distance."""
    scale = distance_skip_margin(1.0)
    x1, y1, x2, y2 = (edges[..., j] for j in range(4))
    m_e = torch.maximum(torch.maximum(x1.abs(), x2.abs()),
                        torch.maximum(y1.abs(), y2.abs())) * scale
    m_l = torch.maximum(torch.maximum(xlo.abs(), xhi.abs()),
                        torch.maximum(ylo.abs(), yhi.abs())) * scale
    gx = torch.maximum((torch.minimum(x1, x2) - m_e) - (xhi + m_l),
                       (xlo - m_l) - (torch.maximum(x1, x2) + m_e))
    gy = torch.maximum((torch.minimum(y1, y2) - m_e) - (yhi + m_l),
                       (ylo - m_l) - (torch.maximum(y1, y2) + m_e))
    gx, gy = gx.clamp_min(0.0), gy.clamp_min(0.0)
    return gx * gx + gy * gy


def pip_lattice_plain(px, py, edges, edge_mask, is_areal,
                      parity: bool = False):
    """(N, G) distance from each point to each of G geometries (edges (G,
    E, 4), edge_mask (G, E), is_areal (G,)): 0 inside an areal geometry,
    else sqrt(min squared boundary distance). The JAX package's layout.
    With ``parity``, also the (N, G) even-odd parity of each point against
    each geometry (``points_in_geoms``): ``(dist, inside)``."""
    n, g, e = px.shape[0], edges.shape[0], edges.shape[1]
    step = max(1, _PLAIN_ELEMS // max(1, g * e))
    parts, insides = [], []
    for lo in range(0, n, step):
        sx, sy = px[lo:lo + step], py[lo:lo + step]
        inside = G.points_in_geoms(sx, sy, edges, edge_mask)
        bdist = G.points_to_edges_dist(sx, sy, edges, edge_mask)
        parts.append(torch.where(inside & is_areal[None, :], 0.0, bdist))
        insides.append(inside)
    if not parts:
        dist, inside = px.new_empty((0, g)), px.new_zeros((0, g), dtype=bool)
    elif len(parts) == 1:
        dist, inside = parts[0], insides[0]
    else:
        dist, inside = torch.cat(parts), torch.cat(insides)
    return (dist, inside) if parity else dist


def _check_lattice_args(px, py, edges, edge_mask, is_areal, cell=None,
                        num_cells: int = 0) -> None:
    """Device, dtype, contiguity and shapes of a K4x launch; ``cell``
    (N,) int32 with ``num_cells`` >= 1 asks for the cell order."""
    _check_cuda_args("pip_lattice", px, py, edges=edges, edge_mask=edge_mask,
                     is_areal=is_areal)
    if edges.dim() != 3 or edges.shape[2] != 4 \
            or edge_mask.shape != edges.shape[:2] \
            or is_areal.shape != edges.shape[:1]:
        raise ValueError(f"pip_lattice: edges {tuple(edges.shape)} must be "
                         f"(G, E, 4) with edge_mask (G, E) and is_areal (G,), "
                         f"got {tuple(edge_mask.shape)} / "
                         f"{tuple(is_areal.shape)}")
    if cell is not None:
        _check_order_args(cell, num_cells, px, py)


def _check_order_args(cell, num_cells: int, px, py) -> None:
    """A cell-order launch: cell (N,) int32 beside px, py, num_cells >= 1."""
    if cell.device != px.device:
        raise ValueError(f"cell_order: cell on {cell.device}, px on "
                         f"{px.device}")
    if cell.dtype != torch.int32:
        raise TypeError(f"cell_order: cell is {cell.dtype}, needs "
                        f"torch.int32")
    if cell.shape != px.shape or py.shape != px.shape or px.dim() != 1:
        raise ValueError(f"cell_order: cell {tuple(cell.shape)}, px "
                         f"{tuple(px.shape)}, py {tuple(py.shape)} must be "
                         f"equal 1-D shapes")
    if not cell.is_contiguous():
        raise ValueError("cell_order: cell is not contiguous")
    if int(num_cells) < 1:
        raise ValueError(f"cell_order: num_cells must be >= 1, got "
                         f"{num_cells}")


def cell_order_plain(cell, num_cells: int, px, py):
    """(perm (N,) int32, px[perm], py[perm]): the points in ascending order
    of their cell id, ``-1`` and out-of-grid cells last, equal cells in
    input order (a stable argsort of the key)."""
    key = torch.where((cell >= 0) & (cell < num_cells), cell,
                      torch.full_like(cell, int(num_cells)))
    perm = torch.argsort(key, stable=True)
    return perm.to(torch.int32), px[perm], py[perm]


@instrumented_kernel
def cell_order(cell, num_cells: int, px, py):
    """The cell order of a window's points (see :func:`cell_order_plain`).
    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/cell_order.cu``."""
    if cell.device.type == "cpu":
        return cell_order_plain(cell, num_cells, px, py)
    _check_cuda_args("cell_order", px, py)
    _check_order_args(cell, num_cells, px, py)
    n = px.shape[0]
    perm = torch.empty(n, dtype=torch.int32, device=px.device)
    sx, sy = torch.empty_like(px), torch.empty_like(py)
    counts = native.function("cell_order", "cell_order_counts",
                             (ctypes.c_int,))(n)
    scratch = torch.empty(counts + 5 * n, dtype=torch.int32, device=px.device)
    launch = native.function("cell_order", "cell_order_launch",
                             _ORDER_ARGTYPES)
    with torch.cuda.device(px.device):
        err = launch(cell.data_ptr(), n, int(num_cells), px.data_ptr(),
                     py.data_ptr(), perm.data_ptr(), sx.data_ptr(),
                     sy.data_ptr(), scratch.data_ptr(),
                     scratch[counts:].data_ptr(),
                     torch.cuda.current_stream(px.device).cuda_stream)
    native.check(err, "cell_order")
    cell_order.launches += 1
    return perm, sx, sy


cell_order.launches = 0


@instrumented_kernel(static=("num_cells", "parity"))
def pip_lattice(px, py, edges, edge_mask, is_areal, cell=None,
                num_cells: int = 0, parity: bool = False):
    """(G, N) JTS-style distance from each point to each of G geometries,
    one row per geometry (what the multi-query paths consume as (Q, N)).
    CPU tensors run :func:`pip_lattice_plain` (transposed); CUDA tensors
    launch the K4x kernel. Given the points' ``cell`` ids and the grid's
    ``num_cells``, and geometries of at least :data:`ORDER_MIN_EDGES`
    (padded) edges, the points go through :func:`cell_order` first and the
    kernel skips the edges no point of a warp needs (the same result).
    With ``parity``, returns ``(dist, inside)``: also the (G, N) even-odd
    parity the kernel's ray cast computes (the JAX package's
    ``points_in_geoms``, whatever ``is_areal`` says)."""
    if px.device.type == "cpu":
        out = pip_lattice_plain(px, py, edges, edge_mask, is_areal, parity)
        return (out[0].T, out[1].T) if parity else out.T
    _check_lattice_args(px, py, edges, edge_mask, is_areal, cell, num_cells)
    g, ne = edges.shape[0], edges.shape[1]
    n = px.shape[0]
    dist = torch.empty((g, n), dtype=torch.float32, device=px.device)
    inside = (torch.empty((g, n), dtype=torch.bool, device=px.device)
              if parity else None)
    perm = None
    if cell is not None and n > 0 and ne >= ORDER_MIN_EDGES:
        perm, px, py = cell_order(cell, num_cells, px, py)
    launch = native.function("pip_lattice", "pip_lattice_launch",
                             _LATTICE_ARGTYPES)
    with torch.cuda.device(px.device):
        err = launch(px.data_ptr(), py.data_ptr(),
                     None if perm is None else perm.data_ptr(), n,
                     edges.data_ptr(), edge_mask.data_ptr(), ne,
                     is_areal.data_ptr(), g, distance_skip_margin(1.0),
                     dist.data_ptr(),
                     None if inside is None else inside.data_ptr(),
                     torch.cuda.current_stream(px.device).cuda_stream)
    native.check(err, "pip_lattice")
    pip_lattice.launches += 1
    return (dist, inside) if parity else dist


pip_lattice.launches = 0
