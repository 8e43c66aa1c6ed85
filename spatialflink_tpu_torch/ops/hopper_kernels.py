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
it. K4 folds every pair (disjoint point ranges per block, edge chunks
staged in shared memory with the per-edge divides done once per edge).
K4x, given the points' cell ids, sorts them into cell order and lets each
warp skip the edges that provably cannot change any of its points
(:func:`distance_skip_margin`); the sources describe both designs.
"""

from __future__ import annotations

import ctypes

import torch

from spatialflink_tpu_torch.ops import geom as G
from spatialflink_tpu_torch.ops import native

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

_C = ctypes.c_void_p
_ARGTYPES = (_C, _C, ctypes.c_int, _C, _C, ctypes.c_int, ctypes.c_int, _C,
             _C)
_LATTICE_ARGTYPES = (_C, _C, _C, ctypes.c_int, _C, _C, ctypes.c_int, _C,
                     ctypes.c_int, ctypes.c_float, _C, _C)
_ORDER_ARGTYPES = (_C, ctypes.c_int, ctypes.c_int, _C, _C, _C, _C, _C, _C, _C,
                   _C)


def _ceil_to(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


def bucket_edges(ne: int) -> int:
    """Edge-count bucket (as ``pallas_kernels.pip_dist``): multiples of 64
    up to one chunk, whole chunks beyond."""
    return _ceil_to(ne, 64) if ne <= EDGE_CHUNK else _ceil_to(ne, EDGE_CHUNK)


def pip_dist_plain(px, py, edges, edge_mask, is_areal: bool):
    """(N,) distance from each point to ONE geometry: 0 inside an areal
    geometry, else sqrt(min squared boundary distance); an empty edge set
    gives sqrt(3.4e38) ~ 1.8e19."""
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


def pip_dist(px, py, edges, edge_mask, is_areal: bool):
    """(N,) JTS-style distance from each point to ONE query geometry (0
    inside areal geometries, else min boundary distance). CPU tensors run
    :func:`pip_dist_plain`; CUDA tensors launch the K4 kernel."""
    if px.device.type == "cpu":
        return pip_dist_plain(px, py, edges, edge_mask, is_areal)
    _check_cuda_args("pip_dist", px, py, edges=edges, edge_mask=edge_mask)
    if edges.dim() != 2 or edges.shape[1] != 4 \
            or edge_mask.shape != edges.shape[:1]:
        raise ValueError(f"pip_dist: edges {tuple(edges.shape)} must be "
                         f"(E, 4) with edge_mask (E,), got "
                         f"{tuple(edge_mask.shape)}")
    ne = edges.shape[0]
    ep = bucket_edges(ne)
    if ep != ne:  # padded edges are masked out in the kernel
        edges = torch.cat([edges, edges.new_zeros((ep - ne, 4))])
        edge_mask = torch.cat([edge_mask, edge_mask.new_zeros(ep - ne)])
    dist = torch.empty_like(px)
    launch = native.function("pip_dist", "pip_dist_launch", _ARGTYPES)
    with torch.cuda.device(px.device):
        err = launch(px.data_ptr(), py.data_ptr(), px.shape[0],
                     edges.data_ptr(), edge_mask.data_ptr(), ep,
                     int(bool(is_areal)), dist.data_ptr(),
                     torch.cuda.current_stream(px.device).cuda_stream)
    native.check(err, "pip_dist")
    pip_dist.launches += 1
    return dist


pip_dist.launches = 0


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


def pip_lattice_plain(px, py, edges, edge_mask, is_areal):
    """(N, G) distance from each point to each of G geometries (edges (G,
    E, 4), edge_mask (G, E), is_areal (G,)): 0 inside an areal geometry,
    else sqrt(min squared boundary distance). The JAX package's layout."""
    n, g, e = px.shape[0], edges.shape[0], edges.shape[1]
    step = max(1, _PLAIN_ELEMS // max(1, g * e))
    parts = []
    for lo in range(0, n, step):
        sx, sy = px[lo:lo + step], py[lo:lo + step]
        inside = G.points_in_geoms(sx, sy, edges, edge_mask)
        bdist = G.points_to_edges_dist(sx, sy, edges, edge_mask)
        parts.append(torch.where(inside & is_areal[None, :], 0.0, bdist))
    if not parts:
        return px.new_empty((0, g))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


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


def pip_lattice(px, py, edges, edge_mask, is_areal, cell=None,
                num_cells: int = 0):
    """(G, N) JTS-style distance from each point to each of G geometries,
    one row per geometry (what the multi-query paths consume as (Q, N)).
    CPU tensors run :func:`pip_lattice_plain` (transposed); CUDA tensors
    launch the K4x kernel. Given the points' ``cell`` ids and the grid's
    ``num_cells``, and geometries of at least :data:`ORDER_MIN_EDGES`
    (padded) edges, the points go through :func:`cell_order` first and the
    kernel skips the edges no point of a warp needs (the same result)."""
    if px.device.type == "cpu":
        return pip_lattice_plain(px, py, edges, edge_mask, is_areal).T
    _check_lattice_args(px, py, edges, edge_mask, is_areal, cell, num_cells)
    g, ne = edges.shape[0], edges.shape[1]
    n = px.shape[0]
    dist = torch.empty((g, n), dtype=torch.float32, device=px.device)
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
                     torch.cuda.current_stream(px.device).cuda_stream)
    native.check(err, "pip_lattice")
    pip_lattice.launches += 1
    return dist


pip_lattice.launches = 0
