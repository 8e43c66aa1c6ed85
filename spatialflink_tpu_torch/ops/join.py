"""Grid-cell join lattices (port of ``spatialflink_tpu.ops.join`` and of
``join_reduce`` in ``spatialflink_tpu.ops.pallas_kernels``).

The reference replicates the query stream to the neighbouring cells of
each query point and equi-joins on cell id (``join/JoinQuery.java:72-90``);
the pair condition is "a's cell within the candidate layers of b's cell,
and dist(a, b) <= r". Here that condition is evaluated on the (Na, Nb)
pair lattice of a window, as the JAX package does, by two hand-written
CUDA kernels:

- K6 (:func:`join_lattice`, ``csrc/join_lattice.cu``): the window's point
  x point pair set, ``cheb_layers(a, b) <= nb_layers`` & the centred
  expansion ``max(a2 + b2 - 2 (a0 b0 + a1 b1), 0) <= r^2`` & both valid,
  produced on the device as ``(a_index, b_index)`` in the order the JAX
  package yields them (by b tile of :data:`JOIN_TILE`, then a, then b);
  no (Na, tile) lattice is ever written. Plain version:
  :func:`join_lattice_plain` over :func:`join_mask`.
- K7 (:func:`join_reduce`, ``csrc/join_reduce.cu``): per a point over the
  whole b batch, the partner count, min d^2 and argmin, the prefilter of
  :func:`join_pairs_host` above :data:`_LATTICE_BUDGET`. Plain version:
  :func:`join_reduce_plain`.

Both kernels walk the window's join index (:func:`join_index`, built once
per window by :func:`join_pairs_host` with ``csrc/cell_order.cu``): the b
points sorted by (b tile, bucket), a bucket being a cell, so that a row
visits only the runs of cells within its layers (``csrc/join_walk.cuh``).

CPU tensors run the plain versions; CUDA tensors launch the kernels or
raise. Point x geometry joins take K4x's (G, N) distance rows
(``geom._lattice``) and geometry x geometry joins K5 in kNN mode
(``geom.geom_stream_dist``, the b geometries as its queries), each with
the JAX package's cell gate (:func:`cell_gate_rows`,
:func:`cell_gate_table`, :func:`pair_min_cheb`).

Coordinates are centred on the grid's middle before the expansion, as the
JAX package does, so that its f32 cancellation stays ~1e-6 degrees. The
expansion is elementwise f32 (no matrix product, so TF32 never enters).
:func:`adaptive_block_min_cells` is the pane join's block-coalescing
threshold, timed once per process and device on K6 itself. Not ported
yet: the bf16 superset (``SPATIALFLINK_JOIN_LATTICE=bf16`` is refused)
and ``join_counts``.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from spatialflink_tpu_torch.index.uniform_grid import NO_LAYER, cheb_layers
from spatialflink_tpu_torch.ops import native
from spatialflink_tpu_torch.utils.deviceplane import instrumented_kernel

_BIG = 3.4e38
#: b points per lattice tile: the pair order is (tile, a, b)
JOIN_TILE = 4096
#: above this many lattice cells (Na * Nb capacities) per window,
#: join_pairs_host prefilters the a side with K7 (read at call time, so
#: tests can lower it)
_LATTICE_BUDGET = 1 << 26
#: (rows x b) elements per step of the plain versions
_PLAIN_PAIRS = 1 << 24
#: operations per (a, b) pair inside the cell layers that the join needs:
#: the distance (K6: 2 mul, add, add, mul, sub, compare, with b's centring
#: and b2 counted once per b point; K7: 2 sub, 2 mul, add, compare) and
#: K7's running min (compare, 2 selects). The kernels touch no pair outside
#: the runs a row walks (``csrc/join_walk.cuh``)
OPS_K6_DIST = 7
OPS_K7_DIST = 9


def _f32(v) -> float:
    """``v`` rounded to float32, as a Python float (exact in f32)."""
    return float(np.float32(v))


def _r2(radius) -> float:
    """r * r in float32, as the JAX package's traced radius computes it."""
    r = np.float32(radius)
    return float(r * r)


def _layers(nb_layers) -> int:
    """The layer bound as an int32 (a larger one admits every pair the
    same way)."""
    return min(int(nb_layers), 2 ** 31 - 1)


def grid_center(grid):
    """The centre of the grid's square (the expansion's origin)."""
    half = grid.cell_length * grid.n / 2
    return grid.min_x + half, grid.min_y + half


def lattice_strategy() -> str:
    """``SPATIALFLINK_JOIN_LATTICE``: 'f32' (the default, and the only
    lattice ported); 'bf16' is refused as not yet ported, any other value
    as a typo (the JAX package's check)."""
    v = os.environ.get("SPATIALFLINK_JOIN_LATTICE", "f32").strip().lower()
    if v not in ("f32", "bf16"):
        raise ValueError(
            f"SPATIALFLINK_JOIN_LATTICE={v!r}: expected 'f32' or 'bf16' "
            "(a typo here would silently measure f32 twice)")
    if v == "bf16":
        from spatialflink_tpu_torch.operators.base import NOT_PORTED

        raise NotImplementedError(
            f"SPATIALFLINK_JOIN_LATTICE=bf16 (the bf16 superset lattice): "
            f"{NOT_PORTED}")
    return v


# ------------------------------------------------------------------------ #
# plain versions


def pairwise_dist2(ax, ay, bx, by, center_x=0.0, center_y=0.0):
    """(Na, Nb) squared distances by the centred expansion
    ``max(|a|^2 + |b|^2 - 2 a.b, 0)`` in float32, each operation rounded
    once (the JAX package's ``pairwise_dist2`` at ``Precision.HIGHEST``)."""
    cx, cy = _f32(center_x), _f32(center_y)
    a0, a1 = ax - cx, ay - cy
    b0, b1 = bx - cx, by - cy
    a2 = a0 * a0 + a1 * a1
    b2 = b0 * b0 + b1 * b1
    cross = a0[:, None] * b0[None, :] + a1[:, None] * b1[None, :]
    return torch.clamp_min((a2[:, None] + b2[None, :]) - 2.0 * cross, 0.0)


def _pair_cell_ok(cell_a, cell_b, nb_layers, n):
    """(Na, Nb) cell-join predicate: a's cell within ``nb_layers`` of b's
    (``nb_layers >= n`` admits every pair of valid cells)."""
    return cheb_layers(cell_a[:, None], cell_b[None, :], n) \
        <= _layers(nb_layers)


@instrumented_kernel(static=("n",))
def join_mask(a, b, radius, nb_layers, center_x, center_y, *, n: int):
    """The (Na, Nb) boolean join lattice of two point batches."""
    d2 = pairwise_dist2(a.x, a.y, b.x, b.y, center_x, center_y)
    ok = _pair_cell_ok(a.cell, b.cell, nb_layers, n)
    return ok & (d2 <= _r2(radius)) & a.valid[:, None] & b.valid[None, :]


def _rows_of(a, rows):
    """The a batch restricted to ``rows`` (all of it when None)."""
    if rows is None:
        return a
    idx = rows.long()
    return type(a)(*(t[idx] for t in a))


def join_lattice_plain(a, b, radius, nb_layers, center_x, center_y, *,
                       n: int, tile: int = JOIN_TILE, rows=None):
    """Plain version of :func:`join_lattice`: ``(a_index, b_index)`` int32
    of every pair of :func:`join_mask`, by b tile of ``tile``, then a, then
    b; with ``rows`` (int32, ascending) only the a rows listed."""
    sub = _rows_of(a, rows)
    m, nb = sub.x.shape[0], b.x.shape[0]
    ids = (torch.arange(m, dtype=torch.int32, device=a.x.device)
           if rows is None else rows.to(torch.int32))
    tile = max(1, min(tile, nb))
    step = max(1, _PLAIN_PAIRS // tile)
    ai, bi = [], []
    for start in range(0, nb, tile):
        bt = type(b)(*(t[start:start + tile] for t in b))
        for lo in range(0, m, step):
            at = type(sub)(*(t[lo:lo + step] for t in sub))
            i, j = torch.nonzero(join_mask(at, bt, radius, nb_layers,
                                           center_x, center_y, n=n),
                                 as_tuple=True)
            ai.append(ids[lo + i])
            bi.append((j + start).to(torch.int32))
    if not ai:
        empty = torch.empty(0, dtype=torch.int32, device=a.x.device)
        return empty, empty.clone()
    return torch.cat(ai), torch.cat(bi)


def join_reduce_plain(a, b, radius, nb_layers, *, n: int,
                      tile: int = JOIN_TILE):
    """Plain version of :func:`join_reduce` (the JAX package's
    ``_join_reduce_impl``): per a point, over b tiles of ``tile``, the
    count of hits (both valid, ``max(|dcx|, |dcy|) <= nb_layers`` over
    ``cell // n, cell % n`` with no sentinel for a cell of -1, and the
    uncentred ``dx*dx + dy*dy <= r^2``), their min d^2 (3.4e38 without
    one) and its index (-1 without one; the earliest index among equal
    minima)."""
    dev = a.x.device
    na, nb = a.x.shape[0], b.x.shape[0]
    layers, r2 = _layers(nb_layers), _r2(radius)
    acx = torch.div(a.cell, n, rounding_mode="floor")
    acy = torch.remainder(a.cell, n)
    bcx = torch.div(b.cell, n, rounding_mode="floor")
    bcy = torch.remainder(b.cell, n)
    cnt = torch.zeros(na, dtype=torch.int32, device=dev)
    mind2 = torch.full((na,), _BIG, dtype=torch.float32, device=dev)
    amin = torch.full((na,), -1, dtype=torch.int32, device=dev)
    tile = max(1, min(tile, nb))
    step = max(1, _PLAIN_PAIRS // tile)
    for lo in range(0, na, step):
        hi = min(na, lo + step)
        ax, ay = a.x[lo:hi, None], a.y[lo:hi, None]
        for start in range(0, nb, tile):
            s = slice(start, start + tile)
            cheb = torch.maximum((acx[lo:hi, None] - bcx[None, s]).abs(),
                                 (acy[lo:hi, None] - bcy[None, s]).abs())
            dx = ax - b.x[None, s]
            dy = ay - b.y[None, s]
            d2 = dx * dx + dy * dy
            hit = (a.valid[lo:hi, None] & b.valid[None, s]
                   & (cheb <= layers) & (d2 <= r2))
            cnt[lo:hi] += hit.sum(dim=1, dtype=torch.int32)
            d2m = torch.where(hit, d2, _BIG)
            tmin, targ = d2m.min(dim=1)
            targ = torch.where(hit.any(dim=1), targ.to(torch.int32) + start,
                               -1)
            better = tmin < mind2[lo:hi]
            mind2[lo:hi] = torch.where(better, tmin, mind2[lo:hi])
            amin[lo:hi] = torch.where(better, targ, amin[lo:hi])
    return cnt, mind2, amin


def pair_min_cheb(cells_a, mask_a, cells_b, mask_b, n: int):
    """(Ga, Gb) least Chebyshev layer distance between any valid cell of
    a and any valid cell of b (2**30 where either has none)."""
    ch = cheb_layers(cells_a[:, None, :, None], cells_b[None, :, None, :], n)
    valid = mask_a[:, None, :, None] & mask_b[None, :, None, :]
    return torch.where(valid, ch, NO_LAYER).amin(dim=(-2, -1))


def cell_gate_rows(cells, cells_mask, point_cell, nb_layers, n: int):
    """(G, N): a point's cell within ``nb_layers`` of ANY valid cell of the
    geometry (the JAX package's ``any(cheb_layers(p, g.cells) <= nb &
    g.cells_mask)``), one cell column of the geometries at a time."""
    layers = _layers(nb_layers)
    gate = torch.zeros((cells.shape[0], point_cell.shape[0]),
                       dtype=torch.bool, device=cells.device)
    for c in range(cells.shape[1]):
        gate |= cells_mask[:, c, None] & (
            cheb_layers(cells[:, c, None], point_cell[None, :], n) <= layers)
    return gate


def cell_gate_table(cells, cells_mask, nb_layers, n: int):
    """(G, n*n): for every cell of the grid, whether it lies within
    ``nb_layers`` of ANY valid cell of the geometry (a geometry's
    neighbouring-cells mask; :func:`cell_gate_rows` gathered by cell)."""
    grid_cells = torch.arange(n * n, dtype=torch.int32, device=cells.device)
    return cell_gate_rows(cells, cells_mask, grid_cells, nb_layers, n)


def point_geom_gate(points, geoms, nb_layers, n: int):
    """(G, N) cell gate of the point x geometry join: by a per-cell table
    gathered at the points' cells when the grid has fewer cells than the
    batch has points, else pair by pair (the same predicate)."""
    cell = points.cell
    if _layers(nb_layers) >= NO_LAYER or n * n >= cell.shape[0]:
        return cell_gate_rows(geoms.cells, geoms.cells_mask, cell,
                              nb_layers, n)
    table = cell_gate_table(geoms.cells, geoms.cells_mask, nb_layers, n)
    inside = (cell >= 0) & (cell < n * n)
    return table[:, cell.clamp(0, n * n - 1).long()] & inside[None, :]


# ------------------------------------------------------------------------ #
# the join index


class JoinIndex(NamedTuple):
    """A window's b points sorted by (b tile, bucket), stably
    (``csrc/join_walk.cuh``): ``perm`` (int32, the b index of each sorted
    position), ``key`` (int32, the sorted keys ``tile * stride + bucket``),
    ``x``, ``y`` (f32, b's coordinates in that order), ``starts`` (int32,
    for every key k below ``tiles * stride`` the first sorted position
    whose key is >= k; None above :data:`MAX_STARTS` entries or when the
    stride is 0), the ``tile`` (b points per tile) it was built for and
    ``stride`` (keys per tile; 0 when each tile was sorted on its own).
    Tile t's points fill the sorted positions ``[t * tile, (t + 1) *
    tile)``."""

    perm: torch.Tensor
    key: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    starts: Optional[torch.Tensor]
    tile: int
    stride: int


#: the most keys an int32 key can hold
_KEY_LIMIT = 2 ** 31 - 1
#: the most entries of a join index's start table (16 MB); the kernels
#: find a run's ends by binary search over the keys above it
MAX_STARTS = 1 << 22


def _tile_of(tile, nb: int) -> int:
    """The b points per tile as the kernels take them (at most nb)."""
    return max(1, min(int(tile), nb))


def index_layout(nb: int, n: int, tile: int):
    """``(tile, tiles, stride, starts)`` of the join index of nb b points on
    an n x n grid: the stride is ``n * n + 3`` keys per tile, or 0 when
    ``tiles`` of them would overflow an int32 key (each tile is then sorted
    on its own, its keys the buckets alone); ``starts`` the start table's
    entries (``tiles * stride``, or 0 for none: above :data:`MAX_STARTS`
    or with a stride of 0)."""
    tile = _tile_of(tile, nb)
    tiles = -(-nb // tile) if nb else 0
    stride = n * n + 3
    if tiles * stride > _KEY_LIMIT:
        stride = 0
    starts = tiles * stride
    return tile, tiles, stride, (starts if starts <= MAX_STARTS else 0)


def index_keys(cell, valid, n: int, tile: int, stride: int):
    """The join index's key of each b point (int32): ``(i // tile) *
    stride + bucket`` with the bucket 0 for a cell < 0, ``cell + 1`` for a
    cell of the grid, ``n*n + 1`` for a cell >= n*n and ``n*n + 2`` for an
    invalid point."""
    cells = n * n
    c = cell.long()
    bucket = torch.where(c < 0, 0, torch.where(c < cells, c + 1, cells + 1))
    bucket = torch.where(valid, bucket, cells + 2)
    t = torch.arange(c.shape[0], device=c.device) // tile
    return (t * stride + bucket).to(torch.int32)


def join_index_plain(b, n: int, tile: int = JOIN_TILE) -> JoinIndex:
    """Plain version of :func:`join_index`: :func:`index_keys` sorted by
    ``cell_order_plain`` (a stable argsort), per tile when the stride is
    0."""
    from spatialflink_tpu_torch.ops.hopper_kernels import cell_order_plain

    nb = b.x.shape[0]
    tile, tiles, stride, num_starts = index_layout(nb, n, tile)
    keys = index_keys(b.cell, b.valid, n, tile, stride)
    if stride:
        perm, x, y = cell_order_plain(keys, max(1, tiles * stride), b.x, b.y)
    else:
        firsts = range(0, nb, tile)
        parts = [cell_order_plain(keys[s:s + tile], n * n + 3,
                                  b.x[s:s + tile], b.y[s:s + tile])
                 for s in firsts]
        perm = torch.cat([q[0] + s for q, s in zip(parts, firsts)])
        x = torch.cat([q[1] for q in parts])
        y = torch.cat([q[2] for q in parts])
    key = keys[perm.long()]
    starts = None
    if num_starts:
        starts = torch.searchsorted(
            key.long(), torch.arange(num_starts, device=key.device)
        ).to(torch.int32)
    return JoinIndex(perm, key, x, y, starts, tile, stride)


_INDEX_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   *(ctypes.c_void_p,) * 7, ctypes.c_int,
                   *(ctypes.c_void_p,) * 3)


@instrumented_kernel
def join_index(b, n: int, tile: int = JOIN_TILE) -> JoinIndex:
    """The join index of a window's b batch (:class:`JoinIndex`), which K7
    and K6 walk. CPU tensors run :func:`join_index_plain`; CUDA tensors
    launch ``csrc/cell_order.cu``'s sort (``join_index_launch``: the key
    formed in its first pass, the sorted keys written by its last, then
    the start table), each launch counted in
    ``hopper_kernels.cell_order.launches``."""
    dev = b.x.device
    if dev.type == "cpu":
        return join_index_plain(b, n, tile)
    from spatialflink_tpu_torch.ops import hopper_kernels as HK

    _check_points("join_index", b, dev, "b")
    nb = b.x.shape[0]
    tile, tiles, stride, num_starts = index_layout(nb, n, tile)
    perm = torch.empty(nb, dtype=torch.int32, device=dev)
    key = torch.empty(nb, dtype=torch.int32, device=dev)
    x, y = torch.empty_like(b.x), torch.empty_like(b.y)
    starts = (torch.empty(num_starts, dtype=torch.int32, device=dev)
              if num_starts else None)
    if nb == 0:
        return JoinIndex(perm, key, x, y, None, tile, stride)
    # one sort over every tile, or (stride 0) one per tile
    spans = [(0, nb)] if stride else [(s, min(nb, s + tile))
                                      for s in range(0, nb, tile)]
    width = max(e - s for s, e in spans)
    counts = native.function("cell_order", "cell_order_counts",
                             (ctypes.c_int,))(width)
    scratch = torch.empty(counts + 5 * width, dtype=torch.int32, device=dev)
    launch = native.function("cell_order", "join_index_launch",
                             _INDEX_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def at(t, s):  # a pointer s items into a contiguous 1-D tensor
        return t.data_ptr() + s * t.element_size()

    with torch.cuda.device(dev):
        for s, e in spans:
            err = launch(at(b.cell, s), at(b.valid, s), e - s, n * n,
                         tile if stride else e - s, stride,
                         tiles * stride if stride else n * n + 3,
                         at(b.x, s), at(b.y, s), at(perm, s), at(x, s),
                         at(y, s), at(key, s), _ptr(starts), num_starts,
                         scratch.data_ptr(), at(scratch, counts),
                         stream)
            native.check(err, "join_index")
            HK.cell_order.launches += 1
            if s:
                perm[s:e] += s
    return JoinIndex(perm, key, x, y, starts, tile, stride)


def _check_index(what, index, b, dev, tile=None) -> None:
    """The join index of ``b`` on ``dev`` (built for ``tile`` when given)."""
    nb = b.x.shape[0]
    for field, dtype in (("perm", torch.int32), ("key", torch.int32),
                         ("x", torch.float32), ("y", torch.float32)):
        t = getattr(index, field)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != (nb,) \
                or not t.is_contiguous():
            raise ValueError(f"{what}: index.{field} must be a contiguous "
                             f"({nb},) {dtype} tensor on {dev}")
    starts = index.starts
    if starts is not None and (
            starts.device != dev or starts.dtype != torch.int32
            or starts.dim() != 1 or not starts.is_contiguous()
            or starts.shape[0] != -(-nb // index.tile) * index.stride):
        raise ValueError(f"{what}: index.starts must be a contiguous int32 "
                         f"tensor on {dev} of one entry per key")
    if tile is not None and index.tile != tile:
        raise ValueError(f"{what}: the index was built for tiles of "
                         f"{index.tile} b points, not {tile}")


# ------------------------------------------------------------------------ #
# the kernels


_C = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_REDUCE_ARGTYPES = (_C, _C, _C, _C, _I, _C, _I, _C, _C, _C, _C, _C, _I, _I,
                    _F, _I, _I, _C, _C, _C, _C)
_LATTICE_ARGTYPES = (_C, _C, _C, _C, _C, _I, _C, _I, _C, _C, _C, _C, _C, _I,
                     _I, _F, _F, _F, _I, _I, _I, _C, _C, _C, _C, _C)
#: a rows per block of K6 (csrc/join_lattice.cu kThreads)
LATTICE_ROWS_PER_BLOCK = 128


def _ptr(t):
    """A tensor's device pointer, or NULL for None."""
    return None if t is None else t.data_ptr()


def _check_points(what, p, dev, name):
    n = p.x.shape[0]
    for field, dtype in (("x", torch.float32), ("y", torch.float32),
                         ("cell", torch.int32), ("valid", torch.bool)):
        t = getattr(p, field)
        if t.device != dev:
            raise ValueError(f"{what}: {name}.{field} on {t.device}, needs "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name}.{field} is {t.dtype}, needs "
                            f"{dtype}")
        if tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError(f"{what}: {name}.{field} must be a contiguous "
                             f"({n},) tensor, got {tuple(t.shape)}")


@instrumented_kernel(static=("n", "tile"))
def join_reduce(a, b, radius, nb_layers, *, n: int, tile: int = JOIN_TILE,
                index=None):
    """Per a point against the whole b batch: ``(count (Na,) int32,
    min_d2 (Na,) f32, argmin (Na,) int32)``, as
    :func:`join_reduce_plain` defines them (``tile`` only shapes the plain
    version's steps and a new index: the result does not depend on it).
    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/join_reduce.cu`` (K7) over ``index``, b's :func:`join_index`
    (built here when None), or raise."""
    dev = a.x.device
    if dev.type == "cpu":
        return join_reduce_plain(a, b, radius, nb_layers, n=n, tile=tile)
    _check_points("join_reduce", a, dev, "a")
    _check_points("join_reduce", b, dev, "b")
    if index is None:
        index = join_index(b, n, tile)
    _check_index("join_reduce", index, b, dev)
    na, nb = a.x.shape[0], b.x.shape[0]
    cnt = torch.empty(na, dtype=torch.int32, device=dev)
    mind2 = torch.empty(na, dtype=torch.float32, device=dev)
    amin = torch.empty(na, dtype=torch.int32, device=dev)
    launch = native.function("join_reduce", "join_reduce_launch",
                             _REDUCE_ARGTYPES)
    with torch.cuda.device(dev):
        err = launch(a.x.data_ptr(), a.y.data_ptr(), a.cell.data_ptr(),
                     a.valid.data_ptr(), na, b.cell.data_ptr(), nb,
                     index.perm.data_ptr(), index.key.data_ptr(),
                     _ptr(index.starts), index.x.data_ptr(),
                     index.y.data_ptr(), index.tile, index.stride,
                     _r2(radius), _layers(nb_layers), int(n),
                     cnt.data_ptr(), mind2.data_ptr(), amin.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "join_reduce")
    join_reduce.launches += 1
    return cnt, mind2, amin


join_reduce.launches = 0


@instrumented_kernel(static=("n", "tile"))
def join_lattice(a, b, radius, nb_layers, center_x, center_y, *, n: int,
                 tile: int = JOIN_TILE, rows=None, index=None):
    """The window's point x point pairs ``(a_index (P,) int32, b_index (P,)
    int32)``: every pair of :func:`join_mask`, ordered by b tile of
    ``tile``, then a, then b (the order of the JAX package's
    ``np.nonzero`` per tile); with ``rows`` (int32, ascending) only those
    a rows, keeping their own indices. CPU tensors run
    :func:`join_lattice_plain`; CUDA tensors launch
    ``csrc/join_lattice.cu`` (K6: a count pass and a scan, one read of the
    pair total, and a write pass) over ``index``, b's :func:`join_index`
    for ``tile`` (built here when None), or raise."""
    dev = a.x.device
    if dev.type == "cpu":
        return join_lattice_plain(a, b, radius, nb_layers, center_x,
                                  center_y, n=n, tile=tile, rows=rows)
    _check_points("join_lattice", a, dev, "a")
    _check_points("join_lattice", b, dev, "b")
    na, nb = a.x.shape[0], b.x.shape[0]
    if rows is not None:
        if rows.device != dev or rows.dtype != torch.int32 \
                or rows.dim() != 1 or not rows.is_contiguous():
            raise ValueError("join_lattice: rows must be a contiguous 1-D "
                             f"int32 tensor on {dev}")
    m = na if rows is None else rows.shape[0]
    tile = _tile_of(tile, nb)
    if index is None:
        index = join_index(b, n, tile)
    _check_index("join_lattice", index, b, dev, tile)
    n_tiles = -(-nb // tile) if nb else 0
    blocks = -(-m // LATTICE_ROWS_PER_BLOCK) * n_tiles
    counts = torch.empty(max(1, m * n_tiles), dtype=torch.int32, device=dev)
    offsets = torch.empty(blocks + 1, dtype=torch.int32, device=dev)
    layers = _layers(nb_layers)
    args = (a.x.data_ptr(), a.y.data_ptr(), a.cell.data_ptr(),
            a.valid.data_ptr(), None if rows is None else rows.data_ptr(), m,
            b.cell.data_ptr(), nb, index.perm.data_ptr(),
            index.key.data_ptr(), _ptr(index.starts), index.x.data_ptr(),
            index.y.data_ptr(), tile, index.stride, _f32(center_x),
            _f32(center_y), _r2(radius), layers, int(layers >= NO_LAYER),
            int(n),
            counts.data_ptr(), offsets.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    count = native.function("join_lattice", "join_lattice_count",
                            _LATTICE_ARGTYPES)
    with torch.cuda.device(dev):
        native.check(count(*args, None, None, stream), "join_lattice count")
        total = int(offsets[blocks])  # the one wait: the output's size
        ai = torch.empty(total, dtype=torch.int32, device=dev)
        bi = torch.empty(total, dtype=torch.int32, device=dev)
        if total:
            write = native.function("join_lattice", "join_lattice_write",
                                    _LATTICE_ARGTYPES)
            native.check(write(*args, ai.data_ptr(), bi.data_ptr(), stream),
                         "join_lattice write")
    join_lattice.launches += 1
    return ai, bi


join_lattice.launches = 0


# ------------------------------------------------------------------------ #
# the window entries


def join_pairs_host(a, b, radius, grid, tile: int = JOIN_TILE,
                    nb_layers=None, lattice_budget=None, index=None):
    """A window's point x point pairs as host arrays ``(a_index, b_index)``
    (int64), in the JAX package's order. When the capacities' product
    ``Na * Nb`` exceeds ``lattice_budget`` (:data:`_LATTICE_BUDGET` read
    at call time), K7 first counts each a row's partners within
    ``sqrt(r^2 + 1e-5)`` (an absolute slack over the expansion's error)
    and K6 runs only over the rows that have one; the pairs are those of
    the full lattice on those rows, in the same order. b's
    :func:`join_index` (``index``, built here when None: the pane join
    passes each b pane's own, built once for all its blocks) serves both
    kernels."""
    lattice_strategy()
    if nb_layers is None:
        # radius 0 => every cell is a neighbour (UniformGrid.java:264-266)
        nb_layers = grid.n if radius == 0 else grid.candidate_layers(radius)
    cx, cy = grid_center(grid)
    na, nb = a.x.shape[0], b.x.shape[0]
    if lattice_budget is None:
        lattice_budget = _LATTICE_BUDGET
    rows = None
    if index is None:
        index = join_index(b, grid.n, tile)
    if na * nb > lattice_budget:
        pre_r = float(np.sqrt(radius * radius + 1e-5))
        cnt, _, _ = join_reduce(a, b, pre_r, nb_layers, n=grid.n, tile=tile,
                                index=index)
        rows = torch.nonzero(cnt > 0).reshape(-1).to(torch.int32)
        if rows.numel() == 0:
            empty = np.zeros(0, np.int64)
            return empty, empty.copy()
    ai, bi = join_lattice(a, b, radius, nb_layers, cx, cy, n=grid.n,
                          tile=tile, rows=rows, index=index)
    return ai.cpu().numpy().astype(np.int64), bi.cpu().numpy().astype(np.int64)


@instrumented_kernel(static=("n",))
def join_point_geom_rows(points, geoms, radius, nb_layers, *, n: int):
    """(G, N) join lattice of a point batch and a geometry batch, one row
    per geometry: the cell gate, K4x's JTS distance (``geom._lattice``, in
    cell order where its gate allows) <= r, and both valid. The JAX
    package's ``join_point_geom_mask`` is its transpose."""
    from spatialflink_tpu_torch.ops import geom as G

    d = G._lattice(points, geoms, n * n)
    gate = point_geom_gate(points, geoms, nb_layers, n)
    return (gate & (d <= _f32(radius)) & points.valid[None, :]
            & geoms.valid[:, None])


def join_point_geom_mask(points, geoms, radius, nb_layers, *, n: int):
    """(N, G) point x geometry join lattice (the JAX package's layout)."""
    return join_point_geom_rows(points, geoms, radius, nb_layers, n=n).T


@instrumented_kernel(static=("n",))
def join_geom_geom_mask(a, b, radius, nb_layers, *, n: int):
    """(Ga, Gb) geometry x geometry join lattice: K5 in kNN mode with the
    b geometries as its queries and each b geometry's neighbouring-cells
    mask (:func:`cell_gate_table`), whose eligibility equals
    ``pair_min_cheb(a, b) <= nb_layers`` & a valid; then d <= r and b
    valid."""
    from spatialflink_tpu_torch.ops import geom as G

    nb = cell_gate_table(b.cells, b.cells_mask, nb_layers, n)
    flag, dist, _ = G.geom_stream_dist(a, mode=G.MODE_KNN, nb=nb, queries=b)
    return (flag & (dist <= _f32(radius)) & b.valid[:, None]).T


# ------------------------------------------------------------------------ #
# the pane join's block-coalescing threshold

#: calibrated thresholds, by device (one calibration per process each)
_BLOCK_MIN_CELLS: dict = {}
#: the clamp of the threshold (the JAX package's): past ~16M cells a block
#: is compute-bound whatever the dispatch costs
BLOCK_MIN_CELLS_MAX = 1 << 24


def adaptive_block_min_cells(device="cpu") -> int:
    """The lattice-cell count (padded Na * Nb) below which one pane-pair
    block of the pane join is dispatch-bound: its fixed cost (the join
    index, K6's launches, the read of the pair total and the pairs' copy
    back) exceeds its work, so the operator evaluates such a window as one
    coalesced lattice (port of the JAX package's
    ``adaptive_block_min_cells``).

    ``SPATIALFLINK_JOIN_BLOCK_MIN_CELLS=<int>`` wins, read at each call
    (0 turns coalescing off). Otherwise it is calibrated once per process
    and device on the port's own lattice path on ``device``:
    :func:`join_lattice` (K6 on the card, its plain version on the CPU)
    with its index and the pairs read back, timed at 256 x 128 (the
    per-dispatch floor) and 4,096 x 1,024 (the marginal rate per cell),
    each the mean of 5 calls after one untimed call, the card synchronised
    around each call; ``floor * rate`` is the break-even block, clamped to
    [0, :data:`BLOCK_MIN_CELLS_MAX`]."""
    env = os.environ.get("SPATIALFLINK_JOIN_BLOCK_MIN_CELLS")
    if env is not None:
        return max(0, int(env))
    dev = torch.device(device)
    key = str(dev)
    if key in _BLOCK_MIN_CELLS:
        return _BLOCK_MIN_CELLS[key]
    import time

    from spatialflink_tpu_torch.models import PointBatch

    def batch(n):
        x = np.linspace(0.0, 1.0, n)
        return PointBatch.from_arrays(x, x, device=dev,
                                      obj_id=np.arange(n, dtype=np.int32),
                                      cell=np.zeros(n, np.int32))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(a, b):
        ai, bi = join_lattice(a, b, 0.1, 4, 0.5, 0.5, n=4)
        ai.cpu(), bi.cpu()

    def mean_s(a, b, reps=5):
        run(a, b)  # the first call outside the timing
        total = 0.0
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            run(a, b)
            sync()
            total += time.perf_counter() - t0
        return total / reps

    sa, sb, ba, bb = batch(256), batch(128), batch(4096), batch(1024)
    t_small, t_big = mean_s(sa, sb), mean_s(ba, bb)
    cells_small, cells_big = 256 * 128, 4096 * 1024
    rate = (cells_big - cells_small) / max(t_big - t_small, 1e-9)
    _BLOCK_MIN_CELLS[key] = int(min(max(t_small * rate, 0.0),
                                    float(BLOCK_MIN_CELLS_MAX)))
    return _BLOCK_MIN_CELLS[key]
