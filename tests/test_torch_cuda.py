"""K4 (dense and with its per-cell edge table), K4x (in stream and in cell
order, with its pruning edge cases), the cell order, K1 (single and with a
query axis of 1, 3, 16 and 17, vector and scalar loads), K2 (with its
overflow and tie cases) and K5 (the geometry-stream distance: range and kNN
mode, point and geometry queries, exact and approximate, 1 and 16 queries,
a query of more edges than it stages) against their plain PyTorch versions
on the card, bit for bit.

The CUDA kernels have no CPU mode, so these tests skip without a card.
This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed: on the card, ``python -m pytest --noconftest
tests/test_torch_cuda.py`` (``--noconftest`` skips tests/conftest.py, which
sets up JAX).
"""

import numpy as np
import pytest
import torch

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import (EdgeGeomBatch, LineString,
                                            MultiPolygon, Point, PointBatch,
                                            Polygon, from_jax_arrays,
                                            single_query_edges)
from spatialflink_tpu_torch.ops import geom as G
from spatialflink_tpu_torch.ops import hopper_kernels as HK
from spatialflink_tpu_torch.ops import knn as K
from spatialflink_tpu_torch.ops import range as R


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ring(n_vert, r=3.0):
    th = np.linspace(0, 2 * np.pi, n_vert, endpoint=False)
    ring = [(5 + r * float(np.cos(t)), 5 + r * float(np.sin(t))) for t in th]
    return ring + [ring[0]]


GEOMS = {
    "polygon": lambda: Polygon.create([[(2, 2), (6, 2), (6, 6), (2, 6)]]),
    "hole": lambda: Polygon.create([[(1, 1), (8, 1), (8, 8), (1, 8)],
                                    [(3, 3), (5, 3), (5, 5)]]),
    "linestring": lambda: LineString.create([(0.5, 0.5), (4, 7), (9, 3)]),
    "chunk512": lambda: Polygon.create([_ring(512)]),
    "chunk513": lambda: Polygon.create([_ring(513)]),
    "large": lambda: Polygon.create([_ring(1301, 3.5)]),
}


def _batch(dev, n=5000, seed=21):
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    rng = np.random.default_rng(seed)
    return grid, PointBatch.from_arrays(rng.uniform(-1, 11, n),
                                        rng.uniform(-1, 11, n), device=dev,
                                        grid=grid)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GEOMS) + ["empty"])
def test_pip_dist_kernel_equals_plain(card, case):
    _, b = _batch(card)
    if case == "empty":
        e = torch.zeros((0, 4), device=card)
        m = torch.zeros(0, dtype=torch.bool, device=card)
        areal = True
    else:
        geom = GEOMS[case]()
        e, m = (torch.from_numpy(a).to(card) for a in single_query_edges(geom))
        areal = isinstance(geom, Polygon)
    launches = HK.pip_dist.launches
    got = HK.pip_dist(b.x, b.y, e, m, areal)
    assert HK.pip_dist.launches == launches + 1
    assert torch.equal(got, HK.pip_dist_plain(b.x, b.y, e, m, areal))


@pytest.mark.cuda
@pytest.mark.parametrize("approximate", [False, True])
def test_range_mask_kernel_equals_plain(card, approximate):
    grid, b = _batch(card)
    args = (b, 5.2, 4.7, int(grid.assign_cell(5.2, 4.7)[0]), 2.0,
            grid.guaranteed_layers(2.0), grid.candidate_layers(2.0))
    launches = R.range_mask_stats.launches
    got = R.range_filter_point_stats(*args, n=grid.n, approximate=approximate)
    want = R.range_filter_point_stats_plain(*args, n=grid.n,
                                            approximate=approximate)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cells = [44, 45, 54]
    gn = torch.from_numpy(grid.guaranteed_cells_mask(1.7, cells)).to(card)
    cn = torch.from_numpy(grid.candidate_cells_mask(1.7, cells)).to(card)
    got = R.range_filter_masks_stats(b, gn, cn, got[1], 1.7,
                                     approximate=approximate)
    want = R.range_filter_masks_stats_plain(b, gn, cn, want[1], 1.7,
                                            approximate=approximate)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert R.range_mask_stats.launches == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("approximate", [False, True])
def test_range_mask_query_axis_rows_equal_single(card, approximate):
    grid, b = _batch(card)
    rng = np.random.default_rng(3)
    qx = rng.uniform(0, 10, 7).astype(np.float32)
    qy = rng.uniform(0, 10, 7).astype(np.float32)
    qc = np.array([grid.assign_cell(float(a), float(c))[0]
                   for a, c in zip(qx, qy)], np.int32)
    qc[3] = -1  # a query outside the grid: no GN/CN cells
    t = [torch.from_numpy(a).to(card) for a in (qx, qy, qc)]
    gl, cl = grid.guaranteed_layers(2.0), grid.candidate_layers(2.0)
    launches = R.range_mask_stats.launches
    masks, gn, ev = R.range_filter_point_multi_masks(
        b, *t, 2.0, gl, cl, n=grid.n, approximate=approximate)
    assert R.range_mask_stats.launches == launches + 1
    plain = R.range_filter_point_multi_masks_plain(
        b, *t, 2.0, gl, cl, n=grid.n, approximate=approximate)
    assert all(torch.equal(g, w) for g, w in zip((masks, gn, ev), plain))
    for q in range(7):
        one = R.range_filter_point_stats(b, float(qx[q]), float(qy[q]),
                                         int(qc[q]), 2.0, gl, cl, n=grid.n,
                                         approximate=approximate)
        assert torch.equal(masks[q], one[0])
        assert [int(gn[q]), int(ev[q])] == [int(one[2]), int(one[3])]
    cells = [[44, 45], [0], [99, 98, 89]]
    gnm = torch.from_numpy(np.stack([grid.guaranteed_cells_mask(1.7, c)
                                     for c in cells])).to(card)
    cnm = torch.from_numpy(np.stack([grid.candidate_cells_mask(1.7, c)
                                     for c in cells])).to(card)
    d = torch.from_numpy(rng.uniform(0, 3, (3, b.capacity))
                         .astype(np.float32)).to(card)
    got = R.range_filter_masks_stats(b, gnm, cnm, d, 1.7,
                                     approximate=approximate)
    want = R.range_filter_masks_stats_plain(b, gnm, cnm, d, 1.7,
                                            approximate=approximate)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for q in range(3):
        one = R.range_filter_masks_stats(b, gnm[q], cnm[q], d[q], 1.7,
                                         approximate=approximate)
        assert torch.equal(got[0][q], one[0])


def _lattice_geoms(card):
    return EdgeGeomBatch.from_objects(
        [GEOMS[c]() for c in ("polygon", "hole", "linestring", "large")]
        + [Polygon.create([[(x, y), (x + 0.7, y), (x + 0.7, y + 0.4),
                            (x, y + 0.4)]]) for x, y in ((1, 1), (6, 7))],
        device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("ordered", [False, True])
def test_pip_lattice_kernel_equals_plain(card, ordered):
    grid, b = _batch(card)
    gb = _lattice_geoms(card)
    assert gb.edges.shape[1] > HK.EDGE_CHUNK  # several edge chunks
    kw = dict(cell=b.cell, num_cells=grid.num_cells) if ordered else {}
    launches = HK.pip_lattice.launches
    got = HK.pip_lattice(b.x, b.y, gb.edges, gb.edge_mask, gb.is_areal, **kw)
    assert HK.pip_lattice.launches == launches + 1
    assert got.shape == (gb.capacity, b.capacity)
    want = HK.pip_lattice_plain(b.x, b.y, gb.edges, gb.edge_mask, gb.is_areal)
    assert torch.equal(got, want.T)
    # each row equals K4 on that geometry alone
    for g in range(6):
        one = HK.pip_dist(b.x, b.y, gb.edges[g], gb.edge_mask[g],
                          bool(gb.is_areal[g]))
        assert torch.equal(got[g], one)


def _knn_inputs(card, n=50_000, ids=3_000, seed=8):
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 11, n)
    y = rng.uniform(-1, 11, n)
    x[:200] = 5.25  # duplicated coordinates: exact ties across objects
    y[:200] = 4.75
    oid = rng.integers(0, ids, n).astype(np.int32)
    b = PointBatch.from_arrays(x, y, device=card, grid=grid, obj_id=oid)
    return grid, b


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 50, K.MAX_K])
@pytest.mark.parametrize("num_ids", [3_000, 100_000])
def test_knn_topk_point_mode_equals_plain(card, k, num_ids):
    grid, b = _knn_inputs(card)
    # 5 queries: the table's per-object reads take the scalar path when Q
    # is not a multiple of 4
    qx = torch.tensor([5.25, 1.0, 9.5, 3.3, 7.7], device=card)
    qy = torch.tensor([4.75, 9.0, 0.5, 3.3, 2.2], device=card)
    qc = torch.tensor([int(grid.assign_cell(float(a), float(c))[0])
                       for a, c in zip(qx.tolist(), qy.tolist())],
                      dtype=torch.int32, device=card)
    kw = dict(mode=K.MODE_POINT, k=k, num_ids=num_ids, x=b.x, y=b.y,
              cell=b.cell, valid=b.valid, qx=qx, qy=qy, q_cell=qc, n=grid.n)
    for nb_layers in (1, grid.n):
        launches = K.knn_topk.launches
        got = K.knn_topk(b.obj_id, nb_layers=nb_layers, **kw)
        assert K.knn_topk.launches == launches + 1
        want = K.knn_topk_plain(b.obj_id, nb_layers=nb_layers, **kw)
        assert _equal(got, want)
        assert bool(got[2][0, :min(k, 10)].all())
    with pytest.raises(NotImplementedError, match=str(K.MAX_K)):
        K.knn_topk(b.obj_id, nb_layers=1, **dict(kw, k=K.MAX_K + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 50])
def test_knn_topk_cell_and_eligible_modes_equal_plain(card, k):
    grid, b = _knn_inputs(card)
    rng = np.random.default_rng(4)
    q = 16
    d = torch.from_numpy(rng.uniform(0, 2, (q, b.capacity))
                         .astype(np.float32)).to(card)
    d[:, :300] = 0.0  # ties at distance 0 (inside a polygon)
    nb = torch.from_numpy(rng.random((q, grid.num_cells)) < 0.4).to(card)
    nb[5] = False  # nothing eligible for query 5
    kw = dict(k=k, num_ids=3_000, cell=b.cell, valid=b.valid, dists=d,
              nb_mask=nb)
    got = K.knn_topk(b.obj_id, mode=K.MODE_CELLS, **kw)
    want = K.knn_topk_plain(b.obj_id, mode=K.MODE_CELLS, **kw)
    assert _equal(got, want)
    assert not bool(got[2][5].any()) and int(got[3][5]) == 0
    assert bool((got[0][5] == K._OID_SENTINEL).all())
    elig = K.point_stream_eligibility(b.cell, b.valid, nb)
    kw = dict(k=k, num_ids=3_000, dists=d, eligible=elig)
    got_e = K.knn_topk(b.obj_id, mode=K.MODE_ELIGIBLE, **kw)
    assert _equal(got_e, K.knn_topk_plain(b.obj_id, mode=K.MODE_ELIGIBLE,
                                          **kw))
    assert _equal(got_e, got)


def _order_inputs(card, n=20_000, seed=5):
    rng = np.random.default_rng(seed)
    cell = rng.integers(-3, 130, n).astype(np.int32)  # -1s and out-of-grid
    cell[:64] = 7  # a long run of one cell
    px = rng.uniform(0, 10, n).astype(np.float32)
    py = rng.uniform(0, 10, n).astype(np.float32)
    return [torch.from_numpy(a).to(card) for a in (cell, px, py)]


@pytest.mark.cuda
@pytest.mark.parametrize("num_cells", [1, 100, 300, 70_000])
def test_cell_order_kernel_equals_plain(card, num_cells):
    cell, px, py = _order_inputs(card)
    launches = HK.cell_order.launches
    got = HK.cell_order(cell, num_cells, px, py)
    assert HK.cell_order.launches == launches + 1
    want = HK.cell_order_plain(cell, num_cells, px, py)
    assert _equal(got, want)


def _edge_case_points(card):
    """Points of the K4x pruning edge cases over the 10 x 10 grid: on
    edges and vertices, at vertex y values, a tile of one cell within a
    margin of an edge, outside the grid (cell -1), plus a random spread."""
    grid, b = _batch(torch.device("cpu"))
    pts = [(b.x.numpy()[:5000].astype(np.float64),
            b.y.numpy()[:5000].astype(np.float64))]
    square = [(2, 2), (6, 2), (6, 6), (2, 6)]
    on = [(2.0 + 4.0 * t, 2.0) for t in np.linspace(0, 1, 33)]
    on += [(6.0, 2.0 + 4.0 * t) for t in np.linspace(0, 1, 33)]
    on += [tuple(v) for v in square] + [tuple(v) for v in _ring(513)[:64]]
    pts.append(tuple(np.asarray(c, np.float64) for c in zip(*on)))
    # y exactly at vertex y values, x across the geometries
    ys = np.repeat([2.0, 6.0, 5.0, 8.0, 1.0], 200)
    pts.append((np.tile(np.linspace(0.0, 10.0, 200), 5), ys))
    # 2,048 points of cell (3, 1) hugging the edge y = 2 from below, and
    # 2,048 of cell (3, 2) from above, within ~2 margins
    off = np.float32(2.0) - np.nextafter(np.float32(2.0), np.float32(0))
    steps = np.array([0, 1, 2, 3, 8, 40, 200, 1000], np.float64) * off
    xs = np.linspace(3.01, 3.99, 256)
    pts.append((np.tile(xs, 8), 2.0 - np.repeat(steps, 256) - 1e-12))
    pts.append((np.tile(xs, 8), 2.0 + np.repeat(steps, 256)))
    # outside the grid: cell -1
    pts.append((np.linspace(-2.0, -0.5, 300), np.linspace(-1.0, 12.0, 300)))
    x = np.concatenate([p[0] for p in pts])
    y = np.concatenate([p[1] for p in pts])
    return grid, PointBatch.from_arrays(x, y, device=card, grid=grid)


def _edge_case_geoms(card):
    big = Polygon.create([[(-50, -50), (60, -50), (60, 60), (-50, 60)]])
    return EdgeGeomBatch.from_objects(
        [GEOMS[c]() for c in ("polygon", "hole", "linestring", "chunk513",
                              "large")]
        + [big, Polygon.create([_ring(8, 1.0)]),
           LineString.create([(2, 2), (6, 2)])], device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("ordered", [True, False])
def test_pip_lattice_pruning_edge_cases_equal_plain(card, ordered):
    grid, b = _edge_case_points(card)
    assert bool((b.cell == -1).any())
    gb = _edge_case_geoms(card)
    kw = dict(cell=b.cell, num_cells=grid.num_cells) if ordered else {}
    orders = HK.cell_order.launches
    got = HK.pip_lattice(b.x, b.y, gb.edges, gb.edge_mask, gb.is_areal, **kw)
    assert HK.cell_order.launches == orders + int(ordered)
    want = HK.pip_lattice_plain(b.x, b.y, gb.edges, gb.edge_mask,
                                gb.is_areal)
    assert torch.equal(got, want.T)
    for g in (0, 3, 4, 5):
        one = HK.pip_dist(b.x, b.y, gb.edges[g], gb.edge_mask[g],
                          bool(gb.is_areal[g]))
        assert torch.equal(got[g], one)


@pytest.mark.cuda
def test_pip_lattice_near_edges_at_conf_coordinates(card):
    """A 64-edge ring at the conf's coordinates (~116, ~40.5, where one ulp
    is 7.6e-6) with points placed on its edges in f32 and a few ulps off
    them, sorted so that each warp holds neighbours."""
    grid = UniformGrid(115.5, 117.6, 39.6, 41.1, num_grid_partitions=100)
    th = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    ring = [(116.6 + 0.35 * float(np.cos(t)), 40.55 + 0.35 * float(np.sin(t)))
            for t in th]
    poly = Polygon.create([ring + [ring[0]]], grid)
    e = single_query_edges(poly)[0][:64].astype(np.float32)
    rng = np.random.default_rng(9)
    t = rng.random((64, 64)).astype(np.float32)
    ex = e[:, None, 0] + t * (e[:, None, 2] - e[:, None, 0])
    ey = e[:, None, 1] + t * (e[:, None, 3] - e[:, None, 1])
    shift = rng.integers(-4, 5, ex.shape).astype(np.float32)
    ex = ex + shift * np.spacing(ex)
    ey = ey - shift * np.spacing(ey)
    x = np.concatenate([ex.ravel(), rng.uniform(115.5, 117.6, 20_000)])
    y = np.concatenate([ey.ravel(), rng.uniform(39.6, 41.1, 20_000)])
    b = PointBatch.from_arrays(x, y, device=card, grid=grid)
    gb = EdgeGeomBatch.from_objects([poly], device=card)
    got = HK.pip_lattice(b.x, b.y, gb.edges, gb.edge_mask, gb.is_areal,
                         cell=b.cell, num_cells=grid.num_cells)
    want = HK.pip_lattice_plain(b.x, b.y, gb.edges, gb.edge_mask,
                                gb.is_areal)
    assert torch.equal(got, want.T)


def _same_point_inputs(card, n, ids):
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    oid = (np.arange(n) % ids).astype(np.int32)
    b = PointBatch.from_arrays(np.full(n, 5.25), np.full(n, 4.75),
                               device=card, grid=grid, obj_id=oid)
    q = [torch.tensor([5.0], device=card), torch.tensor([5.0], device=card),
         torch.tensor([int(grid.assign_cell(5.0, 5.0)[0])],
                      dtype=torch.int32, device=card)]
    return grid, b, q


@pytest.mark.cuda
@pytest.mark.parametrize("n,ids,k", [(100_000, 100_000, K.MAX_K),
                                     (6_000, 3_000, 50), (3_000, 30, 50)])
def test_knn_topk_equal_distances_equal_plain(card, n, ids, k):
    """Every object at one distance: the boundary bin holds them all, so
    the selection refines on the key's lower bits (or, with fewer ids than
    k, takes every object)."""
    grid, b, (qx, qy, qc) = _same_point_inputs(card, n, ids)
    kw = dict(mode=K.MODE_POINT, k=k, num_ids=ids, x=b.x, y=b.y, cell=b.cell,
              valid=b.valid, qx=qx, qy=qy, q_cell=qc, n=grid.n,
              nb_layers=grid.n)
    got = K.knn_topk(b.obj_id, **kw)
    want = K.knn_topk_plain(b.obj_id, **kw)
    assert _equal(got, want)
    assert got[0][0, :min(k, ids)].tolist() == list(range(min(k, ids)))
    assert int(got[2][0].sum()) == min(k, ids)


@pytest.mark.cuda
def test_knn_topk_ties_with_sixteen_queries_equal_plain(card):
    grid, b = _knn_inputs(card)
    rng = np.random.default_rng(6)
    qx = torch.from_numpy(np.r_[5.25, rng.uniform(0, 10, 15)]
                          .astype(np.float32)).to(card)
    qy = torch.from_numpy(np.r_[4.75, rng.uniform(0, 10, 15)]
                          .astype(np.float32)).to(card)
    qc = torch.tensor([int(grid.assign_cell(float(a), float(c))[0])
                       for a, c in zip(qx.tolist(), qy.tolist())],
                      dtype=torch.int32, device=card)
    for k in (10, 50, 300):
        kw = dict(mode=K.MODE_POINT, k=k, num_ids=3_000, x=b.x, y=b.y,
                  cell=b.cell, valid=b.valid, qx=qx, qy=qy, q_cell=qc,
                  n=grid.n, nb_layers=grid.n)
        assert _equal(K.knn_topk(b.obj_id, **kw),
                      K.knn_topk_plain(b.obj_id, **kw))


@pytest.mark.cuda
def test_pip_lattice_short_geometries_stay_in_stream_order(card):
    """Below ORDER_MIN_EDGES padded edges the cell order costs more than it
    saves: the wrapper folds every pair in stream order (same result)."""
    grid, b = _batch(card)
    gb = EdgeGeomBatch.from_objects(
        [GEOMS["polygon"](), GEOMS["linestring"]()], device=card)
    assert gb.edges.shape[1] < HK.ORDER_MIN_EDGES
    orders = HK.cell_order.launches
    got = HK.pip_lattice(b.x, b.y, gb.edges, gb.edge_mask, gb.is_areal,
                         cell=b.cell, num_cells=grid.num_cells)
    assert HK.cell_order.launches == orders
    want = HK.pip_lattice_plain(b.x, b.y, gb.edges, gb.edge_mask,
                                gb.is_areal)
    assert torch.equal(got, want.T)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GEOMS) + ["empty"])
def test_pip_dist_table_kernel_equals_plain(card, case):
    """The per-cell table form on K4's cases (no table above one chunk:
    those fold densely), over points with cells, cell -1 and border
    points."""
    grid, b = _table_points(card)
    if case == "empty":
        e = torch.zeros((0, 4), device=card)
        m = torch.zeros(0, dtype=torch.bool, device=card)
        areal = True
    else:
        geom = GEOMS[case]()
        e, m = (torch.from_numpy(a).to(card) for a in single_query_edges(geom))
        areal = isinstance(geom, Polygon)
    # the table form whatever its listed share (the gate is not tested here)
    t = HK.pip_table(e, m, areal, grid, gate=False)
    assert (t.bits is None) == (t.edges.shape[0] > HK.EDGE_CHUNK)
    launches = HK.pip_dist.launches
    got = HK.pip_dist(b.x, b.y, t.edges, t.edge_mask, t.is_areal, cell=b.cell,
                      table=t)
    assert HK.pip_dist.launches == launches + 1
    want = HK.pip_dist_plain(b.x, b.y, e, m, areal)
    assert torch.equal(got, want)
    assert torch.equal(got, HK.pip_dist(b.x, b.y, e, m, areal))
    if t.bits is not None:
        assert torch.equal(HK.pip_table_fold_plain(b.x, b.y, b.cell, t), want)


def _table_points(card):
    """Random points over and beyond a 10 x 10 grid, points exactly on cell
    borders (and one f32 step either side), and 2,048 points of one cell
    on the border of two cells near the square's corner."""
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    rng = np.random.default_rng(31)
    xs = [rng.uniform(-1, 11, 6000)]
    ys = [rng.uniform(-1, 11, 6000)]
    border = np.arange(0.0, 10.5, 1.0)
    bx, by = np.meshgrid(border, np.linspace(0.0, 10.0, 97))
    for sx, sy in ((bx, by), (by, bx)):
        f = sx.ravel().astype(np.float32)
        for moved in (np.nextafter(f, np.float32(-np.inf)), f,
                      np.nextafter(f, np.float32(np.inf))):
            xs.append(moved.astype(np.float64))
            ys.append(sy.ravel())
    xs.append(np.full(2048, 2.0) + rng.choice([0, 1e-7, -1e-7, 3e-7], 2048))
    ys.append(rng.uniform(2.0, 2.0 + 1e-3, 2048))
    return grid, PointBatch.from_arrays(np.concatenate(xs), np.concatenate(ys),
                                        device=card, grid=grid)


@pytest.mark.cuda
def test_pip_dist_table_conf_coordinates(card):
    """The main path's polygon on the conf's grid, with points on its edges
    and a few ulps off them (cells from float64, as the ingest assigns)."""
    grid = UniformGrid(115.5, 117.6, 39.6, 41.1, num_grid_partitions=100)
    th = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    rr = 0.35 * (1.0 + 0.1 * np.sin(5.0 * th))
    ring = [(116.6 + a * float(np.cos(t)), 40.55 + a * float(np.sin(t)))
            for a, t in zip(rr, th)]
    poly = Polygon.create([ring + [ring[0]]], grid)
    e_np, m_np = single_query_edges(poly)
    e = e_np[:64]
    rng = np.random.default_rng(12)
    t = rng.random((64, 64))
    ex = (e[:, None, 0] + t * (e[:, None, 2] - e[:, None, 0])).ravel()
    ey = (e[:, None, 1] + t * (e[:, None, 3] - e[:, None, 1])).ravel()
    shift = rng.integers(-4, 5, ex.shape) * 7.6e-6
    x = np.concatenate([ex + shift, rng.uniform(115.4, 117.7, 50_000)])
    y = np.concatenate([ey - shift, rng.uniform(39.5, 41.2, 50_000)])
    b = PointBatch.from_arrays(x, y, device=card, grid=grid)
    tab = HK.pip_table(torch.from_numpy(e_np).to(card),
                       torch.from_numpy(m_np).to(card), True, grid,
                       gate=False)
    got = HK.pip_dist(b.x, b.y, tab.edges, tab.edge_mask, True, cell=b.cell,
                      table=tab)
    assert torch.equal(got, HK.pip_dist_plain(b.x, b.y, tab.edges,
                                              tab.edge_mask, True))


def _k1_inputs(card, n):
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    rng = np.random.default_rng(n)
    b = PointBatch.from_arrays(rng.uniform(-1, 11, n), rng.uniform(-1, 11, n),
                               device=card, grid=grid)
    return grid, b, rng


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 3, 16, 17])
@pytest.mark.parametrize("n", [4096, 4099, 1])
@pytest.mark.parametrize("approximate", [False, True])
def test_range_mask_query_counts_and_widths(card, q, n, approximate):
    """Every mode of K1 with Q queries over n points (n % 4 != 0 takes the
    scalar loads; n = 1 a batch with one valid slot; from 12 queries on
    the mask mode stages its cell codes), twice in a row (each launch
    zeroes its own counts): equal to the plain version, and each row to
    the single-query launch."""
    grid, b, rng = _k1_inputs(card, n)
    nn = b.capacity
    if n == 4099:  # an unpadded batch: n itself not a multiple of 4
        b = PointBatch(*(t[:n] for t in b))
        nn = n
    qx = rng.uniform(0, 10, q).astype(np.float32)
    qy = rng.uniform(0, 10, q).astype(np.float32)
    qc = np.array([grid.assign_cell(float(a), float(c))[0]
                   for a, c in zip(qx, qy)], np.int32)
    if q > 2:
        qc[1] = -1
    t = [torch.from_numpy(a).to(card) for a in (qx, qy, qc)]
    gl, cl = grid.guaranteed_layers(2.5), grid.candidate_layers(2.5)
    for _ in range(2):
        got = R.range_filter_point_multi_masks(
            b, *t, 2.5, gl, cl, n=grid.n, approximate=approximate)
        want = R.range_filter_point_multi_masks_plain(
            b, *t, 2.5, gl, cl, n=grid.n, approximate=approximate)
        assert _equal(got, want)
    for row in {0, q - 1}:
        one = R.range_filter_point_stats(
            b, float(qx[row]), float(qy[row]), int(qc[row]), 2.5, gl, cl,
            n=grid.n, approximate=approximate)
        bare = R.range_filter_point_stats(
            b, float(qx[row]), float(qy[row]), int(qc[row]), 2.5, gl, cl,
            n=grid.n, approximate=approximate, return_dists=False)
        plain = R.range_filter_point_stats_plain(
            b, float(qx[row]), float(qy[row]), int(qc[row]), 2.5, gl, cl,
            n=grid.n, approximate=approximate)
        assert _equal(one, plain) and bare[1] is None
        assert _equal(bare[::2] + bare[3:], plain[::2] + plain[3:])
        assert torch.equal(got[0][row], one[0])
    cells = [sorted(rng.choice(100, 3, replace=False).tolist())
             for _ in range(q)]
    gnm = torch.from_numpy(np.stack([grid.guaranteed_cells_mask(2.2, c)
                                     for c in cells])).to(card)
    cnm = torch.from_numpy(np.stack([grid.candidate_cells_mask(2.2, c)
                                     for c in cells])).to(card)
    d = torch.from_numpy(rng.uniform(0, 3, (q, nn)).astype(np.float32)
                         ).to(card)
    for _ in range(2):
        got = R.range_filter_masks_stats(b, gnm, cnm, d, 1.7,
                                         approximate=approximate)
        want = R.range_filter_masks_stats_plain(b, gnm, cnm, d, 1.7,
                                                approximate=approximate)
        assert _equal(got, want)
    one = R.range_filter_masks_stats(b, gnm[q - 1], cnm[q - 1], d[q - 1],
                                     1.7, approximate=approximate)
    assert torch.equal(got[0][q - 1], one[0])


@pytest.mark.cuda
def test_range_mask_counts_on_streams_and_graph_replay(card):
    """K1 zeroes its counts in every launch: launches on two streams and a
    CUDA graph replayed three times (over counts overwritten in between)
    each count as the plain version does."""
    grid, b, rng = _k1_inputs(card, 20_000)
    gl, cl = grid.guaranteed_layers(2.5), grid.candidate_layers(2.5)
    args = (b, 4.2, 5.7, int(grid.assign_cell(4.2, 5.7)[0]), 2.5, gl, cl)
    want = R.range_filter_point_stats_plain(*args, n=grid.n)
    side = torch.cuda.Stream()
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            got = R.range_filter_point_stats(*args, n=grid.n)
        torch.cuda.synchronize()
        assert _equal(got, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = R.range_filter_point_stats(*args, n=grid.n,
                                         return_dists=False)
    for _ in range(3):
        got[2].fill_(-7)
        graph.replay()
        torch.cuda.synchronize()
        assert _equal((got[0], got[2], got[3]),
                      (want[0], want[2], want[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [12, 17])
def test_range_mask_unstaged_cell_masks(card, q):
    """Mask mode over a grid whose (cells x query groups) code words do not
    fit the staged form's shared memory: each query gathers its mask bytes
    from device memory; the rows equal the plain version."""
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=160)
    rng = np.random.default_rng(q)
    b = PointBatch.from_arrays(rng.uniform(-1, 11, 9000),
                               rng.uniform(-1, 11, 9000), device=card,
                               grid=grid)
    assert grid.num_cells * 4 * ((q + 15) // 16) > 96 * 1024
    cells = [sorted(rng.choice(grid.num_cells, 4, replace=False).tolist())
             for _ in range(q)]
    gnm = torch.from_numpy(np.stack([grid.guaranteed_cells_mask(0.9, c)
                                     for c in cells])).to(card)
    cnm = torch.from_numpy(np.stack([grid.candidate_cells_mask(0.9, c)
                                     for c in cells])).to(card)
    d = torch.from_numpy(rng.uniform(0, 1.5, (q, b.capacity))
                         .astype(np.float32)).to(card)
    for approximate in (False, True):
        got = R.range_filter_masks_stats(b, gnm, cnm, d, 0.6,
                                         approximate=approximate)
        want = R.range_filter_masks_stats_plain(b, gnm, cnm, d, 0.6,
                                                approximate=approximate)
        assert _equal(got, want)


def _micro_batch(card, seed=41):
    """One realtime micro-batch: 512 points over and beyond the conf's bbox
    with ids from 100,000, compacted as the realtime kNN path does (and the
    same batch with its interned ids)."""
    grid = UniformGrid(115.5, 117.6, 39.6, 41.1, num_grid_partitions=100)
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(115.4, 117.7, 512), rng.uniform(39.5, 41.2, 512)
    x[:16], y[:16] = 116.51, 40.5  # 16 objects at one distance: ties
    oid = rng.integers(0, 100_000, 512)
    ids, local = np.unique(oid, return_inverse=True)
    compact = PointBatch.from_arrays(x, y, device=card, grid=grid,
                                     obj_id=local.reshape(-1))
    full = PointBatch.from_arrays(x, y, device=card, grid=grid, obj_id=oid)
    return grid, compact, full, ids


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k1-point", "k1-masks", "k4-table",
                                  "k4-dense", "k4-linestring", "k2-point",
                                  "k2-cells", "k4x"])
def test_micro_batch_kernels_equal_plain(card, case):
    """Every kernel of the realtime path at one 512-point micro-batch, bit
    for bit against its plain version; K2 over the compacted ids also
    equals the call over the interned ids once its ids are mapped back."""
    grid, b, full, ids = _micro_batch(card)
    q = (116.5, 40.5, int(grid.assign_cell(116.5, 40.5)[0]))
    r = 0.5
    gl, cl = grid.guaranteed_layers(r), grid.candidate_layers(r)
    poly = Polygon.create([[(116.6 + 0.35 * np.cos(t), 40.55 + 0.35 *
                             np.sin(t)) for t in np.linspace(
                                 0, 2 * np.pi, 65)[:-1]]], grid)
    e, m = (torch.from_numpy(a).to(card) for a in single_query_edges(poly))
    t = HK.pip_table(e, m, True, grid, gate=False)
    d = HK.pip_dist_plain(b.x, b.y, e, m, True)
    cells = sorted(poly.cells)
    if case == "k1-point":
        got = R.range_filter_point_stats(b, *q, r, gl, cl, n=grid.n,
                                         return_dists=False)
        want = R.range_filter_point_stats_plain(b, *q, r, gl, cl, n=grid.n,
                                                return_dists=False)
        assert got[1] is None and want[1] is None
        got, want = got[::2] + got[3:], want[::2] + want[3:]
    elif case == "k1-masks":
        gn = torch.from_numpy(grid.guaranteed_cells_mask(r, cells)).to(card)
        cn = torch.from_numpy(grid.candidate_cells_mask(r, cells)).to(card)
        got = R.range_filter_masks_stats(b, gn, cn, d, r)
        want = R.range_filter_masks_stats_plain(b, gn, cn, d, r)
    elif case.startswith("k4"):
        if case == "k4-linestring":
            line = LineString.create([(116.2, 40.2), (117.0, 40.2),
                                      (117.0, 40.9)], grid)
            e, m = (torch.from_numpy(a).to(card)
                    for a in single_query_edges(line))
            got = (HK.pip_dist(b.x, b.y, e, m, False),)
            want = (HK.pip_dist_plain(b.x, b.y, e, m, False),)
        else:
            kw = dict(cell=b.cell, table=t) if case == "k4-table" else {}
            got = (HK.pip_dist(b.x, b.y, t.edges, t.edge_mask, True, **kw),)
            want = (d,)
    elif case == "k4x":
        gb = EdgeGeomBatch.from_objects([poly, GEOMS["hole"]()], device=card)
        args = (b.x, b.y, gb.edges, gb.edge_mask, gb.is_areal)
        got = (HK.pip_lattice(*args, cell=b.cell, num_cells=grid.num_cells),)
        want = (HK.pip_lattice_plain(*args).T,)
    else:
        nb = torch.from_numpy(grid.neighboring_cells_mask(r, cells)).to(card)
        kw = (dict(mode=K.MODE_POINT, x=b.x, y=b.y, cell=b.cell,
                   valid=b.valid, n=grid.n, nb_layers=cl,
                   qx=torch.tensor([q[0]], dtype=torch.float32, device=card),
                   qy=torch.tensor([q[1]], dtype=torch.float32, device=card),
                   q_cell=torch.tensor([q[2]], dtype=torch.int32,
                                       device=card))
              if case == "k2-point" else
              dict(mode=K.MODE_CELLS, cell=b.cell, valid=b.valid,
                   dists=d[None], nb_mask=nb[None]))
        got = K.knn_topk(b.obj_id, k=50, num_ids=len(ids), **kw)
        want = K.knn_topk_plain(b.obj_id, k=50, num_ids=len(ids), **kw)
        wide = K.knn_topk(full.obj_id, k=50, num_ids=100_000, **kw)
        assert torch.equal(got[1], wide[1]) and torch.equal(got[2], wide[2])
        v = got[2][0].cpu().numpy()
        assert np.array_equal(ids[got[0][0].cpu().numpy()[v]],
                              wide[0][0].cpu().numpy()[v])
    assert _equal(got, want)


def _stream_geoms(grid, n=3000, seed=31):
    """A polygon/linestring window over the 10 x 10 grid: rings of 3-40
    edges (one above 32, so a lane owns two edges), walks, a polygon with a
    hole, a multi-polygon with one part far and one inside the query
    square, repeated vertices (zero-length edges) and a geometry outside
    the grid (no cell)."""
    rng = np.random.default_rng(seed)
    out = [Polygon.create([[(1, 1), (8, 1), (8, 8), (1, 8)],
                           [(3, 3), (5, 3), (5, 5)]], grid, "hole"),
           MultiPolygon.create([[[(9.0, 9.0), (9.5, 9.0), (9.5, 9.5)]],
                                [[(4.0, 4.0), (4.4, 4.0), (4.2, 4.4)]]],
                               grid, "multi"),
           Polygon.create([[(7, 7), (7, 7), (8, 7), (8, 8), (8, 8)]], grid,
                          "zero-length"),
           Polygon.create([[(11, 11), (12, 11), (12, 12)]], grid, "no-cell"),
           Polygon.create([_ring(40, 0.6)], grid, "forty")]
    for i in range(n - len(out)):
        cx, cy = rng.uniform(0.5, 9.5, 2)
        if i % 2:
            k = int(rng.integers(3, 33))
            th = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = rng.uniform(0.05, 0.8)
            ring = [(float(cx + r * np.cos(t)), float(cy + r * np.sin(t)))
                    for t in th]
            out.append(Polygon.create([ring], grid, f"p{i % 700}"))
        else:
            pts = np.cumsum(rng.normal(0, 0.3, (int(rng.integers(2, 9)), 2)),
                            axis=0) + (cx, cy)
            out.append(LineString.create([tuple(map(float, p)) for p in pts],
                                         grid, f"l{i % 700}"))
    return out


def _geom_queries(grid, q, large=False):
    """q query geometries: the square [2, 6]^2, a linestring, then rings
    (one of 1,301 edges, more than K5 stages, with ``large``)."""
    rng = np.random.default_rng(32)
    qs = [Polygon.create([[(2, 2), (6, 2), (6, 6), (2, 6)]], grid),
          LineString.create([(2.0, 8.0), (6.0, 8.5), (6.5, 9.5)], grid)]
    qs += [Polygon.create([[(float(x + 0.4 * np.cos(t)),
                             float(y + 0.4 * np.sin(t)))
                            for t in np.linspace(0, 2 * np.pi, 65)[:-1]]],
                          grid) for x, y in rng.uniform(1, 9, (q, 2))]
    if large:
        qs.insert(0, Polygon.create([_ring(1301, 2.5)], grid))
    return qs[:q]


def _k5_inputs(card, query, q, radius, large=False):
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    geoms = EdgeGeomBatch.from_objects(_stream_geoms(grid), device=card)
    if query == "point":
        rng = np.random.default_rng(33)
        qp = [Point.create(4.0, 4.0, grid)] + [
            Point.create(float(x), float(y), grid)
            for x, y in rng.uniform(0, 10, (q - 1, 2))]
        kw = dict(qx=torch.tensor([p.x for p in qp], dtype=torch.float32,
                                  device=card),
                  qy=torch.tensor([p.y for p in qp], dtype=torch.float32,
                                  device=card))
        cells = [[p.cell] for p in qp]
    else:
        qs = _geom_queries(grid, q, large)
        kw = dict(queries=EdgeGeomBatch.from_objects(qs, device=card,
                                                     pad=len(qs)))
        cells = [sorted(g.cells) for g in qs]
    gn = torch.from_numpy(np.stack([grid.guaranteed_cells_mask(radius, c)
                                    for c in cells])).to(card)
    nb = torch.from_numpy(np.stack([grid.neighboring_cells_mask(radius, c)
                                    for c in cells])).to(card)
    return geoms, gn, nb, kw


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 16])
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("mode", ["range", "knn"])
@pytest.mark.parametrize("query", ["point", "geometry"])
def test_geom_dist_kernel_equals_plain(card, query, mode, approximate, q):
    """K5 against its plain version: flags, counts and distances (+inf
    where the rule consults none) bit for bit; kNN through K2 too."""
    radius = 0.8
    geoms, gn, nb, kw = _k5_inputs(card, query, q, radius)
    m = G.MODE_RANGE if mode == "range" else G.MODE_KNN
    args = dict(mode=m, nb=nb, gn=gn if mode == "range" else None,
                radius=radius, approximate=approximate, **kw)
    launches = G.geom_stream_dist.launches
    got = G.geom_stream_dist(geoms, **args)
    assert G.geom_stream_dist.launches == launches + 1
    want = G.geom_stream_dist_plain(geoms, **args)
    assert _equal(got, want)
    assert int(want[2][:, 1].sum()) > 0 and bool(want[0].any())
    if mode == "knn":
        fn = (G.knn_geoms_to_point_queries if query == "point"
              else G.knn_geoms_to_geom_queries)
        qargs = ((kw["qx"], kw["qy"]) if query == "point"
                 else (kw["queries"],))
        res, evals = fn(geoms, *qargs, nb, k=10, approximate=approximate)
        wres = K.knn_topk_plain(geoms.obj_id, mode=K.MODE_ELIGIBLE, k=10,
                                num_ids=None, dists=want[1],
                                eligible=want[0])
        assert _equal((*res, evals), wres)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["range", "knn"])
def test_geom_dist_query_above_staging(card, mode):
    """A 1,301-edge query polygon (above K5's 1,024 staged edges: read
    from device memory) with 3 other queries."""
    geoms, gn, nb, kw = _k5_inputs(card, "geometry", 4, 0.8, large=True)
    assert kw["queries"].edges.shape[1] > G.QUERY_CHUNK
    m = G.MODE_RANGE if mode == "range" else G.MODE_KNN
    args = dict(mode=m, nb=nb, gn=gn if mode == "range" else None,
                radius=0.8, **kw)
    assert _equal(G.geom_stream_dist(geoms, **args),
                  G.geom_stream_dist_plain(geoms, **args))


@pytest.mark.cuda
def test_geom_dist_argument_checks(card):
    geoms, gn, nb, kw = _k5_inputs(card, "point", 2, 0.8)
    with pytest.raises(ValueError, match="on cpu"):
        G.geom_stream_dist(geoms, mode=G.MODE_RANGE, gn=gn, nb=nb.cpu(),
                           **kw)
    with pytest.raises(ValueError, match="on cpu"):
        G.geom_stream_dist(geoms, mode=G.MODE_KNN, nb=nb,
                           qx=kw["qx"].cpu(), qy=kw["qy"])
    with pytest.raises(TypeError, match="needs torch.float32"):
        G.geom_stream_dist(geoms, mode=G.MODE_KNN, nb=nb,
                           qx=kw["qx"].double(), qy=kw["qy"])
    with pytest.raises(TypeError, match="needs torch.bool"):
        G.geom_stream_dist(geoms, mode=G.MODE_KNN, nb=nb.to(torch.uint8),
                           **kw)
    with pytest.raises(TypeError, match="needs torch.int32"):
        G.geom_stream_dist(geoms._replace(cells=geoms.cells.long()),
                           mode=G.MODE_KNN, nb=nb, **kw)


@pytest.mark.cuda
def test_from_jax_arrays_carries_a_stream_geom_batch(card):
    """A stream-side EdgeGeomBatch as the JAX package holds it (host
    arrays: float64 coordinates, int64 ids) crosses to the card in the
    port's dtypes, and K5 over it equals K5 over the port's own batch."""
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    own = EdgeGeomBatch.from_objects(_stream_geoms(grid, n=500),
                                     device=torch.device("cpu"))
    fields = {k: v.numpy().astype(np.float64 if v.is_floating_point()
                                  else np.int64 if v.dtype == torch.int32
                                  else bool)
              for k, v in own._asdict().items()}
    carried, _ = from_jax_arrays(fields, card)
    assert isinstance(carried, EdgeGeomBatch)
    for name, t in carried._asdict().items():
        assert t.device.type == "cuda"
        assert t.dtype == getattr(own, name).dtype, name
        assert torch.equal(t.cpu(), getattr(own, name)), name
    nb = torch.ones((1, grid.num_cells), dtype=torch.bool, device=card)
    kw = dict(mode=G.MODE_KNN, nb=nb,
              qx=torch.tensor([4.0], device=card),
              qy=torch.tensor([4.0], device=card))
    own_card = EdgeGeomBatch(*(t.to(card) for t in own))
    assert _equal(G.geom_stream_dist(carried, **kw),
                  G.geom_stream_dist(own_card, **kw))
