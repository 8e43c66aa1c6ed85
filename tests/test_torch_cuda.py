"""K4 (dense and with its per-cell edge table), K4x (in stream and in cell
order, with its pruning edge cases), the cell order, K1 (single and with a
query axis of 1, 3, 16 and 17, vector and scalar loads), K2 (with its
overflow and tie cases) and K5 (the geometry-stream distance: range and kNN
mode, point and geometry queries, exact and approximate, 1 and 16 queries,
a query of more edges than it stages, 1, 3, 16 and 17 queries, windows
padded to 8, 16, 32 and 40 edges, rows of padded edges only, an empty
window, geometries inside and around an areal query, near-ties and pairs
at the pair skip's margin, its counts on a side stream and under CUDA-graph
replay), K7 and K6 (over the join index: every b point at one spot over
three tiles, so units of 4,096 partners; clustered sides; a 32,767-cell
grid whose index sorts each tile on its own; K7's -1 corner; equal d^2
in different cells; layers 0, 1, >= n and 2^30; with and without rows)
and the join index itself against their plain PyTorch versions on the
card, bit for bit.

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
@pytest.mark.parametrize("k", [1, 10, 50, 1024, 1025, 2048, 4096])
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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 50, 1025, 2048, 4096])
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
@pytest.mark.parametrize("n,ids,k", [(100_000, 100_000, 1024),
                                     (100_000, 100_000, 4096),
                                     (6_000, 3_000, 50), (3_000, 30, 50),
                                     (3_000, 1_000, 2048)])
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
@pytest.mark.parametrize("q", [1, 3, 16, 17])
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


def _k5_equal(card, geoms, kw, gn, nb, radius=0.8, approximate=False):
    """K5 against its plain version in range and kNN mode, with the grid's
    masks and with every geometry consulted (no guaranteed cell, every
    cell a neighbour)."""
    everywhere = (torch.zeros_like(gn), torch.ones_like(nb))
    for g_mask, n_mask in ((gn, nb), everywhere):
        for mode in (G.MODE_RANGE, G.MODE_KNN):
            args = dict(mode=mode, nb=n_mask, radius=radius,
                        gn=g_mask if mode == G.MODE_RANGE else None,
                        approximate=approximate, **kw)
            got = G.geom_stream_dist(geoms, **args)
            want = G.geom_stream_dist_plain(geoms, **args)
            assert _equal(got, want), (mode, approximate)


def _fitted_geoms(grid, e, n=1500, seed=51):
    """n polygons and linestrings of at most ``e`` edges over the 10 x 10
    grid, with geometries inside, around and crossing the query square
    [2, 6]^2 and a multi-polygon with a part inside it."""
    rng = np.random.default_rng(seed + e)
    most = min(e, 32)
    out = [Polygon.create([_sq_ring(3.0, 3.0, 3.5, 3.5)], grid, "inside"),
           Polygon.create([_sq_ring(1.0, 1.0, 7.0, 7.0)], grid, "around"),
           Polygon.create([_sq_ring(5.0, 5.0, 7.0, 7.0)], grid, "across"),
           LineString.create([(2.5, 2.5), (3.0, 4.0)], grid, "line-inside"),
           MultiPolygon.create([[[(9.0, 9.0), (9.5, 9.0), (9.5, 9.5)]],
                                [[(4.0, 4.0), (4.4, 4.0), (4.2, 4.4)]]],
                               grid, "multi")]
    for i in range(n - len(out)):
        cx, cy = rng.uniform(0.5, 9.5, 2)
        if i % 2:
            k = int(rng.integers(3, most + 1))
            th = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = rng.uniform(0.02, 0.8)
            ring = [(float(cx + r * np.cos(t)), float(cy + r * np.sin(t)))
                    for t in th]
            out.append(Polygon.create([ring], grid, f"p{i}"))
        else:
            pts = np.cumsum(rng.normal(0, 0.3, (int(rng.integers(
                2, most + 2)), 2)), axis=0) + (cx, cy)
            out.append(LineString.create([tuple(map(float, p)) for p in pts],
                                         grid, f"l{i}"))
    if e > 32:  # one geometry of more edges than a warp has lanes
        out.append(Polygon.create([_ring(e, 0.7)], grid, "wide"))
    return out


def _sq_ring(x0, y0, x1, y1):
    return [(x0, y0), (x1, y0), (x1, y1), (x0, y1), (x0, y0)]


def _masks(grid, cells, radius, card):
    return tuple(torch.from_numpy(np.stack([f(radius, c) for c in cells]))
                 .to(card) for f in (grid.guaranteed_cells_mask,
                                     grid.neighboring_cells_mask))


@pytest.mark.cuda
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("query", ["point", "geometry"])
@pytest.mark.parametrize("e", [8, 16, 32, 40])
def test_geom_dist_edge_widths_equal_plain(card, e, query, approximate):
    """Windows padded to 8, 16, 32 and 40 edges (K5 serves a geometry with
    8, 16 or 32 lanes; 40 gives a lane two edges), with rows whose edges
    are all padding, against 3 queries."""
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    geoms = EdgeGeomBatch.from_objects(_fitted_geoms(grid, e), device=card,
                                       edge_pad=e)
    assert geoms.edges.shape[1] == e
    mask = geoms.edge_mask.clone()
    mask[7::97] = False  # valid geometries without a valid edge
    geoms = geoms._replace(edge_mask=mask)
    if query == "point":
        pts = [Point.create(4.0, 4.0, grid), Point.create(2.0, 6.0, grid),
               Point.create(8.3, 1.7, grid)]
        kw = dict(qx=torch.tensor([p.x for p in pts], device=card),
                  qy=torch.tensor([p.y for p in pts], device=card))
        cells = [[p.cell] for p in pts]
    else:
        qs = _geom_queries(grid, 3)
        kw = dict(queries=EdgeGeomBatch.from_objects(qs, device=card,
                                                     pad=len(qs)))
        cells = [sorted(g.cells) for g in qs]
    gn, nb = _masks(grid, cells, 0.8, card)
    _k5_equal(card, geoms, kw, gn, nb, approximate=approximate)


@pytest.mark.cuda
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("query", ["point", "geometry"])
def test_geom_dist_large_window_equals_plain(card, query, approximate):
    """A window of 48,000 geometries (the 3,000 of ``_stream_geoms`` 16
    times): K5 takes tiles of more geometries than a block has groups,
    whose groups take the consulted geometries from a list."""
    geoms, gn, nb, kw = _k5_inputs(card, query, 3, 0.8)
    geoms = EdgeGeomBatch(*(torch.cat([t] * 16) for t in geoms))
    _k5_equal(card, geoms, kw, gn, nb, approximate=approximate)


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["point", "geometry"])
def test_geom_dist_empty_window(card, query):
    """G = 0: no flags or distances, and counts of 0 for every query."""
    geoms, gn, nb, kw = _k5_inputs(card, query, 3, 0.8)
    empty = EdgeGeomBatch(*(t[:0].contiguous() for t in geoms))
    for mode in (G.MODE_RANGE, G.MODE_KNN):
        args = dict(mode=mode, nb=nb, gn=gn if mode == G.MODE_RANGE
                    else None, radius=0.8, **kw)
        flag, dist, counts = G.geom_stream_dist(empty, **args)
        assert flag.shape == (3, 0) and dist.shape == (3, 0)
        assert torch.equal(counts, torch.zeros_like(counts))
        assert _equal((flag, dist, counts),
                      G.geom_stream_dist_plain(empty, **args))


@pytest.mark.cuda
def test_geom_dist_near_ties_and_skip_margin(card):
    """Geometries whose distances to two query edges tie within one ulp
    (midway between the arms of a U-shaped linestring query, moved by 0-2
    ulps), and geometries at a few skip margins from a query edge's box
    (where the box bound and the running min meet), against a linestring
    and a polygon query, every geometry consulted."""
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    rng = np.random.default_rng(61)
    margin = HK.distance_skip_margin(10.0)
    objs = []
    for i in range(400):
        y = float(rng.uniform(1.0, 9.0))
        x = float(np.float32(4.0) + np.float32(i % 5 - 2)
                  * np.spacing(np.float32(4.0)))
        h = float(rng.choice([0.0, 1e-6, 0.01]))
        objs.append(Polygon.create([[(x, y), (x + h, y + h), (x, y + 2 * h)]]
                                   if h else [[(x, y), (x, y), (x, y)]],
                                   grid, f"t{i}"))
    for i in range(800):
        x0, y0, x1, y1 = (6.0, 0.5, 6.0, 9.5) if i % 2 else (2.0, 9.5,
                                                             6.0, 9.5)
        t = rng.uniform(-0.05, 1.05)
        px, py = x0 + t * (x1 - x0), y0 + t * (y1 - y0)
        off = rng.uniform(-1, 1, (3, 2)) * margin * rng.choice([1, 4, 16])
        ring = [(float(px + dx), float(py + dy)) for dx, dy in off]
        objs.append(Polygon.create([ring], grid, f"m{i}") if i % 3
                    else LineString.create(ring, grid, f"m{i}"))
    geoms = EdgeGeomBatch.from_objects(objs, device=card)
    qs = [LineString.create([(2.0, 0.5), (2.0, 9.5), (6.0, 9.5), (6.0, 0.5)],
                            grid),
          Polygon.create([_sq_ring(2.0, 0.5, 6.0, 9.5)], grid)]
    kw = dict(queries=EdgeGeomBatch.from_objects(qs, device=card, pad=2))
    gn, nb = _masks(grid, [sorted(g.cells) for g in qs], 0.8, card)
    _k5_equal(card, geoms, kw, gn, nb)


@pytest.mark.cuda
def test_geom_dist_counts_on_streams_and_graph_replay(card):
    """K5 zeroes its counts inside the launch: launches on two streams and
    a CUDA graph replayed three times (over counts overwritten in between)
    each count as the plain version does."""
    geoms, gn, nb, kw = _k5_inputs(card, "geometry", 3, 0.8)
    args = dict(mode=G.MODE_RANGE, gn=gn, nb=nb, radius=0.8, **kw)
    want = G.geom_stream_dist_plain(geoms, **args)
    side = torch.cuda.Stream()
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            got = G.geom_stream_dist(geoms, **args)
        torch.cuda.synchronize()
        assert _equal(got, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = G.geom_stream_dist(geoms, **args)
    for _ in range(3):
        got[2].fill_(-7)
        graph.replay()
        torch.cuda.synchronize()
        assert _equal(got, want)


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


# ------------------------------------------------------------------------ #
# K6 (join lattice) and K7 (join_reduce)


def _join_batches(dev, na, nb, seed=3, *, spread=0.6, same=False,
                  invalid_a=False):
    """Two point batches on a 10 x 10 grid over [0, 10)^2 with points
    outside it (cell -1), exact capacities; ``same``: every b point at one
    spot (every distance equal), ``invalid_a``: no valid a row."""
    from spatialflink_tpu_torch.ops import join as J  # noqa: F401

    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    rng = np.random.default_rng(seed)

    def batch(n, at=None):
        x = rng.uniform(-0.5, 10.5, n) if at is None else np.full(n, at[0])
        y = rng.uniform(-0.5, 10.5, n) if at is None else np.full(n, at[1])
        # a share on a coarse lattice: exact ties among distances
        k = n // 4
        x[:k] = np.round(x[:k] * 4) / 4
        y[:k] = np.round(y[:k] * 4) / 4
        b = PointBatch.from_arrays(x, y, device=dev, grid=grid)
        keep = rng.random(b.valid.shape[0]) > 0.1
        return b._replace(valid=b.valid & torch.from_numpy(keep).to(dev))

    a = batch(na)
    if invalid_a:
        a = a._replace(valid=torch.zeros_like(a.valid))
    b = batch(nb, (4.3, 5.1) if same else None)
    return grid, a, b, spread


JOIN_CASES = {
    "small": dict(na=300, nb=77),
    "odd": dict(na=1000, nb=5000),      # b not a multiple of the tile
    "tiles": dict(na=2048, nb=9000),
    "same": dict(na=600, nb=3000, same=True),
    "invalid-a": dict(na=500, nb=700, invalid_a=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(JOIN_CASES))
@pytest.mark.parametrize("layers", [1, 3, 10, 2 ** 30])
def test_join_reduce_kernel_equals_plain(card, case, layers):
    from spatialflink_tpu_torch.ops import join as J

    _, a, b, r = _join_batches(card, **JOIN_CASES[case])
    got = J.join_reduce(a, b, r, layers, n=10)
    want = J.join_reduce_plain(a, b, r, layers, n=10)
    torch.cuda.synchronize()
    assert _equal(got, want)
    if case == "same":
        assert (got[0] > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(JOIN_CASES))
@pytest.mark.parametrize("layers,tile", [(1, 4096), (3, 4096), (10, 1000),
                                         (2 ** 30, 4096), (3, 64)])
@pytest.mark.parametrize("with_rows", [False, True])
def test_join_lattice_kernel_equals_plain(card, case, layers, tile,
                                          with_rows):
    from spatialflink_tpu_torch.ops import join as J

    _, a, b, r = _join_batches(card, **JOIN_CASES[case])
    rows = None
    if with_rows:
        cnt, _, _ = J.join_reduce_plain(a, b, r + 0.01, layers, n=10)
        rows = torch.nonzero(cnt > 0).reshape(-1).to(torch.int32)
    got = J.join_lattice(a, b, r, layers, 5.0, 5.0, n=10, tile=tile,
                         rows=rows)
    want = J.join_lattice_plain(a, b, r, layers, 5.0, 5.0, n=10, tile=tile,
                                rows=rows)
    torch.cuda.synchronize()
    assert _equal(got, want)
    if case != "invalid-a":
        assert got[0].numel() > 0


def _exact(dev, x, y, grid, valid=None):
    """A point batch of exactly these points (no padded slots)."""
    b = PointBatch.from_arrays(x, y, device=dev, grid=grid)
    b = type(b)(*(t[:len(x)] for t in b))
    if valid is not None:
        b = b._replace(valid=b.valid & torch.from_numpy(valid).to(dev))
    return b


def _index_case(dev, case):
    """``(grid, a, b, radius)`` of the join index cases: ``same-wide``
    (every b point at one spot, all valid, over three tiles: units of 4,096
    partners), ``clustered`` (both sides Gaussian, sigma 0.3 cells, as taxi
    traces bunch downtown), ``grid-32767`` (a 32,767-cell grid, points
    spread over it and bunched in one corner block, b over three tiles
    and then some: the index sorts each tile on its own), ``corner`` (a
    and b around cell (0, n - 1), many outside the grid: K7's -1 is
    (-1, n - 1)), ``ties`` (a on cell corners, b at the four half-cell
    offsets of each: equal d^2 in four cells, in shuffled b order) and
    ``grid-2048`` (a 2,048-cell grid over three tiles: a stride of its own
    but no start table, whose runs come from binary search)."""
    from spatialflink_tpu_torch.index import UniformGrid as Grid

    grid = Grid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    rng = np.random.default_rng(17)
    if case == "same-wide":
        a = _exact(dev, rng.uniform(3.5, 5.0, 600),
                   rng.uniform(4.5, 5.8, 600), grid)
        b = _exact(dev, np.full(9000, 4.3), np.full(9000, 5.1), grid)
        return grid, a, b, 0.6
    if case == "clustered":
        def pts(k):
            return _exact(dev, rng.normal(4.3, 0.3, k),
                          rng.normal(5.1, 0.3, k), grid, rng.random(k) > 0.1)
        return grid, pts(3000), pts(5000), 0.1
    if case == "grid-32767":
        big = Grid(0.0, 32767.0, 0.0, 32767.0, num_grid_partitions=32767)

        def pts(k):
            x = rng.uniform(0.0, 32767.0, k)
            y = rng.uniform(0.0, 32767.0, k)
            m = 2 * k // 5
            x[:m] = rng.uniform(20.0, 70.0, m)
            y[:m] = rng.uniform(32700.0, 32767.5, m)
            return _exact(dev, x, y, big, rng.random(k) > 0.05)
        return big, pts(5000), pts(3 * 4096 + 77), 1.5
    if case == "grid-2048":
        g = Grid(0.0, 2048.0, 0.0, 2048.0, num_grid_partitions=2048)

        def pts(k):
            x = rng.uniform(0.0, 2048.0, k)
            y = rng.uniform(0.0, 2048.0, k)
            m = k // 2
            x[:m] = rng.uniform(1000.0, 1040.0, m)
            y[:m] = rng.uniform(2010.0, 2048.5, m)
            return _exact(dev, x, y, g, rng.random(k) > 0.05)
        return g, pts(4000), pts(2 * 4096 + 300), 1.5
    if case == "corner":
        def pts(k):
            return _exact(dev, rng.uniform(-0.7, 0.7, k),
                          rng.uniform(8.8, 10.2, k), grid,
                          rng.random(k) > 0.05)
        return grid, pts(400), pts(700), 0.5
    assert case == "ties"
    corners = np.array([(i, j) for i in range(1, 10) for j in range(1, 10)],
                       dtype=np.float64)
    offs = np.array([(-0.5, 0.0), (0.5, 0.0), (0.0, -0.5), (0.0, 0.5)])
    bxy = (corners[:, None, :] + offs[None, :, :]).reshape(-1, 2)
    bxy = np.concatenate([bxy, [(-0.5, 9.5), (10.25, 1.0)]])
    bxy = bxy[rng.permutation(bxy.shape[0])]
    axy = np.concatenate([corners, [(-0.25, 9.75)]])
    return (grid, _exact(dev, axy[:, 0], axy[:, 1], grid),
            _exact(dev, bxy[:, 0], bxy[:, 1], grid,
                   rng.random(bxy.shape[0]) > 0.05), 0.5)


INDEX_CASES = ("same-wide", "clustered", "grid-32767", "grid-2048",
               "corner", "ties")


@pytest.mark.cuda
@pytest.mark.parametrize("case", INDEX_CASES + ("small",))
@pytest.mark.parametrize("tile", [4096, 64])
def test_join_index_kernel_equals_plain(card, case, tile):
    """The join index (cell_order.cu's join_index_launch) against its
    plain version (the composite key through cell_order_plain)."""
    from spatialflink_tpu_torch.ops import join as J

    if case == "small":
        grid, _, b, _ = _join_batches(card, **JOIN_CASES["small"])
    else:
        grid, _, b, _ = _index_case(card, case)
    launches = HK.cell_order.launches
    got = J.join_index(b, grid.n, tile)
    want = J.join_index_plain(b, grid.n, tile)
    torch.cuda.synchronize()
    assert HK.cell_order.launches > launches
    assert (got.tile, got.stride) == (want.tile, want.stride)
    assert _equal(tuple(got[:4]), tuple(want[:4]))
    assert (got.starts is None) == (want.starts is None)
    if want.starts is not None:
        assert torch.equal(got.starts, want.starts)
    if case == "grid-32767" and tile == 4096:
        assert got.stride == 0  # four tiles would overflow an int32 key
    if case.startswith("grid-"):
        assert got.starts is None  # over the start table's cap


@pytest.mark.cuda
@pytest.mark.parametrize("case", INDEX_CASES)
@pytest.mark.parametrize("layers", [0, 1, 12, 2 ** 30])
def test_join_reduce_over_index_equals_plain(card, case, layers):
    from spatialflink_tpu_torch.ops import join as J

    grid, a, b, r = _index_case(card, case)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    before = torch.cuda.memory_allocated(card)
    got = J.join_reduce(a, b, r, layers, n=grid.n)
    torch.cuda.synchronize()
    # nothing in proportion to n^2 (4 GB of int32 at n = 32,767)
    assert torch.cuda.max_memory_allocated(card) - before < 64 << 20
    want = J.join_reduce_plain(a, b, r, layers, n=grid.n)
    torch.cuda.synchronize()
    assert _equal(got, want)
    if layers:
        assert (got[0] > 0).any()
    if case == "ties" and layers:
        assert (got[0] >= 4).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", INDEX_CASES)
@pytest.mark.parametrize("layers", [0, 1, 12, 2 ** 30])
@pytest.mark.parametrize("with_rows", [False, True])
def test_join_lattice_over_index_equals_plain(card, case, layers, with_rows):
    from spatialflink_tpu_torch.ops import join as J

    grid, a, b, r = _index_case(card, case)
    cx, cy = J.grid_center(grid)
    rows = None
    if with_rows:
        cnt, _, _ = J.join_reduce_plain(a, b, r + 0.01, layers, n=grid.n)
        rows = torch.nonzero(cnt > 0).reshape(-1).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    before = torch.cuda.memory_allocated(card)
    got = J.join_lattice(a, b, r, layers, cx, cy, n=grid.n, rows=rows)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(card) - before
    want = J.join_lattice_plain(a, b, r, layers, cx, cy, n=grid.n, rows=rows)
    torch.cuda.synchronize()
    assert _equal(got, want)
    pairs = int(got[0].numel())
    assert peak < (64 << 20) + pairs * 8
    if layers:
        assert pairs > 0
    if case == "same-wide" and layers:
        # units of 4,096 partners (tile 0) and of 808 (tile 2)
        ai, bi = (t.cpu().numpy() for t in got)
        first = ai[bi < 4096]
        per_row = np.bincount(first)
        assert per_row.max() == 4096
        assert (np.bincount(ai[bi >= 8192]).max()) == 9000 - 8192


@pytest.mark.cuda
def test_join_pairs_host_branches_agree_on_card(card):
    """Above the lattice budget (K7, then K6 on the rows with partners) and
    below it (K6 alone): the pairs of the direct branch, in order."""
    from spatialflink_tpu_torch.ops import join as J

    grid, a, b, r = _join_batches(card, 4000, 3000)
    direct = J.join_pairs_host(a, b, r, grid, lattice_budget=1 << 40)
    launches = J.join_reduce.launches
    pruned = J.join_pairs_host(a, b, r, grid, lattice_budget=1)
    assert J.join_reduce.launches == launches + 1
    assert all(np.array_equal(u, v) for u, v in zip(direct, pruned))
    assert direct[0].size > 0


@pytest.mark.cuda
@pytest.mark.parametrize("option", [101, 121])
def test_join_option_on_card_equals_cpu(card, option):
    """One run of option 101 (points x points) and 121 (polygons x
    polygons) on the card and on the CPU: the same pairs in each window."""
    import json as _json
    import os

    from spatialflink_tpu_torch import driver as TD
    from spatialflink_tpu_torch.config import Params

    conf = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "conf", "spatialflink-conf.yml")
    rng = np.random.default_rng(option)
    t0 = 1_700_000_000_000

    def points(n, prefix):
        x = rng.uniform(115.5, 117.6, n)
        y = rng.uniform(39.6, 41.1, n)
        ts = t0 + np.sort(rng.integers(0, 20_000, n))
        return [f"{prefix}{i % 50},{t},{u!r},{v!r}" for i, (t, u, v) in
                enumerate(zip(ts.tolist(), x.tolist(), y.tolist()))]

    def polygons(n, prefix):
        out = []
        for i, t in enumerate(np.sort(rng.integers(0, 20_000, n)).tolist()):
            cx, cy = rng.uniform(115.6, 117.5), rng.uniform(39.7, 41.0)
            th = np.sort(rng.uniform(0, 2 * np.pi, 6))
            ring = [[cx + 0.01 * np.cos(a), cy + 0.01 * np.sin(a)]
                    for a in th]
            out.append(_json.dumps({"geometry": {
                "type": "Polygon", "coordinates": [ring + [ring[0]]]},
                "properties": {"oID": f"{prefix}{i}", "timestamp": t0 + t},
                "type": "Feature"}))
        return out

    p = Params.from_yaml(conf)
    p.query.option = option
    p.query.radius = 0.02
    fmt = "CSV" if option == 101 else "GeoJSON"
    import dataclasses
    p = dataclasses.replace(
        p, input1=dataclasses.replace(p.input1, format=fmt),
        input2=dataclasses.replace(p.input2, format=fmt))
    make = points if option == 101 else polygons
    s1, s2 = make(20_000 if option == 101 else 3_000, "a"), make(2_000, "b")

    def run(device):
        return [(w.window_start, w.window_end,
                 [(x.obj_id, x.timestamp, y.obj_id, y.timestamp)
                  for x, y in w.records])
                for w in TD.run_option(p, iter(s1), iter(s2), device=device)]

    got, want = run("cuda"), run("cpu")
    assert got == want and sum(len(w[2]) for w in want) > 0


def _merge_inputs(dev, P, Q, k, seed, ids, dists=None, p_valid=0.8):
    rng = np.random.default_rng(seed)
    oid = rng.integers(0, ids, (P, Q, k)).astype(np.int32)
    d = (rng.uniform(0.0, 1.0, (P, Q, k)) if dists is None
         else rng.choice(np.asarray(dists), (P, Q, k))).astype(np.float32)
    v = rng.random((P, Q, k)) < p_valid
    oid = np.where(v, oid, K._OID_SENTINEL).astype(np.int32)
    d = np.where(v, d, np.float32(K._BIG)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (oid, d, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("P,Q,k,ids,dists,p_valid", [
    (1, 1, 1, 2, None, 0.8), (2, 1, 50, 100, None, 0.8),
    (3, 5, 7, 9, None, 0.8), (10, 16, 50, 300, None, 0.8),
    (20, 2, 50, 800, None, 0.9), (21, 2, 50, 800, None, 0.9),  # 1,024 +
    (4, 1, 1024, 3000, None, 0.8), (60, 1, 100, 2000, None, 0.8),
    (9, 17, 13, 40, [0.25, 0.5], 0.8),                # ties
    (7, 4, 50, 30, None, 1.0),                         # duplicates
    (5, 3, 20, 100, None, 0.0),                        # all invalid
    (16, 2, 1024, 20_000, [0.1, 0.2, 0.3], 0.8),       # 16 blocks a row
    (100, 3, 100, 6000, None, 0.9),                    # 10,000 a row
    (300, 2, 100, 9000, None, 0.9),                    # pointer table
    (70, 3, 8, 400, None, 0.9),                   # the table, one block
    (3, 2, 1025, 4000, None, 0.9),                     # k > 1,024
    (10, 1, 2048, 30_000, [0.1, 0.2, 0.3], 0.9),       # 20,480 a row
    (2, 3, 2048, 3000, None, 0.8),                     # k > ids
])
def test_knn_merge_kernel_equals_plain(card, P, Q, k, ids, dists, p_valid):
    """K3 against its plain version bit for bit, every field, through the
    stacked entry and the parts entry ((Q, k) and (k,) partials): odd
    shapes, unsorted pane lists (random ids and distances), ties at the
    k-th place, ids in many panes, all-invalid rows, rows wider than one
    block, more panes than the kernel's parameters hold, k > 1,024."""
    oid, d, v = _merge_inputs(card, P, Q, k, P * 7 + k, ids, dists, p_valid)
    launches = K.knn_merge.launches
    got = K.knn_merge(oid, d, v, k)
    want = K.merge_topk_stacked_plain(oid, d, v, k)
    torch.cuda.synchronize()
    assert K.knn_merge.launches == launches + 1
    assert got.obj_id.shape == (Q, k)
    assert _equal(got, want)
    parts = [K.KnnResult(oid[p], d[p], v[p]) for p in range(P)]
    assert _equal(K.knn_merge_parts(parts, k), want)
    one = K.knn_merge_parts([K.KnnResult(*(t[0] for t in r))
                             for r in parts], k)
    assert one.obj_id.shape == (k,)
    assert _equal(one, K.KnnResult(*(t[0] for t in want)))
    assert K.knn_merge.launches == launches + 3


@pytest.mark.cuda
@pytest.mark.parametrize("P,k,num_ids", [(2, 50, 100_000), (10, 50, 3_000),
                                         (4, 1025, 3_000), (2, 2048, 3_000),
                                         (10, 2048, 100_000)])
def test_knn_merge_of_k2_partials_equals_plain(card, P, k, num_ids):
    """K3 over partials of real K2 launches (sorted, unique ids, valid
    slots first), 16 queries, one pane per seed: the parts entry against
    the plain version, and against one K2 launch over all panes' points
    (the pane merge's covering argument)."""
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    rng = np.random.default_rng(P + k)
    qx = torch.from_numpy(rng.uniform(0, 10, 16).astype(np.float32)).to(card)
    qy = torch.from_numpy(rng.uniform(0, 10, 16).astype(np.float32)).to(card)
    qc = torch.tensor([int(grid.assign_cell(float(a), float(c))[0])
                       for a, c in zip(qx.tolist(), qy.tolist())],
                      dtype=torch.int32, device=card)
    xs, ys, ids = (rng.uniform(-1, 11, (P, 20_000)),
                   rng.uniform(-1, 11, (P, 20_000)),
                   rng.integers(0, num_ids, (P, 20_000)).astype(np.int32))
    kw = dict(mode=K.MODE_POINT, k=k, num_ids=num_ids, qx=qx, qy=qy,
              q_cell=qc, n=grid.n, nb_layers=2)
    parts = []
    for p in range(P):
        b = PointBatch.from_arrays(xs[p], ys[p], device=card, grid=grid,
                                   obj_id=ids[p])
        parts.append(K.KnnResult(*K.knn_topk(
            b.obj_id, x=b.x, y=b.y, cell=b.cell, valid=b.valid, **kw)[:3]))
    want = K.merge_topk_stacked_plain(
        *(torch.stack([getattr(r, f) for r in parts])
          for f in K.KnnResult._fields), k)
    launches = K.knn_merge.launches
    got = K.knn_merge_parts(parts, k)
    torch.cuda.synchronize()
    assert K.knn_merge.launches == launches + 1
    assert _equal(got, want)
    b = PointBatch.from_arrays(xs.reshape(-1), ys.reshape(-1), device=card,
                               grid=grid, obj_id=ids.reshape(-1))
    whole = K.knn_topk(b.obj_id, x=b.x, y=b.y, cell=b.cell, valid=b.valid,
                       **kw)
    assert _equal(got, whole[:3])


def _pane_lines(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(115.5, 117.6, n)
    y = rng.uniform(39.6, 41.1, n)
    ts = 1_700_000_000_000 + np.sort(rng.integers(0, 30_000, n))
    back = rng.random(n) < 0.03
    ts[back] -= rng.integers(200, 3_000, int(back.sum()))
    return [f"o{o},{t},{a!r},{b!r}" for o, t, a, b in
            zip(rng.integers(0, 400, n).tolist(), ts.tolist(), x.tolist(),
                y.tolist())]


def _pane_polygons(n, seed):
    import json as _json

    rng = np.random.default_rng(seed)
    out = []
    for i, t in enumerate(np.sort(rng.integers(0, 30_000, n)).tolist()):
        cx, cy = rng.uniform(115.6, 117.5), rng.uniform(39.7, 41.0)
        th = np.sort(rng.uniform(0, 2 * np.pi, 6))
        ring = [[float(cx + 0.01 * np.cos(a)), float(cy + 0.01 * np.sin(a))]
                for a in th]
        out.append(_json.dumps({"geometry": {
            "type": "Polygon", "coordinates": [ring + [ring[0]]]},
            "properties": {"oID": f"g{i % 300}",
                           "timestamp": 1_700_000_000_000 + t},
            "type": "Feature"}))
    return out


def _card_params(option, fmt, **query):
    import dataclasses
    import os

    from spatialflink_tpu_torch.config import Params

    conf = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "conf", "spatialflink-conf.yml")
    p = Params.from_yaml(conf)
    p.query.option = option
    for key, val in query.items():
        setattr(p.query, key, val)
    return dataclasses.replace(
        p, input1=dataclasses.replace(p.input1, format=fmt))


def _knn_lists_close(got, want):
    assert [w[:2] for w in got] == [w[:2] for w in want]
    assert sum(len(q) for w in want for q in w[2]) > 0
    for g, w in zip(got, want):
        for a, b in zip(g[2], w[2]):
            assert [o for o, _ in a] == [o for o, _ in b]
            np.testing.assert_allclose([x for _, x in a], [x for _, x in b],
                                       rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("option,multi", [(51, False), (51, True),
                                          (71, False)])
def test_knn_panes_on_card_equal_cpu(card, option, multi):
    """Options 51 (and its multiQuery) and 71 with panes under the device
    merge on the card (K3 launched once per window) against the CPU run,
    and against the card's full-window run."""
    from spatialflink_tpu_torch import driver as TD

    fmt = "CSV" if option == 51 else "GeoJSON"
    lines = (_pane_lines(30_000, 3) if option == 51
             else _pane_polygons(3_000, 4))
    p = _card_params(option, fmt, panes=True, pane_device_merge=True,
                     multi_query=multi, k=20,
                     query_points=[(116.5, 40.5), (116.9, 40.1),
                                   (116.0, 40.8)])

    def run(device, params):
        return [(w.window_start, w.window_end,
                 w.records if "queries" in w.extras else [w.records])
                for w in TD.run_option(params, iter(lines), device=device)]

    launches = K.knn_merge.launches
    got = run("cuda", p)
    assert K.knn_merge.launches - launches == len(got) >= 5
    _knn_lists_close(got, run("cpu", p))
    p.query.panes = False
    _knn_lists_close(got, run("cuda", p))


@pytest.mark.cuda
def test_dynamic_knn_on_card_equals_cpu(card):
    """Option 51 from a live registry, with an admission and a retirement
    mid-run, on the card and on the CPU."""
    from spatialflink_tpu_torch import driver as TD
    from spatialflink_tpu_torch.runtime.queryplane import QueryRegistry

    lines = _pane_lines(30_000, 5)

    def run(device):
        p = _card_params(51, "CSV", k=20)
        reg = QueryRegistry("knn", radius=p.query.radius, k=20)
        for i, (x, y) in enumerate([(116.5, 40.5), (116.9, 40.1)]):
            reg.admit({"id": f"q{i}", "x": x, "y": y})
        reg.apply()
        p.query_registry = reg

        def churn():
            for i, line in enumerate(lines):
                if i == 12_000:
                    reg.admit({"id": "late", "x": 116.0, "y": 40.8})
                if i == 20_000:
                    reg.retire("q0")
                yield line
        return [(w.window_start, w.extras["query_ids"], w.records)
                for w in TD.run_option(p, churn(), device=device)]

    got, want = run("cuda"), run("cpu")
    assert [w[:2] for w in got] == [w[:2] for w in want]
    assert {tuple(w[1]) for w in got} >= {("q0", "q1"),
                                           ("q0", "q1", "late"),
                                           ("q1", "late")}
    _knn_lists_close([(w[0], 0, w[2]) for w in got],
                     [(w[0], 0, w[2]) for w in want])


# ------------------------------------------------------------------------ #
# K8: the trajectory kernels; K2's exact radius; K4x's parity output


def _traj_points(dev, case, seed=3, t0=0):
    """(PointBatch without padding, M, num_cells) of one named K8 case:
    "empty"; "one-run" (one object); "all-ties" (every point of an object
    at one ts); "absent" (only even ids of a 512-slot state, so odd
    objects are absent); "m-above-n" (100 points, 4,096 slots); "untiled"
    (9,001 points, not a multiple of the sort's 4,096-point tile, with
    ties and padded slots); "window" (60,000 points of 2,000 objects)."""
    from spatialflink_tpu_torch.models.batches import POINT_DTYPES, to_device

    rng = np.random.default_rng(seed)
    n, ids, m = {"empty": (0, 1, 256), "one-run": (700, 1, 256),
                 "all-ties": (2_000, 40, 256), "absent": (3_000, 256, 512),
                 "m-above-n": (100, 30, 4096), "untiled": (9_001, 700, 1024),
                 "window": (60_000, 2_000, 2048)}[case]
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=20)
    x = rng.uniform(-0.5, 10.5, n)
    y = rng.uniform(-0.5, 10.5, n)
    oid = rng.integers(0, ids, n).astype(np.int32)
    ts = (t0 + rng.integers(-5_000, 5_000, n)).astype(np.int32)
    if case == "absent":
        oid = oid - oid % 2
    if case == "all-ties":
        ts = (oid * 7).astype(np.int32)
    if case in ("untiled", "window"):
        dup = rng.random(n) < 0.05  # (object, ts) ties, other coordinates
        ts[1:][dup[1:]] = ts[:-1][dup[1:]]
        oid[1:][dup[1:]] = oid[:-1][dup[1:]]
    valid = np.ones(n, bool)
    if case == "untiled":
        valid[rng.random(n) < 0.1] = False
    cell, _ = grid.assign_cell(x, y)
    host = {"x": x, "y": y, "obj_id": oid, "ts": ts, "cell": cell,
            "valid": valid}
    b = PointBatch(**{k: to_device(v, POINT_DTYPES[k], dev)
                      for k, v in host.items()})
    return b, m, grid.num_cells


TRAJ_CASES = ["empty", "one-run", "all-ties", "absent", "m-above-n",
              "untiled", "window"]


def _state_from(dev, m, seed):
    from spatialflink_tpu_torch.ops import trajectory as T

    rng = np.random.default_rng(seed)
    s = T.TrajStatsState.zeros(m, dev)
    init = torch.from_numpy(rng.random(m) < 0.5).to(dev)
    s.last_ts[init] = torch.from_numpy(
        rng.integers(-8_000, 2_000, m).astype(np.int32)).to(dev)[init]
    s.last_x.copy_(torch.from_numpy(rng.uniform(0, 10, m).astype(np.float32)))
    s.last_y.copy_(torch.from_numpy(rng.uniform(0, 10, m).astype(np.float32)))
    s.spatial.copy_(torch.from_numpy(rng.uniform(0, 3, m).astype(np.float32)))
    s.temporal[init] = torch.from_numpy(
        rng.integers(0, 50_000, m).astype(np.float32)).to(dev)[init]
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAJ_CASES)
def test_tstats_update_kernel_equals_plain(card, case):
    """K8a over three batches with carried state (half of it initialised):
    outputs and the state equal to the plain version's, bit for bit."""
    from spatialflink_tpu_torch.ops import trajectory as T

    _, m, _ = _traj_points(card, case)
    got_s, want_s = _state_from(card, m, 1), _state_from(card, m, 1)
    emitted = 0
    for step in range(3):
        b, _, _ = _traj_points(card, case, seed=10 + step, t0=4_000 * step)
        launches = T.tstats_update.launches
        got_s, got = T.tstats_update(got_s, b)
        assert T.tstats_update.launches == launches + 1
        want_s, want = T.tstats_update_plain(want_s, b)
        assert _equal(got, want), (case, step)
        assert _equal(got_s, want_s), (case, step)
        emitted += int(got.emit.sum())
    assert emitted > 0 or case == "empty"


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAJ_CASES)
def test_tstats_window_summary_kernel_equals_plain(card, case):
    from spatialflink_tpu_torch.ops import trajectory as T

    b, m, _ = _traj_points(card, case)
    launches = T.tstats_window_summary.launches
    got = T.tstats_window_summary(b, m=m)
    assert T.tstats_window_summary.launches == launches + 1
    assert _equal(got, T.tstats_window_summary_plain(b, m=m))
    if case == "absent":
        assert int(got.count[1::2].sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAJ_CASES)
def test_taggregate_kernels_equal_plain(card, case):
    """K8c's groups and K8d's heatmap for every aggregate."""
    from spatialflink_tpu_torch.ops import trajectory as T

    b, m, cells = _traj_points(card, case)
    launches = T.taggregate_group_extents.launches
    got = T.taggregate_group_extents(b, num_cells=cells, num_ids=m)
    assert T.taggregate_group_extents.launches == launches + 1
    want = T.taggregate_group_extents_plain(b, num_cells=cells)
    assert _equal(got, want)
    if b.x.shape[0]:  # the ids read from the batch give the same groups
        assert _equal(T.taggregate_group_extents(b, num_cells=cells), want)
    groups = T.TAggregateGroups(cell=got.cell, obj_id=got.obj_id,
                                length=got.max_ts - got.min_ts,
                                first=got.first)
    for agg in ("SUM", "AVG", "MIN", "MAX", "COUNT"):
        launches = T.taggregate_heatmap.launches
        hm = T.taggregate_heatmap(groups, num_cells=cells, agg=agg)
        assert T.taggregate_heatmap.launches == launches + 1
        assert torch.equal(hm, T.taggregate_heatmap_plain(
            groups, num_cells=cells, agg=agg)), agg


#: K8a's and K8c's key-layout cases: name -> (points, object ids, state
#: slots, ts span, ts_lo, share of padded slots); "limit" points are
#: ops.trajectory.ONE_BLOCK_MAX plus the offset that follows it
K8_KEY_CASES = {
    "n=1": (1, 1, 256, 10_000, 0, 0.0),
    "limit-1": (-1, 700, 1024, 10_000, 0, 0.1),
    "limit": (0, 700, 1024, 10_000, 0, 0.1),
    "limit+1": (1, 700, 1024, 10_000, 0, 0.1),
    "n=9001": (9_001, 700, 1024, 10_000, 0, 0.1),
    "window-60000": (60_000, 2_000, 2048, 10_000, 0, 0.0),
    "span-0": (3_000, 200, 256, 0, 0, 0.1),
    "span-1": (3_000, 200, 256, 1, 0, 0.1),
    "span-8191": (3_000, 200, 256, 8_191, 0, 0.1),
    "span-8192": (9_001, 200, 256, 8_192, 0, 0.1),
    "span-2^30-1": (3_000, 200, 256, 2 ** 30 - 1, -2 ** 29, 0.1),
    "span-2^30-1-tiled": (9_001, 200, 256, 2 ** 30 - 1, -2 ** 29, 0.1),
    "negative-offsets": (9_001, 700, 1024, 3_500, -3_000, 0.1),
    "m=1": (3_000, 1, 1, 10_000, 0, 0.1),
    "m=1024": (9_001, 1_024, 1024, 10_000, 0, 0.1),
    "m=1025": (3_000, 1_025, 1025, 10_000, 0, 0.1),
    "skew-3/4": (60_000, 2_000, 2048, 10_000, 0, 0.0),
}


def _k8_key_batch(dev, case, seed=0, t0=0):
    """(PointBatch, M, num_cells, the batch's ts range over every slot) of
    one K8_KEY_CASES case: ids, ts over [ts_lo + t0, ts_lo + t0 + span]
    (both ends taken), ties, padded slots with ts of their own."""
    from spatialflink_tpu_torch.models.batches import POINT_DTYPES, to_device
    from spatialflink_tpu_torch.ops import trajectory as T

    n, ids, m, span, lo, pad = K8_KEY_CASES[case]
    if case.startswith("limit"):
        n += T.ONE_BLOCK_MAX
    rng = np.random.default_rng(seed)
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=20)
    x = rng.uniform(-0.5, 10.5, n)
    y = rng.uniform(-0.5, 10.5, n)
    oid = rng.integers(0, ids, n).astype(np.int32)
    if case == "skew-3/4":
        oid[rng.random(n) < 0.75] = 0
    ts = (lo + t0 + rng.integers(0, span + 1, n)).astype(np.int64)
    if n >= 2:
        ts[0], ts[-1] = lo + t0, lo + t0 + span
    dup = rng.random(n) < 0.05  # (object, ts) ties, other coordinates
    ts[1:][dup[1:]] = ts[:-1][dup[1:]]
    oid[1:][dup[1:]] = oid[:-1][dup[1:]]
    valid = rng.random(n) >= pad
    cell, _ = grid.assign_cell(x, y)
    host = {"x": x, "y": y, "obj_id": oid, "ts": ts.astype(np.int32),
            "cell": cell, "valid": valid}
    b = PointBatch(**{k: to_device(v, POINT_DTYPES[k], dev)
                      for k, v in host.items()})
    rng_ts = (int(ts.min()), int(ts.max())) if n else (0, 0)
    return b, m, grid.num_cells, rng_ts


@pytest.mark.cuda
@pytest.mark.parametrize("stated", [True, False], ids=["stated", "read"])
@pytest.mark.parametrize("case", list(K8_KEY_CASES))
def test_tstats_update_key_layouts_equal_plain(card, case, stated):
    """K8a at the key layout's edges (one block and tiled, 32- and 64-bit
    keys, spans, negative offsets, pad-marker widths, a skewed window),
    over three batches with carried state, with the batch's ts range
    stated or read from the batch: bit for bit the plain version's."""
    from spatialflink_tpu_torch.ops import trajectory as T

    _, m, _, _ = _k8_key_batch(card, case)
    got_s, want_s = _state_from(card, m, 1), _state_from(card, m, 1)
    for step in range(3):
        b, _, _, rng_ts = _k8_key_batch(card, case, seed=10 + step,
                                        t0=2_000 * step)
        got_s, got = T.tstats_update(got_s, b,
                                     ts_range=rng_ts if stated else None)
        want_s, want = T.tstats_update_plain(want_s, b)
        assert _equal(got, want), (case, step)
        assert _equal(got_s, want_s), (case, step)


@pytest.mark.cuda
@pytest.mark.parametrize("num_ids", [None, 2 ** 31 - 1],
                         ids=["read", "31-bit-ids"])
@pytest.mark.parametrize("case", list(K8_KEY_CASES))
def test_taggregate_key_layouts_equal_plain(card, case, num_ids):
    """K8c at the same edges, with its ids read from the batch or a 31-bit
    id field (a 40-bit key: the 64-bit path), bit for bit."""
    from spatialflink_tpu_torch.ops import trajectory as T

    b, _, cells, _ = _k8_key_batch(card, case)
    got = T.taggregate_group_extents(b, num_cells=cells, num_ids=num_ids)
    assert _equal(got, T.taggregate_group_extents_plain(b, num_cells=cells))


@pytest.mark.cuda
@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "one-block"])
@pytest.mark.parametrize("case", ["n=1", "limit", "span-1", "m=1",
                                  "span-2^30-1", "m=1025"])
def test_k8_forced_paths_equal_plain(card, case, tiled, monkeypatch):
    """Both paths at the same n: the tiled path down to one point and the
    one-block path up to its limit, for K8a and K8c."""
    from spatialflink_tpu_torch.ops import trajectory as T

    b, m, cells, rng_ts = _k8_key_batch(card, case)
    limit = 0 if tiled else T.ONE_BLOCK_MAX
    monkeypatch.setattr(T, "ONE_BLOCK_MAX", limit)
    n = b.x.shape[0]
    _, lay = T.tstats_layout(n, m, *rng_ts)
    assert lay.one_block == (n <= limit)
    got_s, got = T.tstats_update(_state_from(card, m, 2), b, ts_range=rng_ts)
    want_s, want = T.tstats_update_plain(_state_from(card, m, 2), b)
    assert _equal(got, want) and _equal(got_s, want_s)
    got = T.taggregate_group_extents(b, num_cells=cells)
    assert _equal(got, T.taggregate_group_extents_plain(b, num_cells=cells))


def _dirty(dev, nbytes):
    """Leave a freed block of ``nbytes`` of junk in the caching allocator,
    so that an output row a kernel fails to write shows as junk rather than
    as a value a previous call left there."""
    junk = torch.full((nbytes,), 0x5A, dtype=torch.uint8, device=dev)
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("tiled", [False, True], ids=["own-path", "tiled"])
@pytest.mark.parametrize("stated", [True, False], ids=["stated", "read"])
@pytest.mark.parametrize("case", list(K8_KEY_CASES))
def test_tstats_window_summary_key_layouts_equal_plain(card, case, stated,
                                                       tiled, monkeypatch):
    """K8b on K8a's key at the same edges (one block and tiled, 32- and
    64-bit keys, spans, negative offsets, m = 1 / 1,024 / 1,025, one object
    holding 3/4 of the points), with the batch's ts range stated or read,
    on the path its size takes and on the tiled path forced at the same
    n: bit for bit the plain version's, and the absent objects' rows keep
    INT_MAX / INT_MIN / 0."""
    from spatialflink_tpu_torch.ops import trajectory as T

    b, m, _, rng_ts = _k8_key_batch(card, case)
    if tiled:
        monkeypatch.setattr(T, "ONE_BLOCK_MAX", 0)
    _, lay = T.summary_layout(b.x.shape[0], m, *rng_ts)
    assert lay.one_block == (b.x.shape[0] <= T.ONE_BLOCK_MAX)
    _dirty(card, 64 * m + (1 << 20))
    launches = T.tstats_window_summary.launches
    got = T.tstats_window_summary(b, m=m, ts_range=rng_ts if stated else None)
    assert T.tstats_window_summary.launches == launches + 1
    assert _equal(got, T.tstats_window_summary_plain(b, m=m))
    absent = got.count == 0
    assert int(absent.sum()) == m - torch.unique(b.obj_id[b.valid]).numel()
    assert bool((got.min_ts[absent] == T.INT32_MAX).all())
    assert bool((got.max_ts[absent] == T.INT32_MIN).all())
    for t in (got.spatial, got.first_x, got.first_y, got.last_x, got.last_y):
        assert bool((t[absent] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tiled", [False, True], ids=["one-block", "tiled"])
@pytest.mark.parametrize("m", [1, 4_095, 4_096, 4_097, 16_384, 20_001])
@pytest.mark.parametrize("n", [0, 512])
def test_tstats_window_summary_writes_every_row(card, n, m, tiled,
                                                monkeypatch):
    """Every one of the m rows is written, present or absent, whatever m
    (the one-block launch's extra blocks take 4,096 rows each, so m
    crosses their edges): ids spread over [0, m) with both ends present,
    or an empty batch, which takes the one-block launch on either path."""
    from spatialflink_tpu_torch.models.batches import POINT_DTYPES, to_device
    from spatialflink_tpu_torch.ops import trajectory as T

    rng = np.random.default_rng(m)
    oid = rng.integers(0, m, n)
    oid[:2] = (0, m - 1)[:n]
    ts = rng.integers(-1_000, 1_000, n)
    host = {"x": rng.uniform(0, 10, n), "y": rng.uniform(0, 10, n),
            "obj_id": oid, "ts": ts, "cell": np.zeros(n),
            "valid": rng.random(n) >= 0.1}
    b = PointBatch(**{k: to_device(v, POINT_DTYPES[k], card)
                      for k, v in host.items()})
    if tiled:
        monkeypatch.setattr(T, "ONE_BLOCK_MAX", 0)
    rng_ts = (int(ts.min()), int(ts.max())) if n else (0, 0)
    _, lay = T.summary_layout(n, m, *rng_ts)
    assert lay.one_block == (n == 0 or not tiled)
    _dirty(card, 64 * m + (1 << 20))
    got = T.tstats_window_summary(b, m=m, ts_range=rng_ts)
    assert _equal(got, T.tstats_window_summary_plain(b, m=m))


def _heat_groups(dev, case, seed=0):
    """(TAggregateGroups in K8c's order, num_cells) of one K8d case: groups
    of 1-5 positions each (only the first flagged; the others' lengths are
    junk), cell ascending, then positions of the sentinel cell num_cells.
    "empty"; "skew-3/4" (3/4 of the groups in one cell); "edges-empty" (no
    group in the first or the last cell); "edges-full" (groups in both);
    "one-cell" (every group in the last cell); "above-2^24" (lengths up to
    2^30: each cell's f32 sum rounds at most adds, so only group order
    gives the plain version's sum); "sentinel-only"."""
    from spatialflink_tpu_torch.ops import trajectory as T

    rng = np.random.default_rng(seed)
    cells = 400
    g = {"empty": 0, "skew-3/4": 6_000, "edges-empty": 3_000,
         "edges-full": 3_000, "one-cell": 2_000, "above-2^24": 4_000,
         "sentinel-only": 0}[case]
    gc = rng.integers(0, cells, g)
    length = rng.integers(0, 10_000, g)
    if case == "skew-3/4":
        gc[rng.random(g) < 0.75] = 7
    if case == "edges-empty":
        gc = rng.integers(1, cells - 1, g)
    if case == "edges-full":
        gc[:2] = (0, cells - 1)
    if case == "one-cell":
        gc[:] = cells - 1
    if case == "above-2^24":
        gc[rng.random(g) < 0.5] = 3
        length = rng.integers(0, 2 ** 30, g)
    reps = rng.integers(1, 6, g)
    order = np.argsort(gc, kind="stable")
    cell = np.repeat(gc[order], reps[order])
    lens = np.repeat(length[order], reps[order])
    first = np.zeros(cell.shape[0], bool)
    first[np.cumsum(reps[order]) - reps[order]] = True
    lens[~first] = rng.integers(-5, 2 ** 31 - 1, int((~first).sum()))
    tail = 0 if case == "empty" else int(rng.integers(1, 50))
    cell = np.r_[cell, np.full(tail, cells)]
    lens = np.r_[lens, rng.integers(0, 10_000, tail)]
    first = np.r_[first, np.zeros(tail, bool)]
    return T.TAggregateGroups(
        cell=torch.from_numpy(cell.astype(np.int32)).to(dev),
        obj_id=torch.zeros(cell.shape[0], dtype=torch.int32, device=dev),
        length=torch.from_numpy(lens.astype(np.int32)).to(dev),
        first=torch.from_numpy(first).to(dev)), cells


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["SUM", "AVG", "MIN", "MAX", "COUNT"])
@pytest.mark.parametrize("case", ["empty", "skew-3/4", "edges-empty",
                                  "edges-full", "one-cell", "above-2^24",
                                  "sentinel-only"])
def test_taggregate_heatmap_cases_equal_plain(card, case, agg):
    """K8d in its one launch, bit for bit the plain version's: an empty
    input (an all-zero heatmap), a cell holding 3/4 of the groups, no
    group in the first or last cell, groups in both, lengths summing far
    above 2^24 in one cell, non-first positions and the sentinel cell."""
    from spatialflink_tpu_torch.ops import trajectory as T

    groups, cells = _heat_groups(card, case)
    _dirty(card, 4 * cells + 4096)
    launches = T.taggregate_heatmap.launches
    got = T.taggregate_heatmap(groups, num_cells=cells, agg=agg)
    assert T.taggregate_heatmap.launches == launches + 1
    want = T.taggregate_heatmap_plain(groups, num_cells=cells, agg=agg)
    assert torch.equal(got, want), case
    held = torch.zeros(cells, dtype=torch.bool, device=card)
    held[groups.cell[groups.first].long()] = True
    assert bool((got[~held] == 0).all())
    if case == "above-2^24" and agg == "SUM":
        assert float(got[3]) > 2 ** 24


@pytest.mark.cuda
def test_k8_launch_counts(card):
    """K8a, K8b and K8c launch as many kernels as their layout says: one
    at a 512-point cut, six (passes + 2) at a 262,144-point window of a 29-
    / 28-bit key; K8b one for an empty batch; K8d one (torch.profiler's
    count of device kernels in one call)."""
    from torch.profiler import ProfilerActivity, profile

    from spatialflink_tpu_torch.ops import trajectory as T

    marker = torch.empty(1, device=card)

    def kernels(fn):
        # a fill of `marker` runs inside the same profile: a trace without
        # it lost its device events (seen late in a long process, after
        # hundreds of tests), so it says nothing and the profile is taken
        # again
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                marker.fill_(1.0)
                fn()
                torch.cuda.synchronize()
            names = [ev.name.lower() for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA
                     and "memcpy" not in ev.name.lower()
                     and "memset" not in ev.name.lower()]
            fills = sum(1 for name in names if "fillfunctor" in name)
            if fills:
                return len(names) - fills
        return None

    rng = np.random.default_rng(5)
    for n, want in ((512, 1), (262_144, 6)):
        b = PointBatch.from_arrays(
            rng.uniform(0, 10, n), rng.uniform(0, 10, n), device=card,
            grid=UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=100),
            obj_id=rng.integers(0, 10_357, n), ts=rng.integers(0, 10_000, n))
        rng_ts = (0, 9_999)
        _, lay = T.tstats_layout(n, 16_384, *rng_ts)
        assert lay.launches == want
        state = T.TrajStatsState.zeros(16_384, card)
        assert kernels(lambda: T.tstats_update(state, b,
                                               ts_range=rng_ts)) == want
        assert T.extents_layout(n, 10_000, 14).launches == want
        assert kernels(lambda: T.taggregate_group_extents(
            b, num_cells=10_000, num_ids=10_357)) == want
        _, lay = T.summary_layout(n, 16_384, *rng_ts)
        assert lay.launches == want == (1 if n <= T.ONE_BLOCK_MAX
                                        else lay.passes + 2)
        assert kernels(lambda: T.tstats_window_summary(
            b, m=16_384, ts_range=rng_ts)) == want
        groups = T.taggregate_groups(b, num_cells=10_000, num_ids=10_357)
        for agg in ("SUM", "MIN"):
            assert kernels(lambda: T.taggregate_heatmap(
                groups, num_cells=10_000, agg=agg)) == 1
    from spatialflink_tpu_torch.models.batches import POINT_DTYPES, to_device
    empty = PointBatch(**{k: to_device(np.zeros(0), dt, card)
                          for k, dt in POINT_DTYPES.items()})
    assert T.summary_layout(0, 16_384, 0, 0)[1].launches == 1
    assert kernels(lambda: T.tstats_window_summary(empty, m=16_384)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 5])
@pytest.mark.parametrize("radius", [0.0, 0.5, 2.0])
def test_knn_topk_enforce_radius_equals_plain(card, q, radius):
    """K2's point mode with the trajectory kNN's exact radius: only points
    within it enter the lists; the counts stay the cell-eligible ones."""
    grid, b = _knn_inputs(card)
    qx = torch.tensor([5.25, 1.0, 9.5, 3.3, 7.7][:q], device=card)
    qy = torch.tensor([4.75, 9.0, 0.5, 3.3, 2.2][:q], device=card)
    qc = torch.tensor([int(grid.assign_cell(float(a), float(c))[0])
                       for a, c in zip(qx.tolist(), qy.tolist())],
                      dtype=torch.int32, device=card)
    kw = dict(mode=K.MODE_POINT, k=50, num_ids=3_000, x=b.x, y=b.y,
              cell=b.cell, valid=b.valid, qx=qx, qy=qy, q_cell=qc, n=grid.n,
              nb_layers=2)
    got = K.knn_topk(b.obj_id, radius=radius, **kw)
    assert _equal(got, K.knn_topk_plain(b.obj_id, radius=radius, **kw))
    free = K.knn_topk(b.obj_id, **kw)
    assert torch.equal(got[3], free[3])
    assert bool((got[1][got[2]] <= radius).all())


@pytest.mark.cuda
@pytest.mark.parametrize("ordered", [False, True])
def test_pip_lattice_parity_equals_plain(card, ordered):
    """K4x's parity output: the even-odd parity of points_in_geoms for
    every geometry, areal or not, with points on edges and vertices."""
    grid, b = _batch(card)
    _, e = _edge_case_points(card)
    gb = _lattice_geoms(card)
    for px, py, cell in ((b.x, b.y, b.cell), (e.x, e.y, e.cell)):
        kw = dict(cell=cell, num_cells=grid.num_cells) if ordered else {}
        dist, inside = HK.pip_lattice(px, py, gb.edges, gb.edge_mask,
                                      gb.is_areal, parity=True, **kw)
        assert torch.equal(dist, HK.pip_lattice(px, py, gb.edges,
                                                gb.edge_mask, gb.is_areal,
                                                **kw))
        assert torch.equal(inside, G.points_in_geoms(
            px, py, gb.edges, gb.edge_mask).T)
