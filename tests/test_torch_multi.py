"""Multi-query serving over a point stream and the K4x lattice: the PyTorch
port on the CPU (the kernels' plain versions) against the JAX package on
the same seeded inputs.

- K4x's plain version against ``points_to_geoms_dist`` (mixed areal and
  linestring geometries, a polygon with a hole, more than 512 edges),
  within the tolerance of tests/test_pallas.py (rtol=atol=1e-5);
- the Q-query entries ``knn_points_to_geom_queries``,
  ``range_points_to_geom_queries`` and ``range_filter_point_multi_masks``,
  exact and approximate;
- ``run_multi`` of options 1, 6, 11, 51, 56 and 61 through run_option,
  with the pruning counters against the JAX registry's.

Range selections must be identical; the data is checked to hold no point
within 1e-5 of the radius. kNN lists as in tests/test_torch_knn.py, except
that distances to a geometry carry DIST_TOL: projecting a point onto a
segment rounds at the scale of the coordinates, not of the distance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.index import UniformGrid as JGrid
from spatialflink_tpu.models import PointBatch as JPointBatch
from spatialflink_tpu.models.batches import EdgeGeomBatch as JEdgeGeomBatch
from spatialflink_tpu.models.objects import LineString as JLineString
from spatialflink_tpu.models.objects import Polygon as JPolygon
from spatialflink_tpu.ops import geom as JG
from spatialflink_tpu.ops import range as JR

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import Params as TParams
from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import (EdgeGeomBatch, LineString,
                                            Polygon, from_jax_arrays)
from spatialflink_tpu_torch.ops import geom as G
from spatialflink_tpu_torch.ops import hopper_kernels as HK
from spatialflink_tpu_torch.ops import range as R

from test_torch_knn import (CONF, assert_knn_windows_equal, run_both,
                            _stream as _knn_stream)

DIST_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_pallas.py:41-42
GRID = JGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)

# pytest workers import every test module: one intra-op thread keeps this
# file's small CPU tensors from competing with the timed tests that
# other workers run at the same time
torch.set_num_threads(1)


def _ring(n_vert, r=3.0, cx=5.0, cy=5.0):
    th = np.linspace(0, 2 * np.pi, n_vert, endpoint=False)
    ring = [(cx + r * float(np.cos(t)), cy + r * float(np.sin(t)))
            for t in th]
    return ring + [ring[0]]


def _geoms(P, L, grid=None):
    """Mixed areal/linestring query geometries: a square, a polygon with
    a hole, a linestring, a 700-edge ring (two 512-edge chunks) and a
    small triangle."""
    return [
        P.create([[(2, 2), (6, 2), (6, 6), (2, 6), (2, 2)]], grid),
        P.create([[(1, 1), (8, 1), (8, 8), (1, 8), (1, 1)],
                  [(3, 3), (5, 3), (5, 5), (3, 3)]], grid),
        L.create([(0.5, 0.5), (4, 7), (9, 3)], grid),
        P.create([_ring(700, 3.5)], grid),
        P.create([[(7, 7), (9, 7), (8, 9.5), (7, 7)]], grid),
    ]


def _batches(n, seed, lo=-1.0, hi=11.0):
    rng = np.random.default_rng(seed)
    jb = JPointBatch.from_arrays(rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
                                 grid=GRID,
                                 obj_id=rng.integers(0, n // 4, n))
    pb, _ = from_jax_arrays(jb._asdict(), "cpu")
    return jb, pb


def _geom_batches():
    jgb = JEdgeGeomBatch.from_objects(_geoms(JPolygon, JLineString, GRID),
                                      GRID, pad=5)
    tgb = EdgeGeomBatch.from_objects(
        _geoms(Polygon, LineString,
               UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)),
        device=torch.device("cpu"), pad=5)
    return jgb, tgb


def test_edge_geom_batch_matches_jax():
    jgb, tgb = _geom_batches()
    assert tgb.edges.shape[1] > HK.EDGE_CHUNK
    for name in JEdgeGeomBatch._fields:
        np.testing.assert_array_equal(getattr(tgb, name).numpy(),
                                      np.asarray(getattr(jgb, name)), name)
    # the state carry from the JAX package builds the same batch
    jb, _ = _batches(10, 1)
    _, q = from_jax_arrays(jb._asdict(), "cpu", geoms=jgb)
    assert all(torch.equal(a, b) for a, b in zip(q["geoms"], tgb))
    assert q["geoms"].is_areal.dtype == torch.bool


def test_pip_lattice_plain_matches_points_to_geoms_dist():
    jb, pb = _batches(700, 2)
    jgb, tgb = _geom_batches()
    want = np.asarray(JG.points_to_geoms_dist(jb, jgb))
    got = G.points_to_geoms_dist(pb, tgb)
    assert got.shape == (pb.capacity, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **DIST_TOL)
    # areal rows are 0 inside; the linestring row never is
    assert (got[:, 0] == 0).any() and not (got[:, 2] == 0).any()
    # the (G, N) form K4x writes is the transpose; its rows equal K4
    rows = HK.pip_lattice(pb.x, pb.y, tgb.edges, tgb.edge_mask, tgb.is_areal)
    assert torch.equal(rows, got.T)
    for g in range(5):
        one = HK.pip_dist(pb.x, pb.y, tgb.edges[g], tgb.edge_mask[g],
                          bool(tgb.is_areal[g]))
        assert torch.equal(rows[g], one)


def test_points_in_geoms_and_edges_dist_match_jax():
    jb, pb = _batches(300, 3)
    jgb, tgb = _geom_batches()
    np.testing.assert_array_equal(
        G.points_in_geoms(pb.x, pb.y, tgb.edges, tgb.edge_mask).numpy(),
        np.asarray(JG.points_in_geoms(jb.x, jb.y, jgb.edges, jgb.edge_mask)))
    np.testing.assert_allclose(
        G.points_to_edges_dist(pb.x, pb.y, tgb.edges, tgb.edge_mask).numpy(),
        np.asarray(JG.points_to_edges_dist(jb.x, jb.y, jgb.edges,
                                           jgb.edge_mask)), **DIST_TOL)


def test_pip_lattice_plain_blocks_are_exact(monkeypatch):
    _, pb = _batches(500, 4)
    _, tgb = _geom_batches()
    args = (pb.x, pb.y, tgb.edges, tgb.edge_mask, tgb.is_areal)
    whole = HK.pip_lattice_plain(*args)
    monkeypatch.setattr(HK, "_PLAIN_ELEMS", 7 * 5 * tgb.edges.shape[1])
    assert torch.equal(HK.pip_lattice_plain(*args), whole)


def _nb_masks(geoms, radius, which):
    rows = []
    for g in geoms:
        cells = sorted(g.cells)
        gn = GRID.guaranteed_cells_mask(radius, cells)
        rows.append({"gn": gn, "cn": GRID.candidate_cells_mask(radius, cells,
                                                               gn),
                     "nb": GRID.neighboring_cells_mask(radius, cells)}[which])
    return np.stack(rows)


@pytest.mark.parametrize("approximate", [False, True])
def test_knn_points_to_geom_queries_matches_jax(approximate):
    jb, pb = _batches(2_000, 5)
    jgb, tgb = _geom_batches()
    nb = _nb_masks(_geoms(JPolygon, JLineString, GRID), 1.5, "nb")
    want = JG.knn_points_to_geom_queries(jb, jgb, jnp.asarray(nb), k=10,
                                         strategy="sort",
                                         approximate=approximate)
    got = G.knn_points_to_geom_queries(pb, tgb, torch.from_numpy(nb), k=10,
                                       approximate=approximate)
    np.testing.assert_array_equal(got[0].obj_id.numpy(),
                                  np.asarray(want[0].obj_id))
    np.testing.assert_array_equal(got[0].valid.numpy(),
                                  np.asarray(want[0].valid))
    # geometry distances carry the pip kernels' tolerance (the projection
    # onto a segment rounds at coordinate scale, not distance scale)
    np.testing.assert_allclose(got[0].dist.numpy(), np.asarray(want[0].dist),
                               **DIST_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[0].valid.all())


def _far_from(d, radius):
    d = np.asarray(d, np.float64)
    return np.all(np.abs(d[np.isfinite(d)] - radius) > 1e-5)


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("radius", [0.4, 1.7])
def test_range_points_to_geom_queries_matches_jax(radius, approximate):
    jb, pb = _batches(1_500, 6)
    jgb, tgb = _geom_batches()
    jgeoms = _geoms(JPolygon, JLineString, GRID)
    gn, cn = _nb_masks(jgeoms, radius, "gn"), _nb_masks(jgeoms, radius, "cn")
    d = (JG.points_to_geoms_dist(jb, jgb).T if not approximate else
         jnp.stack([jnp.asarray(JG.D.point_bbox_dist(jb.x, jb.y, *b))
                    for b in np.asarray(jgb.bbox)]))
    assert _far_from(d, radius)
    want = JG.range_points_to_geom_queries(jb, jgb, jnp.asarray(gn),
                                           jnp.asarray(cn), radius,
                                           approximate=approximate)
    got = G.range_points_to_geom_queries(pb, tgb, torch.from_numpy(gn),
                                         torch.from_numpy(cn), radius,
                                         approximate=approximate)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (5, pb.capacity) and got[0].any()


@pytest.mark.parametrize("approximate", [False, True])
def test_range_filter_point_multi_masks_matches_jax(approximate):
    jb, pb = _batches(1_200, 7)
    rng = np.random.default_rng(8)
    qx = np.r_[rng.uniform(0, 10, 5), 12.0].astype(np.float32)
    qy = np.r_[rng.uniform(0, 10, 5), 5.0].astype(np.float32)
    qc = np.array([GRID.assign_cell(float(a), float(b))[0]
                   for a, b in zip(qx, qy)], np.int32)
    radius = 1.3
    gl, cl = GRID.guaranteed_layers(radius), GRID.candidate_layers(radius)
    x, y = np.asarray(jb.x, np.float64), np.asarray(jb.y, np.float64)
    assert _far_from(np.hypot(x[None] - qx[:, None], y[None] - qy[:, None]),
                     radius)
    want = JR.range_filter_point_multi_masks(
        jb, jnp.asarray(qx), jnp.asarray(qy), jnp.asarray(qc), radius, gl, cl,
        n=GRID.n, approximate=approximate)
    got = R.range_filter_point_multi_masks(
        pb, torch.from_numpy(qx), torch.from_numpy(qy), torch.from_numpy(qc),
        radius, gl, cl, n=GRID.n, approximate=approximate)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].any() and not got[0][-1].any()


# ------------------------------------------------------------------------ #
# run_multi of options 1, 6, 11, 51, 56 and 61 through run_option

def _multi_params(cls, option, approximate, k=10):
    p = cls.from_yaml(CONF)
    p.query.option = option
    p.query.approximate = approximate
    p.query.multi_query = True
    p.query.k = k
    p.query.query_points = [(116.5, 40.5), (116.9, 40.1), (116.0, 40.8),
                            (118.5, 40.0)]  # the last lies outside the grid
    p.query.query_polygons = [
        list(map(tuple, r)) for r in p.query.query_polygons] + [
        [(116.3, 40.3), (116.6, 40.3), (116.6, 40.6), (116.3, 40.3)],
        _ring(40, 0.25, 116.0, 40.0)]
    p.query.query_linestrings = [
        list(map(tuple, r)) for r in p.query.query_linestrings] + [
        [(116.0, 40.0), (116.4, 40.7)]]
    return dataclasses.replace(
        p, input1=dataclasses.replace(p.input1, format="CSV"))


def _range_windows(results):
    return [(w.window_start, w.window_end, dict(w.extras),
             [[(p.obj_id, p.timestamp, p.x, p.y) for p in q]
              for q in w.records]) for w in results]


def _query_dists(option, approximate, lines):
    """Every record's distance to each query of a range option, by the JAX
    package (the boundary check of the data)."""
    p = _multi_params(JParams, option, approximate)
    grid = p.grids()[0]
    rows = [ln.split(",") for ln in lines]
    x = np.array([float(r[2]) for r in rows], np.float32)
    y = np.array([float(r[3]) for r in rows], np.float32)
    if option == 1:
        return np.stack([np.hypot(x - q.x, y - q.y)
                         for q in p.query_point_objects(grid)])
    geoms = (p.query_polygon_objects(grid) if option == 6
             else p.query_linestring_objects(grid))
    jb = JPointBatch.from_arrays(x, y, grid=grid)
    if approximate:
        return np.stack([np.asarray(JG.D.point_bbox_dist(
            jb.x, jb.y, *np.asarray(g.bbox, np.float32))) for g in geoms])
    gb = JEdgeGeomBatch.from_objects(geoms, grid, pad=len(geoms))
    return np.asarray(JG.points_to_geoms_dist(jb, gb)).T


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("option", [1, 6, 11])
def test_run_multi_range_matches_jax(monkeypatch, option, approximate):
    from spatialflink_tpu import driver as JD
    from spatialflink_tpu.utils.metrics import REGISTRY

    from test_torch_knn import _Recording

    lines = _knn_stream(n=4_000, seed=11)
    d = _query_dists(option, approximate, lines)
    assert _far_from(d, 0.5)
    names = ("gn-bypassed", "distance-computations")
    before = [REGISTRY.counter(c).count for c in names]
    want = _range_windows(JD.run_option(
        _multi_params(JParams, option, approximate), iter(lines)))
    after = [REGISTRY.counter(c).count for c in names]
    rec = _Recording(monkeypatch)
    got = _range_windows(TD.run_option(
        _multi_params(TParams, option, approximate), iter(lines),
        device="cpu"))
    assert len(want) >= 6 and want[0][2]["queries"] >= 2
    assert got == want
    assert sum(len(q) for w in want for q in w[3]) > 0
    (op,) = rec.ops
    assert [op.pruning[c] for c in names] == \
        [a - b for a, b in zip(after, before)]


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("option,k", [(51, 50), (56, 10), (61, 10)])
def test_run_multi_knn_matches_jax(monkeypatch, option, k, approximate):
    lines = _knn_stream(n=4_000, seed=12)
    got, want, counts, jcounts = run_both(
        monkeypatch, _multi_params(JParams, option, approximate, k),
        _multi_params(TParams, option, approximate, k), lines)
    assert want[0][2]["queries"] >= 2 and want[0][2]["k"] == k
    assert_knn_windows_equal(got, want)
    assert counts == jcounts and counts[1] > 0


def test_run_multi_first_query_equals_run():
    """Row 0 of a multi-query run is the single-query run of the same
    option (the JAX package's own dispatch contract)."""
    lines = _knn_stream(n=3_000, seed=13)
    for option in (6, 56):
        p = _multi_params(TParams, option, False)
        multi = list(TD.run_option(p, iter(lines), device="cpu"))
        p.query.multi_query = False
        single = list(TD.run_option(p, iter(lines), device="cpu"))
        assert [w.records[0] if option == 56 else
                [r.obj_id for r in w.records[0]] for w in multi] == \
            [w.records if option == 56 else [r.obj_id for r in w.records]
             for w in single]


def test_run_multi_case_errors_match_jax():
    """An empty query list and a latency variant are refused, with the JAX
    driver's messages."""
    from spatialflink_tpu import driver as JD

    for run, cls in ((lambda p: TD.run_option(p, [], device="cpu"), TParams),
                     (lambda p: JD.run_option(p, []), JParams)):
        p = _multi_params(cls, 56, False)
        p.query.query_polygons = []
        with pytest.raises(ValueError, match="queryPolygons is empty"):
            next(iter(run(p)))
    spec = TD.CaseSpec("knn", "Point", "Polygon", latency=True)
    with pytest.raises(ValueError, match="latency variants"):
        TD._run_multi_case(_multi_params(TParams, 56, False), spec, None,
                           None, None, 0.5)
