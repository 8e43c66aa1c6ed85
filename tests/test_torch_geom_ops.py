"""K5's plain versions on the CPU against the JAX package: the geometry
distances of ``spatialflink_tpu_torch.ops.distances`` and ``ops.geom``
(segment-segment, edge sets, point/geometry/bbox to each stream geometry),
the cell rule, and ``geom_stream_dist_plain`` (the plain version of the K5
kernel) against ``spatialflink_tpu.ops.geom``'s range and kNN entries.

Inputs are made from a numpy seed or written out; the JAX stream batch is
carried to the port with ``from_jax_arrays``, so both sides read the same
f32 arrays. Masks, counts and kNN ids must be equal. Distances must be
equal, or within 1e-6 relative or two f32 ulps of the coordinates'
magnitude (``_close``): XLA on the CPU contracts a product and a sum into
one fma (the projected point ``x1 + t * cx`` of a segment distance among
them), while the port rounds each operation, as its kernels do. The
projected point then differs by up to one ulp of the coordinates, and a
distance by that much whatever its own size (most differ by 1-2 ulps of
the distance; a 0.064 distance among coordinates near 5 differed by 14 of
its ulps, 0.2 of a coordinate ulp, both sides within a coordinate ulp of
the float64 value).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from spatialflink_tpu.index import UniformGrid as JGrid
from spatialflink_tpu.models import (LineString as JLineString,
                                     MultiPolygon as JMultiPolygon,
                                     Polygon as JPolygon)
from spatialflink_tpu.models.batches import EdgeGeomBatch as JEdgeGeomBatch
from spatialflink_tpu.ops import distances as JD
from spatialflink_tpu.ops import geom as JG
from spatialflink_tpu.ops import range as JR

from spatialflink_tpu_torch.models import from_jax_arrays
from spatialflink_tpu_torch.ops import distances as TD
from spatialflink_tpu_torch.ops import geom as TG

torch.set_num_threads(1)

GRID = JGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)


def _sq(x0, y0, x1, y1):
    return [(x0, y0), (x1, y0), (x1, y1), (x0, y1), (x0, y0)]


def _edge_case_geoms():
    """Stream geometries at the exact edges of the rule and the math,
    around the query square [2, 6] x [2, 6]."""
    g = GRID
    return [
        JPolygon.create([_sq(0.5, 0.5, 1.5, 1.5)], g, "far-square"),
        # touches the query's corner (2, 2) at a vertex
        JPolygon.create([_sq(1.0, 1.0, 2.0, 2.0)], g, "touch-corner"),
        # an edge collinear with the query's bottom edge, overlapping it
        JLineString.create([(3.0, 2.0), (4.0, 2.0)], g, "collinear"),
        # crosses the query's right edge properly
        JLineString.create([(5.0, 3.0), (7.0, 3.5)], g, "crossing"),
        # the query lies inside it (disjoint boundaries)
        JPolygon.create([_sq(1.0, 1.0, 7.0, 7.0)], g, "contains-query"),
        # lies inside the query (disjoint boundaries)
        JPolygon.create([_sq(3.0, 3.0, 4.0, 4.0)], g, "inside-query"),
        # a linestring inside the query: not areal, but the query is
        JLineString.create([(3.0, 5.0), (5.0, 5.5)], g, "line-inside"),
        # the query sits in its hole: distance to the hole's boundary
        JPolygon.create([_sq(0.2, 0.2, 9.5, 9.5), _sq(1.5, 1.5, 6.5, 6.5)],
                        g, "query-in-hole"),
        # one part far, one part inside the query
        JMultiPolygon.create([[_sq(8.5, 8.5, 9.5, 9.5)],
                              [_sq(4.5, 4.5, 5.0, 5.0)]], g, "multi"),
        # zero-length edges (repeated vertices)
        JPolygon.create([[(7.0, 7.0), (7.0, 7.0), (8.0, 7.0), (8.0, 8.0),
                          (8.0, 8.0), (7.0, 7.0)]], g, "zero-length"),
        # outside the grid: no cell
        JPolygon.create([_sq(11.0, 11.0, 12.0, 12.0)], g, "no-cell"),
        JLineString.create([(9.0, 0.5), (9.5, 1.0), (9.9, 0.2)], g,
                           "far-line"),
    ]


def _queries():
    g = GRID
    return [JPolygon.create([_sq(2.0, 2.0, 6.0, 6.0)], g, "q-square"),
            JLineString.create([(2.0, 8.0), (6.0, 8.5), (6.5, 9.5)], g,
                               "q-line"),
            JPolygon.create([[(4.2, 4.2), (4.8, 4.2), (4.5, 4.8),
                              (4.2, 4.2)]], g, "q-triangle")]


def _random_geoms(rng, n):
    out = []
    for i in range(n):
        cx, cy = rng.uniform(0.5, 9.5, 2)
        if i % 2:
            k = int(rng.integers(3, 17))
            th = np.sort(rng.uniform(0.0, 2 * np.pi, k))
            r = rng.uniform(0.05, 1.5)
            ring = [(float(cx + r * np.cos(t)), float(cy + r * np.sin(t)))
                    for t in th]
            out.append(JPolygon.create([ring + [ring[0]]], GRID, f"p{i}"))
        else:
            k = int(rng.integers(2, 9))
            pts = np.cumsum(rng.normal(0.0, 0.4, (k, 2)), axis=0) + (cx, cy)
            out.append(JLineString.create([tuple(map(float, p)) for p in pts],
                                          GRID, f"l{i}"))
    return out


def _batches(geoms):
    jgb = JEdgeGeomBatch.from_objects(geoms, GRID)
    tgb, _ = from_jax_arrays(jgb, "cpu")
    return jgb, tgb


def _close(got, want, scale=10.0):
    """Equal within 1e-6 relative or two f32 ulps of ``scale``, the largest
    coordinate magnitude (module docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=2 * float(np.spacing(np.float32(scale))))


def _edges(geom):
    from spatialflink_tpu.models.batches import single_query_edges

    e, m = single_query_edges(geom)
    return e, m


@pytest.mark.parametrize("which", ["edge-cases", "random"])
def test_geoms_to_single_geom_dist_matches_jax(which):
    geoms = (_edge_case_geoms() if which == "edge-cases"
             else _random_geoms(np.random.default_rng(5), 120))
    jgb, tgb = _batches(geoms)
    assert jgb.capacity > len(geoms) or which == "random"  # padded slots
    for q in _queries():
        e, m = _edges(q)
        areal = isinstance(q, JPolygon)
        want = np.asarray(JG.geoms_to_single_geom_dist(
            jgb, jnp.asarray(e), jnp.asarray(m), areal))
        got = TG.geoms_to_single_geom_dist(
            tgb, torch.from_numpy(e), torch.from_numpy(m), areal).numpy()
        _close(got, want)
        if which == "edge-cases" and q.obj_id == "q-square":
            d = dict(zip([g.obj_id for g in geoms], got))
            for zero in ("touch-corner", "collinear", "crossing",
                         "contains-query", "inside-query", "line-inside",
                         "multi"):
                assert d[zero] == 0.0, zero
            assert d["query-in-hole"] == pytest.approx(0.5)
            assert d["far-square"] > 0.5
            # padded slots: no valid edge
            assert np.all(got[len(geoms):] == np.float32(np.sqrt(
                np.float32(3.4e38))))


@pytest.mark.parametrize("which", ["edge-cases", "random"])
def test_point_to_geoms_dist_matches_jax(which):
    geoms = (_edge_case_geoms() if which == "edge-cases"
             else _random_geoms(np.random.default_rng(6), 120))
    jgb, tgb = _batches(geoms)
    rng = np.random.default_rng(7)
    pts = [(4.0, 4.0), (3.5, 3.5), (2.0, 3.0), (5.0, 5.0), (7.5, 7.2),
           (0.0, 0.0)] + [tuple(map(float, p))
                          for p in rng.uniform(0, 10, (10, 2))]
    for x, y in pts:
        want = np.asarray(JG.point_to_geoms_dist(jnp.float32(x),
                                                 jnp.float32(y), jgb))
        got = TG.point_to_geoms_dist(torch.tensor(x, dtype=torch.float32),
                                     torch.tensor(y, dtype=torch.float32),
                                     tgb).numpy()
        _close(got, want)


def test_cell_rule_and_bbox_dist_match_jax():
    geoms = _edge_case_geoms() + _random_geoms(np.random.default_rng(8), 60)
    jgb, tgb = _batches(geoms)
    qs = _queries()
    for r in (0.0, 0.3, 1.0, 2.5):
        for q in qs:
            cells = sorted(q.cells)
            gn = GRID.guaranteed_cells_mask(r, cells)
            nb = GRID.neighboring_cells_mask(r, cells)
            for jf, tf, m in ((JG.geom_cells_all_within,
                               TG.geom_cells_all_within, gn),
                              (JG.geom_cells_any_within,
                               TG.geom_cells_any_within, nb)):
                want = np.asarray(jf(jgb.cells, jgb.cells_mask,
                                     jnp.asarray(m)))
                got = tf(tgb.cells, tgb.cells_mask, torch.from_numpy(m))
                np.testing.assert_array_equal(got.numpy(), want)
            # the geometry outside the grid has no cell: never in the rule
            i = [g.obj_id for g in geoms].index("no-cell")
            assert not TG.geom_cells_all_within(
                tgb.cells, tgb.cells_mask, torch.ones(100, dtype=bool))[i]
        b = np.asarray(qs[0].bbox, np.float32)
        _close(TG.geoms_bbox_dist(tgb, torch.from_numpy(b)).numpy(),
               np.asarray(JG.geoms_bbox_dist(jgb, jnp.asarray(b))))


def _masks(queries, radius, which):
    rows = {k: [] for k in which}
    for q in queries:
        cells = [q.cell] if hasattr(q, "x") else sorted(q.cells)
        if "gn" in which:
            rows["gn"].append(GRID.guaranteed_cells_mask(radius, cells))
        if "nb" in which:
            rows["nb"].append(GRID.neighboring_cells_mask(radius, cells))
    return [np.stack(rows[k]) for k in which]


def _point_queries():
    from spatialflink_tpu.models import Point as JPoint

    return [JPoint.create(x, y, GRID) for x, y in
            ((4.0, 4.0), (5.5, 5.5), (8.0, 2.0), (1.2, 9.1))]


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("query", ["point", "geometry"])
@pytest.mark.parametrize("radius", [0.6, 1.7])
def test_range_entries_match_jax(query, approximate, radius):
    geoms = _edge_case_geoms() + _random_geoms(np.random.default_rng(9), 80)
    jgb, tgb = _batches(geoms)
    qs = _point_queries() if query == "point" else _queries()
    gn, nb = _masks(qs, radius, ("gn", "nb"))
    if query == "point":
        qx = np.array([q.x for q in qs], np.float32)
        qy = np.array([q.y for q in qs], np.float32)
        want = JG.range_geoms_to_point_queries(
            jgb, jnp.asarray(qx), jnp.asarray(qy), jnp.asarray(gn),
            jnp.asarray(nb), radius, approximate=approximate)
        kw = dict(qx=torch.from_numpy(qx), qy=torch.from_numpy(qy))
    else:
        jq = JEdgeGeomBatch.from_objects(qs, GRID, pad=len(qs))
        want = JG.range_geoms_to_geom_queries(
            jgb, jq, jnp.asarray(gn), jnp.asarray(nb), radius,
            approximate=approximate)
        _, carried = from_jax_arrays(jgb, "cpu", geoms=jq)
        kw = dict(queries=carried["geoms"])
    flag, dist, counts = TG.geom_stream_dist_plain(
        tgb, mode=TG.MODE_RANGE, gn=torch.from_numpy(gn),
        nb=torch.from_numpy(nb), radius=radius, approximate=approximate,
        **kw)
    np.testing.assert_array_equal(flag.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(counts[:, 0].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(counts[:, 1].numpy(), np.asarray(want[2]))
    assert int(counts[:, 1].sum()) > 0 and flag.any()
    # the wrapper takes the plain version on CPU tensors; the entry is its
    # mask and counts
    got = (TG.range_geoms_to_point_queries(
        tgb, kw["qx"], kw["qy"], torch.from_numpy(gn),
        torch.from_numpy(nb), radius, approximate=approximate)
        if query == "point" else TG.range_geoms_to_geom_queries(
            tgb, kw["queries"], torch.from_numpy(gn), torch.from_numpy(nb),
            radius, approximate=approximate))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # distances: +inf where the rule does not consult one; the consulted
    # ones are the JAX package's single-query distances
    for q in range(len(qs)):
        consulted = np.isfinite(dist[q].numpy())
        if query == "point":
            d = (JD.point_bbox_dist(qx[q], qy[q], *np.asarray(jgb.bbox).T)
                 if approximate else
                 JG.point_to_geoms_dist(jnp.float32(qx[q]),
                                        jnp.float32(qy[q]), jgb))
        else:
            d = (JG.geoms_bbox_dist(jgb, jq.bbox[q]) if approximate else
                 JG.geoms_to_single_geom_dist(jgb, jq.edges[q],
                                              jq.edge_mask[q],
                                              jq.is_areal[q]))
        _close(dist[q].numpy()[consulted], np.asarray(d)[consulted])
        # the rule's consulted set, by the JAX package's predicates
        all_gn = np.asarray(JG.geom_cells_all_within(
            jgb.cells, jgb.cells_mask, jnp.asarray(gn[q])))
        any_nb = np.asarray(JG.geom_cells_any_within(
            jgb.cells, jgb.cells_mask, jnp.asarray(nb[q])))
        np.testing.assert_array_equal(
            consulted, np.asarray(jgb.valid) & any_nb & ~all_gn)
        mask, gn_c, ev = JR.range_filter_geom_stream_stats(
            jnp.asarray(all_gn), jnp.asarray(any_nb), jnp.asarray(d),
            radius, jgb.valid)
        np.testing.assert_array_equal(flag[q].numpy(), np.asarray(mask))


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("query", ["point", "geometry"])
def test_knn_entries_match_jax(query, approximate):
    geoms = _edge_case_geoms() + _random_geoms(np.random.default_rng(10),
                                               80)
    jgb, tgb = _batches(geoms)
    qs = _point_queries() if query == "point" else _queries()
    (nb,) = _masks(qs, 1.2, ("nb",))
    if query == "point":
        qx = np.array([q.x for q in qs], np.float32)
        qy = np.array([q.y for q in qs], np.float32)
        want, wevals = JG.knn_geoms_to_point_queries(
            jgb, jnp.asarray(qx), jnp.asarray(qy), jnp.asarray(nb), k=7,
            approximate=approximate, strategy="sort")
        got, evals = TG.knn_geoms_to_point_queries(
            tgb, torch.from_numpy(qx), torch.from_numpy(qy),
            torch.from_numpy(nb), k=7, approximate=approximate)
    else:
        jq = JEdgeGeomBatch.from_objects(qs, GRID, pad=len(qs))
        want, wevals = JG.knn_geoms_to_geom_queries(
            jgb, jq, jnp.asarray(nb), k=7, approximate=approximate,
            strategy="sort")
        _, carried = from_jax_arrays(jgb, "cpu", geoms=jq)
        got, evals = TG.knn_geoms_to_geom_queries(
            tgb, carried["geoms"], torch.from_numpy(nb), k=7,
            approximate=approximate)
    np.testing.assert_array_equal(evals.numpy(), np.asarray(wevals))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    assert v.sum() > 0
    np.testing.assert_array_equal(got.obj_id.numpy()[v],
                                  np.asarray(want.obj_id)[v])
    _close(got.dist.numpy()[v], np.asarray(want.dist)[v])


def test_geom_stream_dist_argument_checks():
    geoms = _edge_case_geoms()
    _, tgb = _batches(geoms)
    (nb,) = _masks(_point_queries(), 1.0, ("nb",))
    nb = torch.from_numpy(nb)
    x = torch.zeros(4, dtype=torch.float32)
    with pytest.raises(ValueError, match="exactly one"):
        TG.geom_stream_dist(tgb, mode=TG.MODE_KNN, nb=nb)
    with pytest.raises(ValueError, match="needs gn"):
        TG.geom_stream_dist(tgb, mode=TG.MODE_RANGE, nb=nb, qx=x, qy=x)
    with pytest.raises(ValueError, match="unknown mode"):
        TG.geom_stream_dist(tgb, mode=7, nb=nb, qx=x, qy=x)


def _seg_arrays(rng, n, scale):
    return rng.integers(-scale, scale + 1, (n, 4)).astype(np.float32)


def test_segment_math_matches_jax():
    """Touching, collinear, crossing and zero-length segments among small
    integer coordinates (whose orientations are exact on both sides), and
    random real ones."""
    rng = np.random.default_rng(11)
    a = np.concatenate([_seg_arrays(rng, 4000, 3),
                        rng.uniform(-2, 2, (4000, 4)).astype(np.float32)])
    b = np.concatenate([_seg_arrays(rng, 4000, 3),
                        rng.uniform(-2, 2, (4000, 4)).astype(np.float32)])
    a[:50, 2:] = a[:50, :2]  # zero-length segments
    want_x = np.asarray(JD.segments_intersect(jnp.asarray(a),
                                              jnp.asarray(b)))
    got_x = TD.segments_intersect(torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got_x, want_x)
    assert want_x.sum() > 100
    want = np.asarray(JD.seg_seg_dist2(jnp.asarray(a), jnp.asarray(b)))
    got = TD.seg_seg_dist2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    _close(got, want)
    # integer touching / collinear cases give an exact 0 on both sides
    touch = (want[:4000] == 0) & ~want_x[:4000]
    assert touch.sum() > 50
    np.testing.assert_array_equal(got[:4000][touch], 0.0)
    ba = rng.uniform(0, 5, (500, 4)).astype(np.float32)
    bb = rng.uniform(0, 5, (500, 4)).astype(np.float32)
    ba[:, 2:] += ba[:, :2]
    bb[:, 2:] += bb[:, :2]
    _close(TD.bbox_bbox_dist(torch.from_numpy(ba),
                             torch.from_numpy(bb)).numpy(),
           np.asarray(JD.bbox_bbox_dist(jnp.asarray(ba), jnp.asarray(bb))))


_coord = st.integers(-4, 4).map(float) | st.floats(-4, 4, width=32)
_edge = st.tuples(_coord, _coord, _coord, _coord)


@settings(max_examples=60, deadline=None)
@given(ea=st.lists(_edge, min_size=6, max_size=6),
       eb=st.lists(_edge, min_size=6, max_size=6),
       ma=st.lists(st.booleans(), min_size=6, max_size=6),
       mb=st.lists(st.booleans(), min_size=6, max_size=6))
def test_edges_edges_dist2_property(ea, eb, ma, mb):
    """Six edges a side (one compiled shape), any subset of them valid."""
    a, b = np.asarray(ea, np.float32), np.asarray(eb, np.float32)
    ma, mb = np.asarray(ma), np.asarray(mb)
    want = float(JD.edges_edges_dist2(jnp.asarray(a), jnp.asarray(ma),
                                      jnp.asarray(b), jnp.asarray(mb)))
    got = float(TD.edges_edges_dist2(torch.from_numpy(a),
                                     torch.from_numpy(ma),
                                     torch.from_numpy(b),
                                     torch.from_numpy(mb)))
    if not (ma.any() and mb.any()):
        assert got == want == np.float32(3.4e38)
    else:  # squared: two ulps of 4 in the distance make ~16 ulps of 16
        assert got == pytest.approx(
            want, rel=1e-6, abs=16 * float(np.spacing(np.float32(16))))
