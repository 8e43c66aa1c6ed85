"""The join ops of the PyTorch port (``spatialflink_tpu_torch/ops/join.py``
and the two-stream merges of ``runtime/windows.py``) against the JAX
package on the CPU, on seeded numpy inputs with points outside the grid
(cell -1) and padded (invalid) slots on both sides:

- ``join_mask`` and ``join_pairs_host`` on both branches (the lattice
  budget lowered to force K7's prefilter), the pairs in the JAX order;
- ``join_reduce`` (counts, min d^2, argmin) exactly on dyadic coordinates,
  where every d^2 is exact (ties at equal minima, across tile
  boundaries), and within 1e-6 relative on random ones;
- ``pair_min_cheb``, the point x geometry and geometry x geometry masks,
  and the equality of K5's kNN eligibility over each b geometry's
  neighbouring-cells mask with ``pair_min_cheb <= nb_layers`` (radius 0
  and r > 0);
- ``merge_by_time`` against ``heapq.merge`` (hypothesis).

Float inputs keep every pair's squared distance more than 1e-6 from r^2
(checked), where XLA's FMA could legitimately round a comparison the
other way (ROADMAP known differences).
"""

import heapq

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spatialflink_tpu.index import UniformGrid as JGrid
from spatialflink_tpu.models.batches import EdgeGeomBatch as JEdgeGeomBatch
from spatialflink_tpu.models.batches import PointBatch as JPointBatch
from spatialflink_tpu.ops import join as JJ
from spatialflink_tpu.ops.pallas_kernels import join_reduce as j_join_reduce
from spatialflink_tpu.streams.formats import parse_spatial as j_parse

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import EdgeGeomBatch, PointBatch
from spatialflink_tpu_torch.ops import geom as G
from spatialflink_tpu_torch.ops import join as J
from spatialflink_tpu_torch.runtime.windows import merge_by_time
from spatialflink_tpu_torch.streams.bulk import GeomChunk
from spatialflink_tpu_torch.streams.formats import parse_spatial

CPU = torch.device("cpu")
BBOX = (115.5, 117.6, 39.6, 41.1)
GRID = UniformGrid(*BBOX, num_grid_partitions=30)
JGRID = JGrid(*BBOX, num_grid_partitions=30)

torch.set_num_threads(1)


def _xy(seed, n, lo=(115.4, 39.5), hi=(117.7, 41.2)):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo[0], hi[0], n), rng.uniform(lo[1], hi[1], n)


def _pair(x, y, *, drop=0.1, seed=0, cell=None):
    """(port batch, JAX batch) of the same points, a share invalid."""
    t = PointBatch.from_arrays(x, y, device=CPU, grid=GRID, cell=cell)
    j = JPointBatch.from_arrays(x, y, grid=JGRID, cell=cell)
    keep = np.random.default_rng(seed).random(t.valid.shape[0]) > drop
    t = t._replace(valid=t.valid & torch.from_numpy(keep))
    j = j._replace(valid=np.asarray(j.valid) & keep)
    return t, j


def _clear_of_radius(ax, ay, bx, by, r):
    d2 = (ax[:, None] - bx[None, :]) ** 2 + (ay[:, None] - by[None, :]) ** 2
    return np.abs(d2 - r * r).min() > 1e-6


def _np(t):
    return np.asarray(t)


def _dyadic(seed, n, scale=64.0):
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(115.4, 117.7, n) * scale) / scale
    y = np.round(rng.uniform(39.5, 41.2, n) * scale) / scale
    return x, y


R = 0.05
A_XY, B_XY = _xy(1, 700), _xy(2, 300)


def test_fixture_clear_of_the_radius():
    assert _clear_of_radius(*A_XY, *B_XY, R)
    assert _clear_of_radius(*A_XY, *B_XY, 0.02)


@pytest.mark.parametrize("r,layers", [(R, 3), (0.02, 1), (R, 30),
                                      (R, 2 ** 30)])
def test_join_mask_matches_jax(r, layers):
    (ta, ja), (tb, jb) = _pair(*A_XY, seed=1), _pair(*B_XY, seed=2)
    cx, cy = J.grid_center(GRID)
    got = J.join_mask(ta, tb, r, layers, cx, cy, n=GRID.n)
    want = JJ.join_mask(ja, jb, r, layers, cx, cy, n=JGRID.n)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert got.any()


@pytest.mark.parametrize("budget", [None, 1])
@pytest.mark.parametrize("r", [R, 0.0, 0.3])
def test_join_pairs_host_matches_jax(monkeypatch, budget, r):
    """Both branches, the pairs in the JAX order (by b tile of 4,096, then
    a, then b); the K7 branch gives the direct branch's pairs."""
    # on the 1/64-degree lattice every d^2 is a multiple of 1/4096, at
    # least 5e-5 from r^2 here: far beyond the expansion's rounding
    ax, ay = _dyadic(3, 300)
    bx, by = _dyadic(4, 4500)
    (ta, ja), (tb, jb) = _pair(ax, ay, seed=3), _pair(bx, by, seed=4)
    if r:
        assert _clear_of_radius(ax, ay, bx, by, r)
    if budget is not None:
        monkeypatch.setattr(JJ, "_LATTICE_BUDGET", budget)
        monkeypatch.setattr(J, "_LATTICE_BUDGET", budget)
    parts = list(JJ.join_pairs_host(ja, jb, r, JGRID))
    want = [np.concatenate([p[i] for p in parts]) if parts
            else np.zeros(0, np.int64) for i in (0, 1)]
    got = J.join_pairs_host(ta, tb, r, GRID)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].size > 0
    # the b capacity is 8,192: two b tiles
    assert tb.x.shape[0] == 8192 and (got[1] >= 4096).any()
    if budget is not None:
        monkeypatch.setattr(J, "_LATTICE_BUDGET", 1 << 40)
        direct = J.join_pairs_host(ta, tb, r, GRID)
        assert all(np.array_equal(u, v) for u, v in zip(got, direct))


@pytest.mark.parametrize("tile", [64, 4096])
@pytest.mark.parametrize("r,layers", [(0.05, 2), (0.1, 30), (0.03, 0),
                                      (0.05, 2 ** 30)])
def test_join_reduce_exact_on_dyadic_coordinates(tile, r, layers):
    """Coordinates on a 1/64-degree lattice: every dx, dy and d^2 is exact,
    so the three outputs match bit for bit, with many exact ties at the
    minimum (the earliest b index wins, across tile boundaries too)."""
    ax, ay = _dyadic(5, 900)
    bx, by = _dyadic(6, 1500)
    bx[700:900], by[700:900] = bx[:200], by[:200]  # duplicate b points
    (ta, ja), (tb, jb) = _pair(ax, ay, seed=5), _pair(bx, by, seed=6)
    got = J.join_reduce(ta, tb, r, layers, n=GRID.n, tile=tile)
    want = j_join_reduce(ja, jb, r, layers, n=JGRID.n, tile=tile)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert (got[0] > 1).any() and (got[2] >= 700).any()


def test_join_reduce_cell_rule_has_no_sentinel():
    """A cell of -1 reads as (-1, n - 1) in join_reduce's own cell test: a
    point outside the grid counts a partner outside it, as in the JAX
    scan, where join_mask pairs it with nothing."""
    ax, ay = np.array([115.45, 116.0]), np.array([41.09, 40.0])
    bx, by = np.array([115.51, 115.46]), np.array([41.08, 41.09])
    (ta, ja), (tb, jb) = _pair(ax, ay, drop=0), _pair(bx, by, drop=0)
    got = J.join_reduce(ta, tb, 0.1, 1, n=GRID.n)
    want = j_join_reduce(ja, jb, 0.1, 1, n=JGRID.n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert int(ta.cell[0]) == -1 and int(got[0][0]) == 1
    cx, cy = J.grid_center(GRID)
    assert not J.join_mask(ta, tb, 0.1, 1, cx, cy, n=GRID.n)[0].any()


def test_join_reduce_matches_jax_on_random_coordinates():
    (ta, ja), (tb, jb) = _pair(*A_XY, seed=1), _pair(*B_XY, seed=2)
    got = J.join_reduce(ta, tb, R, 3, n=GRID.n, tile=128)
    want = j_join_reduce(ja, jb, R, 3, n=JGRID.n, tile=128)
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), _np(want[2]))
    np.testing.assert_allclose(got[1].numpy(), _np(want[1]), rtol=1e-6,
                               atol=0)
    assert (got[0] > 0).any()


def test_join_lattice_rows_keep_the_direct_order():
    (ta, _), (tb, _) = _pair(*A_XY, seed=1), _pair(*B_XY, seed=2)
    cx, cy = J.grid_center(GRID)
    ai, bi = J.join_lattice(ta, tb, R, 3, cx, cy, n=GRID.n, tile=64)
    rows = torch.unique(ai)[::2].to(torch.int32)
    si, sj = J.join_lattice(ta, tb, R, 3, cx, cy, n=GRID.n, tile=64,
                            rows=rows)
    keep = torch.isin(ai, rows)
    assert torch.equal(si, ai[keep]) and torch.equal(sj, bi[keep])


def test_lattice_strategy_refuses_bf16_and_typos(monkeypatch):
    monkeypatch.setenv("SPATIALFLINK_JOIN_LATTICE", "bf16")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        J.lattice_strategy()
    monkeypatch.setenv("SPATIALFLINK_JOIN_LATTICE", "bf61")
    with pytest.raises(ValueError, match="expected 'f32' or 'bf16'"):
        J.lattice_strategy()
    monkeypatch.setenv("SPATIALFLINK_JOIN_LATTICE", "F32")
    assert J.lattice_strategy() == "f32"


# ------------------------------------------------------------------------ #
# geometry lattices


def _ring(rng, cx, cy, r, k):
    th = np.sort(rng.uniform(0.0, 2 * np.pi, k))
    ring = [[float(cx + r * np.cos(t)), float(cy + r * np.sin(t))]
            for t in th]
    return ring + [ring[0]]


def _geojson(seed, n):
    import json

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cx, cy = rng.uniform(115.6, 117.5), rng.uniform(39.7, 41.0)
        if i % 9 == 0:  # outside the grid: no cell
            cx = rng.uniform(114.6, 115.3)
        if rng.random() < 0.6:
            g = {"type": "Polygon", "coordinates": [_ring(
                rng, cx, cy, rng.uniform(0.01, 0.09), 6)]}
        else:
            walk = np.cumsum(rng.normal(0, 0.03, (4, 2)), 0) + (cx, cy)
            g = {"type": "LineString", "coordinates": walk.tolist()}
        out.append(json.dumps({"geometry": g, "properties": {
            "oID": f"g{i}", "timestamp": 1_700_000_000_000 + i},
            "type": "Feature"}))
    return out


def _geoms(lines):
    """(port batch, JAX batch) of the same geometries, a share invalid."""
    tg = [parse_spatial(ln, "GeoJSON", GRID, geometry="Polygon")
          for ln in lines]
    jg = [j_parse(ln, "GeoJSON", JGRID, geometry="Polygon") for ln in lines]
    t = EdgeGeomBatch.from_objects(tg, device=CPU)
    j = JEdgeGeomBatch.from_objects(jg, JGRID)
    keep = np.arange(t.valid.shape[0]) % 7 != 3
    return (t._replace(valid=t.valid & torch.from_numpy(keep)),
            j._replace(valid=np.asarray(j.valid) & keep))


GA, GB = _geoms(_geojson(8, 70)), _geoms(_geojson(9, 30))


@pytest.mark.parametrize("layers", [0, 1, 4, 30, 2 ** 30])
def test_pair_min_cheb_matches_jax(layers):
    (ta, ja), (tb, jb) = GA, GB
    got = J.pair_min_cheb(ta.cells, ta.cells_mask, tb.cells, tb.cells_mask,
                          GRID.n)
    want = JJ.pair_min_cheb(ja.cells, ja.cells_mask, jb.cells,
                            jb.cells_mask, JGRID.n)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert (got == 2 ** 30).any() and (got <= 1).any()


@pytest.mark.parametrize("radius", [0.0, 0.03, 0.2])
def test_k5_eligibility_is_the_pair_cell_gate(radius):
    """K5's kNN eligibility of geometry a for query b over b's
    neighbouring-cells mask (``cell_gate_table``) equals
    ``pair_min_cheb(a, b) <= nb_layers`` & a valid, at radius 0 (every
    cell a neighbour of a geometry with one) and r > 0, with geometries
    outside the grid on both sides."""
    (ta, _), (tb, _) = GA, GB
    layers = GRID.n if radius == 0 else GRID.candidate_layers(radius)
    nb = J.cell_gate_table(tb.cells, tb.cells_mask, layers, GRID.n)
    elig = G._geom_elig_multi(ta, nb).T  # (Ga, Gb)
    want = (J.pair_min_cheb(ta.cells, ta.cells_mask, tb.cells,
                            tb.cells_mask, GRID.n) <= layers) \
        & ta.valid[:, None]
    assert torch.equal(elig, want)
    assert want.any() and not want.all()
    # a query geometry outside the grid is nobody's partner, radius 0 too
    outside = ~tb.cells_mask.any(dim=1)
    assert outside.any() and not elig[:, outside].any()


@pytest.mark.parametrize("radius", [0.0, 0.05])
def test_point_geom_mask_matches_jax(radius):
    (tp, jp), (tg, jg) = _pair(*A_XY, seed=1), GB
    layers = GRID.n if radius == 0 else GRID.candidate_layers(radius)
    got = J.join_point_geom_mask(tp, tg, radius, layers, n=GRID.n)
    want = JJ.join_point_geom_mask(jp, jg, radius, layers, n=JGRID.n)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert got.any()


def test_point_geom_gate_forms_agree():
    """The per-cell table gathered at the points' cells equals the pair by
    pair gate (both cell -1 sides included)."""
    tp, _ = _pair(*A_XY, seed=1)
    tg, _ = GB
    for layers in (0, 2, 5):
        table = J.point_geom_gate(tp, tg, layers, GRID.n)
        rows = J.cell_gate_rows(tg.cells, tg.cells_mask, tp.cell, layers,
                                GRID.n)
        assert tp.x.shape[0] > GRID.num_cells and torch.equal(table, rows)


@pytest.mark.parametrize("radius", [0.0, 0.04])
def test_geom_geom_mask_matches_jax(radius):
    (ta, ja), (tb, jb) = GA, GB
    layers = GRID.n if radius == 0 else GRID.candidate_layers(radius)
    got = J.join_geom_geom_mask(ta, tb, radius, layers, n=GRID.n)
    want = JJ.join_geom_geom_mask(ja, jb, radius, layers, n=JGRID.n)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert got.any()


# ------------------------------------------------------------------------ #
# the arrival order of two streams


def _chunks(ts_lists):
    return [GeomChunk([type("R", (), {"timestamp": t})() for t in ts])
            for ts in ts_lists]


@settings(max_examples=120, deadline=None)
@given(st.lists(st.lists(st.integers(0, 30), max_size=6), max_size=5),
       st.lists(st.lists(st.integers(0, 30), max_size=6), max_size=5))
def test_merge_by_time_is_heapq_merge(a, b):
    """Out-of-order streams with equal times, empty chunks and an empty
    side: the runs read back in heapq.merge's order (side 0 first on
    equal keys)."""
    ca, cb = _chunks(a), _chunks(b)
    want = [(s, i) for _, s, i in heapq.merge(
        ((t, 0, i) for i, t in enumerate(x for c in a for x in c)),
        ((t, 1, i) for i, t in enumerate(x for c in b for x in c)),
        key=lambda v: v[0])]
    starts = {}
    for side, chunks in ((0, ca), (1, cb)):
        off = 0
        for c in chunks:
            starts[(side, id(c))] = off
            off += len(c)
    got = [(side, starts[(side, id(ch))] + int(i))
           for side, ch, idx in merge_by_time(ca, cb) for i in idx]
    assert got == want

