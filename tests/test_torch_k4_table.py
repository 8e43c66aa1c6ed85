"""K4's per-cell edge table on the CPU: the table's fold (its listed edges,
its parity bit and its inside flag, :func:`pip_table_fold_plain`, the
kernel's fold as plain PyTorch ops) equals the dense plain version
``pip_dist_plain`` bit for bit (hypothesis over geometries and points on
cell borders, edges, vertices and vertex y values, and cell -1); the cell
margin covers the float64 floor / f32 rounding of cell assignment; the
fold-share count; and the argument checks of K4's ``cell`` / ``table`` and
of K1's ``return_dists``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import (LineString, PointBatch, Polygon,
                                            single_query_edges)
from spatialflink_tpu_torch.ops import hopper_kernels as HK
from spatialflink_tpu_torch.ops import range as R

CPU = torch.device("cpu")
CONF_BBOX = (115.5, 117.6, 39.6, 41.1)  # the conf's gridBBox (x, x, y, y)


def _ring(k, r, cx, cy, wobble, phase=0.0):
    th = phase + np.linspace(0.0, 2.0 * np.pi, k, endpoint=False)
    rr = r * (1.0 + wobble * np.sin(5.0 * th))
    pts = [(float(cx + a * np.cos(t)), float(cy + a * np.sin(t)))
           for a, t in zip(rr, th)]
    return pts + [pts[0]]


def _geometry(kind, rng, grid):
    x0, y0 = grid.min_x, grid.min_y
    span = grid.n * grid.cell_length
    cx, cy = x0 + span * rng.uniform(0.2, 0.8), y0 + span * rng.uniform(0.2,
                                                                        0.8)
    r = span * rng.uniform(0.05, 0.45)
    if kind == "polygon":
        return Polygon.create([_ring(int(rng.integers(3, 48)), r, cx, cy,
                                     rng.uniform(0, 0.4),
                                     rng.uniform(0, 1))])
    if kind == "hole":
        return Polygon.create([_ring(24, r, cx, cy, 0.1),
                               _ring(12, r * 0.4, cx, cy, 0.0)])
    if kind == "linestring":
        k = int(rng.integers(2, 12))
        return LineString.create(list(zip(
            x0 + span * rng.uniform(-0.1, 1.1, k),
            y0 + span * rng.uniform(-0.1, 1.1, k))))
    if kind == "cell-aligned":  # edges on cell borders, vertices on corners
        L = grid.cell_length
        a, b = sorted(rng.choice(grid.n + 1, 2, replace=False))
        c, d = sorted(rng.choice(grid.n + 1, 2, replace=False))
        return Polygon.create([[(x0 + a * L, y0 + c * L),
                                (x0 + b * L, y0 + c * L),
                                (x0 + b * L, y0 + d * L),
                                (x0 + a * L, y0 + d * L)]])
    # larger than the grid's box
    return Polygon.create([[(x0 - span, y0 - span), (x0 + 2 * span, y0 - span),
                            (x0 + 2 * span, y0 + 2 * span),
                            (x0 - span, y0 + 2 * span)]])


def _points(rng, grid, edges, hows):
    """float64 points: random over and beyond the grid, on cell borders,
    on edges, on vertices, at vertex y values, a cluster in one cell near a
    border, and outside the grid (cell -1)."""
    x0, y0 = grid.min_x, grid.min_y
    L = grid.cell_length
    span = grid.n * L
    xs, ys = [], []
    for how in hows:
        m = 32
        if how == "random":
            x = x0 + span * rng.uniform(-0.05, 1.05, m)
            y = y0 + span * rng.uniform(-0.05, 1.05, m)
        elif how == "border":
            x = x0 + L * rng.integers(0, grid.n + 1, m)
            y = y0 + span * rng.uniform(0, 1, m)
            if rng.random() < 0.5:
                x, y = y - y0 + x0, x - x0 + y0
        elif how == "edge":
            e = edges[rng.integers(0, len(edges), m)]
            t = rng.random(m)
            x = e[:, 0] + t * (e[:, 2] - e[:, 0])
            y = e[:, 1] + t * (e[:, 3] - e[:, 1])
        elif how == "vertex":
            e = edges[rng.integers(0, len(edges), m)]
            x, y = e[:, 0].copy(), e[:, 1].copy()
        elif how == "vertex-y":
            e = edges[rng.integers(0, len(edges), m)]
            x, y = x0 + span * rng.uniform(0, 1, m), e[:, 1].copy()
        elif how == "cluster":
            c = x0 + L * rng.integers(0, grid.n + 1)
            x = c + rng.choice([-3e-7, -1e-7, 0.0, 1e-7, 2e-7], m) * span
            y = y0 + span * rng.uniform(0, 1) + rng.uniform(0, L * 0.01, m)
        else:  # outside
            x = x0 - span * rng.uniform(0.01, 0.5, m)
            y = y0 + span * rng.uniform(-0.5, 1.5, m)
        steps = rng.integers(-2, 3, m)  # a few f32 ulps either side
        xs.append(x + steps * np.spacing(np.float32(x)).astype(np.float64))
        ys.append(y - steps * np.spacing(np.float32(y)).astype(np.float64))
    return np.concatenate(xs), np.concatenate(ys)


@st.composite
def _cases(draw):
    conf = draw(st.booleans())
    n = draw(st.sampled_from([1, 3, 7, 10, 20] if conf else [1, 2, 5, 10]))
    kind = draw(st.sampled_from(["polygon", "polygon", "hole", "linestring",
                                 "cell-aligned", "large"]))
    hows = draw(st.lists(st.sampled_from(
        ["random", "border", "edge", "vertex", "vertex-y", "cluster",
         "outside"]), min_size=3, max_size=6))
    return conf, n, kind, hows, draw(st.integers(0, 2 ** 32 - 1))


@settings(max_examples=250, deadline=None)
@given(_cases())
def test_table_fold_equals_dense_plain(case):
    conf, n, kind, hows, seed = case
    box = CONF_BBOX if conf else (0.0, 10.0, 0.0, 10.0)
    grid = UniformGrid(*box, num_grid_partitions=n)
    rng = np.random.default_rng(seed)
    geom = _geometry(kind, rng, grid)
    e_np, m_np = single_query_edges(geom)
    x, y = _points(rng, grid, e_np[m_np].astype(np.float64), hows)
    b = PointBatch.from_arrays(x, y, device=CPU, grid=grid)
    areal = isinstance(geom, Polygon)
    t = HK.pip_table(torch.from_numpy(e_np), torch.from_numpy(m_np), areal,
                     grid, gate=False)
    assert t.bits is not None and t.bits.shape == (grid.num_cells, 1)
    want = HK.pip_dist_plain(b.x, b.y, t.edges, t.edge_mask, areal)
    got = HK.pip_table_fold_plain(b.x, b.y, b.cell, t)
    assert torch.equal(got, want), (kind, n, conf)


@pytest.mark.parametrize("k,table", [(512, True), (513, False),
                                     (1301, False)])
def test_large_geometries(k, table):
    """A table holds one staged chunk of edges (512); above it the kernel
    folds densely, and the wrapper's result is the plain version's."""
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    geom = Polygon.create([_ring(k, 3.0, 5.0, 5.0, 0.1)])
    e, m = (torch.from_numpy(a) for a in single_query_edges(geom))
    t = HK.pip_table(e, m, True, grid, gate=False)
    assert (t.bits is not None) == table
    assert t.edges.shape[0] == HK.bucket_edges(e.shape[0])
    rng = np.random.default_rng(k)
    x, y = _points(rng, grid, e.numpy()[m.numpy()].astype(np.float64),
                   ["random", "edge", "vertex-y", "border", "outside"])
    b = PointBatch.from_arrays(x, y, device=CPU, grid=grid)
    want = HK.pip_dist_plain(b.x, b.y, e, m, True)
    assert torch.equal(HK.pip_dist(b.x, b.y, t.edges, t.edge_mask, True,
                                   cell=b.cell, table=t), want)
    if table:
        assert torch.equal(HK.pip_table_fold_plain(b.x, b.y, b.cell, t), want)


@settings(max_examples=300, deadline=None)
@given(st.booleans(), st.sampled_from([1, 7, 100, 1000]),
       st.integers(0, 2 ** 32 - 1))
def test_cell_margin_covers_assignment_rounding(conf, n, seed):
    """Every point's f32 coordinates lie in its float64-assigned cell's box
    widened by cell_margin(largest |coordinate|)."""
    box = CONF_BBOX if conf else (-3.0, 7.0, 2.0, 12.0)
    grid = UniformGrid(*box, num_grid_partitions=n)
    rng = np.random.default_rng(seed)
    L = grid.cell_length
    k = rng.integers(0, n + 1, 200)
    # on, just inside and just outside cell borders, and anywhere
    x = np.concatenate([grid.min_x + k * L,
                        np.nextafter(grid.min_x + k * L, -np.inf),
                        np.nextafter(grid.min_x + k * L, np.inf),
                        rng.uniform(grid.min_x, grid.min_x + n * L, 200)])
    y = np.concatenate([rng.uniform(grid.min_y, grid.min_y + n * L, 600),
                        grid.min_y + k * L])
    cell, ok = grid.assign_cell(x, y)
    mag = max(abs(v) for v in (grid.min_x, grid.min_x + n * L, grid.min_y,
                               grid.min_y + n * L))
    mc = HK.cell_margin(mag)
    cx, cy = cell[ok] // n, cell[ok] % n
    x32 = x[ok].astype(np.float32).astype(np.float64)
    y32 = y[ok].astype(np.float32).astype(np.float64)
    assert np.all(x32 >= grid.min_x + cx * L - mc)
    assert np.all(x32 <= grid.min_x + (cx + 1) * L + mc)
    assert np.all(y32 >= grid.min_y + cy * L - mc)
    assert np.all(y32 <= grid.min_y + (cy + 1) * L + mc)


def test_cell_margin_scale():
    ulp = float(np.spacing(np.float32(117.6)))
    assert 4 * ulp <= HK.cell_margin(117.6) <= 16 * ulp


def test_main_polygon_table_and_fold_share():
    """The main path's polygon on the conf's grid: the table fold equals
    the dense plain version, and the fold share counts each point's listed
    edges (every valid edge for cell -1, none in an inside cell)."""
    grid = UniformGrid(*CONF_BBOX, num_grid_partitions=100)
    geom = Polygon.create([_ring(64, 0.35, 116.6, 40.55, 0.1)], grid)
    e, m = (torch.from_numpy(a) for a in single_query_edges(geom))
    t = HK.pip_table(e, m, True, grid)
    assert int((t.flags & 2 > 0).sum()) > 0  # some cells wholly inside
    rng = np.random.default_rng(0)
    x = np.r_[rng.uniform(115.5, 117.6, 20_000), 114.0, 118.0]
    y = np.r_[rng.uniform(39.6, 41.1, 20_000), 40.0, 40.0]
    b = PointBatch.from_arrays(x, y, device=CPU, grid=grid)
    assert torch.equal(HK.pip_table_fold_plain(b.x, b.y, b.cell, t),
                       HK.pip_dist_plain(b.x, b.y, t.edges, t.edge_mask,
                                         True))
    share = HK.pip_table_fold_share(b.cell, t)
    listed, in_table = HK._listed(b.cell, t)
    inside = (t.flags[torch.where(in_table, b.cell, 0).long()] & 2 > 0) \
        & in_table
    folds = torch.where(inside, 0, listed.sum(dim=1))
    assert share["valid_edges"] == 64
    assert share["pair_share"] == pytest.approx(
        float(folds.sum()) / (b.capacity * 64))
    # over the valid points alone, a small part of the dense fold
    real = HK.pip_table_fold_share(b.cell[:20_000], t)
    assert 0.0 < real["pair_share"] < real["warp_share"] < 0.3


@pytest.mark.parametrize("cells", [2, 100])
def test_table_listed_share_gate(cells):
    """The listed share is the mean listed edges per cell over the valid
    edges; pip_table keeps its table up to TABLE_MAX_SHARE and from
    TABLE_MIN_EDGES valid edges on (every table with ``gate=False``), and
    the result is the dense plain version's either way."""
    grid = UniformGrid(*CONF_BBOX, num_grid_partitions=cells)
    geom = Polygon.create([_ring(64, 0.35, 116.6, 40.55, 0.1)], grid)
    e, m = (torch.from_numpy(a) for a in single_query_edges(geom))
    full = HK.pip_table(e, m, True, grid, gate=False)
    cell = torch.arange(grid.num_cells, dtype=torch.int32)
    listed, _ = HK._listed(cell, full)
    share = HK.pip_table_listed_share(full)
    assert share == pytest.approx(float(listed.sum()) /
                                  (grid.num_cells * 64))
    kept = HK.pip_table(e, m, True, grid)
    assert (kept.bits is not None) == (share <= HK.TABLE_MAX_SHARE)
    assert (kept.bits is None) == (cells == 2)
    if kept.bits is None:
        assert kept.flags is None and HK.pip_table_listed_share(kept) == 1.0
    line = LineString.create([(116.2, 40.2), (117.0, 40.2), (117.0, 40.9)],
                             grid)
    le, lm = (torch.from_numpy(a) for a in single_query_edges(line))
    assert int(lm.sum()) < HK.TABLE_MIN_EDGES
    assert HK.pip_table(le, lm, False, grid).bits is None
    assert HK.pip_table(le, lm, False, grid, gate=False).bits is not None
    rng = np.random.default_rng(cells)
    b = PointBatch.from_arrays(rng.uniform(115.5, 117.6, 4000),
                               rng.uniform(39.6, 41.1, 4000), device=CPU,
                               grid=grid)
    want = HK.pip_dist_plain(b.x, b.y, full.edges, full.edge_mask, True)
    assert torch.equal(HK.pip_table_fold_plain(b.x, b.y, b.cell, full), want)
    kw = dict(cell=b.cell) if kept.bits is not None else {}
    assert torch.equal(HK.pip_dist(b.x, b.y, kept.edges, kept.edge_mask,
                                   True, table=kept, **kw), want)


def test_pip_dist_table_argument_checks():
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    geom = Polygon.create([[(2, 2), (6, 2), (6, 6), (2, 6)]])
    e, m = (torch.from_numpy(a) for a in single_query_edges(geom))
    t = HK.pip_table(e, m, True, grid, gate=False)
    px = py = torch.full((16,), 4.0)
    cell = torch.full((16,), 44, dtype=torch.int32)
    assert torch.equal(HK.pip_dist(px, py, t.edges, t.edge_mask, True,
                                   cell=cell, table=t), torch.zeros(16))
    with pytest.raises(ValueError, match="own edges"):
        HK.pip_dist(px, py, e, m, True, cell=cell, table=t)
    with pytest.raises(ValueError, match="own edges"):
        HK.pip_dist(px, py, t.edges, t.edge_mask, False, cell=cell, table=t)
    with pytest.raises(ValueError, match="needs the points' cell"):
        HK.pip_dist(px, py, t.edges, t.edge_mask, True, table=t)
    with pytest.raises(TypeError, match="int32"):
        HK.pip_dist(px, py, t.edges, t.edge_mask, True, cell=cell.long(),
                    table=t)
    with pytest.raises(ValueError, match="equal 1-D"):
        HK.pip_dist(px, py, t.edges, t.edge_mask, True, cell=cell[:5],
                    table=t)
    with pytest.raises(ValueError, match="contiguous"):
        HK.pip_dist(px, py, t.edges, t.edge_mask, True,
                    cell=torch.zeros(32, dtype=torch.int32)[::2], table=t)
    with pytest.raises(ValueError, match="without a table"):
        HK.pip_dist(px, py, e, m, True, cell=cell)
    with pytest.raises(TypeError, match="PipTable"):
        HK.pip_dist(px, py, e, m, True, cell=cell, table=(e, m))
    # no table applies (no grid): the wrapper folds densely, cell unused
    dense = HK.pip_table(e, m, True)
    assert dense.bits is None and dense.edges.shape[0] == 64
    assert torch.equal(HK.pip_dist(px, py, dense.edges, dense.edge_mask,
                                   True, table=dense), torch.zeros(16))


def test_range_return_dists_keyword():
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    rng = np.random.default_rng(1)
    b = PointBatch.from_arrays(rng.uniform(0, 10, 300),
                               rng.uniform(0, 10, 300), device=CPU, grid=grid)
    args = (b, 5.2, 4.7, int(grid.assign_cell(5.2, 4.7)[0]), 2.0,
            grid.guaranteed_layers(2.0), grid.candidate_layers(2.0))
    full = R.range_filter_point_stats(*args, n=grid.n)
    bare = R.range_filter_point_stats(*args, n=grid.n, return_dists=False)
    assert full[1] is not None and bare[1] is None
    for a, c in zip(full[::2] + full[3:], bare[::2] + bare[3:]):
        assert torch.equal(a, c)
    with pytest.raises(TypeError, match="return_dists"):
        R.range_filter_point_stats(*args, n=grid.n, return_dists=1)
    with pytest.raises(TypeError, match="return_dists"):
        R.range_filter_point_stats_plain(*args, n=grid.n, return_dists=None)
