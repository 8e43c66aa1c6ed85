"""K4, K4x, K1 (single and with a query axis) and K2 against their plain
PyTorch versions on the card, bit for bit.

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
                                            PointBatch, Polygon,
                                            single_query_edges)
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
def test_pip_lattice_kernel_equals_plain(card):
    _, b = _batch(card)
    gb = _lattice_geoms(card)
    assert gb.edges.shape[1] > HK.EDGE_CHUNK  # several edge chunks
    launches = HK.pip_lattice.launches
    got = HK.pip_lattice(b.x, b.y, gb.edges, gb.edge_mask, gb.is_areal)
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
    qx = torch.tensor([5.25, 1.0, 9.5, 3.3], device=card)
    qy = torch.tensor([4.75, 9.0, 0.5, 3.3], device=card)
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
