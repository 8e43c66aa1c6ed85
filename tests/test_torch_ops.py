"""The PyTorch port's ops (CPU tensors: the kernels' plain versions) against
the JAX package's, on the same seeded inputs.

pip_dist: the JAX side runs its Pallas kernel in interpret mode, as
tests/test_pallas.py does; distances agree within that file's tolerance
(rtol=atol=1e-5). Range masks and counts must be identical on data where no
point lies within 1e-5 of the radius (asserted per case).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatialflink_tpu.index import UniformGrid as JGrid
from spatialflink_tpu.index.uniform_grid import cheb_layers as jax_cheb_layers
from spatialflink_tpu.models import PointBatch as JPointBatch
from spatialflink_tpu.models.batches import single_query_edges as jax_edges
from spatialflink_tpu.models.objects import LineString as JLineString
from spatialflink_tpu.models.objects import Polygon as JPolygon
from spatialflink_tpu.ops import pallas_kernels as PK
from spatialflink_tpu.ops import range as JR
from spatialflink_tpu.utils import bucket_size as jax_bucket_size

from spatialflink_tpu_torch.index import UniformGrid, cheb_layers
from spatialflink_tpu_torch.models import (LineString, Polygon,
                                            from_jax_arrays,
                                            single_query_edges)
from spatialflink_tpu_torch.ops import hopper_kernels as HK
from spatialflink_tpu_torch.ops import range as R
from spatialflink_tpu_torch.utils import bucket_size

DIST_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_pallas.py:41-42

# pytest workers import every test module: one intra-op thread keeps this
# file's small CPU tensors from competing with the timed tests that
# other workers run at the same time
torch.set_num_threads(1)


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setenv("SPATIALFLINK_PALLAS", "interpret")


def _jgrid():
    return JGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)


def _batches(n, seed, lo=0.0, hi=10.0):
    """The same seeded points as a JAX PointBatch and the port's."""
    rng = np.random.default_rng(seed)
    jb = JPointBatch.from_arrays(rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
                                 grid=_jgrid())
    pb, _ = from_jax_arrays(jb._asdict(), "cpu")
    return jb, pb


def _ring(n_vert, r=3.0):
    th = np.linspace(0, 2 * np.pi, n_vert, endpoint=False)
    ring = [(5 + r * float(np.cos(t)), 5 + r * float(np.sin(t))) for t in th]
    return ring + [ring[0]]


def _large_ring():
    th = np.linspace(0, 2 * np.pi, 1301, endpoint=False)
    ring = [(5 + 3.5 * float(np.cos(t)) * (1 + 0.1 * float(np.sin(9 * t))),
             5 + 3.5 * float(np.sin(t)) * (1 + 0.1 * float(np.cos(7 * t))))
            for t in th]
    return ring + [ring[0]]


# the cases of tests/test_pallas.py:44-123 (geometry, points, seed)
PIP_CASES = {
    "polygon": (lambda P, L: P.create([[(2, 2), (6, 2), (6, 6), (2, 6),
                                        (2, 2)]]), 333, 1),
    "hole": (lambda P, L: P.create([[(1, 1), (8, 1), (8, 8), (1, 8), (1, 1)],
                                    [(3, 3), (5, 3), (5, 5), (3, 3)]]),
             257, 2),
    "linestring": (lambda P, L: L.create([(0.5, 0.5), (4, 7), (9, 3)]),
                   130, 3),
    "large": (lambda P, L: P.create([_large_ring()]), 211, 9),
    "chunk512": (lambda P, L: P.create([_ring(512)]), 97, 512),
    "chunk513": (lambda P, L: P.create([_ring(513)]), 97, 513),
}


@pytest.mark.parametrize("case", sorted(PIP_CASES))
def test_pip_dist_matches_pallas(interpret_mode, case):
    make, n, seed = PIP_CASES[case]
    jgeom, geom = make(JPolygon, JLineString), make(Polygon, LineString)
    areal = isinstance(geom, Polygon)
    jb, pb = _batches(n, seed)
    je, jm = jax_edges(jgeom)
    e, m = single_query_edges(geom)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(m, jm)
    want = np.asarray(PK.pip_dist(jnp.asarray(jb.x), jnp.asarray(jb.y),
                                  jnp.asarray(je), jnp.asarray(jm), areal))
    _, q = from_jax_arrays(jb._asdict(), "cpu", edges=je, edge_mask=jm)
    got = HK.pip_dist(pb.x, pb.y, q["edges"], q["edge_mask"], areal)
    assert got.dtype == torch.float32 and got.shape == (pb.capacity,)
    np.testing.assert_allclose(got.numpy(), want, **DIST_TOL)
    if case == "large":
        assert e.shape[0] > HK.EDGE_CHUNK  # streams several edge chunks


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_pip_dist_empty_edges(monkeypatch, mode):
    monkeypatch.setenv("SPATIALFLINK_PALLAS", mode)
    px = np.array([1.0, 2.0], np.float32)
    want = np.asarray(PK.pip_dist(jnp.asarray(px), jnp.asarray(px),
                                  jnp.zeros((0, 4), jnp.float32),
                                  jnp.zeros((0,), bool), True))
    got = HK.pip_dist(torch.from_numpy(px), torch.from_numpy(px),
                      torch.zeros((0, 4)), torch.zeros(0, dtype=torch.bool),
                      True)
    assert np.all(want > 1e18) and np.all(got.numpy() > 1e18)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_pip_dist_plain_blocks_are_exact(monkeypatch):
    """The plain version's point blocks (bounded intermediates) give the
    same bits as one block."""
    _, pb = _batches(500, 4)
    e, m = single_query_edges(Polygon.create([_ring(40)]))
    e, m = torch.from_numpy(e), torch.from_numpy(m)
    whole = HK.pip_dist_plain(pb.x, pb.y, e, m, True)
    monkeypatch.setattr(HK, "_PLAIN_ELEMS", 7 * e.shape[0])
    assert torch.equal(HK.pip_dist_plain(pb.x, pb.y, e, m, True), whole)


@pytest.mark.parametrize("ne,ep", [(0, 64), (2, 64), (64, 64), (65, 128),
                                   (512, 512), (513, 1024), (1301, 1536)])
def test_edge_bucketing_matches_pallas(ne, ep):
    want = (PK._ceil_to(ne, 64) if ne <= PK._EDGE_CHUNK
            else PK._ceil_to(ne, PK._EDGE_CHUNK))
    assert HK.bucket_edges(ne) == want == ep


def _far_from(d, radius):
    d = np.asarray(d, np.float64)
    return np.all(np.abs(d[np.isfinite(d)] - radius) > 1e-5)


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("q,radius", [((5.2, 4.7), 2.0), ((0.3, 9.6), 3.3),
                                      ((5.0, 5.0), 0.9)])
def test_range_filter_point_stats(q, radius, approximate):
    # some points outside the grid (cell -1 but valid) and padded slots
    jb, pb = _batches(300, 11, lo=-1.0, hi=11.0)
    assert pb.capacity > 300 and (np.asarray(jb.cell)[:300] < 0).any()
    grid = _jgrid()
    qc = int(grid.assign_cell(*q)[0])
    gl, cl = grid.guaranteed_layers(radius), grid.candidate_layers(radius)
    want = JR.range_filter_point_stats(jb, q[0], q[1], jnp.int32(qc), radius,
                                       gl, cl, n=grid.n,
                                       approximate=approximate)
    got = R.range_filter_point_stats(pb, q[0], q[1], qc, radius, gl, cl,
                                     n=grid.n, approximate=approximate)
    assert _far_from(np.asarray(want[1]), radius)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].any() and got[0].dtype == torch.bool
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **DIST_TOL)
    assert [int(got[2]), int(got[3])] == [int(want[2]), int(want[3])]


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("radius", [0.4, 1.7])
def test_range_filter_masks_stats(radius, approximate):
    jb, pb = _batches(400, 12, lo=-1.0, hi=11.0)
    grid = _jgrid()
    poly = JPolygon.create([[(2, 2), (6, 2), (6, 6), (2, 6), (2, 2)]],
                           grid=grid)
    cells = sorted(poly.cells)
    gn = grid.guaranteed_cells_mask(radius, cells)
    cn = grid.candidate_cells_mask(radius, cells, gn)
    je, jm = jax_edges(poly)
    from spatialflink_tpu.ops.geom import points_to_single_edges_raw

    inside, mind2 = points_to_single_edges_raw(jb.x, jb.y, jnp.asarray(je),
                                               jnp.asarray(jm))
    dists = np.array(jnp.where(inside, 0.0, jnp.sqrt(mind2)), np.float32)
    assert _far_from(dists, radius)
    want = JR.range_filter_masks_stats(jb, jnp.asarray(gn), jnp.asarray(cn),
                                       jnp.asarray(dists), radius,
                                       approximate=approximate)
    _, q = from_jax_arrays(jb._asdict(), "cpu", gn_mask=gn, cn_mask=cn)
    got = R.range_filter_masks_stats(pb, q["gn_mask"], q["cn_mask"],
                                     torch.from_numpy(dists), radius,
                                     approximate=approximate)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].any()
    assert [int(got[1]), int(got[2])] == [int(want[1]), int(want[2])]


def test_cheb_layers_matches_jax():
    rng = np.random.default_rng(5)
    cells = rng.integers(-1, 100, 500).astype(np.int32)
    for qc in (-1, 0, 37, 99):
        want = np.asarray(jax_cheb_layers(jnp.asarray(cells), jnp.int32(qc),
                                          10))
        got = cheb_layers(torch.from_numpy(cells), qc, 10)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        got_t = cheb_layers(torch.from_numpy(cells),
                            torch.tensor(qc, dtype=torch.int32), 10)
        np.testing.assert_array_equal(got_t.numpy(), want)


def test_bucket_size_matches_jax():
    for n in list(range(0, 600, 7)) + [1 << 20, (1 << 20) + 1]:
        assert bucket_size(n) == jax_bucket_size(n)
        assert bucket_size(n, 8) == jax_bucket_size(n, 8)


def test_grid_masks_and_layers_match_jax():
    jg = JGrid(115.5, 117.6, 39.6, 41.1, num_grid_partitions=100)
    g = UniformGrid(115.5, 117.6, 39.6, 41.1, num_grid_partitions=100)
    rng = np.random.default_rng(6)
    x, y = rng.uniform(115, 118, 200), rng.uniform(39, 42, 200)
    np.testing.assert_array_equal(g.assign_cell(x, y)[0],
                                  jg.assign_cell(x, y)[0])
    for r in (0.0, 0.005, 0.05, 0.5):
        assert g.guaranteed_layers(r) == jg.guaranteed_layers(r)
        assert g.candidate_layers(r) == jg.candidate_layers(r)
        cells = [0, 517, 9999]
        np.testing.assert_array_equal(g.guaranteed_cells_mask(r, cells),
                                      jg.guaranteed_cells_mask(r, cells))
        np.testing.assert_array_equal(g.candidate_cells_mask(r, cells),
                                      jg.candidate_cells_mask(r, cells))
        np.testing.assert_array_equal(g.neighboring_cells_mask(r, cells),
                                      jg.neighboring_cells_mask(r, cells))


def test_from_jax_arrays_fixes_dtypes():
    jb, _ = _batches(10, 3)
    fields = jb._asdict()
    fields["x"] = np.asarray(fields["x"], np.float64)  # f64 must not leak
    pb, q = from_jax_arrays(fields, "cpu",
                            edges=np.zeros((8, 4)), gn_mask=np.ones(4, int))
    assert [t.dtype for t in pb] == [torch.float32, torch.float32,
                                     torch.int32, torch.int32, torch.int32,
                                     torch.bool]
    assert q["edges"].dtype == torch.float32
    assert q["gn_mask"].dtype == torch.bool
    with pytest.raises(ValueError):
        from_jax_arrays(fields, "cpu", bogus=np.zeros(3))

