"""K2 and the windowed kNN options 51, 56 and 61: the PyTorch port on the CPU
(the kernel's plain version) against the JAX package on the same seeded
inputs.

kNN lists must match as (obj_id, dist) in order — equal ids, equal
validity, distances within 1e-6 relative (the two packages may round a
distance differently in the last ulp). Ties break by ascending interned
id in both.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatialflink_tpu import driver as JD
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.index import UniformGrid as JGrid
from spatialflink_tpu.models import PointBatch as JPointBatch
from spatialflink_tpu.ops import knn as JK

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch import operators as TO
from spatialflink_tpu_torch.config import Params as TParams
from spatialflink_tpu_torch.models import from_jax_arrays
from spatialflink_tpu_torch.ops import knn as K

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "conf", "spatialflink-conf.yml")
T0 = 1_700_000_000_000
GRID = JGrid(115.50, 117.60, 39.60, 41.10, num_grid_partitions=100)
Q = (116.5, 40.5)

# pytest workers import every test module: one intra-op thread keeps this
# file's small CPU tensors from competing with the timed tests that
# other workers run at the same time
torch.set_num_threads(1)


def _batch(case, seed=0):
    """(JAX PointBatch, port PointBatch, num_ids) for one named case."""
    rng = np.random.default_rng(seed)
    n = {"prefilter_65536": 65_536}.get(case, 3_000)
    x = rng.uniform(115.4, 117.7, n)  # a margin outside the grid
    y = rng.uniform(39.5, 41.2, n)
    ids = {"few_objects": 7}.get(case, n // 3)
    oid = rng.integers(0, ids, n).astype(np.int32)
    if case == "ties":
        # 120 objects at one point: an exact tie across the k-th place
        x[:120], y[:120] = Q[0] + 0.003, Q[1] - 0.002
        oid[:120] = rng.permutation(ids)[:120]
    jb = JPointBatch.from_arrays(x, y, grid=GRID, obj_id=oid)
    pb, _ = from_jax_arrays(jb._asdict(), "cpu")
    return jb, pb, ids


def _assert_same(got, want):
    """(KnnResult, count) of the port against the JAX package's."""
    res, evals = got
    jres, jevals = want
    np.testing.assert_array_equal(res.obj_id.numpy(), np.asarray(jres.obj_id))
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(jres.valid))
    np.testing.assert_allclose(res.dist.numpy(), np.asarray(jres.dist),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.asarray(evals), np.asarray(jevals))
    assert res.obj_id.dtype == torch.int32 and res.dist.dtype == torch.float32


CASES = ["radius", "radius0", "few_objects", "none", "ties",
         "prefilter_65536"]


@pytest.mark.parametrize("k", [1, 10, 50])
@pytest.mark.parametrize("case", CASES)
def test_knn_point_stats_matches_jax(case, k):
    jb, pb, ids = _batch(case)
    qc = -1 if case == "none" else int(GRID.assign_cell(*Q)[0])
    nb = GRID.n if case == "radius0" else GRID.candidate_layers(0.5)
    if case == "prefilter_65536":
        assert JK._resolve_auto(pb.capacity) == "prefilter"
    want = JK.knn_point_stats(jb, Q[0], Q[1], jnp.int32(qc), 0.5, nb,
                              n=GRID.n, k=k)
    got = K.knn_point_stats(pb, Q[0], Q[1], qc, nb, n=GRID.n, k=k,
                            num_ids=ids)
    _assert_same(got, want)
    valid = int(got[0].valid.sum())
    if case == "none":
        assert valid == 0 and int(got[1]) == 0
        assert bool((got[0].obj_id == K._OID_SENTINEL).all())
        assert bool((got[0].dist == np.float32(K._BIG)).all())
    elif case == "few_objects":
        assert valid == min(k, 7)
    else:
        assert valid == k
    if case == "ties" and k == 50:
        d = got[0].dist.numpy()
        tied = got[0].obj_id.numpy()[d == d[-1]]
        assert len(tied) > 10 and np.all(np.diff(tied) > 0)


@pytest.mark.parametrize("k", [1, 10, 50])
def test_knn_point_multi_stats_matches_jax(k):
    jb, pb, ids = _batch("ties", seed=3)
    rng = np.random.default_rng(4)
    qx = np.r_[Q[0], rng.uniform(115.6, 117.5, 5), 118.0].astype(np.float32)
    qy = np.r_[Q[1], rng.uniform(39.7, 41.0, 5), 40.0].astype(np.float32)
    qc = np.array([GRID.assign_cell(float(a), float(b))[0]
                   for a, b in zip(qx, qy)], np.int32)  # the last: -1
    assert qc[-1] == -1
    nb = GRID.candidate_layers(0.3)
    want = JK.knn_point_multi_stats(jb, qx, qy, qc, 0.3, nb, n=GRID.n, k=k)
    got = K.knn_point_multi_stats(pb, torch.from_numpy(qx),
                                  torch.from_numpy(qy), torch.from_numpy(qc),
                                  nb, n=GRID.n, k=k, num_ids=ids)
    _assert_same(got, want)
    assert got[0].obj_id.shape == (7, k) and int(got[1][-1]) == 0
    # each row is the single-query result
    for q in (0, 3):
        one = K.knn_point_stats(pb, float(qx[q]), float(qy[q]), int(qc[q]),
                                nb, n=GRID.n, k=k, num_ids=ids)
        assert all(torch.equal(a[q], b) for a, b in zip(got[0], one[0]))


@pytest.mark.parametrize("k", [1, 10, 50])
def test_knn_eligible_stats_matches_jax(k):
    rng = np.random.default_rng(6)
    n = 4_000
    oid = rng.integers(0, 500, n).astype(np.int32)
    dists = rng.uniform(0, 1, n).astype(np.float32)
    dists[:300] = 0.0  # ties at 0, as inside a query polygon
    elig = rng.random(n) < 0.6
    want = JK.knn_eligible_stats(jnp.asarray(oid), jnp.asarray(dists),
                                 jnp.asarray(elig), k=k)
    got = K.knn_eligible_stats(torch.from_numpy(oid), torch.from_numpy(dists),
                               torch.from_numpy(elig), k=k)
    _assert_same(got, want)


def test_point_stream_eligibility_matches_jax():
    jb, pb, _ = _batch("radius", seed=2)
    nb = GRID.neighboring_cells_mask(0.3, [517, 4242])
    want = JK.point_stream_eligibility(jb.cell, jb.valid, jnp.asarray(nb))
    got = K.point_stream_eligibility(pb.cell, pb.valid, torch.from_numpy(nb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


@pytest.mark.parametrize("k", [3, 40])
def test_topk_by_distance_matches_jax_sort(k):
    rng = np.random.default_rng(8)
    oid = rng.integers(0, 60, 900).astype(np.int32)
    dist = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0, 2.0]), 900)
    elig = rng.random(900) < 0.5
    want = JK.topk_by_distance(jnp.asarray(oid), jnp.asarray(dist),
                               jnp.asarray(elig), k, "sort")
    got = K.topk_by_distance(torch.from_numpy(oid), torch.from_numpy(dist),
                             torch.from_numpy(elig), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _large_batch(seed=12, n=12_000, ids=4_000):
    rng = np.random.default_rng(seed)
    x = rng.uniform(115.4, 117.7, n)
    y = rng.uniform(39.5, 41.2, n)
    oid = rng.integers(0, ids, n).astype(np.int32)
    jb = JPointBatch.from_arrays(x, y, grid=GRID, obj_id=oid)
    pb, _ = from_jax_arrays(jb._asdict(), "cpu")
    return jb, pb, ids


@pytest.mark.parametrize("k", [1025, 2048, 6000])
@pytest.mark.parametrize("form", ["point", "multi", "eligible"])
def test_k_above_1024_matches_jax(form, k):
    """Any k, as in the JAX package: k = 1,025 and 2,048 below the 4,000
    objects, and 6,000 above them (every object listed, the rest
    padded), through K2's three entry forms."""
    jb, pb, ids = _large_batch()
    nb = GRID.n  # radius 0: every cell
    if form == "point":
        qc = int(GRID.assign_cell(*Q)[0])
        want = JK.knn_point_stats(jb, Q[0], Q[1], jnp.int32(qc), 0.0, nb,
                                  n=GRID.n, k=k)
        got = K.knn_point_stats(pb, Q[0], Q[1], qc, nb, n=GRID.n, k=k,
                                num_ids=ids)
    elif form == "multi":
        qx = np.float32([Q[0], 116.9, 117.65])
        qy = np.float32([Q[1], 40.1, 41.15])
        qc = np.array([GRID.assign_cell(float(a), float(b))[0]
                       for a, b in zip(qx, qy)], np.int32)
        want = JK.knn_point_multi_stats(jb, qx, qy, qc, 0.0, nb, n=GRID.n,
                                        k=k)
        got = K.knn_point_multi_stats(
            pb, torch.from_numpy(qx), torch.from_numpy(qy),
            torch.from_numpy(qc), nb, n=GRID.n, k=k, num_ids=ids)
    else:
        rng = np.random.default_rng(k)
        oid = np.asarray(jb.obj_id)
        dists = rng.choice(np.float32([0.0, 0.125, 0.25, 0.5]), oid.size)
        elig = rng.random(oid.size) < 0.7
        want = JK.knn_eligible_stats(jnp.asarray(oid), jnp.asarray(dists),
                                     jnp.asarray(elig), k=k)
        got = K.knn_eligible_stats(torch.from_numpy(oid),
                                   torch.from_numpy(dists),
                                   torch.from_numpy(elig), k=k)
    _assert_same(got, want)
    most = int(got[0].valid.reshape(-1, k).sum(dim=1).max())
    assert most == k if k < ids else 0 < most < k


def test_approximate_mode_is_exact_selection_over_bbox_distances():
    """The JAX package's approximate kNN keeps only the candidates of
    ``approx_min_k``; the port keeps its exact selection. So the port
    equals JAX's ``sort`` strategy, and JAX's ``approx`` list is a prefix
    of the port's: here one object owns the 2,000 nearest points, so the
    candidates hold fewer than k distinct objects."""
    rng = np.random.default_rng(10)
    n, k = 6_000, 10
    oid = rng.integers(1, 800, n).astype(np.int32)
    d = rng.uniform(0.1, 1.0, n).astype(np.float32)
    d[:2_000] = rng.uniform(0.0, 0.05, 2_000).astype(np.float32)
    oid[:2_000] = 0
    elig = np.ones(n, bool)
    args = (jnp.asarray(oid), jnp.asarray(d), jnp.asarray(elig))
    sort = JK.topk_by_distance(*args, k, "sort")
    approx = JK.topk_by_distance(*args, k, "approx")
    got = K.topk_by_distance(torch.from_numpy(oid), torch.from_numpy(d),
                             torch.from_numpy(elig), k)
    for g, w in zip(got, sort):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    m = int(np.asarray(approx.valid).sum())
    assert 0 < m < k
    np.testing.assert_array_equal(got.obj_id.numpy()[:m],
                                  np.asarray(approx.obj_id)[:m])


# ------------------------------------------------------------------------ #
# options 51, 56 and 61 through run_option


def _stream(n=5000, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.uniform(115.4, 117.7, n)
    y = rng.uniform(39.5, 41.2, n)
    ts = T0 + np.sort(rng.integers(0, 28_000, n))
    back = rng.random(n) < 0.03  # out of order; some beyond the lateness
    ts[back] -= rng.integers(200, 3_000, int(back.sum()))
    x[:40], y[:40] = 116.3137, 40.4219  # duplicated coordinates: ties
    return [f"o{o},{t},{float(a)!r},{float(b)!r}" for o, t, a, b in
            zip(rng.integers(0, 300, n).tolist(), ts.tolist(), x, y)]


def _params(cls, option, approximate=False, k=10, radius=0.5):
    p = cls.from_yaml(CONF)
    p.query.option = option
    p.query.approximate = approximate
    p.query.k = k
    p.query.radius = radius
    return dataclasses.replace(
        p, input1=dataclasses.replace(p.input1, format="CSV"))


def _knn_windows(results):
    return [(w.window_start, w.window_end, dict(w.extras), w.records)
            for w in results]


def assert_knn_windows_equal(got, want):
    assert [w[:3] for w in got] == [w[:3] for w in want]
    assert sum(len(w[3]) for w in want) > 0
    for g, w in zip(got, want):
        per_query = "queries" in w[2]
        rows_g = g[3] if per_query else [g[3]]
        rows_w = w[3] if per_query else [w[3]]
        assert len(rows_g) == len(rows_w)
        for rg, rw in zip(rows_g, rows_w):
            assert [o for o, _ in rg] == [o for o, _ in rw]
            np.testing.assert_allclose([d for _, d in rg],
                                       [d for _, d in rw], rtol=1e-6, atol=0)


class _Recording:
    """Records the operators run_option builds (for their counters)."""

    def __init__(self, monkeypatch):
        self.ops = []
        for name in ("PointPointKNNQuery", "PointGeomKNNQuery",
                     "PointPolygonKNNQuery", "PointLineStringKNNQuery",
                     "PointPointRangeQuery", "PointPolygonRangeQuery",
                     "PointLineStringRangeQuery"):
            base = getattr(TO, name)
            monkeypatch.setattr(TO, name, self._wrap(base))

    def _wrap(self, base):
        rec = self

        class Op(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                rec.ops.append(self)
        return Op


def run_both(monkeypatch, params_j, params_t, lines):
    """(port windows, JAX windows, port counters, JAX counter deltas)."""
    from spatialflink_tpu.utils.metrics import REGISTRY

    names = ("gn-bypassed", "distance-computations")
    before = [REGISTRY.counter(c).count for c in names]
    want = _knn_windows(JD.run_option(params_j, iter(lines)))
    after = [REGISTRY.counter(c).count for c in names]
    rec = _Recording(monkeypatch)
    got = _knn_windows(TD.run_option(params_t, iter(lines), device="cpu"))
    (op,) = rec.ops
    return (got, want, [op.pruning[c] for c in names],
            [a - b for a, b in zip(after, before)])


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("option,k", [(51, 50), (51, 10), (56, 10),
                                      (61, 10)])
def test_run_option_knn_matches_jax(monkeypatch, option, k, approximate):
    lines = _stream()
    got, want, counts, jcounts = run_both(
        monkeypatch, _params(JParams, option, approximate, k),
        _params(TParams, option, approximate, k), lines)
    assert len(want) >= 6 and all(w[2] == {"k": k} for w in want)
    assert_knn_windows_equal(got, want)
    assert counts == jcounts and counts[1] > 0


def test_run_option_knn_radius_zero_matches_jax(monkeypatch):
    lines = _stream(seed=4)
    got, want, counts, jcounts = run_both(
        monkeypatch, _params(JParams, 51, radius=0.0),
        _params(TParams, 51, radius=0.0), lines)
    assert_knn_windows_equal(got, want)
    assert counts == jcounts
