"""The K8 plain versions, the carried trajectory state, K2's exact radius
and K4x's parity against the JAX package's functions on the same seeded
numpy inputs (the CUDA kernels against these plain versions:
tests/test_torch_cuda.py).

Equal: accept / emit flags, sort orders, ids, integer outputs, the
carried last point and last_ts, group extents, heatmaps. Spatial lengths
may differ: the JAX package's running lengths are differences of one f32
cumsum over the whole sorted batch and its XLA distance fuses a
multiply-add, the port sums each run one contribution at a time; they must
agree within 4 * 2**-23 times the batch's total spatial contribution (the
cumsum's rounding). Temporal lengths are equal while a batch's total
temporal contribution stays below 2**24 ms; the precision case below shows
the port exact where the JAX package's cumsum is not.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatialflink_tpu.models import PointBatch as JPointBatch
from spatialflink_tpu.ops import geom as JG
from spatialflink_tpu.ops import knn as JK
from spatialflink_tpu.ops import trajectory as JT
from spatialflink_tpu.runtime.state import TrajStateStore as JStore

from spatialflink_tpu_torch.models import from_jax_arrays
from spatialflink_tpu_torch.ops import hopper_kernels as HK
from spatialflink_tpu_torch.ops import knn as K
from spatialflink_tpu_torch.ops import trajectory as T
from spatialflink_tpu_torch.runtime.state import TrajStateStore

SPATIAL_ULPS = 4 * 2.0 ** -23
torch.set_num_threads(1)


def _batch(seed, n=1_500, ids=60, t0=0, span=6_000, cells=None):
    """(JAX PointBatch, port PointBatch): out-of-order timestamps, (object,
    ts) ties at other coordinates, padding to the bucket, and (with
    ``cells``) cell ids with some -1."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(116.0, 117.0, n)
    y = rng.uniform(40.0, 41.0, n)
    oid = rng.integers(0, ids, n).astype(np.int32)
    ts = t0 + rng.integers(0, span, n)
    dup = np.nonzero(rng.random(n) < 0.05)[0]
    dup = dup[dup > 0]
    oid[dup], ts[dup] = oid[dup - 1], ts[dup - 1]
    kw = {}
    if cells is not None:
        c = rng.integers(0, cells, n).astype(np.int32)
        c[rng.random(n) < 0.05] = -1
        kw["cell"] = c
    jb = JPointBatch.from_arrays(x, y, obj_id=oid, ts=ts, ts_base=0, **kw)
    return jb, from_jax_arrays(jb._asdict(), "cpu")[0]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _spatial_close(want, got, total):
    bound = SPATIAL_ULPS * total
    assert np.all(np.abs(_np(got).astype(np.float64)
                         - _np(want).astype(np.float64)) <= bound), bound


@pytest.mark.parametrize("m", [256, 1024])
def test_tstats_update_plain_matches_jax(m):
    """Three batches with carried state (both packages start from the same
    state, a quarter of it uninitialised), a rebase of the int32 offsets
    between batches two and three, out-of-order points and (object, ts)
    ties."""
    rng = np.random.default_rng(7)
    js = JT.TrajStatsState.zeros(m)
    init = rng.random(m) < 0.75
    js = js._replace(
        last_ts=jnp.asarray(np.where(init, rng.integers(-3_000, 500, m),
                                     T.INT32_MIN).astype(np.int32)),
        last_x=jnp.asarray(rng.uniform(116, 117, m).astype(np.float32)),
        last_y=jnp.asarray(rng.uniform(40, 41, m).astype(np.float32)),
        spatial=jnp.asarray(rng.uniform(0, 2, m).astype(np.float32)),
        temporal=jnp.asarray(np.where(init, rng.integers(0, 9_000, m), 0)
                             .astype(np.float32)))
    jstore, tstore = JStore(capacity=m), TrajStateStore.from_numpy(
        {k: np.asarray(v) for k, v in js._asdict().items()})
    jstore.state = js
    emitted = 0
    for step, delta in enumerate((0, 0, 2_500)):
        jstore.rebase_ts(delta)
        tstore.rebase_ts(delta)
        jb, tb = _batch(step, ids=m // 4, t0=1_000 * step)
        before = np.asarray(jstore.state.spatial).copy()
        jstore.state, jo = JT.tstats_update(jstore.state, jb)
        tstore.state, to = T.tstats_update(tstore.state, tb)
        emit = np.asarray(jo.emit)
        assert np.array_equal(_np(to.emit), emit)
        assert np.array_equal(_np(to.order), np.asarray(jo.order))
        assert np.array_equal(_np(to.obj_id)[emit], np.asarray(jo.obj_id)[emit])
        assert np.array_equal(_np(to.temporal)[emit],
                              np.asarray(jo.temporal)[emit])
        total = float((np.asarray(jstore.state.spatial) - before).sum())
        _spatial_close(np.asarray(jo.spatial)[emit], _np(to.spatial)[emit],
                       total)
        for name in ("last_x", "last_y", "last_ts", "temporal"):
            assert np.array_equal(_np(getattr(tstore.state, name)),
                                  np.asarray(getattr(jstore.state, name)))
        _spatial_close(jstore.state.spatial, tstore.state.spatial, total)
        emitted += int(emit.sum())
    assert emitted > 1_000


def test_state_store_matches_jax():
    """ensure grows as the JAX store does; rebase_ts saturates at the same
    floor and ceiling and keeps the uninitialised sentinel."""
    lt = np.array([T.INT32_MIN, -(2 ** 30) + 5, -5, 0, 7, 2 ** 31 - 10,
                   2 ** 30], np.int32)
    for delta in (0, 3, 100, -100, 2 ** 30, -(2 ** 30), 2 ** 31 + 5,
                  -(2 ** 31) - 5, 2 ** 31 - 1):
        js = JStore(capacity=lt.size)
        js.state = js.state._replace(last_ts=jnp.asarray(lt))
        ts = TrajStateStore.from_numpy(
            {k: np.asarray(v) for k, v in js.state._asdict().items()})
        js.rebase_ts(delta)
        ts.rebase_ts(delta)
        assert np.array_equal(_np(ts.state.last_ts),
                              np.asarray(js.state.last_ts)), delta
    js, ts = JStore(), TrajStateStore()
    for need in (10, 257, 600, 5_000):
        js.ensure(need)
        ts.ensure(need)
        assert ts.capacity == js.capacity
        for name in ts.state._fields:
            assert np.array_equal(_np(getattr(ts.state, name)),
                                  np.asarray(getattr(js.state, name)))


@pytest.mark.parametrize("seed", [0, 1])
def test_tstats_window_summary_plain_matches_jax(seed):
    jb, tb = _batch(seed, n=2_000, ids=90)
    m = 256
    js = JT.tstats_window_summary(jb, m=m)
    ts = T.tstats_window_summary(tb, m=m)
    for name in js._fields:
        if name != "spatial":
            assert np.array_equal(_np(getattr(ts, name)),
                                  np.asarray(getattr(js, name))), name
    _spatial_close(js.spatial, ts.spatial, float(np.asarray(js.spatial).sum()))
    assert int(np.asarray(js.count)[90:].sum()) == 0  # absent objects


@pytest.mark.parametrize("seed", [0, 1])
def test_taggregate_plain_matches_jax(seed):
    """K8c's extents, padded and out-of-grid slots included, and K8d's
    heatmap for every aggregate."""
    cells = 64
    jb, tb = _batch(seed, n=3_000, ids=40, cells=cells)
    je = JT.taggregate_group_extents(jb, num_cells=cells)
    te = T.taggregate_group_extents(tb, num_cells=cells)
    for name in je._fields:
        assert np.array_equal(_np(getattr(te, name)),
                              np.asarray(getattr(je, name))), name
    jg = JT.taggregate_groups(jb, num_cells=cells)
    tg = T.taggregate_groups(tb, num_cells=cells)
    for agg in ("SUM", "AVG", "MIN", "MAX", "COUNT"):
        want = np.asarray(JT.taggregate_heatmap(jg, num_cells=cells, agg=agg))
        got = _np(T.taggregate_heatmap(tg, num_cells=cells, agg=agg))
        assert np.array_equal(got, want), agg
    with pytest.raises(ValueError, match="unknown aggregate"):
        T.taggregate_heatmap(tg, num_cells=cells, agg="MEDIAN")


def test_host_merges_match_jax():
    rng = np.random.default_rng(3)
    parts = []
    for p in range(3):
        m = 64 + 32 * p
        cnt = rng.integers(0, 4, m)
        parts.append(dict(
            spatial=rng.uniform(0, 1, m).astype(np.float32), count=cnt,
            min_ts=np.where(cnt > 0, 1_000 * p + rng.integers(0, 500, m),
                            np.iinfo(np.int64).max),
            max_ts=np.where(cnt > 0, 1_000 * p + rng.integers(500, 999, m),
                            np.iinfo(np.int64).min),
            **{k: rng.uniform(116, 117, m).astype(np.float32)
               for k in ("first_x", "first_y", "last_x", "last_y")}))
    for a, b in zip(T.tstats_stitch_host(parts), JT.tstats_stitch_host(parts)):
        assert np.array_equal(a, b)
    rows = [tuple(rng.integers(0, 9, 20) for _ in range(4)) for _ in range(3)]
    assert T.taggregate_merge_extents_host(rows) == \
        JT.taggregate_merge_extents_host(rows)


def test_precision_case_port_is_exact():
    """262,144 points of 10,357 trajectories over 10 s on fresh state: the
    port's emitted temporal length of each trajectory equals its exact
    int64 span (last minus first accepted ts); the JAX package's batch-wide
    cumsum is off for some (ROADMAP's known differences)."""
    rng = np.random.default_rng(11)
    n, ids = 262_144, 10_357
    oid = rng.integers(0, ids, n).astype(np.int32)
    ts = rng.integers(0, 10_000, n)
    x = rng.uniform(116.0, 117.0, n)
    y = rng.uniform(40.0, 41.0, n)
    jb = JPointBatch.from_arrays(x, y, obj_id=oid, ts=ts, ts_base=0)
    tb = from_jax_arrays(jb._asdict(), "cpu")[0]
    m = 16_384
    _, to = T.tstats_update(T.TrajStatsState.zeros(m, "cpu"), tb)
    _, jo = JT.tstats_update(JT.TrajStatsState.zeros(m), jb)
    order = np.lexsort((ts, oid))
    lo = np.full(ids, np.iinfo(np.int64).max)
    hi = np.full(ids, np.iinfo(np.int64).min)
    np.minimum.at(lo, oid[order], ts[order])
    np.maximum.at(hi, oid[order], ts[order])

    def final_temporal(out):
        emit = _np(out.emit)
        o = _np(out.obj_id)[emit]
        t = _np(out.temporal)[emit]
        last = np.r_[o[1:] != o[:-1], True]
        return o[last], t[last]

    o, t = final_temporal(to)
    assert o.size > 10_000
    assert np.array_equal(t.astype(np.int64), hi[o] - lo[o])
    jo_ids, jt = final_temporal(jo)
    assert np.array_equal(jo_ids, o)
    assert np.any(jt.astype(np.int64) != hi[o] - lo[o])


@pytest.mark.parametrize("q", [1, 3])
def test_knn_point_enforce_radius_matches_jax(q):
    """K2's exact radius (the trajectory kNN) against the JAX package's
    knn_point / knn_point_multi_stats with enforce_radius."""
    from spatialflink_tpu.index import UniformGrid as JGrid

    grid = JGrid(115.50, 117.60, 39.60, 41.10, num_grid_partitions=100)
    rng = np.random.default_rng(5)
    n = 4_000
    x = rng.uniform(116.3, 116.7, n)
    y = rng.uniform(40.3, 40.7, n)
    oid = rng.integers(0, 500, n).astype(np.int32)
    jb = JPointBatch.from_arrays(x, y, grid=grid, obj_id=oid)
    tb = from_jax_arrays(jb._asdict(), "cpu")[0]
    qx = np.array([116.5, 116.4, 116.6][:q], np.float32)
    qy = np.array([40.5, 40.45, 40.6][:q], np.float32)
    qc = np.array([int(grid.assign_cell(float(a), float(b))[0])
                   for a, b in zip(qx, qy)], np.int32)
    radius, layers = 0.05, grid.candidate_layers(0.05)
    jr, jev = JK.knn_point_multi_stats(jb, qx, qy, qc, radius, layers,
                                       n=grid.n, k=20, enforce_radius=True)
    tr, tev = K.knn_point_multi_stats(tb, qx, qy, qc, layers, n=grid.n, k=20,
                                      num_ids=500, radius=radius)
    assert np.array_equal(_np(tr.obj_id), np.asarray(jr.obj_id))
    assert np.array_equal(_np(tr.valid), np.asarray(jr.valid))
    assert np.allclose(_np(tr.dist), np.asarray(jr.dist), rtol=1e-6)
    assert np.array_equal(_np(tev), np.asarray(jev))
    assert bool((_np(tr.dist)[_np(tr.valid)] <= radius).all())
    single = K.knn_point(tb, qx[0], qy[0], qc[0], radius, layers, n=grid.n,
                         k=20, enforce_radius=True, num_ids=500)
    js = JK.knn_point(jb, qx[0], qy[0], qc[0], radius, layers, n=grid.n,
                      k=20, enforce_radius=True)
    assert np.array_equal(_np(single.obj_id), np.asarray(js.obj_id))


def test_pip_lattice_parity_matches_jax():
    """K4x's parity output (plain version) is the JAX package's
    points_in_geoms, for polygons and a linestring, with points on edges
    and vertices."""
    from spatialflink_tpu.models import EdgeGeomBatch as JEdges
    from spatialflink_tpu.models import LineString as JL
    from spatialflink_tpu.models import Polygon as JP

    geoms = [JP.create([[(116.2, 40.2), (117.0, 40.2), (117.0, 40.9),
                         (116.2, 40.9)]]),
             JP.create([[(116.0, 40.0), (116.6, 40.1), (116.3, 40.7)],
                        [(116.25, 40.2), (116.35, 40.2), (116.3, 40.3)]]),
             JL.create([(116.2, 40.2), (117.0, 40.2), (117.0, 40.9)])]
    gb = JEdges.from_objects(geoms)
    rng = np.random.default_rng(2)
    x = np.r_[rng.uniform(115.9, 117.1, 3_000), [116.2, 117.0, 116.6, 116.2]]
    y = np.r_[rng.uniform(39.9, 41.0, 3_000), [40.2, 40.5, 40.2, 40.9]]
    want = np.asarray(JG.points_in_geoms(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(gb.edges), jnp.asarray(gb.edge_mask)))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in
         (("edges", gb.edges), ("edge_mask", gb.edge_mask),
          ("is_areal", gb.is_areal))}
    dist, inside = HK.pip_lattice(
        torch.from_numpy(x.astype(np.float32)),
        torch.from_numpy(y.astype(np.float32)), t["edges"], t["edge_mask"],
        t["is_areal"], parity=True)
    assert np.array_equal(inside.T.numpy(), want)
    assert torch.equal(dist, HK.pip_lattice(
        torch.from_numpy(x.astype(np.float32)),
        torch.from_numpy(y.astype(np.float32)), t["edges"], t["edge_mask"],
        t["is_areal"]))
    assert want[:, 2].any()  # the linestring's ring parity counts too
