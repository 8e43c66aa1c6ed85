"""Realtime mode, the latency variants and count windows on the CPU: the
PyTorch port's run_option (device="cpu") against
spatialflink_tpu.driver.run_option on one seeded 4,096-point CSV stream,
micro-batches of 512 (``realtime_batch_size``).

Options 2/7/12 (range) and 52/57/62 (kNN) realtime, multiQuery 2/7/12/52/57,
the latency variants 8/9/58/59, and options 1 and 51 under
``window.type: COUNT``: bounds and selections identical, kNN (objID,
distance) lists in order with distances within 1e-6 relative (the two
packages may round a distance differently in the last f32 ulp: XLA on the
CPU fuses ``dx*dx + dy*dy`` into an fma). The first micro-batch lies outside
the grid, so realtime mode must drop it. ``latency_ms`` is checked for
presence, sign and length, not by value. Also: ``MicroBatcher`` boundaries
against the JAX package's for decode chunks of 1, 7, 512 and 4,096 records,
and K2's compacted id table in realtime mode.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from spatialflink_tpu import driver as JD
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.runtime.windows import MicroBatcher as JMicroBatcher

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import Params as TParams
from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import Point, PointBatch
from spatialflink_tpu_torch.ops import knn as K
from spatialflink_tpu_torch.runtime import MicroBatcher

from test_torch_knn import assert_knn_windows_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")
T0 = 1_700_000_000_000
N = 4096

torch.set_num_threads(1)


def _stream(n=N, seed=17):
    """CSV rows 'oid,ts,x,y' over 28 s; the first 600 lie west of the grid
    (no micro-batch-0 selection), a few arrive out of order."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(115.55, 117.55, n)
    y = rng.uniform(39.65, 41.05, n)
    x[:600] = rng.uniform(114.0, 115.4, 600)
    ts = T0 + np.sort(rng.integers(0, 28_000, n))
    back = rng.random(n) < 0.03
    ts[back] -= rng.integers(200, 3_000, int(back.sum()))
    return [f"o{o},{t},{float(a)!r},{float(b)!r}" for o, t, a, b in
            zip(rng.integers(0, 300, n).tolist(), ts.tolist(), x, y)]


LINES = _stream()

QUERY_POINTS = [(116.5, 40.5), (116.9, 40.1), (116.0, 40.8)]
QUERY_POLYGONS = [[(116.3, 40.3), (116.6, 40.3), (116.6, 40.6),
                   (116.3, 40.3)]]
QUERY_LINESTRINGS = [[(116.0, 40.0), (116.4, 40.7)]]


def _params(cls, option, *, multi=False, count=False):
    p = cls.from_yaml(CONF)
    p.query.option = option
    p.query.multi_query = multi
    p.query.query_points = QUERY_POINTS
    p.query.query_polygons = [list(map(tuple, r))
                              for r in p.query.query_polygons] + \
        QUERY_POLYGONS
    p.query.query_linestrings = [list(map(tuple, r))
                                 for r in p.query.query_linestrings] + \
        QUERY_LINESTRINGS
    p = dataclasses.replace(p, input1=dataclasses.replace(p.input1,
                                                          format="CSV"))
    if count:  # a 1,000-record window every 300 arrivals
        p = dataclasses.replace(p, window=dataclasses.replace(
            p.window, type="COUNT", interval_s=1000, step_s=300))
    return p


def _windows(results):
    out = []
    for w in results:
        per_query = w.records if "queries" in w.extras else [w.records]
        rows = [[r if isinstance(r, tuple) else
                 (r.obj_id, r.timestamp, r.x, r.y) for r in q]
                for q in per_query]
        out.append((w.window_start, w.window_end, dict(w.extras),
                    rows if "queries" in w.extras else rows[0]))
    return out


def _far_from_radius(option, lines):
    """No record within 1e-5 of the radius of a range option's queries
    (where the two packages' float rounding could differ)."""
    rows = [ln.split(",") for ln in lines]
    x = np.array([float(r[2]) for r in rows], np.float32)
    y = np.array([float(r[3]) for r in rows], np.float32)
    p = _params(JParams, option)
    grid = p.grids()[0]
    if option in (1, 2):
        d = np.stack([np.hypot(x - q.x, y - q.y)
                      for q in p.query_point_objects(grid)])
    else:
        from spatialflink_tpu.models import EdgeGeomBatch, PointBatch as JPB
        from spatialflink_tpu.ops import geom as JG
        geoms = (p.query_polygon_objects(grid) if option in (7, 9, 8)
                 else p.query_linestring_objects(grid))
        d = np.asarray(JG.points_to_geoms_dist(
            JPB.from_arrays(x, y, grid=grid),
            EdgeGeomBatch.from_objects(geoms, grid, pad=len(geoms)))).T
    return bool(np.all(np.abs(d - p.query.radius) > 1e-5))


def _run_both(option, **kw):
    want = _windows(JD.run_option(_params(JParams, option, **kw),
                                  iter(LINES)))
    got = _windows(TD.run_option(_params(TParams, option, **kw),
                                 iter(LINES), device="cpu"))
    return got, want


def _drop_latency(windows):
    return [(s, e, {k: v for k, v in x.items() if k != "latency_ms"}, r)
            for s, e, x, r in windows]


@pytest.mark.parametrize("option,multi", [
    (2, False), (7, False), (12, False), (2, True), (7, True), (12, True),
    (9, False), (8, False)])
def test_range_matches_jax(option, multi):
    assert _far_from_radius(option, LINES)
    got, want = _run_both(option, multi=multi)
    assert _drop_latency(got) == _drop_latency(want)
    selected = [sum(map(len, w[3])) if multi else len(w[3]) for w in want]
    assert sum(selected) > 0
    if option in (2, 7, 12, 9):  # realtime: no empty micro-batch
        assert len(want) < N // 512 and all(selected)
        assert all(w[1] >= w[0] for w in want)
    if option in (8, 9):
        for g, w in zip(got, want):
            lat = g[2]["latency_ms"]
            assert "latency_ms" in w[2]
            assert len(lat) == len(g[3]) and all(v >= 0 for v in lat)


@pytest.mark.parametrize("option,multi", [
    (52, False), (57, False), (62, False), (52, True), (57, True),
    (59, False), (58, False)])
def test_knn_matches_jax(option, multi):
    got, want = _run_both(option, multi=multi)
    assert_knn_windows_equal(_drop_latency(got), _drop_latency(want))
    if option in (52, 57, 62, 59):
        assert len(want) < N // 512  # the batch outside the grid dropped
    if option in (58, 59):
        assert all(g[2]["latency_ms"] == [] for g in got)


@pytest.mark.parametrize("option", [1, 51])
def test_count_windows_match_jax(option):
    if option == 1:
        assert _far_from_radius(option, LINES)
    got, want = _run_both(option, count=True)
    assert len(want) == N // 300
    if option == 1:
        assert got == want and sum(len(w[3]) for w in want) > 0
    else:
        assert_knn_windows_equal(got, want)
    # inclusive end: the bounds are the min and max event time
    assert all(w[0] <= w[1] for w in want)


def test_emit_keeps_latency_off_stdout():
    class Sink:
        def emit(self, rec):
            self.rec = rec
    res = next(iter(TD.run_option(_params(TParams, 9), iter(LINES),
                                  device="cpu")))
    assert res.extras["latency_ms"]
    sink = Sink()
    TD._emit(res, sink)
    assert "latency_ms" not in sink.rec and sink.rec["count"] > 0


def test_latency_variant_refuses_multi_query():
    with pytest.raises(ValueError, match="latency"):
        TD.run_option(_params(TParams, 9, multi=True), iter([]),
                      device="cpu")


@pytest.mark.parametrize("chunk", [1, 7, 512, 4096])
def test_micro_batcher_boundaries_match_jax(chunk):
    lines = LINES[:1500] if chunk == 1 else LINES
    tp, jp = _params(TParams, 2), _params(JParams, 2)

    class Chunks:
        def __init__(self, it):
            self.it = it

        def chunks(self):
            return self.it

    got = [(s, e, r.columns()[2].tolist()) for s, e, r in
           MicroBatcher(512).batches(TD.decode_chunks(
               iter(lines), tp.input1, tp.grids()[0], chunk))]
    want = [(s, e, [p.timestamp for p in r]) for s, e, r in
            JMicroBatcher(512).batches(Chunks(JD.decode_chunks(
                iter(lines), jp.input1, jp.grids()[0], chunk=chunk)))]
    assert len(want) == -(-len(lines) // 512)
    assert got == want


def test_realtime_knn_table_is_compacted(monkeypatch):
    """In realtime mode K2's per-object table is as wide as the batch's
    distinct ids, and the result equals the uncompacted call."""
    widths = []
    plain = K.knn_topk_plain

    def spy(obj_id, **kw):
        ids = obj_id[kw["valid"]] if kw.get("valid") is not None \
            else obj_id
        widths.append((kw["num_ids"], int(torch.unique(ids).numel())))
        return plain(obj_id, **kw)
    monkeypatch.setattr(K, "knn_topk_plain", spy)
    wins = list(TD.run_option(_params(TParams, 52), iter(LINES),
                              device="cpu"))
    assert wins and len(widths) == -(-N // 512)
    assert all(w == d for w, d in widths)
    assert max(w for w, _ in widths) < 300

    # one batch, compacted and not: equal results
    grid = UniformGrid(115.5, 117.6, 39.6, 41.1, num_grid_partitions=100)
    rng = np.random.default_rng(3)
    oid = rng.integers(0, 100_000, 512).astype(np.int32)
    x, y = rng.uniform(115.5, 117.6, 512), rng.uniform(39.6, 41.1, 512)
    x[:20], y[:20] = 116.51, 40.5  # equal distances: ties by id
    q = Point.create(116.5, 40.5, grid)
    ids, local = np.unique(oid, return_inverse=True)
    cpu = torch.device("cpu")
    full = PointBatch.from_arrays(x, y, device=cpu, grid=grid, obj_id=oid)
    comp = PointBatch.from_arrays(x, y, device=cpu, grid=grid, obj_id=local)
    a, ea = K.knn_point_stats(full, q.x, q.y, q.cell, grid.n, n=grid.n,
                              k=50, num_ids=100_000)
    b, eb = K.knn_point_stats(comp, q.x, q.y, q.cell, grid.n, n=grid.n,
                              k=50, num_ids=len(ids))
    assert torch.equal(a.valid, b.valid) and torch.equal(a.dist, b.dist)
    assert np.array_equal(a.obj_id.numpy()[a.valid.numpy()],
                          ids[b.obj_id.numpy()[b.valid.numpy()]])
    assert int(ea) == int(eb) == 512
