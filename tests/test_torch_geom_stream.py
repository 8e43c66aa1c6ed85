"""Polygon and linestring streams end to end on the CPU: the 24 range and
kNN options 16-42 and 66-92 (``_PAIRS`` 3-8; 1 + 5i / 51 + 5i windowed,
2 + 5i / 52 + 5i realtime) through the PyTorch port's run_option
(device="cpu") against spatialflink_tpu.driver.run_option, on one seeded
fixture of 200 geometries in GeoJSON (and a share of them in
WKT): window bounds and selections identical, kNN (objID, distance) lists
in order with distances within 1e-6 relative, the pruning counters equal.
Also multiQuery 16/21/66/71, COUNT windows 21/71, the CLI's stdout byte for
byte with its --output records (GeoJSON and WKT), and off-type records
dropped and counted as the JAX driver drops and counts them.

The stream mixes polygons, multi-polygons, linestrings and multi-
linestrings (a polygon or linestring stream keeps every edge geometry)
over the conf's Beijing bbox, 80 object ids, 18 s of event time with some
records out of order, and 20 outside the grid. No consulted geometry lies within 1e-5
of the radius (checked), where the two packages' roundings could
legitimately differ.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from spatialflink_tpu import driver as JD
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.utils.metrics import REGISTRY

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch import operators as TO
from spatialflink_tpu_torch.config import Params as TParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")
T0 = 1_700_000_000_000
N = 200

torch.set_num_threads(1)

RANGE = [16, 17, 21, 22, 26, 27, 31, 32, 36, 37, 41, 42]
KNN = [66, 67, 71, 72, 76, 77, 81, 82, 86, 87, 91, 92]
QUERY_POINTS = [(116.5, 40.5), (116.9, 40.1), (116.0, 40.8)]
QUERY_POLYGONS = [[(116.3, 40.3), (116.6, 40.3), (116.6, 40.6),
                   (116.3, 40.3)]]


def _ring(rng, cx, cy, r, k):
    th = np.sort(rng.uniform(0.0, 2 * np.pi, k))
    ring = [[float(cx + r * np.cos(t)), float(cy + r * np.sin(t))]
            for t in th]
    return ring + [ring[0]]


def _walk(rng, cx, cy, k):
    pts = np.cumsum(rng.normal(0.0, 0.01, (k + 1, 2)), axis=0) + (cx, cy)
    return pts.tolist()


def _geometry(rng, i):
    cx = rng.uniform(115.55, 117.55)
    cy = rng.uniform(39.65, 41.05)
    if i < 20:  # west of the grid: no cell
        cx = rng.uniform(114.0, 115.3)
    kind = rng.random()
    if kind < 0.45:
        return {"type": "Polygon", "coordinates": [_ring(
            rng, cx, cy, rng.uniform(0.002, 0.03), int(rng.integers(4, 13)))]}
    if kind < 0.53:
        return {"type": "MultiPolygon", "coordinates": [
            [_ring(rng, cx, cy, 0.03, 5)],
            [_ring(rng, cx + rng.uniform(-0.1, 0.1), cy + 0.05, 0.02, 4)]]}
    if kind < 0.93:
        return {"type": "LineString",
                "coordinates": _walk(rng, cx, cy, int(rng.integers(1, 9)))}
    return {"type": "MultiLineString", "coordinates": [
        _walk(rng, cx, cy, 2), _walk(rng, cx + 0.06, cy - 0.04, 3)]}


def _records(seed):
    """(GeoJSON lines, WKT lines) of one seeded stream."""
    rng = np.random.default_rng(seed)
    ts = T0 + np.sort(rng.integers(0, 18_000, N))
    back = rng.random(N) < 0.03  # out of order; some beyond the lateness
    ts[back] -= rng.integers(200, 3_000, int(back.sum()))
    geo, wkt = [], []
    for i in range(N):
        g = _geometry(rng, i)
        oid, t = f"g{int(rng.integers(0, 80))}", int(ts[i])
        geo.append(json.dumps({"geometry": g, "properties": {
            "oID": oid, "timestamp": t}, "type": "Feature"}))
        wkt.append(f"{oid}, {t}, {_wkt(g)}")
    return geo, wkt


def _wkt(g):
    def pts(c):
        return "(" + ", ".join(f"{x!r} {y!r}" for x, y in c) + ")"

    def poly(p):
        return "(" + ", ".join(pts(r) for r in p) + ")"

    body = {"Polygon": lambda c: poly(c),
            "MultiPolygon": lambda c: "(" + ", ".join(poly(p) for p in c)
            + ")",
            "LineString": lambda c: pts(c),
            "MultiLineString": lambda c: "(" + ", ".join(pts(x) for x in c)
            + ")"}[g["type"]](g["coordinates"])
    return f"{g['type'].upper()} {body}"


#: one stream serves both declared stream types (a Polygon or a
#: LineString stream keeps every edge geometry), so the JAX package
#: compiles each of its functions for one set of shapes
GEOJSON, WKT = _records(21)


def _params(cls, option, *, fmt="GeoJSON", multi=False, count=False,
            approximate=False):
    p = cls.from_yaml(CONF)
    p.query.option = option
    p.query.multi_query = multi
    p.query.approximate = approximate
    p.query.query_points = QUERY_POINTS
    p.query.query_polygons = [list(map(tuple, r))
                              for r in p.query.query_polygons] + \
        QUERY_POLYGONS
    p = dataclasses.replace(p, input1=dataclasses.replace(p.input1,
                                                          format=fmt))
    if count:
        p = dataclasses.replace(p, window=dataclasses.replace(
            p.window, type="COUNT", interval_s=90, step_s=60))
    return p


class _Recording:
    """Records the operators run_option builds (for their counters)."""

    def __init__(self, monkeypatch):
        self.ops = []
        for name in dir(TO):
            if name.endswith(("RangeQuery", "KNNQuery")) \
                    and not name.startswith("Point"):
                monkeypatch.setattr(TO, name, self._wrap(getattr(TO, name)))

    def _wrap(self, base):
        rec = self

        class Op(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                rec.ops.append(self)
        return Op


def _windows(results):
    """(start, end, extras, per-query records): range records as (oid,
    ts, geometry type, bbox), kNN records as (oid, dist)."""
    out = []
    for w in results:
        per_query = w.records if "queries" in w.extras else [w.records]
        rows = [[(r.obj_id, r.timestamp, type(r).__name__,
                  tuple(map(float, r.bbox))) if hasattr(r, "obj_id")
                 else tuple(r) for r in q] for q in per_query]
        out.append((w.window_start, w.window_end,
                    {k: v for k, v in w.extras.items()}, rows))
    return out


def run_both(monkeypatch, option, **kw):
    """(port windows, JAX windows, port counters, JAX counter deltas)."""
    lines = WKT if kw.get("fmt") == "WKT" else GEOJSON
    names = ("gn-bypassed", "distance-computations")
    before = [REGISTRY.counter(c).count for c in names]
    want = _windows(JD.run_option(_params(JParams, option, **kw),
                                  iter(lines)))
    after = [REGISTRY.counter(c).count for c in names]
    rec = _Recording(monkeypatch)
    got = _windows(TD.run_option(_params(TParams, option, **kw),
                                 iter(lines), device="cpu"))
    (op,) = rec.ops
    return (got, want, [op.pruning[c] for c in names],
            [a - b for a, b in zip(after, before)])


def assert_windows_equal(got, want, knn):
    assert [w[:3] for w in got] == [w[:3] for w in want]
    assert sum(len(r) for w in want for r in w[3]) > 0
    for g, w in zip(got, want):
        assert len(g[3]) == len(w[3])
        for rg, rw in zip(g[3], w[3]):
            if not knn:
                assert rg == rw
                continue
            assert [o for o, _ in rg] == [o for o, _ in rw]
            np.testing.assert_allclose([d for _, d in rg],
                                       [d for _, d in rw], rtol=1e-6, atol=0)


@pytest.mark.parametrize("option", RANGE + KNN)
def test_run_option_matches_jax(monkeypatch, option):
    got, want, counts, jcounts = run_both(monkeypatch, option)
    realtime = TD.CASES[option].mode == "realtime"
    assert len(want) >= (1 if realtime else 5)
    assert_windows_equal(got, want, option > 50)
    assert counts == jcounts and counts[1] > 0


@pytest.mark.parametrize("option", [16, 37, 71, 91])
def test_wkt_matches_jax(monkeypatch, option):
    got, want, counts, jcounts = run_both(monkeypatch, option, fmt="WKT")
    assert_windows_equal(got, want, option > 50)
    assert counts == jcounts


@pytest.mark.parametrize("option", [21, 71])
def test_approximate_matches_jax(monkeypatch, option):
    """Range in approximate mode is the same function in both packages; kNN
    lists: the JAX package's approximate selection (``approx_min_k``,
    recall < 1) is a prefix of the port's exact one over the same bbox
    distances (ROADMAP known differences)."""
    got, want, counts, jcounts = run_both(monkeypatch, option,
                                          approximate=True)
    assert counts == jcounts
    if option < 51:
        assert_windows_equal(got, want, False)
        return
    assert [w[:3] for w in got] == [w[:3] for w in want]
    for g, w in zip(got, want):
        rg, rw = g[3][0], w[3][0]
        assert [o for o, _ in rg][:len(rw)] == [o for o, _ in rw]


@pytest.mark.parametrize("option", [16, 21, 66, 71])
def test_multi_query_matches_jax(monkeypatch, option):
    got, want, counts, jcounts = run_both(monkeypatch, option, multi=True)
    assert all(w[2]["queries"] == (3 if option in (16, 66) else 2)
               for w in want)
    assert_windows_equal(got, want, option > 50)
    assert counts == jcounts


@pytest.mark.parametrize("option", [21, 71])
def test_count_windows_match_jax(monkeypatch, option):
    got, want, counts, jcounts = run_both(monkeypatch, option, count=True)
    assert len(want) == 3  # every 60 of the 200 arrivals, the last 90
    assert_windows_equal(got, want, option > 50)
    assert counts == jcounts


def test_no_distance_at_the_radius():
    """The fixture's exact distances stay clear of the radius, so the range
    selections cannot legitimately differ in the last ulp."""
    from spatialflink_tpu_torch.models import (EdgeGeomBatch, Polygon,
                                                single_query_edges)
    from spatialflink_tpu_torch.ops import geom as G
    from spatialflink_tpu_torch.streams.formats import parse_spatial

    p = _params(TParams, 21)
    grid = p.grids()[0]
    r = p.query.radius
    gb = EdgeGeomBatch.from_objects(
        [parse_spatial(ln, "GeoJSON", grid) for ln in GEOJSON],
        device=torch.device("cpu"))
    for q in p.query_polygon_objects(grid) + \
            p.query_linestring_objects(grid):
        e, m = (torch.from_numpy(a) for a in single_query_edges(q))
        d = G.geoms_to_single_geom_dist(gb, e, m, isinstance(q, Polygon))
        assert torch.all((d - r).abs() > 1e-5)
    for x, y in QUERY_POINTS:
        d = G.point_to_geoms_dist(torch.tensor(x, dtype=torch.float32),
                                  torch.tensor(y, dtype=torch.float32), gb)
        assert torch.all((d - r).abs() > 1e-5)


@pytest.mark.parametrize("option,fmt", [(21, "GeoJSON"), (71, "GeoJSON"),
                                        (36, "WKT")])
def test_cli_output_matches_jax(tmp_path, capsys, option, fmt):
    """stdout byte for byte, and the --output records: range geometries in
    the --output-format's serialization, equal byte for byte; kNN
    (objID, distance) records with the same ids, distances within 1e-6."""
    lines = WKT if fmt == "WKT" else GEOJSON
    inp = tmp_path / "in.txt"
    inp.write_text("\n".join(lines) + "\n")
    args = ["--config", CONF, "--option", str(option), "--input1", str(inp),
            "--format", fmt, "--output-format", fmt]
    assert JD.main(args + ["--output", str(tmp_path / "jax.out")]) == 0
    want = capsys.readouterr().out
    assert TD.main(args + ["--output", str(tmp_path / "port.out"),
                           "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and want.count("'window'") >= 5
    jout = (tmp_path / "jax.out").read_text().splitlines()
    pout = (tmp_path / "port.out").read_text().splitlines()
    assert len(jout) == len(pout) > 20
    if option < 51:
        assert pout == jout
    else:
        port = [json.loads(ln) for ln in pout]
        jax_ = [json.loads(ln) for ln in jout]
        assert [o for o, _ in port] == [o for o, _ in jax_]
        np.testing.assert_allclose([d for _, d in port],
                                   [d for _, d in jax_], rtol=1e-6, atol=0)


def test_off_type_records_dropped_and_counted(monkeypatch, capsys):
    """Points, a multi-point and a collection in a declared Polygon stream
    are dropped with the JAX driver's counter and warning; the rest runs
    as without them."""
    lines = list(GEOJSON)
    off = [json.dumps({"geometry": g, "properties": {"oID": "x", "timestamp":
                                                     T0 + 5_000 + i},
                       "type": "Feature"}) for i, g in enumerate(
        [{"type": "Point", "coordinates": [116.5, 40.5]},
         {"type": "MultiPoint", "coordinates": [[116.5, 40.5],
                                                [116.6, 40.6]]},
         {"type": "GeometryCollection", "geometries": [
             {"type": "Point", "coordinates": [116.5, 40.5]}]}] * 4)]
    mixed = lines[:100] + off + lines[100:]
    jbefore = REGISTRY.counter("off-type-dropped").count
    want = _windows(JD.run_option(_params(JParams, 21), iter(mixed)))
    jerr = capsys.readouterr().err
    tbefore = TD.decode_chunks.off_type_dropped
    got = _windows(TD.run_option(_params(TParams, 21), iter(mixed),
                                 device="cpu"))
    terr = capsys.readouterr().err
    assert REGISTRY.counter("off-type-dropped").count - jbefore == 12
    assert TD.decode_chunks.off_type_dropped - tbefore == 12
    assert got == want
    assert got == _windows(TD.run_option(_params(TParams, 21), iter(lines),
                                         device="cpu"))
    pat = re.compile(r"warning: dropping off-type (\w+) record\(s\) from "
                     r"declared Polygon stream \(off-type-dropped=\d+\)")
    jw = [pat.fullmatch(ln) for ln in jerr.splitlines() if "off-type" in ln]
    tw = [pat.fullmatch(ln) for ln in terr.splitlines() if "off-type" in ln]
    assert jw and tw and all(jw) and all(tw)
    assert tw[0].group(1) == jw[0].group(1) == "Point"


@pytest.mark.parametrize("chunk", [1, 7, 100])
def test_geometry_chunks_window_like_jax(chunk):
    """The window assemblers over geometry chunks against the JAX
    package's per-record paths: event-time windows with lateness
    (``WindowAssembler.add_chunk``), micro-batches of 64
    (``MicroBatcher.add_records``) and count windows of 90 every 40
    (``SpatialOperator._count_windows``), for decode chunks of ``chunk``
    records: the same bounds and the same records in the same order."""
    from spatialflink_tpu.operators.base import (QueryConfiguration as JConf,
                                                 QueryType as JType,
                                                 SpatialOperator as JOp)
    from spatialflink_tpu.runtime.windows import (MicroBatcher as JMB,
                                                  WindowAssembler as JWA,
                                                  WindowSpec as JSpec)
    from spatialflink_tpu.streams.formats import parse_spatial as jparse

    from spatialflink_tpu_torch.runtime import (MicroBatcher, WindowAssembler,
                                                WindowSpec, count_windows)
    from spatialflink_tpu_torch.streams.bulk import GeomChunk
    from spatialflink_tpu_torch.streams.formats import parse_spatial

    grid = _params(TParams, 21).grids()[0]
    lines = GEOJSON
    tobjs = [parse_spatial(ln, "GeoJSON", grid) for ln in lines]
    jobjs = [jparse(ln, "GeoJSON") for ln in lines]
    chunks = [GeomChunk(tobjs[i:i + chunk])
              for i in range(0, len(tobjs), chunk)]

    def key(recs):
        return [(r.obj_id, r.timestamp) for r in recs]

    def port(wins):
        return [(s, e, key(r.records())) for s, e, r in wins]

    def jax_(wins):
        return [(s, e, key(r)) for s, e, r in wins]

    wa = JWA(JSpec.sliding(10_000, 5_000), 1_000)
    want = [w for i in range(0, len(jobjs), chunk)
            for w in wa.add_chunk([r.timestamp for r in jobjs[i:i + chunk]],
                                  jobjs[i:i + chunk])] + list(wa.flush())
    got = WindowAssembler(WindowSpec.sliding(10_000, 5_000), 1_000) \
        .assemble(chunks)
    assert port(got) == jax_(want) and len(want) >= 5
    mb = JMB(64)
    want = list(mb.add_records(jobjs)) + list(mb.flush())
    assert port(MicroBatcher(64).batches(chunks)) == jax_(want)
    assert len(want) == 4
    op = JOp(JConf(query_type=JType.CountBased, window_size_ms=90,
                   slide_ms=40), _params(JParams, 21).grids()[0])
    want = list(op._count_windows(iter(jobjs)))
    assert port(count_windows(chunks, 90, 40)) == jax_(want)
    assert len(want) == 5


@pytest.mark.parametrize("family", ["range", "knn"])
def test_operator_api_over_object_lists_matches_jax(family):
    """The operators over a plain list of parsed geometries (no decode
    stream): the same windows, selections or kNN lists, and pruning
    counts, as the JAX operators over the same records."""
    from spatialflink_tpu import operators as JO
    from spatialflink_tpu.streams.formats import parse_spatial as jparse

    from spatialflink_tpu_torch import operators as TOps
    from spatialflink_tpu_torch.streams.formats import parse_spatial

    jp, tp = _params(JParams, 21), _params(TParams, 21)
    jgrid, tgrid = jp.grids()[0], tp.grids()[0]
    jobjs = [jparse(ln, "GeoJSON", jgrid) for ln in GEOJSON]
    tobjs = [parse_spatial(ln, "GeoJSON", tgrid) for ln in GEOJSON]
    names = ("gn-bypassed", "distance-computations")
    before = [REGISTRY.counter(c).count for c in names]
    if family == "range":
        jq = jp.query_polygon_objects(jgrid)[0]
        tq = tp.query_polygon_objects(tgrid)[0]
        want = _windows(JO.PolygonPolygonRangeQuery(
            JD._query_conf(jp, JD.CASES[21]), jgrid).run(jobjs, jq, 0.5))
        op = TOps.PolygonPolygonRangeQuery(TD._query_conf(tp, TD.CASES[21]),
                                           tgrid, device="cpu")
        got = _windows(op.run(tobjs, tq, 0.5))
    else:
        jqs = jp.query_point_objects(jgrid)
        tqs = tp.query_point_objects(tgrid)
        want = _windows(JO.PolygonPointKNNQuery(
            JD._query_conf(jp, JD.CASES[66]), jgrid).run_multi(
                jobjs, jqs, 0.5, 5))
        op = TOps.PolygonPointKNNQuery(TD._query_conf(tp, TD.CASES[66]),
                                       tgrid, device="cpu")
        got = _windows(op.run_multi(tobjs, tqs, 0.5, 5))
    after = [REGISTRY.counter(c).count for c in names]
    assert_windows_equal(got, want, family == "knn")
    assert [op.pruning[c] for c in names] == \
        [a - b for a, b in zip(after, before)]


def test_geometry_entry_points_raise_without_a_card(monkeypatch):
    """No fallback: without a card the geometry operators and run_option
    raise unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = _params(TParams, 21)
    grid = p.grids()[0]
    conf = TD._query_conf(p, TD.CASES[21])
    for cls in (TO.GeomPointRangeQuery, TO.GeomGeomRangeQuery,
                TO.GeomPointKNNQuery, TO.GeomGeomKNNQuery):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(conf, grid)
        cls(conf, grid, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.run_option(p, iter(GEOJSON))
