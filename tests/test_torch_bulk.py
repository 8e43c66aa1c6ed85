"""Bulk replay (``--bulk``) and ``--limit`` on the CPU: the port's native
WKT and GeoJSON geometry parsers against the JAX package's
(``bulk_parse_wkt`` / ``bulk_parse_geojson_geoms``, rejects included),
``geoms_to_edge_batch`` against ``EdgeGeomBatch.from_objects`` field for
field, ``run_option_bulk`` against the JAX one and against the port's own
record path (options 1, 6, 51, 16, 66, 101, multiQuery 1 / 51 / 21, 51 and
1 with panes), the CLI's stdout against the JAX CLI's, and the refusals.

Fixtures: test_torch_join's seeded CSV point streams (late records past
the 1 s lateness, points outside the grid) and GeoJSON geometry stream,
that stream written again as WKT with oid and timestamp fields, and a
small WKT / GeoJSON block whose lines the native parsers reject
(multi-geometries, a date-string timestamp, an escaped id).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from spatialflink_tpu import driver as JD
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.streams import bulk as JB
from spatialflink_tpu.streams.formats import parse_spatial as jparse
from spatialflink_tpu.streams.formats import serialize_spatial as jser

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import Params as TParams
from spatialflink_tpu_torch.models import EdgeGeomBatch
from spatialflink_tpu_torch.streams import bulk as TB
from spatialflink_tpu_torch.streams.formats import parse_spatial

from test_torch_join import CONF, GEOMS, POINTS, QPOINTS

torch.set_num_threads(1)
CPU = torch.device("cpu")
RADIUS = {"range": 0.2, "knn": 0.2, "join": 0.05}


def _wkt_lines():
    grid = JParams.from_yaml(CONF).grids()[0]
    return [jser(jparse(ln, "GeoJSON", grid, geometry="Polygon"), "WKT")
            for ln in GEOMS]


WKT = _wkt_lines()
REJECTS_WKT = [
    "a1, 1700000001000, POLYGON ((116.1 40.1, 116.3 40.1, 116.3 40.3, "
    "116.1 40.1), (116.15 40.12, 116.2 40.12, 116.2 40.2), "
    "(116.22 40.11, 116.29 40.11, 116.29 40.2, 116.22 40.2))",
    "m2, 1700000002000, MULTIPOLYGON (((116.4 40.4, 116.5 40.4, "
    "116.5 40.5, 116.4 40.4)), ((116.6 40.6, 116.7 40.6, 116.7 40.7)))",
    "l3, 1700000003000, LINESTRING (116.0 40.0, 116.2 40.3, 116.1 40.9)",
    "d4, 2023-11-14 22:13:24, LINESTRING (116.3 40.3, 116.31 40.35)",
    "m5, 1700000005000, MULTILINESTRING ((116.0 40.0, 116.1 40.1), "
    "(116.2 40.2, 116.3 40.1, 116.35 40.0))",
    "p6, 1700000006000, POLYGON ((116.5 40.5, 116.9 40.5, 116.9 40.9, "
    "116.5 40.9))",
]


def _geojson(geom, oid, ts):
    return json.dumps({"type": "Feature", "geometry": geom,
                       "properties": {"oID": oid, "timestamp": ts}})


REJECTS_GEOJSON = [
    _geojson({"type": "Polygon", "coordinates": [
        [[116.1, 40.1], [116.3, 40.1], [116.3, 40.3], [116.1, 40.1]],
        [[116.15, 40.12], [116.2, 40.12], [116.2, 40.2], [116.15, 40.12]]]},
        "g1", 1700000001000),
    _geojson({"type": "MultiPolygon", "coordinates": [
        [[[116.4, 40.4], [116.5, 40.4], [116.5, 40.5], [116.4, 40.4]]],
        [[[116.6, 40.6], [116.7, 40.6], [116.7, 40.7], [116.6, 40.6]]]]},
        "g2", 1700000002000),
    _geojson({"type": "LineString", "coordinates": [[116.0, 40.0],
                                                    [116.2, 40.3]]},
             "g\"3", 1700000003000),
    _geojson({"type": "LineString", "coordinates": [[116.3, 40.3],
                                                    [116.31, 40.35]]},
             "g4", "2023-11-14 22:13:24"),
    _geojson({"type": "MultiLineString", "coordinates": [
        [[116.0, 40.0], [116.1, 40.1]], [[116.2, 40.2], [116.3, 40.1]]]},
        "g5", 1700000005000),
]


def _fields(p):
    return {f: getattr(p, f) for f in ("ts", "obj_id", "is_areal", "bbox",
                                       "ring_off", "ring_cnt", "ring_voff",
                                       "ring_size", "vx", "vy")}


@pytest.mark.parametrize("fmt", ["WKT", "GeoJSON"])
def test_native_geometry_parsers_match_jax(fmt):
    """Every field and the interner's order; the rejected lines (multi-
    geometries, a date-string timestamp, an escaped id) parse per record
    in both packages and land in line order."""
    if fmt == "WKT":
        lines = WKT + REJECTS_WKT
        kw = dict(date_format="%Y-%m-%d %H:%M:%S")
        got = TB.bulk_parse_wkt("\n".join(lines).encode(), **kw)
        want = JB.bulk_parse_wkt("\n".join(lines).encode(), **kw)
    else:
        lines = GEOMS + REJECTS_GEOJSON
        kw = dict(date_format="%Y-%m-%d %H:%M:%S")
        got = TB.bulk_parse_geojson_geoms("\n".join(lines).encode(), **kw)
        want = JB.bulk_parse_geojson_geoms("\n".join(lines).encode(), **kw)
    assert len(got) == len(lines) == len(want)
    for name, a in _fields(got).items():
        b = getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.interner.to_list() == want.interner.to_list()
    # the multi-part geometries (rejected lines) keep their objects' order
    assert got.multi.tolist() == [
        type(parse_spatial(ln, fmt, None, **kw)).__name__.startswith("Multi")
        for ln in lines]


def test_native_parse_counts_and_refuses_points():
    before = TB.bulk_parse_wkt.calls
    TB.bulk_parse_wkt("\n".join(WKT[:3]).encode())
    assert TB.bulk_parse_wkt.calls == before + 1
    with pytest.raises(ValueError):
        TB.bulk_parse_wkt(b"p, 1700000000000, POINT (116.1 40.1)")
    with pytest.raises(ValueError):
        TB.bulk_parse_geojson_geoms(_geojson(
            {"type": "Point", "coordinates": [116.1, 40.1]}, "p",
            1700000000000).encode())


@pytest.mark.parametrize("fmt", ["WKT", "GeoJSON"])
def test_edge_batch_equals_the_object_batch(fmt):
    """``geoms_to_edge_batch`` field for field against
    ``EdgeGeomBatch.from_objects`` over the per-record parse: edges in the
    objects' ring order (the rings of a polygon largest first), closure
    edges, padding, cells, the representative cell, is_areal; ids through
    the parse's interner."""
    grid = TParams.from_yaml(CONF).grids()[0]
    lines = (WKT + REJECTS_WKT) if fmt == "WKT" else (GEOMS + REJECTS_GEOJSON)
    kw = dict(date_format="%Y-%m-%d %H:%M:%S")
    parse = TB.bulk_parse_wkt if fmt == "WKT" else \
        TB.bulk_parse_geojson_geoms
    parsed = parse("\n".join(lines).encode(), **kw)
    got = TB.geoms_to_edge_batch(parsed, grid, device=CPU, ts_base=17)
    objs = [parse_spatial(ln, fmt, grid, geometry="Polygon", **kw)
            for ln in lines]
    want = EdgeGeomBatch.from_objects(objs, device=CPU, ts_base=17,
                                      obj_id=parsed.obj_id)
    for name in EdgeGeomBatch._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert [parsed.interner.lookup(int(i)) for i in parsed.obj_id] == \
        [o.obj_id for o in objs]
    # the JAX package's batch: the same fields, each polygon's edges the
    # same set (it keeps the rings in the text's order)
    jgrid = JParams.from_yaml(CONF).grids()[0]
    jparse_fn = JB.bulk_parse_wkt if fmt == "WKT" else \
        JB.bulk_parse_geojson_geoms
    jb = JB.geoms_to_edge_batch(jparse_fn("\n".join(lines).encode(), **kw),
                                jgrid, ts_base=17)
    for name in ("bbox", "ts", "cell", "cells", "cells_mask", "is_areal",
                 "valid", "edge_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    ge, je = got.edges.numpy(), np.asarray(jb.edges)
    for g in range(len(lines)):
        assert sorted(map(tuple, ge[g].tolist())) == \
            sorted(map(tuple, je[g].tolist())), g


def test_window_sources_cover_the_record_windows():
    """``bulk_window_batches``' windows and the pane source's windows are
    the same window set, and a pane's records are its window's."""
    spec = TParams.from_yaml(CONF)
    grid = spec.grids()[0]
    parsed = TB.bulk_parse_csv("\n".join(POINTS).encode())
    ws = TD._query_conf(spec, TD.CASES[1]).window_spec()
    full = {s: set(idx.tolist()) for s, _e, idx, _b in
            TB.bulk_window_batches(parsed, ws, grid, device=CPU)}
    panes = {s: set(i for _p, (idx, _b) in ps for i in idx.tolist())
             for s, _e, ps in TB.bulk_pane_window_batches(parsed, ws, grid,
                                                          device=CPU)}
    assert full == panes and len(full) >= 5


# ---------------------------------------------------------------------- #
# run_option_bulk


def _params(cls, option, *, multi=False, panes=False):
    p = cls.from_yaml(CONF)
    spec = TD.CASES[option]
    p.query.option = option
    p.query.radius = RADIUS[spec.family]
    p.query.multi_query = multi
    p.query.panes = panes
    p.query.query_points = [[116.5, 40.5], [116.9, 40.2], [116.1, 40.8]]
    fmt = "GeoJSON" if spec.stream != "Point" else "CSV"
    return dataclasses.replace(
        p, input1=dataclasses.replace(p.input1, format=fmt),
        input2=dataclasses.replace(p.input2, format="CSV"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bulk")
    out = {}
    for name, lines in (("points", POINTS), ("queries", QPOINTS),
                        ("geoms", GEOMS)):
        out[name] = d / f"{name}.txt"
        out[name].write_text("\n".join(lines) + "\n")
    return out


def _input(files, option):
    return str(files["geoms" if TD.CASES[option].stream != "Point"
                     else "points"])


def _results(res):
    return [(r.window_start, r.window_end, r.records, dict(r.extras))
            for r in res]


BULK = [(1, False, False), (6, False, False), (51, False, False),
        (16, False, False), (66, False, False), (101, False, False),
        (1, True, False), (51, True, False), (21, True, False),
        (51, False, True), (1, False, True)]


def _knn_close(got, want):
    """kNN windows: ids and order equal, distances within 1e-6 relative
    (XLA fuses the distance into an FMA: ROADMAP's known differences)."""
    def lists(w):
        return w[2] if w[3].get("queries") else [w[2]]
    assert [(w[0], w[1], w[3]) for w in got] == \
        [(w[0], w[1], w[3]) for w in want]
    for g, w in zip(got, want):
        for gl, wl in zip(lists(g), lists(w), strict=True):
            assert [o for o, _ in gl] == [o for o, _ in wl]
            np.testing.assert_allclose([d for _, d in gl],
                                       [d for _, d in wl], rtol=1e-6)


@pytest.mark.parametrize("option,multi,panes", BULK)
def test_bulk_matches_jax(files, option, multi, panes):
    args = (_input(files, option), str(files["queries"]))
    want = _results(JD.run_option_bulk(
        _params(JParams, option, multi=multi, panes=panes), *args))
    got = _results(TD.run_option_bulk(
        _params(TParams, option, multi=multi, panes=panes), *args,
        device="cpu"))
    if TD.CASES[option].family == "knn":
        _knn_close(got, want)
    else:
        assert got == want
    assert len(want) >= 5 and sum(len(w[2]) for w in want) > 0


@pytest.mark.parametrize("option", [2, 8, 52, 102, 106, 108, 206, 1010,
                                    401])
def test_bulk_takes_the_record_path_where_jax_does(files, option):
    """Realtime, the latency variants, a geometry join, the trajectory,
    app and ser/de families: None (the record path), as in the JAX
    package; so for count windows and a join without its second file."""
    pts, q = str(files["points"]), str(files["queries"])
    for cls, run in ((TParams, lambda p, *a: TD.run_option_bulk(
            p, *a, device="cpu")), (JParams, JD.run_option_bulk)):
        p = cls.from_yaml(CONF)
        p.query.option = option
        assert run(p, pts, q) is None
    p = _params(TParams, 1)
    p.window.type = "COUNT"
    assert TD.run_option_bulk(p, pts, q, device="cpu") is None
    assert TD.run_option_bulk(_params(TParams, 101), pts, None,
                              device="cpu") is None


def test_bulk_point_file_with_a_polygon_falls_back(tmp_path, capsys):
    mixed = tmp_path / "mixed.geojson"
    lines = [json.dumps({"type": "Feature", "geometry": {
        "type": "Point", "coordinates": [116.5, 40.5]}, "properties": {
            "oID": "a", "timestamp": 1_700_000_000_000}}), GEOMS[1]]
    mixed.write_text("\n".join(lines) + "\n")
    p = _params(TParams, 1)
    p = dataclasses.replace(p, input1=dataclasses.replace(p.input1,
                                                          format="GeoJSON"))
    assert TD.run_option_bulk(p, str(mixed), device="cpu") is None
    assert "not bulk-ingestible" in capsys.readouterr().err


def test_file_parsers_read_what_the_block_parsers_read(files, tmp_path):
    """``bulk_parse_file`` / ``bulk_parse_geom_file`` over a file equal the
    block parsers over its bytes (TSV takes the tab), and refuse other
    formats."""
    got = TB.bulk_parse_file(str(files["points"]), "CSV")
    want = TB.bulk_parse_csv(files["points"].read_bytes())
    for name in ("x", "y", "ts", "obj_id"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    tsv = tmp_path / "p.tsv"
    tsv.write_text(files["points"].read_text().replace(",", "\t"))
    np.testing.assert_array_equal(TB.bulk_parse_file(str(tsv), "TSV").x,
                                  want.x)
    wkt = tmp_path / "g.wkt"
    wkt.write_text("\n".join(WKT) + "\n")
    for path, fmt in ((wkt, "WKT"), (files["geoms"], "GeoJSON")):
        g = TB.bulk_parse_geom_file(str(path), fmt)
        block = (TB.bulk_parse_wkt if fmt == "WKT"
                 else TB.bulk_parse_geojson_geoms)(path.read_bytes())
        for name, a in _fields(g).items():
            np.testing.assert_array_equal(a, getattr(block, name))
    with pytest.raises(ValueError, match="csv/tsv/geojson"):
        TB.bulk_parse_file(str(wkt), "WKT")
    with pytest.raises(ValueError, match="WKT/GeoJSON"):
        TB.bulk_parse_geom_file(str(wkt), "CSV")


@pytest.mark.parametrize("prune", [True, False])
def test_bulk_join_prunes_as_the_record_path(files, monkeypatch, prune):
    """The join's bulk replay takes the record path's pair call: the naive
    twins' ``prune_cells = False`` makes every cell a neighbour there too,
    and the pairs equal the record path's, mapped to the records."""
    from spatialflink_tpu_torch.operators import join_query as TJ

    p = _params(TParams, 101)
    grid = p.grids()[0]
    op = TJ.PointPointJoinQuery(TD._query_conf(p, TD.CASES[101]), grid,
                                device="cpu")
    op.prune_cells = prune
    layers = []
    pairs_host = TJ.J.join_pairs_host

    def spy(*a, nb_layers=None, **kw):
        layers.append(nb_layers)
        return pairs_host(*a, nb_layers=nb_layers, **kw)

    monkeypatch.setattr(TJ.J, "join_pairs_host", spy)
    # the driver's parse: late records dropped as the record path drops them
    lateness = p.query.allowed_lateness_s
    pa = TD._bulk_parse_stream(p.input1, str(files["points"]), lateness)
    pb = TD._bulk_parse_stream(p.input2, str(files["queries"]), lateness)
    got = list(op.run_bulk(pa, pb, p.query.radius))
    assert layers and set(layers) == {None if prune else grid.n}
    want = list(op.run(
        TD.ChunkedStream(TD.decode_chunks(POINTS, p.input1, grid)),
        TD.ChunkedStream(TD.decode_chunks(QPOINTS, p.input2, grid)),
        p.query.radius))
    assert [(w.window_start, w.window_end) for w in got] == \
        [(w.window_start, w.window_end) for w in want]

    def key(parsed, i):
        return parsed.interner.lookup(int(parsed.obj_id[i])), \
            int(parsed.ts[i])

    for g, w in zip(got, want):
        assert [(key(pa, a), key(pb, b)) for a, b in g.records] == \
            [((a.obj_id, a.timestamp), (b.obj_id, b.timestamp))
             for a, b in w.records]
    assert sum(len(g.records) for g in got) > 0
