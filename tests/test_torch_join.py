"""The spatial joins end to end on the CPU: the 20 join options (101-142,
101 + 5i windowed and 102 + 5i realtime over the nine (stream, query)
pairs, and the latency variants 108/109) through the PyTorch port's
run_option (device="cpu") against spatialflink_tpu.driver.run_option,
window for window and pair for pair, in order; the CLI's stdout with
--input2 byte for byte, and its --output pairs.

Fixtures (seeded numpy): a 700-point CSV stream and a 250-point CSV query
stream, a 120-geometry and a 60-geometry GeoJSON stream (polygons,
multi-polygons, linestrings, multi-linestrings; a Polygon or LineString
stream keeps every edge geometry), all over the conf's Beijing bbox with
some records outside the grid (cell -1), some out of order and some later
than the 1 s lateness (dropped). The query streams end at 13 s and the
record streams run to 20 s, so the last windows are one-sided (0 pairs).
Radius 0.05 degrees; no pair's distance lies within 3e-5 of it (checked
below), where the two packages' roundings (XLA's FMA, ROADMAP known
differences) could legitimately differ.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from spatialflink_tpu import driver as JD
from spatialflink_tpu.config import Params as JParams

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import Params as TParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")
T0 = 1_700_000_000_000
RADIUS = 0.05
BAND = 3e-5  # no pair distance this close to the radius

torch.set_num_threads(1)

JOINS = sorted(o for o, s in TD.CASES.items() if s.family == "join")
KIND = {"Point": "CSV", "Polygon": "GeoJSON", "LineString": "GeoJSON"}


def _times(rng, n, span):
    ts = T0 + np.sort(rng.integers(0, span, n))
    back = rng.random(n) < 0.06  # out of order; some beyond the lateness
    ts[back] -= rng.integers(200, 3_000, int(back.sum()))
    return ts.tolist()


def _points(seed, n, span, prefix):
    rng = np.random.default_rng(seed)
    x = rng.uniform(115.45, 117.65, n)  # a strip outside the grid
    y = rng.uniform(39.55, 41.15, n)
    oid = rng.integers(0, 60, n).tolist()
    return [f"{prefix}{o},{t},{a!r},{b!r}" for o, t, a, b in
            zip(oid, _times(rng, n, span), x.tolist(), y.tolist())]


def _ring(rng, cx, cy, r, k):
    th = np.sort(rng.uniform(0.0, 2 * np.pi, k))
    ring = [[float(cx + r * np.cos(t)), float(cy + r * np.sin(t))]
            for t in th]
    return ring + [ring[0]]


def _walk(rng, cx, cy, k):
    return (np.cumsum(rng.normal(0.0, 0.01, (k + 1, 2)), axis=0)
            + (cx, cy)).tolist()


def _geometry(rng, i):
    cx = rng.uniform(115.55, 117.55)
    cy = rng.uniform(39.65, 41.05)
    if i % 12 == 0:  # west of the grid: no cell
        cx = rng.uniform(114.5, 115.4)
    kind = rng.random()
    if kind < 0.45:
        return {"type": "Polygon", "coordinates": [_ring(
            rng, cx, cy, rng.uniform(0.005, 0.04), int(rng.integers(4, 11)))]}
    if kind < 0.55:
        return {"type": "MultiPolygon", "coordinates": [
            [_ring(rng, cx, cy, 0.02, 5)],
            [_ring(rng, cx + rng.uniform(-0.1, 0.1), cy + 0.05, 0.015, 4)]]}
    if kind < 0.9:
        return {"type": "LineString",
                "coordinates": _walk(rng, cx, cy, int(rng.integers(1, 7)))}
    return {"type": "MultiLineString", "coordinates": [
        _walk(rng, cx, cy, 2), _walk(rng, cx + 0.06, cy - 0.04, 3)]}


def _geoms(seed, n, span, prefix):
    rng = np.random.default_rng(seed)
    out = []
    for i, t in enumerate(_times(rng, n, span)):
        out.append(json.dumps({"geometry": _geometry(rng, i), "properties": {
            "oID": f"{prefix}{int(rng.integers(0, 40))}", "timestamp": t},
            "type": "Feature"}))
    return out


POINTS = _points(3, 700, 20_000, "p")
QPOINTS = _points(4, 250, 13_000, "q")
GEOMS = _geoms(5, 120, 20_000, "g")
QGEOMS = _geoms(6, 60, 13_000, "h")
STREAMS = {"Point": POINTS, "Polygon": GEOMS, "LineString": GEOMS}
QUERIES = {"Point": QPOINTS, "Polygon": QGEOMS, "LineString": QGEOMS}


def _params(cls, option, *, q_shift=None):
    p = cls.from_yaml(CONF)
    p.query.option = option
    p.query.radius = RADIUS
    spec = TD.CASES[option]
    in2 = dataclasses.replace(p.input2, format=KIND[spec.query])
    if q_shift is not None:  # a query-stream grid unlike the stream's
        dx, dy = q_shift
        x0, y0, x1, y1 = in2.grid_bbox
        in2 = dataclasses.replace(in2, grid_bbox=(x0 + dx, y0 + dy,
                                                  x1 + dx, y1 + dy))
    return dataclasses.replace(
        p, input1=dataclasses.replace(p.input1, format=KIND[spec.stream]),
        input2=in2)


def _key(rec):
    if type(rec).__name__ == "Point":
        return ("Point", rec.obj_id, rec.timestamp, rec.x, rec.y, rec.cell)
    return (type(rec).__name__, rec.obj_id, rec.timestamp,
            tuple(map(float, rec.bbox)), tuple(sorted(rec.cells)))


def _windows(results):
    return [(w.window_start, w.window_end, len(w.extras.get("latency_ms",
                                                            ())),
             [(_key(a), _key(b)) for a, b in w.records]) for w in results]


def run_both(option, **kw):
    spec = TD.CASES[option]
    s1, s2 = STREAMS[spec.stream], QUERIES[spec.query]
    want = _windows(JD.run_option(_params(JParams, option, **kw), iter(s1),
                                  iter(s2)))
    got = _windows(TD.run_option(_params(TParams, option, **kw), iter(s1),
                                 iter(s2), device="cpu"))
    return got, want


@pytest.mark.parametrize("option", JOINS)
def test_run_option_matches_jax(option):
    got, want = run_both(option)
    assert got == want
    assert sum(len(w[3]) for w in want) > 0
    if TD.CASES[option].mode == "window":
        assert len(want) >= 5
        # the query stream ends at 13 s: the last windows are one-sided
        assert want[-1][3] == []
    else:
        assert len(want) >= 1


def test_options_cover_the_jax_joins():
    assert JOINS == sorted(o for o, s in JD.CASES.items()
                           if s.family == "join" and not s.naive)
    assert len(JOINS) == 20


@pytest.mark.parametrize("option", [101, 102, 106, 116, 121])
def test_query_grid_unlike_the_stream_grid(option):
    """Stream 2 decodes on its own grid (the bbox moved by 3 and 2 cells
    here); the join compares cells on the stream's grid: a point's cell
    is taken again from its coordinates (the pairs of one grid), a
    geometry keeps its decode's cell ids (other pairs)."""
    got, want = run_both(option, q_shift=(0.063, 0.042))
    assert got == want and sum(len(w[3]) for w in want) > 0
    same, _ = run_both(option)

    def ids(windows):  # (obj_id, timestamp) of each pair's two records
        return [[(a[1:3], b[1:3]) for a, b in w[3]] for w in windows]
    assert (ids(got) == ids(same)) == (TD.CASES[option].query == "Point")


def test_realtime_pair_across_a_cut_once():
    """Option 102 over 950 arrivals (one 512-arrival cut and the rest):
    each pair once, and some pair's two records fall in different cuts."""
    got, want = run_both(102)
    assert got == want
    pairs = [p for w in got for p in w[3]]
    assert len(pairs) == len(set(pairs))
    assert len(got) == 2
    first = {p[0][1:] for p in got[0][3]} | {p[1][1:] for p in got[0][3]}
    later = got[1][3]
    assert any(a[1:] in first or b[1:] in first for a, b in later)


@pytest.mark.parametrize("option", [108, 109])
def test_latency_variants_count_each_pair(option):
    got, want = run_both(option)
    assert got == want
    assert all(w[2] == len(w[3]) for w in got)
    assert sum(w[2] for w in got) > 0


def test_no_distance_near_the_radius():
    """Every (record, query) distance of the fixtures, in float64 for the
    points and through the port's plain f32 geometry distances otherwise,
    lies more than BAND from the radius."""
    from spatialflink_tpu_torch.models import EdgeGeomBatch
    from spatialflink_tpu_torch.ops import geom as G
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.streams.formats import parse_spatial

    grid = TParams.from_yaml(CONF).grids()[0]

    def xy(lines):
        return np.array([[float(v) for v in ln.split(",")[2:]]
                         for ln in lines])

    a, b = xy(POINTS), xy(QPOINTS)
    d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    assert np.abs(d - RADIUS).min() > BAND
    geoms = [parse_spatial(ln, "GeoJSON", grid, geometry="Polygon")
             for ln in GEOMS + QGEOMS]
    gb = EdgeGeomBatch.from_objects(geoms, device=torch.device("cpu"))
    ng = len(GEOMS)
    # points x query geometries, geometries x query points
    for pts, cols in ((a, slice(ng, None)), (b, slice(0, ng))):
        px = torch.tensor(pts[:, 0], dtype=torch.float32)
        py = torch.tensor(pts[:, 1], dtype=torch.float32)
        dist = HK.pip_lattice_plain(px, py, gb.edges, gb.edge_mask,
                                    gb.is_areal)[:, cols]
        assert (dist - RADIUS).abs().min() > BAND
    for i in range(len(GEOMS), len(geoms)):
        dist = G.geoms_to_single_geom_dist(gb, gb.edges[i], gb.edge_mask[i],
                                           gb.is_areal[i])
        assert (dist[:ng] - RADIUS).abs().min() > BAND


def test_refusals():
    """Count windows, multiQuery and the bf16 lattice are refused as in
    the JAX package (the lattice as not yet ported); a join without its
    query stream raises; the card is never replaced by the CPU."""
    p = _params(TParams, 101)
    with pytest.raises(ValueError, match="needs stream2"):
        TD.run_option(p, iter(POINTS), device="cpu")
    p.query.multi_query = True
    with pytest.raises(ValueError, match="multiQuery"):
        TD.run_option(p, iter(POINTS), iter(QPOINTS), device="cpu")
    p = dataclasses.replace(_params(TParams, 101), window=dataclasses.replace(
        p.window, type="COUNT"))
    with pytest.raises(NotImplementedError, match="CountBased"):
        TD.run_option(p, iter(POINTS), iter(QPOINTS), device="cpu")
    os.environ["SPATIALFLINK_JOIN_LATTICE"] = "bf16"
    try:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            list(TD.run_option(_params(TParams, 101), iter(POINTS),
                               iter(QPOINTS), device="cpu"))
    finally:
        del os.environ["SPATIALFLINK_JOIN_LATTICE"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TD.run_option(_params(TParams, 101), iter(POINTS), iter(QPOINTS))


@pytest.mark.parametrize("option", [101, 121])
def test_cli_with_input2_matches_jax(tmp_path, capsys, option):
    """stdout byte for byte; --output writes each pair as a JSON array of
    its two records, byte for byte."""
    spec = TD.CASES[option]
    conf = tmp_path / "conf.yml"
    conf.write_text(open(CONF).read().replace("radius: 0.5",
                                              f"radius: {RADIUS}"))
    in1, in2 = tmp_path / "in1.txt", tmp_path / "in2.txt"
    in1.write_text("\n".join(STREAMS[spec.stream]) + "\n")
    in2.write_text("\n".join(QUERIES[spec.query]) + "\n")
    args = ["--config", str(conf), "--option", str(option), "--input1",
            str(in1), "--format", KIND[spec.stream], "--input2", str(in2),
            "--format2", KIND[spec.query]]
    assert JD.main(args + ["--output", str(tmp_path / "jax.out")]) == 0
    want = capsys.readouterr().out
    assert TD.main(args + ["--output", str(tmp_path / "port.out"),
                           "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and want.count("'window'") >= 5
    jout = (tmp_path / "jax.out").read_text()
    assert (tmp_path / "port.out").read_text() == jout
    assert jout.count("\n") > 10
