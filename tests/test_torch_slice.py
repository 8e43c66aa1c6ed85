"""Options 1, 6 and 11 end to end on the CPU: the PyTorch port's run_option
(device="cpu") against spatialflink_tpu.driver.run_option on the same seeded
CSV lines, and the port's CLI output against the JAX driver's (options 6
and 51, and a multiQuery option; kNN and multi-query run_option parity is
in tests/test_torch_knn.py and tests/test_torch_multi.py).

The stream spans several decode chunks and sliding windows, carries
out-of-order and late records and points outside the grid. Selections must
be identical; the data is checked to hold no point within 1e-5 of the
radius, where the two packages' float rounding could legitimately differ.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatialflink_tpu import driver as JD
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.ops.distances import point_bbox_dist
from spatialflink_tpu.ops.geom import points_to_single_edges_raw
from spatialflink_tpu.models.batches import single_query_edges

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import Params as TParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")
T0 = 1_700_000_000_000

# pytest workers import every test module: one intra-op thread keeps this
# file's small CPU tensors from competing with the timed tests that
# other workers run at the same time
torch.set_num_threads(1)


def _stream(n=5000, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.uniform(115.4, 117.7, n)  # a margin outside the grid bbox
    y = rng.uniform(39.5, 41.2, n)
    ts = T0 + np.sort(rng.integers(0, 28_000, n))
    back = rng.random(n) < 0.03  # out of order; some beyond the lateness
    ts[back] -= rng.integers(200, 3_000, int(back.sum()))
    lines = [f"o{o},{t},{float(a)!r},{float(b)!r}" for o, t, a, b in
             zip(rng.integers(0, 300, n).tolist(), ts.tolist(), x, y)]
    return lines, x.astype(np.float32), y.astype(np.float32)


def _params(cls, option, approximate=False):
    p = cls.from_yaml(CONF)
    p.query.option = option
    p.query.approximate = approximate
    return dataclasses.replace(
        p, input1=dataclasses.replace(p.input1, format="CSV"))


def _query_dists(option, approximate, x, y):
    """Each point's distance to the option's query, by the JAX package."""
    p = _params(JParams, option)
    grid = p.grids()[0]
    if option == 1:
        q = p.query_point_objects(grid)[0]
        return np.hypot(x.astype(np.float64) - q.x, y.astype(np.float64) - q.y)
    geom = (p.query_polygon_objects(grid) if option == 6
            else p.query_linestring_objects(grid))[0]
    if approximate:
        b = np.asarray(geom.bbox, np.float32)
        return np.asarray(point_bbox_dist(jnp.asarray(x), jnp.asarray(y),
                                          *map(jnp.asarray, b)))
    e, m = single_query_edges(geom)
    inside, mind2 = points_to_single_edges_raw(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(e), jnp.asarray(m))
    return np.asarray(jnp.where(inside & (option == 6), 0.0,
                                jnp.sqrt(mind2)))


def _windows(results):
    return [(w.window_start, w.window_end,
             [(p.obj_id, p.timestamp, p.x, p.y) for p in w.records])
            for w in results]


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("option", [1, 6, 11])
def test_run_option_matches_jax(option, approximate):
    lines, x, y = _stream()
    radius = _params(TParams, option).query.radius
    d = _query_dists(option, approximate, x, y)
    assert np.all(np.abs(d - radius) > 1e-5)  # no point at the boundary
    want = _windows(JD.run_option(_params(JParams, option, approximate),
                                  iter(lines)))
    got = _windows(TD.run_option(_params(TParams, option, approximate),
                                 iter(lines), device="cpu"))
    assert len(want) >= 6 and sum(len(w[2]) for w in want) > 0
    assert [w[:2] for w in got] == [w[:2] for w in want]
    assert got == want


def test_cli_output_matches_jax(tmp_path, capsys):
    lines, x, y = _stream(n=3000, seed=9)
    assert np.all(np.abs(_query_dists(6, False, x, y) - 0.5) > 1e-5)
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(lines) + "\n")
    args = ["--config", CONF, "--option", "6", "--input1", str(inp),
            "--format", "CSV"]
    assert JD.main(args + ["--output", str(tmp_path / "jax.out")]) == 0
    want = capsys.readouterr().out
    proc = subprocess.run(
        [sys.executable, "-m", "spatialflink_tpu_torch.driver", *args,
         "--output", str(tmp_path / "port.out"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == want and want.count("'window'") >= 5
    assert (tmp_path / "port.out").read_text() == \
        (tmp_path / "jax.out").read_text()


def _cli_pair(tmp_path, capsys, args):
    """(JAX stdout, port stdout, JAX --output text, port --output text) of
    one CLI invocation on both drivers."""
    assert JD.main(args + ["--output", str(tmp_path / "jax.out")]) == 0
    want = capsys.readouterr().out
    proc = subprocess.run(
        [sys.executable, "-m", "spatialflink_tpu_torch.driver", *args,
         "--output", str(tmp_path / "port.out"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr
    return (want, proc.stdout, (tmp_path / "jax.out").read_text(),
            (tmp_path / "port.out").read_text())


def test_cli_knn_output_matches_jax(tmp_path, capsys):
    """Option 51 (k from the conf): stdout with the ``k`` extra and the
    (objID, distance) records of --output, byte for byte."""
    lines, _, _ = _stream(n=3000, seed=9)
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(lines) + "\n")
    want, got, jout, pout = _cli_pair(
        tmp_path, capsys, ["--config", CONF, "--option", "51", "--input1",
                           str(inp), "--format", "CSV"])
    assert got == want and want.count("'k': 10") >= 5
    _assert_knn_records_close(pout, jout)


def _assert_knn_records_close(port_text, jax_text):
    """--output kNN records: the same ids in the same order, distances
    within 1e-6 relative. (XLA on the CPU contracts dx*dx + dy*dy into
    fma(dx, dx, dy*dy), which rounds some distances one ulp away from the
    port's unfused arithmetic, so the digits can differ.)"""
    port = [json.loads(ln) for ln in port_text.splitlines()]
    jax_ = [json.loads(ln) for ln in jax_text.splitlines()]
    assert len(jax_) >= 50 and [o for o, _ in port] == [o for o, _ in jax_]
    np.testing.assert_allclose([d for _, d in port], [d for _, d in jax_],
                               rtol=1e-6, atol=0)


def test_cli_multi_query_output_matches_jax(tmp_path, capsys):
    """Option 56 under --multi-query with three query polygons: stdout with
    ``per_query_counts``, ``k`` and ``queries``, and the flattened records
    of --output, byte for byte."""
    import yaml

    with open(CONF) as f:
        conf = yaml.safe_load(f.read().split("\n", 1)[1])  # the !! tag
    conf["query"]["queryPolygons"] += [
        [[116.3, 40.3], [116.6, 40.3], [116.6, 40.6], [116.3, 40.3]],
        [[115.8, 39.9], [116.1, 39.9], [116.0, 40.2], [115.8, 39.9]]]
    (tmp_path / "conf.yml").write_text(yaml.safe_dump(conf))
    lines, _, _ = _stream(n=3000, seed=9)
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(lines) + "\n")
    want, got, jout, pout = _cli_pair(
        tmp_path, capsys, ["--config", str(tmp_path / "conf.yml"),
                           "--option", "56", "--multi-query", "--input1",
                           str(inp), "--format", "CSV"])
    assert got == want and want.count("'queries': 3") >= 5
    assert "'per_query_counts': [10, 10, 10]" in want
    _assert_knn_records_close(pout, jout)


def test_config_reads_k():
    assert TParams.from_yaml(CONF).query.k == JParams.from_yaml(CONF).query.k \
        == 10
    p = TParams.from_dict({
        "inputStream1": {"topicName": "t", "format": "CSV",
                         "gridBBox": [0, 0, 1, 1], "numGridCells": 4},
        "query": {"option": 51, "k": 50}, "window": {"interval": 10}})
    assert p.query.k == 50
    assert TD._query_conf(p, TD.CASES[51]).k == 50


@pytest.mark.parametrize("option", [211, 2011, 212])
def test_realtime_knn_is_refused(option):
    """Trajectory kNN (realtime 211, its naive twin 2011, and windowed 212)
    is not ported yet; the realtime kNN over polygon and linestring
    streams now is (tests/test_torch_geom_stream.py)."""
    with pytest.raises(NotImplementedError,
                       match=f"queryOption {option}: not yet ported"):
        TD.run_option(_params(TParams, option), [], device="cpu")


@pytest.mark.parametrize("argv,message", [
    (["--option", "211"], "queryOption 211: not yet ported"),
    (["--option", "101"], "queryOption 101: not yet ported"),
    (["--option", "6", "--kafka"], "--kafka: not yet ported"),
    (["--option", "6", "--panes"], "--panes: not yet ported"),
    (["--option", "6", "--limit", "5"], "--limit: not yet ported"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, capsys, argv, message):
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(_stream(n=10)[0]) + "\n")
    rc = TD.main(["--config", CONF, "--input1", str(inp), "--format", "CSV",
                  "--device", "cpu", *argv])
    assert rc != 0
    assert message in capsys.readouterr().err


def test_config_features_not_ported_raise():
    p = _params(TParams, 6)
    p.query.panes = True
    with pytest.raises(NotImplementedError, match="query.panes: not yet"):
        TD.run_option(p, [], device="cpu")


@pytest.mark.parametrize("kind", ["point", "polygon", "linestring"])
def test_operator_api_matches_jax(kind):
    """The operator API over a plain list of Point records: same windows,
    same selections, and the same pruning counts as the JAX operator's
    gn-bypassed / distance-computations registry counters."""
    from spatialflink_tpu import operators as JO
    from spatialflink_tpu.models import Point as JPoint
    from spatialflink_tpu.utils.metrics import REGISTRY

    from spatialflink_tpu_torch import operators as TO
    from spatialflink_tpu_torch.models import Point as TPoint

    lines, x, y = _stream(n=3000, seed=9)
    option = {"point": 1, "polygon": 6, "linestring": 11}[kind]
    assert np.all(np.abs(_query_dists(option, False, x, y) - 0.5) > 1e-5)
    rows = [ln.split(",") for ln in lines]
    jp, tp = _params(JParams, 1), _params(TParams, 1)
    jgrid, tgrid = jp.grids()[0], tp.grids()[0]
    jconf = JO.QueryConfiguration(window_size_ms=10_000, slide_ms=5_000,
                                  allowed_lateness_ms=1_000)
    tconf = TO.QueryConfiguration(window_size_ms=10_000, slide_ms=5_000,
                                  allowed_lateness_ms=1_000)
    if kind == "point":
        jq, tq = jp.query_point_objects(jgrid)[0], tp.query_point_objects(tgrid)[0]
        jop = JO.PointPointRangeQuery(jconf, jgrid)
        top = TO.PointPointRangeQuery(tconf, tgrid, device="cpu")
    else:
        get = ("query_polygon_objects" if kind == "polygon"
               else "query_linestring_objects")
        jq, tq = getattr(jp, get)(jgrid)[0], getattr(tp, get)(tgrid)[0]
        jop = JO.PointPolygonRangeQuery(jconf, jgrid)
        top = TO.PointPolygonRangeQuery(tconf, tgrid, device="cpu")
    jpts = [JPoint.create(float(a), float(b), jgrid, o, int(t))
            for o, t, a, b in rows]
    tpts = [TPoint.create(float(a), float(b), tgrid, o, int(t))
            for o, t, a, b in rows]
    before = [REGISTRY.counter(c).count
              for c in ("gn-bypassed", "distance-computations")]
    want = _windows(jop.run(iter(jpts), jq, 0.5))
    after = [REGISTRY.counter(c).count
             for c in ("gn-bypassed", "distance-computations")]
    got = _windows(top.run(iter(tpts), tq, 0.5))
    assert got == want and sum(len(w[2]) for w in want) > 0
    assert [top.pruning["gn-bypassed"], top.pruning["distance-computations"]] \
        == [a - b for a, b in zip(after, before)]


def _as_format(lines, fmt):
    """The CSV stream re-encoded: GeoJSON features, or TSV rows with
    date-string timestamps (second resolution, the conf's dateFormat)."""
    from datetime import datetime, timezone

    out = []
    for ln in lines:
        o, t, a, b = ln.split(",")
        if fmt == "GeoJSON":
            out.append('{"geometry": {"type": "Point", "coordinates": '
                       f'[{a}, {b}]}}, "properties": {{"oID": "{o}", '
                       f'"timestamp": {t}}}, "type": "Feature"}}')
        else:
            d = datetime.fromtimestamp(int(t) // 1000, tz=timezone.utc)
            out.append("\t".join([o, d.strftime("%Y-%m-%d %H:%M:%S"), a, b]))
    return out


@pytest.mark.parametrize("fmt", ["GeoJSON", "TSV"])
def test_input_formats_match_jax(fmt):
    lines, x, y = _stream(n=3000, seed=9)
    assert np.all(np.abs(_query_dists(6, False, x, y) - 0.5) > 1e-5)
    lines = _as_format(lines, fmt)
    jp, tp = _params(JParams, 6), _params(TParams, 6)
    jp = dataclasses.replace(jp, input1=dataclasses.replace(jp.input1,
                                                            format=fmt))
    tp = dataclasses.replace(tp, input1=dataclasses.replace(tp.input1,
                                                            format=fmt))
    want = _windows(JD.run_option(jp, iter(lines)))
    got = _windows(TD.run_option(tp, iter(lines), device="cpu"))
    assert got == want and sum(len(w[2]) for w in want) > 0
