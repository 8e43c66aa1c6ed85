"""The trajectory queries end to end on the CPU, part two: tJoin 209/210
and its naive twin 2090, tKNN 211/212 and its naive twin 2011 (single and
multiQuery), the synthetic harness 99 and its source, the refusals and
the CLI, against spatialflink_tpu.driver.run_option on the fixture and
with the tolerances of tests/test_torch_trajectory.py."""

import math

import pytest
import torch

from spatialflink_tpu import driver as JD
from spatialflink_tpu.config import Params as JParams

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import Params as TParams

from test_torch_trajectory import (CONF, LINES, LINES2, _assert_same,
                                   _assert_tstats_close, _obj, _params, _run)

torch.set_num_threads(1)


@pytest.mark.parametrize("option", [209, 210, 2090])
def test_tjoin_matches_jax(option):
    want, got = _run(option)
    _assert_same(want, got, 3 if option == 210 else 1)
    assert sum(len(w.records) for w in want) > 0


def _assert_knn_close(want, got):
    def strip(w):
        recs = w.records if "queries" in w.extras else [w.records]
        return [[(o, _obj(s)) for o, _, s in q] for q in recs]

    def dists(w):
        recs = w.records if "queries" in w.extras else [w.records]
        return [d for q in recs for _, d, _ in q]

    assert [(w.window_start, w.window_end, strip(w), _obj(w.extras))
            for w in got] == \
        [(w.window_start, w.window_end, strip(w), _obj(w.extras))
         for w in want]
    for jw, tw in zip(want, got):
        for a, b in zip(dists(jw), dists(tw)):
            assert math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-9)
    assert sum(len(dists(w)) for w in want) > 0


@pytest.mark.parametrize("option,multi", [
    (211, False), (212, False), (2011, False), (211, True), (212, True)])
def test_tknn_matches_jax(option, multi):
    points = [(116.5, 40.5), (116.0, 40.2), (117.0, 40.8)]
    want, got = _run(option, multi_query=multi, query_points=points,
                     radius=0.3)
    _assert_knn_close(want, got)


def test_synthetic_harness_matches_jax():
    """Option 99: the six families over SyntheticPointSource (windowed),
    each result tagged with its family."""
    want, got = _run(99)
    assert [w.extras["family"] for w in got] == \
        [w.extras["family"] for w in want]
    assert {w.extras["family"] for w in got} == {
        "tfilter", "trange", "tstats", "taggregate", "tjoin", "tknn"}
    for fam in ("tfilter", "trange", "taggregate", "tjoin"):
        _assert_same([w for w in want if w.extras["family"] == fam],
                     [w for w in got if w.extras["family"] == fam])
    _assert_tstats_close([w for w in want if w.extras["family"] == "tstats"],
                         [w for w in got if w.extras["family"] == "tstats"])
    _assert_knn_close([w for w in want if w.extras["family"] == "tknn"],
                      [w for w in got if w.extras["family"] == "tknn"])


def test_synthetic_source_matches_jax():
    """SyntheticPointSource draws the JAX package's points, out-of-order
    ones included; generate_query_polygons tiles the same squares."""
    from spatialflink_tpu.streams import sources as JS

    from spatialflink_tpu_torch.streams import sources as TS

    jg, tg = _params(JParams, 1).grids()[0], _params(TParams, 1).grids()[0]
    kw = dict(num_trajectories=30, steps=12, dt_ms=400,
              out_of_order_fraction=0.2, out_of_order_max_ms=2_000, seed=3)
    want = [(p.obj_id, p.timestamp, p.x, p.y, p.cell)
            for p in JS.SyntheticPointSource(jg, **kw)]
    got = [(p.obj_id, p.timestamp, p.x, p.y, p.cell)
           for p in TS.SyntheticPointSource(tg, **kw)]
    assert got == want
    assert [p.rings for p in TS.generate_query_polygons(12, tg)] == \
        [p.rings for p in JS.generate_query_polygons(12, jg)]


@pytest.mark.parametrize("option", [1010, 2000])
def test_options_outside_the_slice_are_refused(option):
    """The apps 1010 and 2000 were refused until their slice ported them
    (tests/test_torch_apps.py); now they run, and an empty stream gives
    no result."""
    assert list(TD.run_option(_params(TParams, option), [],
                              device="cpu")) == []


def test_multi_query_refused_outside_range_knn_and_tknn():
    p = _params(TParams, 206, multi_query=True)
    with pytest.raises(ValueError, match="plus trajectory kNN"):
        TD.run_option(p, [], device="cpu")
    p = _params(TParams, 2011, multi_query=True)
    with pytest.raises(ValueError, match="naive-twin tKnn"):
        list(TD.run_option(p, iter(LINES), device="cpu"))


def test_cli_matches_jax(tmp_path, capsys):
    """The CLI for 206 and 210 (--input2): stdout as the JAX driver prints
    it; without --input2 tJoin is refused; --chaos is not ported
    (--checkpoint, refused here before, runs since its slice:
    test_torch_recovery.py)."""
    inp, inp2 = tmp_path / "a.csv", tmp_path / "b.csv"
    inp.write_text("\n".join(LINES) + "\n")
    inp2.write_text("\n".join(LINES2) + "\n")
    for option, more in (("202", []), ("210", ["--input2", str(inp2),
                                                "--format2", "CSV"])):
        argv = ["--config", CONF, "--option", option, "--format", "CSV",
                "--input1", str(inp), *more]
        assert JD.main(argv) == 0
        want = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{")]
        assert TD.main(argv + ["--device", "cpu"]) == 0
        got = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
        assert got == want and len(got) >= 3
    rc = TD.main(["--config", CONF, "--option", "209", "--format", "CSV",
                  "--input1", str(inp), "--device", "cpu"])
    assert rc == 2 and "(tjoin) needs --input2" in capsys.readouterr().err
    rc = TD.main(["--config", CONF, "--option", "205", "--format", "CSV",
                  "--input1", str(inp), "--chaos", "seed=1", "--device",
                  "cpu"])
    assert rc == 2 and "--chaos: not yet ported" in \
        capsys.readouterr().err


def _self_join_points(pkg_point, grid, seed=12, n=240, trajs=9):
    """A seeded stream of ``trajs`` trajectories that cross each other and
    revisit their own cells, as Point objects of one package."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = 1_700_000_000_000
    oid = rng.integers(0, trajs, n)
    ts = base + np.sort(rng.integers(0, 40_000, n))
    x = 116.5 + rng.normal(0, 0.01, n)
    y = 40.5 + rng.normal(0, 0.01, n)
    return [pkg_point.create(float(x[i]), float(y[i]), grid, f"t{oid[i]}",
                             int(ts[i])) for i in range(n)]


@pytest.mark.parametrize("realtime", [False, True])
def test_self_join_run_single_matches_jax(realtime):
    """``PointPointTJoinQuery.run_single`` against the JAX method (JAX
    ``tests/test_trajectory.py:442``'s case, on a seeded stream): the same
    windows and pairs, none of one object with itself."""
    from spatialflink_tpu.index import UniformGrid as JGrid
    from spatialflink_tpu.models import Point as JPoint
    from spatialflink_tpu.operators import (PointPointTJoinQuery as JTJ,
                                            QueryConfiguration as JQC,
                                            QueryType as JQT)

    from spatialflink_tpu_torch.index import UniformGrid as TGrid
    from spatialflink_tpu_torch.models import Point as TPoint
    from spatialflink_tpu_torch.operators import (
        PointPointTJoinQuery as TTJ, QueryConfiguration as TQC,
        QueryType as TQT)

    bbox = (115.5, 117.6, 39.6, 41.1)
    out = []
    for grid_cls, point, op_cls, qc, qt, kw in (
            (JGrid, JPoint, JTJ, JQC, JQT, {}),
            (TGrid, TPoint, TTJ, TQC, TQT, {"device": "cpu"})):
        grid = grid_cls(*bbox, num_grid_partitions=100)
        conf = (qc(query_type=qt.RealTime, realtime_batch_size=60)
                if realtime else qc(window_size_ms=10_000, slide_ms=5_000))
        op = op_cls(conf, grid, **kw)
        out.append(list(op.run_single(iter(_self_join_points(point, grid)),
                                      0.01)))
    want, got = out
    _assert_same(want, got)
    pairs = [p for w in got for p in w.records]
    assert pairs and all(a.obj_id != b.obj_id for a, b in pairs)
