"""The port's skew-adaptive grid against the JAX package's: the leaf
layout and its float arithmetic (``index/adaptive_grid.py``), the cell
observer at every decode call site (``index/uniform_grid.py``), and the
point-stream range operators' host prefilter (``operators/base.py``
``_prefilter``) on clustered streams whose repartition epochs fire mid-run:
the same results, the same prefilter and grid counters, the same layouts,
versions and epoch counts.

Inputs are seeded numpy streams; the JAX operators run on the CPU as the
JAX package's own tests run them."""

import contextlib
import dataclasses
import hashlib
import io
import os

import numpy as np
import pytest
import torch
import yaml

from spatialflink_tpu import driver as JD
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.index import AdaptiveGrid as JAdaptive
from spatialflink_tpu.index import UniformGrid as JGrid
from spatialflink_tpu.index import uniform_grid as jug
from spatialflink_tpu.runtime import repartition as JR
from spatialflink_tpu.runtime.queryplane import QueryRegistry as JRegistry
from spatialflink_tpu.streams import kafka as JK
from spatialflink_tpu.streams.synthetic import clustered_lines
from spatialflink_tpu.utils import metrics as JM

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import Params as TParams
from spatialflink_tpu_torch.index import AdaptiveGrid as TAdaptive
from spatialflink_tpu_torch.index import UniformGrid as TGrid
from spatialflink_tpu_torch.index import uniform_grid as tug
from spatialflink_tpu_torch.models import Point as TPoint
from spatialflink_tpu_torch.operators import (PointPointRangeQuery,
                                              QueryConfiguration)
from spatialflink_tpu_torch.runtime import repartition as TR
from spatialflink_tpu_torch.runtime.queryplane import QueryRegistry as TRegistry
from spatialflink_tpu_torch.streams import kafka as TK
from spatialflink_tpu_torch.utils import metrics as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")
BBOX = (115.5, 117.6, 39.6, 41.1)
#: the counters the prefilter and the controller bump
COUNTERS = ("prefilter-records", "prefilter-kept",
            "prefilter-windows-skipped", "prefilter-mask-recomputes",
            "repartitions", "grid-splits", "grid-merges")

torch.set_num_threads(1)


def _grids(n, refine, coarsen=2):
    return (JAdaptive(JGrid(*BBOX, num_grid_partitions=n), refine, coarsen),
            TAdaptive(TGrid(*BBOX, num_grid_partitions=n), refine, coarsen))


def _random_layout(rng, n, coarsen, n_splits=6, n_coarse=4):
    """The layout ``tests/test_grid.py``'s ``_random_layout`` draws."""
    splits = rng.choice(n * n, size=n_splits, replace=False).tolist()
    nb = -(-n // coarsen)
    blocks = [(int(rng.integers(0, nb)), int(rng.integers(0, nb)))
              for _ in range(n_coarse)]
    return splits, blocks


def _edge_points(ag, rng):
    """Points exactly on cell and fine-leaf edges (computed as the leaf
    bounds compute them), one ulp either side, and the bbox's corners."""
    b, fl = ag.base, ag.fine_length
    k = rng.integers(0, ag.n * ag.refine + 1, 300)
    j = rng.integers(0, ag.n * ag.refine + 1, 300)
    xs = b.min_x + k.astype(np.float64) * fl
    ys = b.min_y + j.astype(np.float64) * fl
    cx = b.min_x + rng.integers(0, ag.n + 1, 100) * b.cell_length
    cy = b.min_y + rng.integers(0, ag.n + 1, 100) * b.cell_length
    xs = np.concatenate([xs, np.nextafter(xs, -np.inf),
                         np.nextafter(xs, np.inf), cx,
                         [b.min_x, b.max_x, b.min_x, b.max_x]])
    ys = np.concatenate([ys, np.nextafter(ys, np.inf),
                         np.nextafter(ys, -np.inf), cy,
                         [b.min_y, b.max_y, b.max_y, b.min_y]])
    return xs, ys


# --------------------------------------------------------------- the grid


@pytest.mark.parametrize("seed,n,refine,coarsen", [
    (0, 20, 4, 2), (1, 25, 3, 3), (2, 100, 8, 2), (3, 7, 2, 4)])
def test_grid_matches_jax(seed, n, refine, coarsen):
    """The same random layouts in both packages: equal leaf tables and
    bounds, ``assign_leaf`` on random points and on points placed exactly
    on cell and leaf edges (and one ulp off), the GN, CN and neighbouring
    leaf masks of point and cell-list queries, and the union mask."""
    rng = np.random.default_rng(seed)
    j, t = _grids(n, refine, coarsen)
    splits, blocks = _random_layout(rng, n, coarsen)
    assert j.apply_layout(splits, blocks) == t.apply_layout(splits, blocks)
    assert t.layout() == j.layout() and t.version == j.version == 1
    assert repr(t) == repr(j)
    for leaf in range(j.num_leaves):
        assert t.leaf_bounds(leaf) == j.leaf_bounds(leaf)
    xs = rng.uniform(j.base.min_x - 0.1, j.base.max_x + 0.1, 3000)
    ys = rng.uniform(j.base.min_y - 0.1, j.base.max_y + 0.1, 3000)
    ex, ey = _edge_points(j, rng)
    for x, y in ((xs, ys), (ex, ey)):
        np.testing.assert_array_equal(t.assign_leaf(x, y),
                                      j.assign_leaf(x, y))
    cell = int(j.base.assign_cell(xs[:1], ys[:1])[0][0])
    for _ in range(8):
        # a point query anywhere, its point on a fine edge half the time
        px, py = (float(ex[rng.integers(0, ex.size)]),
                  float(ey[rng.integers(0, ey.size)]))
        if rng.random() < 0.5:
            px, py = float(rng.uniform(j.base.min_x, j.base.max_x)), \
                float(rng.uniform(j.base.min_y, j.base.max_y))
        qc = int(j.base.assign_cell(px, py)[0])
        r = float(rng.uniform(0.2, 8.0)) * j.fine_length
        for fn in ("guaranteed_leaf_mask", "candidate_leaf_mask",
                   "neighboring_leaf_mask"):
            np.testing.assert_array_equal(
                getattr(t, fn)(r, qc, point=(px, py)),
                getattr(j, fn)(r, qc, point=(px, py)))
        cells = sorted({cell, qc, int(rng.integers(0, n * n))})
        for fn in ("guaranteed_leaf_mask", "candidate_leaf_mask",
                   "neighboring_leaf_mask"):
            np.testing.assert_array_equal(getattr(t, fn)(r, cells),
                                          getattr(j, fn)(r, cells))
        queries = [(qc, (px, py)), (cells, None), (cell, None)]
        np.testing.assert_array_equal(
            t.union_neighboring_leaf_mask(r, queries),
            j.union_neighboring_leaf_mask(r, queries))
    # radius 0 selects every leaf and guarantees none; no query, no leaf
    for r, cells in ((0.0, [cell]), (0.1, [])):
        for fn in ("guaranteed_leaf_mask", "neighboring_leaf_mask"):
            np.testing.assert_array_equal(getattr(t, fn)(r, cells),
                                          getattr(j, fn)(r, cells))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_union_mask_equals_the_per_rect_evaluation(seed):
    """``union_neighboring_leaf_mask`` evaluates the OR of many rects in
    one pass over the fine lattice: equal to the per-rect evaluation
    (``_mask_parts_rects``) and to the JAX package's, for hundreds of
    query cells (a polygon's), point queries in split cells, and radii on
    exact multiples of the fine length, just off them, 0 and negative;
    and ``neighboring_leaf_mask``, its one-query case, equal to the
    per-rect evaluation query by query."""
    rng = np.random.default_rng(seed)
    j, t = _grids(30, 4 + seed, 2)
    splits, blocks = _random_layout(rng, 30, 2, n_splits=12, n_coarse=20)
    j.apply_layout(splits, blocks)
    t.apply_layout(splits, blocks)
    fl = t.fine_length
    cells = sorted(set(rng.integers(0, 900, 300).tolist()))
    pts = [(float(rng.uniform(j.base.min_x, j.base.max_x)),
            float(rng.uniform(j.base.min_y, j.base.max_y))) for _ in range(5)]
    queries = [(cells[:150], None), (cells[150:], None)] + [
        (int(j.base.assign_cell(x, y)[0]), (x, y)) for x, y in pts]
    radii = [k * fl for k in (0.5, 1, 2, 3, 7)] + \
        [np.nextafter(k * fl, np.inf) for k in (1, 2, 5)] + \
        [np.nextafter(k * fl, -np.inf) for k in (1, 2, 5)] + \
        [float(rng.uniform(0, 20 * fl)), 0.0, -fl, 40 * t.base.cell_length]
    for r in radii:
        got = t.union_neighboring_leaf_mask(r, queries)
        np.testing.assert_array_equal(
            got, j.union_neighboring_leaf_mask(r, queries))
        rects = [rc for c, p in queries for rc in t._query_rects(c, p)]
        np.testing.assert_array_equal(got, t._mask_parts_rects(r, rects)[1])
        for c, p in queries:
            # the single-query mask is the union's one-query case
            np.testing.assert_array_equal(
                t.neighboring_leaf_mask(r, c, point=p),
                t._mask_parts(r, c, p)[1])
    assert not t.union_neighboring_leaf_mask(fl, []).any()


def test_layout_versions_and_keys_match_jax():
    """``apply_layout``'s version bumps (only on a real change; a split
    wins over a coarse block), its refusals, and ``cell_key`` /
    ``cell_from_key`` over every leaf of a layout, with the same keys and
    the same errors."""
    j, t = _grids(20, 3)
    steps = [([5, 9], [(4, 4)]), ([9, 5], [(4, 4)]), ([5], [(4, 4)]),
             ([0], [(0, 0), (5, 5)]), ([0], [(5, 5)]), ([], []), ([], [])]
    for splits, blocks in steps:
        assert t.apply_layout(splits, blocks) == \
            j.apply_layout(splits, blocks)
        assert (t.version, t.split_cells(), t.coarse_blocks()) == \
            (j.version, j.split_cells(), j.coarse_blocks())
    assert t.version == j.version == 4
    t.apply_layout([3, 77, 399], [(2, 7), (9, 9)])
    j.apply_layout([3, 77, 399], [(2, 7), (9, 9)])
    for leaf in range(j.num_leaves):
        key = t.cell_key(leaf)
        assert key == j.cell_key(leaf)
        assert t.cell_from_key(key) == j.cell_from_key(key)
        base = j.base.cell_from_key(key[:10])
        assert t.base.cell_from_key(key[:10]) == base
        assert t.leaf_of_cell(base) == j.leaf_of_cell(base)
    for g in (t, j):
        with pytest.raises(ValueError, match="malformed"):
            g.cell_from_key("0000000003x1")
        with pytest.raises(ValueError, match="unsplit"):
            g.cell_from_key("0000000004:1")
        with pytest.raises(ValueError, match="out of range"):
            g.apply_layout([400])
        with pytest.raises(ValueError, match="out of range"):
            g.apply_layout([], [(10, 0)])
    for cls, grid in ((TAdaptive, t.base), (JAdaptive, j.base)):
        for kw in ({"refine": 1}, {"coarsen": 1}):
            with pytest.raises(ValueError, match="must be >= 2"):
                cls(grid, **kw)


def test_observer_hook_and_controller_chain():
    """``assign_cell`` hands every result to ``_CELL_OBSERVER``;
    ``install`` chains the controller after an observer already there and
    ``uninstall`` restores it, as in the JAX package."""
    grid = TGrid(*BBOX, num_grid_partitions=100)
    seen = []
    tug._CELL_OBSERVER = seen.append
    try:
        ctl = TR.RepartitionController(TAdaptive(grid), interval_records=100)
        assert ctl.install() is ctl and TR.active_controller() is ctl
        cells, _ = grid.assign_cell(np.full(200, 116.5), np.full(200, 40.5))
        assert len(seen) == 1 and seen[0] is cells and ctl.epochs == 1
        assert ctl.grid.split_cells() == [int(cells[0])]
        ctl.uninstall()
        assert TR.active_controller() is None
        assert tug._CELL_OBSERVER == seen.append
        grid.assign_cell(116.5, 40.5)
        assert len(seen) == 2 and ctl.epochs == 1
        tug.observe_cells(cells)
        assert len(seen) == 3 and seen[-1] is cells
    finally:
        tug._CELL_OBSERVER = None
    tug.observe_cells(cells)  # no observer: nothing happens


# ---------------------------------------------- decode-time observations

N_LINES = 2000


def _lines(n=N_LINES, hot=0.8, seed=5, dt_ms=6):
    g = JGrid(*BBOX, num_grid_partitions=100)
    return clustered_lines(g, n, hot, seed=seed, fmt="csv", dt_ms=dt_ms)


def _hot_point():
    g = JGrid(*BBOX, num_grid_partitions=100)
    return ((g.min_x + g.max_x) / 2 + g.cell_length / 3,
            (g.min_y + g.max_y) / 2 + g.cell_length / 3)


def _conf(tmp_path, name, window=None, **query):
    """The sample config with a radius that both keeps and drops, and
    query points at the cluster (the refinement's case) and away."""
    with open(CONF) as f:
        d = yaml.safe_load(f)
    hx, hy = _hot_point()
    d["kafkaBootStrapServers"] = f"memory://{name}"
    d["query"]["radius"] = 0.006
    d["query"]["queryPoints"] = [[hx, hy], [116.0, 40.0],
                                 [hx + 0.01, hy - 0.004]]
    d["query"]["queryPolygons"] = [[[hx - 0.01, hy - 0.01],
                                    [hx + 0.012, hy - 0.01],
                                    [hx + 0.012, hy + 0.008],
                                    [hx - 0.01, hy - 0.01]]]
    d["query"].update(query)
    if window:
        d["window"].update(window)
    path = tmp_path / f"{name}.yml"
    path.write_text(yaml.safe_dump(d))
    return str(path)


def _recorder(module, calls):
    def observe(cells):
        c = np.ascontiguousarray(np.asarray(cells), np.int32)
        calls.append((c.size, hashlib.md5(c.tobytes()).hexdigest()))
    module._CELL_OBSERVER = observe


@contextlib.contextmanager
def _quiet():
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()):
        yield out


@pytest.mark.parametrize("opt,extra,window", [
    (1, [], None), (6, ["--multi-query"], None), (2, [], None),
    (51, [], {"type": "COUNT", "interval": 1000, "step": 500}),
    (206, [], None), (101, ["--input2"], None), (1, ["--kafka"], None),
])
def test_observer_calls_match_jax(tmp_path, monkeypatch, opt, extra,
                                  window):
    """Both drivers under ``--adaptive-grid`` hand the cell observer the
    same arrays in the same order: the decode's chunks (file and
    ``--kafka``), a join's second stream, and the batches the JAX package
    assigns again from materialized records (kNN count windows, the
    trajectory windows), which the port reports through
    ``observe_cells``. An extra or a missing call would move every later
    epoch."""
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(_lines()) + "\n")
    argv = ["--config", _conf(tmp_path, f"obs{opt}", window), "--option",
            str(opt), "--format", "CSV", "--adaptive-grid",
            "--repartition-interval", "1000"]
    if "--input2" in extra:
        q = tmp_path / "q.csv"
        q.write_text("\n".join(_lines(400, 0.5, 6, 45)) + "\n")
        argv += ["--input2", str(q), "--format2", "CSV"]
    if "--kafka" in extra:
        argv += ["--kafka"]
        for b in (JK.resolve_broker(f"memory://obs{opt}"),
                  TK.resolve_broker(f"memory://obs{opt}")):
            for ln in _lines():
                b.produce("points.geojson", ln)
    else:
        argv += ["--input1", str(inp)]
    argv += [a for a in extra if a not in ("--input2", "--kafka")]
    seen = {}
    try:
        for name, mod, main, more in (("jax", jug, JD.main, []),
                                      ("port", tug, TD.main,
                                       ["--device", "cpu"])):
            seen[name] = []
            _recorder(mod, seen[name])
            with _quiet():
                assert main(argv + more) == 0
            mod._CELL_OBSERVER = None
    finally:
        jug._CELL_OBSERVER = tug._CELL_OBSERVER = None
        JK.reset_memory_brokers()
        TK.reset_memory_brokers()
    assert len(seen["port"]) >= 2 and seen["port"] == seen["jax"]


def test_plain_point_records_are_observed_once_a_chunk():
    """A known difference (ROADMAP Queue 3): over a plain iterable of
    Point records (option 99's synthetic stream, the operator API) the
    port cuts chunks and assigns each chunk's cells once, where the JAX
    package takes each Point's cell at its creation and assigns a window
    batch's again. The results are the same; the epochs count otherwise."""
    grid = TGrid(*BBOX, num_grid_partitions=100)
    pts = [TPoint.create(116.5 + i * 1e-4, 40.5, None, obj_id=f"o{i}",
                         timestamp=1_700_000_000_000 + 10 * i)
           for i in range(5000)]
    calls = []
    tug._CELL_OBSERVER = lambda c: calls.append(np.asarray(c).size)
    try:
        conf = QueryConfiguration(window_size_ms=10_000, slide_ms=5_000)
        op = PointPointRangeQuery(conf, grid, device="cpu")
        q = TPoint.create(116.6, 40.5, grid)
        calls.clear()
        wins = list(op.run(iter(pts), q, 0.05))
    finally:
        tug._CELL_OBSERVER = None
    assert wins and calls == [4096, 904]


# --------------------------------------------------------- the operators

N_OPS = 4500


def _op_lines():
    return _lines(N_OPS, 0.85, seed=9, dt_ms=5)


def _params(cls, opt, panes=False, multi=False, realtime_batch=None):
    p = cls.from_yaml(CONF)
    p.query.option = opt
    p.query.panes = panes
    p.query.multi_query = multi
    hx, hy = _hot_point()
    p.query.radius = 0.004
    p.query.query_points = [(hx, hy), (116.0, 40.0), (hx + 0.008, hy)]
    p.query.query_polygons = [[(hx - 0.01, hy - 0.01), (hx + 0.012, hy - 0.01),
                               (hx + 0.012, hy + 0.008),
                               (hx - 0.01, hy - 0.01)]]
    p = dataclasses.replace(p, input1=dataclasses.replace(p.input1,
                                                          format="CSV"))
    return p


def _canon(results):
    """(start, end, per-query sorted (oid, ts, x, y)) of each window."""
    out = []
    for w in results:
        per_query = w.records if "queries" in w.extras else [w.records]
        out.append((w.window_start, w.window_end,
                    [sorted((p.obj_id, p.timestamp, p.x, p.y) for p in q)
                     for q in per_query],
                    w.extras.get("query_ids")))
    return out


def _adaptive_run(pkg, params, lines, registry=None):
    """One run_option over the records ``lines`` with an adaptive grid
    (K = 8) and its controller installed, epochs every 1,000 records, under
    a fresh registry: (windows, counters, controller)."""
    D, AG, R, M = pkg
    ag = AG(params.grids()[0], refine=8)
    params.adaptive_grid = ag
    ctl = R.RepartitionController(ag, interval_records=1000)
    if registry is not None:
        params.query_registry = registry
    kw = {"device": "cpu"} if D is TD else {}
    with M.scoped_registry() as reg:
        out = D.run_option(params, iter(lines), **kw)
        ctl.install()
        try:
            wins = _canon(out)
        finally:
            ctl.uninstall()
    return wins, {c: reg.counter(c).count for c in COUNTERS}, ctl


JAX_PKG = (JD, JAdaptive, JR, JM)
PORT_PKG = (TD, TAdaptive, TR, TM)


@pytest.mark.parametrize("opt,panes,multi", [
    (1, False, False), (6, False, False), (11, False, False),
    (2, False, False), (7, False, False), (1, True, False),
    (6, True, False), (1, False, True), (6, False, True),
    (11, False, True), (2, False, True),
])
def test_operators_match_jax(monkeypatch, opt, panes, multi):
    """Options 1, 6 and 11 windowed, realtime (2, 7) and with panes, and
    multiQuery 1 / 6 / 11 / 2, on a clustered stream whose epochs split
    the hot cells mid-run: the port's results, prefilter and grid
    counters, final layout, version, epochs and decisions equal the JAX
    package's, and the port's results equal its own uniform run's."""
    # decode chunks of 500: epochs fire between the windows
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "500")
    lines = _op_lines()
    want, jc, jctl = _adaptive_run(JAX_PKG, _params(JParams, opt, panes,
                                                    multi), lines)
    got, tc, tctl = _adaptive_run(PORT_PKG, _params(TParams, opt, panes,
                                                    multi), lines)
    assert got == want and tc == jc
    assert tc["repartitions"] >= 1 and tc["prefilter-mask-recomputes"] >= 1
    assert 0 < tc["prefilter-kept"] < tc["prefilter-records"]
    assert tctl.grid.layout() == jctl.grid.layout()
    assert tctl.epochs == jctl.epochs and tctl.repartitions == \
        jctl.repartitions
    assert [{k: v for k, v in d.items() if k != "ts_ms"}
            for d in tctl.decisions] == \
        [{k: v for k, v in d.items() if k != "ts_ms"} for d in jctl.decisions]
    uniform = _canon(TD.run_option(_params(TParams, opt, panes, multi),
                                   iter(lines), device="cpu"))
    assert got == uniform


def _scripted(lines, reg, hx, hy):
    """The stream, admitting a query after 2,000 records and retiring one
    after 4,000 (each lands at the next window's ``apply``)."""
    for i, ln in enumerate(lines):
        if i == 2000:
            reg.admit({"id": "near", "x": hx + 0.008, "y": hy})
        if i == 4000:
            reg.retire("far")
        yield ln


def test_dynamic_plane_matches_jax(monkeypatch):
    """``--queries-file`` option 1 (``run_dynamic``) under the adaptive
    grid, a query admitted and one retired mid-run: the union leaf mask is
    rebuilt at each fleet bump and at each grid bump, and the results,
    counters and layouts equal the JAX package's."""
    # decode chunks of 500, so the admissions land between windows
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "500")
    lines = _op_lines()
    hx, hy = _hot_point()
    out = {}
    for name, pkg, reg_cls, params_cls in (
            ("jax", JAX_PKG, JRegistry, JParams),
            ("port", PORT_PKG, TRegistry, TParams)):
        reg = reg_cls("range", radius=0.004)
        reg.admit({"id": "hot", "x": hx, "y": hy})
        reg.admit({"id": "far", "x": 116.0, "y": 40.0})
        reg.apply()
        out[name] = _adaptive_run(pkg, _params(params_cls, 1),
                                  _scripted(lines, reg, hx, hy), reg)
    (want, jc, jctl), (got, tc, tctl) = out["jax"], out["port"]
    assert got == want and tc == jc
    assert {len(w[3]) for w in got} == {2, 3}
    assert tc["repartitions"] >= 1 and tc["prefilter-mask-recomputes"] >= 1
    assert tctl.grid.layout() == jctl.grid.layout()


def test_prefilter_of_a_record_list_and_a_bulk_window():
    """A window that is not columnar (a list of Point records) takes the
    record-array route; a bulk replay's window is not prefiltered; a
    window whose mask keeps nothing launches nothing and selects
    nothing."""
    from spatialflink_tpu_torch.streams.bulk import BulkWindow

    grid = TGrid(*BBOX, num_grid_partitions=100)
    ag = TAdaptive(grid, refine=4)
    conf = QueryConfiguration(adaptive_grid=ag)
    op = PointPointRangeQuery(conf, grid, device="cpu")
    recs = [TPoint.create(116.5 + i * 1e-3, 40.5, grid, obj_id=f"o{i}",
                          timestamp=1_700_000_000_000 + i)
            for i in range(50)]
    q = recs[10]
    cache = op._leaf_mask_cache(lambda: ag.neighboring_leaf_mask(
        0.0015, q.cell, point=(q.x, q.y)))
    with TM.scoped_registry() as reg:
        keep, batch = op._prefilter(recs, cache, 1_700_000_000_000)
        assert keep.tolist() == [i for i in range(50)
                                 if ag.neighboring_leaf_mask(
                                     0.0015, q.cell, point=(q.x, q.y))[
                                     ag.assign_leaf(recs[i].x,
                                                    recs[i].y)[()]]]
        assert 0 < keep.size < 50 and int(batch.valid.sum()) == keep.size
        far = op._leaf_mask_cache(lambda: np.zeros(ag.num_leaves, bool))
        keep, batch = op._prefilter(recs, far, 0)
        assert keep.size == 0 and batch is None
        assert op._filter_eval(lambda b: 1 / 0, far)(recs, 0) == []
        bw = BulkWindow(np.arange(3), None, None)
        assert op._prefilter(bw, cache, 0) is None
        assert reg.counter("prefilter-windows-skipped").count == 2
        assert reg.counter("prefilter-records").count == 150
