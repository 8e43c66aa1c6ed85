"""The trajectory queries end to end on the CPU, part one: tFilter
201/202, tRange 203/204 and its naive twin 2030, tStats 205/206 and
tAggregate 207/208 through the PyTorch port's run_option (device="cpu",
the K8 kernels' plain versions) against spatialflink_tpu.driver.run_option,
window for window: windowed, realtime, query.panes (204, 206, 208) and
per-cell COUNT windows (208). Part two, tests/test_torch_trajectory_join.py:
tJoin, tKNN (multiQuery too), option 99, the refusals and the CLI.

Fixture (seeded numpy): 40 random-walk trajectories of 70 points each,
400 ms apart (28 s), as CSV rows in arrival order, 3 % of them moved up to
1.5 s into the past (some beyond the 1 s lateness: dropped) and 2 % of
them repeated at the same (object, ts) with other coordinates (ties), some
outside the grid and some outside the query polygon; a second stream of
12 trajectories is tJoin's query stream.

Equal: ids, order, integers (temporal lengths, group lengths, counts),
heatmaps and point coordinates. tStats' spatial lengths and speeds may
differ: the JAX package takes a running length as a difference of one f32
cumsum over the whole batch, the port sums each trajectory's own run (see
``ops/trajectory.py``); each must agree within 4 * 2**-23 times the
batch's total spatial length (the cumsum's rounding over the batch; the
sum of the result's per-trajectory totals bounds the batch's total from
above). Temporal lengths are equal: every batch's total temporal
contribution stays below 2**24 ms (40 trajectories x 28 s), where f32
sums of integer deltas are exact in any order. tKNN distances within 1e-6
relative: XLA on the CPU fuses the distance's multiply-add, the port does
not (ROADMAP's known differences).
"""

import dataclasses
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
SPATIAL_ULPS = 4 * 2.0 ** -23

torch.set_num_threads(1)


def _lines(seed=0, trajs=40, steps=70, prefix="traj-"):
    rng = np.random.default_rng(seed)
    x = rng.uniform(115.7, 117.3, trajs)
    y = rng.uniform(39.9, 41.0, trajs)
    out = []
    for step in range(steps):
        x = x + rng.normal(0.0, 0.01, trajs)
        y = y + rng.normal(0.0, 0.01, trajs)
        for i in range(trajs):
            t = T0 + 400 * step
            if rng.random() < 0.03:
                t -= int(rng.integers(0, 1500))
            a, b = float(x[i]), float(y[i])
            out.append(f"{prefix}{i},{t},{a!r},{b!r}")
            if rng.random() < 0.02:  # a tie: same (object, ts), elsewhere
                out.append(f"{prefix}{i},{t},{a + 0.001!r},{b - 0.002!r}")
    return out


LINES = _lines()
LINES2 = _lines(seed=5, trajs=12, prefix="q-")


def _params(cls, option, **query):
    p = cls.from_yaml(CONF)
    p.query.option = option
    p.query.radius = 0.05
    p.query.k = 5
    for k, v in query.items():
        setattr(p.query, k, v)
    fmt = dataclasses.replace(p.input1, format="CSV")
    return dataclasses.replace(p, input1=fmt, input2=fmt)


def _run(option, window=None, **query):
    """(JAX results, port results) of one option over the fixture."""
    out = []
    for cls, drv, kw in ((JParams, JD, {}), (TParams, TD,
                                             {"device": "cpu"})):
        p = _params(cls, option, **query)
        if window is not None:
            p = dataclasses.replace(p, window=dataclasses.replace(
                p.window, **window))
        out.append(list(drv.run_option(p, iter(LINES), iter(LINES2), **kw)))
    return out


def _obj(r):
    """A comparable form of one record (floats kept for the tolerant
    checks)."""
    name = type(r).__name__
    if name == "Point":
        return ("P", r.obj_id, r.timestamp, r.x, r.y, r.cell)
    if name == "LineString":
        return ("L", r.obj_id, r.timestamp, tuple(map(tuple, r.coords_list)),
                tuple(r.bbox), r.cell)
    if isinstance(r, (tuple, list)):
        return tuple(_obj(v) for v in r)
    if isinstance(r, dict):
        return tuple(sorted((k, _obj(v)) for k, v in r.items()))
    if isinstance(r, np.ndarray):
        return ("A", r.dtype.str, r.tolist())
    if isinstance(r, (set, frozenset)):
        return ("S", tuple(sorted(r)))
    if isinstance(r, (np.floating, np.integer)):
        return r.item()
    return r


def _window(w):
    return (w.window_start, w.window_end, [_obj(r) for r in w.records],
            _obj(w.extras))


def _assert_same(want, got, min_windows=1):
    assert len(want) >= min_windows
    assert [_window(w) for w in got] == [_window(w) for w in want]


def _assert_tstats_close(want, got):
    """tStats: objects, order and temporal lengths equal; spatial lengths
    and speeds within the stated bound."""
    assert [(w.window_start, w.window_end) for w in got] == \
        [(w.window_start, w.window_end) for w in want]
    checked = 0
    for jw, tw in zip(want, got):
        assert [r[0] for r in tw.records] == [r[0] for r in jw.records]
        assert [r[2] for r in tw.records] == [r[2] for r in jw.records]
        total = {}
        for oid, s, _, _ in jw.records:
            total[oid] = max(total.get(oid, 0.0), s)
        bound = SPATIAL_ULPS * sum(total.values())
        for (_, js, jt, jv), (_, ts, _, tv) in zip(jw.records, tw.records):
            assert abs(ts - js) <= bound, (js, ts, bound)
            assert abs(tv - jv) <= bound / max(jt, 1) + 1e-6 * abs(jv)
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("option,traj_ids", [
    (201, []), (201, ["traj-3", "traj-17", "traj-30"]), (202, []),
    (202, ["traj-3", "traj-17", "traj-30"])])
def test_tfilter_matches_jax(option, traj_ids):
    want, got = _run(option, traj_ids=traj_ids)
    _assert_same(want, got, 3)


@pytest.mark.parametrize("option", [203, 204, 2030])
def test_trange_matches_jax(option):
    want, got = _run(option)
    _assert_same(want, got, 3)
    assert any(len(w.records) for w in want)


@pytest.mark.parametrize("option,traj_ids", [
    (205, []), (206, []), (205, ["traj-3", "traj-17", "traj-30"]),
    (206, ["traj-3", "traj-17", "traj-30"])])
def test_tstats_matches_jax(option, traj_ids):
    want, got = _run(option, traj_ids=traj_ids)
    _assert_tstats_close(want, got)


@pytest.mark.parametrize("option,agg", [
    (207, "SUM"), (207, "ALL"), (208, "SUM"), (208, "AVG"), (208, "MIN"),
    (208, "MAX"), (208, "COUNT"), (208, "ALL")])
def test_taggregate_matches_jax(option, agg):
    want, got = _run(option, aggregate_function=agg,
                     traj_deletion_threshold_s=2)
    _assert_same(want, got, 3)


@pytest.mark.parametrize("agg", ["SUM", "MIN", "MAX", "ALL", "COUNT"])
def test_taggregate_count_windows_match_jax(agg):
    """window.type COUNT: per-cell count windows of 6 points every 2."""
    want, got = _run(208, window=dict(type="COUNT", interval_s=6, step_s=2),
                     aggregate_function=agg)
    _assert_same(want, got, 3)


@pytest.mark.parametrize("option", [204, 206, 208])
def test_panes_match_jax(option):
    """query.panes: 204, 206 and 208 (ALL) pane by pane; 206 with panes
    also equals 206 without, within the tStats bound."""
    want, got = _run(option, panes=True, aggregate_function="ALL")
    if option == 206:
        _assert_tstats_close(want, got)
        _, whole = _run(option)
        _assert_tstats_close(whole, got)
    else:
        _assert_same(want, got, 3)
