"""The apps on the CPU: StayTime (1010-1012) and CheckIn (2000) of the
PyTorch port against spatialflink_tpu.apps, record for record (the stay
times exactly: the port splits a window's pairs of every object in one
pass, in the JAX package's order of pairs, cells and float additions),
the cases of tests/test_apps.py on both packages, and the driver options
through both CLIs, stdout byte for byte (the emission wall clock of
2000's records pinned in both).
"""

import json
import time

import numpy as np
import pytest

from spatialflink_tpu import driver as JD
from spatialflink_tpu.apps import CheckIn as JCheckIn
from spatialflink_tpu.apps import StayTime as JStayTime
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.index import UniformGrid as JGrid
from spatialflink_tpu.models import Point as JPoint
from spatialflink_tpu.models import Polygon as JPolygon
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.apps import CheckIn, StayTime, parse_checkin_csv
from spatialflink_tpu_torch.config import Params as TParams
from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import Point, Polygon
from spatialflink_tpu_torch.operators import QueryConfiguration, QueryType

from test_torch_join import CONF

BASE = 1_700_000_000_000
GRIDS = (JGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10),
         UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10))


def _apps(size=10_000, slide=10_000):
    """(JAX app, port app) over the 10 x 10 unit grid."""
    return (JStayTime(JConf(JQT.WindowBased, window_size_ms=size,
                            slide_ms=slide), GRIDS[0]),
            StayTime(QueryConfiguration(QueryType.WindowBased,
                                        window_size_ms=size, slide_ms=slide),
                     GRIDS[1], device="cpu"))


def _pts(specs):
    """The same points as JAX and port objects: (x, y, oid, t offset)."""
    return tuple([cls.create(x, y, g, obj_id=o, timestamp=BASE + t)
                  for x, y, o, t in specs]
                 for cls, g in ((JPoint, GRIDS[0]), (Point, GRIDS[1])))


def _polys(specs):
    """(rings, oid, t offset) as JAX and port polygons."""
    return tuple([cls.create(r, g, obj_id=o, timestamp=BASE + t)
                  for r, o, t in specs]
                 for cls, g in ((JPolygon, GRIDS[0]), (Polygon, GRIDS[1])))


def _records(results):
    return [(r.window_start, r.window_end, r.records) for r in results]


def _walks(seed, n_obj=12, steps=30):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        for o in rng.permutation(n_obj).tolist():
            x, y = rng.uniform(0.3, 9.7, 2)
            out.append((float(x), float(y), f"o{o}", t * 600
                        + int(rng.integers(0, 500))))
    return out


STAY_CASES = {
    "same_cell": [(0.5, 0.5, "a", 0), (0.7, 0.7, "a", 2000)],
    "same_column": [(0.5, 0.5, "a", 0), (0.5, 3.5, "a", 4000)],
    "diagonal": [(0.5, 0.5, "a", 0), (2.5, 1.5, "a", 4000)],
    "two_objects": [(0.5, 0.5, "a", 0), (5.5, 5.5, "b", 0),
                    (0.6, 0.6, "a", 1000), (5.6, 5.6, "b", 3000)],
    "walks": _walks(1),
}


@pytest.mark.parametrize("case", sorted(STAY_CASES))
def test_cell_stay_time_matches_jax(case):
    jp, tp = _pts(STAY_CASES[case])
    ja, ta = _apps(10_000, 5_000)
    want = _records(ja.cell_stay_time_tuples(iter(jp)))
    got = _records(ta.cell_stay_time_tuples(iter(tp)))
    assert got == want and any(w[2] for w in want)
    ja, ta = _apps(10_000, 5_000)
    assert _records(ta.cell_stay_time(iter(tp))) == \
        _records(ja.cell_stay_time(iter(jp)))


def test_stay_time_traj_ids_filter():
    jp, tp = _pts(STAY_CASES["walks"])
    ja, ta = _apps()
    ids = {"o1", "o4", "o9", "nobody"}
    want = _records(ja.cell_stay_time(iter(jp), ids))
    assert _records(ta.cell_stay_time(iter(tp), ids)) == want
    assert want != _records(_apps()[0].cell_stay_time(iter(jp)))


def test_total_time_is_conserved():
    _, tp = _pts(STAY_CASES["walks"])
    _, ta = _apps()
    for r in ta.cell_stay_time_tuples(iter(tp)):
        by_pair = {}
        for oid, t0, t1, _c, share in r.records:
            by_pair[(oid, t0, t1)] = by_pair.get((oid, t0, t1), 0.0) + share
        for (_, t0, t1), total in by_pair.items():
            assert total == pytest.approx(t1 - t0)


SHELL = [(0.1, 0.1), (2.9, 0.1), (2.9, 2.9), (0.1, 2.9), (0.1, 0.1)]
HOLE = [(0.95, 0.95), (2.05, 0.95), (2.05, 2.05), (0.95, 2.05),
        (0.95, 0.95)]
L_SHAPE = [(0.1, 0.1), (1.9, 0.1), (1.9, 0.2), (0.2, 0.2), (0.2, 1.9),
           (0.1, 1.9), (0.1, 0.1)]
SQUARE = [(0.6, 0.6), (1.9, 0.6), (1.9, 1.9), (0.6, 1.9), (0.6, 0.6)]
SENSORS = [([SQUARE], "s1", 1000), ([SQUARE], "s1", 2000),
           ([SQUARE], "s2", 2000), ([SHELL, HOLE], "d", 2500),
           ([L_SHAPE], "l", 3000), ([[(4.2, 4.2), (7.7, 4.4), (6.1, 8.3)]],
                                   "t", 12_000)]


def test_sensor_intersection_with_a_hole_matches_jax():
    jpolys, tpolys = _polys(SENSORS)
    ja, ta = _apps(10_000, 5_000)
    want = _records(ja.cell_sensor_range_intersection(iter(jpolys)))
    got = _records(ta.cell_sensor_range_intersection(iter(tpolys)))
    assert got == want
    counts = dict(got[1][2])  # the window [0, 10 s)
    # distinct timestamps: 1 s (s1), 2 s (s1, s2), the donut's, the L's
    assert counts[GRIDS[1].cell_id(0, 0)] == 4
    assert GRIDS[1].cell_id(1, 1) in counts  # the square and s2
    _, tpoly = _polys([([SHELL, HOLE], "d", 0)])
    (only,) = _records(_apps()[1].cell_sensor_range_intersection(
        iter(tpoly)))
    assert GRIDS[1].cell_id(1, 1) not in dict(only[2])  # inside the hole


def test_normalized_matches_jax():
    jp, tp = _pts(STAY_CASES["walks"])
    jpolys, tpolys = _polys(SENSORS)
    ja, ta = _apps(10_000, 5_000)
    want = _records(ja.normalized_cell_stay_time(iter(jp), iter(jpolys)))
    got = _records(ta.normalized_cell_stay_time(iter(tp), iter(tpolys)))
    assert got == want and any(w[2] for w in want)


def test_pair_shares_match_jax_on_random_trajectories():
    """The per-object entry against the JAX package's vectorized one,
    exactly (tests/test_apps.py holds that against the scalar rule)."""
    ja, ta = _apps()
    rng = np.random.default_rng(77)
    for _ in range(5):
        specs = [(float(rng.uniform(0.2, 9.8)), float(rng.uniform(0.2, 9.8)),
                  "t", i * 1000) for i in range(40)]
        jp, tp = _pts(specs)
        assert ta._pair_shares(tp) == ja._pair_shares(jp)
    jp, tp = _pts([(0.5, 0.5, "t", 0), (0.6, 0.6, "t", 1000),
                   (0.6, 4.5, "t", 3000), (7.5, 4.5, "t", 6000)])
    assert ta._pair_shares(tp) == ja._pair_shares(jp)
    assert ta._pair_shares(tp[:1]) == []


def _ev(cls, event, device, user, t):
    return cls(obj_id=user, timestamp=BASE + t, x=0.0, y=0.0,
               event_id=event, device_id=device, user_id=user)


CHECKINS = [("e1", "room1-in", "u1", 0), ("e2", "room1-in", "u2", 1000),
            ("e3", "room1-out", "u1", 2000), ("e4", "room1-out", "u1", 4000),
            ("e5", "room2-out", "u3", 5000), ("e6", "room2-out", "u3", 7000),
            ("e7", "room2-in", "u2", 8000), ("e8", "room1-in", "u2", 9000)]


def test_checkin_matches_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.456)
    caps = {"room1": 10}
    conf = QueryConfiguration(QueryType.WindowBased)
    jconf = JConf(JQT.WindowBased)
    want = list(JCheckIn(jconf, room_capacities=caps).run(
        iter([_ev(JPoint, *e) for e in CHECKINS])))
    got = list(CheckIn(conf, room_capacities=caps, device="cpu").run(
        iter([_ev(Point, *e) for e in CHECKINS])))
    assert got == want
    assert [c for _r, _cap, c, _ts in got][:3] == [1, 2, 1]
    repaired = list(CheckIn(conf, device="cpu").insert_missing_events(
        iter([_ev(Point, *e) for e in CHECKINS])))
    assert [p.device_id for p in repaired][3:6] == \
        ["room1-in", "room1-out", "room2-out"]
    assert repaired[3].timestamp == BASE + 3000
    p = parse_checkin_csv("e7,roomA-in,user9,1700000000000,1.5,2.5")
    assert (p.device_id, p.user_id, p.x, p.timestamp) == \
        ("roomA-in", "user9", 1.5, 1700000000000)


def test_count_windows_are_refused():
    for cls in (StayTime, CheckIn):
        with pytest.raises(NotImplementedError, match="CountBased"):
            cls(QueryConfiguration(QueryType.CountBased), GRIDS[1],
                device="cpu")


# ---------------------------------------------------------------------- #
# the driver options


def _beijing_points(seed=3, n=600, n_obj=25):
    rng = np.random.default_rng(seed)
    t = BASE + np.sort(rng.integers(0, 20_000, n))
    late = rng.random(n) < 0.04
    t[late] -= 3_000
    ox = rng.uniform(116.0, 117.0, n_obj)
    oy = rng.uniform(40.0, 40.8, n_obj)
    o = rng.integers(0, n_obj, n)
    x = ox[o] + rng.normal(0.0, 0.03, n)
    y = oy[o] + rng.normal(0.0, 0.03, n)
    return [f"v{a},{b},{c!r},{d!r}" for a, b, c, d in
            zip(o.tolist(), t.tolist(), x.tolist(), y.tolist())]


def _beijing_sensors(seed=4, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cx, cy = rng.uniform(116.0, 117.0), rng.uniform(40.0, 40.8)
        r = rng.uniform(0.01, 0.08)
        ring = [[cx - r, cy - r], [cx + r, cy - r], [cx + r, cy + r],
                [cx - r, cy + r], [cx - r, cy - r]]
        coords = [ring]
        if i % 5 == 0:  # a hole
            h = r / 3
            coords.append([[cx - h, cy - h], [cx + h, cy - h],
                           [cx + h, cy + h], [cx - h, cy + h],
                           [cx - h, cy - h]])
        out.append(json.dumps({
            "type": "Feature", "geometry": {"type": "Polygon",
                                            "coordinates": coords},
            "properties": {"oID": f"s{i % 7}",
                           "timestamp": BASE + int(rng.integers(0, 20_000))}}))
    return sorted(out, key=lambda s: json.loads(s)["properties"]["timestamp"])


POINT_LINES = _beijing_points()
SENSOR_LINES = _beijing_sensors()
CHECKIN_LINES = [f"{e},{d},{u},{BASE + t},0.5,0.5"
                 for e, d, u, t in CHECKINS]
INPUTS = {1010: (POINT_LINES, None, "CSV"),
          1011: (SENSOR_LINES, None, "GeoJSON"),
          1012: (POINT_LINES, SENSOR_LINES, "CSV"),
          2000: (CHECKIN_LINES, None, "CSV")}


def _params(cls, option):
    import dataclasses

    p = cls.from_yaml(CONF)
    p.query.option = option
    lines1, lines2, fmt = INPUTS[option]
    return dataclasses.replace(
        p, input1=dataclasses.replace(p.input1, format=fmt),
        input2=dataclasses.replace(p.input2, format="GeoJSON"))


@pytest.mark.parametrize("option", [1010, 1011, 1012, 2000])
def test_run_option_matches_jax(monkeypatch, option):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.456)
    lines1, lines2, _ = INPUTS[option]

    def run(mod, cls, **kw):
        out = mod.run_option(_params(cls, option), iter(lines1),
                             iter(lines2) if lines2 else None, **kw)
        return [(r.window_start, r.window_end, r.records)
                if hasattr(r, "records") else r for r in out]

    want = run(JD, JParams)
    got = run(TD, TParams, device="cpu")
    assert got == want and want
    if option != 2000:
        assert any(w[2] for w in want)


@pytest.mark.parametrize("option", [1010, 1011, 1012, 2000])
def test_cli_matches_jax(tmp_path, capsys, monkeypatch, option):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.456)
    lines1, lines2, fmt = INPUTS[option]
    in1 = tmp_path / "in1.txt"
    in1.write_text("\n".join(lines1) + "\n")
    args = ["--config", CONF, "--option", str(option), "--input1", str(in1),
            "--format", fmt]
    if lines2:
        in2 = tmp_path / "in2.txt"
        in2.write_text("\n".join(lines2) + "\n")
        args += ["--input2", str(in2), "--format2", "GeoJSON"]
    assert JD.main(args) == 0
    want = capsys.readouterr().out
    assert TD.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and want.count("\n") >= 3
