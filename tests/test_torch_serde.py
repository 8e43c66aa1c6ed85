"""The ser/de conformance options 401-406 ... 901-906 and the shapefile
inputs 1001-1003 on the CPU: the PyTorch port's run_option and CLI
against spatialflink_tpu.driver, output for output (each record's parsed
object, compared through its repr, and its re-serialization; stdout byte
for byte), the wall clock every object stamps at construction pinned in
both packages.

Fixtures: five seeded records of each option's geometry type (points,
polygons with and without a hole, linestrings, collections of a point and
a linestring, multi-points) over the conf's Beijing bbox, written by the
JAX package's serializer in the option's format, delimiter and
timestamp form; a shapefile written with ``struct`` as
tests/test_shapefile.py writes it (a point, a polygon with a hole, a
two-part polyline, a null shape, an unsupported multipoint), and its
truncated and non-shapefile forms.
"""

import struct
import time

import numpy as np
import pytest

from spatialflink_tpu import driver as JD
from spatialflink_tpu import models as JM
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.streams.formats import serialize_spatial as jser
from spatialflink_tpu.streams.shapefile import ShapefileError as JError

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import Params as TParams
from spatialflink_tpu_torch.streams.shapefile import (FILE_CODE,
                                                      ShapefileError,
                                                      read_shapefile)

from test_torch_join import CONF

NOW = 1_700_000_123.456
SERDE = sorted(o for o, s in TD.CASES.items() if s.family == "deser")
SHAPES = [1001, 1002, 1003]


@pytest.fixture(autouse=True)
def _pinned_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


def _objects(kind, seed):
    """Five JAX objects of ``kind``, ids and timestamps seeded."""
    rng = np.random.default_rng(seed)
    grid = JParams.from_yaml(CONF).grids()[0]
    out = []
    for i in range(5):
        cx, cy = rng.uniform(115.7, 117.4), rng.uniform(39.8, 40.9)
        ts = 1_700_000_000_000 + int(rng.integers(0, 20_000)) * 1000
        r = float(rng.uniform(0.01, 0.05))
        oid = f"o{int(rng.integers(0, 100))}"
        pt = JM.Point.create(cx, cy, grid, obj_id=oid, timestamp=ts)
        line = JM.LineString.create(
            [(cx, cy), (cx + r, cy + r / 2), (cx + 2 * r, cy)], grid,
            obj_id=oid, timestamp=ts)
        if kind == "Point":
            out.append(pt)
        elif kind == "Polygon":
            rings = [[(cx - r, cy - r), (cx + r, cy - r), (cx + r, cy + r),
                      (cx - r, cy + r)]]
            if i % 2:
                h = r / 3
                rings.append([(cx - h, cy - h), (cx + h, cy - h),
                              (cx, cy + h)])
            out.append(JM.Polygon.create(rings, grid, obj_id=oid,
                                         timestamp=ts))
        elif kind == "LineString":
            out.append(line)
        elif kind == "GeometryCollection":
            out.append(JM.GeometryCollection.create([pt, line], obj_id=oid,
                                                    timestamp=ts))
        else:
            out.append(JM.MultiPoint.create(
                [(cx, cy), (cx + r, cy - r), (cx - r, cy)], grid,
                obj_id=oid, timestamp=ts))
    return out


def _lines(option):
    spec = TD.CASES[option]
    p = JParams.from_yaml(CONF)
    delim = spec.delim or ("\t" if spec.fmt == "TSV" else ",")
    date_format = p.input1.date_format if spec.timestamped else None
    return [jser(o, spec.fmt, delimiter=delim, date_format=date_format)
            for o in _objects(spec.stream, option)]


def _params(cls, option):
    p = cls.from_yaml(CONF)
    p.query.option = option
    return p


def _out(results):
    return [(repr(obj), ser) for obj, ser in results]


def test_the_thirty_options():
    assert SERDE == [b + j for b in range(400, 1000, 100)
                     for j in range(1, 7)]
    assert [(TD.CASES[o].fmt, TD.CASES[o].delim, TD.CASES[o].timestamped)
            for o in SERDE] == [(JD.CASES[o].fmt, JD.CASES[o].delim,
                                 JD.CASES[o].timestamped) for o in SERDE]


@pytest.mark.parametrize("option", SERDE)
def test_serde_option_matches_jax(option):
    lines = _lines(option)
    want = _out(JD.run_option(_params(JParams, option), iter(lines)))
    got = _out(TD.run_option(_params(TParams, option), iter(lines),
                             device="cpu"))
    assert got == want and len(want) == 5
    assert type(list(TD.run_option(_params(TParams, option), iter(lines),
                                   device="cpu"))[0][0]).__name__ == \
        TD.CASES[option].stream


@pytest.mark.parametrize("option", [401, 504, 602, 705, 803, 906])
def test_serde_cli_matches_jax(tmp_path, capsys, option):
    """stdout byte for byte, and --output (the parsed record in the
    output format) byte for byte."""
    inp = tmp_path / "in.txt"
    inp.write_text("\n".join(_lines(option)) + "\n")
    args = ["--config", CONF, "--option", str(option), "--input1", str(inp),
            "--output-format", "WKT"]
    assert JD.main(args + ["--output", str(tmp_path / "jax.out")]) == 0
    want = capsys.readouterr().out
    assert TD.main(args + ["--output", str(tmp_path / "port.out"),
                           "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and want.count("\n") == 5
    assert (tmp_path / "port.out").read_text() == \
        (tmp_path / "jax.out").read_text()


# ---------------------------------------------------------------------- #
# shapefiles


def _point_payload(x, y):
    return struct.pack("<i", 1) + struct.pack("<dd", x, y)


def _poly_payload(shape_type, parts):
    out = struct.pack("<i", shape_type) + struct.pack("<dddd", 0, 0, 0, 0)
    out += struct.pack("<ii", len(parts), sum(len(p) for p in parts))
    start = 0
    for p in parts:
        out += struct.pack("<i", start)
        start += len(p)
    for p in parts:
        for x, y in p:
            out += struct.pack("<dd", x, y)
    return out


def _build_shp(payloads, file_code=FILE_CODE):
    records = b""
    for i, payload in enumerate(payloads, start=1):
        records += struct.pack(">ii", i, len(payload) // 2) + payload
    header = struct.pack(">i", file_code) + b"\x00" * 20
    header += struct.pack(">i", (100 + len(records)) // 2)
    return header + b"\x00" * (100 - len(header)) + records


RING = [(116.1, 40.1), (116.4, 40.1), (116.4, 40.4), (116.1, 40.4),
        (116.1, 40.1)]
HOLE = [(116.2, 40.2), (116.3, 40.2), (116.3, 40.3), (116.2, 40.3),
        (116.2, 40.2)]
PAYLOADS = [_point_payload(116.25, 40.75), _poly_payload(5, [RING, HOLE]),
            _poly_payload(3, [[(116.0, 40.0), (116.5, 40.5), (116.9, 40.5)],
                              [(116.6, 40.6), (116.7, 40.8)]]),
            struct.pack("<i", 0), struct.pack("<i", 8) + b"\x00" * 40]


@pytest.mark.parametrize("option", SHAPES)
def test_shapefile_options_match_jax(tmp_path, capsys, option):
    shp = tmp_path / "in.shp"
    shp.write_bytes(_build_shp(PAYLOADS))
    want = [repr(o) for o in JD.run_option(_params(JParams, option),
                                           str(shp))]
    got = [repr(o) for o in TD.run_option(_params(TParams, option), str(shp),
                                          device="cpu")]
    assert got == want and len(got) == 3
    args = ["--config", CONF, "--option", str(option), "--input1", str(shp)]
    assert JD.main(args) == 0
    jout = capsys.readouterr()
    assert TD.main(args + ["--device", "cpu"]) == 0
    tout = capsys.readouterr()
    assert tout.out == jout.out and tout.out.count("\n") == 3
    assert "Unsupported shape type [8]" in tout.err


def test_shapefile_rejects(tmp_path):
    good = _build_shp(PAYLOADS)
    cases = {"short.shp": good[:60], "cut.shp": good[:-10],
             "other.shp": _build_shp(PAYLOADS, file_code=1234)}
    for name, data in cases.items():
        p = tmp_path / name
        p.write_bytes(data)
        with pytest.raises(JError) as j:
            JD.run_option(_params(JParams, 1001), str(p))
        with pytest.raises(ShapefileError) as t:
            read_shapefile(str(p))
        assert str(t.value) == str(j.value)
        with pytest.raises(ShapefileError):
            TD.run_option(_params(TParams, 1001), str(p), device="cpu")
